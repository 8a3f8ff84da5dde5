// Per-16-px-tile 3DGS compositor, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel comfy3d_tpu/ops/pallas/gs_tile.py::_bwd_kernel
// (:127, reached through composite_tiles_bwd :240). The Python wrapper and
// the plain PyTorch version are comfy3d_tpu_torch/ops/gs_tile.py.
//
// What it computes, for tile t: the forward (gs_tile_fwd.cu) walked the
// first n = min(counts[t], M) slots of data[t] front to back. Here they are
// walked back to front, chunk by chunk (128 slots) and slot by slot within a
// chunk. Per pixel, from the forward's final T and the cotangents g_acc [C]
// and g_T, as gs_tile.py:140-203 computes it:
//   L = log(max(T_fin, e^-80))   (log T after the current chunk)
//   S = 0                        (sum over later slots of chan.g_acc a T)
// and per live slot i (power <= 0, raw = op G >= 1/255), in the forward's
// operations and order, so every live/unsat decision is its own:
//   L_i   = L - log1p(-a)  (running within the chunk; the carry to the
//           chunk before is max(L_0, -80))
//   T_i   = exp(clamp(L_i, -80, 0)),  one_m = max(1 - a, 0.01)
//   d a   = [raw < 0.99] (chan.g_acc T_i - S/one_m - g_T T_fin/one_m)
//   S    += chan.g_acc a T_i
//   d power = d a op G; d mu, d conic from the power's derivatives in
//   mx = mu - px, my = mu - py; d op += d a G; d chan_k += a T_i g_acc_k.
// The per-pixel values are summed over the tile's 256 pixels into the
// slot's column of out[t] ([D, M], tile data's layout): rows d mu_x, d mu_y,
// d a, d b, d c, d op, d chan_0..C-1. Every other entry of out[t] (rows
// >= 6 + C, slots >= n) is written 0.
//
// Hazard, shared with the reference and kept for parity (ROADMAP §C): where
// T underflows below e^-80 within a chunk, the rebuild from the floored
// log T_fin overstates every T_i before it in that chunk, so the gradient
// there is not the composited list's.
//
// Bound: operations (~17 f32 operations and one exp per slot-pixel visit,
// ~10 + 4C more, one log1p and one exp per live one, ~34 more per
// unsaturated one), not bytes (a slot's columns are shared by 256 pixels).
// Design: one CTA per tile, one thread per pixel (L, S, T_fin, g_T and
// g_acc in registers). Each chunk is staged in shared memory as the forward
// stages it. Each slot's 6 + C sums are reduced by warp shuffles into one
// shared-memory slot per warp (a warp whose lanes have nothing writes zeros
// without shuffling), then summed over the 8 warps after the chunk and
// written by slot index: a slot belongs to one tile, so no atomics, and the
// sums are deterministic.
//
// Built with -fmad=false, as the forward is: the power and alpha round as
// the forward's do, so the 1/255 and 0.99 cuts fall on the same visits.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;   // threads per CTA
constexpr int NWARP = NPIX / 32;
constexpr int CHUNK = 128;          // slots per staged chunk
// f32 roundings of the same double constants the plain version uses
constexpr float ALPHA_MAX = (float)0.99;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ONE_M_MIN = (float)(1.0 - 0.99);
constexpr float LOG_FLOOR = -80.f;
constexpr float T_FLOOR = (float)1.8048513878454153e-35;   // e^-80

template <int C>
constexpr int smem_bytes() {
  // s_dat [6 + C][CHUNK], s_red [NWARP][6 + C][CHUNK]
  return (int)(sizeof(float) * (6 + C) * CHUNK * (1 + NWARP));
}

template <int C>
__global__ void __launch_bounds__(NPIX)
gs_tile_bwd_kernel(const float* __restrict__ data,
                   const int* __restrict__ counts,
                   const float* __restrict__ trans,
                   const float* __restrict__ g_acc,
                   const float* __restrict__ g_trans, int d, int m,
                   int grid_w, float* __restrict__ out) {
  constexpr int NF = 6 + C;   // staged and reduced rows
  extern __shared__ float smem[];
  float* s_dat = smem;                                  // [NF][CHUNK]
  float* s_red = smem + NF * CHUNK;                     // [NWARP][NF][CHUNK]

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int count = min(max(counts[t], 0), m);
  const int nsteps = (count + CHUNK - 1) / CHUNK;
  const float ox = (float)((t % grid_w) * TILE);
  const float oy = (float)((t / grid_w) * TILE);
  const float px = ((float)(tid % TILE) + 0.5f) + ox;
  const float py = ((float)(tid / TILE) + 0.5f) + oy;
  const float* tile = data + (long long)t * d * m;
  float* gtile = out + (long long)t * d * m;

  const float tfin = trans[(long long)t * NPIX + tid];
  const float gT = g_trans[(long long)t * NPIX + tid];
  float gA[C];
#pragma unroll
  for (int k = 0; k < C; ++k) gA[k] = g_acc[((long long)t * C + k) * NPIX + tid];
  float L = logf(fmaxf(tfin, T_FLOOR));
  float S = 0.f;

  // rows past 6 + C, and the slots of chunks the forward never walked
  for (long long i = tid; i < (long long)(d - NF) * m; i += NPIX)
    gtile[(long long)NF * m + i] = 0.f;
  for (int f = 0; f < NF; ++f)
    for (int j = nsteps * CHUNK + tid; j < m; j += NPIX)
      gtile[(long long)f * m + j] = 0.f;

  for (int q = nsteps - 1; q >= 0; --q) {
    const int off = q * CHUNK;
    __syncthreads();   // the previous chunk's readers are done
    for (int i = tid; i < NF * CHUNK; i += NPIX) {
      const int f = i / CHUNK;
      const int j = i % CHUNK;
      s_dat[f * CHUNK + j] = tile[(long long)f * m + off + j];
    }
    __syncthreads();

    const int n = min(CHUNK, count - off);
    for (int j = CHUNK - 1; j >= 0; --j) {
      float gr[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) gr[f] = 0.f;
      bool live = false;
      if (j < n) {   // uniform across the CTA
        const float mx = s_dat[0 * CHUNK + j] - px;
        const float my = s_dat[1 * CHUNK + j] - py;
        const float a = s_dat[2 * CHUNK + j];
        const float b = s_dat[3 * CHUNK + j];
        const float c = s_dat[4 * CHUNK + j];
        const float op = s_dat[5 * CHUNK + j];
        const float power = -0.5f * (a * mx * mx + c * my * my) - b * mx * my;
        const float G = expf(fminf(power, 0.f));
        const float raw = op * G;
        live = power <= 0.f && raw >= ALPHA_MIN;
        if (live) {
          const float alpha = fminf(raw, ALPHA_MAX);
          const float one_m = fmaxf(1.f - alpha, ONE_M_MIN);
          L = L - log1pf(-alpha);
          const float ti = expf(fminf(fmaxf(L, LOG_FLOOR), 0.f));
          const float wc = alpha * ti;
          float cg = 0.f;
#pragma unroll
          for (int k = 0; k < C; ++k) cg += s_dat[(6 + k) * CHUNK + j] * gA[k];
          if (raw < ALPHA_MAX) {
            const float da = (cg * ti - S / one_m) + -gT * (tfin / one_m);
            const float dp = da * op * G;
            gr[0] = dp * (-(a * mx + b * my));
            gr[1] = dp * (-(c * my + b * mx));
            gr[2] = -0.5f * mx * mx * dp;
            gr[3] = -mx * my * dp;
            gr[4] = -0.5f * my * my * dp;
            gr[5] = da * G;
          }
#pragma unroll
          for (int k = 0; k < C; ++k) gr[6 + k] = wc * gA[k];
          S += cg * wc;
        }
      }
      if (__any_sync(0xffffffffu, live)) {
#pragma unroll
        for (int f = 0; f < NF; ++f) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            gr[f] += __shfl_down_sync(0xffffffffu, gr[f], o);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < NF; ++f) s_red[(warp * NF + f) * CHUNK + j] = gr[f];
      }
    }
    // the carry to the chunk before: max(log T before this chunk, -80)
    L = fmaxf(L, LOG_FLOOR);
    __syncthreads();

    // sum the warps' partials; write the chunk's columns by slot index
    for (int i = tid; i < NF * CHUNK; i += NPIX) {
      const int f = i / CHUNK;
      const int j = i % CHUNK;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) sum += s_red[(w * NF + f) * CHUNK + j];
      gtile[(long long)f * m + off + j] = sum;
    }
  }
}

template <int C>
cudaError_t launch(const float* data, const int* counts, const float* trans,
                   const float* g_acc, const float* g_trans, int ntiles,
                   int d, int m, int grid_w, float* out,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<C>();
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gs_tile_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return e;
  }
  gs_tile_bwd_kernel<C><<<ntiles, NPIX, bytes, stream>>>(
      data, counts, trans, g_acc, g_trans, d, m, grid_w, out);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// data, out [ntiles, d, m] f32 row-major (m a multiple of 128,
// d >= 6 + nchan); counts [ntiles] i32; trans, g_trans [ntiles, 1, 256] and
// g_acc [ntiles, nchan, 256] f32. Every entry of out is written.
extern "C" int gs_tile_bwd(const float* data, const int* counts,
                           const float* trans, const float* g_acc,
                           const float* g_trans, int ntiles, int d, int m,
                           int grid_w, int nchan, float* out, void* stream) {
  if (ntiles <= 0 || grid_w <= 0 || m <= 0 || m % CHUNK != 0 ||
      d < 6 + nchan)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nchan) {
#define GS_TILE_BWD_CASE(C)                                                 \
  case C:                                                                   \
    return (int)launch<C>(data, counts, trans, g_acc, g_trans, ntiles, d,   \
                          m, grid_w, out, s);
    GS_TILE_BWD_CASE(1)
    GS_TILE_BWD_CASE(2)
    GS_TILE_BWD_CASE(3)
    GS_TILE_BWD_CASE(4)
    GS_TILE_BWD_CASE(5)
    GS_TILE_BWD_CASE(6)
#undef GS_TILE_BWD_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* gs_tile_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
