// Coarse-bin 3DGS compositor, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel comfy3d_tpu/ops/pallas/gs_flat.py::_bwd_kernel
// (:552, reached through composite_bins_bwd :730). The Python wrapper and
// the plain PyTorch version are comfy3d_tpu_torch/ops/gs_flat.py.
//
// What it computes, for coarse bin t: the forward (gs_flat_fwd.cu) walked
// the bin's pairs front to back in 128-pair chunks and sub-tile s composited
// the first stops[t, s] of them. Here each in-image sub-tile's prefix is
// walked back to front. Per pixel, from the forward's final T and the
// cotangents g_acc [C] and g_T:
//   log T = log(max(T_fin, e^-80))   (T can underflow to 0 in the last chunk)
//   S = 0                            (sum over later pairs of chan.g_acc a T)
// and per visited pair i (footprint bit set, raw = op G >= 1/255), in the
// forward's operations and order, so every live/unsat decision is its own:
//   log T_i = clamp(log T - log(max(1 - a, 0.01)), -80, 0), T_i = exp(.)
//   d a     = [raw < 0.99] (chan.g_acc T_i - S/(1-a) - g_T T_fin/(1-a))
//   S      += chan.g_acc a T_i,  log T = log T_i
//   d power = d a op G [power <= 0]; d mu, d conic from the power's
//   derivatives in dx, dy; d op += d a G; d chan_k += a T_i g_acc_k.
// The per-pixel values are summed over the bin's pixels into the pair's
// column of out [DG, ppad]: rows d mu_x, d mu_y, d a, d b, d c, d op,
// d chan_0..C-1 (rows up to DG and unwalked columns stay as the caller
// zeroed them).
//
// Bound: operations (~75 f32 operations, one log and two exps per live
// pair-pixel visit), not bytes (a pair's payload and its gradient column
// are shared by every pixel of its bin).
// Design: one CTA per bin, one thread per pixel of each sub-tile (NSUB
// pixels per thread; log T, S, T_fin, g_T and g_acc in registers). Each
// chunk is staged in shared memory with its per-sub-tile footprint bits,
// masked to the sub-tiles whose prefix holds the chunk, as the forward
// stages it. Each pair's 6 + C sums are reduced by warp shuffles into one
// shared-memory slot per warp (a warp whose lanes have nothing writes
// zeros without shuffling), then summed over the 8 warps after the chunk
// and written by pair index. A pair belongs to one bin only, so no two
// CTAs write one column: no atomics, and the sums are deterministic.
//
// Built with -fmad=false, as the forward is: the power and alpha round as
// the forward's do, so the 1/255 and 0.99 cuts fall on the same visits.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;   // threads per CTA
constexpr int NWARP = NPIX / 32;
constexpr int CHUNK = 128;          // pairs per staged chunk (<= NPIX)
// f32 roundings of the same double constants the plain version uses
constexpr float ALPHA_MAX = (float)0.99;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ONE_M_MIN = (float)(1.0 - 0.99);
constexpr float LOG_FLOOR = -80.f;
constexpr float T_FLOOR = (float)1.8048513878454153e-35;   // e^-80

__device__ __forceinline__ long long floor_to_chunk(long long x) {
  long long q = x / CHUNK;
  if (x < 0 && q * CHUNK != x) --q;
  return q * CHUNK;
}

template <int C>
constexpr int smem_bytes() {
  // s_pay [6 + C][CHUNK], s_red [NWARP][6 + C][CHUNK], s_ov [CHUNK]
  return (int)(sizeof(float) * (6 + C) * CHUNK * (1 + NWARP) +
               sizeof(unsigned int) * CHUNK);
}

template <int C, int SUB>
__global__ void __launch_bounds__(NPIX)
gs_flat_bwd_kernel(const float* __restrict__ data, long long ppad,
                   const int* __restrict__ bounds,
                   const float* __restrict__ trans,
                   const int* __restrict__ stops,
                   const float* __restrict__ g_acc,
                   const float* __restrict__ g_trans, int nbins_x, int width,
                   int height, float* __restrict__ out) {
  constexpr int NSUB = SUB * SUB;
  constexpr int NF = 6 + C;   // staged rows: mu_x, mu_y (bin-local), a, b, c, op, chans
  extern __shared__ float smem[];
  float* s_pay = smem;                                  // [NF][CHUNK]
  float* s_red = smem + NF * CHUNK;                     // [NWARP][NF][CHUNK]
  unsigned int* s_ov =
      reinterpret_cast<unsigned int*>(s_red + NWARP * NF * CHUNK);

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bin_x = t % nbins_x;
  const int bin_y = t / nbins_x;
  const float bin_ox = (float)(bin_x * SUB * TILE);
  const float bin_oy = (float)(bin_y * SUB * TILE);

  const long long b0 = bounds[t];
  const long long b1 = bounds[t + 1];
  const long long b0_al = floor_to_chunk(b0);

  const float lx = (float)(tid % TILE);
  const float ly = (float)(tid / TILE);
  float px[NSUB], py[NSUB], logT[NSUB], S[NSUB], tfin[NSUB], gT[NSUB];
  float gA[NSUB][C];
  int stop[NSUB];
  unsigned int draw = 0;   // sub-tiles inside the image
  int qmax = 0;            // chunks to walk: the longest in-image prefix
#pragma unroll
  for (int s = 0; s < NSUB; ++s) {
    const float sx0 = (float)((s % SUB) * TILE);
    const float sy0 = (float)((s / SUB) * TILE);
    px[s] = lx + (sx0 + 0.5f);
    py[s] = ly + (sy0 + 0.5f);
    const bool in_img = (bin_x * SUB + s % SUB) * TILE < width &&
                        (bin_y * SUB + s / SUB) * TILE < height;
    const long long base = (long long)t * NSUB + s;
    stop[s] = stops[base];
    if (in_img) {
      draw |= 1u << s;
      qmax = max(qmax, stop[s]);
    }
    tfin[s] = trans[base * NPIX + tid];
    gT[s] = g_trans[base * NPIX + tid];
#pragma unroll
    for (int k = 0; k < C; ++k) gA[s][k] = g_acc[(base * C + k) * NPIX + tid];
    logT[s] = logf(fmaxf(tfin[s], T_FLOOR));
    S[s] = 0.f;
  }

  for (long long q = qmax - 1; q >= 0; --q) {
    unsigned int walk = 0;   // sub-tiles whose prefix holds chunk q (uniform)
#pragma unroll
    for (int s = 0; s < NSUB; ++s)
      if (((draw >> s) & 1u) && q < stop[s]) walk |= 1u << s;

    __syncthreads();   // the previous chunk's readers are done
    if (tid < CHUNK) {
      const long long g = b0_al + q * CHUNK + tid;
      unsigned int ov = 0;
      if (g >= b0 && g < b1 && g >= 0 && g < ppad) {
        const float mxl = data[g] - bin_ox;
        const float myl = data[ppad + g] - bin_oy;
        const float r = data[(6 + C) * ppad + g];
#pragma unroll
        for (int s = 0; s < NSUB; ++s) {
          const float sx0 = (float)((s % SUB) * TILE);
          const float sy0 = (float)((s / SUB) * TILE);
          if (mxl + r > sx0 && mxl - r < sx0 + TILE &&
              myl + r > sy0 && myl - r < sy0 + TILE)
            ov |= 1u << s;
        }
        s_pay[0 * CHUNK + tid] = mxl;
        s_pay[1 * CHUNK + tid] = myl;
#pragma unroll
        for (int f = 2; f < NF; ++f) s_pay[f * CHUNK + tid] = data[f * ppad + g];
      }
      s_ov[tid] = ov & walk;
    }
    __syncthreads();

    for (int j = CHUNK - 1; j >= 0; --j) {
      const unsigned int ov = s_ov[j];
      if (ov == 0) continue;   // uniform across the CTA
      const float mxl = s_pay[0 * CHUNK + j];
      const float myl = s_pay[1 * CHUNK + j];
      const float a = s_pay[2 * CHUNK + j];
      const float b = s_pay[3 * CHUNK + j];
      const float c = s_pay[4 * CHUNK + j];
      const float op = s_pay[5 * CHUNK + j];
      float ch[C];
#pragma unroll
      for (int k = 0; k < C; ++k) ch[k] = s_pay[(6 + k) * CHUNK + j];
      float gr[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) gr[f] = 0.f;
      bool any = false;
#pragma unroll
      for (int s = 0; s < NSUB; ++s) {
        if (!((ov >> s) & 1u)) continue;
        const float dx = px[s] - mxl;
        const float dy = py[s] - myl;
        const float power = -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
        const float G = expf(fminf(power, 0.f));
        const float raw = op * G;
        if (raw >= ALPHA_MIN) {
          any = true;
          const float alpha = fminf(raw, ALPHA_MAX);
          const float one_m = fmaxf(1.f - alpha, ONE_M_MIN);
          const float lti =
              fminf(fmaxf(logT[s] - logf(one_m), LOG_FLOOR), 0.f);
          const float ti = expf(lti);
          float cg = 0.f;
#pragma unroll
          for (int k = 0; k < C; ++k) cg += ch[k] * gA[s][k];
          const float w = alpha * ti;
          if (raw < ALPHA_MAX) {
            const float da =
                cg * ti - S[s] / one_m - gT[s] * (tfin[s] / one_m);
            gr[5] += da * G;
            if (power <= 0.f) {
              const float dp = da * op * G;
              gr[0] += dp * (a * dx + b * dy);
              gr[1] += dp * (c * dy + b * dx);
              gr[2] += -0.5f * dp * dx * dx;
              gr[3] += -dp * dx * dy;
              gr[4] += -0.5f * dp * dy * dy;
            }
          }
#pragma unroll
          for (int k = 0; k < C; ++k) gr[6 + k] += w * gA[s][k];
          S[s] += cg * w;
          logT[s] = lti;
        }
      }
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int f = 0; f < NF; ++f) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            gr[f] += __shfl_down_sync(0xffffffffu, gr[f], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < NF; ++f) s_red[(warp * NF + f) * CHUNK + j] = gr[f];
      }
    }
    __syncthreads();

    // Sum the warps' partials; write the walked pairs' columns by index
    // (s_ov[j] != 0 only for pairs of this bin's segment).
    for (int i = tid; i < NF * CHUNK; i += NPIX) {
      const int f = i / CHUNK;
      const int j = i % CHUNK;
      if (s_ov[j] == 0) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) sum += s_red[(w * NF + f) * CHUNK + j];
      out[f * ppad + (b0_al + q * CHUNK + j)] = sum;
    }
  }
}

struct Args {
  const float* data;
  long long ppad;
  const int* bounds;
  const float* trans;
  const int* stops;
  const float* g_acc;
  const float* g_trans;
  int nbins, nbins_x, width, height;
  float* out;
  cudaStream_t stream;
};

template <int C, int SUB>
cudaError_t launch(const Args& a) {
  constexpr int bytes = smem_bytes<C>();
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gs_flat_bwd_kernel<C, SUB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  gs_flat_bwd_kernel<C, SUB><<<a.nbins, NPIX, bytes, a.stream>>>(
      a.data, a.ppad, a.bounds, a.trans, a.stops, a.g_acc, a.g_trans,
      a.nbins_x, a.width, a.height, a.out);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_sub(int sub_n, const Args& a) {
  switch (sub_n) {
    case 2: return launch<C, 2>(a);
    case 3: return launch<C, 3>(a);
    case 4: return launch<C, 4>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// data [dpay, ppad] f32 row-major; bounds [nbins + 1] i32;
// trans, g_trans [nbins, sub_n^2, 1, 256] f32; stops [nbins, sub_n^2] i32;
// g_acc [nbins, sub_n^2, nchan, 256] f32; out [dg, ppad] f32, zeroed by the
// caller (rows 0..5+nchan of the walked pairs' columns are written).
extern "C" int gs_flat_bwd(const float* data, long long ppad, int dpay,
                           const int* bounds, const float* trans,
                           const int* stops, const float* g_acc,
                           const float* g_trans, int nbins, int nbins_x,
                           int nchan, int sub_n, int width, int height,
                           float* out, int dg, void* stream) {
  if (nbins <= 0 || nbins_x <= 0 || dpay < 7 + nchan || dg < 6 + nchan)
    return (int)cudaErrorInvalidValue;
  const Args a{data, ppad, bounds, trans, stops, g_acc, g_trans, nbins,
               nbins_x, width, height, out,
               static_cast<cudaStream_t>(stream)};
  switch (nchan) {
    case 1: return (int)launch_sub<1>(sub_n, a);
    case 2: return (int)launch_sub<2>(sub_n, a);
    case 3: return (int)launch_sub<3>(sub_n, a);
    case 4: return (int)launch_sub<4>(sub_n, a);
    case 5: return (int)launch_sub<5>(sub_n, a);
    case 6: return (int)launch_sub<6>(sub_n, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* gs_flat_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
