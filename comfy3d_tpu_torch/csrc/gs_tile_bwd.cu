// Per-16-px-tile 3DGS compositor, backward with its per-splat scatter, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel comfy3d_tpu/ops/pallas/gs_tile.py::_bwd_kernel
// (:127, reached through composite_tiles_bwd :240) together with the XLA
// scatter that follows it (comfy3d_tpu/ops/gs_render.py:534-537). The
// Python wrapper and the plain PyTorch version are
// comfy3d_tpu_torch/ops/gs_tile.py::composite_tiles_bwd_splats.
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
// The per-pixel values are summed over the tile's 256 pixels, and each
// walked, valid slot's sums are added into its splat's row prim_idx[t, j]
// of g [n, 6 + C]: d mu_x, d mu_y, d a, d b, d c, d op, d chan_0..C-1.
// Invalid slots and slots past the count add nothing.
//
// Hazard, shared with the reference and kept for parity (ROADMAP §C): where
// T underflows below e^-80 within a chunk, the rebuild from the floored
// log T_fin overstates every T_i before it in that chunk, so the gradient
// there is not the composited list's.
//
// Bound: operations (~17 f32 operations and one exp per slot-pixel visit,
// ~10 + 4C more, one log1p and one exp per live one, ~34 more per
// unsaturated one), not bytes (a slot's 6 + C values are shared by 256
// pixels, and the output is one row per splat).
// Design: one CTA per tile, one thread per pixel, each chunk staged in
// shared memory (one 16-byte aligned row per slot) and cut into sub-chunks
// of 16 slots, each in two phases (gs_bwd_common.cuh): A, the pixel-major
// walk above, writes dG = d a G and wc = a T_i per (slot, pixel) to shared
// memory; B, slot-major, gives each half-warp lane one slot and each warp
// 32 pixels, so a slot's 6 + C sums cost one pass over shared memory and a
// sum of the 8 warps' partials, not the up to 8 x 5 (6 + C) warp shuffles
// and the cross-warp pass per slot of a per-slot design. The sums go
// straight into the splat rows with atomicAdd: a splat sits in ~6 tiles,
// so contention is low, and no [T, D, M] columns are written, zero-filled
// or scattered. The atomics' order varies, so the rows vary from run to run
// in their last bits. ~50 KB of shared memory per CTA (C = 4) leaves room
// for 4 CTAs per SM.
//
// Built with -fmad=false, as the forward is: the power and alpha round as
// the forward's do, so the 1/255 and 0.99 cuts fall on the same visits.
// Only those decisions must round as the forward's: d a is formed with one
// correctly rounded reciprocal of one_m, not two divisions.

#include <cuda_runtime.h>

#include "gs_bwd_common.cuh"

namespace {

using namespace gs_bwd;

template <int C>
__global__ void __launch_bounds__(NPIX, 4)
gs_tile_bwd_kernel(const float* __restrict__ data,
                   const int* __restrict__ counts,
                   const long long* __restrict__ prim_idx,
                   const unsigned char* __restrict__ valid,
                   const float* __restrict__ trans,
                   const float* __restrict__ g_acc,
                   const float* __restrict__ g_trans, int d, int m,
                   int grid_w, long long n_rows, float* __restrict__ g) {
  using L = Smem<C>;
  constexpr int NF = L::NF;
  extern __shared__ __align__(16) float smem[];
  float* s_dat = smem + L::DAT;                          // [CHUNK][NFS]
  int* s_row = reinterpret_cast<int*>(smem + L::ROW);    // [CHUNK]

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int count = min(max(counts[t], 0), m);
  const int nsteps = (count + CHUNK - 1) / CHUNK;
  if (nsteps == 0) return;   // uniform: an empty tile adds nothing
  const float ox = (float)((t % grid_w) * TILE) + 0.5f;
  const float oy = (float)((t / grid_w) * TILE) + 0.5f;
  const float px = (float)(tid % TILE) + ox;
  const float py = (float)(tid / TILE) + oy;
  const float* tile = data + (long long)t * d * m;

  const float tfin = trans[(long long)t * NPIX + tid];
  const float gT = g_trans[(long long)t * NPIX + tid];
  float gA[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    gA[k] = g_acc[((long long)t * C + k) * NPIX + tid];
    smem[L::GA + k * NPIX + tid] = gA[k];
  }
  float Lg = logf(fmaxf(tfin, T_FLOOR));
  float S = 0.f;
  float* my_dg = smem + L::DG + tid * SPAD;
  float* my_wc = smem + L::WC + tid * SPAD;

  for (int q = nsteps - 1; q >= 0; --q) {
    const int off = q * CHUNK;
    __syncthreads();   // the previous chunk's readers are done
    for (int i = tid; i < NF * CHUNK; i += NPIX) {
      const int f = i / CHUNK;
      const int j = i % CHUNK;
      s_dat[j * L::NFS + f] = tile[(long long)f * m + off + j];
    }
    if (tid < CHUNK) {
      const long long e = (long long)t * m + off + tid;
      const long long row = prim_idx[e];
      s_row[tid] = (off + tid < count && valid[e] && row >= 0 && row < n_rows)
                       ? (int)row : -1;
    }
    __syncthreads();

    const int n = min(CHUNK, count - off);
    for (int j0 = ((n - 1) / SUB) * SUB; j0 >= 0; j0 -= SUB) {
      const int jn = min(SUB, n - j0);
      // A: this pixel's walk over the sub-chunk, back to front
      for (int jl = jn - 1; jl >= 0; --jl) {
        const int j = j0 + jl;
        float4 v0, v1;   // mu_x, mu_y, a, b; c, op, chan_0, chan_1
        slot_head<C>(smem, j, v0, v1);
        const float mx = v0.x - px;
        const float my = v0.y - py;
        const float a = v0.z, b = v0.w, c = v1.x, op = v1.y;
        const float power = power_of(a, b, c, mx, my);
        const float G = expf(fminf(power, 0.f));
        const float raw = op * G;
        float dg = 0.f, wc = 0.f;
        if (power <= 0.f && raw >= ALPHA_MIN) {
          const float alpha = fminf(raw, ALPHA_MAX);
          const float one_m = fmaxf(1.f - alpha, ONE_M_MIN);
          Lg = Lg - log1pf(-alpha);
          const float ti = expf(fminf(fmaxf(Lg, LOG_FLOOR), 0.f));
          wc = alpha * ti;
          float cg = 0.f;
#pragma unroll
          for (int k = 0; k < C; ++k) cg += slot_chan<C>(smem, j, v1, k) * gA[k];
          if (raw < ALPHA_MAX) {
            const float r = __frcp_rn(one_m);
            const float da = cg * ti - (S + gT * tfin) * r;
            dg = da * G;
          }
          S += cg * wc;
        }
        my_dg[jl] = dg;
        my_wc[jl] = wc;
      }
      __syncthreads();
      // B: the sub-chunk's sums, slot-major
      slot_sums<C>(smem, j0, jn, ox, oy);
      __syncthreads();
      add_rows<C>(smem, j0, jn, g);
    }
    // the carry to the chunk before: max(log T before this chunk, -80)
    Lg = fmaxf(Lg, LOG_FLOOR);
  }
}

template <int C>
cudaError_t launch(const float* data, const int* counts,
                   const long long* prim_idx, const unsigned char* valid,
                   const float* trans, const float* g_acc,
                   const float* g_trans, int ntiles, int d, int m, int grid_w,
                   long long n_rows, float* g, cudaStream_t stream) {
  constexpr int bytes = Smem<C>::BYTES;
  const cudaError_t e = allow_smem(gs_tile_bwd_kernel<C>, bytes);
  if (e != cudaSuccess) return e;
  gs_tile_bwd_kernel<C><<<ntiles, NPIX, bytes, stream>>>(
      data, counts, prim_idx, valid, trans, g_acc, g_trans, d, m, grid_w,
      n_rows, g);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// data [ntiles, d, m] f32 row-major (m a multiple of 128, d >= 6 + nchan);
// counts [ntiles] i32; prim_idx [ntiles, m] i64 and valid [ntiles, m] bool
// (1 byte); trans, g_trans [ntiles, 1, 256] and g_acc [ntiles, nchan, 256]
// f32; g [n_rows, 6 + nchan] f32, zeroed by the caller, which the walked,
// valid slots' sums are added into.
extern "C" int gs_tile_bwd(const float* data, const int* counts,
                           const long long* prim_idx,
                           const unsigned char* valid, const float* trans,
                           const float* g_acc, const float* g_trans,
                           int ntiles, int d, int m, int grid_w, int nchan,
                           long long n_rows, float* g, void* stream) {
  if (ntiles <= 0 || grid_w <= 0 || m <= 0 || m % CHUNK != 0 ||
      d < 6 + nchan || n_rows <= 0 || n_rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nchan) {
#define GS_TILE_BWD_CASE(C)                                                 \
  case C:                                                                   \
    return (int)launch<C>(data, counts, prim_idx, valid, trans, g_acc,      \
                          g_trans, ntiles, d, m, grid_w, n_rows, g, s);
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
