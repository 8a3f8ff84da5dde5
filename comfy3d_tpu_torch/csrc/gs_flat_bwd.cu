// Coarse-bin 3DGS compositor, backward with its per-splat scatter, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel comfy3d_tpu/ops/pallas/gs_flat.py::_bwd_kernel
// (:552, reached through composite_bins_bwd :730) together with the XLA
// scatter that follows it (comfy3d_tpu/ops/gs_render.py:641-644). The
// Python wrapper and the plain PyTorch version are
// comfy3d_tpu_torch/ops/gs_flat.py::composite_bins_bwd_splats.
//
// What it computes, for sub-tile s of coarse bin t: the forward
// (gs_flat_fwd.cu) walked the bin's pairs front to back in 128-pair chunks
// and the sub-tile composited the first stops[t, s] of them. Here each
// in-image sub-tile's prefix is walked back to front. Per pixel, from the
// forward's final T and the cotangents g_acc [C] and g_T:
//   log T = log(max(T_fin, e^-80))   (T can underflow to 0 in the last chunk)
//   S = 0                            (sum over later pairs of chan.g_acc a T)
// and per visited pair i (footprint bit set, raw = op G >= 1/255), in the
// forward's operations and order, so every live/unsat decision is its own:
//   log T_i = clamp(log T - log(max(1 - a, 0.01)), -80, 0), T_i = exp(.)
//   d a     = [raw < 0.99] (chan.g_acc T_i - S/(1-a) - g_T T_fin/(1-a))
//   S      += chan.g_acc a T_i,  log T = log T_i
//   d power = d a op G [power <= 0]; d mu, d conic from the power's
//   derivatives in dx, dy; d op += d a G; d chan_k += a T_i g_acc_k.
// The per-pixel values are summed over the sub-tile's pixels and added
// into the pair's splat row sprim[g] of g [n, 6 + C]: d mu_x, d mu_y, d a,
// d b, d c, d op, d chan_0..C-1. Pairs outside every walked prefix, or
// whose 3σ square misses the sub-tile, add nothing.
//
// Hazard, shared with the reference and kept for parity (ROADMAP §C): where
// T underflows below e^-80 in the last walked chunk, the rebuild from the
// floored log T_fin overstates T_i there.
//
// Bound: operations (~75 f32 operations, one log and two exps per live
// pair-pixel visit), not bytes (a pair's payload is shared by every pixel
// of its sub-tiles, and the output is one row per splat).
// Design: one CTA per 16-px sub-tile (nbins x NSUB CTAs), one thread per
// pixel, so each thread carries one pixel's state, the card gets NSUB times
// a one-CTA-per-bin grid, and a bin's longest serial walk is split
// over its sub-tiles. Each CTA stages its bin's chunk in shared memory
// (one 16-byte aligned row per pair), compacted to the pairs whose
// footprint bit is set for this sub-tile (a ballot per warp keeps their
// order), then walks it in sub-chunks of 16 pairs in the two phases of
// gs_bwd_common.cuh: A, the pixel-major walk above, writes dG = d a G and
// wc = a T_i per (pair, pixel) to shared memory (wc negated where the
// power is positive, which this kernel's visit test lets be live: phase B
// then leaves d power out); B, slot-major, sums them per pair with one
// half-warp lane per pair, where a per-slot design spends up to
// 8 x 5 (6 + C) warp shuffles per pair. The sums go straight into the
// splat rows with atomicAdd: the four sub-tiles of a bin may add into one
// pair's splat, and a splat has at most k = 4 bins, so contention is low.
// The atomics' order varies, so the rows vary from run to run in their last
// bits. ~50 KB of shared memory per CTA (C = 4) leaves room for 4 CTAs per
// SM.
//
// Built with -fmad=false, as the forward is: the power and alpha round as
// the forward's do, so the 1/255 and 0.99 cuts fall on the same visits.
// Only those decisions must round as the forward's: d a is formed with one
// correctly rounded reciprocal of one_m, not two divisions.

#include <cuda_runtime.h>

#include "gs_bwd_common.cuh"

namespace {

using namespace gs_bwd;

__device__ __forceinline__ long long floor_to_chunk(long long x) {
  long long q = x / CHUNK;
  if (x < 0 && q * CHUNK != x) --q;
  return q * CHUNK;
}

template <int C, int SUBN>
__global__ void __launch_bounds__(NPIX, 4)
gs_flat_bwd_kernel(const float* __restrict__ data, long long ppad,
                   const int* __restrict__ bounds,
                   const long long* __restrict__ sprim, long long nsprim,
                   const float* __restrict__ trans,
                   const int* __restrict__ stops,
                   const float* __restrict__ g_acc,
                   const float* __restrict__ g_trans, int nbins_x, int width,
                   int height, long long n_rows, float* __restrict__ g) {
  constexpr int NSUB = SUBN * SUBN;
  using L = Smem<C>;
  constexpr int NF = L::NF;   // staged rows: mu_x, mu_y (bin-local), a, b, c, op, chans
  extern __shared__ __align__(16) float smem[];
  float* s_dat = smem + L::DAT;                          // [CHUNK][NFS]
  int* s_row = reinterpret_cast<int*>(smem + L::ROW);    // [CHUNK]
  int* s_cnt = reinterpret_cast<int*>(smem + L::CNT);    // [NWARP]

  const int cta = blockIdx.x;   // = t * NSUB + s
  const int t = cta / NSUB;
  const int s = cta % NSUB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bin_x = t % nbins_x;
  const int bin_y = t / nbins_x;
  const bool in_img = (bin_x * SUBN + s % SUBN) * TILE < width &&
                      (bin_y * SUBN + s / SUBN) * TILE < height;
  const int stop = stops[cta];
  if (!in_img || stop <= 0) return;   // uniform: nothing was composited
  const float bin_ox = (float)(bin_x * SUBN * TILE);
  const float bin_oy = (float)(bin_y * SUBN * TILE);
  const float sx0 = (float)((s % SUBN) * TILE);
  const float sy0 = (float)((s / SUBN) * TILE);
  const float px0 = sx0 + 0.5f;
  const float py0 = sy0 + 0.5f;
  const float px = (float)(tid % TILE) + px0;   // bin-local pixel centre
  const float py = (float)(tid / TILE) + py0;

  const long long b0 = bounds[t];
  const long long b1 = bounds[t + 1];
  const long long b0_al = floor_to_chunk(b0);

  const float tfin = trans[(long long)cta * NPIX + tid];
  const float gT = g_trans[(long long)cta * NPIX + tid];
  float gA[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    gA[k] = g_acc[((long long)cta * C + k) * NPIX + tid];
    smem[L::GA + k * NPIX + tid] = gA[k];
  }
  float logT = logf(fmaxf(tfin, T_FLOOR));
  float S = 0.f;
  float* my_dg = smem + L::DG + tid * SPAD;
  float* my_wc = smem + L::WC + tid * SPAD;

  for (int q = stop - 1; q >= 0; --q) {
    // stage chunk q, compacted to the pairs this sub-tile's footprint test
    // keeps, in their order
    const long long gi = b0_al + (long long)q * CHUNK + tid;
    bool hit = false;
    float mxl = 0.f, myl = 0.f;
    if (tid < CHUNK && gi >= b0 && gi < b1 && gi >= 0 && gi < ppad &&
        gi < nsprim) {
      mxl = data[gi] - bin_ox;
      myl = data[ppad + gi] - bin_oy;
      const float r = data[(6 + C) * ppad + gi];
      hit = mxl + r > sx0 && mxl - r < sx0 + TILE && myl + r > sy0 &&
            myl - r < sy0 + TILE;
    }
    const unsigned int ballot = __ballot_sync(0xffffffffu, hit);
    __syncthreads();   // the previous chunk's readers are done
    if (lane == 0) s_cnt[warp] = __popc(ballot);
    __syncthreads();
    int nq = 0, pos = 0;
#pragma unroll
    for (int w = 0; w < CHUNK / 32; ++w) {
      if (w < warp) pos += s_cnt[w];
      nq += s_cnt[w];
    }
    if (hit) {
      pos += __popc(ballot & ((1u << lane) - 1u));
      float* dst = s_dat + pos * L::NFS;
      dst[0] = mxl;
      dst[1] = myl;
#pragma unroll
      for (int f = 2; f < NF; ++f) dst[f] = data[f * ppad + gi];
      const long long row = sprim[gi];
      s_row[pos] = (row >= 0 && row < n_rows) ? (int)row : -1;
    }
    __syncthreads();

    for (int j0 = ((nq - 1) / SUB) * SUB; j0 >= 0 && nq > 0; j0 -= SUB) {
      const int jn = min(SUB, nq - j0);
      // A: this pixel's walk over the sub-chunk, back to front
      for (int jl = jn - 1; jl >= 0; --jl) {
        const int j = j0 + jl;
        float4 v0, v1;   // mu_x, mu_y, a, b; c, op, chan_0, chan_1
        slot_head<C>(smem, j, v0, v1);
        const float dx = px - v0.x;
        const float dy = py - v0.y;
        const float a = v0.z, b = v0.w, c = v1.x, op = v1.y;
        const float power = power_of(a, b, c, dx, dy);
        const float G = expf(fminf(power, 0.f));
        const float raw = op * G;
        float dg = 0.f, wc = 0.f;
        if (raw >= ALPHA_MIN) {
          const float alpha = fminf(raw, ALPHA_MAX);
          const float one_m = fmaxf(1.f - alpha, ONE_M_MIN);
          const float lti = fminf(fmaxf(logT - logf(one_m), LOG_FLOOR), 0.f);
          const float ti = expf(lti);
          float cg = 0.f;
#pragma unroll
          for (int k = 0; k < C; ++k) cg += slot_chan<C>(smem, j, v1, k) * gA[k];
          wc = alpha * ti;
          if (raw < ALPHA_MAX) {
            const float r = __frcp_rn(one_m);
            const float da = cg * ti - (S + gT * tfin) * r;
            dg = da * G;
          }
          S += cg * wc;
          logT = lti;
          if (!(power <= 0.f)) wc = -wc;   // phase B: no d power here
        }
        my_dg[jl] = dg;
        my_wc[jl] = wc;
      }
      __syncthreads();
      // B: the sub-chunk's sums, slot-major
      slot_sums<C>(smem, j0, jn, px0, py0);
      __syncthreads();
      add_rows<C>(smem, j0, jn, g);
    }
  }
}

struct Args {
  const float* data;
  long long ppad;
  const int* bounds;
  const long long* sprim;
  long long nsprim;
  const float* trans;
  const int* stops;
  const float* g_acc;
  const float* g_trans;
  int nbins, nbins_x, width, height;
  long long n_rows;
  float* g;
  cudaStream_t stream;
};

template <int C, int SUBN>
cudaError_t launch(const Args& a) {
  constexpr int bytes = Smem<C>::BYTES;
  const cudaError_t e = allow_smem(gs_flat_bwd_kernel<C, SUBN>, bytes);
  if (e != cudaSuccess) return e;
  gs_flat_bwd_kernel<C, SUBN>
      <<<a.nbins * SUBN * SUBN, NPIX, bytes, a.stream>>>(
          a.data, a.ppad, a.bounds, a.sprim, a.nsprim, a.trans, a.stops,
          a.g_acc, a.g_trans, a.nbins_x, a.width, a.height, a.n_rows, a.g);
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
// data [dpay, ppad] f32 row-major; bounds [nbins + 1] i32; sprim [nsprim]
// i64 (the splat of each pair); trans, g_trans [nbins, sub_n^2, 1, 256]
// f32; stops [nbins, sub_n^2] i32; g_acc [nbins, sub_n^2, nchan, 256] f32;
// g [n_rows, 6 + nchan] f32, zeroed by the caller, which the walked pairs'
// sums are added into.
extern "C" int gs_flat_bwd(const float* data, long long ppad, int dpay,
                           const int* bounds, const long long* sprim,
                           long long nsprim,
                           const float* trans,
                           const int* stops, const float* g_acc,
                           const float* g_trans, int nbins, int nbins_x,
                           int nchan, int sub_n, int width, int height,
                           long long n_rows, float* g, void* stream) {
  if (nbins <= 0 || nbins_x <= 0 || dpay < 7 + nchan || n_rows <= 0 ||
      n_rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Args a{data, ppad, bounds, sprim, nsprim, trans, stops, g_acc,
               g_trans, nbins, nbins_x, width, height, n_rows, g,
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
