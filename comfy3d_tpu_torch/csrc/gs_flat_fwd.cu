// Coarse-bin 3DGS compositor, forward, with its pair-row gather, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels comfy3d_tpu/ops/pallas/gs_flat.py::_fwd_kernel_merged
// (:339, merged = 1) and ::_fwd_kernel (:198, merged = 0), together with
// the gather of the pair payload that feeds them (comfy3d_tpu/ops/
// gs_render.py:601). The Python wrapper and the plain PyTorch version are
// comfy3d_tpu_torch/ops/gs_flat.py::composite_bins_fwd_rows.
//
// What it computes, for coarse bin t (SUB x SUB sub-tiles of 16 px): the
// bin's depth-sorted pairs g in [bounds[t], bounds[t+1]), pair g holding
// splat row rows[sprim[g]] (mu_x, mu_y, conic a, b, c, opacity, C channels,
// 3-sigma radius, zero pad: D floats), are walked front to back in 128-pair
// chunks, counted from bounds[t] rounded down to a multiple of 128 (the
// slots before bounds[t] are dead). Per pixel:
//   alpha = min(op * exp(min(power, 0)), 0.99), 0 where op*G < 1/255 or the
//           pair's 3-sigma square misses the pixel's 16-px sub-tile;
//   acc += chan * alpha * T;   T *= 1 - alpha.
// Before each chunk a group whose largest T is below EPS_T stops: the whole
// bin when merged (sub-tiles whose origin is outside the image start at
// T = 0), else each in-image sub-tile on its own (out-of-image sub-tiles keep
// acc 0, T 1, stops 0). stops = chunks composited, per sub-tile; the
// backward (gs_flat_bwd.cu) walks exactly that prefix. Indices outside
// [0, n) read as a zero row.
//
// Bound: operations (~20 f32 ops and one exp per pair-pixel visit), not
// bytes (a pair's row is shared by every pixel of its sub-tiles).
// Design:
//  * One CTA per 16-px sub-tile, one thread per pixel (acc and T in
//    registers), so a bin's serial walk is split over SUB^2 CTAs (2,500 at
//    800^2 and bin_px 32, where one CTA per bin gives 625). The sub-tiles
//    of a bin form one thread-block cluster. In merged mode each CTA
//    reduces its own vote (__syncthreads_or), posts it in its shared
//    memory, and after a cluster barrier reads its peers' votes through
//    distributed shared memory: the bin stops when none has T >= EPS_T. The
//    votes are double-buffered by the chunk's parity, so the one cluster
//    barrier per chunk also guards their reuse; a last barrier keeps every
//    CTA's shared memory alive until its peers have read it. Clusters of 9
//    and 16 CTAs (bin_px 48, 64) are beyond the portable 8 and are asked
//    for as non-portable (the H100 allows 16). In per-sub-tile mode no
//    cluster barrier is used.
//  * Gather in the kernel: threads 0..127 read a chunk's pair indices
//    (a chunk ahead, into registers) and copy the rows with cp.async into a
//    two-stage ring (gs_fwd_common.cuh), so chunk q + 1 streams in while
//    chunk q is walked. The thread that copied a pair tests its 3-sigma
//    square against the CTA's sub-tile and computes its box; a ballot per
//    warp compacts the chunk, in order, to the pairs that hit the sub-tile,
//    so a pair that misses costs no iteration.
//  * Dead visits skipped a warp at a time through the conservative box of
//    gs_fwd_common.cuh, as in gs_tile_fwd.cu: each warp walks, in order,
//    only the compacted pairs whose box meets its two pixel rows, and every
//    visit it walks runs the exact test in the reference's operations and
//    order, so the live decisions, the exit votes and the stops are those
//    of the full walk.
//  * Tensor cores are not used: the one matrix product of the TPU kernels
//    is colours [128, C] x weights [128, 256] per chunk with C = 4; here
//    each weight hangs on its pixel's serial T chain, and TF32 would break
//    the 1e-4 parity.
//
// Built with -fmad=false: the power and alpha are rounded operation by
// operation as the plain version rounds them, so the 1/255 cut falls on the
// same pair-pixel visits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gs_fwd_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace gs_fwd;

constexpr float EPS_T = (float)1.0e-3;

// the pair rows' width: 7 + C values padded to a multiple of 8
template <int C>
__host__ __device__ constexpr int rows_d() { return (7 + C + 7) / 8 * 8; }

__device__ __forceinline__ long long floor_to_chunk(long long x) {
  long long q = x / CHUNK;
  if (x < 0 && q * CHUNK != x) --q;
  return q * CHUNK;
}

template <int C, int SUB>
__global__ void __launch_bounds__(NPIX, 6)
gs_flat_fwd_kernel(const float* __restrict__ rows, long long n_rows,
                   const long long* __restrict__ sprim, long long nsprim,
                   const int* __restrict__ bounds, int nbins_x, int width,
                   int height, int merged, float* __restrict__ acc,
                   float* __restrict__ trans, int* __restrict__ stops) {
  constexpr int NSUB = SUB * SUB;
  constexpr int D = rows_d<C>();
  __shared__ __align__(16) float s_row[2][CHUNK][D];
  __shared__ float4 s_box[2][CHUNK];
  __shared__ int s_list[CHUNK];   // the chunk's pairs that hit this sub-tile
  __shared__ int s_cnt[CHUNK / 32];
  __shared__ int s_vote[2];

  const int cta = blockIdx.x;   // = t * NSUB + s
  const int t = cta / NSUB;
  const int s = cta % NSUB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bin_x = t % nbins_x;
  const int bin_y = t / nbins_x;
  const bool in_img = (bin_x * SUB + s % SUB) * TILE < width &&
                      (bin_y * SUB + s / SUB) * TILE < height;
  if (!merged && !in_img) {   // uniform: no cluster barrier in this mode
#pragma unroll
    for (int k = 0; k < C; ++k)
      acc[((long long)cta * C + k) * NPIX + tid] = 0.f;
    trans[(long long)cta * NPIX + tid] = 1.f;
    if (tid == 0) stops[cta] = 0;
    return;
  }
  const float bin_ox = (float)(bin_x * SUB * TILE);
  const float bin_oy = (float)(bin_y * SUB * TILE);
  const float sx0 = (float)((s % SUB) * TILE);
  const float sy0 = (float)((s / SUB) * TILE);
  // bin-local pixel centre, and this warp's (two pixel rows)
  const float px = (float)(tid % TILE) + (sx0 + 0.5f);
  const float py = (float)(tid / TILE) + (sy0 + 0.5f);
  const float wx0 = 0.f + (sx0 + 0.5f);
  const float wx1 = 15.f + (sx0 + 0.5f);
  const float wy0 = (float)(2 * warp) + (sy0 + 0.5f);
  const float wy1 = (float)(2 * warp + 1) + (sy0 + 0.5f);

  const long long b0 = bounds[t];
  const long long b1 = bounds[t + 1];
  const long long b0_al = floor_to_chunk(b0);
  const int nchunks = b1 > b0 ? (int)((b1 - b0_al + CHUNK - 1) / CHUNK) : 0;

  // loader thread tid < CHUNK owns pair b0_al + q CHUNK + tid of chunk q
  long long nidx = 0;
  bool nok = false, pq = false, pq1 = false;
  auto fetch = [&](int q) {
    const long long g = b0_al + (long long)q * CHUNK + tid;
    nok = false;
    if (tid < CHUNK && g >= b0 && g < b1 && g >= 0 && g < nsprim) {
      nidx = sprim[g];
      nok = nidx >= 0 && nidx < n_rows;
    }
  };
  auto issue = [&](int buf) {
    if (tid < CHUNK) stage_row<D>(&s_row[buf][tid][0], rows, nidx, nok);
    cp_async_commit();
  };

  float T = (merged && !in_img) ? 0.f : 1.f;
  float A[C];
#pragma unroll
  for (int k = 0; k < C; ++k) A[k] = 0.f;
  int stop = 0;

  if (in_img && nchunks > 0) {
    fetch(0);
    issue(0);
    pq = nok;
    if (nchunks > 1) fetch(1);
  }
  cg::cluster_group cluster = cg::this_cluster();
  for (int q = 0; q < nchunks; ++q) {
    const int buf = q & 1;
    // saturation vote; also the barrier after chunk q - 1's readers
    const int mine = __syncthreads_or(T >= EPS_T);
    if (merged) {
      if (tid == 0) s_vote[buf] = mine;
      cluster.sync();
      int any = 0;
#pragma unroll
      for (int r = 0; r < NSUB; ++r)
        any |= *cluster.map_shared_rank(&s_vote[buf], r);
      if (!any) break;
    } else if (!mine) {
      break;
    }
    stop = q + 1;
    if (!in_img) continue;   // merged mode: this sub-tile only votes

    if (q + 1 < nchunks) {
      issue(buf ^ 1);
      pq1 = nok;
      if (q + 2 < nchunks) fetch(q + 2);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // this thread's own pair, now landed: its footprint test and its box,
    // in the bin-local frame the walk uses
    bool hit = false;
    int rank = 0;   // among the warp's hits
    if (tid < CHUNK) {
      float* r = &s_row[buf][tid][0];
      float4 v0 = reinterpret_cast<float4*>(r)[0];
      const float4 v1 = reinterpret_cast<const float4*>(r)[1];
      const float mxl = v0.x - bin_ox;
      const float myl = v0.y - bin_oy;
      const float rad = r[6 + C];
      hit = pq && mxl + rad > sx0 && mxl - rad < sx0 + TILE &&
            myl + rad > sy0 && myl - rad < sy0 + TILE;
      if (hit) {
        v0.x = mxl;
        v0.y = myl;
        reinterpret_cast<float4*>(r)[0] = v0;
        s_box[buf][tid] = box_of(mxl, myl, v0.z, v0.w, v1.x, v1.y);
      }
      const unsigned int ballot = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_cnt[warp] = __popc(ballot);
      rank = __popc(ballot & ((1u << lane) - 1u));
    }
    pq = pq1;
    __syncthreads();
    int nq = 0;
#pragma unroll
    for (int w = 0; w < CHUNK / 32; ++w) nq += s_cnt[w];
    if (hit) {   // compacted, in order
      int pos = rank;
#pragma unroll
      for (int w = 0; w < CHUNK / 32; ++w)
        if (w < warp) pos += s_cnt[w];
      s_list[pos] = tid;
    }
    __syncthreads();

    unsigned int hits[CHUNK / 32];   // this warp's pairs, in order
    warp_hits(s_box[buf], s_list, nq, wx0, wx1, wy0, wy1, hits);
#pragma unroll
    for (int k = 0; k < CHUNK / 32; ++k) {
      for (unsigned int m = hits[k]; m != 0u; m &= m - 1u) {
        const int slot = s_list[32 * k + __ffs(m) - 1];
        const float* r = &s_row[buf][slot][0];
        const float4 v0 = reinterpret_cast<const float4*>(r)[0];
        const float4 v1 = reinterpret_cast<const float4*>(r)[1];
        const float mxl = v0.x;
        const float myl = v0.y;
        const float a = v0.z;
        const float b = v0.w;
        const float c = v1.x;
        const float op = v1.y;
        const float dx = px - mxl;
        const float dy = py - myl;
        const float power = -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
        const float G = expf(fminf(power, 0.f));
        const float raw = op * G;
        if (raw >= ALPHA_MIN) {
          const float alpha = fminf(raw, ALPHA_MAX);
          const float w = alpha * T;
#pragma unroll
          for (int k2 = 0; k2 < C; ++k2) A[k2] += r[6 + k2] * w;
          T *= 1.f - alpha;
        }
      }
    }
  }
  cp_async_wait<0>();   // a stop may leave the next chunk's copies in flight
  // no CTA of the bin leaves while a peer may still read its votes
  if (merged) cluster.sync();

#pragma unroll
  for (int k = 0; k < C; ++k)
    acc[((long long)cta * C + k) * NPIX + tid] = A[k];
  trans[(long long)cta * NPIX + tid] = T;
  if (tid == 0) stops[cta] = stop;
}

struct Args {
  const float* rows;
  long long n_rows;
  const long long* sprim;
  long long nsprim;
  const int* bounds;
  int nbins, nbins_x, width, height, merged;
  float* acc;
  float* trans;
  int* stops;
  cudaStream_t stream;
};

template <int C, int SUB>
cudaError_t launch(const Args& a) {
  constexpr int NSUB = SUB * SUB;
  auto kernel = gs_flat_fwd_kernel<C, SUB>;
  if (NSUB > 8) {   // clusters of 9 and 16 CTAs are not portable
    static bool allowed = false;
    if (!allowed) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return e;
      allowed = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.nbins * NSUB));
  cfg.blockDim = dim3(NPIX);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NSUB;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, a.rows, a.n_rows, a.sprim, a.nsprim, a.bounds,
      a.nbins_x, a.width, a.height, a.merged, a.acc, a.trans, a.stops);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_sub(int sub_n, int d, const Args& a) {
  if (d != rows_d<C>()) return cudaErrorInvalidValue;
  switch (sub_n) {
    case 2: return launch<C, 2>(a);
    case 3: return launch<C, 3>(a);
    case 4: return launch<C, 4>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns the launch's error, or cudaGetLastError()
// after it (0 on success). rows [n_rows, d] f32 row-major (d = 7 + nchan
// padded to a multiple of 8, 16-byte aligned); sprim [nsprim] i64; bounds
// [nbins + 1] i32; acc [nbins, sub_n^2, nchan, 256], trans [nbins, sub_n^2,
// 1, 256] f32; stops [nbins, sub_n^2] i32, every entry written.
extern "C" int gs_flat_fwd(const float* rows, long long n_rows, int d,
                           const long long* sprim, long long nsprim,
                           const int* bounds, int nbins, int nbins_x,
                           int nchan, int sub_n, int width, int height,
                           int merged, float* acc, float* trans, int* stops,
                           void* stream) {
  if (nbins <= 0 || nbins_x <= 0 || n_rows <= 0 ||
      (reinterpret_cast<size_t>(rows) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{rows, n_rows, sprim, nsprim, bounds, nbins, nbins_x, width,
               height, merged ? 1 : 0, acc, trans, stops,
               static_cast<cudaStream_t>(stream)};
  switch (nchan) {
    case 1: return (int)launch_sub<1>(sub_n, d, a);
    case 2: return (int)launch_sub<2>(sub_n, d, a);
    case 3: return (int)launch_sub<3>(sub_n, d, a);
    case 4: return (int)launch_sub<4>(sub_n, d, a);
    case 5: return (int)launch_sub<5>(sub_n, d, a);
    case 6: return (int)launch_sub<6>(sub_n, d, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* gs_flat_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
