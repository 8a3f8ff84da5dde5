// Per-16-px-tile 3DGS compositor, forward, with its splat-row gather, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel comfy3d_tpu/ops/pallas/gs_tile.py::_fwd_kernel
// (:92, reached through composite_tiles_fwd :206) together with the gather
// that feeds it its [T, D, M] block (comfy3d_tpu/ops/gs_render.py:445-462).
// The Python wrapper and the plain PyTorch version are
// comfy3d_tpu_torch/ops/gs_tile.py::composite_tiles_fwd_rows.
//
// What it computes, for tile t of a grid grid_w tiles wide: the tile's
// depth-ordered slot list prim_idx[t] is walked front to back over its
// first min(counts[t], M) slots, slot j holding splat row rows[prim_idx[t,
// j]] (mu_x, mu_y, conic a, b, c, opacity, C channels, zero pad: D floats)
// with its opacity times valid[t, j]. Per pixel (centre (i % 16 + 0.5) +
// ox, (i / 16 + 0.5) + oy):
//   mx = mu_x - px, my = mu_y - py
//   power = -0.5 * (a mx mx + c my my) - b mx my
//   alpha = min(op * exp(min(power, 0)), 0.99), 0 where power > 0 or
//           op * G < 1/255;
//   acc += chan * alpha * T;   T *= 1 - alpha.
// There is no saturation exit: the reference walks every counted slot, and
// the backward (gs_tile_bwd.cu) rebuilds T from the final one. The TPU
// kernel composites a 128-slot chunk at once through a log-space prefix
// (exclusive product floored at e^-80); here T is multiplied slot by slot.
// The two differ in rounding, and where T < e^-80, where each term is below
// 2e-35. When `block` is given, the CTA also writes the tile data the
// backward reads, block[t, f, j] = the staged row's value f (opacity times
// valid), as gs_render.py::_build_tile_data gathers it, for every slot of
// the walked chunks: slots below the count hold their rows; slots from the
// count to the end of the last walked chunk hold zeros (the backward stages
// them and never uses them); chunks past the last walked one are left
// unwritten (the backward never reads them). Indices outside [0, n) read as
// a zero row.
//
// Bound: operations (~17 f32 operations and one exp per slot-pixel visit,
// 4 + 2C more per live one), not bytes (a slot's row and index are shared
// by the tile's 256 pixels).
// Design: one CTA per tile, one thread per pixel (acc and T in registers).
//  * Gather in the kernel: threads 0..127 read a chunk's indices and copy
//    their slots' rows with cp.async into a two-stage ring of shared memory
//    (gs_fwd_common.cuh), slot-major ([CHUNK][D], 16-byte aligned), so
//    chunk q + 1 streams in while chunk q is walked, and a thread reads a
//    slot's first eight values with two float4 broadcasts. The indices are
//    read into registers a chunk ahead of their copies. No [T, D, M] block
//    is materialised unless the backward asks for one.
//  * Dead visits skipped a warp at a time: each staged slot gets the
//    conservative box of gs_fwd_common.cuh around its mean, and each warp
//    (two pixel rows) walks, in order, only the slots whose box meets its
//    rectangle (a ballot per 32 slots gives it their mask). Every visit
//    it walks runs the exact test in the reference's operations and order,
//    so the live decisions, and the output, are those of the full walk.
//  * Tiles run in index order, CTA t on tile t. Taking the longest lists
//    first gains less than sorting the counts costs (PERF.md;
//    chip_fwd_split.py times it as a source variant).
//  * Tensor cores are not used: the only matrix product of the TPU kernel
//    is colours [128, C] x weights [128, 256] per chunk with C = 4, and here
//    each weight hangs on its pixel's serial T chain; TF32 would also break
//    the 1e-4 parity with the plain version.
//
// Built with -fmad=false: the power and alpha are rounded operation by
// operation as the plain version rounds them, so the 1/255 and 0.99 cuts
// fall on the same slot-pixel visits.

#include <cuda_runtime.h>

#include "gs_fwd_common.cuh"

namespace {

using namespace gs_fwd;

// the tile rows' width: 6 + C values padded to a multiple of 8
template <int C>
__host__ __device__ constexpr int rows_d() { return (6 + C + 7) / 8 * 8; }

template <int C>
__global__ void __launch_bounds__(NPIX)
gs_tile_fwd_kernel(const float* __restrict__ rows, long long n_rows,
                   const long long* __restrict__ prim_idx,
                   const unsigned char* __restrict__ valid,
                   const int* __restrict__ counts, int m, int grid_w,
                   float* __restrict__ acc, float* __restrict__ trans,
                   float* __restrict__ block) {
  constexpr int D = rows_d<C>();
  __shared__ __align__(16) float s_row[2][CHUNK][D];
  __shared__ float4 s_box[2][CHUNK];

  const int t = (int)blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int count = min(max(counts[t], 0), m);
  const int nchunks = (count + CHUNK - 1) / CHUNK;
  const float ox = (float)((t % grid_w) * TILE);
  const float oy = (float)((t / grid_w) * TILE);
  const float px = ((float)(tid % TILE) + 0.5f) + ox;
  const float py = ((float)(tid / TILE) + 0.5f) + oy;
  // this warp's pixel centres: tile rows 2 warp and 2 warp + 1
  const float wx0 = 0.5f + ox;
  const float wx1 = 15.5f + ox;
  const float wy0 = ((float)(2 * warp) + 0.5f) + oy;
  const float wy1 = ((float)(2 * warp + 1) + 0.5f) + oy;
  const long long* idx_t = prim_idx + (long long)t * m;
  const unsigned char* valid_t = valid + (long long)t * m;

  // loader thread tid < CHUNK owns slot tid of each chunk: the index and
  // valid flag of the next chunk to copy, and the flag of the chunk copied
  long long nidx = 0;
  bool nok = false, nvalid = false, vq = false, vq1 = false;
  auto fetch = [&](int q) {
    const int j = q * CHUNK + tid;
    nok = false;
    nvalid = false;
    if (tid < CHUNK && j < count) {
      nidx = idx_t[j];
      nvalid = valid_t[j] != 0;
      nok = nidx >= 0 && nidx < n_rows;
    }
  };
  auto issue = [&](int buf) {
    if (tid < CHUNK) stage_row<D>(&s_row[buf][tid][0], rows, nidx, nok);
    cp_async_commit();
  };

  float T = 1.f;
  float A[C];
#pragma unroll
  for (int k = 0; k < C; ++k) A[k] = 0.f;

  if (nchunks > 0) {
    fetch(0);
    issue(0);
    vq = nvalid;
    if (nchunks > 1) fetch(1);
  }
  for (int q = 0; q < nchunks; ++q) {
    const int buf = q & 1;
    __syncthreads();   // chunk q - 1's readers are done with buffer buf ^ 1
    if (q + 1 < nchunks) {
      issue(buf ^ 1);
      vq1 = nvalid;
      if (q + 2 < nchunks) fetch(q + 2);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (tid < CHUNK) {   // prepare this thread's own slot, now landed
      const int j = q * CHUNK + tid;
      float* r = &s_row[buf][tid][0];
      float4 v1 = reinterpret_cast<float4*>(r)[1];
      v1.y = v1.y * (vq ? 1.f : 0.f);   // opacity times valid
      reinterpret_cast<float4*>(r)[1] = v1;
      const float4 v0 = reinterpret_cast<const float4*>(r)[0];
      // (slots past the count are never walked)
      s_box[buf][tid] = box_of(v0.x, v0.y, v0.z, v0.w, v1.x, v1.y);
      if (block != nullptr) {
        float* out = block + (long long)t * D * m + j;
#pragma unroll
        for (int f = 0; f < D; ++f) out[(long long)f * m] = r[f];
      }
    }
    vq = vq1;
    __syncthreads();

    unsigned int hits[CHUNK / 32];   // this warp's slots, in order
    warp_hits(s_box[buf], nullptr, min(CHUNK, count - q * CHUNK), wx0, wx1,
              wy0, wy1, hits);
#pragma unroll
    for (int k = 0; k < CHUNK / 32; ++k) {
      for (unsigned int m = hits[k]; m != 0u; m &= m - 1u) {
        const int j = 32 * k + __ffs(m) - 1;
        const float* r = &s_row[buf][j][0];
        const float4 v0 = reinterpret_cast<const float4*>(r)[0];
        const float4 v1 = reinterpret_cast<const float4*>(r)[1];
        const float mx = v0.x - px;
        const float my = v0.y - py;
        const float a = v0.z;
        const float b = v0.w;
        const float c = v1.x;
        const float op = v1.y;
        const float power = -0.5f * (a * mx * mx + c * my * my) - b * mx * my;
        const float G = expf(fminf(power, 0.f));
        const float raw = op * G;
        if (power <= 0.f && raw >= ALPHA_MIN) {
          const float alpha = fminf(raw, ALPHA_MAX);
          const float w = alpha * T;
#pragma unroll
          for (int k2 = 0; k2 < C; ++k2) A[k2] += r[6 + k2] * w;
          T *= 1.f - alpha;
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < C; ++k) acc[((long long)t * C + k) * NPIX + tid] = A[k];
  trans[(long long)t * NPIX + tid] = T;
}

template <int C>
cudaError_t launch(const float* rows, long long n_rows, int d,
                   const long long* prim_idx, const unsigned char* valid,
                   const int* counts, int ntiles, int m, int grid_w,
                   float* acc, float* trans, float* block,
                   cudaStream_t stream) {
  if (d != rows_d<C>()) return cudaErrorInvalidValue;
  gs_tile_fwd_kernel<C><<<ntiles, NPIX, 0, stream>>>(
      rows, n_rows, prim_idx, valid, counts, m, grid_w, acc, trans, block);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// rows [n_rows, d] f32 row-major (d = 6 + nchan padded to a multiple of 8,
// 16-byte aligned); prim_idx [ntiles, m] i64 and valid [ntiles, m] bool
// (1 byte); counts [ntiles] i32; m a multiple of 128; acc [ntiles, nchan, 256] and trans [ntiles, 1, 256] f32, every entry
// written; block [ntiles, d, m] f32 or null (see the note at the top).
extern "C" int gs_tile_fwd(const float* rows, long long n_rows, int d,
                           const long long* prim_idx,
                           const unsigned char* valid, const int* counts,
                           int ntiles, int m, int grid_w, int nchan,
                           float* acc, float* trans, float* block,
                           void* stream) {
  if (ntiles <= 0 || grid_w <= 0 || m <= 0 || m % CHUNK != 0 ||
      n_rows <= 0 || (reinterpret_cast<size_t>(rows) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nchan) {
#define GS_TILE_FWD_CASE(C)                                                 \
  case C:                                                                   \
    return (int)launch<C>(rows, n_rows, d, prim_idx, valid, counts, ntiles, \
                          m, grid_w, acc, trans, block, s);
    GS_TILE_FWD_CASE(1)
    GS_TILE_FWD_CASE(2)
    GS_TILE_FWD_CASE(3)
    GS_TILE_FWD_CASE(4)
    GS_TILE_FWD_CASE(5)
    GS_TILE_FWD_CASE(6)
#undef GS_TILE_FWD_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* gs_tile_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
