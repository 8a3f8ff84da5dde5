// Per-16-px-tile 3DGS compositor, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel comfy3d_tpu/ops/pallas/gs_tile.py::_fwd_kernel
// (:92, reached through composite_tiles_fwd :206). The Python wrapper and the
// plain PyTorch version are comfy3d_tpu_torch/ops/gs_tile.py.
//
// What it computes, for tile t of a grid grid_w tiles wide: the tile's
// padded, depth-ordered list data[t] ([D, M] f32, rows mu_x, mu_y, conic
// a, b, c, opacity, C channels, zero pad) is walked front to back over its
// first min(counts[t], M) slots. Per pixel (centre (i % 16 + 0.5) + ox,
// (i / 16 + 0.5) + oy):
//   mx = mu_x - px, my = mu_y - py
//   power = -0.5 * (a mx mx + c my my) - b mx my
//   alpha = min(op * exp(min(power, 0)), 0.99), 0 where power > 0 or
//           op * G < 1/255;
//   acc += chan * alpha * T;   T *= 1 - alpha.
// There is no saturation exit: the reference walks every counted slot. The
// TPU kernel composites a 128-slot chunk at once through a log-space prefix
// (exclusive product floored at e^-80); here T is multiplied slot by slot.
// The two differ in rounding, and where T < e^-80, where each term is below
// 2e-35.
//
// Bound: operations (~17 f32 operations and one exp per slot-pixel visit,
// 4 + 2C more per live one), not bytes (a slot's 4 (6 + C) bytes are shared
// by the tile's 256 pixels).
// Design: one CTA per tile, one thread per pixel (acc and T in registers).
// Each 128-slot chunk of the tile's columns is staged in shared memory by
// all 256 threads (coalesced row reads), then every thread walks it.
//
// Built with -fmad=false: the power and alpha are rounded operation by
// operation as the plain version rounds them, so the 1/255 and 0.99 cuts
// fall on the same slot-pixel visits.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;   // threads per CTA
constexpr int CHUNK = 128;          // slots per staged chunk
// f32 roundings of the same double constants the plain version uses
constexpr float ALPHA_MAX = (float)0.99;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);

template <int C>
__global__ void __launch_bounds__(NPIX)
gs_tile_fwd_kernel(const float* __restrict__ data,
                   const int* __restrict__ counts, int d, int m, int grid_w,
                   float* __restrict__ acc, float* __restrict__ trans) {
  constexpr int NF = 6 + C;   // staged rows: mu_x, mu_y, a, b, c, op, chans
  __shared__ float s_dat[NF][CHUNK];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int count = min(max(counts[t], 0), m);
  const float ox = (float)((t % grid_w) * TILE);
  const float oy = (float)((t / grid_w) * TILE);
  const float px = ((float)(tid % TILE) + 0.5f) + ox;
  const float py = ((float)(tid / TILE) + 0.5f) + oy;
  const float* tile = data + (long long)t * d * m;

  float T = 1.f;
  float A[C];
#pragma unroll
  for (int k = 0; k < C; ++k) A[k] = 0.f;

  for (int off = 0; off < count; off += CHUNK) {
    __syncthreads();   // the previous chunk's readers are done
    for (int i = tid; i < NF * CHUNK; i += NPIX) {
      const int f = i / CHUNK;
      const int j = i % CHUNK;
      s_dat[f][j] = tile[(long long)f * m + off + j];
    }
    __syncthreads();

    const int n = min(CHUNK, count - off);
    for (int j = 0; j < n; ++j) {
      const float mx = s_dat[0][j] - px;
      const float my = s_dat[1][j] - py;
      const float a = s_dat[2][j];
      const float b = s_dat[3][j];
      const float c = s_dat[4][j];
      const float op = s_dat[5][j];
      const float power = -0.5f * (a * mx * mx + c * my * my) - b * mx * my;
      const float G = expf(fminf(power, 0.f));
      const float raw = op * G;
      if (power <= 0.f && raw >= ALPHA_MIN) {
        const float alpha = fminf(raw, ALPHA_MAX);
        const float w = alpha * T;
#pragma unroll
        for (int k = 0; k < C; ++k) A[k] += s_dat[6 + k][j] * w;
        T *= 1.f - alpha;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < C; ++k) acc[((long long)t * C + k) * NPIX + tid] = A[k];
  trans[(long long)t * NPIX + tid] = T;
}

template <int C>
cudaError_t launch(const float* data, const int* counts, int ntiles, int d,
                   int m, int grid_w, float* acc, float* trans,
                   cudaStream_t stream) {
  gs_tile_fwd_kernel<C><<<ntiles, NPIX, 0, stream>>>(data, counts, d, m,
                                                     grid_w, acc, trans);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// data [ntiles, d, m] f32 row-major (m a multiple of 128, d >= 6 + nchan);
// counts [ntiles] i32; acc [ntiles, nchan, 256] and trans [ntiles, 1, 256]
// f32, every entry written.
extern "C" int gs_tile_fwd(const float* data, const int* counts, int ntiles,
                           int d, int m, int grid_w, int nchan, float* acc,
                           float* trans, void* stream) {
  if (ntiles <= 0 || grid_w <= 0 || m <= 0 || m % CHUNK != 0 ||
      d < 6 + nchan)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nchan) {
    case 1: return (int)launch<1>(data, counts, ntiles, d, m, grid_w, acc, trans, s);
    case 2: return (int)launch<2>(data, counts, ntiles, d, m, grid_w, acc, trans, s);
    case 3: return (int)launch<3>(data, counts, ntiles, d, m, grid_w, acc, trans, s);
    case 4: return (int)launch<4>(data, counts, ntiles, d, m, grid_w, acc, trans, s);
    case 5: return (int)launch<5>(data, counts, ntiles, d, m, grid_w, acc, trans, s);
    case 6: return (int)launch<6>(data, counts, ntiles, d, m, grid_w, acc, trans, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* gs_tile_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
