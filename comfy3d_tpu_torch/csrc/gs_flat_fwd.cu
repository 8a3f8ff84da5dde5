// Coarse-bin 3DGS compositor, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernels comfy3d_tpu/ops/pallas/gs_flat.py::_fwd_kernel_merged
// (:339, merged = 1) and ::_fwd_kernel (:198, merged = 0). The Python wrapper
// and the plain PyTorch version are comfy3d_tpu_torch/ops/gs_flat.py.
//
// What it computes, for coarse bin t (SUB x SUB sub-tiles of 16 px): the
// bin's depth-sorted pairs [bounds[t], bounds[t+1]) of `data` are walked
// front to back in 128-pair chunks, counted from bounds[t] rounded down to a
// multiple of 128 (the slots before bounds[t] are dead). Per pixel:
//   alpha = min(op * exp(min(power, 0)), 0.99), 0 where op*G < 1/255 or the
//           pair's 3-sigma square misses the pixel's 16-px sub-tile;
//   acc += chan * alpha * T;   T *= 1 - alpha.
// Before each chunk a group whose largest T is below EPS_T stops: the whole
// bin when merged (sub-tiles whose origin is outside the image start at
// T = 0), else each in-image sub-tile on its own (out-of-image sub-tiles keep
// acc 0, T 1, stops 0). stops = chunks composited, per sub-tile.
//
// Bound: operations (~20 f32 ops and one exp per pair-pixel visit), not
// bytes (a pair's 64-byte payload is shared by every pixel of its bin).
// Design: one CTA per bin, one thread per pixel of each sub-tile (NSUB
// pixels per thread, acc and T in registers), so the payload is read from
// device memory once per bin. Each 128-pair chunk is staged in shared memory
// with its per-sub-tile footprint bits, so a pair that misses a sub-tile
// costs one uniform branch. The exit is a __syncthreads_or vote per chunk,
// which is also the barrier that frees the staging buffer.
//
// Built with -fmad=false: the power and alpha are rounded operation by
// operation as the plain version rounds them, so the 1/255 cut falls on the
// same pair-pixel visits.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;   // threads per CTA
constexpr int CHUNK = 128;          // pairs per staged chunk (<= NPIX)
// f32 roundings of the same double constants the plain version uses
constexpr float ALPHA_MAX = (float)0.99;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float EPS_T = (float)1.0e-3;

__device__ __forceinline__ long long floor_to_chunk(long long x) {
  long long q = x / CHUNK;
  if (x < 0 && q * CHUNK != x) --q;
  return q * CHUNK;
}

template <int C, int SUB>
__global__ void __launch_bounds__(NPIX)
gs_flat_fwd_kernel(const float* __restrict__ data, long long ppad,
                   const int* __restrict__ bounds, int nbins_x, int width,
                   int height, int merged, float* __restrict__ acc,
                   float* __restrict__ trans, int* __restrict__ stops) {
  constexpr int NSUB = SUB * SUB;
  constexpr int NF = 6 + C;   // staged rows: mu_x, mu_y (bin-local), a, b, c, op, chans
  __shared__ float s_pay[NF][CHUNK];
  __shared__ unsigned int s_ov[CHUNK];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int bin_x = t % nbins_x;
  const int bin_y = t / nbins_x;
  const float bin_ox = (float)(bin_x * SUB * TILE);
  const float bin_oy = (float)(bin_y * SUB * TILE);

  const long long b0 = bounds[t];
  const long long b1 = bounds[t + 1];
  const long long b0_al = floor_to_chunk(b0);
  const long long nchunks = b1 > b0 ? (b1 - b0_al + CHUNK - 1) / CHUNK : 0;

  const float lx = (float)(tid % TILE);
  const float ly = (float)(tid / TILE);
  float px[NSUB], py[NSUB], T[NSUB], A[NSUB][C];
  int stop[NSUB];
  unsigned int live = 0;   // sub-tiles whose group still composites
  unsigned int draw = 0;   // of those, sub-tiles inside the image
#pragma unroll
  for (int s = 0; s < NSUB; ++s) {
    const float sx0 = (float)((s % SUB) * TILE);
    const float sy0 = (float)((s / SUB) * TILE);
    px[s] = lx + (sx0 + 0.5f);
    py[s] = ly + (sy0 + 0.5f);
    const bool in_img = (bin_x * SUB + s % SUB) * TILE < width &&
                        (bin_y * SUB + s / SUB) * TILE < height;
    T[s] = (merged && !in_img) ? 0.f : 1.f;
#pragma unroll
    for (int k = 0; k < C; ++k) A[s][k] = 0.f;
    stop[s] = 0;
    if (merged || in_img) live |= 1u << s;
    if (in_img) draw |= 1u << s;
  }

  for (long long q = 0; q < nchunks; ++q) {
    // Saturation vote; also the barrier before s_pay is overwritten.
    if (merged) {
      float m = 0.f;
#pragma unroll
      for (int s = 0; s < NSUB; ++s) m = fmaxf(m, T[s]);
      if (!__syncthreads_or(m >= EPS_T)) break;
    } else {
#pragma unroll
      for (int s = 0; s < NSUB; ++s) {
        if ((live >> s) & 1u) {   // uniform across the CTA
          if (!__syncthreads_or(T[s] >= EPS_T)) live &= ~(1u << s);
        }
      }
      if (live == 0) break;
    }

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
        s_pay[0][tid] = mxl;
        s_pay[1][tid] = myl;
#pragma unroll
        for (int f = 2; f < NF; ++f) s_pay[f][tid] = data[f * ppad + g];
      }
      s_ov[tid] = ov;
    }
    __syncthreads();

    const unsigned int mask = live & draw;
    for (int j = 0; j < CHUNK; ++j) {
      const unsigned int ov = s_ov[j] & mask;
      if (ov == 0) continue;   // uniform across the CTA
      const float mxl = s_pay[0][j];
      const float myl = s_pay[1][j];
      const float a = s_pay[2][j];
      const float b = s_pay[3][j];
      const float c = s_pay[4][j];
      const float op = s_pay[5][j];
      float ch[C];
#pragma unroll
      for (int k = 0; k < C; ++k) ch[k] = s_pay[6 + k][j];
#pragma unroll
      for (int s = 0; s < NSUB; ++s) {
        if (!((ov >> s) & 1u)) continue;
        const float dx = px[s] - mxl;
        const float dy = py[s] - myl;
        const float power = -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
        const float G = expf(fminf(power, 0.f));
        const float raw = op * G;
        if (raw >= ALPHA_MIN) {
          const float alpha = fminf(raw, ALPHA_MAX);
          const float w = alpha * T[s];
#pragma unroll
          for (int k = 0; k < C; ++k) A[s][k] += ch[k] * w;
          T[s] *= 1.f - alpha;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < NSUB; ++s)
      if ((live >> s) & 1u) stop[s] = (int)(q + 1);
  }

#pragma unroll
  for (int s = 0; s < NSUB; ++s) {
    const long long base = (long long)t * NSUB + s;
#pragma unroll
    for (int k = 0; k < C; ++k) acc[(base * C + k) * NPIX + tid] = A[s][k];
    trans[base * NPIX + tid] = T[s];
  }
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < NSUB; ++s) stops[(long long)t * NSUB + s] = stop[s];
  }
}

struct Args {
  const float* data;
  long long ppad;
  const int* bounds;
  int nbins, nbins_x, width, height, merged;
  float* acc;
  float* trans;
  int* stops;
  cudaStream_t stream;
};

template <int C, int SUB>
cudaError_t launch(const Args& a) {
  gs_flat_fwd_kernel<C, SUB><<<a.nbins, NPIX, 0, a.stream>>>(
      a.data, a.ppad, a.bounds, a.nbins_x, a.width, a.height, a.merged,
      a.acc, a.trans, a.stops);
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
// acc [nbins, sub_n^2, nchan, 256], trans [nbins, sub_n^2, 1, 256] f32;
// stops [nbins, sub_n^2] i32.
extern "C" int gs_flat_fwd(const float* data, long long ppad, int dpay,
                           const int* bounds, int nbins, int nbins_x,
                           int nchan, int sub_n, int width, int height,
                           int merged, float* acc, float* trans, int* stops,
                           void* stream) {
  if (nbins <= 0 || nbins_x <= 0 || dpay < 7 + nchan)
    return (int)cudaErrorInvalidValue;
  const Args a{data, ppad, bounds, nbins, nbins_x, width, height,
               merged ? 1 : 0, acc, trans, stops,
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

extern "C" const char* gs_flat_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
