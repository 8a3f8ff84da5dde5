// Soft silhouette (SoftRasterizer-style coverage) and its backward, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes this function as an
// XLA scan over chunks of 32 faces (comfy3d_tpu/ops/rasterize.py::
// soft_silhouette, :442, with _signed_dist_to_tri :492 and _seg_dist :507),
// which at FlexiCubes_MVS's defaults (res 128, 512² views) is a stream of
// [H, W, 32] temporaries per chunk over ~10^5 faces. The Python wrappers and
// the plain PyTorch version are comfy3d_tpu_torch/ops/rasterize.py::
// {soft_silhouette_fwd, soft_silhouette_bwd, soft_silhouette_plain}.
//
// What it computes, per pixel centre p = (x + 0.5, y + 0.5) of an H x W
// image, over every face f with ok[f] (screen corners a, b, c =
// tri[f, 0:6], in pixels):
//   dd_e  = |p - closest point of segment e|^2 for e = ab, bc, ca, with
//           t = clip(((p - a).u) / max(u.u, 1e-12), 0, 1), u = b - a
//   dist  = sqrt(max(min_e dd_e, 1e-20))
//   d     = (inside ? dist : -dist) * scale      (inside: the three edge
//           functions share a sign, zeros included, but are not all 0: a
//           triangle collapsed to a point covers nothing)
//   prob  = sigmoid(sign(d) d^2 / sigma)
//   L[p] += log1p(-clip(prob, 0, 1 - 1e-7))
// The caller forms the coverage 1 - exp(L). The backward takes g_L and adds
// into g_tri [F, 6] the gradient of sum_p g_L[p] L[p]: zero where the clip
// is active, the distance's gradient sent to the nearest of the three
// segments (split in halves at a tie of the min, as autograd splits it)
// through its closest point with t held fixed (exact: see below), the
// max(., 1e-20) differentiated as the plain version's autograd does, and
// the inside test held fixed.
//
// Exact: every ok face against every pixel, as the JAX package computes
// it; only the order of the sum over faces differs. A pair whose sigmoid
// argument is below -87 (prob < 2^-126) adds nothing to L in float32 and
// skips the transcendental functions; nothing else is culled.
//
// Bound: operations. Each face-pixel pair costs ~70 f32 operations (three
// segment distances, three edge functions) and, while prob > 2^-126, an exp
// and a log1p; the inputs are 28 bytes a face and the output 4 a pixel.
// Design: one CTA per 16x16-pixel tile, one thread per pixel (L in a
// register). The faces are staged through shared memory in chunks of 256,
// one face a thread, with each edge's vector and 1/max(u.u, 1e-12) computed
// once at staging; every thread then walks the chunk. The backward re-walks
// the same pairs; per face and warp a vote skips pairs whose gradient is
// zero for all 32 pixels, else the warp sums the face's 6 values with
// shuffles and adds them into a per-chunk shared accumulator; after the
// chunk each nonzero face corner gets one atomicAdd into g_tri.
//
// Built with -fmad=false: every product and sum is rounded on its own, as
// in the plain version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 16;
constexpr int THREADS = TILE * TILE;
constexpr int CH = THREADS;          // faces staged per chunk
constexpr int NF = 16;               // floats staged per face
constexpr float S_MIN = -87.0f;      // sigmoid(S_MIN) < 2^-126
constexpr float P_MAX = 1.0f - 1e-7f;

// staged face: a(2) b(2) c(2), then per edge e (ab, bc, ca): u(2), 1/den,
// then ok as float
__device__ __forceinline__ void stage_face(const float* __restrict__ tri,
                                           const unsigned char* __restrict__ ok,
                                           int f, int nf, float* s) {
  if (f >= nf) {
    s[15] = 0.0f;
    return;
  }
  const float* t = tri + 6 * (long long)f;
#pragma unroll
  for (int i = 0; i < 6; ++i) s[i] = t[i];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int i0 = 2 * e, i1 = (2 * e + 2) % 6;
    const float ux = t[i1] - t[i0], uy = t[i1 + 1] - t[i0 + 1];
    s[6 + 3 * e] = ux;
    s[7 + 3 * e] = uy;
    s[8 + 3 * e] = 1.0f / fmaxf(ux * ux + uy * uy, 1e-12f);
  }
  s[15] = ok[f] ? 1.0f : 0.0f;
}

struct Seg {
  float wx, wy, traw, t, dx, dy, dd;
};

__device__ __forceinline__ Seg segment(float px, float py, float ax,
                                       float ay, float ux, float uy,
                                       float inv_den) {
  Seg r;
  r.wx = px - ax;
  r.wy = py - ay;
  r.traw = (r.wx * ux + r.wy * uy) * inv_den;
  r.t = fminf(fmaxf(r.traw, 0.0f), 1.0f);
  r.dx = px - (ax + r.t * ux);
  r.dy = py - (ay + r.t * uy);
  r.dd = r.dx * r.dx + r.dy * r.dy;
  return r;
}

// the pair's sigmoid argument s and what the backward needs
struct Pair {
  float s;
  bool inside;
  float dd;        // the nearest segment's squared distance
  Seg seg[3];      // ab, bc, ca
};

__device__ __forceinline__ Pair pair(float px, float py, const float* f,
                                     float scale, float inv_sigma) {
  Pair r;
  r.seg[0] = segment(px, py, f[0], f[1], f[6], f[7], f[8]);
  r.seg[1] = segment(px, py, f[2], f[3], f[9], f[10], f[11]);
  r.seg[2] = segment(px, py, f[4], f[5], f[12], f[13], f[14]);
  // edge functions cross(b - a, p - a) from the staged vectors
  const float e0 = f[6] * r.seg[0].wy - f[7] * r.seg[0].wx;
  const float e1 = f[9] * r.seg[1].wy - f[10] * r.seg[1].wx;
  const float e2 = f[12] * r.seg[2].wy - f[13] * r.seg[2].wx;
  r.inside = ((e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) ||
              (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f)) &&
             !(e0 == 0.0f && e1 == 0.0f && e2 == 0.0f);
  // sqrt and the floor are monotone: the min of the three distances is the
  // distance of the least squared one
  r.dd = fminf(fminf(r.seg[0].dd, r.seg[1].dd), r.seg[2].dd);
  const float dist = sqrtf(fmaxf(r.dd, 1e-20f));
  const float d = (r.inside ? dist : -dist) * scale;
  r.s = (d > 0.0f ? d : (d < 0.0f ? -d : 0.0f)) * d * inv_sigma;
  return r;
}

// the share of min(min(dist_ab, dist_bc), dist_ca)'s gradient that reaches
// each segment's squared distance: a tie of min splits it in halves, and
// the floor max(dd, 1e-20) passes it above the floor (half at it), as the
// plain version's autograd does
__device__ __forceinline__ void segment_shares(const Seg* seg, float* w) {
  float dist[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) dist[e] = sqrtf(fmaxf(seg[e].dd, 1e-20f));
  float w0 = 1.0f, w1 = 0.0f;
  if (dist[1] < dist[0]) { w0 = 0.0f; w1 = 1.0f; }
  else if (dist[1] == dist[0]) { w0 = w1 = 0.5f; }
  const float m01 = fminf(dist[0], dist[1]);
  float w2 = 0.0f;
  if (dist[2] < m01) { w0 = w1 = 0.0f; w2 = 1.0f; }
  else if (dist[2] == m01) { w0 *= 0.5f; w1 *= 0.5f; w2 = 0.5f; }
  w[0] = w0;
  w[1] = w1;
  w[2] = w2;
#pragma unroll
  for (int e = 0; e < 3; ++e)
    w[e] *= seg[e].dd > 1e-20f ? 1.0f : (seg[e].dd == 1e-20f ? 0.5f : 0.0f);
}

__device__ __forceinline__ float sigmoid(float s) {
  return 1.0f / (1.0f + expf(-s));
}

__global__ void __launch_bounds__(THREADS)
silhouette_fwd_kernel(const float* __restrict__ tri,
                      const unsigned char* __restrict__ ok, int nf, int h,
                      int w, float scale, float inv_sigma,
                      float* __restrict__ out) {
  __shared__ float sf[CH * NF];
  const int x = blockIdx.x * TILE + (threadIdx.x % TILE);
  const int y = blockIdx.y * TILE + (threadIdx.x / TILE);
  const float px = x + 0.5f, py = y + 0.5f;
  float acc = 0.0f;
  for (int base = 0; base < nf; base += CH) {
    __syncthreads();
    stage_face(tri, ok, base + threadIdx.x, nf, sf + NF * threadIdx.x);
    __syncthreads();
    const int n = min(CH, nf - base);
    for (int j = 0; j < n; ++j) {
      const float* f = sf + NF * j;
      if (f[15] == 0.0f) continue;
      const Pair q = pair(px, py, f, scale, inv_sigma);
      if (q.s < S_MIN) continue;
      const float p = fminf(fmaxf(sigmoid(q.s), 0.0f), P_MAX);
      acc += log1pf(-p);
    }
  }
  if (x < w && y < h) out[(long long)y * w + x] = acc;
}

__global__ void __launch_bounds__(THREADS)
silhouette_bwd_kernel(const float* __restrict__ tri,
                      const unsigned char* __restrict__ ok, int nf, int h,
                      int w, float scale, float inv_sigma,
                      const float* __restrict__ g_out,
                      float* __restrict__ g_tri) {
  __shared__ float sf[CH * NF];
  __shared__ float gacc[CH * 6];
  const int x = blockIdx.x * TILE + (threadIdx.x % TILE);
  const int y = blockIdx.y * TILE + (threadIdx.x / TILE);
  const bool in_img = x < w && y < h;
  const float px = x + 0.5f, py = y + 0.5f;
  const float gl = in_img ? g_out[(long long)y * w + x] : 0.0f;
  const int lane = threadIdx.x & 31;
  // d s / d dd = +-scale^2 / sigma (dd above the 1e-20 floor)
  const float ds_ddd = scale * scale * inv_sigma;
  for (int i = threadIdx.x; i < CH * 6; i += THREADS) gacc[i] = 0.0f;
  for (int base = 0; base < nf; base += CH) {
    __syncthreads();
    stage_face(tri, ok, base + threadIdx.x, nf, sf + NF * threadIdx.x);
    __syncthreads();
    const int n = min(CH, nf - base);
    for (int j = 0; j < n; ++j) {
      const float* f = sf + NF * j;
      if (f[15] == 0.0f) continue;       // uniform over the CTA
      float g[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      bool live = false;
      if (in_img && gl != 0.0f) {
        const Pair q = pair(px, py, f, scale, inv_sigma);
        if (q.s >= S_MIN && q.dd >= 1e-20f) {
          const float p = sigmoid(q.s);
          // the clip's derivative, halved at its bounds (min / max split
          // a tie's gradient, as the plain version's and XLA's do)
          const float clip_g = p < P_MAX ? 1.0f : (p == P_MAX ? 0.5f : 0.0f);
          if (p > 0.0f && clip_g > 0.0f) {
            // dL/ds = -1/(1-p) * p(1-p) = -p; s = +-dd scale^2 / sigma
            const float g_dd = -gl * p * clip_g *
                               (q.inside ? ds_ddd : -ds_ddd);
            float w[3];
            segment_shares(q.seg, w);
            // each nearest segment's backward, dd = |p - c|^2 with c =
            // (1 - t) a + t b and t held fixed: at the projection (0 < t
            // < 1) dd does not change with t, and where t is clipped
            // neither does t, so this is the exact gradient, without the
            // t-chain's cancellation on near-degenerate edges
#pragma unroll
            for (int e = 0; e < 3; ++e) {
              if (w[e] == 0.0f) continue;
              const Seg& sg = q.seg[e];
              const float gcx = -2.0f * sg.dx * g_dd * w[e];   // d/d c
              const float gcy = -2.0f * sg.dy * g_dd * w[e];
              const int ia = 2 * e, ib = (2 * e + 2) % 6;
              g[ia] += (1.0f - sg.t) * gcx;
              g[ia + 1] += (1.0f - sg.t) * gcy;
              g[ib] += sg.t * gcx;
              g[ib + 1] += sg.t * gcy;
            }
            live = true;
          }
        }
      }
      if (!__any_sync(0xffffffffu, live)) continue;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        float v = g[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_down_sync(0xffffffffu, v, off);
        g[k] = v;
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < 6; ++k) atomicAdd(&gacc[6 * j + k], g[k]);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n * 6; i += THREADS) {
      const float v = gacc[i];
      if (v != 0.0f) atomicAdd(&g_tri[6 * (long long)base + i], v);
      gacc[i] = 0.0f;
    }
  }
}

}  // namespace

extern "C" int soft_silhouette_fwd(const float* tri, const unsigned char* ok,
                                   int nf, int h, int w, float scale,
                                   float inv_sigma, float* out,
                                   void* stream) {
  if (nf < 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE);
  silhouette_fwd_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      tri, ok, nf, h, w, scale, inv_sigma, out);
  return (int)cudaGetLastError();
}

extern "C" int soft_silhouette_bwd(const float* tri, const unsigned char* ok,
                                   int nf, int h, int w, float scale,
                                   float inv_sigma, const float* g_out,
                                   float* g_tri, void* stream) {
  if (nf < 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE);
  silhouette_bwd_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      tri, ok, nf, h, w, scale, inv_sigma, g_out, g_tri);
  return (int)cudaGetLastError();
}

extern "C" const char* soft_silhouette_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
