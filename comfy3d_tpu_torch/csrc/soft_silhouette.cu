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
// The window. A pair whose sigmoid argument s is below -87 (prob < 2^-126)
// adds nothing to L in float32 and nothing to a gradient. Outside a face,
// s = -(dist * scale)^2 / sigma, so s < -87 exactly when dist > R =
// sqrt(87 sigma) * max(H, W) (82.7 px at 512² and sigma 3e-4). A pixel
// inside a face lies inside the face's screen box, and a pixel farther than
// R from the box is farther than R from the face. So a pixel whose centre
// lies more than R + 1 px from the box holds no live pair of the face: the
// kernels test each face's box against each 16x16 tile's rectangle of pixel
// centres, and again against each warp's 16x2 rectangle, Euclidean (the gap
// in x and in y, squared and summed, against (R + 1)^2), and skip the face
// where it is out of reach. The 1-px margin covers the float32 rounding of
// dist and s (~1e-6 of R). Two more guards make the window hold for the
// float32 arithmetic the kernels run, and not only for exact distances:
//   - each box is widened by 2^-16 * M px, M the largest magnitude among
//     the corners and max(H, W): the rounding of dist (a few ulps of M);
//   - a face whose float32 inside test may err far from the face is kept
//     for every pixel. The test's error is a few ulps of |u| (|w| + M), so
//     at a pixel D >= R from a face it cannot flip every edge's sign unless
//     sin(the face's smallest angle) < ~2^-20 (1 + 3M / R); the pre-pass
//     keeps every face with 2A * R <= 2^-17 * L1 * L2 * (R + 3M) (2A twice
//     the area, L1 >= L2 the two longest edges) or L2^2 < 1e-20: slivers,
//     faces collapsed onto a segment, faces with huge corners. A point (all
//     corners equal) is never inside and keeps its box. A face with a
//     corner that is not finite is kept too (its box is then the whole
//     plane), and so is every face whose test gives NaN.
// So the pairs the window skips are a subset of those whose s < -87, which
// the kernels of the full walk (every ok face against every pixel) skipped
// as well; the order of each pixel's sum is unchanged, so with one split
// (below) the forward's L is bit for bit the full walk's.
//
// Design: one CTA per 16x16-pixel tile and face range (split), one thread
// per pixel (L in a register).
//   1. A pre-pass (silhouette_records_kernel) writes one record per face
//      once a call: its box [F] float4 (x0, y0, x1, y1; ok folded in, a
//      culled face's box is empty) and its geometry [F, 16] floats (the
//      corners, each edge's vector and 1 / max(u.u, 1e-12), one spare):
//      19 floats padded to 20 for 16-byte copies, in a scratch tensor that
//      the wrapper allocates. The backward rebuilds the same records from
//      the same inputs (the same bits).
//   2. Each CTA scans its faces 256 at a time: cp.async copies a chunk's
//      boxes (16 bytes a face) into a double-buffered shared ring, each
//      thread tests one box against the tile, and a ballot and a prefix
//      over the 8 warps compact the survivors, in ascending face index,
//      into a shared list whose geometry records cp.async gathers (64 bytes
//      each, read back as four 16-byte loads a pair). The scan of chunk
//      k + 1, its gather and the boxes of chunk k + 2 are in flight while
//      the threads walk chunk k's survivors.
//   3. The survivor's thread also tests its box against each warp's 16x2
//      pixels and keeps one bit a warp; a warp skips a face whose bit is
//      clear with a uniform branch.
//   4. The backward walks the same survivors: per survivor and warp a vote
//      skips pairs whose gradient is zero for all 32 pixels, else the warp
//      sums the face's 6 values by halving exchanges (9 shuffles; lane 4k
//      holds value k) and 6 lanes add them into the survivor's shared row;
//      after the chunk each nonzero value of a survivor's row gets one
//      atomicAdd into g_tri, and only the survivors' rows are cleared. A
//      pixel whose upstream gradient is 0 (deep inside the silhouette,
//      where exp(L) underflows) walks nothing.
//   5. Load balance: tiles over the object hold most of the pairs (on the
//      FlexiCubes fit's res-128 surface at 512² the heaviest tile walks
//      5.2x the mean, and at one split its CTA sets the kernel's time).
//      `splits` > 1 cuts each tile's faces into that many contiguous
//      ranges (grid z; the wrapper takes ~32768 CTAs, at most 32 splits),
//      so the card runs many short CTAs. The forward then writes one
//      partial log-sum per split and silhouette_sum_kernel adds them in
//      split order, so L stays deterministic and exact (every live pair
//      summed; the sum's association differs from one split's, by ~1e-6
//      of L); the backward adds its atomics as before.
//
// Bound: operations. Each walked pair costs ~68 f32 operations (three
// segment distances, three edge functions), more while s >= -87 (the exp,
// the division and the log1p; the backward's nearest-segment gradient and
// warp sums). The window leaves ~1.16x the live pairs to walk at 512²
// and ~1.3x at 256²; the scan (~20 operations per face and tile) and the
// records' bytes (80 a face, read from L2 once per tile and split) take
// ~5 % of the time on an H100. With the work spread, the kernels are bound
// by the instructions the SMs run for the walked pairs (on an H100 ~6x
// the live pairs' f32 bound at the card's peak, which counts no
// comparison, select or special-function instruction).
//
// Built with -fmad=false: every product and sum is rounded on its own, as
// in the plain version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 16;
constexpr int THREADS = TILE * TILE;
constexpr int WARPS = THREADS / 32;
constexpr int CH = THREADS;          // faces scanned per chunk
constexpr int NG = 16;               // floats of a face's geometry record
constexpr float S_MIN = -87.0f;      // sigmoid(S_MIN) < 2^-126
constexpr float P_MAX = 1.0f - 1e-7f;
constexpr float BOX_PAD = 1.0f / 65536.0f;     // 2^-16 of M
constexpr float ILL = 1.0f / 131072.0f;        // 2^-17: the angle guard

// the shared memory of a CTA, each part double-buffered: the scan's boxes;
// the survivors' geometry records, the warps each reaches (one bit a warp)
// and their faces (less the chunk's first); the warps' survivor counts.
// The backward's accumulator rows follow it.
struct Stage {
  float4 box[2][CH];
  float rec[2][CH * NG];
  unsigned warps[2][CH];
  unsigned char idx[2][CH];
  int wcnt[WARPS];
};
constexpr size_t FWD_SMEM = sizeof(Stage);
constexpr size_t BWD_SMEM = sizeof(Stage) + sizeof(float) * CH * 6;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the record pre-pass: one thread a face
__global__ void silhouette_records_kernel(const float* __restrict__ tri,
                                          const unsigned char* __restrict__ ok,
                                          int nf, float m_view, float reach,
                                          float4* __restrict__ box,
                                          float* __restrict__ geom) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= nf) return;
  const float* t = tri + 6 * (long long)f;
  float c[6], g[NG], den[3];
#pragma unroll
  for (int i = 0; i < 6; ++i) c[i] = t[i];
#pragma unroll
  for (int i = 0; i < 6; ++i) g[i] = c[i];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int i0 = 2 * e, i1 = (2 * e + 2) % 6;
    const float ux = c[i1] - c[i0], uy = c[i1 + 1] - c[i0 + 1];
    den[e] = ux * ux + uy * uy;
    g[6 + 3 * e] = ux;
    g[7 + 3 * e] = uy;
    g[8 + 3 * e] = 1.0f / fmaxf(den[e], 1e-12f);
  }
  g[15] = 0.0f;
  float4* dst = reinterpret_cast<float4*>(geom + NG * (long long)f);
#pragma unroll
  for (int q = 0; q < NG / 4; ++q)
    dst[q] = make_float4(g[4 * q], g[4 * q + 1], g[4 * q + 2], g[4 * q + 3]);

  float4 b = make_float4(INFINITY, INFINITY, -INFINITY, -INFINITY);
  if (ok[f]) {
    bool finite = true;
    float m = m_view;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      finite = finite && isfinite(c[i]);
      m = fmaxf(m, fabsf(c[i]));
    }
    // twice the area, cross(b - a, c - a) = u_ab.y u_ca.x - u_ab.x u_ca.y,
    // and the two longest edges
    const float a2 = fabsf(g[7] * g[12] - g[6] * g[13]);
    const float l1 = fmaxf(fmaxf(den[0], den[1]), den[2]);
    const float l2 = fmaxf(fminf(den[0], den[1]),
                           fminf(fmaxf(den[0], den[1]), den[2]));
    // a point (all corners equal) has its three edge functions 0 at every
    // pixel, so it is never inside
    const bool point = g[6] == 0.0f && g[7] == 0.0f && g[9] == 0.0f &&
                       g[10] == 0.0f;
    const bool sound =
        finite && (point || (l2 >= 1e-20f &&
                             a2 * reach > ILL * sqrtf(l1) * sqrtf(l2) *
                                              (reach + 3.0f * m)));
    if (sound) {
      const float pad = BOX_PAD * m;
      b = make_float4(fminf(fminf(c[0], c[2]), c[4]) - pad,
                      fminf(fminf(c[1], c[3]), c[5]) - pad,
                      fmaxf(fmaxf(c[0], c[2]), c[4]) + pad,
                      fmaxf(fmaxf(c[1], c[3]), c[5]) + pad);
    } else {
      b = make_float4(-INFINITY, -INFINITY, INFINITY, INFINITY);
    }
  }
  box[f] = b;
}

// a box within reach of the rectangle [x0, x1] x [y0, y1] of pixel
// centres; NaN keeps it
__device__ __forceinline__ bool reaches(float4 b, float x0, float y0,
                                        float x1, float y1, float lim2) {
  const float gx = fmaxf(fmaxf(b.x - x1, x0 - b.z), 0.0f);
  const float gy = fmaxf(fmaxf(b.y - y1, y0 - b.w), 0.0f);
  return !(gx * gx + gy * gy > lim2);
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
  float dist[3];   // (the backward) each segment's sqrt(max(dd, 1e-20))
  Seg seg[3];      // ab, bc, ca
};

// a face's geometry record (NG floats) as four 16-byte shared loads:
// (ax ay bx by) (cx cy u_ab) (1/den_ab u_bc 1/den_bc) (u_ca 1/den_ca -)
template <bool BWD>
__device__ __forceinline__ Pair pair(float px, float py, const float* rec,
                                     float scale, float inv_sigma) {
  const float4* f4 = reinterpret_cast<const float4*>(rec);
  const float4 q0 = f4[0], q1 = f4[1], q2 = f4[2], q3 = f4[3];
  Pair r;
  r.seg[0] = segment(px, py, q0.x, q0.y, q1.z, q1.w, q2.x);
  r.seg[1] = segment(px, py, q0.z, q0.w, q2.y, q2.z, q2.w);
  r.seg[2] = segment(px, py, q1.x, q1.y, q3.x, q3.y, q3.z);
  // edge functions cross(b - a, p - a) from the staged vectors
  const float e0 = q1.z * r.seg[0].wy - q1.w * r.seg[0].wx;
  const float e1 = q2.y * r.seg[1].wy - q2.z * r.seg[1].wx;
  const float e2 = q3.x * r.seg[2].wy - q3.y * r.seg[2].wx;
  r.inside = ((e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) ||
              (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f)) &&
             !(e0 == 0.0f && e1 == 0.0f && e2 == 0.0f);
  // sqrt and the floor are monotone: the min of the three distances is the
  // distance of the least squared one (the same bits either way)
  r.dd = fminf(fminf(r.seg[0].dd, r.seg[1].dd), r.seg[2].dd);
  float dist;
  if (BWD) {
#pragma unroll
    for (int e = 0; e < 3; ++e) r.dist[e] = sqrtf(fmaxf(r.seg[e].dd, 1e-20f));
    dist = fminf(fminf(r.dist[0], r.dist[1]), r.dist[2]);
  } else {
    dist = sqrtf(fmaxf(r.dd, 1e-20f));
  }
  const float d = (r.inside ? dist : -dist) * scale;
  r.s = (d > 0.0f ? d : (d < 0.0f ? -d : 0.0f)) * d * inv_sigma;
  return r;
}

// the share of min(min(dist_ab, dist_bc), dist_ca)'s gradient that reaches
// each segment's squared distance: a tie of min splits it in halves, and
// the floor max(dd, 1e-20) passes it above the floor (half at it), as the
// plain version's autograd does
__device__ __forceinline__ void segment_shares(const Pair& q, float* w) {
  const float* dist = q.dist;
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
    w[e] *= q.seg[e].dd > 1e-20f ? 1.0f
                                 : (q.seg[e].dd == 1e-20f ? 0.5f : 0.0f);
}

// the sum over the warp of each lane's 6 values, by halving exchanges (8
// slots, the last two 0: 9 shuffles): lane 4k returns the sum of value k
__device__ __forceinline__ float warp_sum6(const float* g, int lane) {
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
  float b[4], c[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lo = g[i], hi = i + 4 < 6 ? g[i + 4] : 0.0f;
    b[i] = (h4 ? hi : lo) +
           __shfl_xor_sync(0xffffffffu, h4 ? lo : hi, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    c[i] = (h3 ? b[i + 2] : b[i]) +
           __shfl_xor_sync(0xffffffffu, h3 ? b[i] : b[i + 2], 8);
  float d = (h2 ? c[1] : c[0]) +
            __shfl_xor_sync(0xffffffffu, h2 ? c[0] : c[1], 4);
  d += __shfl_xor_sync(0xffffffffu, d, 2);
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  return d;
}

__device__ __forceinline__ float sigmoid(float s) {
  return 1.0f / (1.0f + expf(-s));
}

// where a CTA is: its tile's rectangle of pixel centres (clipped to the
// image), its pixel, its split's faces
struct Place {
  int x, y, h;
  float px, py;
  float tx0, ty0, tx1, ty1;     // the tile's pixel centres
  int f0, f1;                   // the split's faces [f0, f1)
};

__device__ __forceinline__ Place place(int nf, int h, int w, int splits) {
  Place p;
  const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
  p.x = x0 + (threadIdx.x % TILE);
  p.y = y0 + (threadIdx.x / TILE);
  p.h = h;
  p.px = p.x + 0.5f;
  p.py = p.y + 0.5f;
  p.tx0 = x0 + 0.5f;
  p.ty0 = y0 + 0.5f;
  p.tx1 = min(x0 + TILE - 1, w - 1) + 0.5f;
  p.ty1 = min(y0 + TILE - 1, h - 1) + 0.5f;
  const int per = ((nf + splits - 1) / splits + CH - 1) / CH * CH;
  p.f0 = min(nf, (int)blockIdx.z * per);
  p.f1 = min(nf, p.f0 + per);
  return p;
}

// cp.async the boxes of the faces [f, min(f + CH, f1)) into st.box[buf]
__device__ __forceinline__ void load_boxes(Stage& st, int buf, int f, int f1,
                                           const float4* __restrict__ box) {
  const int i = f + threadIdx.x;
  if (i < f1) cp_async16(&st.box[buf][threadIdx.x], box + i);
  cp_async_commit();
}

// the chunk of faces from f (boxes in st.box[buf]) against the tile: the
// survivors, in ascending face index, into st.rec / st.warps / st.idx
// [buf], their geometry gathered by cp.async and the warps whose 16 x 2
// pixels each reaches (the same test on the warp's rows) set; returns
// their count. Every thread of the CTA calls it.
__device__ __forceinline__ int compact(Stage& st, int buf, int f,
                                       const Place& p, float lim2,
                                       const float* __restrict__ geom) {
  const int i = f + threadIdx.x, lane = threadIdx.x & 31,
            warp = threadIdx.x >> 5;
  const float4 b = st.box[buf][threadIdx.x];
  const bool keep = i < p.f1 && b.x <= b.z &&
                    reaches(b, p.tx0, p.ty0, p.tx1, p.ty1, lim2);
  const unsigned m = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) st.wcnt[warp] = __popc(m);
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) {
    const int c = st.wcnt[k];
    base += k < warp ? c : 0;
    total += c;
  }
  if (keep) {
    const int slot = base + __popc(m & ((1u << lane) - 1u));
    float* r = st.rec[buf] + NG * slot;
    const float* src = geom + NG * (long long)i;
#pragma unroll
    for (int q = 0; q < NG / 4; ++q) cp_async16(r + 4 * q, src + 4 * q);
    // each warp's rows span the tile's columns: the same gap in x
    unsigned bits = 0u;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      const float y0 = p.ty0 + 2 * k;
      if (y0 < p.h && reaches(b, p.tx0, y0, p.tx1, fminf(y0 + 1.0f, p.ty1),
                              lim2))
        bits |= 1u << k;
    }
    st.warps[buf][slot] = bits;
    st.idx[buf][slot] = (unsigned char)threadIdx.x;
  }
  cp_async_commit();
  return total;
}

// the pipeline of one CTA over its split's faces: walk(buf, n, f) is
// called once a chunk, with that chunk's n survivors staged in st.*[buf]
// and its first face f, while the next chunk's gather and the one after's
// boxes are in flight
template <typename Walk>
__device__ __forceinline__ void scan(Stage& st, const Place& p, float lim2,
                                     const float4* __restrict__ box,
                                     const float* __restrict__ geom,
                                     Walk walk) {
  const int nch = (p.f1 - p.f0 + CH - 1) / CH;
  if (nch == 0) return;
  load_boxes(st, 0, p.f0, p.f1, box);
  cp_async_wait_all();
  __syncthreads();
  int n = compact(st, 0, p.f0, p, lim2, geom);
  if (nch > 1) load_boxes(st, 1, p.f0 + CH, p.f1, box);
  for (int k = 0; k < nch; ++k) {
    cp_async_wait_all();
    __syncthreads();
    int n_next = 0;
    if (k + 1 < nch) {
      n_next = compact(st, (k + 1) & 1, p.f0 + (k + 1) * CH, p, lim2, geom);
      if (k + 2 < nch) load_boxes(st, k & 1, p.f0 + (k + 2) * CH, p.f1, box);
    }
    walk(k & 1, n, p.f0 + k * CH);
    n = n_next;
  }
}

__global__ void __launch_bounds__(THREADS, 5)
silhouette_fwd_kernel(const float4* __restrict__ box,
                      const float* __restrict__ geom, int nf, int h, int w,
                      int splits, float scale, float inv_sigma, float lim2,
                      float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage& st = *reinterpret_cast<Stage*>(smem);
  const Place p = place(nf, h, w, splits);
  const unsigned me = 1u << (threadIdx.x >> 5);
  float acc = 0.0f;
  scan(st, p, lim2, box, geom, [&](int buf, int n, int) {
    const float* rec = st.rec[buf];
    const unsigned* warps = st.warps[buf];
    for (int j = 0; j < n; ++j) {
      if (!(warps[j] & me)) continue;          // uniform over the warp
      const Pair q = pair<false>(p.px, p.py, rec + NG * j, scale, inv_sigma);
      if (q.s < S_MIN) continue;
      const float pr = fminf(fmaxf(sigmoid(q.s), 0.0f), P_MAX);
      acc += log1pf(-pr);
    }
  });
  if (p.x < w && p.y < h)
    out[(long long)blockIdx.z * h * w + (long long)p.y * w + p.x] = acc;
}

// L = the splits' partial log-sums added in split order
__global__ void silhouette_sum_kernel(const float* __restrict__ part,
                                      long long n, int splits,
                                      float* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = part[i];
  for (int z = 1; z < splits; ++z) acc += part[z * n + i];
  out[i] = acc;
}

__global__ void __launch_bounds__(THREADS, 4)
silhouette_bwd_kernel(const float4* __restrict__ box,
                      const float* __restrict__ geom, int nf, int h, int w,
                      int splits, float scale, float inv_sigma, float lim2,
                      const float* __restrict__ g_out,
                      float* __restrict__ g_tri) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage& st = *reinterpret_cast<Stage*>(smem);
  float* gacc = reinterpret_cast<float*>(smem + sizeof(Stage));
  const Place p = place(nf, h, w, splits);
  const bool in_img = p.x < w && p.y < h;
  const float gl = in_img ? g_out[(long long)p.y * w + p.x] : 0.0f;
  const int lane = threadIdx.x & 31;
  const unsigned me = 1u << (threadIdx.x >> 5);
  // d s / d dd = +-scale^2 / sigma (dd above the 1e-20 floor)
  const float ds_ddd = scale * scale * inv_sigma;
  for (int i = threadIdx.x; i < CH * 6; i += THREADS) gacc[i] = 0.0f;
  scan(st, p, lim2, box, geom, [&](int buf, int n, int f) {
    const float* rec = st.rec[buf];
    const unsigned* warps = st.warps[buf];
    for (int j = 0; j < n; ++j) {
      if (!(warps[j] & me)) continue;          // uniform over the warp
      float g[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      bool live = false;
      if (in_img && gl != 0.0f) {
        const Pair q = pair<true>(p.px, p.py, rec + NG * j, scale, inv_sigma);
        if (q.s >= S_MIN && q.dd >= 1e-20f) {
          const float pr = sigmoid(q.s);
          // the clip's derivative, halved at its bounds (min / max split
          // a tie's gradient, as the plain version's and XLA's do)
          const float clip_g =
              pr < P_MAX ? 1.0f : (pr == P_MAX ? 0.5f : 0.0f);
          if (pr > 0.0f && clip_g > 0.0f) {
            // dL/ds = -1/(1-p) * p(1-p) = -p; s = +-dd scale^2 / sigma
            const float g_dd = -gl * pr * clip_g *
                               (q.inside ? ds_ddd : -ds_ddd);
            float sw[3];
            segment_shares(q, sw);
            // each nearest segment's backward, dd = |p - c|^2 with c =
            // (1 - t) a + t b and t held fixed: at the projection (0 < t
            // < 1) dd does not change with t, and where t is clipped
            // neither does t, so this is the exact gradient, without the
            // t-chain's cancellation on near-degenerate edges
#pragma unroll
            for (int e = 0; e < 3; ++e) {
              if (sw[e] == 0.0f) continue;
              const Seg& sg = q.seg[e];
              const float gcx = -2.0f * sg.dx * g_dd * sw[e];   // d/d c
              const float gcy = -2.0f * sg.dy * g_dd * sw[e];
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
      const float v = warp_sum6(g, lane);
      if ((lane & 3) == 0 && lane < 24)
        atomicAdd(&gacc[6 * j + (lane >> 2)], v);
    }
    __syncthreads();
    // the survivors' rows only: one atomicAdd a nonzero value, then clear
    for (int i = threadIdx.x; i < n * 6; i += THREADS) {
      const float v = gacc[i];
      if (v != 0.0f)
        atomicAdd(&g_tri[6 * (long long)(f + st.idx[buf][i / 6]) + i % 6],
                  v);
      gacc[i] = 0.0f;
    }
  });
}

cudaError_t records(const float* tri, const unsigned char* ok, int nf, int h,
                    int w, float reach, float* rec, cudaStream_t stream) {
  if (nf == 0) return cudaSuccess;
  float4* box = reinterpret_cast<float4*>(rec);
  float* geom = rec + 4 * (long long)nf;
  silhouette_records_kernel<<<(nf + 255) / 256, 256, 0, stream>>>(
      tri, ok, nf, (float)max(h, w), reach, box, geom);
  return cudaGetLastError();
}

}  // namespace

// Both launchers: tri [F, 6] float32 corners in pixels, ok [F] uint8, reach
// R (pixels), splits >= 1, rec scratch of 20 F floats (boxes [F, 4], then
// geometry [F, 16]).
extern "C" int soft_silhouette_fwd(const float* tri, const unsigned char* ok,
                                   int nf, int h, int w, float scale,
                                   float inv_sigma, float reach, int splits,
                                   float* rec, float* part, float* out,
                                   void* stream_) {
  if (nf < 0 || h <= 0 || w <= 0 || splits < 1 || (splits > 1 && !part))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        silhouette_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)FWD_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  cudaError_t e = records(tri, ok, nf, h, w, reach, rec, stream);
  if (e != cudaSuccess) return (int)e;
  const float lim = reach + 1.0f;
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE, splits);
  silhouette_fwd_kernel<<<grid, THREADS, FWD_SMEM, stream>>>(
      reinterpret_cast<const float4*>(rec), rec + 4 * (long long)nf, nf, h,
      w, splits, scale, inv_sigma, lim * lim, splits > 1 ? part : out);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long n = (long long)h * w;
  silhouette_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, n, splits, out);
  return (int)cudaGetLastError();
}

extern "C" int soft_silhouette_bwd(const float* tri, const unsigned char* ok,
                                   int nf, int h, int w, float scale,
                                   float inv_sigma, float reach, int splits,
                                   float* rec, const float* g_out,
                                   float* g_tri, void* stream_) {
  if (nf < 0 || h <= 0 || w <= 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        silhouette_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)BWD_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  cudaError_t e = records(tri, ok, nf, h, w, reach, rec, stream);
  if (e != cudaSuccess) return (int)e;
  const float lim = reach + 1.0f;
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE, splits);
  silhouette_bwd_kernel<<<grid, THREADS, BWD_SMEM, stream>>>(
      reinterpret_cast<const float4*>(rec), rec + 4 * (long long)nf, nf, h,
      w, splits, scale, inv_sigma, lim * lim, g_out, g_tri);
  return (int)cudaGetLastError();
}

extern "C" const char* soft_silhouette_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
