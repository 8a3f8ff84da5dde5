// What the two redesigned compositor forward kernels share (gs_tile_fwd.cu,
// K4', and gs_flat_fwd.cu, K1'/K2'): the asynchronous staging of splat
// rows read by index, and the per-splat box with its warp-uniform test.
//
// Staging. Each kernel reads a 128-slot chunk's splat indices itself and
// copies each slot's row (D floats, 16-byte aligned, D/4 pieces of 16
// bytes) from the [n, D] row matrix into shared memory with cp.async, into
// a two-stage ring: chunk q + 1 streams in while chunk q is walked. The
// thread that issued a slot's copies waits for them (cp.async.wait_group
// waits for the calling thread's own copies) and then prepares the slot
// (its box, and what else the kernel needs), before one barrier publishes
// the chunk to every thread.
//
// The box. The visit test of both forwards is op * expf(min(power, 0)) >=
// 1/255 (K4 also asks power <= 0), with power = -0.5 (a mx mx + c my my) -
// b mx my evaluated in f32 from the offset m between the splat's mean and
// the pixel centre. box_of gives, per splat, a box around its mean outside
// which no pixel centre can pass that test, so a warp whose pixel
// rectangle (two 16-px rows) misses the box skips the slot: a ballot per 32
// slots gives each warp the mask of the slots it walks (warp_hits). The
// derivation (u = 2^-24):
// a passing visit has op expf(p_c) (1 + 4u)(1 + u) >= alpha (expf's 2 ulp,
// op G's rounding), so the computed power p_c >= -tau/2 - 5u with
// tau = 2 ln(op / alpha). Without contractions (-fmad=false) p_c differs
// from p = -Q/2 (Q = A + C + 2B, A = a mx^2, C = c my^2, B = b mx my) by at
// most 1.5u (|A| + |C|) + 2u |B| + u |p_c| <= 2.1u S, S = |A| + |C| + 2|B|.
// So a passing visit has Q - 4.2u S <= tau + 10u, and with eta = BOX_ETA
// (> 4.2u): (1-eta) a mx^2 - 2 (1+eta) |b| |mx my| + (1-eta) c my^2 <=
// tau' = tau + BOX_TAU_SLACK. Where that form is positive definite
// (det' = a'c' - b'^2 > BOX_MIN_DET a'c', so float64's cancellation in det'
// stays below 1e-6 of it) it bounds |mx| <= sqrt(tau' c'/det') and
// |my| <= sqrt(tau' a'/det'). The half-extents are widened by BOX_WIDEN
// (the float64 roundings and mx's own rounding, u relative) and the ends
// rounded outward to f32. Any input not finite, or a form that is not
// positive definite: the whole plane (every visit takes the exact test).
// op < alpha: empty (op G <= op, as G <= 1). The Python copy, held against
// random and adversarial splats by the CPU tests and against every
// full-size input by chip_smoke.py, is comfy3d_tpu_torch/ops/gs_tile.py::
// splat_box.

#pragma once

#include <cuda_runtime.h>

namespace gs_fwd {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;   // threads per CTA, one per pixel
constexpr int CHUNK = 128;          // slots per staged chunk (<= NPIX)
// f32 roundings of the same double constants the plain versions use
constexpr float ALPHA_MAX = (float)0.99;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
// the box's margins (gs_tile.py: BOX_TAU_SLACK, BOX_ETA, BOX_WIDEN,
// BOX_MIN_DET)
constexpr double BOX_TAU_SLACK = 1e-4;
constexpr double BOX_ETA = 1e-6;
constexpr double BOX_WIDEN = 1e-6;
constexpr double BOX_MIN_DET = 1e-9;

// One 16-byte piece from device to shared memory, asynchronously; zero
// bytes read (the piece zero-filled) where src_bytes is 0.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row `idx` of rows [n, D] into dst (D floats, 16-byte aligned); zeros
// where !ok.
template <int D>
__device__ __forceinline__ void stage_row(float* dst, const float* rows,
                                          long long idx, bool ok) {
  const float* src = rows + (ok ? idx : 0LL) * D;
  const int bytes = ok ? 16 : 0;
#pragma unroll
  for (int p = 0; p < D / 4; ++p) cp_async16(dst + 4 * p, src + 4 * p, bytes);
}

// The box (x0, x1, y0, y1) around (mu_x, mu_y), in the frame of the staged
// means; see the note at the top of this file.
__device__ __forceinline__ float4 box_of(float mu_x, float mu_y, float a,
                                         float b, float c, float op) {
  const float inf = __int_as_float(0x7f800000);
  if (!(isfinite(mu_x) && isfinite(mu_y) && isfinite(a) && isfinite(b) &&
        isfinite(c) && isfinite(op)))
    return make_float4(-inf, inf, -inf, inf);   // the whole plane
  if (op < ALPHA_MIN) return make_float4(inf, -inf, inf, -inf);   // empty
  const double alpha = (double)ALPHA_MIN;
  const double tau = 2.0 * (log((double)op) - log(alpha)) + BOX_TAU_SLACK;
  const double a1 = (double)a * (1.0 - BOX_ETA);
  const double c1 = (double)c * (1.0 - BOX_ETA);
  const double b1 = fabs((double)b) * (1.0 + BOX_ETA);
  const double det = a1 * c1 - b1 * b1;
  if (!(a1 > 0.0 && c1 > 0.0 && det > BOX_MIN_DET * a1 * c1))
    return make_float4(-inf, inf, -inf, inf);   // not positive definite
  const double hx = sqrt(tau * c1 / det) * (1.0 + BOX_WIDEN);
  const double hy = sqrt(tau * a1 / det) * (1.0 + BOX_WIDEN);
  return make_float4(__double2float_rd((double)mu_x - hx),
                     __double2float_ru((double)mu_x + hx),
                     __double2float_rd((double)mu_y - hy),
                     __double2float_ru((double)mu_y + hy));
}

// True where the pixel-centre rectangle [wx0, wx1] x [wy0, wy1] lies wholly
// outside box b.
__device__ __forceinline__ bool box_misses(const float4& b, float wx0,
                                           float wx1, float wy0, float wy1) {
  return b.y < wx0 || b.x > wx1 || b.w < wy0 || b.z > wy1;
}

// The slots among the first n of a staged chunk whose box meets this
// warp's pixel rectangle, as four 32-slot masks (bit l of mask k: slot
// 32 k + l), one ballot each: lane l tests slots l, l + 32, l + 64,
// l + 96. The masks are the same in every lane, so the walk over their
// set bits is uniform, and a slot that misses costs the warp nothing
// after its ballot. `list` maps a position to its staged slot (null: the
// position is the slot).
__device__ __forceinline__ void warp_hits(const float4* boxes, const int* list,
                                          int n, float wx0, float wx1,
                                          float wy0, float wy1,
                                          unsigned int (&mask)[CHUNK / 32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < CHUNK / 32; ++k) {
    const int j = 32 * k + lane;
    bool hit = false;
    if (j < n) {
      const float4 bx = boxes[list != nullptr ? list[j] : j];
      hit = !box_misses(bx, wx0, wx1, wy0, wy1);
    }
    mask[k] = __ballot_sync(0xffffffffu, hit);
  }
}

}  // namespace gs_fwd
