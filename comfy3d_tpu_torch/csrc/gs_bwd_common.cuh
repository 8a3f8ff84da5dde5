// What the two compositor backward kernels share (gs_tile_bwd.cu, K5', and
// gs_flat_bwd.cu, K3'): the shared-memory layout, phase B (the slot-major
// sums of a sub-chunk) and the epilogue that adds each slot's sums into its
// splat's gradient row with atomics.
//
// Both kernels run one CTA per 16-px (sub-)tile, one thread per pixel, and
// walk the (sub-)tile's list back to front in staged 128-slot chunks. Each
// chunk is split into sub-chunks of SUB = 16 slots, and each sub-chunk in
// two phases:
//   A (in the kernel, pixel-major): each thread walks the sub-chunk's slots
//     back to front, carrying its pixel's log T and S exactly as the
//     reference does, and writes two scalars per (slot, pixel) to shared
//     memory: dG = d alpha * G (0 where the slot is dead, or saturated, for
//     the pixel) and wc = alpha * T_i (0 where dead; > 0 where live, and
//     stored negated where the power is positive, which takes d power out:
//     only K3's visit test lets such a visit be live);
//   B (here, slot-major): lane l of a warp owns slot l % 16 of the
//     sub-chunk, the two half-warps take pixels 32w + i and 32w + 16 + i of
//     warp w's 32 (i < 16) and recompute the offsets dx = px - mu_x,
//     dy = py - mu_y; one shuffle per sum joins the halves, and the 8 warps'
//     partials are summed in the epilogue. A slot's 6 + C sums so cost one
//     pass over shared memory and 6 + C shuffles per warp per 16 slots,
//     where a per-slot design spends 5 (6 + C) shuffles per warp per slot.
// The scratch rows are SPAD = 17 floats long, so phase A's writes (thread =
// pixel, one slot) and phase B's reads (16 slots at two pixels 16 apart)
// each fall on 32 different banks. 16-slot sub-chunks keep the CTA at
// ~50 KB of shared memory (C = 4), so 4 CTAs (32 warps) share an SM.
//
// Per pixel, with dp = dG * op (zero where the power is positive):
//   d mu_x = a Σdp dx + b Σdp dy    d a = -0.5 Σdp dx²    d op = ΣdG
//   d mu_y = c Σdp dy + b Σdp dx    d b = -Σdp dx dy      d chan_k = Σwc g_acc_k
//                                   d c = -0.5 Σdp dy²
// which is the reference's per-pixel d power (a mx + b my), ... with
// mx = -dx, summed once the slot's constants are factored out.

#pragma once

#include <cuda_runtime.h>

namespace gs_bwd {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;   // threads per CTA, one per pixel
constexpr int NWARP = NPIX / 32;
constexpr int CHUNK = 128;          // slots per staged chunk
constexpr int SUB = 16;             // slots per sub-chunk: one per half-warp lane
constexpr int SPAD = SUB + 1;       // scratch row stride (floats)
// f32 roundings of the same double constants the plain versions use
constexpr float ALPHA_MAX = (float)0.99;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ONE_M_MIN = (float)(1.0 - 0.99);
constexpr float LOG_FLOOR = -80.f;
constexpr float T_FLOOR = (float)1.8048513878454153e-35;   // e^-80

// Dynamic shared memory of one CTA, offsets in 4-byte words.
// A staged slot is one row of DAT [CHUNK][NFS]: mu_x, mu_y, a, b | c, op,
// chan_0, chan_1 | chan_2.. , 16-byte aligned, so a thread reads a slot's
// first eight values with two float4 loads.
template <int C>
struct Smem {
  static constexpr int NF = 6 + C;        // gradient row: mu_x, mu_y, a, b, c, op, chans
  static constexpr int NFS = (NF + 3) / 4 * 4;   // staged row stride
  static constexpr int NFP = NF | 1;      // odd partial stride: no bank conflicts
  static constexpr int DG = 0;                              // [NPIX][SPAD]
  static constexpr int WC = DG + NPIX * SPAD;               // [NPIX][SPAD]
  static constexpr int GA = WC + NPIX * SPAD;               // [C][NPIX] g_acc
  static constexpr int PART = GA + C * NPIX;                // [NWARP][SUB][NFP]
  static constexpr int DAT = (PART + NWARP * SUB * NFP + 3) / 4 * 4;  // [CHUNK][NFS]
  static constexpr int ROW = DAT + CHUNK * NFS;             // [CHUNK] int rows
  static constexpr int CNT = ROW + CHUNK;                   // [NWARP] int
  static constexpr int BYTES = (CNT + NWARP) * 4;
};

// Staged slot j's first eight values (mu_x, mu_y, a, b; c, op, chan_0,
// chan_1) and its channel k.
template <int C>
__device__ __forceinline__ void slot_head(const float* smem, int j,
                                          float4& v0, float4& v1) {
  const float4* row =
      reinterpret_cast<const float4*>(smem + Smem<C>::DAT + j * Smem<C>::NFS);
  v0 = row[0];
  v1 = row[1];
}

template <int C>
__device__ __forceinline__ float slot_chan(const float* smem, int j,
                                           const float4& v1, int k) {
  return k == 0 ? v1.z
       : k == 1 ? v1.w
                : smem[Smem<C>::DAT + j * Smem<C>::NFS + 6 + k];
}

// The power of a pixel's offset (dx, dy) under conic (a, b, c), in the
// forward's operations and order: every live/unsaturated decision
// evaluates it through here.
__device__ __forceinline__ float power_of(float a, float b, float c, float dx,
                                          float dy) {
  return -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
}

// Phase B of sub-chunk [j0, j0 + jn) of the staged chunk: this warp's
// partial gradient rows of each of its slots, into PART. (px0, py0) is
// pixel 0's centre in the frame of the staged mu_x, mu_y. A half-warp's 16
// pixels are one row of the tile, so dy is constant over its loop and the
// dy terms follow from Σdp: Σdp dy = dy Σdp, Σdp dx dy = dy Σdp dx,
// Σdp dy² = dy² Σdp; and dp = op dG, so op is applied once per slot.
template <int C>
__device__ __forceinline__ void slot_sums(float* smem, int j0, int jn,
                                          float px0, float py0) {
  using L = Smem<C>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int jl = lane % SUB;
  const int p0 = warp * 32 + (lane / SUB) * SUB;   // this half's pixel row
  float4 v0, v1;
  slot_head<C>(smem, j0 + jl, v0, v1);
  const float mux = v0.x, muy = v0.y, a = v0.z, b = v0.w, c = v1.x;
  const float op = v1.y;
  const float dy = ((float)(p0 / TILE) + py0) - muy;
  // Σd, Σd dx, Σd dx² of d = dG where the power is <= 0, ΣdG, Σwc g_k
  float sd = 0.f, sdx = 0.f, sdxx = 0.f, sg = 0.f;
  float sc[C];
#pragma unroll
  for (int k = 0; k < C; ++k) sc[k] = 0.f;
  if (jl < jn) {
    const float* s_dg = smem + L::DG + p0 * SPAD + jl;
    const float* s_wc = smem + L::WC + p0 * SPAD + jl;
    const float* s_ga = smem + L::GA + p0;
#pragma unroll 4
    for (int i = 0; i < SUB; ++i) {
      const float dx = ((float)i + px0) - mux;   // p0 % TILE == 0
      const float dg = s_dg[i * SPAD];
      const float ws = s_wc[i * SPAD];
      const float d = ws < 0.f ? 0.f : dg;       // the power > 0 flag
      const float wc = fabsf(ws);
      sg += dg;
      sd += d;
      const float ddx = d * dx;
      sdx += ddx;
      sdxx += ddx * dx;
#pragma unroll
      for (int k = 0; k < C; ++k) sc[k] += wc * s_ga[k * NPIX + i];
    }
  }
  float s[6 + C] = {op * sdx, dy * (op * sd), op * sdxx, dy * (op * sdx),
                    dy * dy * (op * sd), sg};
#pragma unroll
  for (int k = 0; k < C; ++k) s[6 + k] = sc[k];
  // join the two half-warps (lanes l and l + 16 hold the same slot)
#pragma unroll
  for (int f = 0; f < 6 + C; ++f)
    s[f] += __shfl_down_sync(0xffffffffu, s[f], SUB);
  if (lane < SUB) {   // s: Σdp dx, Σdp dy, Σdp dx², Σdp dx dy, Σdp dy², ...
    float* part = smem + L::PART + (warp * SUB + jl) * L::NFP;
    part[0] = a * s[0] + b * s[1];
    part[1] = c * s[1] + b * s[0];
    part[2] = -0.5f * s[2];
    part[3] = -s[3];
    part[4] = -0.5f * s[4];
#pragma unroll
    for (int f = 5; f < 6 + C; ++f) part[f] = s[f];
  }
}

// The epilogue of sub-chunk [j0, j0 + jn): the 8 warps' partials summed,
// and each sum added into g [n, 6 + C] at the slot's row (ROW; -1 skips the
// slot). Threads take consecutive entries of a row, so a slot's atomics
// fall on consecutive addresses. A zero sum is skipped: adding it changes
// nothing.
template <int C>
__device__ __forceinline__ void add_rows(const float* smem, int j0, int jn,
                                         float* __restrict__ g) {
  using L = Smem<C>;
  const int* s_row = reinterpret_cast<const int*>(smem + L::ROW);
  for (int i = threadIdx.x; i < jn * L::NF; i += NPIX) {
    const int jl = i / L::NF;
    const int f = i - jl * L::NF;
    const int row = s_row[j0 + jl];
    if (row < 0) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w)
      sum += smem[L::PART + (w * SUB + jl) * L::NFP + f];
    if (sum != 0.f) atomicAdd(g + (long long)row * L::NF + f, sum);
  }
}

// Sets the dynamic shared memory the kernel needs (above 48 KB only on
// request) and asks for the largest carveout, so four CTAs fit on an SM.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace gs_bwd
