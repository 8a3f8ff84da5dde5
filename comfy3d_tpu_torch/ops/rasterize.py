"""Triangle rasterization, attribute interpolation, texture lookup and the
soft silhouette.

Port of `comfy3d_tpu/ops/rasterize.py`:

  rasterize  discrete visibility, per pixel (face_id, barycentrics, depth,
             mask), by one of two paths with one contract: `"bruteforce"`,
             a scan over chunks of faces for every pixel, and `"binned"`,
             the faces binned into 16-px tiles (`ops.binning`) and each
             tile's list scanned `chunk` faces at a time.
  recompute_barycentrics  the weights re-derived from live vertices at the
             rasterized face ids: the gradient path to vertex positions
             (visibility itself is not differentiated).
  interpolate, texture_sample  attribute interpolation and bilinear
             texture lookup (wrap or clamp), differentiable; the mip chain,
             per-pixel LOD and trilinear lookup (`build_mip_chain`,
             `uv_mip_level`, `texture_sample_mip`).
  soft_silhouette  differentiable coverage 1 − Π(1 − sigmoid(sign(d)·d²/σ))
             over faces (d the signed screen distance), the visibility
             gradients of a mask loss; `antialias` blends silhouette-edge
             pixels by it. On the card its log-sum and backward are the
             hand-written kernels of `csrc/soft_silhouette.cu`
             (`soft_silhouette_fwd`, `soft_silhouette_bwd`, each counting its
             launches); on the CPU, and as the card's yardstick,
             `soft_silhouette_plain`: chunks of faces under
             `torch.utils.checkpoint`, as the JAX package's remat.

The z-test keeps the nearest face; within a chunk `torch.argmin` returns the
first minimum, as `jnp.argmin` does, and a later chunk wins only when
strictly nearer, so the lowest face index wins ties on both paths. Faces
with a corner at w ≤ 1e-8 are dropped. The rasterizer's scans are plain
tensor code on every device (the JAX package has no Pallas rasterizer).

Conventions: OpenGL clip space (`core.camera`); screen x right, y down
(image row 0 = top); face_id −1 is background; barycentrics are
screen-space (w0, w1, w2) in the face's vertex order, perspective-corrected
by `recompute_barycentrics`.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from . import _build, binning
from .binning import TILE

METHODS = ("binned", "bruteforce")


@dataclasses.dataclass(frozen=True)
class RasterOut:
    face_id: torch.Tensor   # [H, W] int32, -1 = background
    bary: torch.Tensor      # [H, W, 3] screen-space barycentrics
    depth: torch.Tensor     # [H, W] view-space depth (0 at background)
    mask: torch.Tensor      # [H, W] float32 coverage {0, 1}


# ------------------------------------------------------------------ #
# Vertex processing
# ------------------------------------------------------------------ #
def project_vertices(v: torch.Tensor, mvp: torch.Tensor) -> torch.Tensor:
    """[V, 3] world positions → [V, 4] clip coordinates, mvp @ (v, 1).
    Summed as (x·m0 + y·m1) + (z·m2 + m3), the order in which the JAX
    package's CPU matmul rounds, so both packages project alike."""
    m = mvp.T
    return (v[:, 0:1] * m[0] + v[:, 1:2] * m[1]) + (v[:, 2:3] * m[2] + m[3])


def clip_to_screen(v_clip: torch.Tensor, height: int, width: int):
    """Clip → (screen_xy [V, 2], w_view [V], valid [V]). Clip w is the
    view-space distance along the camera axis: the z-test key."""
    w = v_clip[:, 3]
    safe_w = torch.where(w.abs() < 1e-8, 1e-8, w)
    ndc = v_clip[:, :3] / safe_w[:, None]
    sx = (ndc[:, 0] * 0.5 + 0.5) * width
    sy = (0.5 - ndc[:, 1] * 0.5) * height
    return torch.stack([sx, sy], -1), w, w > 1e-8


def _edge(p, a, b, fused: bool = False):
    """Edge function cross(b − a, p − a): > 0 left of a→b (y down flips).

    `fused` rounds it as fma(bx − ax, py − ay, −(by − ay)·(px − ax)): the
    JAX package's compiled scans contract it so on the CPU (its eager ops
    do not). The first product is exact in float64, so only the sum
    rounds, then to float32, on every device."""
    x1, y1 = b[..., 0] - a[..., 0], p[..., 1] - a[..., 1]
    x2, y2 = b[..., 1] - a[..., 1], p[..., 0] - a[..., 0]
    if fused:
        return (x1.double() * y1 - x2 * y2).float()
    return x1 * y1 - x2 * y2


def _face_corners(screen_xy, w_view, faces):
    f = faces.long()
    return (screen_xy[f[..., 0]], screen_xy[f[..., 1]], screen_xy[f[..., 2]],
            w_view[f[..., 0]], w_view[f[..., 1]], w_view[f[..., 2]])


def _safe_inverse_area(area, eps=1e-9):
    """1/area where |area| > eps, else 0; the division's input is guarded
    too, so degenerate and padding faces give no NaN gradient."""
    ok = area.abs() > eps
    return torch.where(ok, 1.0 / torch.where(ok, area, 1.0), 0.0)


def _coverage(px, p0, p1, p2, w0, w1, w2, eps=1e-9):
    """Inside test, screen barycentrics and per-pixel view depth.
    px [..., 2] pixel centres; corners broadcastable [...]. Returns
    (inside, b0, b1, b2, depth)."""
    e12 = _edge(px, p1, p2, True)     # weight of v0
    e20 = _edge(px, p2, p0, True)     # weight of v1
    e01 = _edge(px, p0, p1, True)     # weight of v2
    area = _edge(p2, p0, p1, True)
    inside = (area.abs() > eps) & (
        ((e12 >= 0) & (e20 >= 0) & (e01 >= 0))
        | ((e12 <= 0) & (e20 <= 0) & (e01 <= 0)))
    inv_area = _safe_inverse_area(area, eps)
    b0, b1, b2 = e12 * inv_area, e20 * inv_area, e01 * inv_area
    # screen-linear 1/w is perspective-correct
    inv_w = (b0 / w0.clamp_min(1e-8) + b1 / w1.clamp_min(1e-8)
             + b2 / w2.clamp_min(1e-8))
    return inside, b0, b1, b2, 1.0 / inv_w.clamp_min(1e-8)


def _pixel_centers(height: int, width: int, device):
    ys = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], -1)                      # [H, W, 2]


def _nearest(depth, inside, valid, b0, b1, b2):
    """Per pixel, the first nearest covered candidate of the last axis:
    (its index [...], depth [...], barycentrics [..., 3])."""
    depth = torch.where(inside & valid, depth, torch.inf)
    z, k = depth.min(-1, keepdim=True)    # the first minimum, as argmin
    bary = torch.cat([b.gather(-1, k) for b in (b0, b1, b2)], -1)
    return k[..., 0], z[..., 0], bary


# ------------------------------------------------------------------ #
# Path A: brute force (every face for every pixel)
# ------------------------------------------------------------------ #
def rasterize_bruteforce(screen_xy, w_view, faces, face_valid, height: int,
                         width: int, chunk: int = 32) -> RasterOut:
    dev = screen_xy.device
    px = _pixel_centers(height, width, dev)[:, :, None]   # [H, W, 1, 2]
    best_z = torch.full((height, width), torch.inf, device=dev)
    best_f = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    best_b = torch.zeros((height, width, 3), device=dev)
    for s in range(0, faces.shape[0], chunk):
        p0, p1, p2, w0, w1, w2 = _face_corners(screen_xy, w_view,
                                               faces[s:s + chunk])
        valid = face_valid[s:s + chunk] & (w0 > 1e-8) & (w1 > 1e-8) \
            & (w2 > 1e-8)
        inside, b0, b1, b2, depth = _coverage(px, p0, p1, p2, w0, w1, w2)
        k, z, bary = _nearest(depth, inside, valid, b0, b1, b2)
        better = z < best_z
        best_f = torch.where(better, (k + s).to(torch.int32), best_f)
        best_b = torch.where(better[..., None], bary, best_b)
        best_z = torch.minimum(best_z, z)
    hit = best_f >= 0
    return RasterOut(face_id=best_f, bary=best_b,
                     depth=torch.where(hit, best_z, 0.0), mask=hit.float())


# ------------------------------------------------------------------ #
# Path B: tile-binned
# ------------------------------------------------------------------ #
def rasterize_binned(screen_xy, w_view, faces, face_valid, height: int,
                     width: int, max_per_tile: int | None = 256,
                     max_tiles_per_prim: int = 64,
                     chunk: int = 8) -> RasterOut:
    """Faces binned into 16-px tiles by their screen boxes; each tile scans
    the first `max_per_tile` faces of its list (None: all of them), in
    ascending index, `chunk` at a time (steps past the longest list are
    skipped: their slots are all invalid)."""
    dev = screen_xy.device
    grid_h, grid_w = binning.num_tiles(height, width)
    p0, p1, p2, w0, w1, w2 = _face_corners(screen_xy, w_view, faces)
    active = face_valid & (w0 > 1e-8) & (w1 > 1e-8) & (w2 > 1e-8)
    bins = binning.bin_primitives(
        torch.minimum(torch.minimum(p0, p1), p2),
        torch.maximum(torch.maximum(p0, p1), p2), active, grid_h, grid_w,
        max_per_tile=max_per_tile, max_tiles_per_prim=max_tiles_per_prim)

    ntiles, npix = grid_h * grid_w, TILE * TILE
    centers = binning.tile_pixel_centers(grid_h, grid_w, dev)[:, :, None]
    best_z = torch.full((ntiles, npix), torch.inf, device=dev)
    best_f = torch.full((ntiles, npix), -1, dtype=torch.int32, device=dev)
    best_b = torch.zeros((ntiles, npix, 3), device=dev)
    longest = min(int(bins.count.max()), bins.prim_idx.shape[1])
    for s in range(0, longest, chunk):
        fidx = bins.prim_idx[:, s:s + chunk]                  # [T, chunk]
        tp0, tp1, tp2, tw0, tw1, tw2 = (
            a[:, None] for a in _face_corners(screen_xy, w_view,
                                              faces[fidx]))
        inside, b0, b1, b2, depth = _coverage(centers, tp0, tp1, tp2,
                                              tw0, tw1, tw2)
        k, z, bary = _nearest(depth, inside,
                              bins.valid[:, None, s:s + chunk], b0, b1, b2)
        better = z < best_z
        best_f = torch.where(better, fidx.gather(1, k).to(torch.int32),
                             best_f)
        best_b = torch.where(better[..., None], bary, best_b)
        best_z = torch.minimum(best_z, z)

    def to_img(a):
        return binning.tiles_to_image(a, grid_h, grid_w, height, width)

    face_id = to_img(best_f)
    hit = face_id >= 0
    return RasterOut(face_id=face_id, bary=to_img(best_b),
                     depth=torch.where(hit, to_img(best_z), 0.0),
                     mask=hit.float())


# ------------------------------------------------------------------ #
# Public entry
# ------------------------------------------------------------------ #
def rasterize(v: torch.Tensor, faces: torch.Tensor, mvp: torch.Tensor,
              height: int, width: int, face_valid=None,
              method: str = "binned", **kw) -> RasterOut:
    """World-space vertices + faces + mvp → RasterOut on the vertices'
    device. Not differentiable (visibility is discrete); pair with
    `recompute_barycentrics` and `interpolate` for gradients. `method` is
    `"binned"` or `"bruteforce"`."""
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    with torch.no_grad():
        screen_xy, w_view, _ = clip_to_screen(
            project_vertices(v.detach(), mvp.detach()), height, width)
        if face_valid is None:
            face_valid = torch.ones(faces.shape[0], dtype=torch.bool,
                                    device=faces.device)
        fn = rasterize_binned if method == "binned" else rasterize_bruteforce
        return fn(screen_xy, w_view, faces, face_valid, height, width, **kw)


# ------------------------------------------------------------------ #
# Differentiable interpolation
# ------------------------------------------------------------------ #
def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src[idx] along the first axis through `index_select`, whose
    backward is an `index_add_` (atomic adds on the card): the backward of
    advanced indexing sorts the indices and walks each run of a repeated
    one alone, 0.9 s of a 1.0-s fit step on an H100 where every pixel of
    three 512² views reads a vertex or a texel."""
    return src.index_select(0, idx.reshape(-1)).reshape(
        idx.shape + src.shape[1:])


def recompute_barycentrics(v: torch.Tensor, mvp: torch.Tensor,
                           faces: torch.Tensor, rast: RasterOut,
                           perspective: bool = True) -> torch.Tensor:
    """[H, W, 3] weights re-derived from the live vertices at the
    rasterized face ids (perspective-corrected; 0 at background):
    differentiable with respect to `v`."""
    h, w = rast.face_id.shape
    fv = faces.long()[rast.face_id.clamp_min(0).long()]       # [H, W, 3]
    screen_xy, w_view, _ = clip_to_screen(project_vertices(v, mvp), h, w)
    p0, p1, p2 = (_take(screen_xy, fv[..., i]) for i in range(3))
    px = _pixel_centers(h, w, v.device)
    area = _edge(p2, p0, p1)
    b = torch.stack([_edge(px, p1, p2), _edge(px, p2, p0),
                     _edge(px, p0, p1)], -1) \
        * _safe_inverse_area(area)[..., None]
    if perspective:
        bw = b / _take(w_view, fv).clamp_min(1e-8)
        # summed in one order, so every device rounds alike
        total = bw[..., 0:1] + bw[..., 1:2] + bw[..., 2:3]
        b = bw / total.clamp_min(1e-12)
    return b * rast.mask[..., None]


def interpolate(attr: torch.Tensor, rast: RasterOut, faces: torch.Tensor,
                bary: torch.Tensor | None = None) -> torch.Tensor:
    """Per-pixel interpolation of vertex attributes attr [V, C] through
    `faces` (uv faces with uv attributes for face-varying UVs). `bary`:
    the weights from `recompute_barycentrics`, else the rasterizer's
    screen-space ones (differentiable with respect to `attr` only)."""
    fv = faces.long()[rast.face_id.clamp_min(0).long()]       # [H, W, 3]
    if bary is None:
        bary = rast.bary * rast.mask[..., None]
    return (bary[..., 0:1] * _take(attr, fv[..., 0])
            + bary[..., 1:2] * _take(attr, fv[..., 1])
            + bary[..., 2:3] * _take(attr, fv[..., 2]))


# ------------------------------------------------------------------ #
# Texture sampling
# ------------------------------------------------------------------ #
def _floor_mod(x, n):
    """x mod n with the sign of n (`jnp.mod`'s float semantics)."""
    r = torch.fmod(x, n)
    return torch.where((r != 0) & (r < 0), r + n, r)


def texture_sample(tex: torch.Tensor, uv: torch.Tensor,
                   mode: str = "wrap") -> torch.Tensor:
    """Bilinear lookup. tex [Ht, Wt, C]; uv [..., 2] in [0, 1] (u right,
    v up: row 0 of tex is v = 0). `mode` "wrap" repeats the texture, any
    other value clamps to its border."""
    ht, wt = tex.shape[0], tex.shape[1]
    flat = tex.reshape(ht * wt, *tex.shape[2:])
    u = uv[..., 0] * wt - 0.5
    v = uv[..., 1] * ht - 0.5
    if mode == "wrap":
        u, v = _floor_mod(u, wt), _floor_mod(v, ht)
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = (u - u0)[..., None], (v - v0)[..., None]

    def fetch(ui, vi):
        ui, vi = ui.to(torch.int32), vi.to(torch.int32)
        if mode == "wrap":
            ui, vi = torch.remainder(ui, wt), torch.remainder(vi, ht)
        else:
            ui, vi = ui.clamp(0, wt - 1), vi.clamp(0, ht - 1)
        return _take(flat, vi.long() * wt + ui.long())

    return ((1 - fu) * (1 - fv) * fetch(u0, v0)
            + fu * (1 - fv) * fetch(u0 + 1, v0)
            + (1 - fu) * fv * fetch(u0, v0 + 1)
            + fu * fv * fetch(u0 + 1, v0 + 1))


def build_mip_chain(tex: torch.Tensor, max_levels: int | None = None):
    """[Ht, Wt, C] → list of mip levels (2× average-pooled), level 0 = full
    resolution, while both sides are even (at most `max_levels`, default
    32)."""
    levels = [tex]
    h, w = tex.shape[0], tex.shape[1]
    n = max_levels or 32
    while len(levels) < n and h >= 2 and w >= 2 and h % 2 == 0 \
            and w % 2 == 0:
        t = levels[-1]
        levels.append((t[0::2, 0::2] + t[1::2, 0::2] + t[0::2, 1::2]
                       + t[1::2, 1::2]) * 0.25)
        h, w = h // 2, w // 2
    return levels


def uv_mip_level(uv_img: torch.Tensor, tex_size: int) -> torch.Tensor:
    """Per-pixel LOD from screen-space UV differences (the last row and
    column repeat): uv_img [H, W, 2] → lod [H, W]."""
    du_dx = torch.diff(uv_img, dim=1, append=uv_img[:, -1:]).abs()
    du_dy = torch.diff(uv_img, dim=0, append=uv_img[-1:]).abs()
    footprint = torch.maximum(du_dx.amax(-1), du_dy.amax(-1)) * tex_size
    return torch.log2(footprint.clamp_min(1e-8))


def texture_sample_mip(mips, uv: torch.Tensor, lod: torch.Tensor,
                       mode: str = "wrap") -> torch.Tensor:
    """Trilinear lookup: bilinear in the two levels around `lod`, linear
    between them."""
    n = len(mips)
    lod = lod.clamp(0.0, n - 1.0)
    lo = torch.floor(lod).to(torch.int32)
    frac = (lod - lo)[..., None]
    out_lo = uv.new_zeros(uv.shape[:-1] + (mips[0].shape[-1],))
    out_hi = torch.zeros_like(out_lo)
    hi = torch.clamp_max(lo + 1, n - 1)
    for li in range(n):
        s = texture_sample(mips[li], uv, mode=mode)
        out_lo = torch.where((lo == li)[..., None], s, out_lo)
        out_hi = torch.where((hi == li)[..., None], s, out_hi)
    return out_lo * (1 - frac) + out_hi * frac


def antialias(color: torch.Tensor, background: torch.Tensor,
              v: torch.Tensor, faces: torch.Tensor, mvp: torch.Tensor,
              rast: RasterOut, sigma: float = 1e-5,
              face_valid=None) -> torch.Tensor:
    """Silhouette-edge antialiasing with vertex gradients: pixels whose
    4-neighbourhood crosses the coverage mask take the soft silhouette as
    alpha, the others keep the hard mask."""
    h, w = rast.mask.shape
    sil = soft_silhouette(v, faces, mvp, h, w, sigma=sigma,
                          face_valid=face_valid)
    m = rast.mask
    shift = torch.stack([torch.roll(m, 1, 0), torch.roll(m, -1, 0),
                         torch.roll(m, 1, 1), torch.roll(m, -1, 1)])
    edge = (shift.amax(0) != shift.amin(0)) | (m != torch.roll(m, 1, 0))
    alpha = torch.where(edge, sil, m)[..., None]
    return color * alpha + background * (1.0 - alpha)


# ------------------------------------------------------------------ #
# Soft silhouette
# ------------------------------------------------------------------ #
SIL_CLIP = 1.0 - 1e-7      # the largest per-face coverage summed


def _clip(x, lo, hi):
    """min(max(x, lo), hi), whose gradient is halved at a bound (a tie of
    min / max), as `jnp.clip`'s is."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _seg_dist(p, a, b):
    """Distance from p to the segment a–b (floored at 1e-10). The segment
    parameter t of the closest point is held fixed in the backward pass:
    where 0 < t < 1 the distance does not change with t, and where t is
    clipped neither does t, so the gradient is exact, without the JAX
    package's t-chain, whose terms cancel and blow up on near-degenerate
    edges."""
    ab = b - a
    ap = p - a
    den = torch.maximum((ab * ab).sum(-1), ab.new_tensor(1e-12))
    t = _clip((ap * ab).sum(-1) / den, 0.0, 1.0).detach()
    d = p - (a + t[..., None] * ab)
    return torch.sqrt(torch.maximum((d * d).sum(-1), d.new_tensor(1e-20)))


def _signed_dist_to_tri(p, a, b, c):
    """Signed 2-D distance to a triangle: positive inside (the three edge
    functions of one sign, zeros included, but not all three 0), negative
    outside; the distance to the nearest edge segment. A triangle collapsed
    to a point has all three edge functions 0 at every pixel: the JAX
    package counts it inside everywhere (ROADMAP §C.12), here it covers
    nothing."""
    dist = torch.minimum(torch.minimum(_seg_dist(p, a, b), _seg_dist(p, b, c)),
                         _seg_dist(p, c, a))
    e0, e1, e2 = _edge(p, a, b), _edge(p, b, c), _edge(p, c, a)
    inside = ((((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
               | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)))
              & ~((e0 == 0) & (e1 == 0) & (e2 == 0)))
    return torch.where(inside, dist, -dist)


def _silhouette_chunk(tri, px, scale: float, sigma: float):
    """Σ over a chunk of faces tri [n, 3, 2] of log1p(−clip(p)) per pixel
    of px [H, W, 1, 2]."""
    d = _signed_dist_to_tri(px, tri[:, 0], tri[:, 1], tri[:, 2]) * scale
    prob = torch.sigmoid(torch.sign(d) * d * d / sigma)
    return torch.log1p(-_clip(prob, 0.0, SIL_CLIP)).sum(-1)


def soft_silhouette_logsum_plain(tri, ok, height: int, width: int,
                                 sigma: float, chunk: int = 32):
    """Plain version of `soft_silhouette_fwd` (same contract): the ok faces,
    in order, `chunk` at a time, each chunk recomputed in the backward pass
    (`torch.utils.checkpoint`) rather than keeping its [H, W, chunk]
    temporaries."""
    px = _pixel_centers(height, width, tri.device)[:, :, None]
    tri = tri[ok]
    scale = 1.0 / max(height, width)
    out = tri.new_zeros((height, width))
    for s in range(0, tri.shape[0], chunk):
        part = tri[s:s + chunk]
        if part.requires_grad:
            out = out + checkpoint(_silhouette_chunk, part, px, scale, sigma,
                                   use_reentrant=False)
        else:
            out = out + _silhouette_chunk(part, px, scale, sigma)
    return out


def _sil_lib():
    lib = _build.load("soft_silhouette")
    if not getattr(lib, "_argtypes_set", False):
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # tri, ok, nf, h, w, scale, inv_sigma, out, stream
        lib.soft_silhouette_fwd.argtypes = [vp, vp, i32, i32, i32, f32, f32,
                                            vp, vp]
        # tri, ok, nf, h, w, scale, inv_sigma, g_out, g_tri, stream
        lib.soft_silhouette_bwd.argtypes = [vp, vp, i32, i32, i32, f32, f32,
                                            vp, vp, vp]
        for fn in (lib.soft_silhouette_fwd, lib.soft_silhouette_bwd):
            fn.restype = i32
        lib.soft_silhouette_error_string.argtypes = [i32]
        lib.soft_silhouette_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _sil_check(tri, ok):
    if tri.dtype != torch.float32 or tuple(tri.shape[1:]) != (3, 2):
        raise ValueError(f"tri must be float32 [F, 3, 2], got {tri.dtype} "
                         f"{tuple(tri.shape)}")
    if ok.dtype != torch.bool or tuple(ok.shape) != (tri.shape[0],):
        raise ValueError(f"ok must be bool [{tri.shape[0]}], got {ok.dtype} "
                         f"{tuple(ok.shape)}")
    if ok.device != tri.device:
        raise ValueError("tri and ok must lie on one device")


def _sil_launch(name, *args):
    lib = _sil_lib()
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.soft_silhouette_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def soft_silhouette_fwd(tri, ok, height: int, width: int,
                        sigma: float) -> torch.Tensor:
    """Per-pixel Σ_f log1p(−clip(sigmoid(sign(d)·d²/σ), 0, 1 − 1e-7)) over
    the faces with `ok`: tri [F, 3, 2] float32 screen corners (pixels), ok
    [F] bool → L [H, W]; the coverage is 1 − exp(L). Not differentiable
    itself (`soft_silhouette` wraps it). On a CUDA tensor it launches
    `csrc/soft_silhouette.cu`'s forward or raises; on a CPU tensor it runs
    `soft_silhouette_logsum_plain`."""
    _sil_check(tri, ok)
    if not tri.is_cuda:
        return soft_silhouette_logsum_plain(tri, ok, height, width, sigma)
    tri = tri.detach().contiguous()
    ok8 = ok.to(torch.uint8).contiguous()
    out = torch.empty((height, width), dtype=torch.float32, device=tri.device)
    _sil_launch("soft_silhouette_fwd", tri.data_ptr(), ok8.data_ptr(),
                tri.shape[0], height, width, 1.0 / max(height, width),
                1.0 / sigma, out.data_ptr())
    soft_silhouette_fwd.launches += 1
    return out


soft_silhouette_fwd.launches = 0     # kernel launches since the last reset


def soft_silhouette_bwd(tri, ok, g_out, height: int, width: int,
                        sigma: float) -> torch.Tensor:
    """The gradient of Σ_p g_out[p]·L[p] (`soft_silhouette_fwd`'s L) with
    respect to tri: [F, 3, 2]. On a CUDA tensor it launches
    `csrc/soft_silhouette.cu`'s backward (atomics: the order of the sums
    varies from run to run) or raises; on a CPU tensor it differentiates
    `soft_silhouette_logsum_plain`."""
    _sil_check(tri, ok)
    if tuple(g_out.shape) != (height, width):
        raise ValueError(f"g_out {tuple(g_out.shape)}, not {(height, width)}")
    if not tri.is_cuda:
        with torch.enable_grad():
            t = tri.detach().requires_grad_()
            L = soft_silhouette_logsum_plain(t, ok, height, width, sigma)
            return torch.autograd.grad(L, t, g_out)[0]
    tri = tri.detach().contiguous()
    ok8 = ok.to(torch.uint8).contiguous()
    g_out = g_out.detach().to(torch.float32).contiguous()
    g_tri = torch.zeros_like(tri)
    _sil_launch("soft_silhouette_bwd", tri.data_ptr(), ok8.data_ptr(),
                tri.shape[0], height, width, 1.0 / max(height, width),
                1.0 / sigma, g_out.data_ptr(), g_tri.data_ptr())
    soft_silhouette_bwd.launches += 1
    return g_tri


soft_silhouette_bwd.launches = 0     # kernel launches since the last reset


class _SilhouetteLogSum(torch.autograd.Function):
    """L = `soft_silhouette_fwd`, its backward `soft_silhouette_bwd`."""

    @staticmethod
    def forward(ctx, tri, ok, height, width, sigma):
        ctx.save_for_backward(tri, ok)
        ctx.args = (height, width, sigma)
        return soft_silhouette_fwd(tri, ok, height, width, sigma)

    @staticmethod
    def backward(ctx, g):
        tri, ok = ctx.saved_tensors
        return (soft_silhouette_bwd(tri, ok, g, *ctx.args),
                None, None, None, None)


def _face_screen(v, faces, mvp, height: int, width: int, face_valid):
    """Per-face screen corners [F, 3, 2] (differentiable in v) and the ok
    flag: valid, every corner at w > 1e-8."""
    screen_xy, w_view, _ = clip_to_screen(project_vertices(v, mvp), height,
                                          width)
    f = faces.long()
    tri = _take(screen_xy, f)
    ok = (_take(w_view.detach(), f) > 1e-8).all(-1)
    if face_valid is not None:
        ok = ok & face_valid
    return tri, ok


def soft_silhouette(v: torch.Tensor, faces: torch.Tensor, mvp: torch.Tensor,
                    height: int, width: int, sigma: float = 1e-4,
                    face_valid=None, chunk: int = 32) -> torch.Tensor:
    """Differentiable coverage [H, W] à la SoftRasterizer: per pixel
    1 − Π_f (1 − sigmoid(sign(d)·d²/σ)) over the valid faces whose corners
    all lie in front of the camera, d the signed screen distance to the
    face (positive inside) over max(H, W). Differentiable in v. On the card
    the log-sum and its backward are the CUDA kernels; on the CPU it is
    `soft_silhouette_plain` (`chunk` faces a step)."""
    tri, ok = _face_screen(v, faces, mvp, height, width, face_valid)
    if tri.is_cuda:
        L = _SilhouetteLogSum.apply(tri, ok, height, width, float(sigma))
    else:
        L = soft_silhouette_logsum_plain(tri, ok, height, width, sigma, chunk)
    return 1.0 - torch.exp(L)


def soft_silhouette_plain(v: torch.Tensor, faces: torch.Tensor,
                          mvp: torch.Tensor, height: int, width: int,
                          sigma: float = 1e-4, face_valid=None,
                          chunk: int = 32) -> torch.Tensor:
    """Plain version of `soft_silhouette` (same contract) on every device:
    `soft_silhouette_logsum_plain` under autograd."""
    tri, ok = _face_screen(v, faces, mvp, height, width, face_valid)
    return 1.0 - torch.exp(soft_silhouette_logsum_plain(
        tri, ok, height, width, sigma, chunk))
