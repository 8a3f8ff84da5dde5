"""Triangle rasterization, attribute interpolation and texture lookup.

Port of the part of `comfy3d_tpu/ops/rasterize.py` that `render_mesh` runs:

  rasterize  discrete visibility, per pixel (face_id, barycentrics, depth,
             mask), by one of two paths with one contract: `"bruteforce"`,
             a scan over chunks of faces for every pixel, and `"binned"`,
             the faces binned into 16-px tiles (`ops.binning`) and each
             tile's list scanned `chunk` faces at a time.
  recompute_barycentrics  the weights re-derived from live vertices at the
             rasterized face ids: the gradient path to vertex positions
             (visibility itself is not differentiated).
  interpolate, texture_sample  attribute interpolation and bilinear
             texture lookup (wrap or clamp), differentiable.

The z-test keeps the nearest face; within a chunk `torch.argmin` returns the
first minimum, as `jnp.argmin` does, and a later chunk wins only when
strictly nearer, so the lowest face index wins ties on both paths. Faces
with a corner at w ≤ 1e-8 are dropped. The scans are plain tensor code on
every device (the JAX package has no Pallas rasterizer).

Conventions: OpenGL clip space (`core.camera`); screen x right, y down
(image row 0 = top); face_id −1 is background; barycentrics are
screen-space (w0, w1, w2) in the face's vertex order, perspective-corrected
by `recompute_barycentrics`.
"""

from __future__ import annotations

import dataclasses

import torch

from . import binning
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
                     width: int, max_per_tile: int = 256,
                     max_tiles_per_prim: int = 64,
                     chunk: int = 8) -> RasterOut:
    """Faces binned into 16-px tiles by their screen boxes; each tile scans
    the first `max_per_tile` faces of its list, in ascending index,
    `chunk` at a time (steps past the longest list are skipped: their
    slots are all invalid)."""
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
    longest = int(bins.count.max())
    for s in range(0, min(longest, max_per_tile), chunk):
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
def recompute_barycentrics(v: torch.Tensor, mvp: torch.Tensor,
                           faces: torch.Tensor, rast: RasterOut,
                           perspective: bool = True) -> torch.Tensor:
    """[H, W, 3] weights re-derived from the live vertices at the
    rasterized face ids (perspective-corrected; 0 at background):
    differentiable with respect to `v`."""
    h, w = rast.face_id.shape
    fv = faces.long()[rast.face_id.clamp_min(0).long()]       # [H, W, 3]
    screen_xy, w_view, _ = clip_to_screen(project_vertices(v, mvp), h, w)
    p0, p1, p2 = (screen_xy[fv[..., i]] for i in range(3))
    px = _pixel_centers(h, w, v.device)
    area = _edge(p2, p0, p1)
    b = torch.stack([_edge(px, p1, p2), _edge(px, p2, p0),
                     _edge(px, p0, p1)], -1) \
        * _safe_inverse_area(area)[..., None]
    if perspective:
        bw = b / w_view[fv].clamp_min(1e-8)
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
    return (bary[..., 0:1] * attr[fv[..., 0]]
            + bary[..., 1:2] * attr[fv[..., 1]]
            + bary[..., 2:3] * attr[fv[..., 2]])


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
        return tex[vi.long(), ui.long()]

    return ((1 - fu) * (1 - fv) * fetch(u0, v0)
            + fu * (1 - fv) * fetch(u0 + 1, v0)
            + (1 - fu) * fv * fetch(u0, v0 + 1)
            + fu * fv * fetch(u0 + 1, v0 + 1))
