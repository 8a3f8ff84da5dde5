"""3D Gaussian Splatting renderer: EWA projection, binning, and the two
compositors.

Port of `comfy3d_tpu/ops/gs_render.py`. `render_arrays(backend=...)` picks
one of two paths after the shared projection (`project_gaussians`: 3D→2D
EWA splatting, 2D covariance + 0.3 px dilation, conic, 3σ radius, frustum
cull, elementwise on [N] vectors):

  * "flat" (the default; JAX's "pallas" and "auto") — the coarse-bin path
    the JAX package runs on its accelerator: `binning.bin_coarse`, one
    (bin|depth)-key sort of (splat, bin) pairs, then `gs_flat`'s
    compositor, which reads the splats' rows by index, saturation exit per
    bin;
  * "tile" (JAX's "xla") — the per-16-px-tile path: one global depth sort
    of the splats, `binning.bin_primitives` into padded per-tile lists of
    `max_per_tile` slots, then `gs_tile`'s compositor, which reads the
    splats' rows by index and walks every counted slot.

Each compositor is a CUDA kernel for tensors on the card and its plain
PyTorch version for tensors on the CPU, with its backward likewise.
`render` loops over a batch of cameras (the JAX package vmaps). Gradients
reach xyz, scale, rotation, opacity, colours and `means2d_offset` through
autograd over the component-wise projection and the compositor's backward.
"""

from __future__ import annotations

import math

import torch

from ..core.camera import Camera
from ..core.gaussian import GaussianSplat
from . import binning, gs_flat, gs_tile
from .gs_flat import ALPHA_MIN, TILE


# ------------------------------------------------------------------ #
# 1. Projection
# ------------------------------------------------------------------ #
def project_gaussians(xyz, scale, rot_quat, w2c, intrinsics, width, height,
                      near: float = 0.01):
    """EWA projection of 3D gaussians to screen, written out on [N]
    component vectors as the JAX function is.

    Returns (means2d [N,2] px, depths [N], conics [N,3] (a,b,c) of the
    inverse 2D covariance, radii [N] px, in_frustum [N] bool).
    """
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    R = w2c[:3, :3]
    x, y, z3 = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    t0 = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z3 + w2c[0, 3]
    t1 = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z3 + w2c[1, 3]
    t2 = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z3 + w2c[2, 3]
    depth = -t2                             # camera looks down -Z
    in_front = depth > near
    d = torch.clamp_min(depth, near)
    inv_d = 1.0 / d

    # frustum-clamped view-plane coords (limits the EWA Jacobian blowup)
    lim_x = 1.3 * (0.5 * width / fx)
    lim_y = 1.3 * (0.5 * height / fy)
    tx = torch.clamp(t0 * inv_d, -lim_x, lim_x) * d
    ty = torch.clamp(t1 * inv_d, -lim_y, lim_y) * d

    u = fx * t0 * inv_d + cx
    v = -fy * t1 * inv_d + cy               # image rows grow downward

    # J rows: (j00, 0, j02) and (0, j11, j12)
    j00 = fx * inv_d
    j02 = fx * tx * inv_d * inv_d
    j11 = -fy * inv_d
    j12 = -fy * ty * inv_d * inv_d

    # world cov Σ = (R_q S)(R_q S)^T, expanded per component
    qw, qx, qy, qz = (rot_quat[:, 0], rot_quat[:, 1], rot_quat[:, 2],
                      rot_quat[:, 3])
    sx, sy, sz = scale[:, 0], scale[:, 1], scale[:, 2]
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    m00, m01, m02 = r00 * sx, r01 * sy, r02 * sz
    m10, m11, m12 = r10 * sx, r11 * sy, r12 * sz
    m20, m21, m22 = r20 * sx, r21 * sy, r22 * sz
    s00 = m00 * m00 + m01 * m01 + m02 * m02
    s01 = m00 * m10 + m01 * m11 + m02 * m12
    s02 = m00 * m20 + m01 * m21 + m02 * m22
    s11 = m10 * m10 + m11 * m11 + m12 * m12
    s12 = m10 * m20 + m11 * m21 + m12 * m22
    s22 = m20 * m20 + m21 * m21 + m22 * m22

    # camera-frame cov: W = R Σ Rᵀ (R is the 3×3 w2c rotation)
    w_rows = []
    for i in (0, 1, 2):
        ri0, ri1, ri2 = R[i, 0], R[i, 1], R[i, 2]
        a0 = ri0 * s00 + ri1 * s01 + ri2 * s02
        a1 = ri0 * s01 + ri1 * s11 + ri2 * s12
        a2 = ri0 * s02 + ri1 * s12 + ri2 * s22
        w_rows.append((a0, a1, a2))
    c00 = w_rows[0][0] * R[0, 0] + w_rows[0][1] * R[0, 1] \
        + w_rows[0][2] * R[0, 2]
    c01 = w_rows[0][0] * R[1, 0] + w_rows[0][1] * R[1, 1] \
        + w_rows[0][2] * R[1, 2]
    c02 = w_rows[0][0] * R[2, 0] + w_rows[0][1] * R[2, 1] \
        + w_rows[0][2] * R[2, 2]
    c11 = w_rows[1][0] * R[1, 0] + w_rows[1][1] * R[1, 1] \
        + w_rows[1][2] * R[1, 2]
    c12 = w_rows[1][0] * R[2, 0] + w_rows[1][1] * R[2, 1] \
        + w_rows[1][2] * R[2, 2]
    c22 = w_rows[2][0] * R[2, 0] + w_rows[2][1] * R[2, 1] \
        + w_rows[2][2] * R[2, 2]

    # 2D cov = J W Jᵀ with J = [[j00,0,j02],[0,j11,j12]]
    a = (j00 * j00 * c00 + 2 * j00 * j02 * c02 + j02 * j02 * c22) + 0.3
    b = (j00 * j11 * c01 + j00 * j12 * c02
         + j02 * j11 * c12 + j02 * j12 * c22)
    c = (j11 * j11 * c11 + 2 * j11 * j12 * c12 + j12 * j12 * c22) + 0.3

    det = a * c - b * b
    inv_det = 1.0 / torch.clamp_min(det, 1e-12)
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], -1)
    means2d = torch.stack([u, v], -1)

    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.0))
    radii = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam, 0.0)))
    visible = in_front & (det > 1e-12) & (radii > 0)
    return means2d, depth, conic, radii, visible


# ------------------------------------------------------------------ #
# 2. Coarse-bin compositing
# ------------------------------------------------------------------ #
def max_tiles_per_prim_coarse(max_tiles_per_prim: int) -> int:
    """Map a 16-px-tile footprint cap to the equivalent coarse-bin cap
    (same pixel coverage; ≥4 so a 2×2 bin straddle always fits)."""
    return max(4, max_tiles_per_prim // 4)


def _bins_to_image(x, nby, nbx, height, width, bin_px=32):
    """[nbins, NSUB, C, NPIX] → [H, W, C] (crop the bin padding)."""
    sub = bin_px // TILE
    c = x.shape[2]
    img = x.reshape(nby, nbx, sub, sub, c, TILE, TILE)
    img = img.permute(0, 2, 5, 1, 3, 6, 4)     # nby,sy,ty,nbx,sx,tx,c
    img = img.reshape(nby * sub * TILE, nbx * sub * TILE, c)
    return img[:height, :width]


def payload_rows(means2d, conic, opacity, chans, radii):
    """Per-splat rows [N, DPAY] of the coarse-bin compositor: μx, μy,
    conic a, b, c, opacity, channels, 3σ radius, zero values up to a
    multiple of 8."""
    n = means2d.shape[0]
    d_raw = 7 + chans.shape[-1]
    dpay = gs_flat.payload_width(chans.shape[-1])
    parts = [means2d, conic, opacity[:, None], chans, radii[:, None]]
    if dpay > d_raw:
        parts.append(means2d.new_zeros((n, dpay - d_raw)))
    return torch.cat(parts, dim=-1)                   # [N, DPAY]


class _CompositeFlat(torch.autograd.Function):
    """The compositor as an autograd node (JAX: `_composite_flat`, a
    custom VJP, `_flat_vjp_fwd`/`_flat_vjp_bwd`). Returns
    (acc [nbins, NSUB, C, 256], trans [.., 1, 256]).

    `forward` packs the per-splat rows (autograd is off there) and hands
    them with the sorted pairs' splat indices to
    `gs_flat.composite_bins_fwd_rows`, which reads them by index: the
    forward gathers no payload. `backward` gathers the payload
    (`gs_flat.gather_payload`) for `gs_flat.composite_bins_bwd_splats`,
    whose per-splat rows (atomics on the card, so the sums vary in their
    last bits from run to run) it splits into the gradients of means2d,
    conic, opacity and chans. The radius row has none."""

    @staticmethod
    def forward(ctx, means2d, conic, opacity, chans, radii, sprim, bounds,
                nbx, nby, width, height, bin_px):
        rows = payload_rows(means2d, conic, opacity, chans, radii)
        acc, trans, stops = gs_flat.composite_bins_fwd_rows(
            rows, sprim, bounds, nbx, nby, chans.shape[-1], width, height,
            bin_px=bin_px)
        ctx.save_for_backward(rows, bounds, trans, stops, sprim)
        ctx.geometry = (nbx, nby, chans.shape[-1], width, height, bin_px,
                        means2d.shape[0])
        return acc, trans

    @staticmethod
    def backward(ctx, g_acc, g_trans):
        # an output without a gradient arrives as zeros (autograd
        # materialises it); the permute and crop of `_bins_to_image` leave
        # the cotangents strided
        rows, bounds, trans, stops, sprim = ctx.saved_tensors
        nbx, nby, c, width, height, bin_px, n = ctx.geometry
        data = gs_flat.gather_payload(rows, sprim)
        g = gs_flat.composite_bins_bwd_splats(
            data, bounds, sprim, n, trans, stops, g_acc.contiguous(),
            g_trans.contiguous(), nbx, nby, c, width, height, bin_px=bin_px)
        return (g[:, 0:2], g[:, 2:5], g[:, 5], g[:, 6:6 + c], *[None] * 8)


def render_flat(means2d, conic, opacity, chans, depth, active, radii,
                width: int, height: int, k: int = 4, bin_px: int = 32):
    """Coarse-bin splat compositing for one camera.

    chans: [N, C] channel vector (rgb... + depth last). Returns
    (rgb [H,W,C-1], alpha [H,W], depth [H,W], overflow)."""
    nby, nbx = binning.num_bins(height, width, bin_px)
    sprim, bounds, overflow = binning.bin_coarse(
        means2d.detach(), depth.detach(), radii, active, nby, nbx, k=k,
        bin_px=bin_px)
    # inactive pairs get radius 0 → they fail every sub-tile footprint test
    r_row = torch.where(active, torch.clamp_min(radii, 0.5),
                        torch.zeros_like(radii))
    acc, trans = _CompositeFlat.apply(means2d, conic, opacity, chans, r_row,
                                      sprim, bounds, nbx, nby, width, height,
                                      bin_px)
    img = _bins_to_image(acc, nby, nbx, height, width, bin_px)
    tr = _bins_to_image(trans, nby, nbx, height, width, bin_px)[..., 0]
    alpha = 1.0 - tr
    return img[..., :-1], alpha, img[..., -1], overflow


# ------------------------------------------------------------------ #
# 3. Per-16-px-tile compositing
# ------------------------------------------------------------------ #
def tile_rows(means2d, conics, opacities, colors):
    """Per-splat rows [N, D] of the tile compositor: μx, μy, conic a, b, c,
    opacity, channels, zero values up to D = 6 + C padded to a multiple of
    8."""
    d_raw = 2 + 3 + 1 + colors.shape[-1]
    pad = gs_tile.rows_width(colors.shape[-1]) - d_raw
    parts = [means2d, conics, opacities[:, None], colors]
    if pad:
        parts.append(means2d.new_zeros((means2d.shape[0], pad)))
    return torch.cat(parts, dim=-1)                      # [N, D]


def _build_tile_data(means2d, conics, opacities, colors, prim_idx,
                     prim_valid):
    """Per-tile splat columns [T, D, M]: `tile_rows` gathered by
    `gs_tile.gather_tile_block` (invalid slots get opacity 0, so their
    gradient columns are exactly 0)."""
    return gs_tile.gather_tile_block(
        tile_rows(means2d, conics, opacities, colors), prim_idx, prim_valid)


class _CompositeTiles(torch.autograd.Function):
    """The tile compositor as an autograd node (JAX: `tile_composite_pallas`,
    a custom VJP, `_pallas_vjp_fwd`/`_pallas_vjp_bwd`; the binning stays
    outside, in `render_tiles`). Returns (acc [T, C, 256], trans
    [T, 1, 256]).

    `forward` packs the per-splat rows (autograd is off there) and hands
    them with the tiles' slot lists to `gs_tile.composite_tiles_fwd_rows`,
    which reads them by index. Only when a gradient can follow
    (`ctx.needs_input_grad`) does it ask for the [T, D, M] tile data the
    backward reads, which the kernel then writes as it stages the slots;
    serving writes none. `backward` returns the gradients of means2d,
    conic, opacity and chans itself: the per-splat rows of
    `gs_tile.composite_tiles_bwd_splats`, which sums each valid slot's
    gradient into its splat's row (atomics on the card, so the sums vary in
    their last bits from run to run), split into the four inputs."""

    @staticmethod
    def forward(ctx, means2d, conic, opacity, chans, prim_idx, valid, counts,
                grid_w):
        rows = tile_rows(means2d, conic, opacity, chans)
        keep = any(ctx.needs_input_grad[:4])
        acc, trans, block = gs_tile.composite_tiles_fwd_rows(
            rows, prim_idx, valid, counts, grid_w, chans.shape[-1],
            keep_block=keep)
        if keep:
            ctx.save_for_backward(block, counts, trans, prim_idx, valid)
        ctx.geometry = (grid_w, chans.shape[-1], means2d.shape[0])
        return acc, trans

    @staticmethod
    def backward(ctx, g_acc, g_trans):
        block, counts, trans, prim_idx, valid = ctx.saved_tensors
        grid_w, c, n = ctx.geometry
        g = gs_tile.composite_tiles_bwd_splats(
            block, counts, prim_idx, valid, n, grid_w, trans,
            g_acc.contiguous(), g_trans.contiguous(), c)
        return (g[:, 0:2], g[:, 2:5], g[:, 5], g[:, 6:6 + c], *[None] * 4)

def render_tiles(means2d, conic, opacity, chans, depth, active, radii,
                 width: int, height: int, max_per_tile: int = 512,
                 max_tiles_per_prim: int = 16):
    """Per-16-px-tile splat compositing for one camera (JAX: the `xla`
    branch of `render_arrays`).

    chans: [N, C] channel vector (rgb... + depth last). Returns
    (rgb [H,W,C-1], alpha [H,W], depth [H,W], overflow)."""
    grid_h, grid_w = binning.num_tiles(height, width)
    # global front-to-back depth order: each tile's ascending-index list
    # is then depth-ordered
    order = torch.argsort(torch.where(active, depth.detach(),
                                      torch.full_like(depth, math.inf)),
                          stable=True)
    s_means2d = means2d[order]
    s_radii = radii[order][:, None]
    bins = binning.bin_primitives(
        s_means2d.detach() - s_radii, s_means2d.detach() + s_radii,
        active[order], grid_h, grid_w, max_per_tile=max_per_tile,
        max_tiles_per_prim=max_tiles_per_prim)
    counts = torch.clamp_max(bins.count, max_per_tile)
    acc, trans = _CompositeTiles.apply(
        s_means2d, conic[order], opacity[order], chans[order],
        bins.prim_idx, bins.valid, counts, grid_w)
    img = binning.tiles_to_image(acc.transpose(1, 2), grid_h, grid_w,
                                 height, width)
    alpha = 1.0 - binning.tiles_to_image(trans[:, 0], grid_h, grid_w,
                                         height, width)
    return img[..., :-1], alpha, img[..., -1], bins.overflow


# ------------------------------------------------------------------ #
# Public renderer
# ------------------------------------------------------------------ #
# the port's two paths, and the JAX package's backend names for them
BACKENDS = {"flat": "flat", "tile": "tile", "pallas": "flat", "auto": "flat",
            "xla": "tile"}


def render_arrays(xyz, scale, rot_quat, opacity, colors, alive,
                  w2c, intrinsics, width: int, height: int,
                  background=None, max_per_tile: int = 512,
                  max_tiles_per_prim: int = 16, chunk: int = 16,
                  means2d_offset=None, backend: str = "flat",
                  bin_px: int = 32):
    """Render raw gaussian arrays for one camera on the arrays' device.

    colors: [N, C] per-gaussian channel vector (precomputed — SH eval or
    raw RGB). `means2d_offset` [N,2] is the viewspace-gradient hook.
    `backend`: "flat" (coarse bins, `bin_px`) or "tile" (16-px tiles, each
    list cut at `max_per_tile`, a multiple of 128); the JAX package's
    names map onto them: "pallas" and "auto" → "flat", "xla" → "tile".
    `chunk` is accepted for the JAX signature and has no effect: the tile
    compositor walks 128-slot chunks. Returns dict(image [H,W,C], alpha,
    depth, radii [N], means2d [N,2], overflow flag).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {sorted(BACKENDS)}, got "
                         f"{backend!r}")
    means2d, depth, conic, radii, visible = project_gaussians(
        xyz, scale, rot_quat, w2c, intrinsics, width, height)
    if means2d_offset is not None:
        means2d = means2d + means2d_offset
    active = visible & alive & (opacity > ALPHA_MIN)

    chans = torch.cat([colors, depth[:, None]], -1)
    if BACKENDS[backend] == "tile":
        rgb, alpha, depth_img, overflow = render_tiles(
            means2d, conic, opacity, chans, depth, active, radii.detach(),
            width, height, max_per_tile=max_per_tile,
            max_tiles_per_prim=max_tiles_per_prim)
    else:
        rgb, alpha, depth_img, overflow = render_flat(
            means2d, conic, opacity, chans, depth, active, radii.detach(),
            width, height, k=max_tiles_per_prim_coarse(max_tiles_per_prim),
            bin_px=bin_px)
    if background is not None:
        bg = torch.as_tensor(background, dtype=rgb.dtype, device=rgb.device)
        rgb = rgb + (1.0 - alpha[..., None]) * bg
    return {"image": rgb, "alpha": alpha, "depth": depth_img,
            "radii": radii * active, "means2d": means2d,
            "overflow": overflow}


def render(splat: GaussianSplat, camera: Camera, background=(1.0, 1.0, 1.0),
           **kw):
    """Render a GaussianSplat for one camera or a batch of cameras (a loop
    over the batch; outputs are stacked along the batch shape)."""
    if camera.device != splat.device:
        raise ValueError(f"camera on {camera.device}, splat on "
                         f"{splat.device}")
    w2c = camera.w2c
    intr = camera.intrinsics
    campos = camera.campos

    def one(w2c_i, intr_i, campos_i):
        colors = splat.colors_toward(campos_i)
        return render_arrays(splat.xyz, splat.scale, splat.rotation,
                             splat.opacity, colors, splat.alive,
                             w2c_i, intr_i, camera.width, camera.height,
                             background=background, **kw)

    bshape = camera.batch_shape
    if not bshape:
        return one(w2c, intr, campos)
    outs = [one(w, i, c) for w, i, c in zip(w2c.reshape(-1, 4, 4),
                                             intr.reshape(-1, 4),
                                             campos.reshape(-1, 3))]
    return {key: torch.stack([o[key] for o in outs]).reshape(
        bshape + tuple(outs[0][key].shape)) for key in outs[0]}
