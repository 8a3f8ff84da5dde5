"""UV unwrapping and texture baking.

Port of `comfy3d_tpu/ops/texture.py`: one UV-space rasterization serves the
bakes of SF3D's texture baker and `mesh_utils.color_func_to_albedo` (UV
rasterize → interpolate → query colours → dilate), and `auto_unwrap` takes
the charted LSCM atlas (`ops/uv_atlas.py`, the xatlas role), falling back
to the box-projection unwrap for very large meshes or when the atlas fails.

The unwraps are host code over numpy arrays. The UV rasterization reuses
`ops/rasterize.py` with an orthographic map of the unit UV square to clip
space, on `device` (default: the card). Textures come back v-up (row 0 =
v = 0, the `core/io` convention): the rasterizer's rows run y-down, so the
bakes flip them (`torch.flip`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core import image as image_ops
from . import rasterize as R


def auto_unwrap(v: np.ndarray, f: np.ndarray, padding: float = 0.01,
                max_atlas_faces: int = 300_000):
    """Charted LSCM atlas (xatlas role) up to `max_atlas_faces` faces, else
    (or when the atlas raises) the box unwrap. Returns (vt, ft) and which
    unwrap ran, "atlas" or "box"."""
    f = np.asarray(f)
    if f.shape[0] <= max_atlas_faces:
        try:
            from .uv_atlas import atlas_unwrap
            vt, ft = atlas_unwrap(np.asarray(v), f, padding=padding)
            return vt, ft, "atlas"
        except Exception as e:  # noqa: BLE001 — degenerate inputs
            print(f"[texture.auto_unwrap] atlas failed ({e!r}); "
                  "falling back to box unwrap")
    vt, ft = box_unwrap(np.asarray(v), f, padding=padding)
    return vt, ft, "box"


# ------------------------------------------------------------------ #
# Box-projection UV unwrap (SF3D box_uv_unwrap role)
# ------------------------------------------------------------------ #
def box_unwrap(v: np.ndarray, f: np.ndarray, padding: float = 0.01):
    """Returns (vt [Nt, 2], ft [M, 3]): per-face UVs from the dominant
    normal axis, packed into a 3×2 chart grid. Face-varying (each face
    gets its own UV verts — welded per chart where positions coincide).
    """
    v = np.asarray(v, np.float32)
    f = np.asarray(f, np.int64)
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    n = np.cross(e1, e2)
    axis = np.abs(n).argmax(axis=1)                       # 0=x,1=y,2=z
    sign = np.take_along_axis(n, axis[:, None], 1)[:, 0] >= 0
    chart = axis * 2 + sign.astype(np.int64)              # 0..5

    # project: drop the dominant axis
    proj_axes = {0: (1, 2), 1: (0, 2), 2: (0, 1)}
    lo, hi = v.min(0), v.max(0)
    extent = np.maximum(hi - lo, 1e-8)

    vt_rows = []
    ft = np.zeros_like(f, dtype=np.int32)
    cell_w, cell_h = 1.0 / 3.0, 1.0 / 2.0
    weld: dict = {}
    for fi in range(len(f)):
        c = int(chart[fi])
        a0, a1 = proj_axes[c // 2]
        cx, cy = c % 3, c // 3
        for k in range(3):
            vid = int(f[fi, k])
            key = (c, vid)
            if key not in weld:
                u = (v[vid, a0] - lo[a0]) / extent[a0]
                w = (v[vid, a1] - lo[a1]) / extent[a1]
                u = cx * cell_w + (padding + u * (1 - 2 * padding)) * cell_w
                w = cy * cell_h + (padding + w * (1 - 2 * padding)) * cell_h
                weld[key] = len(vt_rows)
                vt_rows.append((u, w))
            ft[fi, k] = weld[key]
    return np.asarray(vt_rows, np.float32), ft


# ------------------------------------------------------------------ #
# UV-space rasterization + baking
# ------------------------------------------------------------------ #
def _uv_clip(vt: torch.Tensor) -> torch.Tensor:
    """UV [0,1]² → clip coordinates covering the texture image (z 0,
    w 1)."""
    x = vt[:, 0] * 2.0 - 1.0
    y = vt[:, 1] * 2.0 - 1.0
    return torch.stack([x, y, torch.zeros_like(x), torch.ones_like(x)], -1)


@torch.no_grad()
def rasterize_uv(vt, ft, texture_size: int, face_valid=None,
                 method: str = "binned", device=None) -> R.RasterOut:
    """Rasterize the UV layout into texture space: per texel (face_id,
    barycentrics), rows y-down; the SF3D texture_baker `rast` pass. On
    `device` (default: the card)."""
    dev = resolve_device(device)
    vt = torch.as_tensor(np.asarray(vt, np.float32), device=dev)
    ft = torch.as_tensor(np.asarray(ft, np.int32), device=dev)
    screen_xy, w_view, _ = R.clip_to_screen(_uv_clip(vt), texture_size,
                                            texture_size)
    if face_valid is None:
        face_valid = torch.ones(ft.shape[0], dtype=torch.bool, device=dev)
    if method == "binned":
        return R.rasterize_binned(screen_xy, w_view, ft, face_valid,
                                  texture_size, texture_size)
    if method == "bruteforce":
        return R.rasterize_bruteforce(screen_xy, w_view, ft, face_valid,
                                      texture_size, texture_size)
    raise ValueError(f"method must be one of {R.METHODS}, got {method!r}")


def bake_attributes(rast: R.RasterOut, attr: torch.Tensor,
                    faces: torch.Tensor) -> torch.Tensor:
    """Per-vertex attributes attr [V, C] interpolated at every covered
    texel through `faces` (geometric faces, with the UV rasterization's
    face ids): the texture_baker `bake` pass."""
    return R.interpolate(attr, rast, faces)


@torch.no_grad()
def bake_vertex_colors(v, f, vt, ft, colors, texture_size: int = 1024,
                       dilate_iters: int = 16, method: str = "binned",
                       device=None) -> torch.Tensor:
    """Per-vertex colours [V, 3] baked into an albedo and dilated: [S, S,
    3] float32, v-up, on `device` (default: the card)."""
    dev = resolve_device(device)
    rast = rasterize_uv(vt, ft, texture_size, method=method, device=dev)
    tex = bake_attributes(rast, torch.as_tensor(np.asarray(colors,
                                                           np.float32),
                                                device=dev),
                          torch.as_tensor(np.asarray(f), device=dev))
    tex = image_ops.dilate_texture(tex, rast.mask, iterations=dilate_iters)
    return torch.flip(tex, (0,))


@torch.no_grad()
def bake_color_fn(v, f, vt, ft, color_fn, texture_size: int = 1024,
                  dilate_iters: int = 16, chunk: int = 262144,
                  method: str = "binned", device=None) -> torch.Tensor:
    """Bake a 3D colour field: rasterize the UVs → interpolate 3D positions
    → query `color_fn(pts [M, 3]) → [M, 3]` `chunk` texels at a time (every
    texel, the uncovered ones at the origin) → keep the covered ones →
    dilate. [S, S, 3] float32, v-up, on `device` (default: the card);
    counterpart of `color_func_to_albedo` (mesh_utils.py:521-568)."""
    dev = resolve_device(device)
    rast = rasterize_uv(vt, ft, texture_size, method=method, device=dev)
    pos = R.interpolate(torch.as_tensor(np.asarray(v, np.float32),
                                        device=dev), rast,
                        torch.as_tensor(np.asarray(f), device=dev))
    flat = pos.reshape(-1, 3)
    tex = torch.cat([color_fn(flat[i:i + chunk])
                     for i in range(0, flat.shape[0], chunk)])
    tex = tex.reshape(texture_size, texture_size, 3) * rast.mask[..., None]
    tex = image_ops.dilate_texture(tex, rast.mask, iterations=dilate_iters)
    return torch.flip(tex, (0,))
