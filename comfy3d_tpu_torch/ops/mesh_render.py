"""Mesh rendering on top of `ops.rasterize`: the `Mesh_Orbit_Renderer`
node's work.

Port of `comfy3d_tpu/ops/mesh_render.py`: RGB, alpha, depth, world normal
and view-cosine buffers for one camera or a batch of them (the JAX package
vmaps over the views; here each view is one pass of the same code, stacked).
Differentiable with respect to the vertices (through
`recompute_barycentrics`), the vertex colours and the albedo texture.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..core.camera import Camera
from . import rasterize as R


def render_mesh(v: torch.Tensor, faces: torch.Tensor, camera: Camera,
                vn: Optional[torch.Tensor] = None,
                vc: Optional[torch.Tensor] = None,
                vt: Optional[torch.Tensor] = None,
                ft: Optional[torch.Tensor] = None,
                albedo: Optional[torch.Tensor] = None,
                face_valid: Optional[torch.Tensor] = None,
                background=1.0, method: str = "binned", ssaa: int = 1):
    """Render one view, or a batch of views when `camera` has a batch
    shape, on the vertices' device.

    Returns dict(image [.., H, W, 3], alpha [.., H, W], depth, normal
    [.., H, W, 3], viewcos). The colour comes from the albedo texture
    (with vt/ft), else the vertex colours, else flat grey 0.5.
    `background` is a scalar or an RGB triple; `ssaa` renders at
    `ssaa`× the size and average-pools."""
    mvp, campos = camera.view_proj, camera.campos
    if vn is None:      # the same for every view
        vn = vertex_normals(v, faces)
    args = (v, faces, vn, vc, vt, ft, albedo, face_valid, background,
            camera.width, camera.height, method, ssaa)
    if not camera.batch_shape:
        return _render_single(*args, mvp, campos)
    mvp = mvp.reshape(-1, 4, 4)
    campos = campos.reshape(-1, 3)
    views = [_render_single(*args, mvp[i], campos[i])
             for i in range(mvp.shape[0])]
    return {k: torch.stack([o[k] for o in views]).reshape(
                camera.batch_shape + views[0][k].shape)
            for k in views[0]}


def _unit(x, eps):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        eps)


def _render_single(v, faces, vn, vc, vt, ft, albedo, face_valid, background,
                   width, height, method, ssaa, mvp, campos):
    rh, rw = height * ssaa, width * ssaa
    rast = R.rasterize(v, faces, mvp, rh, rw, face_valid=face_valid,
                       method=method)
    bary = R.recompute_barycentrics(v, mvp, faces, rast)
    alpha = rast.mask

    # geometry buffers
    pos = R.interpolate(v, rast, faces, bary)
    normal = _unit(R.interpolate(vn, rast, faces, bary), 1e-8)
    view_dir = _unit(campos - pos, 1e-8)
    viewcos = (normal * view_dir).sum(-1).abs() * alpha

    # colour
    if albedo is not None and vt is not None and ft is not None:
        uv = R.interpolate(vt, rast, ft, bary)      # face-varying UVs
        color = R.texture_sample(albedo, uv)
    elif vc is not None:
        color = R.interpolate(vc, rast, faces, bary)
    else:
        color = torch.full_like(pos, 0.5)

    bg = torch.as_tensor(background, dtype=color.dtype, device=color.device)
    a = alpha[..., None]
    image = color * a + bg * (1.0 - a)
    depth = rast.depth
    if ssaa > 1:
        image, alpha, depth, normal, viewcos = (
            _avg_pool(x, ssaa) for x in (image, alpha, depth, normal,
                                         viewcos))
    return {"image": image, "alpha": alpha, "depth": depth,
            "normal": normal, "viewcos": viewcos}


def _avg_pool(x, k):
    """[H, W] or [H, W, C] → k×k means."""
    if x.dim() == 2:
        return F.avg_pool2d(x[None, None], k)[0, 0]
    return F.avg_pool2d(x.permute(2, 0, 1)[None], k)[0].permute(1, 2, 0)


def vertex_normals(v: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted unit vertex normals (`index_add_` of the face normals
    into their corners); differentiable with respect to `v`."""
    f = faces.long()
    v0 = v[f[:, 0]]
    fn = torch.linalg.cross(v[f[:, 1]] - v0, v[f[:, 2]] - v0, dim=-1)
    vn = torch.zeros_like(v)
    for k in range(3):
        vn = vn.index_add(0, f[:, k], fn)
    return _unit(vn, 1e-12)
