"""Multi-view colour projection onto a mesh, and its bake into a texture.

Port of `comfy3d_tpu/algorithms/color_project.py`, the back-projection of
Hunyuan3D paint's `bake_from_multiview` (view-cosine-weighted, with the
candidate views' weights), which Unique3D's `multiview_color_projection`
and MV-Adapter's texture projection share.

Per view: rasterize a depth buffer (`ops/rasterize.py::rasterize`), project
every vertex, depth-test it against the buffer at its pixel, weight it by
the view cosine to the power `cos_power` (times the view's weight) and
sample the image bilinearly there. The weighted colours are averaged per
vertex; the vertices no view saw are filled by the native vertex inpaint
(`native.inpaint_vertex_colors`, the mesh-inpaint processor's role), and
`bake_projection` bakes the vertex colours into a UV albedo
(`ops/texture.py::bake_vertex_colors`), unwrapping first if the mesh has no
UVs. Tensors live on `device` (default: the card); the mesh is host numpy.

Departure from the JAX package: its `project_and_inpaint` catches any
failure of the native library and fills the unseen vertices with the mean
colour; here a failed build or load raises, since a mean fill would hide a
broken library. Each stage runs inside a `torch.profiler.record_function`
span named in `BAKE_SPANS`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from .. import native, resolve_device
from ..core.camera import Camera
from ..core.mesh import Mesh
from ..ops import rasterize as R
from ..ops import texture as T

BAKE_SPANS = ("color_project.project", "color_project.inpaint",
              "color_project.unwrap", "color_project.bake")
# a vertex is seen when its view depth is at most the z-buffer's at its
# pixel times (1 + DEPTH_EPS), plus 1e-4
DEPTH_EPS = 2e-3


def _sample_bilinear(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """img [H, W, C]; xy [N, 2] pixel coordinates → [N, C], the centres at
    half-integers, clamped to the border."""
    h, w = img.shape[0], img.shape[1]
    x = torch.clamp(xy[:, 0] - 0.5, 0.0, w - 1.0)
    y = torch.clamp(xy[:, 1] - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    return ((1 - fx) * (1 - fy) * img[y0, x0]
            + fx * (1 - fy) * img[y0, x1]
            + (1 - fx) * fy * img[y1, x0]
            + fx * fy * img[y1, x1])


def _sample_nearest(depth: torch.Tensor, xy: torch.Tensor, h: int, w: int):
    """depth [H, W] at the pixel each xy [N, 2] falls in: the coordinates
    truncated toward zero, then clipped to the image. They are clamped to
    [-1, size] first, where the cast is exact (XLA's saturating cast gives
    the same pixel for any finite coordinate)."""
    x = xy[:, 0].clamp(-1.0, float(w)).to(torch.int32).clamp(0, w - 1)
    y = xy[:, 1].clamp(-1.0, float(h)).to(torch.int32).clamp(0, h - 1)
    return depth[y.long(), x.long()]


def _f32(x, device) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = np.asarray(x, np.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def project_colors(mesh: Mesh, images, cameras: Camera,
                   cos_power: float = 4.0, view_weights=None, device=None):
    """images [V, H, W, 3]; `cameras` a batch of V at the images' size →
    (vertex colours [N, 3], confidence [N]) on `device` (default: the
    card). The confidence is the sum over views of the visible vertices'
    cos^p (times `view_weights[i]`, Hunyuan paint's candidate view
    weights)."""
    dev = resolve_device(device)
    images = _f32(images, dev)
    v = _f32(mesh.v, dev)
    f = torch.as_tensor(np.asarray(mesh.f, np.int32), device=dev)
    if mesh.vn is None:
        mesh = mesh.auto_normal()
    vn = _f32(mesh.vn, dev)
    n_views, h, w = images.shape[0], int(images.shape[1]), \
        int(images.shape[2])
    mvps = cameras.view_proj.to(dev).reshape(-1, 4, 4)
    campos = cameras.campos.to(dev).reshape(-1, 3)

    acc = torch.zeros((v.shape[0], 3), device=dev)
    wacc = torch.zeros((v.shape[0],), device=dev)
    for i in range(n_views):
        rast = R.rasterize(v, f, mvps[i], h, w)
        xy, wv, valid = R.clip_to_screen(R.project_vertices(v, mvps[i]),
                                         h, w)
        # depth test: the vertex's view depth against the z-buffer
        zbuf = _sample_nearest(rast.depth, xy, h, w)
        visible = valid & (wv <= zbuf * (1.0 + DEPTH_EPS) + 1e-4) \
            & (zbuf > 0)
        to_cam = campos[i][None, :] - v
        to_cam = to_cam / torch.clamp_min(torch.linalg.vector_norm(
            to_cam, dim=-1, keepdim=True), 1e-8)
        cosv = torch.clamp_min((to_cam * vn).sum(-1), 0.0)
        weight = torch.where(visible, cosv ** cos_power, 0.0)
        if view_weights is not None:
            weight = weight * float(view_weights[i])
        cols = _sample_bilinear(images[i], xy)
        acc = acc + cols * weight[:, None]
        wacc = wacc + weight
    return acc / torch.clamp_min(wacc, 1e-8)[:, None], wacc


def project_and_inpaint(mesh: Mesh, images, cameras: Camera,
                        cos_power: float = 4.0,
                        confidence_min: float = 1e-3, view_weights=None,
                        device=None) -> Mesh:
    """The mesh with vertex colours `vc` from the views: vertices of
    confidence at most `confidence_min` are inpainted over the mesh's edges
    by the native library (which raises if it cannot be built or
    loaded)."""
    with record_function(BAKE_SPANS[0]):
        colors, conf = project_colors(mesh, images, cameras, cos_power,
                                      view_weights=view_weights,
                                      device=device)
        colors = colors.cpu().numpy()
        seen = conf.cpu().numpy() > confidence_min
    with record_function(BAKE_SPANS[1]):
        colors, _ = native.inpaint_vertex_colors(colors, seen, mesh.f)
    return dataclasses.replace(mesh, vc=np.clip(colors, 0.0, 1.0))


def bake_projection(mesh: Mesh, images, cameras: Camera,
                    texture_size: int = 1024, cos_power: float = 4.0,
                    view_weights=None, device=None,
                    info: dict | None = None) -> Mesh:
    """Views → vertex colours (`project_and_inpaint`) → a UV albedo
    [S, S, 3] (v-up, dilated) on the mesh, unwrapped with
    `texture.auto_unwrap` if it has no UVs. `info`, when given, receives
    which unwrap ran: "atlas", "box", or "given" (the mesh's own UVs)."""
    dev = resolve_device(device)
    mesh = project_and_inpaint(mesh, images, cameras, cos_power,
                               view_weights=view_weights, device=dev)
    unwrap = "given"
    if mesh.vt is None or mesh.ft is None:
        with record_function(BAKE_SPANS[2]):
            vt, ft, unwrap = T.auto_unwrap(mesh.v, mesh.f)
        mesh = dataclasses.replace(mesh, vt=vt, ft=ft)
    if info is not None:
        info["unwrap"] = unwrap
    with record_function(BAKE_SPANS[3]):
        albedo = T.bake_vertex_colors(mesh.v, mesh.f, mesh.vt, mesh.ft,
                                      mesh.vc, texture_size=texture_size,
                                      device=dev)
    return dataclasses.replace(mesh, albedo=albedo.cpu().numpy())
