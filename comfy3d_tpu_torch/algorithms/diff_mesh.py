"""Differentiable mesh and texture fitting to multi-view images.

Port of `comfy3d_tpu/algorithms/diff_mesh.py` (upstream's DiffRastMesh
`diff_mesh.py:24-162`): per-vertex offsets and an albedo texture (stored
pre-sigmoid, as upstream's `raw_albedo`; vertex colours when the mesh has
no UVs) fitted to reference views under MSE, MS-SSIM and the mask's
alpha, with a uniform-Laplacian smoothness term, an optional
normal-consistency term and an offset penalty. Each step renders a batch
of views through `ops/mesh_render.py::render_mesh` (differentiable in the
vertices through `recompute_barycentrics` and in the texture through
`texture_sample`) and takes one Adam step per parameter group
(`torch.optim.Adam`: optax's `adam` update, m̂ / (√v̂ + ε), in another
rounding order). With `remesh_every` the fit runs in segments with a host
remesh between them (`native.isotropic_remesh`, then decimation).

The fit runs on the cameras' device; meshes stay on the host (`core.Mesh`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core.camera import Camera
from ..core.mesh import Mesh
from ..ops import mesh_render, ssim as ssim_ops


@dataclasses.dataclass(frozen=True)
class DiffMeshConfig:
    iterations: int = 512            # the reference node's default 1024
    batch_size: int = 3
    lr_verts: float = 1e-3
    lr_texture: float = 1e-1
    lambda_ssim: float = 0.2
    lambda_alpha: float = 1.0
    lambda_lap: float = 10.0
    lambda_normal: float = 0.0
    lambda_offset: float = 0.1
    texture_size: int = 512
    ssaa: int = 1
    method: str = "binned"
    # every `remesh_every` steps a host remesh (upstream `diff_mesh.py:
    # 129-141`: clean, isotropic remesh at `remesh_size` of the bounding
    # box's diagonal, decimation above `decimate_target`); 0: none
    remesh_every: int = 0
    remesh_size: float = 0.01
    decimate_target: int = 50000


def _first_pairs(keys: np.ndarray):
    """For a sequence of keys: the index of each key's first occurrence,
    per element."""
    _, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    return first[inv.reshape(-1)]


def build_adjacency(faces: np.ndarray, num_verts: int,
                    max_degree: int = 16) -> np.ndarray:
    """One-ring neighbour table [V, max_degree] (-1 pads): each vertex's
    neighbours in the order the faces' edges (a, b), (b, c), (c, a) first
    name them, as the JAX package's loop appends them, cut at
    `max_degree`."""
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    e = f[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 3, 2)
    # directed pairs in the loop's order: u → v, then v → u, per edge
    d = np.stack([e, e[..., ::-1]], 2).reshape(-1, 2)
    table = np.full((num_verts, max_degree), -1, np.int32)
    if not len(d):
        return table
    keys = d[:, 0] * num_verts + d[:, 1]
    first = np.flatnonzero(_first_pairs(keys) == np.arange(len(keys)))
    u, v = d[first, 0], d[first, 1]
    order = np.lexsort((first, u))
    u, v = u[order], v[order]
    start = np.searchsorted(u, np.arange(num_verts))
    rank = np.arange(len(u)) - start[u]
    keep = rank < max_degree
    table[u[keep], rank[keep]] = v[keep]
    return table


def build_face_adjacency(faces: np.ndarray) -> np.ndarray:
    """[E, 2] pairs of faces sharing an edge: each later face naming an
    edge paired with the first face that named it, in the faces' order."""
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    e = np.sort(f[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2), 1)
    if not len(e):
        return np.zeros((0, 2), np.int32)
    keys = e[:, 0] * (int(f.max()) + 1) + e[:, 1]
    first = _first_pairs(keys)
    later = first != np.arange(len(keys))
    return np.stack([first[later] // 3, np.flatnonzero(later) // 3],
                    1).astype(np.int32)


def laplacian_loss(v: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """Mean squared uniform-Laplacian magnitude (smoothness)."""
    mask = (adj >= 0).to(v.dtype)
    nb = v[adj.clamp_min(0)]                          # [V, D, 3]
    n = mask.sum(1, keepdim=True)
    mean_nb = (nb * mask[..., None]).sum(1) / n.clamp_min(1.0)
    lap = (v - mean_nb) * (n > 0)
    return (lap ** 2).sum(-1).mean()


def normal_consistency_loss(v: torch.Tensor, faces: torch.Tensor,
                            adj_faces: torch.Tensor) -> torch.Tensor:
    """Mean of 1 − cos between the normals of edge-adjacent faces."""
    f = faces.long()
    v0 = v[f[:, 0]]
    n = torch.linalg.cross(v[f[:, 1]] - v0, v[f[:, 2]] - v0, dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp_min(
        1e-12)
    a = adj_faces.long()
    return (1.0 - (n[a[:, 0]] * n[a[:, 1]]).sum(-1)).mean()


def _nearest_rows(src_pts: np.ndarray, dst_pts: np.ndarray) -> np.ndarray:
    """The index into src_pts of each dst point's nearest point (host,
    chunked brute force)."""
    out = np.empty(len(dst_pts), np.int64)
    for i in range(0, len(dst_pts), 4096):
        d = ((dst_pts[i:i + 4096, None, :] - src_pts[None]) ** 2).sum(-1)
        out[i:i + 4096] = d.argmin(1)
    return out


def _periodic_remesh(mesh: Mesh, cfg: DiffMeshConfig) -> Mesh:
    """The host remesh between fit segments: weld and clean, isotropic
    remesh at `remesh_size` of the diagonal, decimation above
    `decimate_target`; vertex colours carried by the nearest old vertex,
    UVs unwrapped anew."""
    from .. import native
    from ..ops import texture as texture_ops

    v = np.asarray(mesh.v, np.float32)
    f = np.asarray(mesh.f, np.int32)
    diag = float(np.linalg.norm(v.max(0) - v.min(0)))
    cv, cf = native.clean_mesh(v, f, weld_eps=diag * 1e-4)
    rv, rf = native.isotropic_remesh(cv, cf, target_frac=cfg.remesh_size,
                                     iterations=3)
    if len(rf) == 0:
        rv, rf = cv, cf
    if len(rf) > cfg.decimate_target:
        rv, rf = native.decimate_mesh(rv, rf, cfg.decimate_target)
    out = Mesh(v=rv, f=rf, albedo=mesh.albedo,
               metallic_roughness=mesh.metallic_roughness)
    if mesh.vc is not None and len(v):
        out.vc = np.asarray(mesh.vc)[_nearest_rows(v, rv)]
    if mesh.vt is not None and mesh.ft is not None:
        out.vt, out.ft, _ = texture_ops.auto_unwrap(rv, rf)
    return out.auto_normal()


def _logit(x: torch.Tensor) -> torch.Tensor:
    x = x.clamp(1e-4, 1 - 1e-4)
    return torch.log(x / (1 - x))


class MeshFit:
    """One fit segment's fixed inputs on the cameras' device: the mesh's
    vertices, faces, adjacency tables and UVs, the reference views and
    masks; `init_params()` the trainable tensors, `loss(params, view_idx)`
    the objective on a batch of views."""

    def __init__(self, mesh: Mesh, cameras: Camera, images, masks,
                 cfg: DiffMeshConfig):
        dev = cameras.device
        self.cfg, self.cameras, self.mesh = cfg, cameras, mesh
        self.images = torch.as_tensor(images, dtype=torch.float32,
                                      device=dev)
        self.masks = torch.as_tensor(masks, dtype=torch.float32, device=dev)
        self.v0 = torch.as_tensor(mesh.v, dtype=torch.float32, device=dev)
        self.faces = torch.as_tensor(mesh.f, device=dev)
        self.adj = torch.as_tensor(
            build_adjacency(mesh.f, mesh.num_vertices), device=dev).long()
        self.adj_f = torch.as_tensor(build_face_adjacency(mesh.f),
                                     device=dev)
        self.use_texture = mesh.vt is not None and mesh.ft is not None
        if self.use_texture:
            self.vt = torch.as_tensor(mesh.vt, dtype=torch.float32,
                                      device=dev)
            self.ft = torch.as_tensor(mesh.ft, device=dev)

    def init_params(self) -> dict:
        """{"offsets": zeros, "raw_albedo" [T, T, 3] (the mesh's albedo of
        the config's size, else 0.5) or "raw_vc" [V, 3] (its vertex colours,
        else 0.5), pre-sigmoid}, each requiring gradients."""
        cfg, mesh, dev = self.cfg, self.mesh, self.v0.device
        params = {"offsets": torch.zeros_like(self.v0)}
        if self.use_texture:
            ts = cfg.texture_size
            init = (torch.as_tensor(mesh.albedo, dtype=torch.float32,
                                    device=dev)
                    if mesh.albedo is not None and mesh.albedo.shape[0] == ts
                    else torch.full((ts, ts, 3), 0.5, device=dev))
            params["raw_albedo"] = _logit(init)
        else:
            init = (torch.as_tensor(mesh.vc, dtype=torch.float32,
                                    device=dev)
                    if mesh.vc is not None
                    else torch.full_like(self.v0, 0.5))
            params["raw_vc"] = _logit(init)
        return {k: p.requires_grad_() for k, p in params.items()}

    def loss(self, params: dict, view_idx: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        v = self.v0 + params["offsets"]
        if self.use_texture:
            kw = dict(vt=self.vt, ft=self.ft,
                      albedo=torch.sigmoid(params["raw_albedo"]))
        else:
            kw = dict(vc=torch.sigmoid(params["raw_vc"]))
        cam = dataclasses.replace(self.cameras,
                                  c2w=self.cameras.c2w[view_idx],
                                  fovy_deg=self.cameras.fovy_deg[view_idx])
        out = mesh_render.render_mesh(v, self.faces, cam, method=cfg.method,
                                      ssaa=cfg.ssaa, **kw)
        ref_m = self.masks[view_idx]
        rendered = out["image"] * ref_m[..., None]
        target = self.images[view_idx] * ref_m[..., None]
        mse = ((rendered - target) ** 2).mean()
        l_ssim = 1.0 - ssim_ops.ms_ssim(target, rendered, levels=3)
        l_alpha = ((out["alpha"] - ref_m) ** 2).mean()
        loss = (1 - cfg.lambda_ssim) * mse + cfg.lambda_ssim * l_ssim \
            + cfg.lambda_alpha * l_alpha \
            + cfg.lambda_lap * laplacian_loss(v, self.adj) \
            + cfg.lambda_offset * (params["offsets"] ** 2).sum(-1).mean()
        if cfg.lambda_normal > 0 and self.adj_f.shape[0] > 0:
            loss = loss + cfg.lambda_normal * normal_consistency_loss(
                v, self.faces, self.adj_f)
        return loss


def fit(mesh: Mesh, cameras: Camera, images, masks,
        cfg: DiffMeshConfig = DiffMeshConfig(), seed: int = 0,
        progress: Optional[Callable] = None, views=None) -> Mesh:
    """Fit the vertex offsets and the albedo (vertex colours without UVs)
    of `mesh` to `images` [N, H, W, 3] and `masks` [N, H, W] seen by
    `cameras` (batch N) → a new host `Mesh`, normals recomputed.

    views: the view indices of every step, [iterations, batch_size];
    without them each segment draws its own from a CPU generator seeded
    with `seed` plus the segment's first step (the JAX package reseeds its
    `PRNGKey` so). With `remesh_every` > 0 and a vertex learning rate the
    fit runs in segments of that many steps with `_periodic_remesh`
    between them. `progress(step, {"loss": ...})` every 50 steps."""
    remesh_on = cfg.remesh_every > 0 and cfg.lr_verts > 0
    remaining, it_base = cfg.iterations, 0
    while True:
        seg = remaining if not remesh_on else min(cfg.remesh_every,
                                                  remaining)
        seg_views = None if views is None else views[it_base:it_base + seg]
        mesh = _fit_segment(mesh, cameras, images, masks, cfg, seg,
                            seed + it_base, it_base, progress, seg_views)
        remaining -= seg
        it_base += seg
        if remaining <= 0:
            return mesh
        mesh = _periodic_remesh(mesh, cfg)


def _fit_segment(mesh, cameras, images, masks, cfg: DiffMeshConfig,
                 iterations: int, seed: int, it_base: int,
                 progress: Optional[Callable], views) -> Mesh:
    problem = MeshFit(mesh, cameras, images, masks, cfg)
    params = problem.init_params()
    colour = "raw_albedo" if problem.use_texture else "raw_vc"
    opt = torch.optim.Adam([
        {"params": [params["offsets"]], "lr": cfg.lr_verts},
        {"params": [params[colour]], "lr": cfg.lr_texture}],
        betas=(0.9, 0.999), eps=1e-8)
    nviews = problem.images.shape[0]
    gen = torch.Generator().manual_seed(int(seed))
    for it in range(iterations):
        if views is None:
            idx = torch.randint(0, nviews, (cfg.batch_size,), generator=gen)
        else:
            idx = torch.as_tensor(np.asarray(views[it]), dtype=torch.long)
        opt.zero_grad(set_to_none=True)
        loss = problem.loss(params, idx.to(problem.v0.device))
        loss.backward()
        opt.step()
        if progress is not None and it % 50 == 0:
            progress(it_base + it, {"loss": float(loss)})
    with torch.no_grad():
        v = (problem.v0 + params["offsets"]).cpu().numpy()
        fitted = torch.sigmoid(params[colour]).cpu().numpy()
    out = dataclasses.replace(
        mesh, v=v, albedo=fitted if problem.use_texture else mesh.albedo,
        vc=mesh.vc if problem.use_texture else fitted)
    return out.auto_normal()
