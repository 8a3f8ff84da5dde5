"""SDF grid → mesh, fitted to multi-view depth and mask (and normal) maps.

Port of `comfy3d_tpu/algorithms/sdf_fit.py` (upstream's FlexiCubesTrainer,
`flexicubes_trainer.py:22-213`): a learnable per-vertex SDF and vertex
deformation over a regular grid (with `engine="flexicubes"` also FlexiCubes'
21 weights per cube), optimised so the extracted surface's renders match
the reference masks (through the soft silhouette), depths and normals
(through the rasterizer's live barycentrics), with the SDF sign regularizer,
a deformation penalty and, for FlexiCubes, L_dev and a weight stabilizer.

The surface engine is `ops/flexicubes.py` (its valid faces only, compacted)
or, with `engine="tets"`, `ops/tetra.py::marching_tets_diff` over
`grid_tets`, its valid triangles compacted in order. Each step renders `batch_size` views on the cameras' device;
on the card the mask loss's coverage goes through the soft-silhouette
kernels (`ops/rasterize.py::soft_silhouette`). Adam is `torch.optim.Adam`
(optax's `adam` update, m̂ / (√v̂ + ε), in another rounding order). The
views of each step come from the caller (`views=`) or from a CPU
`torch.Generator` seeded with `seed`; the JAX package draws them from
`PRNGKey(seed)`, so the two draw different views from one seed. After the
fit the eval-mode surface (FlexiCubes' quads split along the larger γ·γ
diagonal) is welded on the host into a `core.Mesh`.

Departures from the JAX package (ROADMAP §C.11, §C.13, §C.14): the normal
term takes each face's outward unit normal, the binned rasterizer keeps
every face of a tile's list, and FlexiCubes' quads keep their cycle
(`ops/flexicubes.py::QUAD_ORDERS["cycle"]`), so the fitted surface is
closed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.camera import Camera
from ..core.mesh import Mesh
from ..ops import flexicubes as FC
from ..ops import rasterize as R
from ..ops import tetra


@dataclasses.dataclass(frozen=True)
class SDFFitConfig:
    resolution: int = 32
    iterations: int = 300
    batch_size: int = 2
    lr: float = 1e-2
    lambda_mask: float = 1.0
    lambda_depth: float = 10.0
    lambda_normal: float = 0.2
    lambda_sign: float = 0.1
    lambda_deform: float = 0.5
    sigma_sil: float = 3e-4
    max_deform: float = 0.45     # fraction of a grid cell
    method: str = "binned"
    # "flexicubes": the reference's extraction (21 learnable weights per
    # cube, vertex deformation, the L_dev floater regularizer); "tets":
    # marching tets
    engine: str = "flexicubes"
    lambda_dev: float = 0.5          # remove_floaters_weight
    lambda_weights: float = 0.1      # cube_stabilizer_weight


def init_params(cfg: SDFFitConfig, init_radius: float = 0.5, device=None):
    """(params {"sdf", "deform"[, "weights"]} on `device`, requiring
    gradients; grid vertices [V, 3]; tets [T, 4] numpy or None): a sphere
    of `init_radius`, no deformation, zero weights."""
    if cfg.engine == "flexicubes":
        verts = FC.grid_verts(cfg.resolution)
        tets = None
    else:
        verts, tets = tetra.grid_tets(cfg.resolution)
    sdf = init_radius - np.linalg.norm(verts, axis=-1)
    params = {"sdf": torch.as_tensor(sdf, dtype=torch.float32, device=device),
              "deform": torch.zeros((verts.shape[0], 3), device=device)}
    if cfg.engine == "flexicubes":
        # [:12] beta, [12:20] alpha, [20] gamma, zero-init
        params["weights"] = torch.zeros((cfg.resolution ** 3, 21),
                                        device=device)
    return ({k: p.requires_grad_() for k, p in params.items()},
            torch.as_tensor(verts, device=device), tets)


def _edges_of_tets(tets: torch.Tensor) -> torch.Tensor:
    """The unique vertex pairs (lower index first) of a tet mesh's edges
    [E, 2], in lexicographic order, on the tets' device (a 1-D unique of
    one int64 key per pair: at 128³, 74 M pairs)."""
    t = tets.long()
    pairs = torch.cat([t[:, [a, b]] for a, b in
                       [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]])
    pairs = pairs.sort(dim=1).values
    n = int(t.max()) + 1
    key = torch.unique(pairs[:, 0] * n + pairs[:, 1])
    return torch.stack([torch.div(key, n, rounding_mode="floor"), key % n],
                       1)


def _grid_edges(res: int) -> np.ndarray:
    """The axis-aligned edges of a (res+1)³ vertex grid [E, 2]."""
    idx = np.arange((res + 1) ** 3).reshape(res + 1, res + 1, res + 1)
    return np.concatenate([
        np.stack([idx[:-1].ravel(), idx[1:].ravel()], 1),
        np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
        np.stack([idx[:, :, :-1].ravel(), idx[:, :, 1:].ravel()], 1)])


def sign_consistency_loss(sdf: torch.Tensor,
                          edges: torch.Tensor) -> torch.Tensor:
    """A BCE-style pull toward agreeing signs on the grid edges whose ends'
    signs differ."""
    a = sdf[edges[:, 0]]
    b = sdf[edges[:, 1]]
    flip = ((a * b) < 0).to(sdf.dtype)
    return (F.softplus(-a * torch.sign(b)) * flip).mean() + \
        (F.softplus(-b * torch.sign(a)) * flip).mean()


class SDFFit:
    """One fit's fixed inputs on the cameras' device: the references, the
    grid, the edges of the sign regularizer, and the parameters with their
    Adam state. `loss(params, view_idx)` is the objective on a batch of
    views, `step(view_idx)` one Adam step (→ the loss), `surface_soup()`
    the eval-mode surface's triangles and `mesh()` them welded."""

    def __init__(self, cameras: Camera, ref_masks, ref_depths=None,
                 ref_normals=None, cfg: SDFFitConfig = SDFFitConfig()):
        dev = cameras.device
        self.cfg, self.cameras = cfg, cameras

        def f32(a):
            return None if a is None else torch.as_tensor(
                np.asarray(a, np.float32) if not torch.is_tensor(a) else a,
                dtype=torch.float32, device=dev)

        self.ref_masks = f32(ref_masks)
        self.ref_depths = f32(ref_depths)
        self.ref_normals = f32(ref_normals)
        self.params, self.grid, tets = init_params(cfg, device=dev)
        self.fc_mode = cfg.engine == "flexicubes"
        if self.fc_mode:
            self.edges = torch.as_tensor(_grid_edges(cfg.resolution),
                                         device=dev)
            self.cell = 2.0 / cfg.resolution
            self.tets = None
        else:
            self.tets = torch.as_tensor(tets, device=dev).long()
            self.edges = _edges_of_tets(self.tets)
            self.cell = 2.0 / (cfg.resolution - 1)
        self.mvp = cameras.view_proj
        self.opt = torch.optim.Adam(list(self.params.values()), lr=cfg.lr,
                                    betas=(0.9, 0.999), eps=1e-8)

    def geometry(self, params, training: bool = True):
        """(triangles [F, 3, 3], L_dev): the surface's valid triangles in
        the JAX package's order (its other slots, masked there, carry no
        loss and no gradient)."""
        cfg = self.cfg
        deform = torch.tanh(params["deform"]) * (cfg.max_deform * self.cell)
        v = self.grid + deform
        if self.fc_mode:
            vd, _, faces, _, l_dev = FC.flexicubes(
                params["sdf"], v, cfg.resolution, weights=params["weights"],
                training=training)
            return vd[faces], l_dev
        tris, valid = tetra.marching_tets_diff(v, params["sdf"], self.tets)
        return tris[valid], torch.zeros((), device=v.device)

    def render_view(self, tris, view: int) -> dict:
        cfg, cams = self.cfg, self.cameras
        h, w = cams.height, cams.width
        flat_v = tris.reshape(-1, 3)
        faces = torch.arange(flat_v.shape[0], device=flat_v.device,
                             dtype=torch.int32).reshape(-1, 3)
        mvp = self.mvp[view]
        # every face of a tile's list rasterized (ROADMAP §C.13: the JAX
        # fit keeps 256 a tile, and at res 128 on 512² views a tile holds
        # more, so its renders have holes)
        kw = {"max_per_tile": None} if cfg.method == "binned" else {}
        rast = R.rasterize(flat_v, faces, mvp, h, w, method=cfg.method,
                           **kw)
        bary = R.recompute_barycentrics(flat_v, mvp, faces, rast)
        # differentiable depth: the view depth of the live vertices
        _, w_view, _ = R.clip_to_screen(R.project_vertices(flat_v, mvp), h, w)
        depth = R.interpolate(w_view[:, None], rast, faces, bary)[..., 0]
        soft = R.soft_silhouette(flat_v, faces, mvp, h, w,
                                 sigma=cfg.sigma_sil)
        normal = None
        if self.ref_normals is not None:
            # each face's outward unit normal (ROADMAP §C.11: the JAX
            # package divides them all by one matrix norm, and takes
            # FlexiCubes' faces, wound toward positive sdf, i.e. inward
            # here, as they come); the length floored at 1e-12 inside the
            # square root, so a degenerate face gets no NaN gradient
            fn = torch.linalg.cross(tris[:, 1] - tris[:, 0],
                                    tris[:, 2] - tris[:, 0], dim=-1)
            if self.fc_mode:
                fn = -fn
            fn = fn / torch.sqrt((fn * fn).sum(-1, keepdim=True)
                                 .clamp_min(1e-24))
            normal = R.interpolate(fn.repeat_interleave(3, 0), rast, faces,
                                   bary)
        return {"mask": rast.mask, "soft": soft, "depth": depth,
                "normal": normal}

    def loss(self, params, view_idx) -> torch.Tensor:
        cfg = self.cfg
        tris, l_dev = self.geometry(params)
        loss = 0.0
        for i in [int(i) for i in view_idx]:
            out = self.render_view(tris, i)
            m_ref = self.ref_masks[i]
            loss = loss + cfg.lambda_mask * (out["soft"] - m_ref).abs().mean()
            both = out["mask"] * m_ref
            n_both = both.sum().clamp_min(1.0)
            if self.ref_depths is not None:
                loss = loss + cfg.lambda_depth * (
                    ((out["depth"] - self.ref_depths[i]) ** 2) * both).sum() \
                    / n_both
            if self.ref_normals is not None:
                n_ref = self.ref_normals[i] * 2.0 - 1.0
                cos = (out["normal"] * n_ref).sum(-1)
                loss = loss + cfg.lambda_normal * (
                    (1.0 - cos) * both).sum() / n_both
        loss = loss / cfg.batch_size
        loss = loss + cfg.lambda_sign * sign_consistency_loss(
            params["sdf"], self.edges)
        loss = loss + cfg.lambda_deform * (params["deform"] ** 2).mean()
        if self.fc_mode:
            # L_dev and the cube-weight stabilizer
            loss = loss + cfg.lambda_dev * l_dev
            # |w| with the JAX package's derivative at 0 (1, where torch's
            # abs gives 0): the zero-initialised weights move in step one
            w = params["weights"][:, :20]
            loss = loss + cfg.lambda_weights * torch.where(
                w >= 0, w, -w).mean()
        return loss

    def step(self, view_idx) -> torch.Tensor:
        """One Adam step on the views `view_idx`; returns the loss (before
        the step)."""
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss(self.params, view_idx)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def surface_soup(self) -> np.ndarray:
        """The eval-mode surface's triangles [F, 3, 3] on the host."""
        with torch.no_grad():
            return self.geometry(self.params, training=False)[0].cpu().numpy()

    def mesh(self) -> Mesh:
        """The eval-mode surface, welded on the host."""
        soup = self.surface_soup()
        v, f = tetra.weld(soup, soup.shape[0])
        return Mesh(v=v, f=f).auto_normal()


def draw_views(iterations: int, batch_size: int, nviews: int,
               seed: int = 0) -> np.ndarray:
    """[iterations, batch_size] view indices from a CPU generator seeded
    with `seed`."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, nviews, (iterations, batch_size),
                         generator=gen).numpy()


def fit(cameras: Camera, ref_masks, ref_depths=None, ref_normals=None,
        cfg: SDFFitConfig = SDFFitConfig(), seed: int = 0,
        progress: Optional[Callable] = None, views=None) -> Mesh:
    """Fit the SDF grid on the cameras' device; returns the welded `Mesh`.

    ref_masks [V, H, W]; ref_depths [V, H, W] view-space depth (0 =
    background); ref_normals [V, H, W, 3] world normals encoded in [0, 1].
    views: the view indices of every step, [iterations, batch_size]
    (default `draw_views(..., seed)`). `progress(step, {"loss": ...})`
    every 50 steps."""
    problem = SDFFit(cameras, ref_masks, ref_depths, ref_normals, cfg)
    if views is None:
        views = draw_views(cfg.iterations, cfg.batch_size,
                           problem.ref_masks.shape[0], seed)
    for it in range(cfg.iterations):
        loss = problem.step(np.asarray(views[it]))
        if progress is not None and it % 50 == 0:
            progress(it, {"loss": float(loss)})
    return problem.mesh()
