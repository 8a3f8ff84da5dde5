"""Instant-NGP NeRF fitting (multi-view images → radiance field → density
grid).

Port of `comfy3d_tpu/algorithms/ngp.py`: a hash-grid encoder with density
and colour MLPs (`NGPField`, the JAX package's `make_field` closures as one
module), occupancy-grid-masked volume rendering (`ops/raymarch.py`), an Adam
fit with TV regularisation (`fit`, stepped by `NGPFit`), and the chunked
density queries for extraction (`density_grid`).

Random draws come from explicit `torch.Generator`s, or from the caller: each
iteration of `fit` takes the ray indices, the march jitter, the TV samples
and (on the iterations that update the occupancy grid) its jitter, so a
test can replay the JAX package's key schedule (`draws=`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..core.camera import Camera, get_rays
from ..ops import hashgrid, raymarch

# the TV regulariser's samples per step (`hashgrid.total_variation_loss`'s
# default in the JAX package)
TV_SAMPLES = 4096
# iterations below this update the occupancy grid every step
OCC_WARMUP = 64


@dataclasses.dataclass(frozen=True)
class NGPConfig:
    iterations: int = 512
    ray_batch: int = 4096
    num_steps: int = 128
    lr: float = 1e-2
    lambda_tv: float = 1e-7
    lambda_entropy: float = 1e-3
    bound: float = 1.0
    occ_res: int = 64
    occ_update_every: int = 16
    occ_threshold: float = 0.01
    grid: hashgrid.HashGridConfig = hashgrid.HashGridConfig()
    hidden: int = 64
    geo_feat_dim: int = 15


def _dir_encoding(dirs: torch.Tensor) -> torch.Tensor:
    """SH-flavoured direction features (degree-3 basis → 16 dims)."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    feats = [torch.ones_like(x), x, y, z, x * y, y * z, x * z,
             x * x - y * y, 3 * z * z - 1,
             x * (x * x - 3 * y * y), y * (3 * x * x - y * y),
             z * (x * x - y * y), x * y * z,
             x * (5 * z * z - 1), y * (5 * z * z - 1),
             z * (5 * z * z - 3)]
    return torch.stack(feats, -1)


class NGPField(nn.Module):
    """The radiance field: `table` [L, T, F] hash-grid features; `sig1`,
    `sig2` the density MLP (encoding → hidden → 1 σ + geo features);
    `col1`, `col2` the colour MLP (geo features + direction encoding →
    hidden → rgb). Zero-initialised; `init_params` draws the JAX package's
    init, `convert.ngp_state_from_flax` carries its params over."""

    def __init__(self, cfg: NGPConfig):
        super().__init__()
        self.cfg = cfg
        g = cfg.grid
        self.table = nn.Parameter(torch.zeros(
            g.num_levels, g.table_size, g.features_per_level))
        self.sig1 = nn.Linear(g.output_dim, cfg.hidden)
        self.sig2 = nn.Linear(cfg.hidden, 1 + cfg.geo_feat_dim)
        self.col1 = nn.Linear(cfg.geo_feat_dim + 16, cfg.hidden)
        self.col2 = nn.Linear(cfg.hidden, 3)
        for p in self.parameters():
            nn.init.zeros_(p)

    @staticmethod
    def _mlp(h, l1, l2):
        return l2(F.relu(l1(h)))

    def density(self, xyz):
        """xyz [M, 3] in the ±bound box → (σ [M], geo features [M, G])."""
        u = (xyz / self.cfg.bound) * 0.5 + 0.5
        enc = hashgrid.encode(self.table, u, self.cfg.grid)
        out = self._mlp(enc, self.sig1, self.sig2)
        return torch.exp(out[:, 0].clamp(-10.0, 10.0)), out[:, 1:]

    def field(self, xyz, dirs):
        """(σ [M], rgb [M, 3]) at points xyz along unit directions dirs."""
        sigma, geo = self.density(xyz)
        h = torch.cat([geo, _dir_encoding(dirs)], -1)
        return sigma, torch.sigmoid(self._mlp(h, self.col1, self.col2))

    forward = field


def init_params(cfg: NGPConfig, generator: torch.Generator,
                device=None) -> NGPField:
    """A field with the JAX package's init distribution: the table uniform
    ±1e-4, each weight normal with std 1/sqrt(fan_in), biases 0; drawn from
    `generator` on its device, then moved to `device`."""
    field = NGPField(cfg).to(generator.device)
    with torch.no_grad():
        field.table.copy_(hashgrid.init_params(cfg.grid, generator))
        for lin in (field.sig1, field.sig2, field.col1, field.col2):
            w = torch.randn(lin.weight.shape, generator=generator,
                            device=generator.device)
            lin.weight.copy_(w / np.sqrt(lin.in_features))
    return field.to(resolve_device(device))


def make_field(state: Mapping[str, torch.Tensor], cfg: NGPConfig,
               device=None) -> NGPField:
    """An `NGPField` holding `state` (a state dict, e.g. from
    `convert.ngp_state_from_flax`) on `device` (default: the card)."""
    field = NGPField(cfg)
    field.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32))
                           if not torch.is_tensor(v) else v
                           for k, v in state.items()}, strict=True)
    return field.to(resolve_device(device))


class NGPFit:
    """The fit's state and its step: the field, its Adam (the JAX package's:
    β = (0.9, 0.999), ε = 1e-8 outside the square root, dense moments), the
    occupancy EMA [R, R, R], the flattened training rays and the draws'
    generator, all on `device` (default: the card). Images composite
    against white where the mask is 0."""

    def __init__(self, cameras: Camera, images, masks,
                 cfg: NGPConfig = NGPConfig(), seed: int = 0,
                 init: Optional[NGPField] = None, device=None):
        dev = resolve_device(device)
        cameras = dataclasses.replace(cameras, c2w=cameras.c2w.to(dev),
                                      fovy_deg=cameras.fovy_deg.to(dev))
        self.cfg = cfg
        images = torch.as_tensor(images, dtype=torch.float32, device=dev)
        masks = torch.as_tensor(masks, dtype=torch.float32, device=dev)
        origins, dirs = get_rays(cameras)
        self.flat_o = origins.reshape(-1, 3)
        self.flat_d = dirs.reshape(-1, 3)
        m = masks[..., None]
        self.flat_rgb = (images * m + (1.0 - m)).reshape(-1, 3)
        self.flat_m = masks.reshape(-1)
        self.nrays = self.flat_o.shape[0]
        if init is None:
            init = init_params(cfg, torch.Generator(dev).manual_seed(seed),
                               device=dev)
        self.field = init.to(dev)
        self.occ = torch.zeros((cfg.occ_res,) * 3, device=dev)
        self.opt = torch.optim.Adam(self.field.parameters(), lr=cfg.lr,
                                    betas=(0.9, 0.999), eps=1e-8,
                                    fused=dev.type == "cuda")
        self.generator = torch.Generator(dev).manual_seed(seed + 1)

    def updates_occupancy(self, it: int) -> bool:
        return it < OCC_WARMUP or it % self.cfg.occ_update_every == 0

    def draw(self, it: int) -> dict:
        """Iteration `it`'s draws from the generator: ray indices [B],
        march jitter [B, S], TV samples [TV_SAMPLES, 3] and, when the
        iteration updates the occupancy grid, its jitter [R³, 3]."""
        cfg, g, dev = self.cfg, self.generator, self.generator.device
        d = {"idx": torch.randint(0, self.nrays, (cfg.ray_batch,),
                                  generator=g, device=dev),
             "jitter": torch.rand((cfg.ray_batch, cfg.num_steps),
                                  generator=g, device=dev),
             "tv": torch.rand((TV_SAMPLES, 3), generator=g, device=dev)}
        if self.updates_occupancy(it):
            d["occ"] = torch.rand((cfg.occ_res ** 3, 3), generator=g,
                                  device=dev)
        return d

    def loss(self, d: dict) -> torch.Tensor:
        cfg = self.cfg
        idx = d["idx"].to(self.flat_o.device)
        out = raymarch.march(self.field.field, self.flat_o[idx],
                             self.flat_d[idx],
                             occ_grid=self.occ > cfg.occ_threshold,
                             bound=cfg.bound, num_steps=cfg.num_steps,
                             jitter=d["jitter"])
        rgb = out["rgb"] + (1.0 - out["alpha"][:, None])        # white bg
        loss = ((rgb - self.flat_rgb[idx]) ** 2).mean()
        loss = loss + cfg.lambda_entropy * (
            (out["alpha"] - self.flat_m[idx]) ** 2).mean()
        if cfg.lambda_tv > 0:
            loss = loss + cfg.lambda_tv * hashgrid.total_variation_loss(
                self.field.table, cfg.grid,
                d["tv"].to(self.flat_o.device))
        return loss

    def step(self, d: dict) -> torch.Tensor:
        """One Adam step on the draws `d`; returns the loss (on the
        device, no host sync)."""
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss(d)
        loss.backward()
        self.opt.step()
        return loss.detach()

    @torch.no_grad()
    def occ_step(self, jitter: torch.Tensor) -> None:
        """The occupancy EMA, one jittered point per cell."""
        occ = self.occ
        self.occ = raymarch.update_occupancy(
            occ, lambda x: self.field.density(x)[0].reshape(occ.shape),
            self.cfg.occ_res, bound=self.cfg.bound, jitter=jitter)

    def run(self, draws: Optional[Sequence[dict]] = None,
            progress: Optional[Callable] = None) -> None:
        """`cfg.iterations` steps, the occupancy EMA after each step below
        `OCC_WARMUP` and every `occ_update_every` after; `progress(it,
        {"loss": float})` every 50 iterations (the only host syncs)."""
        for it in range(self.cfg.iterations):
            d = self.draw(it) if draws is None else draws[it]
            loss = self.step(d)
            if self.updates_occupancy(it):
                self.occ_step(d["occ"])
            if progress is not None and it % 50 == 0:
                progress(it, {"loss": float(loss)})


def fit(cameras: Camera, images, masks, cfg: NGPConfig = NGPConfig(),
        seed: int = 0, progress: Optional[Callable] = None,
        draws: Optional[Sequence[dict]] = None,
        init: Optional[NGPField] = None, device=None):
    """Fit the field to images [V, H, W, 3] and masks [V, H, W] seen by
    `cameras` [V], on `device` (default: the card). Returns (field,
    occ_values [R, R, R]).

    The field starts from `init`, else `init_params` from a generator
    seeded `seed`; the draws come from `draws[it]` (dicts as
    `NGPFit.draw` makes them), else from a generator seeded `seed + 1`."""
    run = NGPFit(cameras, images, masks, cfg, seed=seed, init=init,
                 device=device)
    run.run(draws, progress)
    return run.field, run.occ


@torch.no_grad()
def render_views(field: NGPField, cameras: Camera, cfg: NGPConfig,
                 occ_values=None, chunk_rays: int = 65536):
    """Full images of the fitted field from `cameras` (no jitter):
    dict(rgb [..., H, W, 3], alpha [..., H, W], depth [..., H, W])."""
    origins, dirs = get_rays(cameras)
    shape = origins.shape[:-1]
    o, d = origins.reshape(-1, 3), dirs.reshape(-1, 3)
    occ_grid = occ_values > cfg.occ_threshold \
        if occ_values is not None else None
    outs = {"rgb": [], "alpha": [], "depth": []}
    for i in range(0, o.shape[0], chunk_rays):
        out = raymarch.march(field.field, o[i:i + chunk_rays],
                             d[i:i + chunk_rays], occ_grid=occ_grid,
                             bound=cfg.bound, num_steps=cfg.num_steps)
        for k in outs:
            outs[k].append(out[k])
    return {k: torch.cat(vs).reshape(shape + vs[0].shape[1:])
            for k, vs in outs.items()}


def grid_points(res: int, bound: float, device) -> torch.Tensor:
    """[res³, 3] lattice over [-bound, bound]³, x-major; the axis is
    computed in float64 and rounded once, so every device has the same
    points."""
    lin = torch.as_tensor(np.linspace(-bound, bound, res).astype(np.float32),
                          device=device)
    gx, gy, gz = torch.meshgrid(lin, lin, lin, indexing="ij")
    return torch.stack([gx, gy, gz], -1).reshape(-1, 3)


@torch.no_grad()
def density_grid(field: NGPField, cfg: NGPConfig, res: int = 128,
                 chunk: int = 262144) -> torch.Tensor:
    """σ on a res³ lattice over the ±bound box, [res, res, res], on the
    field's device, queried `chunk` points at a time."""
    pts = grid_points(res, cfg.bound, field.table.device)
    vals = [field.density(pts[i:i + chunk])[0]
            for i in range(0, pts.shape[0], chunk)]
    return torch.cat(vals).reshape(res, res, res)
