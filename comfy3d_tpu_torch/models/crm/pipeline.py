"""CRM, the convolutional reconstruction model: six views and their
canonical coordinate maps → a coloured mesh.

Port of `comfy3d_tpu/models/crm/pipeline.py` (`CRM/model/crm/model.py:
23-160`, `model/crm/sampler.py:116-186`). The six RGB views and six CCMs
(flipped BGR → RGB) are rolled out into a 256×768 two-row triplane strip
(`rollout_strip`, upstream's `get_tri(..., blender=True)`; the CCM copy
with its off-plane channels zeroed), 12 channels deep, lightly noised at
t = 20 with the SD-2.1 DDIM schedule (`ddim_add_noise`; the noise a numpy
`default_rng(seed)` draw × 0.5 + 0.5, on the host, as the JAX package
draws it), completed by a learned 20-channel plane and refined by a
`UNet2DModel` into 32-channel planes (xy, yz, zx side by side). A point's
feature is the sum of its three bilinear plane samples
(`grid_sample_border_ac`); the SDF MLP (with the sphere offset
`+ 0.5 − ‖x‖`), the colour MLP and the cube-weight MLP read it. The SDF is
queried on the `linspace(-1, 1, 81)³` grid in chunks of 262,144 points and
extracted by the port's marching tets (`ops/tetra.py::extract_isosurface`);
the colours are queried at the mesh's vertices. Each stage of `__call__`
runs under a `record_function` span of `CRM_STAGES`.

`CRMModel`'s submodules carry `CRM.pth`'s own names (`unet2.unet.*`,
`unet2.learned_plane` [1, 20, P, 3P], `sdfMlp.fc{1,2,3}`,
`rgbMlp.fc{1,2,3}`, `weightMlp.{0,2}`); planes are [C, P, 3P].
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ...core.image import resize_images
from ...ops import tetra
from ..common import init_weights_, seeded_model
from .unet2d import UNet2DModel, UNet2DModelConfig

CRM_STAGES = ("crm.forward", "crm.query", "crm.extract", "crm.colors")
QUERY_CHUNK = 262144


@dataclasses.dataclass(frozen=True)
class CRMConfig:
    view_size: int = 256
    plane_resolution: int = 256
    c_dim: int = 32
    mlp_hidden: int = 512
    tet_grid_size: int = 80
    # specs_objaverse_total.json Input.scale / Pretrain.radius
    scale: float = 0.95
    sphere_radius: float = 0.5
    noise_t: int = 20
    unet: UNet2DModelConfig = UNet2DModelConfig.crm()

    @classmethod
    def tiny(cls) -> "CRMConfig":
        return cls(view_size=32, plane_resolution=32, c_dim=8,
                   mlp_hidden=16, tet_grid_size=12,
                   unet=UNet2DModelConfig.tiny())


def grid_sample_border_ac(plane, uv):
    """Bilinear samples of plane [C, H, W] at uv [N, 2] in [-1, 1] (x along
    W, y along H), corners aligned, clamped at the border → [N, C]: torch's
    `grid_sample(align_corners=True, padding_mode="border")`, TetTexNet's
    sampling (shape_texture_net.py:58)."""
    out = F.grid_sample(plane[None], uv[None, None], mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out[0, :, 0].t()


def _rot90(img, k):
    """torch.rot90(dims=[1, 2]) on [H, W, C]."""
    return np.rot90(img, k=k, axes=(0, 1))


def rollout_strip(views: np.ndarray, fix: bool = False) -> np.ndarray:
    """`get_tri(..., blender=True, scale=1)` (util/utils.py:157-193) on the
    views re-ordered as `sampler.py:124-130` does (the 6th first): views
    [6, H, W, 3] → a strip [H, 3W, 6], two rows of three tiles stacked on
    the channel axis. `fix` zeroes each tile's off-plane CCM channels."""
    v = [np.asarray(views[i], np.float32) for i in (5, 0, 1, 2, 3, 4)]
    t0 = _rot90(v[2], 2)
    t1 = v[4][::-1, ::-1]
    t2 = _rot90(_rot90(v[0], 3)[:, ::-1], 2)
    t3 = _rot90(_rot90(v[5], 2)[:, ::-1], 2)
    t4 = _rot90(v[1], 2)[:, ::-1]
    t5 = _rot90(v[3], 1)[::-1, ::-1]
    if fix:
        t0, t1, t2, t3, t4, t5 = (t.copy() for t in (t0, t1, t2, t3, t4, t5))
        for t, keep in ((t0, 0), (t3, 0), (t1, 2), (t4, 2), (t2, 1),
                        (t5, 1)):
            t[..., [c for c in range(3) if c != keep]] = 0
    row1 = np.concatenate([t0, t1, t2], axis=1)
    row2 = np.concatenate([t3, t4, t5], axis=1)
    return np.concatenate([row1, row2], axis=-1)


def ddim_add_noise(x, noise, t: int, num_train_timesteps: int = 1000,
                   beta_start: float = 0.00085, beta_end: float = 0.012):
    """stabilityai/stable-diffusion-2-1-base's DDIMScheduler.add_noise
    (scaled-linear betas, ᾱ in float64): sampler.py:145-149's light
    perturbation at t = 20."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                        num_train_timesteps, dtype=np.float64) ** 2
    acp = float(np.cumprod(1.0 - betas)[t])
    return np.sqrt(acp) * x + np.sqrt(1.0 - acp) * noise


class _MLP3(nn.Module):
    """fc1 → ReLU → fc2 → ReLU → fc3."""

    def __init__(self, dim_in: int, hidden: int, dim_out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim_in, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.fc3 = nn.Linear(hidden, dim_out)

    def forward(self, x):
        return self.fc3(F.relu(self.fc2(F.relu(self.fc1(x)))))


class UNetPP(nn.Module):
    """`CRM/model/archs/unet.py::UNetPP`: the strip [B, 12, P, 3P] with the
    learned plane concatenated (its `in_channels` − 12 channels) → the
    `UNet2DModel`, whose input is never narrower than the strip."""

    def __init__(self, cfg: CRMConfig):
        super().__init__()
        self.unet = UNet2DModel(dataclasses.replace(
            cfg.unet, in_channels=max(cfg.unet.in_channels, 12)))
        p = cfg.plane_resolution
        self.learned_plane = (nn.Parameter(torch.zeros(
            1, cfg.unet.in_channels - 12, p, 3 * p))
            if cfg.unet.in_channels > 12 else None)

    def forward(self, strip, t):
        if self.learned_plane is not None:
            strip = torch.cat([strip, self.learned_plane.expand(
                strip.shape[0], -1, -1, -1)], 1)
        return self.unet(strip, t)


class CRMModel(nn.Module):
    def __init__(self, cfg: CRMConfig = CRMConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.unet2 = UNetPP(c)
        self.sdfMlp = _MLP3(c.c_dim, c.mlp_hidden, 4)      # sdf, deform(3)
        self.rgbMlp = _MLP3(c.c_dim, c.mlp_hidden, 3)
        self.weightMlp = nn.Sequential(nn.Linear(8 * c.c_dim, c.mlp_hidden),
                                       nn.SiLU(),
                                       nn.Linear(c.mlp_hidden, 21))

    def forward(self, strip, t):
        """strip [B, 12, P, 3P] (rgb + ccm) → planes [B, c_dim, P, 3P]."""
        return self.unet2(strip, t)

    def query_feat(self, planes, pts):
        """TetTexNet (shape_texture_net.py:14-36): planes [C, P, 3P], pts
        [N, 3] → the three planes' samples summed [N, C]."""
        p = self.cfg.plane_resolution
        f = grid_sample_border_ac(planes[..., :p], pts[:, [0, 1]])
        f = f + grid_sample_border_ac(planes[..., p:2 * p], pts[:, [1, 2]])
        return f + grid_sample_border_ac(planes[..., 2 * p:], pts[:, [2, 0]])

    def query(self, planes, pts):
        """→ (sdf [N] with the sphere offset (model.py:66,93), deform [N, 3]
        with the flexicubes scaling (util/renderer.py:23-25), rgb [N, 3] in
        about [-1, 1])."""
        c = self.cfg
        feat = self.query_feat(planes, pts)
        sd = self.sdfMlp(feat)
        sdf = sd[:, 0] + c.sphere_radius - torch.linalg.vector_norm(pts,
                                                                     dim=-1)
        deform = torch.tanh(sd[:, 1:]) / c.tet_grid_size \
            * (c.scale / 0.95) * 0.5
        return sdf, deform, self.rgbMlp(feat)

    def cube_weights(self, corner_feats):
        """corner_feats [M, 8·C] → the 21 flexicubes weights [M, 21] · 0.1."""
        return self.weightMlp(corner_feats) * 0.1


def init_crm_(model: CRMModel, generator: torch.Generator) -> None:
    """`init_weights_`, and the learned plane zero, as the JAX package's
    init leaves it."""
    init_weights_(model, generator)
    if model.unet2.learned_plane is not None:
        with torch.no_grad():
            model.unet2.learned_plane.zero_()


def grid_points(res: int, device=None) -> torch.Tensor:
    """The `linspace(-1, 1, res)³` lattice, [res³, 3] in ij order."""
    lin = torch.as_tensor(np.linspace(-1.0, 1.0, res, dtype=np.float32),
                          device=device)
    return torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"),
                       -1).reshape(-1, 3)


class CRMReconPipeline:
    def __init__(self, model: CRMModel):
        self.model = model.eval()
        self.cfg = model.cfg

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @classmethod
    def init_random(cls, seed: int = 0, cfg: Optional[CRMConfig] = None,
                    device=None) -> "CRMReconPipeline":
        """Weights drawn from `seed` (`init_crm_`) on `device` (default: the
        card)."""
        cfg = cfg or CRMConfig()
        return cls(seeded_model(lambda: CRMModel(cfg), init_crm_, seed,
                                device))

    @classmethod
    def from_pretrained(cls, ckpt_path: str, cfg: Optional[CRMConfig] = None,
                        device=None) -> "CRMReconPipeline":
        """The public `CRM.pth` (reference nodes.py:2341-2380), loaded
        strictly by its own names (`convert.crm_state_dict`)."""
        from ..diffusion.config import load_module
        from ..loader import load_state_dict
        from .convert import crm_state_dict
        cfg = cfg or CRMConfig()
        sd = crm_state_dict(load_state_dict(ckpt_path))
        return cls(load_module(lambda: CRMModel(cfg), sd, device))

    def make_strip(self, images, ccms, seed: int = 123):
        """images, ccms [6, S, S, 3] in [0, 1] → the noised strip
        [P, 3P, 12] (numpy float32): rolled out, resized to the plane
        resolution, and perturbed at t = `noise_t` with `default_rng(seed)`'s
        standard normals × 0.5 + 0.5."""
        c = self.cfg
        imgs = torch.as_tensor(images, dtype=torch.float32).cpu()
        xyz = torch.as_tensor(ccms, dtype=torch.float32).cpu().flip(-1)
        if imgs.shape[1] != c.view_size:
            imgs = resize_images(imgs, c.view_size, c.view_size)
            xyz = resize_images(xyz, c.view_size, c.view_size)
        strip = np.concatenate([rollout_strip(imgs.numpy()),
                                rollout_strip(xyz.numpy(), fix=True)], -1)
        p = c.plane_resolution
        if strip.shape[0] != p:
            strip = resize_images(torch.as_tensor(strip)[None], p,
                                  3 * p)[0].numpy()
        noise = (np.random.default_rng(seed).standard_normal(strip.shape)
                 .astype(np.float32) * 0.5 + 0.5)
        return ddim_add_noise(strip, noise, c.noise_t).astype(np.float32)

    @torch.no_grad()
    def planes(self, strip):
        """The noised strip [P, 3P, 12] → the refined planes [C, P, 3P]."""
        x = torch.as_tensor(strip, device=self.device).permute(2, 0, 1)[None]
        return self.model(x, float(self.cfg.noise_t))[0]

    @torch.no_grad()
    def sdf_grid(self, planes):
        """The SDF on the `linspace(-1, 1, tet_grid_size + 1)³` lattice,
        queried in chunks of `QUERY_CHUNK` points → [R, R, R]."""
        res = self.cfg.tet_grid_size + 1
        pts = grid_points(res, planes.device)
        return torch.cat([self.model.query(planes, pts[i:i + QUERY_CHUNK])[0]
                          for i in range(0, len(pts), QUERY_CHUNK)]
                         ).reshape(res, res, res)

    @torch.no_grad()
    def vertex_colors(self, planes, v):
        """The colour MLP at the vertices v [N, 3] (host array), mapped from
        [-1, 1] to [0, 1] and clipped (model.py:101-103) → [N, 3] numpy."""
        pts = torch.as_tensor(np.asarray(v, np.float32), device=planes.device)
        rgb = torch.cat([self.model.query(planes, pts[i:i + QUERY_CHUNK])[2]
                         for i in range(0, len(pts), QUERY_CHUNK)])
        return torch.clamp(rgb * 0.5 + 0.5, 0.0, 1.0).cpu().numpy()

    @torch.no_grad()
    def __call__(self, images, ccms, with_color: bool = True,
                 seed: int = 123):
        """images, ccms [6, S, S, 3] in [0, 1] (tensors or arrays) → a host
        `Mesh` with vertex colours."""
        forward, query, extract, colors = CRM_STAGES
        with record_function(forward):
            planes = self.planes(self.make_strip(images, ccms, seed))
        with record_function(query):
            grid = self.sdf_grid(planes)
        with record_function(extract):
            mesh = tetra.extract_isosurface(grid, iso=0.0, bounds=(-1.0, 1.0))
        if with_color and mesh.num_vertices:
            with record_function(colors):
                mesh.vc = self.vertex_colors(planes, mesh.v)
        return mesh.auto_normal()
