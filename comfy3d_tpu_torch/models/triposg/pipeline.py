"""TripoSG: image → mesh by rectified-flow latent-set diffusion.

Port of `comfy3d_tpu/models/triposg/pipeline.py` (upstream's
`pipeline_triposg.py`):
  * DINOv2-large conditioning at 518² (`models/dinov2.py`), the image
    resized as `jax.image.resize(..., "bilinear")` does; the unconditional
    tokens are zeros of the conditional ones, the CFG pair [cond, uncond];
  * the DiT (`dit.py`) over the rectified-flow schedule: σ from a float64
    linspace(1, 0), shifted by s·σ / (1 + (s − 1)·σ) and cast to float32
    once, t = 1000·σ, x ← x + (σ_next − σ)·v, v = v_u + g·(v_c − v_u);
    a CFG-distilled model (the scribble model, `distilled=True`) runs the
    conditional pass alone, where the JAX package blends at g = 0 and so
    returns the velocity of the zero tokens (ROADMAP §C.10);
  * the VAE (`vae.py`): 1/scale_factor, the decoder's kv cache, the octree
    SDF decode (`models/vecset/vae.py::decode_volume_auto`: at the node's
    256, a 64³ grid refined twice), marching tets and the weld.

The model's state dict holds `cond.*` (`transformers.Dinov2Model` names),
`dit.*` and `vae.*` (upstream's names). Each stage runs under a
`torch.profiler.record_function` span named in `TRIPOSG_STAGES`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ... import resolve_device
from ...core.image import resize_images
from ..common import init_weights_, seeded_model
from ..dinov2 import (IMAGENET_MEAN, IMAGENET_STD, Dinov2, Dinov2Config,
                      init_dinov2_)
from ..vecset.vae import decode_volume_auto, grid_to_mesh
from .dit import RMSNorm, TripoSGDiT, TripoSGDiTConfig
from .vae import TripoSGVAE, TripoSGVAEConfig

TRIPOSG_STAGES = ("triposg.encode_cond", "triposg.denoise",
                  "triposg.vae_decoder", "triposg.decode", "triposg.extract")


@dataclasses.dataclass(frozen=True)
class TripoSGConfig:
    dit: TripoSGDiTConfig = TripoSGDiTConfig()
    vae: TripoSGVAEConfig = TripoSGVAEConfig()
    cond: Dinov2Config = Dinov2Config(hidden=1024, layers=24, heads=16)
    image_size: int = 518
    num_steps: int = 50
    guidance_scale: float = 7.0
    shift: float = 1.0

    @classmethod
    def tiny(cls) -> "TripoSGConfig":
        """Test-scale config (the JAX package's `tiny()`)."""
        return cls(
            dit=TripoSGDiTConfig(width=32, in_channels=8, num_layers=3,
                                 heads=2, cross_attention_dim=32),
            vae=TripoSGVAEConfig(latent_channels=8, num_latents=16,
                                 heads=2, width_encoder=16,
                                 width_decoder=32, num_layers_encoder=1,
                                 num_layers_decoder=1),
            cond=Dinov2Config(hidden=32, layers=1, heads=2, patch=14,
                              pretrain_image_size=28),
            image_size=28, num_steps=3)


class TripoSG(nn.Module):
    def __init__(self, cfg: TripoSGConfig = TripoSGConfig()):
        super().__init__()
        self.cfg = cfg
        self.cond = Dinov2(cfg.cond)
        self.dit = TripoSGDiT(cfg.dit)
        self.vae = TripoSGVAE(cfg.vae)


def _init_triposg_(model: TripoSG, gen: torch.Generator) -> None:
    """`common.init_weights_`, `dinov2.init_dinov2_` and the RMS scales 1."""
    init_weights_(model, gen)
    init_dinov2_(model.cond, gen)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)


def random_model(seed: int, cfg: TripoSGConfig, device) -> TripoSG:
    """Weights drawn from `seed` on `device` (`common.seeded_model`)."""
    return seeded_model(lambda: TripoSG(cfg), _init_triposg_, seed, device)


def flow_sigmas(num_steps: int, shift: float) -> np.ndarray:
    """The float32 σ schedule, 1 → 0 in `num_steps` steps."""
    s = np.linspace(1.0, 0.0, num_steps + 1)
    return (shift * s / (1.0 + (shift - 1.0) * s)).astype(np.float32)


class TripoSGPipeline:
    def __init__(self, model: TripoSG):
        self.model = model.eval()
        self.cfg = model.cfg
        # the scribble factory's CFG-distilled model: the conditional pass
        # alone (ROADMAP §C.10)
        self.is_scribble = False

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @classmethod
    def init_random(cls, seed: int = 0,
                    cfg: TripoSGConfig = TripoSGConfig(),
                    device=None) -> "TripoSGPipeline":
        """Weights drawn from `seed` on `device` (default: the card)."""
        return cls(random_model(seed, cfg, resolve_device(device)))

    @classmethod
    def from_pretrained(cls, path: str, device=None,
                        **cfg_overrides) -> "TripoSGPipeline":
        """Upstream's directory (`transformer/`, `vae/` and optionally
        `image_encoder_dinov2/`, each with its config.json), loaded strictly
        as float32 on `device` (default: the card)."""
        from .convert import load_triposg_dir
        return cls(load_triposg_dir(path, resolve_device(device),
                                    **cfg_overrides))

    def _f32(self, x) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = np.array(x, np.float32)
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def encode_cond(self, image) -> torch.Tensor:
        """image [B, H, W, 3] or [H, W, 3] in [0, 1] → DINOv2 tokens
        [2B, 1 + N, C]: the conditional half, then zeros."""
        c = self.cfg
        with record_function(TRIPOSG_STAGES[0]):
            x = self._f32(image)
            if x.dim() == 3:
                x = x[None]
            s = c.image_size
            if tuple(x.shape[1:3]) != (s, s):
                x = resize_images(x, s, s)
            x = (x - self._f32(IMAGENET_MEAN)) / self._f32(IMAGENET_STD)
            cond = self.model.cond(x.permute(0, 3, 1, 2))
            return torch.cat([cond, torch.zeros_like(cond)])

    @torch.no_grad()
    def denoise(self, cond, noise, guidance_scale: float, num_steps: int,
                distilled: bool = False) -> torch.Tensor:
        """The Euler loop over `flow_sigmas(num_steps, shift)` from `noise`
        [B, N, C]: with CFG over the [cond, uncond] tokens `cond` [2B, …],
        or, `distilled`, the conditional pass alone."""
        dit = self.model.dit
        sig = flow_sigmas(num_steps, self.cfg.shift)
        x = noise
        b = x.shape[0]
        with record_function(TRIPOSG_STAGES[1]):
            for i in range(num_steps):
                t = float(np.float32(1000.0) * sig[i])
                if distilled:
                    v = dit(x, torch.full((b,), t, device=x.device),
                            cond[:b])
                else:
                    v_c, v_u = dit(torch.cat([x, x]),
                                   torch.full((2 * b,), t, device=x.device),
                                   cond).chunk(2)
                    v = v_u + guidance_scale * (v_c - v_u)
                x = x + float(sig[i + 1] - sig[i]) * v
        return x

    @torch.no_grad()
    def sample_latents(self, image, seed: int = 0,
                       num_steps: Optional[int] = None,
                       guidance_scale: Optional[float] = None,
                       draws=None, distilled: Optional[bool] = None
                       ) -> torch.Tensor:
        """image → latents [B, num_latents, latent_channels]. `draws` (that
        shape) is the initial noise; without it the noise is drawn from a
        CPU `torch.Generator` seeded with `seed` and moved, so a seed gives
        the same latents on every device. `distilled` (default
        `is_scribble`) runs the conditional pass alone and reads no
        guidance scale."""
        c = self.cfg
        cond = self.encode_cond(image)
        b = cond.shape[0] // 2
        shape = (b, c.vae.num_latents, c.vae.latent_channels)
        if draws is None:
            draws = torch.randn(shape,
                                generator=torch.Generator().manual_seed(seed))
        noise = self._f32(draws)
        if tuple(noise.shape) != shape:
            raise ValueError(f"draws {tuple(noise.shape)}, not {shape}")
        gs = c.guidance_scale if guidance_scale is None else guidance_scale
        return self.denoise(cond, noise, float(gs), num_steps or c.num_steps,
                            self.is_scribble if distilled is None
                            else distilled)

    @torch.no_grad()
    def decode_grid(self, latents, octree_resolution: int = 256,
                    bounds: float = 1.005,
                    num_chunks: int = 65536) -> torch.Tensor:
        """latents [B, N, C] → SDF logits [B, R+1, R+1, R+1]: the latents
        over scale_factor, the VAE's decoder, the octree decode."""
        vae = self.model.vae
        with record_function(TRIPOSG_STAGES[2]):
            decoded = vae(self._f32(latents) / self.cfg.vae.scale_factor)
        with record_function(TRIPOSG_STAGES[3]):
            return decode_volume_auto(vae.query, decoded,
                                      octree_resolution=octree_resolution,
                                      bounds=bounds, num_chunks=num_chunks)

    def latents_to_mesh(self, latents, octree_resolution: int = 256,
                        bounds: float = 1.005,
                        num_chunks: int = 65536) -> list:
        """latents [B, N, C] → one host `Mesh` per sample."""
        grids = self.decode_grid(latents, octree_resolution, bounds,
                                 num_chunks)
        with record_function(TRIPOSG_STAGES[4]):
            return [grid_to_mesh(g, bounds=bounds) for g in grids]

    def __call__(self, image, seed: int = 0,
                 num_steps: Optional[int] = None,
                 guidance_scale: Optional[float] = None,
                 octree_resolution: int = 256, num_chunks: int = 65536,
                 draws=None, distilled: Optional[bool] = None) -> list:
        latents = self.sample_latents(image, seed, num_steps, guidance_scale,
                                      draws=draws, distilled=distilled)
        return self.latents_to_mesh(latents, octree_resolution,
                                    num_chunks=num_chunks)
