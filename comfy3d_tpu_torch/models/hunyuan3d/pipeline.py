"""Hunyuan3D-2.1 shape generation: image → latent set → occupancy grid →
mesh.

Port of `comfy3d_tpu/models/hunyuan3d/pipeline.py`:
  * DINOv2-giant conditioning at 224² (`models/dinov2.py`); the
    unconditional embedding is zeros of the encoder's output, not the
    encoding of a blank image, and the CFG pair is [cond, uncond];
  * the flow-matching DiT (`models/vecset/dit.py`) over the Euler schedule
    of `models/vecset/scheduler.py`, a Python loop over the sigmas; the
    guidance-distilled (-turbo) models take the guidance scale as an
    embedding and run no CFG batch;
  * the ShapeVAE (`models/vecset/vae.py`): 1/scale_factor, the latent-set
    transformer, the octree occupancy decode (`decode_volume_auto`: at the
    node's octree 256, a 64³ grid refined twice), marching tets and the
    weld.

The model's state dict holds `cond.*` (`transformers.Dinov2Model` names),
`dit.*` and `vae.*` (upstream `hy3dgen` names). Each stage runs under a
`torch.profiler.record_function` span named in `SHAPE_STAGES` (the decode's
levels under `vae.DECODE_SPANS`'s), so a profile of one call splits its
time.
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
from ..loader import load_state_dict
from ..vecset import (DiTConfig, Hunyuan3DDiT, ShapeVAE, ShapeVAEConfig,
                      flow_match_sigmas)
from ..vecset.vae import decode_volume_auto, grid_to_mesh

SHAPE_STAGES = ("hunyuan3d.encode_cond", "hunyuan3d.denoise",
                "hunyuan3d.vae_transformer", "hunyuan3d.decode",
                "hunyuan3d.extract")


@dataclasses.dataclass(frozen=True)
class Hunyuan3DShapeConfig:
    dit: DiTConfig = DiTConfig()
    vae: ShapeVAEConfig = ShapeVAEConfig()
    cond: Dinov2Config = Dinov2Config(hidden=1536, layers=40, heads=24,
                                      use_swiglu=True)   # dinov2-giant
    image_size: int = 224
    guidance_scale: float = 5.0
    num_steps: int = 30
    shift: float = 1.0

    @classmethod
    def tiny(cls) -> "Hunyuan3DShapeConfig":
        """Test-scale config (the JAX package's `tiny()`)."""
        return cls(
            dit=DiTConfig(in_channels=8, context_in_dim=32, hidden_size=64,
                          num_heads=4, depth=1, depth_single_blocks=2),
            vae=ShapeVAEConfig(num_latents=16, embed_dim=8, width=64,
                               heads=4, num_decoder_layers=1),
            cond=Dinov2Config(hidden=32, layers=1, heads=2, patch=14,
                              pretrain_image_size=28),
            image_size=28, num_steps=4)


class Hunyuan3DShape(nn.Module):
    def __init__(self, cfg: Hunyuan3DShapeConfig = Hunyuan3DShapeConfig()):
        super().__init__()
        self.cfg = cfg
        self.cond = Dinov2(cfg.cond)
        self.dit = Hunyuan3DDiT(cfg.dit)
        self.vae = ShapeVAE(cfg.vae)


def _init_shape_(model: Hunyuan3DShape, gen: torch.Generator) -> None:
    """`common.init_weights_` for the linear, conv and norm layers,
    `dinov2.init_dinov2_` for DINOv2's tokens and LayerScale, the DiT's RMS
    scales 1."""
    init_weights_(model, gen)
    init_dinov2_(model.cond, gen)
    with torch.no_grad():
        for name, p in model.dit.named_parameters():
            if name.endswith("_norm.scale"):
                p.fill_(1.0)


def _random_model(seed: int, cfg: Hunyuan3DShapeConfig,
                  device) -> Hunyuan3DShape:
    """Weights drawn from `seed` on `device` (`_init_shape_`;
    `common.seeded_model`)."""
    return seeded_model(lambda: Hunyuan3DShape(cfg), _init_shape_, seed,
                        device)


class Hunyuan3DShapePipeline:
    def __init__(self, model: Hunyuan3DShape):
        self.model = model.eval()
        self.cfg = model.cfg

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # -------------------------------------------------------------- #
    @classmethod
    def init_random(cls, seed: int = 0,
                    cfg: Hunyuan3DShapeConfig = Hunyuan3DShapeConfig(),
                    device=None) -> "Hunyuan3DShapePipeline":
        """Weights drawn from `seed` on `device` (default: the card)."""
        return cls(_random_model(seed, cfg, resolve_device(device)))

    @classmethod
    def from_pretrained(cls, dit_path: str, vae_path: str,
                        cond_path: Optional[str] = None,
                        cfg: Hunyuan3DShapeConfig = Hunyuan3DShapeConfig(),
                        device=None) -> "Hunyuan3DShapePipeline":
        """The public checkpoints (`model.fp16.safetensors` of the DiT and
        of the VAE, in upstream names; optionally a DINOv2 in
        `transformers.Dinov2Model` names), each loaded strictly as float32;
        without `cond_path` the conditioner keeps weights drawn from seed 0
        on `device` (default: the card)."""
        model = _random_model(0, cfg, resolve_device(device))
        parts = [(model.dit, dit_path), (model.vae, vae_path)]
        if cond_path:
            parts.append((model.cond, cond_path))
        for module, path in parts:
            module.load_state_dict(load_state_dict(path), strict=True)
        return cls(model)

    # -------------------------------------------------------------- #
    def _f32(self, x) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = np.array(x, np.float32)
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def encode_cond(self, image) -> torch.Tensor:
        """image [B, H, W, 3] or [H, W, 3] in [0, 1] → DINOv2 tokens
        [2B, 1 + N, C]: the conditional half, then zeros (the distilled
        model: [B, 1 + N, C], no CFG batch). Other sizes are resized to
        `image_size` as `jax.image.resize(..., "bilinear")` does
        (antialiased when it shrinks)."""
        c = self.cfg
        with record_function(SHAPE_STAGES[0]):
            x = self._f32(image)
            if x.dim() == 3:
                x = x[None]
            s = c.image_size
            if tuple(x.shape[1:3]) != (s, s):
                x = resize_images(x, s, s)
            x = (x - self._f32(IMAGENET_MEAN)) / self._f32(IMAGENET_STD)
            cond = self.model.cond(x.permute(0, 3, 1, 2))
            if c.dit.guidance_embed:
                return cond
            return torch.cat([cond, torch.zeros_like(cond)])

    @torch.no_grad()
    def denoise(self, cond, noise, guidance_scale: float,
                num_steps: int) -> torch.Tensor:
        """The Euler loop over `flow_match_sigmas(num_steps, shift)` from
        `noise` [B, N, E] (σ = 0) → latents (σ = 1)."""
        dit = self.model.dit
        sigmas = flow_match_sigmas(num_steps, self.cfg.shift)
        x = noise
        with record_function(SHAPE_STAGES[1]):
            for i in range(num_steps):
                if self.cfg.dit.guidance_embed:
                    b = x.shape[0]
                    t = torch.full((b,), float(sigmas[i]), device=x.device)
                    g = torch.full((b,), float(guidance_scale),
                                   device=x.device)
                    v = dit(x, t, cond, guidance=g)
                else:
                    t = torch.full((2 * x.shape[0],), float(sigmas[i]),
                                   device=x.device)
                    v_cond, v_uncond = dit(torch.cat([x, x]), t,
                                           cond).chunk(2)
                    v = v_uncond + guidance_scale * (v_cond - v_uncond)
                x = x + float(sigmas[i + 1] - sigmas[i]) * v
        return x

    @torch.no_grad()
    def sample_latents(self, image, seed: int = 0,
                       num_steps: Optional[int] = None,
                       guidance_scale: Optional[float] = None,
                       noise=None) -> torch.Tensor:
        """image → latents [B, num_latents, embed_dim]. `noise` (that
        shape) is the initial sample; without it the noise is drawn from a
        CPU `torch.Generator` seeded with `seed` and moved, so a seed gives
        the same latents on every device."""
        c = self.cfg
        cond = self.encode_cond(image)
        b = cond.shape[0] if c.dit.guidance_embed else cond.shape[0] // 2
        shape = (b, c.vae.num_latents, c.vae.embed_dim)
        if noise is None:
            noise = torch.randn(shape,
                                generator=torch.Generator().manual_seed(seed))
        noise = self._f32(noise)
        if tuple(noise.shape) != shape:
            raise ValueError(f"noise {tuple(noise.shape)}, not {shape}")
        gs = c.guidance_scale if guidance_scale is None else guidance_scale
        return self.denoise(cond, noise, float(gs), num_steps or c.num_steps)

    @torch.no_grad()
    def decode_grid(self, latents, octree_resolution: int = 256,
                    bounds: float = 1.01,
                    num_chunks: int = 65536) -> torch.Tensor:
        """latents [B, N, E] → occupancy logits [B, R+1, R+1, R+1]: the
        latents over scale_factor, the VAE's transformer, the octree
        decode."""
        vae = self.model.vae
        with record_function(SHAPE_STAGES[2]):
            decoded = vae(self._f32(latents) / self.cfg.vae.scale_factor)
        with record_function(SHAPE_STAGES[3]):
            return decode_volume_auto(vae.query, decoded,
                                      octree_resolution=octree_resolution,
                                      bounds=bounds, num_chunks=num_chunks)

    def latents_to_mesh(self, latents, octree_resolution: int = 256,
                        bounds: float = 1.01, mc_level: float = 0.0,
                        num_chunks: int = 65536) -> list:
        """latents [B, N, E] → one host `Mesh` per sample."""
        grids = self.decode_grid(latents, octree_resolution, bounds,
                                 num_chunks)
        with record_function(SHAPE_STAGES[4]):
            return [grid_to_mesh(g, bounds=bounds, mc_level=mc_level)
                    for g in grids]

    def __call__(self, image, seed: int = 0,
                 num_steps: Optional[int] = None,
                 guidance_scale: Optional[float] = None,
                 octree_resolution: int = 256,
                 num_chunks: int = 65536) -> list:
        latents = self.sample_latents(image, seed, num_steps, guidance_scale)
        return self.latents_to_mesh(latents,
                                    octree_resolution=octree_resolution,
                                    num_chunks=num_chunks)
