"""Craftsman: multi-view images → SDF latent-set DDIM diffusion → mesh.

Port of `comfy3d_tpu/models/craftsman/pipeline.py` (upstream's
`systems/shape_diffusion.py`, `models/denoisers/simple_denoiser.py`, the
Michelangelo aligned autoencoder and `Configs/Craftsman_config.yaml`):

  * the conditioner is CLIP ViT-L/14 at 224² with a camera ModLN in every
    block (`clip.py`, `modulation_dim` 32): each view is resized bicubic
    as `jax.image.resize` does, CLIP-normalised and encoded with its
    camera's code, `encode_camera` of the fixed front / right / back / left
    orbit (`CRAFTSMAN_CAMERAS`, repeated as `np.resize` repeats it); every
    view's tokens together are one context;
  * the denoiser (`SimpleDenoiser`) runs a token stream [t | LN → Linear
    (context) | latents]: t the [sin | cos] embedding through `time_proj`
    (c_fc 4×, exact GELU, c_proj), then a UNet of attention blocks
    (`UNetDiffusionTransformer`: an encoder stack, a middle block and a
    decoder stack whose skips enter through Linear([skip, x]) and a
    LayerNorm), bias-free qkv, LayerNorm eps 1e-6 throughout;
  * sampling is DDIM over scaled-linear betas with epsilon prediction
    (`diffusion/schedulers.py`), x₀ = noise · init_sigma, the CFG pair
    [cond, zeros] and eps = e_u + g·(e_c − e_u); `scheduler_name` picks
    another registry sampler;
  * the latents go through the vecset `ShapeVAE` (the Michelangelo
    decoder's layout: 256 × 64 latents, width 768, 16 layers, bias-free
    qkv, 8 frequencies without π) and its octree decode, marching tets and
    the weld.

Module names are upstream's without their checkpoint prefixes
(`denoiser_model.`, `shape_model.` with `decoder` as `geo_decoder`,
`condition.model.vision_model.`), so `convert.load_craftsman_ckpt` strips
and loads them strictly. Each stage runs under a
`torch.profiler.record_function` span named in `CRAFTSMAN_STAGES`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ... import resolve_device
from ...core.image import resize_images
from ..clip import (CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, CLIPVisionConfig,
                    CLIPVisionEncoder)
from ..common import init_weights_, seeded_model
from ..diffusion import schedulers
from ..diffusion.schedulers import SchedulerConfig
from ..triposg.dit import _sinusoidal
from ..vecset.blocks import ResidualAttentionBlock, VecMLP
from ..vecset.vae import (ShapeVAE, ShapeVAEConfig, decode_volume_auto,
                          grid_to_mesh)

CRAFTSMAN_STAGES = ("craftsman.encode_cond", "craftsman.denoise",
                    "craftsman.vae_transformer", "craftsman.decode",
                    "craftsman.extract")


@dataclasses.dataclass(frozen=True)
class DenoiserConfig:
    input_channels: int = 64
    width: int = 768
    layers: int = 6
    heads: int = 12
    context_dim: int = 1024


class UNetDiffusionTransformer(nn.Module):
    """`encoder.{i}`, `middle_block` and `decoder.{i}` = [resblock, skip
    Linear(2w, w), skip LayerNorm] (simple_denoiser.py:15-77; the skip
    LayerNorm always, as the JAX package's default `skip_ln` has it)."""

    def __init__(self, cfg: DenoiserConfig):
        super().__init__()
        c = cfg

        def block():
            return ResidualAttentionBlock(c.width, c.heads, qkv_bias=False)

        self.encoder = nn.ModuleList([block() for _ in range(c.layers)])
        self.middle_block = block()
        self.decoder = nn.ModuleList([nn.ModuleList([
            block(), nn.Linear(2 * c.width, c.width),
            nn.LayerNorm(c.width, eps=1e-6)])
            for _ in range(c.layers)])

    def forward(self, x):
        enc = []
        for block in self.encoder:
            x = block(x)
            enc.append(x)
        x = self.middle_block(x)
        for resblock, linear, norm in self.decoder:
            x = resblock(norm(linear(torch.cat([enc.pop(), x], -1))))
        return x


class SimpleDenoiser(nn.Module):
    """simple_denoiser.py:94-188 under its names."""

    def __init__(self, cfg: DenoiserConfig = DenoiserConfig()):
        super().__init__()
        c = self.cfg = cfg
        self.time_proj = VecMLP(c.width)
        self.context_embed = nn.Sequential(
            nn.LayerNorm(c.context_dim, eps=1e-6),
            nn.Linear(c.context_dim, c.width))
        self.input_proj = nn.Linear(c.input_channels, c.width)
        self.backbone = UNetDiffusionTransformer(c)
        self.ln_post = nn.LayerNorm(c.width, eps=1e-6)
        self.output_proj = nn.Linear(c.width, c.input_channels)

    def forward(self, latents, t, context):
        """latents [B, N, C]; t [B] (DDIM timesteps); context [B, M, D] →
        eps [B, N, C]."""
        n = latents.shape[1]
        temb = self.time_proj(_sinusoidal(t, self.cfg.width))[:, None]
        x = torch.cat([temb, self.context_embed(context),
                       self.input_proj(latents)], 1)
        return self.output_proj(self.ln_post(self.backbone(x))[:, -n:])


# the fixed orbit cameras of BaseEmbedder (conditional_encoders/
# base.py:41-66): front / right / back / left c2w at distance 1
CRAFTSMAN_CAMERAS = np.array([
    [[1, 0, 0, 0], [0, 0, -1, -1], [0, 1, 0, 0], [0, 0, 0, 1]],
    [[0, 0, 1, 1], [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
    [[-1, 0, 0, 0], [0, 0, 1, 1], [0, 1, 0, 0], [0, 0, 0, 1]],
    [[0, 0, -1, -1], [-1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
], np.float32)


def encode_camera(c2ws) -> torch.Tensor:
    """The sincos camera code (base.py:74-80): c2w [V, 4, 4] → [V, 32]."""
    flat = torch.as_tensor(c2ws, dtype=torch.float32).reshape(-1, 16)
    return torch.cat([flat.sin(), flat.cos()], -1)


@dataclasses.dataclass(frozen=True)
class CraftsmanConfig:
    """The published `Craftsman_config.yaml` widths: CLIP ViT-L/14 with
    ModLN 32, the denoiser (width 768, 6 + 1 + 6 blocks, 12 heads) and the
    Michelangelo decoder (256 × 64 latents, width 768, 16 layers)."""
    denoiser: DenoiserConfig = DenoiserConfig()
    vae: ShapeVAEConfig = ShapeVAEConfig(num_latents=256, embed_dim=64,
                                         width=768, heads=12,
                                         num_decoder_layers=16,
                                         qkv_bias=False, num_freqs=8,
                                         include_pi=False, scale_factor=1.0)
    cond: CLIPVisionConfig = CLIPVisionConfig(modulation_dim=32)
    scheduler: SchedulerConfig = SchedulerConfig(
        beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear",
        prediction_type="epsilon")
    num_steps: int = 50
    guidance_scale: float = 7.5

    @classmethod
    def tiny(cls) -> "CraftsmanConfig":
        """Test-scale config (the JAX package's `tiny()`)."""
        return cls(
            denoiser=DenoiserConfig(input_channels=8, width=32,
                                    layers=1, heads=2, context_dim=32),
            vae=ShapeVAEConfig(num_latents=16, embed_dim=8, width=32,
                               heads=2, num_decoder_layers=1,
                               qkv_bias=False, num_freqs=8,
                               include_pi=False, scale_factor=1.0),
            cond=CLIPVisionConfig(hidden=32, layers=1, heads=2, mlp_dim=64,
                                  image_size=28, patch=14, projection_dim=24,
                                  modulation_dim=32),
            num_steps=3)


class Craftsman(nn.Module):
    def __init__(self, cfg: CraftsmanConfig = CraftsmanConfig()):
        super().__init__()
        self.cfg = cfg
        self.cond = CLIPVisionEncoder(cfg.cond)
        self.denoiser = SimpleDenoiser(cfg.denoiser)
        self.vae = ShapeVAE(cfg.vae)


def _init_craftsman_(model: Craftsman, gen: torch.Generator) -> None:
    """`common.init_weights_`, CLIP's class token and positions normal with
    std 0.02."""
    init_weights_(model, gen)
    emb = model.cond.embeddings
    with torch.no_grad():
        for p in (emb.class_embedding, emb.position_embedding.weight):
            p.copy_(torch.randn(p.shape, generator=gen,
                                device=gen.device) * 0.02)


def random_model(seed: int, cfg: CraftsmanConfig, device) -> Craftsman:
    """Weights drawn from `seed` on `device` (`common.seeded_model`)."""
    return seeded_model(lambda: Craftsman(cfg), _init_craftsman_, seed,
                        device)


class CraftsmanPipeline:
    def __init__(self, model: Craftsman):
        self.model = model.eval()
        self.cfg = model.cfg
        # a registry sampler's name; None: DDIM
        self.scheduler_name = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @classmethod
    def init_random(cls, seed: int = 0,
                    cfg: CraftsmanConfig = CraftsmanConfig(),
                    device=None) -> "CraftsmanPipeline":
        """Weights drawn from `seed` on `device` (default: the card)."""
        return cls(random_model(seed, cfg, resolve_device(device)))

    @classmethod
    def from_pretrained(cls, path: str, device=None,
                        **cfg_overrides) -> "CraftsmanPipeline":
        """Upstream's Lightning `.ckpt` (or the first under a directory),
        loaded strictly as float32 on `device` (default: the card)."""
        from .convert import load_craftsman_ckpt
        return cls(load_craftsman_ckpt(path, resolve_device(device),
                                       **cfg_overrides))

    def _f32(self, x) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = np.array(x, np.float32)
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def encode_cond(self, images) -> torch.Tensor:
        """images [V, H, W, 3] in [0, 1] → the context [1, V·(1 + N), D]:
        every view's CLIP tokens, each view modulated by its camera
        (clip_encoder.py:98-137, shape_diffusion.py:329-339). Views whose
        height is not the encoder's size are resized bicubic."""
        c = self.cfg.cond
        with record_function(CRAFTSMAN_STAGES[0]):
            x = self._f32(images)
            if x.dim() == 3:
                x = x[None]
            if x.shape[1] != c.image_size:
                x = resize_images(x, c.image_size, c.image_size, "bicubic")
            x = (x - self._f32(CLIP_IMAGE_MEAN)) / self._f32(CLIP_IMAGE_STD)
            mod = None
            if c.modulation_dim:
                cams = np.resize(CRAFTSMAN_CAMERAS, (x.shape[0], 4, 4))
                mod = encode_camera(cams).to(self.device)
            tokens = self.model.cond(x.permute(0, 3, 1, 2), project=False,
                                     mod_cond=mod)[0]
            return tokens.reshape(1, -1, tokens.shape[-1])

    @torch.no_grad()
    def denoise(self, cond, noise, num_steps: int, guidance_scale: float,
                scheduler_name: str = "DDIMScheduler") -> torch.Tensor:
        """`diffusion.schedulers.sample_loop` of `scheduler_name` over
        `num_steps` from `noise` [1, N, C] · init_sigma, CFG over [cond,
        zeros]; a stochastic sampler draws its noise from a generator
        seeded with 0 on the noise's device."""
        den = self.model.denoiser
        sched = schedulers.make_scheduler(scheduler_name, self.cfg.scheduler,
                                          num_steps)
        cond2 = torch.cat([cond, torch.zeros_like(cond)])

        def eps(x_in, i, t):
            e_c, e_u = den(torch.cat([x_in, x_in]),
                           torch.full((2,), float(t), device=x_in.device),
                           cond2).chunk(2)
            return e_u + guidance_scale * (e_c - e_u)

        with record_function(CRAFTSMAN_STAGES[1]):
            return schedulers.sample_loop(sched, eps,
                                          noise * sched.init_sigma)

    @torch.no_grad()
    def sample_latents(self, images, seed: int = 0,
                       num_steps: Optional[int] = None,
                       guidance_scale: Optional[float] = None,
                       draws=None) -> torch.Tensor:
        """images → latents [1, num_latents, embed_dim]. `draws` (that
        shape) is the initial noise; without it the noise is drawn from a
        CPU `torch.Generator` seeded with `seed` and moved."""
        c = self.cfg
        shape = (1, c.vae.num_latents, c.vae.embed_dim)
        if draws is None:
            draws = torch.randn(shape,
                                generator=torch.Generator().manual_seed(seed))
        noise = self._f32(draws)
        if tuple(noise.shape) != shape:
            raise ValueError(f"draws {tuple(noise.shape)}, not {shape}")
        gs = c.guidance_scale if guidance_scale is None else guidance_scale
        return self.denoise(self.encode_cond(images), noise,
                            num_steps or c.num_steps, float(gs),
                            self.scheduler_name or "DDIMScheduler")

    @torch.no_grad()
    def decode_grid(self, latents, octree_resolution: int = 256,
                    num_chunks: int = 65536) -> torch.Tensor:
        """latents [B, N, C] → occupancy logits [B, R+1, R+1, R+1]: the
        ShapeVAE's transformer, then the octree decode."""
        vae = self.model.vae
        with record_function(CRAFTSMAN_STAGES[2]):
            decoded = vae(self._f32(latents))
        with record_function(CRAFTSMAN_STAGES[3]):
            return decode_volume_auto(vae.query, decoded,
                                      octree_resolution=octree_resolution,
                                      num_chunks=num_chunks)

    def latents_to_mesh(self, latents, octree_resolution: int = 256,
                        num_chunks: int = 65536) -> List:
        """latents [B, N, C] → one host `Mesh` per sample."""
        grids = self.decode_grid(latents, octree_resolution, num_chunks)
        with record_function(CRAFTSMAN_STAGES[4]):
            return [grid_to_mesh(g) for g in grids]

    def __call__(self, images, seed: int = 0,
                 num_steps: Optional[int] = None,
                 guidance_scale: Optional[float] = None,
                 octree_resolution: int = 256, num_chunks: int = 65536,
                 draws=None) -> List:
        latents = self.sample_latents(images, seed, num_steps,
                                      guidance_scale, draws=draws)
        return self.latents_to_mesh(latents, octree_resolution, num_chunks)
