"""MVDream: text embeddings → four consistent orbit views.

Port of `comfy3d_tpu/models/mvdream/pipeline.py`'s text path (the
reference's MVDream_Model node, which feeds LGM): an SD-1.5-class UNet
with 3D self-attention across the four views (`UNetConfig.mv_views`) and a
camera embedding — each view's flattened 4×4 c2w through a small MLP —
added to the time embedding; sampling (DDIM by default, any sampler of
the registry by `scheduler_name`) with classifier-free guidance over a
batch [uncond; cond] of 2·V frames, `un + g·(co − un)`; the first V
latents decoded by the VAE.

Text conditioning is passed in as `prompt_embeds` [77, 768] (a CLIP text
encoder's output, `models/clip.py`); without it the pipeline's
`default_prompt_embeds` (the empty prompt's, set by `from_pretrained`) or
zeros, and the negative embedding likewise. `from_pretrained` reads an
mvdream-diffusers directory (`convert.load_mvdream_dir`). The model's
state dict holds `unet.*` (diffusers' `UNet2DConditionModel` names),
`vae.*` (diffusers' `AutoencoderKL`) and `camera_embed.{0,2}` (MVDream's
own camera MLP). Images leave as the node
protocol holds them, [V, S, S, 3] in [0, 1].

Not ported, each raising NotImplementedError naming its ROADMAP item:
ImageDream's image conditioning (`image=`, `cfg.ip_dim`, the Resampler,
the pinned extra frame), CRM's stage-2 `pixel_images` and T2I-Adapter
`adapter_residuals` (A.6.4).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from ...core.camera import orbit_c2w
from ..common import init_weights_, seeded_model
from ..diffusion.schedulers import (SchedulerConfig, make_scheduler,
                                    sample_loop)
from ..diffusion.unet import UNet2DCondition, UNetConfig
from ..diffusion.vae import AutoencoderKL, VAEConfig


@dataclasses.dataclass(frozen=True)
class MVDreamConfig:
    image_size: int = 256
    num_views: int = 4
    camera_elevation: float = 0.0
    camera_radius: float = 1.5
    unet: UNetConfig = dataclasses.field(
        default_factory=lambda: dataclasses.replace(UNetConfig.sd15(),
                                                    mv_views=4))
    vae: VAEConfig = VAEConfig()
    prompt_tokens: int = 77
    prompt_dim: int = 768
    camera_dim: int = 16
    # ImageDream's image-prompt tokens (not ported: > 0 raises)
    ip_dim: int = 0
    ip_weight: float = 1.0
    ip_embed_dim: int = 1280
    resampler_depth: int = 4
    resampler_heads: int = 12
    resampler_dim_head: int = 64

    @property
    def vae_factor(self) -> int:
        return 2 ** (len(self.vae.block_out_channels) - 1)


def _image_dream(what: str):
    return NotImplementedError(
        f"{what} is not ported (ROADMAP A.6.4: ImageDream, stage-2 and "
        f"T2I-Adapter conditioning)")


class CameraEmbed(nn.Sequential):
    """Flattened c2w [B, 16] → a time-embedding-sized vector: Linear, SiLU,
    Linear (MVDream's `camera_embed.{0,2}`)."""

    def __init__(self, camera_dim: int, dim: int):
        super().__init__(nn.Linear(camera_dim, dim), nn.SiLU(),
                         nn.Linear(dim, dim))


def orbit_c2w_flat(num_views: int, elevation: float, radius: float,
                   device=None) -> torch.Tensor:
    """[V, 16]: the c2w of V cameras at one elevation, azimuths i·360/V."""
    azims = torch.arange(num_views, dtype=torch.float32) \
        * (360.0 / num_views)
    c2w = orbit_c2w(torch.full((num_views,), float(elevation)), azims,
                    radius, device=device)
    return c2w.reshape(num_views, 16)


class MVDream(nn.Module):
    def __init__(self, cfg: MVDreamConfig = MVDreamConfig()):
        super().__init__()
        if cfg.ip_dim > 0:
            raise _image_dream("MVDreamConfig.ip_dim (ImageDream)")
        if cfg.unet.in_channels != 4:
            raise _image_dream("a stage-2 (in_channels 8) UNet")
        self.cfg = cfg
        self.unet = UNet2DCondition(cfg.unet)
        self.vae = AutoencoderKL(cfg.vae)
        self.camera_embed = CameraEmbed(cfg.camera_dim,
                                        cfg.unet.block_out_channels[0] * 4)


class MVDreamPipeline:
    scheduler_name = "DDIMScheduler"

    def __init__(self, model: MVDream):
        self.model = model.eval()
        self.cfg = model.cfg
        self.default_prompt_embeds: Optional[torch.Tensor] = None
        self.default_negative_embeds: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @classmethod
    def init_random(cls, seed: int = 0, cfg: MVDreamConfig = MVDreamConfig(),
                    device=None) -> "MVDreamPipeline":
        """Weights drawn from `seed` in the JAX package's scheme
        (`common.init_weights_`) on `device` (default: the card;
        `common.seeded_model`)."""
        return cls(seeded_model(lambda: MVDream(cfg), init_weights_, seed,
                                device))

    @classmethod
    def from_pretrained(cls, path: str, device=None,
                        **cfg_overrides) -> "MVDreamPipeline":
        """An ashawkey/mvdream-sd2.1-diffusers directory: the LDM-layout
        UNet renamed (`convert.mv_unet_name`) and loaded strictly with the
        camera MLP, the VAE, and the empty prompt's embedding from
        text_encoder/ as the default prompt and negative embeddings. An
        ImageDream checkpoint raises (ROADMAP A.6.4)."""
        from .convert import load_mvdream_dir
        return load_mvdream_dir(cls, path, device, **cfg_overrides)

    def camera_embedding(self, elevation: Optional[float] = None):
        """The V views' camera embeddings [V, 4·C0]."""
        cfg = self.cfg
        cams = orbit_c2w_flat(cfg.num_views, cfg.camera_elevation
                              if elevation is None else elevation,
                              cfg.camera_radius, device=self.device)
        return self.model.camera_embed(cams)

    def conditioning(self, prompt_embeds=None, negative_embeds=None,
                     elevation: Optional[float] = None):
        """The CFG batch's conditioning: (context [2·V, T, D] as [uncond;
        cond], camera embeddings [2·V, 4·C0]). Embeddings [T, D] default to
        `default_prompt_embeds` / `default_negative_embeds`, else zeros."""
        cfg = self.cfg
        dev = self.device
        v = cfg.num_views
        if prompt_embeds is None:
            prompt_embeds = self.default_prompt_embeds
        if prompt_embeds is None:
            prompt_embeds = torch.zeros(cfg.prompt_tokens, cfg.prompt_dim)
        prompt_embeds = torch.as_tensor(prompt_embeds, dtype=torch.float32,
                                        device=dev)
        if negative_embeds is None:
            negative_embeds = self.default_negative_embeds
        if negative_embeds is None:
            negative_embeds = torch.zeros_like(prompt_embeds)
        negative_embeds = torch.as_tensor(negative_embeds,
                                          dtype=torch.float32, device=dev)
        states = torch.cat([negative_embeds[None].expand(v, -1, -1),
                            prompt_embeds[None].expand(v, -1, -1)])
        cam_emb = self.camera_embedding(elevation)
        return states, torch.cat([cam_emb, cam_emb])

    def guided_eps(self, x, t, cond, guidance_scale: float):
        """One guided UNet call: the V latents `x` [V, 4, l, l] at timestep
        `t`, run as the CFG batch [x; x] under `cond` (`conditioning`'s
        pair) → un + g·(co − un)."""
        states, cam_emb2 = cond
        v = self.cfg.num_views
        tvec = torch.full((2 * v,), float(t), device=x.device)
        out = self.model.unet(torch.cat([x, x]), tvec, states,
                              class_emb=cam_emb2, mv_views=v)
        un, co = out.chunk(2)
        return un + guidance_scale * (co - un)

    def initial_latents(self, generator: Optional[torch.Generator] = None):
        """[V, 4, S/8, S/8] noise drawn with `generator` (default: seed 0)
        on the CPU and moved, so a seed gives the same noise on every
        device."""
        cfg = self.cfg
        lat = cfg.image_size // cfg.vae_factor
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return torch.randn((cfg.num_views, cfg.unet.in_channels, lat, lat),
                           generator=generator).to(self.device)

    @torch.no_grad()
    def sample_latents(self, prompt_embeds=None, negative_embeds=None,
                       num_inference_steps: int = 30,
                       guidance_scale: float = 7.0,
                       generator: Optional[torch.Generator] = None,
                       latents: Optional[torch.Tensor] = None,
                       elevation: Optional[float] = None,
                       step_noise: Optional[Callable] = None):
        """The guided sampling loop → the V denoised latents. A stochastic
        sampler's noise for step i is `step_noise(i)` ([V, 4, S/8, S/8]),
        or else drawn on the CPU with `generator` (default: seed 0) after
        the initial latents, step by step, and moved."""
        cond = self.conditioning(prompt_embeds, negative_embeds, elevation)
        sched = make_scheduler(self.scheduler_name, SchedulerConfig(),
                               num_inference_steps)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if latents is None:
            latents = self.initial_latents(generator)
        latents = torch.as_tensor(latents, dtype=torch.float32,
                                  device=self.device) * sched.init_sigma
        if step_noise is None:
            def step_noise(i):
                return torch.randn(latents.shape,
                                   generator=generator).to(latents.device)
        return sample_loop(
            sched, lambda x, i, t: self.guided_eps(x, t, cond,
                                                   guidance_scale),
            latents, noise=step_noise)

    @torch.no_grad()
    def __call__(self, prompt_embeds=None, negative_embeds=None, image=None,
                 num_inference_steps: int = 30, guidance_scale: float = 7.0,
                 generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None,
                 elevation: Optional[float] = None,
                 adapter_residuals=None, pixel_images=None,
                 step_noise: Optional[Callable] = None):
        """→ [V, S, S, 3] images in [0, 1].

        prompt_embeds / negative_embeds: [T, D] (zeros when None).
        latents: the initial noise [V, 4, S/8, S/8]; when None it is drawn
        with `generator` (`initial_latents`). step_noise: a stochastic
        sampler's noise by step (`sample_latents`)."""
        if image is not None:
            raise _image_dream("image conditioning (ImageDream)")
        if pixel_images is not None:
            raise _image_dream("pixel_images (stage 2)")
        if adapter_residuals is not None:
            raise _image_dream("adapter_residuals (T2I-Adapter)")
        latents = self.sample_latents(
            prompt_embeds, negative_embeds, num_inference_steps,
            guidance_scale, generator, latents, elevation, step_noise)
        img = self.model.vae.decode(latents)
        return torch.clamp(img * 0.5 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)
