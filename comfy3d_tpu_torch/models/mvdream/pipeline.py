"""MVDream / ImageDream: text (or an image) embeddings → consistent orbit
views.

Port of `comfy3d_tpu/models/mvdream/pipeline.py` (the reference's
MVDream_Model node, which feeds LGM, and CRM's two 6-view samplers): an
SD-class UNet with 3D self-attention across the views
(`UNetConfig.mv_views`) and a camera embedding — each view's flattened 4×4
c2w through a small MLP — added to the time embedding; sampling (DDIM by
default, any sampler of the registry by `scheduler_name`) with
classifier-free guidance over a batch [uncond; cond] of 2·F frames,
`un + g·(co − un)`; the first V latents decoded by the VAE.

Text conditioning is passed in as `prompt_embeds` [T, D] (a CLIP text
encoder's output, `models/clip.py`); without it the pipeline's
`default_prompt_embeds` (the empty prompt's, set by the loaders) or zeros,
and the negative embedding likewise.

ImageDream (`cfg.ip_dim` > 0, `image=`): the image's CLIP penultimate
hidden states (the `vision_encoder` hook, `set_vision_encoder`; zeros
without one) go through the `Resampler` to `ip_dim` tokens appended to the
context of every frame (the uncond half takes the Resampler's output on
zeros of the same shape), and the image's VAE latent is pinned as an extra
(V+1)-th frame: before every UNet call it is written at that frame's slot
of the cond half (zeros in the uncond half), with the camera embedding of
a zero c2w, while the scheduler steps all V+1 latents. CRM's stage 2
(`pixel_images=`, a UNet of 8 input channels): the pixel views' VAE
latents are concatenated to each step's input as 4 more channels (zeros in
the uncond half), and no frame is pinned. T2I-Adapter (`adapter_residuals`,
one feature map per down block) conditions both halves.

The model's state dict holds `unet.*` (diffusers' `UNet2DConditionModel`
names), `vae.*` (diffusers' `AutoencoderKL`), `camera_embed.{0,2}`
(MVDream's own camera MLP) and, for ImageDream, `image_embed.*` (the
Resampler in the checkpoint's own names). Images leave as the node
protocol holds them, [V, S, S, 3] in [0, 1].
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from ...core.camera import orbit_c2w
from ...core.image import resize_images
from ..common import _attend, init_weights_, seeded_model
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
    # ImageDream: ip_dim image-prompt tokens from a Resampler over CLIP's
    # penultimate hidden states (ip_embed_dim wide)
    ip_dim: int = 0
    ip_weight: float = 1.0
    ip_embed_dim: int = 1280
    resampler_depth: int = 4
    resampler_heads: int = 12
    resampler_dim_head: int = 64

    @property
    def vae_factor(self) -> int:
        return 2 ** (len(self.vae.block_out_channels) - 1)


class CameraEmbed(nn.Sequential):
    """Flattened c2w [B, 16] → a time-embedding-sized vector: Linear, SiLU,
    Linear (MVDream's `camera_embed.{0,2}`)."""

    def __init__(self, camera_dim: int, dim: int):
        super().__init__(nn.Linear(camera_dim, dim), nn.SiLU(),
                         nn.Linear(dim, dim))


class PerceiverAttention(nn.Module):
    """`mv_unet.py:355-403`: the latents query [image tokens; latents]. Its
    LayerNorms take the JAX package's eps, 1e-6."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, 2 * inner, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x, latents):
        x, latents = self.norm1(x), self.norm2(latents)
        k, v = self.to_kv(torch.cat([x, latents], 1)).chunk(2, dim=-1)
        return self.to_out(_attend(self.to_q(latents), k, v, self.heads))


class Resampler(nn.Module):
    """ImageDream's image-prompt projector (`mv_unet.py:406-450`): learned
    query `latents` attend to the projected CLIP tokens over `depth`
    perceiver blocks, each followed by a LayerNorm → Linear → exact GELU →
    Linear feed-forward (`layers.{i}.{0,1}`), → `num_queries` tokens of
    `output_dim`, LayerNormed."""

    def __init__(self, dim: int, depth: int, dim_head: int, heads: int,
                 num_queries: int, embedding_dim: int, output_dim: int,
                 ff_mult: int = 4):
        super().__init__()
        self.latents = nn.Parameter(torch.zeros(1, num_queries, dim))
        self.proj_in = nn.Linear(embedding_dim, dim)
        self.proj_out = nn.Linear(dim, output_dim)
        self.norm_out = nn.LayerNorm(output_dim, eps=1e-6)
        self.layers = nn.ModuleList([nn.ModuleList([
            PerceiverAttention(dim, heads, dim_head),
            nn.Sequential(nn.LayerNorm(dim, eps=1e-6),
                          nn.Linear(dim, dim * ff_mult, bias=False),
                          nn.GELU(),
                          nn.Linear(dim * ff_mult, dim, bias=False))])
            for _ in range(depth)])

    def forward(self, x):
        """x [B, N, embedding_dim] → [B, num_queries, output_dim]."""
        latents = self.latents.expand(x.shape[0], -1, -1)
        x = self.proj_in(x)
        for attn, ff in self.layers:
            latents = latents + attn(x, latents)
            latents = latents + ff(latents)
        return self.norm_out(self.proj_out(latents))


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
        self.cfg = cfg
        self.unet = UNet2DCondition(cfg.unet)
        self.vae = AutoencoderKL(cfg.vae)
        self.camera_embed = CameraEmbed(cfg.camera_dim,
                                        cfg.unet.block_out_channels[0] * 4)
        self.image_embed = None
        if cfg.ip_dim > 0:
            self.image_embed = Resampler(
                dim=cfg.prompt_dim, depth=cfg.resampler_depth,
                dim_head=cfg.resampler_dim_head,
                heads=cfg.resampler_heads, num_queries=cfg.ip_dim,
                embedding_dim=cfg.ip_embed_dim, output_dim=cfg.prompt_dim)


def init_mvdream_(model: MVDream, generator: torch.Generator) -> None:
    """`init_weights_`, and the Resampler's query latents normal with std
    prompt_dim^-1/2, as the JAX package's init draws them."""
    init_weights_(model, generator)
    if model.image_embed is not None:
        lat = model.image_embed.latents
        with torch.no_grad():
            lat.copy_(torch.randn(lat.shape, generator=generator,
                                  device=generator.device)
                      * lat.shape[-1] ** -0.5)


class Conditioning(NamedTuple):
    """What one guided UNet call reads: the context [2·F, T(+ip), D] as
    [uncond; cond], the camera embeddings [2·F, 4·C0], the pinned latents
    [2, 4, l, l] of the extra frame ([zeros; the image's]) or None, and the
    stage-2 pixel latents [2·F, 4, l, l] ([zeros; the views']) or None."""
    states: torch.Tensor
    cam_emb: torch.Tensor
    pinned: Optional[torch.Tensor] = None
    pixels: Optional[torch.Tensor] = None

    @property
    def frames(self) -> int:
        return self.states.shape[0] // 2


class MVDreamPipeline:
    scheduler_name = "DDIMScheduler"

    def __init__(self, model: MVDream):
        self.model = model.eval()
        self.cfg = model.cfg
        self.default_prompt_embeds: Optional[torch.Tensor] = None
        self.default_negative_embeds: Optional[torch.Tensor] = None
        # image [B, H, W, 3] in [0, 1] → CLIP penultimate states [B, N, C]
        self.vision_encoder: Optional[Callable] = None

    def set_vision_encoder(self, fn: Optional[Callable]) -> None:
        self.vision_encoder = fn

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @classmethod
    def init_random(cls, seed: int = 0, cfg: MVDreamConfig = MVDreamConfig(),
                    device=None) -> "MVDreamPipeline":
        """Weights drawn from `seed` in the JAX package's scheme
        (`init_mvdream_`) on `device` (default: the card;
        `common.seeded_model`)."""
        return cls(seeded_model(lambda: MVDream(cfg), init_mvdream_, seed,
                                device))

    @classmethod
    def from_pretrained(cls, path: str, device=None,
                        **cfg_overrides) -> "MVDreamPipeline":
        """An ashawkey/mvdream-sd2.1-diffusers or imagedream-ipmv-diffusers
        directory: the LDM-layout UNet renamed (`convert.mv_unet_name`) and
        loaded strictly with the camera MLP (and the Resampler), the VAE,
        the empty prompt's embedding from text_encoder/ as the default
        prompt and negative embeddings, and image_encoder/'s penultimate
        states as the vision hook."""
        from .convert import load_mvdream_dir
        return load_mvdream_dir(cls, path, device, **cfg_overrides)

    @classmethod
    def from_ldm_checkpoint(cls, ckpt_path: str, device=None,
                            **cfg_overrides) -> "MVDreamPipeline":
        """A single-file LDM checkpoint: CRM's pixel- / ccm-diffusion
        stages (`convert.load_ldm_checkpoint`)."""
        from .convert import load_ldm_checkpoint
        return load_ldm_checkpoint(cls, ckpt_path, device, **cfg_overrides)

    def camera_embedding(self, elevation: Optional[float] = None,
                         extra_frame: bool = False):
        """The V views' camera embeddings [V, 4·C0], and with `extra_frame`
        a (V+1)-th row, the embedding of a zero c2w."""
        cfg = self.cfg
        cams = orbit_c2w_flat(cfg.num_views, cfg.camera_elevation
                              if elevation is None else elevation,
                              cfg.camera_radius, device=self.device)
        if extra_frame:
            cams = torch.cat([cams, cams.new_zeros(1, 16)])
        return self.model.camera_embed(cams)

    def _embeds(self, embeds, default):
        cfg = self.cfg
        if embeds is None:
            embeds = default
        if embeds is None:
            embeds = torch.zeros(cfg.prompt_tokens, cfg.prompt_dim)
        return torch.as_tensor(embeds, dtype=torch.float32,
                               device=self.device)

    def encode_images(self, images):
        """[N, H, W, 3] in [0, 1] → scaled VAE latents [N, 4, S/8, S/8] (the
        posterior's mean), resized to S first (antialiased when it shrinks,
        as `jax.image.resize`)."""
        s = self.cfg.image_size
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        if x.shape[1:3] != (s, s):
            x = resize_images(x, s, s)
        return self.model.vae.encode(x.permute(0, 3, 1, 2) * 2.0 - 1.0)

    def conditioning(self, prompt_embeds=None, negative_embeds=None,
                     elevation: Optional[float] = None, image=None,
                     pixel_images=None) -> Conditioning:
        """The CFG batch's `Conditioning`. Embeddings [T, D] default to
        `default_prompt_embeds` / `default_negative_embeds`, else zeros.
        `image` [H, W, 3] (or [1, H, W, 3]) in [0, 1] adds the IP tokens
        (ImageDream; ignored when `cfg.ip_dim` is 0) and, without
        `pixel_images`, the pinned extra frame; `pixel_images` [V, H, W, 3]
        are stage 2's views, which a UNet of 8 input channels needs (any
        other warns and ignores them)."""
        cfg = self.cfg
        use_pixel = pixel_images is not None
        if use_pixel and cfg.unet.in_channels != 8:
            warnings.warn(
                "pixel_images conditioning needs a stage-2 (in_channels=8) "
                f"UNet; this pipeline has {cfg.unet.in_channels} — ignoring "
                "pixel_images")
            use_pixel = False
        if cfg.unet.in_channels == 8 and not use_pixel:
            raise ValueError(
                "stage-2 (in_channels=8) UNet requires pixel_images")
        use_ip = image is not None and cfg.ip_dim > 0
        pin = use_ip and not use_pixel
        nf = cfg.num_views + 1 if pin else cfg.num_views
        cond = self._embeds(prompt_embeds, self.default_prompt_embeds)
        uncond = self._embeds(negative_embeds, self.default_negative_embeds)
        cond = cond[None].expand(nf, -1, -1)
        uncond = uncond[None].expand(nf, -1, -1)
        pinned = pixels = None
        if use_ip:
            img = torch.as_tensor(image, dtype=torch.float32,
                                  device=self.device)
            if img.ndim == 3:
                img = img[None]
            if self.vision_encoder is not None:
                hidden = self.vision_encoder(img)
            else:
                hidden = torch.zeros(1, 257, cfg.ip_embed_dim,
                                     device=self.device)
            rs = self.model.image_embed
            cond = torch.cat([cond, rs(hidden).expand(nf, -1, -1)], 1)
            uncond = torch.cat([uncond, rs(torch.zeros_like(hidden))
                                .expand(nf, -1, -1)], 1)
            if pin:
                lat = self.encode_images(img)
                pinned = torch.cat([torch.zeros_like(lat), lat])
        if use_pixel:
            lat = self.encode_images(pixel_images)
            pixels = torch.cat([torch.zeros_like(lat), lat])
        cam = self.camera_embedding(elevation, extra_frame=pin)
        return Conditioning(torch.cat([uncond, cond]),
                            torch.cat([cam, cam]), pinned, pixels)

    def guided_eps(self, x, t, cond: Conditioning, guidance_scale: float,
                   adapter_residuals=None):
        """One guided UNet call: the F latents `x` [F, 4, l, l] at timestep
        `t`, run as the CFG batch [x; x] under `cond` (with the pinned frame
        written at slot F−1 of each half, the stage-2 latents as 4 more
        channels) → un + g·(co − un). `adapter_residuals` (one map per down
        block, [F, C, h, w]) condition both halves."""
        nf = cond.frames
        lat = torch.cat([x, x])
        if cond.pinned is not None:
            lat = lat.clone()
            lat[nf - 1] = cond.pinned[0]
            lat[2 * nf - 1] = cond.pinned[1]
        if cond.pixels is not None:
            lat = torch.cat([lat, cond.pixels], 1)
        if adapter_residuals is not None:
            adapter_residuals = [torch.cat([r, r]) for r in adapter_residuals]
        tvec = torch.full((2 * nf,), float(t), device=x.device)
        out = self.model.unet(lat, tvec, cond.states, class_emb=cond.cam_emb,
                              mv_views=nf,
                              adapter_residuals=adapter_residuals)
        un, co = out.chunk(2)
        return un + guidance_scale * (co - un)

    def initial_latents(self, generator: Optional[torch.Generator] = None,
                        frames: Optional[int] = None):
        """[F, 4, S/8, S/8] noise (F: `frames`, default the V views) drawn
        with `generator` (default: seed 0) on the CPU and moved, so a seed
        gives the same noise on every device."""
        cfg = self.cfg
        lat = cfg.image_size // cfg.vae_factor
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return torch.randn((frames or cfg.num_views, cfg.vae.latent_channels,
                            lat, lat), generator=generator).to(self.device)

    @torch.no_grad()
    def sample_latents(self, prompt_embeds=None, negative_embeds=None,
                       num_inference_steps: int = 30,
                       guidance_scale: float = 7.0,
                       generator: Optional[torch.Generator] = None,
                       latents: Optional[torch.Tensor] = None,
                       elevation: Optional[float] = None,
                       step_noise: Optional[Callable] = None, image=None,
                       pixel_images=None, adapter_residuals=None):
        """The guided sampling loop → the F denoised latents (the V views',
        then the pinned frame's with ImageDream's `image`). A stochastic
        sampler's noise for step i is `step_noise(i)` ([F, 4, S/8, S/8]), or
        else drawn on the CPU with `generator` (default: seed 0) after the
        initial latents, step by step, and moved."""
        cond = self.conditioning(prompt_embeds, negative_embeds, elevation,
                                 image, pixel_images)
        sched = make_scheduler(self.scheduler_name, SchedulerConfig(),
                               num_inference_steps)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if latents is None:
            latents = self.initial_latents(generator, cond.frames)
        latents = torch.as_tensor(latents, dtype=torch.float32,
                                  device=self.device) * sched.init_sigma
        if step_noise is None:
            def step_noise(i):
                return torch.randn(latents.shape,
                                   generator=generator).to(latents.device)
        return sample_loop(
            sched, lambda x, i, t: self.guided_eps(
                x, t, cond, guidance_scale, adapter_residuals),
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

        prompt_embeds / negative_embeds: [T, D] (zeros when None). image:
        ImageDream's conditioning image, [H, W, 3] in [0, 1]. pixel_images:
        stage 2's views [V, H, W, 3] in [0, 1]. adapter_residuals: the
        T2I-Adapter's maps. latents: the initial noise [F, 4, S/8, S/8] (F
        = V, or V + 1 with the pinned frame); when None it is drawn with
        `generator` (`initial_latents`). step_noise: a stochastic sampler's
        noise by step (`sample_latents`)."""
        latents = self.sample_latents(
            prompt_embeds, negative_embeds, num_inference_steps,
            guidance_scale, generator, latents, elevation, step_noise,
            image, pixel_images, adapter_residuals)
        img = self.model.vae.decode(latents[:self.cfg.num_views])
        return torch.clamp(img * 0.5 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)
