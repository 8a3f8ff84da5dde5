"""Era3D: one image → six views and six normal maps at 512², with
row-wise multi-view attention.

Port of `comfy3d_tpu/models/era3d/pipeline.py` (upstream's
`pipeline_mvdiffusion_unclip.py` and `transformer_mv2d_self_rowwise.py`):
  * an SD-2.1-class UNet whose blocks (`UNetConfig.mv_rowwise`) make
    `attn1` the joint attention of each normal frame and its colour frame
    (`cd_joint`) and add `attn_mv`, attention within each token row across
    the six views of one domain;
  * unCLIP conditioning: the image's projected CLIP embedding, normalised,
    noised at `noise_level` and unnormalised, beside the noise level's
    timestep embedding, through the `projection` class embedding;
  * in-network pose regression (`pose_hook`): the mid block's pooled
    features of each normal and colour frame pair → elevation and focal
    regressors, averaged over the views → sin | cos → the camera embedding,
    added to the up path's time embedding;
  * fixed per-view prompt embeddings (normal domain, then colour), the
    classifier-free guidance batch laid out [uncond normals, cond normals,
    uncond colours, cond colours], the image's VAE latent concatenated on
    the channels of the cond frames (zeros in the uncond frames).

The model's state dict holds `unet.*` (upstream's names, with
`class_embedding`, `camera_embedding`, `elevation_regressor` and
`focal_regressor`) and `vae.*`. Images enter as [S, S, 3] in [0, 1] and
leave as [V, S, S, 3]; the modules run NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.image import resize_images
from ..common import init_weights_, seeded_model
from ..diffusion.schedulers import (SchedulerConfig, make_scheduler,
                                    sample_loop)
from ..diffusion.unet import (TimestepEmbedding, UNet2DCondition,
                              UNetConfig, timestep_embedding)
from ..diffusion.vae import AutoencoderKL, VAEConfig


@dataclasses.dataclass(frozen=True)
class Era3DConfig:
    image_size: int = 512
    num_views: int = 6
    prompt_tokens: int = 77
    prompt_dim: int = 1024
    unet: UNetConfig = UNetConfig(
        in_channels=8, out_channels=4, cross_attention_dim=1024,
        attention_head_dim=64, mv_views=6, mv_rowwise=True, cd_joint=True)
    vae: VAEConfig = VAEConfig()
    scheduler: SchedulerConfig = SchedulerConfig()
    # the unCLIP class embedding's input: [noised image embedding |
    # noise-level embedding], each clip_embed_dim wide
    clip_embed_dim: int = 1024
    regress_blocks: int = 3          # 0: no pose regression
    noise_level: int = 0


class ResidualLiner(nn.Module):
    """Era3D's pose regressor (upstream `unet_mv2d_condition.py:109-129`):
    `linear_in` (Linear, SiLU), `num_block` residual blocks h ← SiLU(h +
    linear2(SiLU(linear1(h)))), `linear_out`."""

    def __init__(self, in_features: int, out_features: int, dim: int,
                 num_block: int):
        super().__init__()
        self.linear_in = nn.Sequential(nn.Linear(in_features, dim), nn.SiLU())
        self.blocks = nn.ModuleList([nn.ModuleDict({
            "linear1": nn.Linear(dim, dim), "linear2": nn.Linear(dim, dim)})
            for _ in range(num_block)])
        self.linear_out = nn.Linear(dim, out_features)

    def forward(self, x):
        h = self.linear_in(x)
        for blk in self.blocks:
            h = F.silu(h + blk["linear2"](F.silu(blk["linear1"](h))))
        return self.linear_out(h)


def ddpm_alphas_cumprod(num_train_timesteps=1000,
                        schedule="squaredcos_cap_v2",
                        beta_start=0.0001, beta_end=0.02) -> np.ndarray:
    """The image-noising scheduler's alphas_cumprod (float64)."""
    if schedule == "squaredcos_cap_v2":
        def f(t):
            return np.cos((t / num_train_timesteps + 0.008)
                          / 1.008 * np.pi / 2) ** 2
        ts = np.arange(num_train_timesteps)
        betas = np.minimum(1.0 - f(ts + 1) / f(ts), 0.999)
    elif schedule == "scaled_linear":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                            num_train_timesteps) ** 2
    else:
        betas = np.linspace(beta_start, beta_end, num_train_timesteps)
    return np.cumprod(1.0 - betas)


class Era3D(nn.Module):
    def __init__(self, cfg: Era3DConfig = Era3DConfig()):
        super().__init__()
        self.cfg = cfg
        td = cfg.unet.block_out_channels[0] * 4
        extras = dict(
            class_embedding=TimestepEmbedding(2 * cfg.clip_embed_dim, td),
            camera_embedding=TimestepEmbedding(4, td))
        if cfg.regress_blocks > 0:
            mid = 2 * cfg.unet.block_out_channels[-1]
            extras.update(
                elevation_regressor=ResidualLiner(mid, 1, 1280,
                                                  cfg.regress_blocks),
                focal_regressor=ResidualLiner(mid, 1, 1280,
                                              cfg.regress_blocks))
        self.unet = UNet2DCondition(cfg.unet, **extras)
        self.vae = AutoencoderKL(cfg.vae)


class Era3DConditioning(NamedTuple):
    """What one guided UNet call reads, over the 4V frames [uncond normals,
    cond normals, uncond colours, cond colours]: the prompt embeddings
    [4V, T, D], the class embeddings [4V, 4·C0] and the image latents
    [4V, 4, l, l] (zeros in the uncond frames)."""
    states: torch.Tensor
    class_emb: torch.Tensor
    image_latents: torch.Tensor


class Era3DPipeline:
    scheduler_name = "DDIMScheduler"

    def __init__(self, model: Era3D):
        self.model = model.eval()
        self.cfg = cfg = model.cfg
        # the per-view prompt embeddings [2V, T, D], normal domain then
        # colour (the checkpoint's `fixed_prompt_embeds_6view`); zeros
        # until set
        self.prompt_embeds = torch.zeros(2 * cfg.num_views, cfg.prompt_tokens,
                                         cfg.prompt_dim)
        # the unCLIP image normaliser's statistics (image_normalizer/)
        self.normalizer_mean = torch.zeros(cfg.clip_embed_dim)
        self.normalizer_std = torch.ones(cfg.clip_embed_dim)
        self.noising_alphas = ddpm_alphas_cumprod()
        # image [B, H, W, 3] in [0, 1] → the projected embedding [B, D]
        self.vision_encoder: Optional[Callable] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @classmethod
    def init_random(cls, seed: int = 0, cfg: Era3DConfig = Era3DConfig(),
                    device=None) -> "Era3DPipeline":
        """Weights drawn from `seed` in the JAX package's scheme
        (`common.init_weights_`) on `device` (default: the card)."""
        return cls(seeded_model(lambda: Era3D(cfg), init_weights_, seed,
                                device))

    @classmethod
    def from_pretrained(cls, path: str, device=None,
                        **cfg_overrides) -> "Era3DPipeline":
        """A pengHTYX/MacLab-Era3D-512-6view directory
        (`convert.load_era3d_dir`)."""
        from .convert import load_era3d_dir
        return load_era3d_dir(cls, path, device, **cfg_overrides)

    def set_prompt_embeds(self, embeds) -> None:
        self.prompt_embeds = torch.as_tensor(embeds, dtype=torch.float32)

    def set_vision_encoder(self, fn: Optional[Callable]) -> None:
        self.vision_encoder = fn

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def noise_image_embeddings(self, embeds, noise):
        """StableUnCLIP's image-embedding noising: normalise, noise at
        `noise_level` with `noise` (the embedding's shape), unnormalise,
        then the noise level's timestep embedding beside it → [B, 2·E]."""
        cfg = self.cfg
        mean, std = (self._f32(a) for a in (self.normalizer_mean,
                                            self.normalizer_std))
        ac = float(self.noising_alphas[cfg.noise_level])
        x = (embeds - mean) / std
        x = float(np.sqrt(ac)) * x + float(np.sqrt(1.0 - ac)) \
            * self._f32(noise)
        x = x * std + mean
        lvl = timestep_embedding(torch.full(
            (x.shape[0],), float(cfg.noise_level), device=x.device),
            cfg.clip_embed_dim)
        return torch.cat([x, lvl], -1)

    def pose_hook(self, h, temb):
        """The UNet's pose hook (None without regressors): the mid block's
        output h [4V, C, h, w] pooled, each normal frame's row beside its
        colour frame's → the elevation and focal regressors, averaged over
        the V views of the uncond and the cond half → sin | cos → the camera
        embedding, added to `temb` per half. → (new temb, (elevation [2,
        1], focal [2, 1]))."""
        unet, v = self.model.unet, self.cfg.num_views
        pool = h.mean((2, 3))
        half = pool.shape[0] // 2
        pair = torch.cat([pool[:half], pool[half:]], -1)
        ele = unet.elevation_regressor(pair).reshape(-1, v, 1).mean(1)
        focal = unet.focal_regressor(pair).reshape(-1, v, 1).mean(1)
        pose = torch.cat([ele, focal], -1)
        emb = unet.camera_embedding(torch.cat([torch.sin(pose),
                                               torch.cos(pose)], -1))
        emb = emb.repeat_interleave(v, 0)
        return temb + torch.cat([emb, emb]), (ele, focal)

    def conditioning(self, image, image_noise=None) -> Era3DConditioning:
        """image [1, S, S, 3] in [0, 1]; `image_noise` [1, E], the unCLIP
        noise of the image embedding (read only with a vision encoder;
        None: zeros)."""
        cfg, v = self.cfg, self.cfg.num_views
        td = cfg.unet.block_out_channels[0] * 4
        lat = self.model.vae.encode(image.permute(0, 3, 1, 2) * 2.0 - 1.0)
        lat = lat.expand(v, -1, -1, -1)
        zl = torch.zeros_like(lat)
        if self.vision_encoder is not None:
            emb = self.vision_encoder(image)
            pos = self.noise_image_embeddings(
                emb, torch.zeros_like(emb) if image_noise is None
                else image_noise)
            mlp = self.model.unet.class_embedding
            pos, neg = mlp(pos), mlp(torch.zeros_like(pos))
            neg, pos = neg.expand(v, -1), pos.expand(v, -1)
            class_emb = torch.cat([neg, pos, neg, pos])
        else:
            class_emb = torch.zeros(4 * v, td, device=self.device)
        pe_n, pe_c = self._f32(self.prompt_embeds).chunk(2)
        return Era3DConditioning(torch.cat([pe_n, pe_n, pe_c, pe_c]),
                                 class_emb, torch.cat([zl, lat, zl, lat]))

    def guided_eps(self, x, t, cond: Era3DConditioning,
                   guidance_scale: float):
        """One guided UNet call on the 2V latents x [2V, 4, l, l] (normals,
        then colours) at timestep t → (un + g·(co − un), the pose hook's
        (elevation, focal) or None)."""
        n, c = x.chunk(2)
        lat = torch.cat([torch.cat([n, n, c, c]), cond.image_latents], 1)
        tvec = torch.full((lat.shape[0],), float(t), device=x.device)
        hook = self.pose_hook if self.cfg.regress_blocks > 0 else None
        out = self.model.unet(lat, tvec, cond.states,
                              class_emb=cond.class_emb, pose_hook=hook)
        out, aux = out if hook is not None else (out, {})
        un_n, co_n, un_c, co_c = out.chunk(4)
        un, co = torch.cat([un_n, un_c]), torch.cat([co_n, co_c])
        return un + guidance_scale * (co - un), aux.get("pose_aux")

    @torch.no_grad()
    def __call__(self, image, num_inference_steps: int = 40,
                 guidance_scale: float = 3.0, seed: int = 0,
                 draws: Optional[Mapping[str, object]] = None):
        """image [S, S, 3] (or [1, S, S, 3]) in [0, 1] → (colours [V, S, S,
        3], normals [V, S, S, 3]) in [0, 1].

        draws: the noise — "image_embeds" [1, E] (the unCLIP noise, read
        with a vision encoder), "latents" [2V, 4, l, l] (NCHW) and, for a
        stochastic sampler, "step"[i] of the latents' shape by loop step.
        Without it the noise is drawn in that order on the CPU from a
        generator seeded with `seed` and moved."""
        cfg = self.cfg
        image = self._f32(image)
        if image.ndim == 3:
            image = image[None]
        s = cfg.image_size
        if image.shape[1:3] != (s, s):
            image = resize_images(image, s, s)
        l = s // 2 ** (len(cfg.vae.block_out_channels) - 1)
        shape = (2 * cfg.num_views, cfg.vae.latent_channels, l, l)
        if draws is None:
            gen = torch.Generator().manual_seed(int(seed))
            image_noise = (torch.randn((1, cfg.clip_embed_dim), generator=gen)
                           if self.vision_encoder is not None else None)
            latents = torch.randn(shape, generator=gen)

            def step_noise(i):
                return torch.randn(shape, generator=gen).to(self.device)
        else:
            image_noise, latents = draws.get("image_embeds"), draws["latents"]

            def step_noise(i):
                return self._f32(draws["step"][i])
        cond = self.conditioning(image, image_noise)
        sched = make_scheduler(self.scheduler_name, cfg.scheduler,
                               num_inference_steps)
        out = sample_loop(
            sched, lambda x, i, t: self.guided_eps(x, t, cond,
                                                   guidance_scale)[0],
            self._f32(latents) * sched.init_sigma, noise=step_noise)
        imgs = torch.clamp(self.model.vae.decode(out) * 0.5 + 0.5, 0.0, 1.0)
        imgs = imgs.permute(0, 2, 3, 1)
        return imgs[cfg.num_views:], imgs[:cfg.num_views]
