"""Zero123Plus: one image → a 3×2 grid of six novel views.

Port of `comfy3d_tpu/models/zero123plus/pipeline.py`:
  * an SD-2.1-class UNet (v-prediction, trailing timestep spacing) on a
    960×640 latent canvas holding a 3×2 grid of 320² views;
  * reference attention: the condition image's VAE latent is re-noised at
    each step and run through the UNet with `ref_mode="write"`, and every
    self-attention of the denoising pass (`ref_mode="read"`) appends the
    recorded states to its keys and values;
  * global conditioning: a CLIP vision embedding (`set_vision_encoder`,
    e.g. `models/clip.py::make_vision_conditioner`) added to the prompt
    embedding with per-token ramping coefficients;
  * the pipeline's own affine scalings of latents, (x − 0.22)·0.75, and of
    images, x·0.5/0.8;
  * Euler-ancestral sampling (any sampler of the registry by
    `scheduler_name`), classifier-free guidance as a doubled batch
    [uncond; cond].

The model's state dict holds `unet.*` and `vae.*` (diffusers' names). The
image enters and the grid leaves as the node layer holds images,
[H, W, 3] in [0, 1]; the modules run NCHW. `from_pretrained` reads a
sudo-ai/zero123plus directory.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import torch
from torch import nn

from ...core.image import resize_images
from ..common import init_weights_, seeded_model
from ..diffusion.schedulers import SchedulerConfig, make_scheduler
from ..diffusion.unet import UNet2DCondition, UNetConfig
from ..diffusion.vae import AutoencoderKL, VAEConfig


def scale_latents(x):
    return (x - 0.22) * 0.75


def unscale_latents(x):
    return x / 0.75 + 0.22


def scale_image(x):
    return x * 0.5 / 0.8


def unscale_image(x):
    return x / 0.5 * 0.8


@dataclasses.dataclass(frozen=True)
class Zero123PlusConfig:
    height: int = 960
    width: int = 640
    unet: UNetConfig = UNetConfig.sd21()
    vae: VAEConfig = VAEConfig()
    cond_size: int = 512          # the VAE path's condition image size
    prompt_tokens: int = 77
    prompt_dim: int = 1024

    @property
    def vae_factor(self) -> int:
        return 2 ** (len(self.vae.block_out_channels) - 1)


class Zero123Plus(nn.Module):
    def __init__(self, cfg: Zero123PlusConfig = Zero123PlusConfig()):
        super().__init__()
        self.cfg = cfg
        self.unet = UNet2DCondition(cfg.unet)
        self.vae = AutoencoderKL(cfg.vae)


class Zero123PlusPipeline:
    """The model, the (empty) prompt's embedding [T, D] and the ramping
    coefficients [T] (zeros by default, which null the global term), and
    a pluggable vision encoder: fn(image [B, S, S, 3]) → [B, D]."""

    def __init__(self, model: Zero123Plus, prompt_embeds=None,
                 ramping=None):
        self.model = model.eval()
        self.cfg = cfg = model.cfg
        self.prompt_embeds = (torch.zeros(cfg.prompt_tokens, cfg.prompt_dim)
                              if prompt_embeds is None else prompt_embeds)
        self.ramping = (torch.zeros(cfg.prompt_tokens) if ramping is None
                        else ramping)
        self.vision_encoder: Optional[Callable] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @classmethod
    def init_random(cls, seed: int = 0,
                    cfg: Zero123PlusConfig = Zero123PlusConfig(),
                    device=None) -> "Zero123PlusPipeline":
        """Weights drawn from `seed` in the JAX package's scheme
        (`common.init_weights_`) on `device` (default: the card;
        `common.seeded_model`)."""
        return cls(seeded_model(lambda: Zero123Plus(cfg), init_weights_, seed,
                                device))

    @classmethod
    def from_pretrained(cls, path: str, device=None,
                        **cfg_overrides) -> "Zero123PlusPipeline":
        """A sudo-ai/zero123plus-v1.x diffusers directory
        (`model_index.json`, unet/, vae/, text_encoder/, vision_encoder/),
        as the reference's `DiffusionPipeline.from_pretrained` composes it
        (`Zero123Plus/pipeline.py:272-313`): the UNet and VAE loaded
        strictly, the ramping coefficients from model_index.json, the
        prompt embedding the empty prompt's when text_encoder/ holds
        weights, and the projected CLIP vision conditioner when
        vision_encoder/ does; on `device` (default: the card)."""
        import os
        from ..clip import make_vision_conditioner
        from ..diffusion.config import (encode_empty_prompt,
                                        has_weights_file,
                                        load_clip_vision_dir, load_module,
                                        unet_config_from_json,
                                        vae_config_from_json)
        from ..loader import load_dir_state_dict, read_json_config
        index = read_json_config(os.path.join(path, "model_index.json"))
        parts = {name: os.path.join(path, name) for name in ("unet", "vae")}
        raw = {name: read_json_config(os.path.join(p, "config.json"))
               for name, p in parts.items()}
        unet_cfg = unet_config_from_json(raw["unet"])
        cfg = Zero123PlusConfig(
            unet=unet_cfg, vae=vae_config_from_json(raw["vae"]),
            prompt_dim=unet_cfg.cross_attention_dim, **cfg_overrides)
        sd = {f"{name}.{k}": v for name, p in parts.items()
              for k, v in load_dir_state_dict(p).items()}
        model = load_module(lambda: Zero123Plus(cfg), sd, device)
        ramping = index.get("ramping_coefficients")
        ramping = (torch.zeros(cfg.prompt_tokens) if not ramping
                   else torch.tensor(ramping, dtype=torch.float32))
        te = os.path.join(path, "text_encoder")
        prompt_embeds = (encode_empty_prompt(te, device)
                         if has_weights_file(te) else None)
        pipe = cls(model, prompt_embeds=prompt_embeds, ramping=ramping)
        ve = os.path.join(path, "vision_encoder")
        if has_weights_file(ve):
            pipe.set_vision_encoder(make_vision_conditioner(
                load_clip_vision_dir(ve, device)[1].eval()))
        return pipe

    def set_vision_encoder(self, fn):
        self.vision_encoder = fn

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def encode_condition(self, image):
        """image [B, S, S, 3] in [0, 1] → the condition latent [B, 4, S/f,
        S/f]: the VAE posterior's mean of the affine-scaled image."""
        x = scale_image(self._f32(image).permute(0, 3, 1, 2) * 2.0 - 1.0)
        return self.model.vae.encode(x)

    def _encoder_states(self, image):
        """The prompt embedding [1, T, D], plus, with a vision encoder, the
        projected image embedding times the ramping coefficients."""
        emb = self._f32(self.prompt_embeds)[None]
        if self.vision_encoder is not None:
            global_emb = self.vision_encoder(image)            # [B, D]
            emb = emb + global_emb[:, None, :] \
                * self._f32(self.ramping)[None, :, None]
        return emb

    @torch.no_grad()
    def __call__(self, image, num_inference_steps: int = 28,
                 guidance_scale: float = 4.0, seed: int = 0,
                 output_type: str = "image",
                 draws: Optional[Mapping[str, object]] = None):
        """image [S, S, 3] in [0, 1] → the [H, W, 3] grid of six views in
        [0, 1] (or, with `output_type="latent"`, the unscaled latents
        [1, 4, H/f, W/f]).

        draws: the noise, NCHW — "latents" [1, 4, H/f, W/f], and by loop
        step i "cond"[i] (the condition latent's re-noising, [B, 4, S/f,
        S/f], B = 2 under CFG) and "step"[i] (the sampler's, the latents'
        shape). Without it the noise is drawn in that order from a
        `torch.Generator` seeded with `seed` on the pipeline's device."""
        cfg = self.cfg
        image = self._f32(image)[None]
        if image.shape[1] != cfg.cond_size:
            image = resize_images(image, cfg.cond_size, cfg.cond_size)
        sched = make_scheduler(
            getattr(self, "scheduler_name", None)
            or "EulerAncestralDiscreteScheduler",
            SchedulerConfig(prediction_type="v_prediction",
                            timestep_spacing="trailing"),
            num_inference_steps)

        cond_lat = self.encode_condition(image)
        states = self._encoder_states(image)
        use_cfg = guidance_scale > 1.0
        if use_cfg:
            neg_lat = self.encode_condition(torch.zeros_like(image))
            cond_lat = torch.cat([neg_lat, cond_lat])
            states = torch.cat([self._f32(self.prompt_embeds)[None], states])

        lh, lw = cfg.height // cfg.vae_factor, cfg.width // cfg.vae_factor
        lat_shape = (1, cfg.unet.in_channels, lh, lw)
        if draws is None:
            gen = torch.Generator(self.device).manual_seed(seed)

            def draw(shape):
                return torch.randn(shape, generator=gen, device=self.device)
            latents = draw(lat_shape)
        else:
            latents = self._f32(draws["latents"])
        latents = latents * sched.init_sigma

        unet = self.model.unet
        aux = sched.init_aux(latents)
        for i in range(sched.loop_steps):
            if draws is None:
                cond_noise = draw(cond_lat.shape)
                step_noise = draw(lat_shape) if sched.stochastic else None
            else:
                cond_noise = self._f32(draws["cond"][i])
                step_noise = self._f32(draws["step"][i])
            tvec = torch.full((cond_lat.shape[0],),
                              float(sched.timesteps[i]), device=self.device)
            # the reference pass: the condition latent re-noised at this step
            noisy_cond = sched.scale_model_input(
                sched.add_noise(cond_lat, cond_noise, i), i)
            _, ref = unet(noisy_cond, tvec, states, ref_mode="write")

            lat_in = torch.cat([latents] * 2) if use_cfg else latents
            out = unet(sched.scale_model_input(lat_in, i), tvec, states,
                       ref_mode="read", ref_hidden=ref)
            if use_cfg:
                uncond, cond = out.chunk(2)
                out = uncond + guidance_scale * (cond - uncond)
            latents, aux = sched.step_aux(out, i, latents, aux, step_noise)

        latents = unscale_latents(latents)
        if output_type == "latent":
            return latents
        img = unscale_image(self.model.vae.decode(latents))
        return torch.clamp(img[0] * 0.5 + 0.5, 0.0, 1.0).permute(1, 2, 0)
