"""Wonder3D: one image → six views and six normal maps, jointly.

Port of `comfy3d_tpu/models/wonder3d/pipeline.py` (upstream's
`pipeline_mvdiffusion_image.py`): an SD-1.5-class UNet with MVDream's 3D
self-attention over the six views (`UNetConfig.mv_views`) and Wonder3D's
cross-domain joint attention (`cd_joint`), which pairs each normal frame
with its colour frame. The conditioning is the image's projected CLIP
embedding (the context, one token), the image's VAE latent concatenated to
every frame's latents on the channels, and the fixed camera table — a sin |
cos vector of [elevation_cond, elevation, azimuth, normal, colour] per frame
— through the `projection` class embedding, added to the time embedding.

The joint attention pairs frame j of the batch's first half with frame j of
its second half, so the port lays every UNet call out as upstream does:
[uncond normals, cond normals, uncond colours, cond colours] under
classifier-free guidance, the two domains' cond frames alone at guidance
1.0 (upstream's `guidance_scale != 1.0` test). The JAX package runs
[uncond (normals, colours), cond (normals, colours)] at every guidance, so
each of its normal frames attends to its unconditional twin and its output
at guidance 1.0 depends on the unconditional half (ROADMAP §C.9). The JAX
package also multiplies the VAE's latents by the scaling factor a second
time (§C.8); the port scales them once (`AutoencoderKL.encode` / `decode`).

The model's state dict holds `unet.*` (upstream's `UNetMV2DConditionModel`
names, with its `class_embedding.linear_{1,2}`) and `vae.*`. Images enter
as [S, S, 3] in [0, 1] and leave as [V, S, S, 3]; the modules run NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ...core.image import resize_images
from ..common import init_weights_, seeded_model
from ..diffusion.schedulers import (SchedulerConfig, make_scheduler,
                                    sample_loop)
from ..diffusion.unet import TimestepEmbedding, UNet2DCondition, UNetConfig
from ..diffusion.vae import AutoencoderKL, VAEConfig

# upstream pipeline_mvdiffusion_image.py:139-152 — [e_cond, e, a, normal,
# colour] per frame: the six views' normal frames, then their colour frames
CAMERA_TABLE = np.array(
    [[0.0, 0.0000, 0.0000, 1.0, 0.0],
     [0.0, -0.2362, 0.8125, 1.0, 0.0],
     [0.0, -0.1686, 1.6934, 1.0, 0.0],
     [0.0, 0.5220, 3.1406, 1.0, 0.0],
     [0.0, 0.6904, 4.8359, 1.0, 0.0],
     [0.0, 0.3733, 5.5859, 1.0, 0.0],
     [0.0, 0.0000, 0.0000, 0.0, 1.0],
     [0.0, -0.2362, 0.8125, 0.0, 1.0],
     [0.0, -0.1686, 1.6934, 0.0, 1.0],
     [0.0, 0.5220, 3.1406, 0.0, 1.0],
     [0.0, 0.6904, 4.8359, 0.0, 1.0],
     [0.0, 0.3733, 5.5859, 0.0, 1.0]], np.float32)


@dataclasses.dataclass(frozen=True)
class Wonder3DConfig:
    image_size: int = 256
    num_views: int = 6
    prompt_dim: int = 768            # the projected CLIP image embedding
    unet: UNetConfig = UNetConfig(
        in_channels=8, out_channels=4, cross_attention_dim=768,
        attention_head_dim=-8, mv_views=6, cd_joint=True)
    vae: VAEConfig = VAEConfig()
    scheduler: SchedulerConfig = SchedulerConfig()


class Wonder3D(nn.Module):
    def __init__(self, cfg: Wonder3DConfig = Wonder3DConfig()):
        super().__init__()
        self.cfg = cfg
        self.unet = UNet2DCondition(cfg.unet, class_embedding=(
            TimestepEmbedding(10, cfg.unet.block_out_channels[0] * 4)))
        self.vae = AutoencoderKL(cfg.vae)


class Wonder3DPipeline:
    scheduler_name = "DDIMScheduler"

    def __init__(self, model: Wonder3D):
        self.model = model.eval()
        self.cfg = model.cfg
        # image [B, H, W, 3] in [0, 1] → the projected embedding [B, D]
        self.vision_encoder: Optional[Callable] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @classmethod
    def init_random(cls, seed: int = 0, cfg: Wonder3DConfig = Wonder3DConfig(),
                    device=None) -> "Wonder3DPipeline":
        """Weights drawn from `seed` in the JAX package's scheme
        (`common.init_weights_`) on `device` (default: the card)."""
        return cls(seeded_model(lambda: Wonder3D(cfg), init_weights_, seed,
                                device))

    @classmethod
    def from_pretrained(cls, path: str, device=None,
                        **cfg_overrides) -> "Wonder3DPipeline":
        """A flamehaze1115/wonder3d-v1.0 directory: unet/ (with its
        projection class embedding) and vae/ loaded strictly, and
        image_encoder/'s projected CLIP embedding as the vision hook when it
        holds weights; on `device` (default: the card)."""
        import os
        from ..clip import make_vision_conditioner
        from ..diffusion.config import (has_weights_file,
                                        load_clip_vision_dir, load_module,
                                        unet_config_from_json,
                                        unet_state_dict,
                                        vae_config_from_json)
        from ..loader import load_dir_state_dict, read_json_config
        unet_dir, vae_dir = (os.path.join(path, n) for n in ("unet", "vae"))
        raw = read_json_config(os.path.join(unet_dir, "config.json"))
        unet_cfg = unet_config_from_json(raw)
        kw = dict(unet=unet_cfg, vae=vae_config_from_json(read_json_config(
                      os.path.join(vae_dir, "config.json"))),
                  num_views=raw.get("num_views", 6),
                  prompt_dim=unet_cfg.cross_attention_dim,
                  image_size=raw.get("sample_size", 32) * 8)
        kw.update(cfg_overrides)
        cfg = Wonder3DConfig(**kw)
        sd = {**{f"unet.{k}": v for k, v in unet_state_dict(unet_dir).items()},
              **{f"vae.{k}": v
                 for k, v in load_dir_state_dict(vae_dir).items()}}
        pipe = cls(load_module(lambda: Wonder3D(cfg), sd, device))
        ie = os.path.join(path, "image_encoder")
        if has_weights_file(ie):
            pipe.set_vision_encoder(make_vision_conditioner(
                load_clip_vision_dir(ie, device)[1].eval()))
        return pipe

    def set_vision_encoder(self, fn: Optional[Callable]) -> None:
        self.vision_encoder = fn

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def camera_class_emb(self) -> torch.Tensor:
        """[2V, 4·C0]: the camera table's first 2V rows (as the JAX package
        slices it), sin | cos, through the class embedding."""
        cam = self._f32(CAMERA_TABLE[:2 * self.cfg.num_views])
        return self.model.unet.class_embedding(
            torch.cat([torch.sin(cam), torch.cos(cam)], -1))

    def conditioning(self, image):
        """image [1, S, S, 3] in [0, 1] → (the CLIP embedding [1, D], zeros
        without a vision encoder; the image's VAE latent [1, 4, l, l])."""
        if self.vision_encoder is not None:
            emb = self.vision_encoder(image)
        else:
            emb = torch.zeros(1, self.cfg.prompt_dim, device=self.device)
        lat = self.model.vae.encode(image.permute(0, 3, 1, 2) * 2.0 - 1.0)
        return emb, lat

    def guided_eps(self, x, t, emb, image_latent, class_emb,
                   guidance_scale: float):
        """One guided UNet call on the 2V latents x [2V, 4, l, l] (normals,
        then colours) at timestep t: the frames laid out [uncond normals,
        cond normals, uncond colours, cond colours] (the uncond frames'
        embedding and image latent zeros) → un + g·(co − un); at g = 1 the
        cond frames alone."""
        v = self.cfg.num_views
        n, c = x[:v], x[v:]
        cn, cc = class_emb[:v], class_emb[v:]
        lat = image_latent.expand(v, -1, -1, -1)
        states = emb[:, None, :].expand(v, -1, -1)
        if guidance_scale == 1.0:
            parts = ((n, lat, states, cn), (c, lat, states, cc))
        else:
            zl, zs = torch.zeros_like(lat), torch.zeros_like(states)
            parts = ((n, zl, zs, cn), (n, lat, states, cn),
                     (c, zl, zs, cc), (c, lat, states, cc))
        xs, lats, ss, ces = (torch.cat(p) for p in zip(*parts))
        tvec = torch.full((xs.shape[0],), float(t), device=x.device)
        out = self.model.unet(torch.cat([xs, lats], 1), tvec, ss,
                              class_emb=ces)
        if guidance_scale == 1.0:
            return out
        un_n, co_n, un_c, co_c = out.chunk(4)
        un, co = torch.cat([un_n, un_c]), torch.cat([co_n, co_c])
        return un + guidance_scale * (co - un)

    @torch.no_grad()
    def __call__(self, image, num_inference_steps: int = 50,
                 guidance_scale: float = 1.0, seed: int = 0,
                 draws: Optional[Mapping[str, object]] = None):
        """image [S, S, 3] (or [1, S, S, 3]) in [0, 1] → (colours [V, S, S,
        3], normals [V, S, S, 3]) in [0, 1].

        draws: the noise, NCHW — "latents" [2V, 4, l, l] and, for a
        stochastic sampler, "step"[i] of the same shape by loop step. Without
        it the noise is drawn in that order on the CPU from a generator
        seeded with `seed` and moved, so a seed gives the same views on
        every device."""
        cfg = self.cfg
        image = self._f32(image)
        if image.ndim == 3:
            image = image[None]
        s = cfg.image_size
        if image.shape[1:3] != (s, s):
            image = resize_images(image, s, s)
        emb, lat = self.conditioning(image)
        class_emb = self.camera_class_emb()
        sched = make_scheduler(self.scheduler_name, cfg.scheduler,
                               num_inference_steps)
        shape = (2 * cfg.num_views, cfg.vae.latent_channels) + lat.shape[2:]
        if draws is None:
            gen = torch.Generator().manual_seed(int(seed))
            latents = torch.randn(shape, generator=gen)

            def step_noise(i):
                return torch.randn(shape, generator=gen).to(self.device)
        else:
            latents = draws["latents"]

            def step_noise(i):
                return self._f32(draws["step"][i])
        out = sample_loop(
            sched, lambda x, i, t: self.guided_eps(
                x, t, emb, lat, class_emb, guidance_scale),
            self._f32(latents) * sched.init_sigma, noise=step_noise)
        imgs = torch.clamp(self.model.vae.decode(out) * 0.5 + 0.5, 0.0, 1.0)
        imgs = imgs.permute(0, 2, 3, 1)
        return imgs[cfg.num_views:], imgs[:cfg.num_views]
