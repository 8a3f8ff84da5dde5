"""An Era3D checkpoint directory (pengHTYX/MacLab-Era3D-512-6view) → the
port's `Era3DPipeline`.

Port of `comfy3d_tpu/models/era3d/convert.py::load_era3d_dir`, without its
rule tables: the unet/ directory's state dict — the row-wise UNet with the
unCLIP class embedding, the camera embedding and the elevation and focal
regressors (upstream `unet_mv2d_condition.py:455,654,659-686`) — loads
strictly under its own names, as does vae/. Beside them: the
StableUnCLIPImageNormalizer statistics (image_normalizer/), the image
noising scheduler's table (image_noising_scheduler/), image_encoder/'s
projected CLIP embedding as the vision hook, and the per-view prompt
embeddings (fixed_prompt_embeds_6view/{normal,clr}_embeds.pt).
"""

from __future__ import annotations

import os

import torch

from ..diffusion.config import (has_weights_file, load_clip_vision_dir,
                                load_module, unet_config_from_json,
                                unet_state_dict, vae_config_from_json)
from ..loader import load_dir_state_dict, read_json_config


def find_prompt_embeds(path: str):
    """The normal-domain then colour-domain prompt embeddings [2V, T, D]
    of the checkpoint, or None."""
    for sub in ("fixed_prompt_embeds_6view",
                os.path.join("mvdiffusion", "data",
                             "fixed_prompt_embeds_6view")):
        d = os.path.join(path, sub)
        if os.path.isdir(d):
            return torch.cat([
                torch.load(os.path.join(d, f"{name}_embeds.pt"),
                           map_location="cpu", weights_only=True).float()
                for name in ("normal", "clr")])
    return None


def load_era3d_dir(cls, path: str, device=None, **cfg_overrides):
    """`cls`'s pipeline on `device` (default: the card). The unCLIP width
    comes from image_normalizer/config.json and the prompt's token count
    from the embeddings, so a published checkpoint needs no overrides."""
    from .pipeline import Era3D, Era3DConfig, ddpm_alphas_cumprod
    from ..clip import make_vision_conditioner
    unet_dir, vae_dir = (os.path.join(path, n) for n in ("unet", "vae"))
    raw = read_json_config(os.path.join(unet_dir, "config.json"))
    unet_cfg = unet_config_from_json(raw)
    kw = dict(unet=unet_cfg, vae=vae_config_from_json(read_json_config(
                  os.path.join(vae_dir, "config.json"))),
              num_views=raw.get("num_views", 6),
              prompt_dim=unet_cfg.cross_attention_dim,
              image_size=raw.get("sample_size", 64) * 8,
              regress_blocks=raw.get("num_regress_blocks", 3)
              if raw.get("regress_elevation", False) else 0)
    nz = os.path.join(path, "image_normalizer")
    if os.path.exists(os.path.join(nz, "config.json")):
        kw["clip_embed_dim"] = read_json_config(os.path.join(
            nz, "config.json")).get("embedding_dim", 1024)
    embeds = find_prompt_embeds(path)
    if embeds is not None:
        kw["prompt_tokens"] = embeds.shape[1]
    kw.update(cfg_overrides)
    cfg = Era3DConfig(**kw)
    sd = {**{f"unet.{k}": v for k, v in unet_state_dict(unet_dir).items()},
          **{f"vae.{k}": v for k, v in load_dir_state_dict(vae_dir).items()}}
    pipe = cls(load_module(lambda: Era3D(cfg), sd, device))
    if os.path.isdir(nz):
        stats = load_dir_state_dict(nz)
        if "mean" in stats:
            pipe.normalizer_mean = stats["mean"].reshape(-1)
        if "std" in stats:
            pipe.normalizer_std = stats["std"].reshape(-1)
    ns = os.path.join(path, "image_noising_scheduler",
                      "scheduler_config.json")
    if os.path.exists(ns):
        nraw = read_json_config(ns)
        pipe.noising_alphas = ddpm_alphas_cumprod(
            nraw.get("num_train_timesteps", 1000),
            nraw.get("beta_schedule", "squaredcos_cap_v2"),
            nraw.get("beta_start", 0.0001), nraw.get("beta_end", 0.02))
    ie = os.path.join(path, "image_encoder")
    if has_weights_file(ie):
        pipe.set_vision_encoder(make_vision_conditioner(
            load_clip_vision_dir(ie, device)[1].eval()))
    if embeds is not None:
        pipe.set_prompt_embeds(embeds)
    return pipe
