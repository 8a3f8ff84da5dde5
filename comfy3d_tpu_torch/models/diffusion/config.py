"""diffusers component directories → the port's UNet, VAE and CLIP.

Port of `comfy3d_tpu/models/diffusion/convert.py`'s config readers
(`unet_config_from_json`, `vae_config_from_json`) and directory loaders
(`load_{unet,vae,clip_text,clip_vision}_dir`, `encode_empty_prompt`). The
port reads diffusers' and transformers' state dicts by their own names,
strictly, with no rule tables: each module is built on `meta` and takes the
loaded float32 tensors as its own, then moves to `device` (default: the
card). A field the port does not carry comes through as its config field,
and `UNet2DCondition` raises for it, naming its ROADMAP item.
"""

from __future__ import annotations

import os

import torch

from ... import resolve_device
from ..loader import load_dir_state_dict, read_json_config
from .unet import UNet2DCondition, UNetConfig
from .vae import AutoencoderKL, VAEConfig


def unet_config_from_json(cfg: dict, **overrides) -> UNetConfig:
    """A `UNet2DConditionModel` (or multi-view variant) config dict →
    `UNetConfig`; `overrides` replace fields after reading."""
    ahd = cfg.get("attention_head_dim", 8)
    if isinstance(ahd, (list, tuple)):
        # per-block head counts (SD 2.x's [5, 10, 20, 20]: 64-wide heads);
        # a uniform list is a head count
        ahd = -ahd[0] if len(set(ahd)) == 1 else 64
    else:
        # a scalar is diffusers' head count (its num_attention_heads
        # fallback): the config's negative convention
        ahd = -ahd
    depth = cfg.get("transformer_layers_per_block", 1)
    kw = dict(
        in_channels=cfg.get("in_channels", 4),
        out_channels=cfg.get("out_channels", 4),
        block_out_channels=tuple(cfg.get("block_out_channels",
                                         (320, 640, 1280, 1280))),
        layers_per_block=cfg.get("layers_per_block", 2),
        cross_attention_dim=cfg.get("cross_attention_dim", 1024),
        attention_head_dim=ahd,
        norm_groups=cfg.get("norm_num_groups", 32),
        down_block_types=tuple(cfg.get("down_block_types", (
            "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D", "DownBlock2D"))),
        up_block_types=tuple(cfg.get("up_block_types", (
            "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
            "CrossAttnUpBlock2D"))),
        # the multi-view UNets (Wonder3D / Era3D UNetMV2DConditionModel)
        mv_views=cfg.get("num_views", 1)
        if cfg.get("multiview_attention", False) else 1,
        cd_joint=bool(cfg.get("cd_attention_mid", False))
        or (bool(cfg.get("mvcd_attention", False))
            and cfg.get("selfattn_block", "") == "self_rowwise"),
        mv_rowwise=cfg.get("selfattn_block", "") == "self_rowwise",
        transformer_depth=tuple(depth) if isinstance(depth, (list, tuple))
        else depth,
        addition_embed_type=cfg.get("addition_embed_type") or "",
        addition_time_embed_dim=cfg.get("addition_time_embed_dim", 256)
        or 256,
        addition_proj_dim=cfg.get("projection_class_embeddings_input_dim",
                                  2816) or 2816,
    )
    kw.update(overrides)
    return UNetConfig(**kw)


def vae_config_from_json(cfg: dict) -> VAEConfig:
    """An `AutoencoderKL` config dict → `VAEConfig`."""
    return VAEConfig(
        in_channels=cfg.get("in_channels", 3),
        latent_channels=cfg.get("latent_channels", 4),
        block_out_channels=tuple(cfg.get("block_out_channels",
                                         (128, 256, 512, 512))),
        layers_per_block=cfg.get("layers_per_block", 2),
        norm_groups=cfg.get("norm_num_groups", 32),
        scaling_factor=cfg.get("scaling_factor", 0.18215))


def load_module(build, state_dict, device=None):
    """`build()` on `meta`, the state dict loaded strictly as its own
    tensors, moved to `device` (default: the card)."""
    with torch.device("meta"):
        module = build()
    module.load_state_dict(state_dict, strict=True, assign=True)
    return module.to(resolve_device(device))


def _config(path: str) -> dict:
    return read_json_config(os.path.join(path, "config.json"))


def unet_state_dict(path: str) -> dict:
    """A diffusers `unet/` directory's state dict, each spatial
    transformer's 1×1-convolution `proj_in` / `proj_out` kernel
    (`use_linear_projection: false`, SD 1.x) as the Linear's matrix the
    port holds."""
    sd = load_dir_state_dict(path)
    for k, v in sd.items():
        if k.endswith(("proj_in.weight", "proj_out.weight")) and v.ndim == 4:
            sd[k] = v[:, :, 0, 0]
    return sd


def load_unet_dir(path: str, device=None, **config_overrides):
    """A diffusers `unet/` directory (config.json + weights) → (UNetConfig,
    the loaded `UNet2DCondition`, the raw config dict)."""
    raw = _config(path)
    cfg = unet_config_from_json(raw, **config_overrides)
    return cfg, load_module(lambda: UNet2DCondition(cfg),
                            unet_state_dict(path), device), raw


def load_vae_dir(path: str, device=None):
    """A diffusers `vae/` directory → (VAEConfig, the loaded
    `AutoencoderKL`, the raw config dict)."""
    raw = _config(path)
    cfg = vae_config_from_json(raw)
    return cfg, load_module(lambda: AutoencoderKL(cfg),
                            load_dir_state_dict(path), device), raw


def _unprefixed(sd: dict, root: str) -> dict:
    """A transformers CLIP state dict without its `text_model.` /
    `vision_model.` prefix and the `position_ids` buffer older files
    carry."""
    out = {}
    for k, v in sd.items():
        if k.startswith(root):
            k = k[len(root):]
        if k != "embeddings.position_ids":
            out[k] = v
    return out


def load_clip_text_dir(path: str, device=None):
    """A `CLIPTextModel` directory → (CLIPTextConfig, the loaded
    `CLIPTextEncoder`, the raw config dict)."""
    from ..clip import CLIPTextConfig, CLIPTextEncoder
    raw = _config(path)
    cfg = CLIPTextConfig(
        vocab_size=raw.get("vocab_size", 49408),
        hidden=raw.get("hidden_size", 768),
        layers=raw.get("num_hidden_layers", 12),
        heads=raw.get("num_attention_heads", 12),
        mlp_dim=raw.get("intermediate_size", 3072),
        max_positions=raw.get("max_position_embeddings", 77),
        eos_token_id=raw.get("eos_token_id", 49407),
        act=raw.get("hidden_act", "quick_gelu"))
    sd = _unprefixed(load_dir_state_dict(path), "text_model.")
    return cfg, load_module(lambda: CLIPTextEncoder(cfg), sd, device), raw


def load_clip_vision_dir(path: str, device=None):
    """A `CLIPVisionModelWithProjection` directory → (CLIPVisionConfig, the
    loaded `CLIPVisionEncoder`, the raw config dict)."""
    from ..clip import CLIPVisionConfig, CLIPVisionEncoder
    raw = _config(path)
    vc = raw.get("vision_config", raw)
    cfg = CLIPVisionConfig(
        hidden=vc.get("hidden_size", 1024),
        layers=vc.get("num_hidden_layers", 24),
        heads=vc.get("num_attention_heads", 16),
        mlp_dim=vc.get("intermediate_size", 4096),
        image_size=vc.get("image_size", 224),
        patch=vc.get("patch_size", 14),
        projection_dim=raw.get("projection_dim", 768),
        act=vc.get("hidden_act", "quick_gelu"))
    sd = _unprefixed(load_dir_state_dict(path), "vision_model.")
    return cfg, load_module(lambda: CLIPVisionEncoder(cfg), sd, device), raw


def has_weights_file(path: str) -> bool:
    """Whether a component directory holds a transformers weights file
    (`model*` / `pytorch_model*`), as the JAX loaders test it."""
    return os.path.isdir(path) and any(
        f.startswith(("model", "pytorch_model")) for f in os.listdir(path))


@torch.no_grad()
def encode_empty_prompt(text_encoder_dir: str, device=None) -> torch.Tensor:
    """The checkpoint's CLIPTextModel on the empty prompt "": its hidden
    states [T, D] (the reference pipelines' `_encode_prompt(prompt="")`,
    e.g. `Zero123Plus/pipeline.py:335,377`). The empty prompt needs no
    vocab: [BOS, EOS] then pads, "!" (id 0) for a `gelu` (SD2-class)
    encoder, else EOS."""
    from ..clip import empty_prompt_ids
    cfg, model, _ = load_clip_text_dir(text_encoder_dir, device)
    pad = 0 if cfg.act == "gelu" else 49407
    return model.eval()(empty_prompt_ids(cfg.max_positions,
                                         pad_token_id=pad))[0][0]
