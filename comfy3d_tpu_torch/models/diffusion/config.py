"""diffusers `config.json` → the port's UNet and VAE configs.

Port of `comfy3d_tpu/models/diffusion/convert.py::{unet_config_from_json,
vae_config_from_json}` (the config readers only: the port loads diffusers'
state dicts by name, with no rule tables). A field the port does not carry
comes through as its config field, and `UNet2DCondition` raises for it,
naming its ROADMAP item.
"""

from __future__ import annotations

from .unet import UNetConfig
from .vae import VAEConfig


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
