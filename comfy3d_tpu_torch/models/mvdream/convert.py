"""MVDream's LDM-layout checkpoint → the port's `MVDream`.

Port of `comfy3d_tpu/models/mvdream/convert.py::{mv_unet_rules,
config_from_mv_unet_json, load_mvdream_dir}` for the text-only model. The
ashawkey/mvdream-sd2.1-diffusers checkpoints ship an LDM/OpenAI-layout UNet
(`MultiViewUNetModel`, `LGM/mvdream/mv_unet.py:635`): `input_blocks`,
`middle_block` and `output_blocks` of ResBlocks (`in_layers`, `emb_layers`,
`out_layers`, `skip_connection`) and SpatialTransformer3Ds, `time_embed`,
`out`, plus the camera MLP `camera_embed`. `mv_unet_name` renames each
key to the port's diffusers names (the renames of `mv_unet_rules`, with no
layout change: torch keeps torch's layouts); the module then loads
strictly. ImageDream checkpoints (`ip_dim > 0`: the IP Resampler
`image_embed.*`, `to_k_ip` / `to_v_ip`) raise, naming ROADMAP A.6.4.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional

from ..diffusion.config import (encode_empty_prompt, has_weights_file,
                                load_module, vae_config_from_json)
from ..diffusion.unet import UNetConfig
from ..loader import load_dir_state_dict, read_json_config

_RES = {"in_layers.0": "norm1", "in_layers.2": "conv1",
        "emb_layers.1": "time_emb_proj", "out_layers.0": "norm2",
        "out_layers.3": "conv2", "skip_connection": "conv_shortcut"}
_TOP = {"time_embed.0": "time_embedding.linear_1",
        "time_embed.2": "time_embedding.linear_2",
        "out.0": "conv_norm_out", "out.2": "conv_out",
        "input_blocks.0.0": "conv_in"}


def _res(rest: str, base: str) -> Optional[str]:
    layer, _, leaf = rest.rpartition(".")
    return f"{base}.{_RES[layer]}.{leaf}" if layer in _RES else None


def mv_unet_name(key: str, layers_per_block: int = 2) -> Optional[str]:
    """An LDM-layout `MultiViewUNetModel` key → its name in the port's
    `MVDream` state dict (`unet.*` in diffusers' names, `camera_embed.*`),
    or None for a key the text-only model has no slot for. The attention
    blocks' inner names are diffusers' already."""
    stride = layers_per_block + 1
    if key.startswith("camera_embed."):
        return key
    layer, _, leaf = key.rpartition(".")
    if layer in _TOP:
        return f"unet.{_TOP[layer]}.{leaf}"
    m = re.match(r"input_blocks\.(\d+)\.(\d+)\.(.*)", key)
    if m:
        i, sub, rest = int(m.group(1)), m.group(2), m.group(3)
        level, j = (i - 1) // stride, (i - 1) % stride
        if rest.startswith("op."):
            return f"unet.down_blocks.{level}.downsamplers.0.conv." \
                f"{rest[len('op.'):]}"
        if sub == "0":
            return _res(rest, f"unet.down_blocks.{level}.resnets.{j}")
        return f"unet.down_blocks.{level}.attentions.{j}.{rest}"
    m = re.match(r"middle_block\.(\d+)\.(.*)", key)
    if m:
        sub, rest = m.groups()
        if sub in ("0", "2"):
            return _res(rest, f"unet.mid_block.resnets.{int(sub) // 2}")
        return f"unet.mid_block.attentions.0.{rest}"
    m = re.match(r"output_blocks\.(\d+)\.(\d+)\.(.*)", key)
    if m:
        i, sub, rest = int(m.group(1)), m.group(2), m.group(3)
        level, j = i // stride, i % stride
        if sub != "0" and rest.startswith("conv."):
            return f"unet.up_blocks.{level}.upsamplers.0.conv." \
                f"{rest[len('conv.'):]}"
        if sub == "0":
            return _res(rest, f"unet.up_blocks.{level}.resnets.{j}")
        return f"unet.up_blocks.{level}.attentions.{j}.{rest}"
    return None


def mv_unet_state_dict(sd: dict, layers_per_block: int = 2) -> dict:
    """An LDM-layout UNet state dict → the port's names; a 1×1-conv
    `proj_in` / `proj_out` kernel becomes the Linear's matrix, as
    `mv_unet_rules` takes it. Raises for a key with no slot."""
    out, unused = {}, []
    for key, val in sd.items():
        name = mv_unet_name(key, layers_per_block)
        if name is None:
            unused.append(key)
            continue
        if name.endswith(("proj_in.weight", "proj_out.weight")) \
                and val.ndim == 4:
            val = val[:, :, 0, 0]
        out[name] = val
    if unused:
        raise ValueError(f"{len(unused)} keys of the MVDream UNet have no "
                         f"slot in the port, e.g. {unused[:4]}")
    return out


def config_from_mv_unet_json(raw: dict) -> UNetConfig:
    """A `MultiViewUNetModel` config.json → `UNetConfig` (its `ip_dim` and
    `ip_weight` kept, for the caller to refuse)."""
    mult = raw.get("channel_mult", (1, 2, 4, 4))
    ch = raw.get("model_channels", 320)
    attn_res = set(raw.get("attention_resolutions", (4, 2, 1)))
    down, ds = [], 1
    for li in range(len(mult)):
        down.append("CrossAttnDownBlock2D" if ds in attn_res
                    else "DownBlock2D")
        if li != len(mult) - 1:
            ds *= 2
    up = ["CrossAttnUpBlock2D" if b == "CrossAttnDownBlock2D"
          else "UpBlock2D" for b in reversed(down)]
    nhc = raw.get("num_head_channels", 64)
    ahd = nhc if nhc and nhc > 0 else -max(raw.get("num_heads", 8), 1)
    return UNetConfig(
        in_channels=raw.get("in_channels", 4),
        out_channels=raw.get("out_channels", 4),
        block_out_channels=tuple(ch * m for m in mult),
        layers_per_block=raw.get("num_res_blocks", 2),
        cross_attention_dim=raw.get("context_dim", 1024),
        attention_head_dim=ahd,
        down_block_types=tuple(down), up_block_types=tuple(up),
        ip_dim=raw.get("ip_dim", 0),
        ip_weight=raw.get("ip_weight", 1.0))


def load_mvdream_dir(cls, path: str, device=None, **cfg_overrides):
    """An mvdream-diffusers directory (unet/ in the LDM layout, vae/,
    text_encoder/) → `cls`'s pipeline on `device`, its default prompt and
    negative embeddings the empty prompt's when text_encoder/ holds
    weights."""
    from .pipeline import MVDream, MVDreamConfig, _image_dream
    unet_dir = os.path.join(path, "unet")
    raw = read_json_config(os.path.join(unet_dir, "config.json"))
    base = config_from_mv_unet_json(raw)
    if base.ip_dim > 0:
        raise _image_dream(f"an ImageDream checkpoint (ip_dim {base.ip_dim}"
                           f", {path})")
    vae_dir = os.path.join(path, "vae")
    vae_cfg = vae_config_from_json(
        read_json_config(os.path.join(vae_dir, "config.json")))
    num_views = 4
    kw = dict(
        unet=dataclasses.replace(base, mv_views=num_views),
        vae=vae_cfg, num_views=num_views,
        prompt_dim=base.cross_attention_dim,
        camera_dim=raw.get("camera_dim", 16) or 16,
        image_size=raw.get("image_size", 32)
        * 2 ** (len(vae_cfg.block_out_channels) - 1))
    kw.update(cfg_overrides)
    cfg = MVDreamConfig(**kw)
    sd = mv_unet_state_dict(load_dir_state_dict(unet_dir),
                            cfg.unet.layers_per_block)
    sd.update({f"vae.{k}": v
               for k, v in load_dir_state_dict(vae_dir).items()})
    pipe = cls(load_module(lambda: MVDream(cfg), sd, device))
    te = os.path.join(path, "text_encoder")
    if has_weights_file(te):
        emb = encode_empty_prompt(te, pipe.device)
        pipe.default_prompt_embeds = emb
        pipe.default_negative_embeds = emb
    return pipe
