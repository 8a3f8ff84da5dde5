"""MVDream / ImageDream LDM-layout checkpoints → the port's `MVDream`.

Port of `comfy3d_tpu/models/mvdream/convert.py`. The
ashawkey/{mvdream-sd2.1,imagedream-ipmv}-diffusers checkpoints and CRM's
single-file stages ship an LDM/OpenAI-layout UNet (`MultiViewUNetModel`,
`LGM/mvdream/mv_unet.py:635`): `input_blocks`, `middle_block` and
`output_blocks` of ResBlocks (`in_layers`, `emb_layers`, `out_layers`,
`skip_connection`) and SpatialTransformer3Ds, `time_embed`, `out`, plus the
camera MLP `camera_embed` and ImageDream's IP Resampler `image_embed`.
`mv_unet_name` renames each key to the port's names (the renames of
`mv_unet_rules`, with no layout change: torch keeps torch's layouts; the
Resampler and the attentions' `to_k_ip` / `to_v_ip` keep theirs); the module
then loads strictly. `load_ldm_checkpoint` reads CRM's `.pth` files (the VAE
and OpenCLIP towers through `models/diffusion/ldm_convert.py`), and
`fold_lora_checkpoint` folds CRM T2I V3's LoRA / DoRA adapters into the
UNet's weights.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional

import torch

from ..diffusion.config import (encode_empty_prompt, has_weights_file,
                                load_clip_vision_dir, load_module,
                                vae_config_from_json)
from ..diffusion.unet import UNetConfig
from ..loader import load_dir_state_dict, load_state_dict, read_json_config

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
    `MVDream` state dict (`unet.*` in diffusers' names, `camera_embed.*`,
    `image_embed.*`), or None for a key it has no slot for. The attention
    blocks' inner names are diffusers' already."""
    stride = layers_per_block + 1
    if key.startswith(("camera_embed.", "image_embed.")):
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
    """A `MultiViewUNetModel` config.json → `UNetConfig`."""
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
    """An mvdream- or imagedream-diffusers directory (unet/ in the LDM
    layout, vae/, text_encoder/, for ImageDream image_encoder/) → `cls`'s
    pipeline on `device`: its default prompt and negative embeddings the
    empty prompt's when text_encoder/ holds weights, its vision hook the
    penultimate states of image_encoder/'s CLIPVisionModel when that holds
    weights."""
    from ..clip import make_vision_hidden_conditioner
    from .pipeline import MVDream, MVDreamConfig
    unet_dir = os.path.join(path, "unet")
    raw = read_json_config(os.path.join(unet_dir, "config.json"))
    base = config_from_mv_unet_json(raw)
    vae_dir = os.path.join(path, "vae")
    vae_cfg = vae_config_from_json(
        read_json_config(os.path.join(vae_dir, "config.json")))
    num_views = 4
    kw = dict(
        unet=dataclasses.replace(base, mv_views=num_views),
        vae=vae_cfg, num_views=num_views,
        prompt_dim=base.cross_attention_dim,
        camera_dim=raw.get("camera_dim", 16) or 16,
        ip_dim=base.ip_dim, ip_weight=base.ip_weight,
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
    ie = os.path.join(path, "image_encoder")
    if has_weights_file(ie):
        _, enc, _ = load_clip_vision_dir(ie, pipe.device)
        pipe.set_vision_encoder(make_vision_hidden_conditioner(enc.eval()))
    return pipe


# CRM's multi-view stages (`Configs/CRM_configs/sd_v2_base_ipmv_zero_SNR
# .yaml` and its chin8 stage 2): an SD-2.1 MultiViewUNetModel
LDM_UNET = {"model_channels": 320, "attention_resolutions": [4, 2, 1],
            "num_res_blocks": 2, "channel_mult": [1, 2, 4, 4],
            "num_head_channels": 64, "context_dim": 1024, "camera_dim": 16}


def ldm_config(in_channels: int = 4, out_channels: int = 4,
               unet_ip_dim: int = 16, num_views: int = 6, **cfg_overrides):
    """The `MVDreamConfig` of an LDM multi-view checkpoint (`LDM_UNET` with
    `unet_ip_dim` IP tokens, the SD VAE, 256² views, a 16-wide camera MLP):
    CRM's pixel stage (4 input channels), its CCM stage (8), and with
    `num_views=4` the imagedream-ipmv widths. `cfg_overrides` replace
    fields after."""
    from ..diffusion.vae import VAEConfig
    from .pipeline import MVDreamConfig
    base = config_from_mv_unet_json({
        **LDM_UNET, "in_channels": in_channels,
        "out_channels": out_channels, "ip_dim": unet_ip_dim})
    kw = dict(unet=dataclasses.replace(base, mv_views=num_views),
              vae=VAEConfig(), num_views=num_views,
              prompt_dim=base.cross_attention_dim, camera_dim=16,
              ip_dim=base.ip_dim, ip_weight=base.ip_weight, image_size=256)
    kw.update(cfg_overrides)
    return MVDreamConfig(**kw)


def ldm_vision_config():
    """ImageDream's OpenCLIP ViT-H/14 visual tower (projection 1024)."""
    from ..clip import CLIPVisionConfig
    return CLIPVisionConfig(hidden=1280, layers=32, heads=16, mlp_dim=5120,
                            image_size=224, patch=14, projection_dim=1024,
                            act="gelu")


def load_ldm_checkpoint(cls, ckpt_path: str, device=None, **cfg_overrides):
    """A single LDM checkpoint file → `cls`'s pipeline on `device`: CRM's
    multi-view stages (`pixel-diffusion.pth` / `ccm-diffusion.pth`,
    reference nodes.py:2188-2211). The MultiViewUNetModel under
    `model.diffusion_model.` (its input channels, 4 or 8, read from
    `conv_in`; IP tokens when `image_embed.*` keys are present), the LDM
    AutoencoderKL under `first_stage_model.`, the OpenCLIP ViT-H text tower
    (the empty prompt's embedding) and visual tower (the vision hook, at
    `ldm_vision_config()`) under `cond_stage_model.model.`. `num_views`
    (default 6) and the other `MVDreamConfig` fields may be overridden."""
    from ..clip import CLIPVisionEncoder, make_vision_hidden_conditioner
    from ..diffusion.ldm_convert import (encode_empty_prompt_openclip,
                                         ldm_vae_state_dict,
                                         open_clip_visual_state_dict)
    from .pipeline import MVDream
    sd = load_state_dict(ckpt_path)
    pre = "model.diffusion_model."
    unet_sd = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    conv_in, out = (unet_sd.get(k) for k in ("input_blocks.0.0.weight",
                                             "out.2.weight"))
    ip = any(k.startswith("image_embed") or "resampler" in k
             for k in unet_sd)
    cfg = ldm_config(4 if conv_in is None else int(conv_in.shape[1]),
                     4 if out is None else int(out.shape[0]),
                     16 if ip else 0, **cfg_overrides)
    msd = {**mv_unet_state_dict(unet_sd, cfg.unet.layers_per_block),
           **{f"vae.{k}": v for k, v in ldm_vae_state_dict(
               sd, len(cfg.vae.block_out_channels)).items()}}
    pipe = cls(load_module(lambda: MVDream(cfg), msd, device))
    if any(k.startswith("cond_stage_model.model.transformer.") for k in sd):
        emb = encode_empty_prompt_openclip(sd, device=pipe.device)
        pipe.default_prompt_embeds = emb
        pipe.default_negative_embeds = emb
    if any(k.startswith("cond_stage_model.model.visual.") for k in sd):
        vcfg = ldm_vision_config()
        enc = load_module(lambda: CLIPVisionEncoder(vcfg),
                          open_clip_visual_state_dict(sd), pipe.device)
        pipe.set_vision_encoder(make_vision_hidden_conditioner(enc.eval()))
    return pipe


@torch.no_grad()
def fold_lora_checkpoint(pipe, lora_path: str) -> int:
    """Fold a peft-injected LoRA / DoRA checkpoint into `pipe`'s UNet in
    place (CRM T2I V3, reference nodes.py:3629-3730): each adapted
    projection's weight W becomes W + B·A (peft's α = r), and for DoRA then
    m ⊙ W / ‖W‖ row by row, the adapter's forward folded exactly.
    W is the file's `base_layer` weight when it has one, else the loaded
    weight; a `base_layer` bias replaces the bias. Keys may carry the
    `model.diffusion_model.` or `diffusion_model.` prefix. Returns the
    number of folded projections."""
    sd = {}
    for k, v in load_state_dict(lora_path).items():
        for pre in ("model.diffusion_model.", "diffusion_model."):
            if k.startswith(pre):
                k = k[len(pre):]
                break
        sd[k] = v
    params = dict(pipe.model.named_parameters())
    nrb = pipe.cfg.unet.layers_per_block
    folded = 0
    for key in sd:
        m = re.fullmatch(r"(.+)\.lora_A\.([^.]+)\.weight", key)
        if not m:
            continue
        mod, adapter = m.groups()
        a = sd[key]                                         # [r, in]
        b = sd.get(f"{mod}.lora_B.{adapter}.weight")        # [out, r]
        name = mv_unet_name(f"{mod}.weight", nrb)
        if name is None:
            print(f"[mvdream.fold_lora] no slot for {mod}")
        if b is None or name is None or not name.startswith("unet."):
            continue
        w = params[name]
        base = sd.get(f"{mod}.base_layer.weight")
        base = w.detach().cpu() if base is None else base
        new = base.double() + b.double() @ a.double()
        mag = sd.get(f"{mod}.lora_magnitude_vector.{adapter}.weight")
        if mag is not None:                                 # DoRA
            norm = torch.linalg.vector_norm(new, dim=1)
            new = new * (mag.reshape(-1).double()
                         / norm.clamp_min(1e-8))[:, None]
        w.copy_(new.to(w.dtype))
        bias = sd.get(f"{mod}.base_layer.bias")
        if bias is not None:
            params[name[:-len("weight")] + "bias"].copy_(bias)
        folded += 1
    print(f"[mvdream.fold_lora] folded {folded} projections from "
          f"{lora_path}")
    return folded
