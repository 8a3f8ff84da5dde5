"""LDM-layout single-file checkpoints (CompVis / Stability) → the port's VAE
and CLIP encoders.

Port of `comfy3d_tpu/models/diffusion/ldm_convert.py`. CRM's multi-view
stages ship as single `.pth` LDM checkpoints (`pixel-diffusion.pth`,
`ccm-diffusion.pth`) holding `model.diffusion_model.*` (the
`MultiViewUNetModel`, renamed by `models/mvdream/convert.py`),
`first_stage_model.*` (the LDM `AutoencoderKL`) and
`cond_stage_model.model.*` (OpenCLIP ViT-H: its text tower and its visual
tower). Each tower's keys are renamed onto the port's modules, whose names
are diffusers' and transformers': the LDM VAE's `encoder.down.{i}.block.{j}`
→ `encoder.down_blocks.{i}.resnets.{j}`, its 1×1-conv attention → the
linear `to_q` / `to_k` / `to_v` / `to_out.0`, the decoder's `up.{i}` (by
resolution level) → `up_blocks.{L−1−i}` (by application order);
OpenCLIP's `transformer.resblocks.{i}` → `encoder.layers.{i}`, its fused
`attn.in_proj_{weight,bias}` split into q / k / v. The modules then load
strictly.
"""

from __future__ import annotations

import re
from typing import Optional

import torch

from ... import resolve_device

_VAE_RES = {"nin_shortcut": "conv_shortcut"}
_VAE_ATTN = {"norm": "group_norm", "q": "to_q", "k": "to_k", "v": "to_v",
             "proj_out": "to_out.0"}


def ldm_vae_name(key: str, n_levels: int = 4) -> Optional[str]:
    """An LDM `AutoencoderKL` key (without `first_stage_model.`) → its name
    in the port's `AutoencoderKL`, or None."""
    if key.split(".")[0] in ("quant_conv", "post_quant_conv"):
        return key
    side, _, rest = key.partition(".")
    if side not in ("encoder", "decoder"):
        return None
    layer, _, leaf = rest.rpartition(".")
    if layer in ("conv_in", "conv_out"):
        return key
    if layer == "norm_out":
        return f"{side}.conv_norm_out.{leaf}"
    m = re.fullmatch(r"mid\.(block_[12]|attn_1)\.(\w+)", layer)
    if m:
        blk, sub = m.groups()
        if blk == "attn_1":
            return f"{side}.mid_block.attentions.0.{_VAE_ATTN[sub]}.{leaf}" \
                if sub in _VAE_ATTN else None
        return f"{side}.mid_block.resnets.{int(blk[-1]) - 1}." \
            f"{_VAE_RES.get(sub, sub)}.{leaf}"
    m = re.fullmatch(r"(down|up)\.(\d+)\.(block\.(\d+)\.(\w+)|"
                     r"(down|up)sample\.conv)", layer)
    if not m or (m.group(1) == "down") != (side == "encoder"):
        return None
    level = int(m.group(2))
    bi = level if side == "encoder" else n_levels - 1 - level
    base = f"{side}.{m.group(1)}_blocks.{bi}"
    if m.group(4) is not None:
        sub = m.group(5)
        return f"{base}.resnets.{m.group(4)}.{_VAE_RES.get(sub, sub)}.{leaf}"
    return f"{base}.{m.group(1)}samplers.0.conv.{leaf}"


def ldm_vae_state_dict(sd: dict, n_levels: int = 4,
                       prefix: str = "first_stage_model.") -> dict:
    """The `prefix`ed keys of an LDM checkpoint → the port's `AutoencoderKL`
    state dict; the attention's 1×1-conv kernels become Linear matrices.
    The training loss's keys (`loss.*`) are dropped; any other key without
    a slot raises."""
    out, unused = {}, []
    for key, val in sd.items():
        if not key.startswith(prefix):
            continue
        key = key[len(prefix):]
        if key.startswith("loss."):
            continue
        name = ldm_vae_name(key, n_levels)
        if name is None:
            unused.append(key)
            continue
        if ".attentions.0." in name and val.ndim == 4:
            val = val[:, :, 0, 0]
        out[name] = val
    if unused:
        raise ValueError(f"{len(unused)} keys of the LDM VAE have no slot "
                         f"in the port, e.g. {unused[:4]}")
    return out


# OpenCLIP's residual-block names → transformers' CLIP encoder layers
_OC_BLOCK = {"ln_1": "layer_norm1", "ln_2": "layer_norm2",
             "attn.out_proj": "self_attn.out_proj", "mlp.c_fc": "mlp.fc1",
             "mlp.c_proj": "mlp.fc2"}


def _open_clip_blocks(sd: dict, prefix: str, n_layers: int) -> dict:
    """`prefix` + `transformer.resblocks.{i}.*` for i < n_layers → the
    port's `encoder.layers.{i}.*`, the fused in_proj split into q/k/v."""
    out = {}
    pre = prefix + "transformer.resblocks."
    for key, val in sd.items():
        if not key.startswith(pre):
            continue
        idx, sub = key[len(pre):].split(".", 1)
        if int(idx) >= n_layers:
            continue
        base = f"encoder.layers.{idx}."
        layer, _, leaf = sub.rpartition(".")
        if layer in _OC_BLOCK:
            out[f"{base}{_OC_BLOCK[layer]}.{leaf}"] = val
        elif sub in ("attn.in_proj_weight", "attn.in_proj_bias"):
            leaf = sub.rsplit("_", 1)[1]
            for name, part in zip("qkv", val.chunk(3, dim=0)):
                out[f"{base}self_attn.{name}_proj.{leaf}"] = part
        else:
            raise ValueError(f"OpenCLIP key {key} has no slot in the port")
    return out


def _n_blocks(sd: dict, prefix: str) -> int:
    pre = prefix + "transformer.resblocks."
    return 1 + max(int(k[len(pre):].split(".", 1)[0])
                   for k in sd if k.startswith(pre))


def open_clip_text_state_dict(sd: dict, n_layers: int,
                              prefix: str = "cond_stage_model.model."
                              ) -> dict:
    """An OpenCLIP text tower → the port's `CLIPTextEncoder` state dict of
    its first `n_layers` blocks (FrozenOpenCLIPEmbedder's "penultimate"
    drops the last block and still applies `ln_final`). The projection,
    the logit scale and the attention mask are not parameters of it."""
    out = _open_clip_blocks(sd, prefix, n_layers)
    out["embeddings.token_embedding.weight"] = \
        sd[prefix + "token_embedding.weight"]
    out["embeddings.position_embedding.weight"] = \
        sd[prefix + "positional_embedding"]
    for leaf in ("weight", "bias"):
        out[f"final_layer_norm.{leaf}"] = sd[f"{prefix}ln_final.{leaf}"]
    return out


@torch.no_grad()
def encode_empty_prompt_openclip(sd: dict, hidden: int = 1024,
                                 heads: int = 16, mlp_dim: int = 4096,
                                 total_layers: int = 24,
                                 prefix: str = "cond_stage_model.model.",
                                 device=None) -> torch.Tensor:
    """The empty prompt's hidden states [77, hidden] through the OpenCLIP
    text tower's penultimate layer (what the LDM-era SD2-class pipelines
    condition on): exact-GELU blocks, the empty prompt padded with id 0."""
    from ..clip import CLIPTextConfig, CLIPTextEncoder, empty_prompt_ids
    from .config import load_module
    n = total_layers - 1
    tok = sd[prefix + "token_embedding.weight"]
    cfg = CLIPTextConfig(vocab_size=tok.shape[0], hidden=hidden, layers=n,
                         heads=heads, mlp_dim=mlp_dim,
                         max_positions=sd[prefix + "positional_embedding"]
                         .shape[0], act="gelu")
    model = load_module(lambda: CLIPTextEncoder(cfg),
                        open_clip_text_state_dict(sd, n, prefix), device)
    ids = empty_prompt_ids(cfg.max_positions, pad_token_id=0)
    return model.eval()(ids.to(resolve_device(device)))[0][0]


def open_clip_visual_state_dict(sd: dict,
                                prefix: str = "cond_stage_model.model."
                                "visual.") -> dict:
    """An OpenCLIP ViT visual tower (ImageDream's image encoder) → the
    port's `CLIPVisionEncoder` state dict: `proj` [width, out] is the
    transposed `visual_projection`."""
    out = _open_clip_blocks(sd, prefix, _n_blocks(sd, prefix))
    out.update({
        "embeddings.patch_embedding.weight": sd[prefix + "conv1.weight"],
        "embeddings.class_embedding": sd[prefix + "class_embedding"],
        "embeddings.position_embedding.weight":
            sd[prefix + "positional_embedding"],
        "visual_projection.weight": sd[prefix + "proj"].t().contiguous()})
    for ours, theirs in (("pre_layrnorm", "ln_pre"),
                         ("post_layernorm", "ln_post")):
        for leaf in ("weight", "bias"):
            out[f"{ours}.{leaf}"] = sd[f"{prefix}{theirs}.{leaf}"]
    return out
