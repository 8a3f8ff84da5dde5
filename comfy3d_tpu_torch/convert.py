"""The JAX package's containers and params as numpy arrays → the port's
tensors.

`GaussianSplat` and `Camera` of `comfy3d_tpu/core/{gaussian,camera}.py`
hold their state in six and two arrays, and
`GSTrainState` of `comfy3d_tpu/algorithms/gs_trainer.py` in dicts of arrays;
handing those arrays over (as numpy) gives a port `GaussianSplat` / `Camera`
/ `GSTrainState` with the same state. The JAX package's model params (nested
dicts of arrays) become the port's native-layout state dicts
(`triposr_state_dict_from_flax`, `instantmesh_state_dict_from_flax` and
the per-block functions below them), so both packages can compute on
identical inputs and weights.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .algorithms.gs_trainer import PARAMS, GSTrainState
from .core.camera import Camera
from .core.gaussian import GaussianSplat

SPLAT_FIELDS = ("xyz", "sh", "opacity_raw", "scale_raw", "rot_raw", "alive")


def splat_from_numpy(arrays: Mapping[str, np.ndarray],
                     device) -> GaussianSplat:
    """arrays: the six GaussianSplat fields by name (xyz [N,3], sh [N,K,3],
    opacity_raw [N], scale_raw [N,3], rot_raw [N,4] wxyz, alive [N])."""
    missing = [f for f in SPLAT_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"splat arrays lack {missing}")
    out = {}
    for f in SPLAT_FIELDS:
        a = np.array(arrays[f], dtype=bool if f == "alive" else np.float32)
        out[f] = torch.as_tensor(a, device=device)
    return GaussianSplat(**out)


def camera_from_numpy(c2w, fovy_deg, width: int, height: int,
                      near: float, far: float, device) -> Camera:
    """c2w [..., 4, 4] and fovy_deg [...] of a JAX Camera, plus its static
    fields."""
    c2w = torch.as_tensor(np.array(c2w, np.float32), device=device)
    fov = torch.as_tensor(np.array(fovy_deg, np.float32), device=device)
    return Camera(c2w=c2w, fovy_deg=fov.expand(c2w.shape[:-2]).clone(),
                  width=int(width), height=int(height), near=float(near),
                  far=float(far))


def train_state_from_numpy(state: Mapping, device) -> GSTrainState:
    """state: a trainer state's fields by name — `params`, `adam_m`, `adam_v`
    (dicts of the five parameter arrays xyz, sh, opacity_raw, scale_raw,
    rot_raw), `alive` [cap], `grad_accum`, `denom`, `max_radii` [cap] and
    `step`."""
    def f32(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=device)

    def tree(d):
        missing = [k for k in PARAMS if k not in d]
        if missing:
            raise KeyError(f"parameter arrays lack {missing}")
        return {k: f32(d[k]) for k in PARAMS}

    return GSTrainState(
        params=tree(state["params"]), adam_m=tree(state["adam_m"]),
        adam_v=tree(state["adam_v"]),
        alive=torch.as_tensor(np.array(state["alive"], dtype=bool),
                              device=device),
        grad_accum=f32(state["grad_accum"]), denom=f32(state["denom"]),
        max_radii=f32(state["max_radii"]), step=int(state["step"]))


# ------------------------------------------------------------------ #
# the JAX package's model params (numpy) → native torch state dicts
# ------------------------------------------------------------------ #
def _join(prefix: str, sd: Mapping) -> dict:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def _dense(p) -> dict:
    """A JAX Dense {kernel [in, out], bias} → nn.Linear {weight, bias}."""
    out = {"weight": np.ascontiguousarray(np.asarray(p["kernel"]).T)}
    if "bias" in p:
        out["bias"] = np.asarray(p["bias"])
    return out


def _norm(p) -> dict:
    return {"weight": np.asarray(p["scale"]), "bias": np.asarray(p["bias"])}


def attention_state_dict_from_flax(p) -> dict:
    sd = {}
    for name in ("to_q", "to_k", "to_v"):
        sd.update(_join(name, _dense(p[name])))
    sd.update(_join("to_out.0", _dense(p["to_out_0"])))
    return sd


def feedforward_state_dict_from_flax(p) -> dict:
    return {**_join("net.0.proj", _dense(p["net_0"]["proj"])),
            **_join("net.2", _dense(p["net_2"]))}


def basic_block_state_dict_from_flax(p) -> dict:
    sd = {}
    for name in ("norm1", "norm2", "norm3"):
        if name in p:
            sd.update(_join(name, _norm(p[name])))
    for name in ("attn1", "attn2"):
        if name in p:
            sd.update(_join(name, attention_state_dict_from_flax(p[name])))
    sd.update(_join("ff", feedforward_state_dict_from_flax(p["ff"])))
    return sd


def transformer1d_state_dict_from_flax(p) -> dict:
    sd = {**_join("norm", _norm(p["norm"])),
          **_join("proj_in", _dense(p["proj_in"])),
          **_join("proj_out", _dense(p["proj_out"]))}
    i = 0
    while f"blocks_{i}" in p:
        sd.update(_join(f"transformer_blocks.{i}",
                        basic_block_state_dict_from_flax(p[f"blocks_{i}"])))
        i += 1
    return sd


def vit_self_attention_state_dict_from_flax(p) -> dict:
    sd = {}
    for name in ("query", "key", "value"):
        sd.update(_join(f"attention.{name}", _dense(p[name])))
    sd.update(_join("output.dense", _dense(p["out"])))
    return sd


def vit_block_state_dict_from_flax(p) -> dict:
    return {**_join("layernorm_before", _norm(p["ln1"])),
            **_join("attention",
                    vit_self_attention_state_dict_from_flax(p["attn"])),
            **_join("layernorm_after", _norm(p["ln2"])),
            **_join("intermediate.dense", _dense(p["mlp_in"])),
            **_join("output.dense", _dense(p["mlp_out"]))}


def vit_state_dict_from_flax(p) -> dict:
    """HF's pooler.dense, which the JAX model lacks and no output reads,
    gets zero weights, so the port's ViT loads strictly."""
    kernel = np.asarray(p["patch_embed"]["kernel"])       # [kh, kw, I, O]
    sd = {"embeddings.cls_token": np.asarray(p["cls_token"]),
          "embeddings.position_embeddings": np.asarray(p["pos_embed"]),
          "embeddings.patch_embeddings.projection.weight":
              np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)),
          "embeddings.patch_embeddings.projection.bias":
              np.asarray(p["patch_embed"]["bias"]),
          **_join("layernorm", _norm(p["ln_final"]))}
    i = 0
    while f"block_{i}" in p:
        sd.update(_join(f"encoder.layer.{i}",
                        vit_block_state_dict_from_flax(p[f"block_{i}"])))
        i += 1
    h = sd["embeddings.cls_token"].shape[-1]
    sd["pooler.dense.weight"] = np.zeros((h, h), np.float32)
    sd["pooler.dense.bias"] = np.zeros((h,), np.float32)
    return sd


def _conv_transpose(p) -> dict:
    """A JAX ConvTranspose {kernel [kh, kw, I, O], bias} → torch's
    ConvTranspose2d {weight [I, O, kh, kw], bias}: flax applies the kernel
    unflipped, torch as the gradient of a convolution."""
    kernel = np.asarray(p["kernel"])[::-1, ::-1]
    return {"weight": np.ascontiguousarray(kernel.transpose(2, 3, 0, 1)),
            "bias": np.asarray(p["bias"])}


def triposr_state_dict_from_flax(params) -> dict:
    """The JAX package's TripoSR params → the port's `TripoSR` state dict
    (torch tensors on the CPU), the inverse of that package's
    `_convert_triposr`: Dense kernels transposed, the ConvTranspose kernel
    [kh, kw, I, O] flipped back to torch's [I, O, kh, kw], the triplane
    tokens [3, P, P, C] → [3, C, P, P], the decoder's layer_i / layer_out
    → layers.{0, 2, …}."""
    sd = _join("image_tokenizer.model",
               vit_state_dict_from_flax(params["vit"]))
    sd["tokenizer.embeddings"] = np.ascontiguousarray(
        np.asarray(params["triplane_tokens"]).transpose(0, 3, 1, 2))
    sd.update(_join("backbone",
                    transformer1d_state_dict_from_flax(params["backbone"])))
    sd.update(_join("post_processor.upsample",
                    _conv_transpose(params["post"]["upsample"])))
    dec = params["decoder"]
    n_hidden = sum(1 for k in dec if k.startswith("layer_")
                   and k != "layer_out")
    for i in range(n_hidden + 1):
        name = "layer_out" if i == n_hidden else f"layer_{i}"
        sd.update(_join(f"decoder.layers.{2 * i}", _dense(dec[name])))
    return {k: torch.as_tensor(np.array(v, np.float32)) for k, v in sd.items()}


# ------------------------------------------------------------ InstantMesh
def vit_adaln_block_state_dict_from_flax(p) -> dict:
    """`ViTBlockAdaLN`: a ViT block plus its `adaln` head."""
    return {**vit_block_state_dict_from_flax(p),
            **_join("adaLN_modulation.1", _dense(p["adaln"]))}


def dino_adaln_state_dict_from_flax(p) -> dict:
    """`DinoAdaLN`: the ViT (no pooler) under `model`, adaLN heads in its
    blocks, and `camera_embedder.{0,2}`."""
    sd = {k: v for k, v in vit_state_dict_from_flax(p).items()
          if not k.startswith("pooler.")}
    i = 0
    while f"block_{i}" in p:
        sd.update(_join(f"encoder.layer.{i}",
                        vit_adaln_block_state_dict_from_flax(p[f"block_{i}"])))
        i += 1
    return {**_join("model", sd),
            **_join("camera_embedder.0", _dense(p["cam_embed_0"])),
            **_join("camera_embedder.2", _dense(p["cam_embed_1"]))}


def lrm_block_state_dict_from_flax(p) -> dict:
    """`LRMBlock`: `nn.MultiheadAttention`'s keys — the cross-attention's
    separate `{q,k,v}_proj_weight`, the self-attention's packed
    `in_proj_weight`, `out_proj.weight` — and `mlp.{0,3}`."""
    def t(name, sub):
        return np.ascontiguousarray(np.asarray(p[name][sub]["kernel"]).T)

    sd = {}
    for name in ("norm1", "norm2", "norm3"):
        sd.update(_join(name, _norm(p[name])))
    for x in "qkv":
        sd[f"cross_attn.{x}_proj_weight"] = t("cross_attn", f"to_{x}")
    sd["self_attn.in_proj_weight"] = np.concatenate(
        [t("self_attn", f"to_{x}") for x in "qkv"], 0)
    for name in ("cross_attn", "self_attn"):
        sd[f"{name}.out_proj.weight"] = t(name, "to_out_0")
    sd.update(_join("mlp.0", _dense(p["mlp_in"])))
    sd.update(_join("mlp.3", _dense(p["mlp_out"])))
    return sd


def triplane_transformer_state_dict_from_flax(p) -> dict:
    sd = {"pos_embed": np.asarray(p["pos_embed"]),
          **_join("norm", _norm(p["norm"])),
          **_join("deconv", _conv_transpose(p["deconv"]))}
    i = 0
    while f"layer_{i}" in p:
        sd.update(_join(f"layers.{i}",
                        lrm_block_state_dict_from_flax(p[f"layer_{i}"])))
        i += 1
    return sd


_OSG_HEADS = {"sdf": "net_sdf", "deform": "net_deformation",
              "rgb": "net_rgb", "weight": "net_weight"}


def osg_decoder_state_dict_from_flax(p) -> dict:
    """`OSGDecoder`: each head's `{prefix}_{i}` / `{prefix}_out` Dense →
    `net_*.{0, 2, …}`; heads the params lack are left out."""
    sd = {}
    for prefix, net in _OSG_HEADS.items():
        if prefix + "_out" not in p:
            continue
        n_hidden = sum(1 for k in p if k.startswith(prefix + "_")) - 1
        for i in range(n_hidden + 1):
            name = f"{prefix}_out" if i == n_hidden else f"{prefix}_{i}"
            sd.update(_join(f"{net}.{2 * i}", _dense(p[name])))
    return sd


def instantmesh_state_dict_from_flax(params) -> dict:
    """The JAX package's InstantMesh params → the port's `InstantMesh`
    state dict (torch tensors on the CPU), in the upstream checkpoint's
    names: `encoder.*`, `transformer.*`, `synthesizer.decoder.*`."""
    sd = {**_join("encoder", dino_adaln_state_dict_from_flax(
              params["encoder"])),
          **_join("transformer", triplane_transformer_state_dict_from_flax(
              params["transformer"])),
          **_join("synthesizer.decoder", osg_decoder_state_dict_from_flax(
              params["decoder"]))}
    return {k: torch.as_tensor(np.array(v, np.float32)) for k, v in sd.items()}
