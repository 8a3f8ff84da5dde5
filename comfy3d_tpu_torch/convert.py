"""The JAX package's containers and params as numpy arrays → the port's
tensors.

`GaussianSplat` and `Camera` of `comfy3d_tpu/core/{gaussian,camera}.py`
hold their state in six and two arrays, and
`GSTrainState` of `comfy3d_tpu/algorithms/gs_trainer.py` in dicts of arrays;
handing those arrays over (as numpy) gives a port `GaussianSplat` / `Camera`
/ `GSTrainState` with the same state. The JAX package's model params (nested
dicts of arrays) become the port's native-layout state dicts
(`triposr_state_dict_from_flax`, `instantmesh_state_dict_from_flax`,
`mvdream_state_dict_from_flax` (with `resampler_state_dict_from_flax`),
`wonder3d_state_dict_from_flax`, `era3d_state_dict_from_flax`,
`lgm_state_dict_from_flax`, `crm_state_dict_from_flax` (with
`unet2d_state_dict_from_flax`), `t2i_adapter_state_dict_from_flax`,
`zero123plus_state_dict_from_flax`, `clip_vision_state_dict_from_flax`,
`hunyuan3d_shape_state_dict_from_flax` (with `dinov2_`, `shape_vae_` and
`hunyuan3d_dit_state_dict_from_flax`), `hunyuan3d_paint_state_dict_from_flax`
and the per-block functions below
them; `ngp_state_from_flax` for the NeRF
field), so both packages can compute on identical inputs and weights.
"""

from __future__ import annotations

import re
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


# ------------------------------------- the diffusion UNet / VAE, MVDream, LGM
def _modules(tree, path=()):
    """(flax path "a/b/c", its param dict) for every Dense, Conv and norm
    of a flax param tree."""
    if "kernel" in tree or "scale" in tree:
        yield "/".join(path), tree
        return
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _modules(sub, path + (name,))


def _loose(tree, path=()):
    """(flax path, array) for every param a module declared itself (cls
    tokens, position grids, LayerScale, the qk norms' scales): the array
    leaves that are no Dense's, Conv's or norm's."""
    if "kernel" in tree or "scale" in tree:
        return
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _loose(sub, path + (name,))
        else:
            yield "/".join(path + (name,)), np.asarray(sub)


def _module_sd(p) -> dict:
    """A flax Dense {kernel [in, out]}, Conv {kernel [kh, kw, I, O]} or
    norm {scale} (each with its bias) → torch's {weight, bias}: Linear
    [out, in], Conv2d [O, I, kh, kw]."""
    if "scale" in p:
        return _norm(p)
    kernel = np.asarray(p["kernel"])
    if kernel.ndim == 4:
        out = {"weight": np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))}
        if "bias" in p:
            out["bias"] = np.asarray(p["bias"])
        return out
    return _dense(p)


def _rename(path: str, renames) -> str:
    for pattern, repl in renames:
        path = re.sub(pattern, repl, path)
    return path.replace("/", ".")


def _renamed_state_dict(tree, renames) -> dict:
    """Every module of a flax tree under its torch name: the flax path
    with each (regex, replacement) of `renames` applied in order, then
    "/" → "."."""
    sd = {}
    for path, p in _modules(tree):
        sd.update(_join(_rename(path, renames), _module_sd(p)))
    return sd


def _renamed_params(tree, renames) -> dict:
    """`_renamed_state_dict`, and every `_loose` param renamed alike."""
    return {**_renamed_state_dict(tree, renames),
            **{_rename(path, renames): a for path, a in _loose(tree)}}


def _tensors(sd) -> dict:
    return {k: torch.as_tensor(np.array(v, np.float32)) for k, v in sd.items()}


# the JAX package's transformer-block names → diffusers'
_TRANSFORMER_RENAMES = (
    (r"blocks_(\d+)", r"transformer_blocks.\1"),
    (r"to_out_0", "to_out.0"),
    (r"ff_net_0/proj", "ff.net.0.proj"),
    (r"ff_net_2", "ff.net.2"),
)
_UNET_RENAMES = (
    (r"^(down|up)_(\d+)_res_(\d+)", r"\1_blocks.\2.resnets.\3"),
    (r"^(down|up)_(\d+)_attn_(\d+)", r"\1_blocks.\2.attentions.\3"),
    (r"^down_(\d+)_downsample", r"down_blocks.\1.downsamplers.0"),
    (r"^up_(\d+)_upsample", r"up_blocks.\1.upsamplers.0"),
    (r"^mid_res_(\d+)", r"mid_block.resnets.\1"),
    (r"^mid_attn", "mid_block.attentions.0"),
    (r"^time_emb_(\d)", r"time_embedding.linear_\1"),
    (r"^norm_out", "conv_norm_out"),
) + _TRANSFORMER_RENAMES
_VAE_RENAMES = (
    (r"^encoder/quant_conv", "quant_conv"),
    (r"^decoder/post_quant_conv", "post_quant_conv"),
    (r"/(down|up)_(\d+)_res_(\d+)", r"/\1_blocks.\2.resnets.\3"),
    (r"/down_(\d+)_downsample", r"/down_blocks.\1.downsamplers.0.conv"),
    (r"/up_(\d+)_upsample", r"/up_blocks.\1.upsamplers.0.conv"),
    (r"/mid_res_(\d+)", r"/mid_block.resnets.\1"),
    (r"/mid_attn", "/mid_block.attentions.0"),
    (r"/norm_out", "/conv_norm_out"),
    (r"to_out_0", "to_out.0"),
)
_LGM_RENAMES = (
    (r"^(down|up)_(\d+)_res_(\d+)", r"\1_blocks.\2.nets.\3"),
    (r"^(down|up)_(\d+)_attn_(\d+)", r"\1_blocks.\2.attns.\3"),
    (r"^(down|up)_(\d+)_(down|up)sample", r"\1_blocks.\2.\3sample"),
    (r"^mid_res_(\d+)", r"mid_block.nets.\1"),
    (r"^mid_attn", "mid_block.attns.0"),
    (r"/(qkv|proj)$", r"/attn.\1"),
)


def unet_state_dict_from_flax(params) -> dict:
    """The JAX package's `UNet2DCondition` params → the port's state dict
    (diffusers' `UNet2DConditionModel` names), torch tensors on the CPU."""
    return _tensors(_renamed_state_dict(params, _UNET_RENAMES))


def vae_state_dict_from_flax(params) -> dict:
    """The JAX package's `AutoencoderKL` params → the port's state dict
    (diffusers' `AutoencoderKL` names)."""
    return _tensors(_renamed_state_dict(params, _VAE_RENAMES))


# the JAX package's Resampler names → ImageDream's checkpoint's
_RESAMPLER_RENAMES = (
    (r"^layers_(\d+)_attn", r"layers.\1.0"),
    (r"^layers_(\d+)_norm", r"layers.\1.1.0"),
    (r"^layers_(\d+)_fc1", r"layers.\1.1.1"),
    (r"^layers_(\d+)_fc2", r"layers.\1.1.3"),
)


def resampler_state_dict_from_flax(params) -> dict:
    """The JAX package's ImageDream `Resampler` params → the port's
    `Resampler` state dict (the checkpoint's `image_embed.*` names without
    the prefix: `latents`, `proj_in`, `layers.{i}.0.*` the perceiver
    attention, `layers.{i}.1.{0,1,3}` the feed-forward, `proj_out`,
    `norm_out`)."""
    return _tensors(_renamed_params(params, _RESAMPLER_RENAMES))


def mvdream_state_dict_from_flax(params) -> dict:
    """The JAX package's MVDream params, `{"unet", "vae", "camera"}` and for
    ImageDream `"resampler"` → the port's `MVDream` state dict: `unet.*`
    (with the cross-attentions' `to_k_ip` / `to_v_ip`), `vae.*`,
    `camera_embed.{0,2}` (MVDream's camera MLP) and `image_embed.*`."""
    cam = params["camera"]
    sd = {**_join("unet", unet_state_dict_from_flax(params["unet"])),
          **_join("vae", vae_state_dict_from_flax(params["vae"])),
          **_tensors({**_join("camera_embed.0", _dense(cam["linear_1"])),
                      **_join("camera_embed.2", _dense(cam["linear_2"]))})}
    if "resampler" in params:
        sd.update(_join("image_embed", resampler_state_dict_from_flax(
            params["resampler"])))
    return sd


def _mlp_state_dict(p) -> dict:
    """A flax Dense-SiLU-Dense {linear_1, linear_2} → diffusers'
    `TimestepEmbedding` names."""
    return _tensors({**_join("linear_1", _dense(p["linear_1"])),
                     **_join("linear_2", _dense(p["linear_2"]))})


def wonder3d_state_dict_from_flax(params) -> dict:
    """The JAX package's Wonder3D params, `{"unet", "vae", "class_mlp"}` →
    the port's `Wonder3D` state dict: `unet.*` (with the blocks'
    `attn_joint_mid` / `norm_joint_mid` and the projection class embedding
    `unet.class_embedding.linear_{1,2}`) and `vae.*`."""
    return {**_join("unet", unet_state_dict_from_flax(params["unet"])),
            **_join("unet.class_embedding",
                    _mlp_state_dict(params["class_mlp"])),
            **_join("vae", vae_state_dict_from_flax(params["vae"]))}


# the JAX package's ResidualLiner names → Era3D's checkpoint's
_REGRESSOR_RENAMES = (
    (r"^linear_in_0", "linear_in.0"),
    (r"^blocks_(\d+)_(linear[12])", r"blocks.\1.\2"),
)


def era3d_state_dict_from_flax(params) -> dict:
    """The JAX package's Era3D params, `{"unet", "vae", "class_mlp",
    "camera_mlp"[, "elevation_reg", "focal_reg"]}` → the port's `Era3D`
    state dict: `unet.*` (with the row-wise blocks' `attn_mv` / `norm_mv`,
    `unet.class_embedding`, `unet.camera_embedding` and the regressors
    `unet.{elevation,focal}_regressor.*`) and `vae.*`."""
    sd = {**_join("unet", unet_state_dict_from_flax(params["unet"])),
          **_join("unet.class_embedding",
                  _mlp_state_dict(params["class_mlp"])),
          **_join("unet.camera_embedding",
                  _mlp_state_dict(params["camera_mlp"])),
          **_join("vae", vae_state_dict_from_flax(params["vae"]))}
    for key, name in (("elevation_reg", "elevation_regressor"),
                      ("focal_reg", "focal_regressor")):
        if key in params:
            sd.update(_join(f"unet.{name}", _tensors(_renamed_state_dict(
                params[key], _REGRESSOR_RENAMES))))
    return sd


# the JAX package's UNet2DModel names → diffusers'
_UNET2D_RENAMES = (
    (r"^(down|up)_(\d+)_res_(\d+)", r"\1_blocks.\2.resnets.\3"),
    (r"^(down|up)_(\d+)_attn_(\d+)", r"\1_blocks.\2.attentions.\3"),
    (r"^down_(\d+)_down$", r"down_blocks.\1.downsamplers.0.conv"),
    (r"^up_(\d+)_up$", r"up_blocks.\1.upsamplers.0.conv"),
    (r"^mid_res_(\d+)", r"mid_block.resnets.\1"),
    (r"^mid_attn", "mid_block.attentions.0"),
    (r"^time_(\d)$", r"time_embedding.linear_\1"),
    (r"to_out_0", "to_out.0"),
)
_CRM_MLPS = {"sdf_0": "sdfMlp.fc1", "sdf_1": "sdfMlp.fc2",
             "sdf_2": "sdfMlp.fc3", "rgb_0": "rgbMlp.fc1",
             "rgb_1": "rgbMlp.fc2", "rgb_2": "rgbMlp.fc3",
             "weight_0": "weightMlp.0", "weight_1": "weightMlp.2"}


def unet2d_state_dict_from_flax(params) -> dict:
    """The JAX package's CRM `UNet2DModel` params → the port's state dict
    (diffusers' `UNet2DModel` names)."""
    return _tensors(_renamed_state_dict(params, _UNET2D_RENAMES))


def crm_state_dict_from_flax(params) -> dict:
    """The JAX package's `CRMModel` params → the port's `CRMModel` state
    dict in `CRM.pth`'s names: `unet2.unet.*`, `unet2.learned_plane`
    [1, C, P, 3P] (from [P, 3P, C]), `sdfMlp`, `rgbMlp`, `weightMlp`."""
    sd = _join("unet2.unet", unet2d_state_dict_from_flax(params["unet2"]))
    if "learned_plane" in params:
        sd["unet2.learned_plane"] = torch.as_tensor(np.ascontiguousarray(
            np.asarray(params["learned_plane"], np.float32)
            .transpose(2, 0, 1)[None]))
    for name, torch_name in _CRM_MLPS.items():
        sd.update(_tensors(_join(torch_name, _dense(params[name]))))
    return sd


def t2i_adapter_state_dict_from_flax(params) -> dict:
    """The JAX package's `T2IAdapter` params → the port's `T2IAdapter` state
    dict (the diffusers `T2IAdapterV2` checkpoint's `adapter.*` names)."""
    def name(path):
        m = re.fullmatch(r"enc_(mid|down)_(\d+)", path)
        if m:
            n = 2 * int(m.group(2)) + (m.group(1) == "down")
            return f"conv2d_img_encoder.blocks.{n}"
        m = re.fullmatch(r"enc_conv_(in|out)", path)
        if m:
            return f"conv2d_img_encoder.conv_{m.group(1)}"
        m = re.fullmatch(r"in_conv_(\d+)", path)
        if m:
            return f"body.{m.group(1)}.in_conv"
        b, r, blk = re.fullmatch(r"res_(\d+)_(\d+)/(block[12])",
                                 path).groups()
        return f"body.{b}.resnets.{r}.{blk}"

    return _tensors({f"adapter.{name(path)}.{k}": v
                     for path, p in _modules(params)
                     for k, v in _module_sd(p).items()})


def zero123plus_state_dict_from_flax(params) -> dict:
    """The JAX package's Zero123Plus params, `{"unet", "vae"}` → the port's
    `Zero123Plus` state dict: `unet.*` and `vae.*` (diffusers' names)."""
    return {**_join("unet", unet_state_dict_from_flax(params["unet"])),
            **_join("vae", vae_state_dict_from_flax(params["vae"]))}


# the JAX package's CLIP vision names → a CLIPVisionModelWithProjection's
# (without its `vision_model.` prefix)
_CLIP_RENAMES = (
    (r"^patch_embedding", "embeddings.patch_embedding"),
    (r"^layers_(\d+)/(q|k|v|out)_proj",
     r"encoder.layers.\1.self_attn.\2_proj"),
    (r"^layers_(\d+)/(fc\d)", r"encoder.layers.\1.mlp.\2"),
    (r"^layers_(\d+)/", r"encoder.layers.\1."),
)


def clip_vision_state_dict_from_flax(params) -> dict:
    """The JAX package's `CLIPVisionEncoder` params → the port's
    `CLIPVisionEncoder` state dict (HF names, `models/clip.py`)."""
    modules = {k: v for k, v in params.items()
               if k not in ("class_embedding", "position_embedding")}
    return _tensors({
        **_renamed_state_dict(modules, _CLIP_RENAMES),
        "embeddings.class_embedding": np.asarray(params["class_embedding"]),
        "embeddings.position_embedding.weight": np.asarray(
            params["position_embedding"])})


def clip_text_state_dict_from_flax(params) -> dict:
    """The JAX package's `CLIPTextEncoder` params → the port's
    `CLIPTextEncoder` state dict (a `CLIPTextModel`'s names without its
    `text_model.` prefix, `models/clip.py`)."""
    modules = {k: v for k, v in params.items()
               if k not in ("token_embedding", "position_embedding")}
    return _tensors({
        **_renamed_state_dict(modules, _CLIP_RENAMES),
        "embeddings.token_embedding.weight": np.asarray(
            params["token_embedding"]),
        "embeddings.position_embedding.weight": np.asarray(
            params["position_embedding"])})


def lgm_state_dict_from_flax(params) -> dict:
    """The JAX package's `LGMUNet` params → the port's `LGMUNet` state dict
    in LGM's checkpoint names (`unet.*` and the trailing 1×1 `conv.*`)."""
    body = {k: v for k, v in params.items() if k != "conv_final"}
    return _tensors({
        **_join("unet", _renamed_state_dict(body, _LGM_RENAMES)),
        **_join("conv", _module_sd(params["conv_final"]))})


def ngp_state_from_flax(params) -> dict:
    """The JAX package's NeRF params (`algorithms/ngp.py::init_params`:
    `table` [L, T, F] and the dense layers `sig1`, `sig2`, `col1`, `col2`
    with `w` [in, out] and `b`) → `NGPField`'s state dict, numpy arrays."""
    sd = {"table": np.array(params["table"], np.float32)}
    for name in ("sig1", "sig2", "col1", "col2"):
        sd[f"{name}.weight"] = np.array(params[name]["w"], np.float32).T
        sd[f"{name}.bias"] = np.array(params[name]["b"], np.float32)
    return sd


# ------------------------------------------------ DINOv2, the vecset models
# the JAX package's DINOv2 names → `transformers.Dinov2Model`'s
_DINOV2_RENAMES = (
    (r"^patch_embed$", "embeddings.patch_embeddings.projection"),
    (r"^cls_token$", "embeddings.cls_token"),
    (r"^pos_embed$", "embeddings.position_embeddings"),
    (r"^register_tokens$", "embeddings.register_tokens"),
    (r"^ln_final$", "layernorm"),
    (r"^layer_(\d+)/(layer_scale\d)$", r"encoder.layer.\1.\2.lambda1"),
    (r"^layer_(\d+)/(query|key|value)$",
     r"encoder.layer.\1.attention.attention.\2"),
    (r"^layer_(\d+)/attn_out$", r"encoder.layer.\1.attention.output.dense"),
    (r"^layer_(\d+)/(fc\d|weights_in|weights_out)$",
     r"encoder.layer.\1.mlp.\2"),
    (r"^layer_(\d+)/(norm\d)_mod$",
     r"encoder.layer.\1.\2_modulation.linear2"),
    (r"^layer_(\d+)/", r"encoder.layer.\1."),
)
# the vecset VAE's: resblocks_i → resblocks.i, the qk LayerNorms'
# q_norm_scale → attention.q_norm.weight
_SHAPE_VAE_RENAMES = (
    (r"resblocks_(\d+)", r"resblocks.\1"),
    (r"(q|k)_norm_scale$", r"attention.\1_norm.weight"),
    (r"(q|k)_norm_bias$", r"attention.\1_norm.bias"),
)
# the DiT's: the upstream module paths the JAX package flattened with "_"
_DIT_RENAMES = (
    (r"^(double|single)_blocks_(\d+)", r"\1_blocks.\2"),
    (r"(img|txt)_mod_lin", r"\1_mod.lin"),
    (r"(img|txt)_attn_(qkv|proj|norm)", r"\1_attn.\2"),
    (r"(img|txt)_mlp_(\d)", r"\1_mlp.\2"),
    (r"modulation_lin", "modulation.lin"),
    (r"adaLN_modulation_1", "adaLN_modulation.1"),
    (r"(query|key)_norm_scale$", r"\1_norm.scale"),
)


def dinov2_state_dict_from_flax(params) -> dict:
    """The JAX package's `Dinov2` params → the port's `Dinov2` state dict
    (`transformers.Dinov2Model` names). HF's `mask_token`, which the JAX
    model lacks and nothing reads, gets zeros, and so does the final
    LayerNorm of a `return_prenorm` model (weight 1, bias 0)."""
    sd = _renamed_params(params, _DINOV2_RENAMES)
    h = sd["embeddings.cls_token"].shape[-1]
    sd["embeddings.mask_token"] = np.zeros((1, h), np.float32)
    sd.setdefault("layernorm.weight", np.ones((h,), np.float32))
    sd.setdefault("layernorm.bias", np.zeros((h,), np.float32))
    return _tensors(sd)


def shape_vae_state_dict_from_flax(params) -> dict:
    """The JAX package's `ShapeVAE` params → the port's `ShapeVAE` state
    dict (upstream names: `post_kl`, `transformer.resblocks.{i}`,
    `geo_decoder.*`)."""
    return _tensors(_renamed_params(params, _SHAPE_VAE_RENAMES))


def hunyuan3d_dit_state_dict_from_flax(params) -> dict:
    """The JAX package's `Hunyuan3DDiT` params → the port's state dict
    (upstream names: `double_blocks.{i}.img_attn.qkv`, …)."""
    return _tensors(_renamed_params(params, _DIT_RENAMES))


def hunyuan3d_shape_state_dict_from_flax(params) -> dict:
    """The JAX package's Hunyuan3D shape params, `{"cond", "dit", "vae"}` →
    the port's `Hunyuan3DShape` state dict: `cond.*`, `dit.*`, `vae.*`."""
    return {**_join("cond", dinov2_state_dict_from_flax(params["cond"])),
            **_join("dit", hunyuan3d_dit_state_dict_from_flax(params["dit"])),
            **_join("vae", shape_vae_state_dict_from_flax(params["vae"]))}


def hunyuan3d_paint_state_dict_from_flax(params,
                                         pbr_settings=("albedo", "mr")
                                         ) -> dict:
    """The JAX package's Hunyuan3D paint params, `{"unet", "unet_dual",
    "vae", "cls", "text_gen", "text_ref"[, "attr_embeds"]}` → the port's
    `Hunyuan3DPaint` state dict: `unet.*` (its 2.5D blocks'
    `attn_multiview` / `attn_refview` under the blocks' names, the camera
    table `unet.class_embedding`, the learned tokens
    `unet.learned_text_clip_{gen,ref}` and, one per name of `pbr_settings`,
    `unet.learned_text_clip_{attr}` from `attr_embeds`), `unet_dual.*` and
    `vae.*`."""
    tokens = {"gen": params["text_gen"], "ref": params["text_ref"]}
    if "attr_embeds" in params:
        attr = np.asarray(params["attr_embeds"])
        if len(attr) != len(pbr_settings):
            raise ValueError(f"{len(attr)} attribute token sets for "
                             f"{pbr_settings}")
        tokens.update(zip(pbr_settings, attr))
    unet = {**unet_state_dict_from_flax(params["unet"]),
            **_tensors({"class_embedding.weight":
                        np.asarray(params["cls"]["embedding"]),
                        **{f"learned_text_clip_{k}": np.asarray(v)
                           for k, v in tokens.items()}})}
    return {**_join("unet", unet),
            **_join("unet_dual", unet_state_dict_from_flax(
                params["unet_dual"])),
            **_join("vae", vae_state_dict_from_flax(params["vae"]))}


# ------------------------------------------------------------------ TripoSG
def _unrepack_heads(kernels, heads: int):
    """The JAX package's per-module flax kernels [in, d] of q, k, v (or k,
    v) → upstream's, whose concatenation its attention splits head first
    (the inverse of `comfy3d_tpu/models/triposg/convert.py::
    _repack_heads`)."""
    kers = [np.asarray(k) for k in kernels]
    din, d = kers[0].shape
    packed = np.stack([k.reshape(din, heads, d // heads) for k in kers], 2)
    cat = packed.reshape(din, len(kers) * d)
    return [cat[:, i * d:(i + 1) * d] for i in range(len(kers))]


def _triposg_block_state_dict(p, heads: int) -> dict:
    """One flax `DiTBlock` → upstream's names (norm1/attn1, norm2/attn2
    with norm_cross, norm3/ff, skip_linear/skip_norm), the attention
    kernels un-repacked."""
    sd = {}
    for n in ("norm1", "norm2", "norm3", "skip_norm", "skip_linear"):
        if n in p:
            sd.update(_join(n, _module_sd(p[n])))
    for a in ("attn1", "attn2"):
        if a not in p:
            continue
        ap = p[a]
        names = ("to_q", "to_k", "to_v") if a == "attn1" else ("to_k", "to_v")
        for m, k in zip(names, _unrepack_heads(
                [ap[m]["kernel"] for m in names], heads)):
            sd[f"{a}.{m}.weight"] = np.ascontiguousarray(k.T)
        if a == "attn2":
            sd.update(_join(f"{a}.to_q", _dense(ap["to_q"])))
        sd.update(_join(f"{a}.to_out.0", _dense(ap["to_out_0"])))
        for q in ("q", "k"):
            if f"norm_{q}_scale" in ap:
                sd[f"{a}.norm_{q}.weight"] = np.asarray(ap[f"norm_{q}_scale"])
        if "norm_cross" in ap:
            sd.update(_join(f"{a}.norm_cross", _norm(ap["norm_cross"])))
    sd.update(_join("ff.net.0.proj", _dense(p["ff_0"])))
    sd.update(_join("ff.net.2", _dense(p["ff_2"])))
    return sd


def triposg_dit_state_dict_from_flax(params, heads: int) -> dict:
    """The JAX package's `TripoSGDiT` params → upstream's
    `TripoSGDiTModel` names (`time_proj.linear_{1,2}`, `proj_in`,
    `blocks.{i}.*`, `norm_out`, `proj_out`)."""
    sd = {}
    for flax_name, name in (("proj_in", "proj_in"), ("proj_out", "proj_out"),
                            ("time_proj_linear_1", "time_proj.linear_1"),
                            ("time_proj_linear_2", "time_proj.linear_2"),
                            ("norm_out", "norm_out")):
        sd.update(_join(name, _module_sd(params[flax_name])))
    for key, p in params.items():
        m = re.fullmatch(r"blocks_(\d+)", key)
        if m:
            sd.update(_join(f"blocks.{m.group(1)}",
                            _triposg_block_state_dict(p, heads)))
    return _tensors(sd)


def triposg_vae_state_dict_from_flax(params, heads: int) -> dict:
    """The JAX package's `TripoSGVAE` params → upstream's
    `TripoSGVAEModel` names (`encoder.{proj_in, blocks.{i}, norm_out}`,
    `quant`, `post_quant`, `decoder.{blocks.{i}, proj_query, norm_out,
    proj_out}`, the query block last of `decoder.blocks`); the encoder's
    only where the flax tree has it (its `init` traces no encode)."""
    names = {"enc_proj_in": "encoder.proj_in",
             "enc_norm_out": "encoder.norm_out", "quant": "quant",
             "post_quant": "post_quant", "proj_query": "decoder.proj_query",
             "dec_norm_out": "decoder.norm_out",
             "proj_out": "decoder.proj_out"}
    sd = {}
    for flax_name, name in names.items():
        if flax_name in params:
            sd.update(_join(name, _module_sd(params[flax_name])))
    n_dec = sum(1 for k in params if re.fullmatch(r"dec_blocks_\d+", k))
    for key, p in params.items():
        m = re.fullmatch(r"(enc|dec)_blocks_(\d+)", key)
        if m:
            stage = "encoder" if m.group(1) == "enc" else "decoder"
            name = f"{stage}.blocks.{m.group(2)}"
        elif key == "dec_query_block":
            name = f"decoder.blocks.{n_dec}"
        else:
            continue
        sd.update(_join(name, _triposg_block_state_dict(p, heads)))
    return _tensors(sd)


def triposg_state_dict_from_flax(params, dit_heads: int,
                                 vae_heads: int) -> dict:
    """The JAX package's TripoSG params, `{"cond", "dit", "vae"}` → the
    port's `TripoSG` state dict in upstream's names: `cond.*`
    (`transformers.Dinov2Model`), `dit.*` (`TripoSGDiTModel`) and `vae.*`
    (`TripoSGVAEModel`), the attention kernels in upstream's head-major
    packing, so that the JAX loader reads files written from it."""
    return {**_join("cond", dinov2_state_dict_from_flax(params["cond"])),
            **_join("dit", triposg_dit_state_dict_from_flax(params["dit"],
                                                            dit_heads)),
            **_join("vae", triposg_vae_state_dict_from_flax(params["vae"],
                                                            vae_heads))}
