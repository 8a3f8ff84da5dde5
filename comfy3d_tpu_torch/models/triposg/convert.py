"""TripoSG's native checkpoint directory → the port's `TripoSG`.

Port of `comfy3d_tpu/models/triposg/convert.py::load_triposg_dir`: upstream's
diffusers-style layout, `transformer/` (TripoSGDiTModel), `vae/`
(TripoSGVAEModel) and `image_encoder_dinov2/` (facebook/dinov2-large), each
a config.json beside its weights. The configs are read with the JAX
package's keys and defaults; the weights load strictly under their own
names (the modules split heads as upstream does, so nothing is repacked);
without `image_encoder_dinov2/` the conditioner keeps weights drawn from
seed 0.
"""

from __future__ import annotations

import os

from ..dinov2 import Dinov2Config
from ..loader import load_dir_state_dict, read_json_config
from .dit import TripoSGDiTConfig
from .vae import TripoSGVAEConfig


def triposg_config(path: str, **cfg_overrides):
    """The `TripoSGConfig` of an upstream directory."""
    from .pipeline import TripoSGConfig
    traw = read_json_config(os.path.join(path, "transformer", "config.json"))
    vraw = read_json_config(os.path.join(path, "vae", "config.json"))
    cond_dir = os.path.join(path, "image_encoder_dinov2")
    craw = (read_json_config(os.path.join(cond_dir, "config.json"))
            if os.path.isdir(cond_dir) else {})
    kw = dict(
        dit=TripoSGDiTConfig(
            width=traw.get("width", 2048),
            in_channels=traw.get("in_channels", 64),
            num_layers=traw.get("num_layers", 21),
            heads=traw.get("num_attention_heads", 16),
            cross_attention_dim=traw.get("cross_attention_dim", 1024)),
        vae=TripoSGVAEConfig(
            latent_channels=vraw.get("latent_channels", 64),
            heads=vraw.get("num_attention_heads", 8),
            width_encoder=vraw.get("width_encoder", 512),
            width_decoder=vraw.get("width_decoder", 1024),
            num_layers_encoder=vraw.get("num_layers_encoder", 8),
            num_layers_decoder=vraw.get("num_layers_decoder", 16),
            num_freqs=vraw.get("embed_frequency", 8),
            include_pi=vraw.get("embed_include_pi", False),
            in_channels=vraw.get("in_channels", 3)),
        cond=Dinov2Config(
            hidden=craw.get("hidden_size", 1024),
            layers=craw.get("num_hidden_layers", 24),
            heads=craw.get("num_attention_heads", 16),
            patch=craw.get("patch_size", 14),
            pretrain_image_size=craw.get("image_size", 518),
            layer_norm_eps=craw.get("layer_norm_eps", 1e-6)),
        image_size=craw.get("image_size", 518))
    kw.update(cfg_overrides)
    return TripoSGConfig(**kw)


def load_dit_vae_cond(model, path: str, tag: str):
    """`model.dit`, `model.vae` and `model.cond` loaded strictly from the
    `transformer/`, `vae/` and `image_encoder_dinov2/` folders under
    `path`; without the last the conditioner keeps its weights (`tag`
    names the family in the message). Returns `model`."""
    parts = [(model.dit, "transformer"), (model.vae, "vae")]
    if os.path.isdir(os.path.join(path, "image_encoder_dinov2")):
        parts.append((model.cond, "image_encoder_dinov2"))
    else:
        print(f"[{tag}.convert] no image_encoder_dinov2/ — random "
              "conditioner")
    for module, sub in parts:
        module.load_state_dict(load_dir_state_dict(os.path.join(path, sub)),
                               strict=True)
    return model


def load_triposg_dir(path: str, device, **cfg_overrides):
    """An upstream TripoSG directory → `TripoSG` on `device`."""
    from .pipeline import random_model
    return load_dit_vae_cond(
        random_model(0, triposg_config(path, **cfg_overrides), device),
        path, "triposg")
