"""PartCrafter's native checkpoint directory → the port's `PartCrafter`.

Port of `comfy3d_tpu/models/partcrafter/convert.py::load_partcrafter_dir`:
upstream's diffusers-style layout (wgsxm/PartCrafter), `transformer/`
(PartCrafterDiTModel: TripoSG's DiT and `part_embedding`), `vae/`
(TripoSGVAEModel's layout) and `image_encoder_dinov2/`, each a config.json
beside its weights. The VAE's and DINOv2's configs are read as
`triposg/convert.py::triposg_config` reads them, the transformer's with its
`max_num_parts` and `global_attn_block_ids` (or, without them, the
inclusive `global_attn_block_id_range`). The weights load strictly under
their own names; without `image_encoder_dinov2/` the conditioner keeps
weights drawn from seed 0.
"""

from __future__ import annotations

import os

from ..loader import read_json_config
from ..triposg.convert import load_dit_vae_cond, triposg_config


def partcrafter_config(path: str, **cfg_overrides):
    """The `PartCrafterConfig` of an upstream directory."""
    from .pipeline import PartCrafterConfig, PartCrafterDiTConfig
    tsg = triposg_config(path)
    traw = read_json_config(os.path.join(path, "transformer", "config.json"))
    gids = traw.get("global_attn_block_ids")
    if gids is None:
        span = traw.get("global_attn_block_id_range")
        gids = list(range(span[0], span[1] + 1)) if span else []
    kw = dict(dit=PartCrafterDiTConfig(
        base=tsg.dit, max_num_parts=traw.get("max_num_parts", 32),
        global_attn_block_ids=tuple(gids)),
        vae=tsg.vae, cond=tsg.cond, image_size=tsg.image_size)
    kw.update(cfg_overrides)
    return PartCrafterConfig(**kw)


def load_partcrafter_dir(path: str, device, **cfg_overrides):
    """An upstream PartCrafter directory → `PartCrafter` on `device`."""
    from .pipeline import random_model
    return load_dit_vae_cond(
        random_model(0, partcrafter_config(path, **cfg_overrides), device),
        path, "partcrafter")
