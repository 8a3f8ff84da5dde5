"""A diffusers `T2IAdapterV2` directory → the port's `T2IAdapter`.

Port of `comfy3d_tpu/models/crm/t2i_convert.py::{config_from_dir,
load_adapter_dir}`. The reference loads the adapter with
`T2IAdapterV2.from_pretrained(dir)` (reference nodes.py:3547, 3693): a
`config.json` and `diffusion_pytorch_model.{safetensors,bin}` whose state
dict holds the port's module's names (`adapter.*`), loaded strictly.
"""

from __future__ import annotations

import os

from ..loader import load_state_dict, read_json_config
from .t2i_adapter import T2IAdapter, T2IAdapterConfig

WEIGHT_NAMES = ("diffusion_pytorch_model.safetensors",
                "diffusion_pytorch_model.bin")


def config_from_dir(path: str) -> T2IAdapterConfig:
    """The directory's diffusers `config.json`, when present, as a
    `T2IAdapterConfig`; else the default."""
    cfg_path = os.path.join(path, "config.json")
    if not os.path.exists(cfg_path):
        return T2IAdapterConfig()
    raw = read_json_config(cfg_path)
    return T2IAdapterConfig(
        in_channels=int(raw.get("in_channels", 3)),
        channels=tuple(raw.get("channels", (320, 640, 1280, 1280))),
        num_res_blocks=int(raw.get("num_res_blocks", 2)),
        cond_channels=tuple(raw.get("conditioning_embedding_out_channels",
                                    (16, 32, 64, 128, 256))))


def load_adapter_dir(path: str, device=None):
    """A directory → (T2IAdapterConfig, the loaded `T2IAdapter` on `device`),
    or None when it holds no weights file."""
    from ..diffusion.config import load_module
    for name in WEIGHT_NAMES:
        wpath = os.path.join(path, name)
        if os.path.exists(wpath):
            cfg = config_from_dir(path)
            return cfg, load_module(lambda: T2IAdapter(cfg),
                                    load_state_dict(wpath), device).eval()
    return None
