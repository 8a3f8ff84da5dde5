"""Checkpoint files → state dicts of float32 CPU tensors.

`.safetensors` files are read with the `safetensors` package (imported at
the call), any other file with `torch.load(weights_only=True)`, unwrapping
a top-level "state_dict". Every floating tensor is cast to float32: the
port computes in float32, as the JAX package's converters feed its float32
modules, so a public fp16 file loads as float32 parameters.
`load_dir_state_dict` reads a diffusers component directory (one weights
file, or the shards its index names) and `read_json_config` its
`config.json`, as `comfy3d_tpu/models/loader.py` does.
"""

from __future__ import annotations

import json
import os

import torch

# a diffusers component directory's weights files, in the order they are
# looked for
WEIGHT_NAMES = ("diffusion_pytorch_model.safetensors", "model.safetensors",
                "diffusion_pytorch_model.bin", "pytorch_model.bin",
                "model.ckpt")
INDEX_NAMES = ("diffusion_pytorch_model.safetensors.index.json",
               "model.safetensors.index.json")


def load_state_dict(path: str) -> dict:
    """{name: CPU tensor} of a checkpoint file, floating ones as float32."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        t = torch.as_tensor(v)
        out[k] = t.float() if t.is_floating_point() else t
    return out


def load_dir_state_dict(path: str) -> dict:
    """A checkpoint file, or a diffusers component directory: the shards
    its index file names, else the first of `WEIGHT_NAMES` present, else
    its only weights file. Raises FileNotFoundError when none is found."""
    if os.path.isfile(path):
        return load_state_dict(path)
    for name in INDEX_NAMES:
        idx = os.path.join(path, name)
        if os.path.exists(idx):
            with open(idx) as fh:
                shards = sorted(set(json.load(fh)["weight_map"].values()))
            sd = {}
            for shard in shards:
                sd.update(load_state_dict(os.path.join(path, shard)))
            return sd
    for name in WEIGHT_NAMES:
        if os.path.exists(os.path.join(path, name)):
            return load_state_dict(os.path.join(path, name))
    cands = [f for f in sorted(os.listdir(path))
             if f.endswith((".safetensors", ".bin", ".ckpt", ".pth", ".pt"))]
    if len(cands) == 1:
        return load_state_dict(os.path.join(path, cands[0]))
    raise FileNotFoundError(
        f"no recognizable weights file in {path!r} (found {cands})")


def read_json_config(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)
