"""Checkpoint files → state dicts of float32 CPU tensors.

`.safetensors` files are read with the `safetensors` package (imported at
the call), any other file with `torch.load(weights_only=True)`, unwrapping
a top-level "state_dict". Every floating tensor is cast to float32: the
port computes in float32, as the JAX package's converters feed its float32
modules, so a public fp16 file loads as float32 parameters.
"""

from __future__ import annotations

import torch


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
