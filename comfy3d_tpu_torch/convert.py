"""The JAX package's containers as numpy arrays → the port's tensors.

`comfy3d_tpu.core.gaussian.GaussianSplat` and `comfy3d_tpu.core.camera.Camera`
hold their state in six and two arrays, and
`comfy3d_tpu.algorithms.gs_trainer.GSTrainState` in dicts of arrays;
handing those arrays over (as numpy) gives a port `GaussianSplat` / `Camera`
/ `GSTrainState` with the same state, so both packages can compute on
identical inputs.
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
