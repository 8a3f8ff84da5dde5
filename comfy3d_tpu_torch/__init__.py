"""comfy3d_tpu_torch — the PyTorch/CUDA port of comfy3d_tpu for NVIDIA Hopper.

The JAX package `comfy3d_tpu` stays the reference; this package mirrors its
module names so each module's counterpart is easy to find
(`comfy3d_tpu_torch/ops/gs_render.py` ↔ `comfy3d_tpu/ops/gs_render.py`). Plain
tensor code is PyTorch; each kernel the JAX package wrote in Pallas becomes a
hand-written CUDA kernel under `csrc/`, built with `nvcc` at first use.

Layering:
  core/      dataclasses of tensors (GaussianSplat, Camera), SH, GS-PLY I/O
  ops/       3DGS projection, coarse (bin|depth) sort, bin compositor
             (`ops/gs_flat.py` wraps `csrc/gs_flat_{fwd,bwd}.cu`), SSIM
  algorithms/  the per-asset 3DGS trainer (`gs_trainer.py`)
  convert    numpy arrays of the JAX containers → the port's tensors

Entry points run on the card unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"

import importlib as _importlib

_SUBMODULES = ("core", "ops", "algorithms", "convert")


def default_device():
    """The device entry points use when given `device=None`: the card.

    There is no CPU fallback: on a machine without CUDA, tensors created on
    this device raise."""
    import torch
    return torch.device("cuda")


def resolve_device(device=None):
    """`device`, or `default_device()` when it is None."""
    import torch
    return default_device() if device is None else torch.device(device)


def __getattr__(name):
    if name in _SUBMODULES:
        return _importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
