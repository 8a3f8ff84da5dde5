"""comfy3d_tpu_torch — the PyTorch/CUDA port of comfy3d_tpu for NVIDIA Hopper.

The JAX package `comfy3d_tpu` stays the reference; this package mirrors its
module names so each module's counterpart is easy to find
(`comfy3d_tpu_torch/ops/gs_render.py` ↔ `comfy3d_tpu/ops/gs_render.py`). Plain
tensor code is PyTorch; each kernel the JAX package wrote in Pallas becomes a
hand-written CUDA kernel under `csrc/`, built with `nvcc` at first use.

Layering:
  core/      GaussianSplat, Camera, SH, Mesh (host numpy), image utilities
             (`image.py`: compositing, resizing, grids, texture dilation),
             file I/O (GS-PLY, OBJ, GLB, mesh PLY)
  ops/       3DGS projection, binning, the bin and tile compositors
             (`gs_flat.py`, `gs_tile.py` wrap `csrc/*.cu`), SSIM, volume
             decodes, marching tets and the weld, FlexiCubes, ray
             marching, the hash-grid encoding, the mesh rasterizer (its
             soft silhouette wraps `csrc/soft_silhouette.cu`) and
             renderer, UV unwrapping (`uv_atlas.py`, `texture.py`) and
             baking
  models/    TripoSR, InstantMesh, the SD UNet / VAE / samplers, MVDream,
             LGM, CLIP's vision encoder, Zero123Plus, DINOv2, the vecset
             substrate (ShapeVAE with its octree decode, the flow DiT) and
             Hunyuan3D-2.1 shape generation and paint, CRM, Wonder3D,
             Era3D and TripoSG; checkpoint files
             and directories (`loader`)
  algorithms/  the 3DGS trainer, the Instant-NGP fit (`ngp.py`), the
             GS→mesh converter (`gs_to_mesh.py`), the multi-view colour
             projection and bake (`color_project.py`), the mesh fit
             (`diff_mesh.py`) and the FlexiCubes SDF fit (`sdf_fit.py`)
  native/    host C++ mesh clean / decimate / remesh / vertex inpaint (g++
             at first use, ctypes)
  nodes/     the ComfyUI node classes under the JAX package's registry keys
             and the workflow executor (`run_workflow(..., device=)`)
  convert    numpy arrays of the JAX containers and params → the port's

Entry points run on the card unless the caller passes `device="cpu"`.

Tests: `python -m pytest tests/test_torch_*.py` holds each module against
the JAX package on the CPU at tiny widths (Hunyuan3D-2.1 shape and paint:
`tests/test_torch_hunyuan3d{,_paint}.py`); `python3 chip_smoke.py` drives
every path on the card (phases 17–18: Hunyuan3D-2.1 shape, then paint, at
the nodes' defaults; phase 19: configs 1–5 as workflow graphs).
"""

__version__ = "0.1.0"

import importlib as _importlib

_SUBMODULES = ("core", "ops", "algorithms", "convert", "native", "nodes")


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
