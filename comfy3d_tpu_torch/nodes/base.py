"""Node-layer foundation: the registry, the paths, the run's device and the
edge conventions.

Port of `comfy3d_tpu/nodes/base.py`. Each node class declares
`INPUT_TYPES` (a classmethod), `RETURN_TYPES`, `RETURN_NAMES`, `FUNCTION`
and `CATEGORY`, as the reference's protocol has them; registration keys a
class by "[Comfy3D] " and its name with underscores turned to spaces
(reference `__init__.py:54-63`), or by its bare name, the same strings as
the JAX package's, so one workflow dict runs on either package.

Edges: IMAGE = float32 [N, H, W, 3] in [0, 1] and MASK = float32 [N, H, W]
as CPU torch tensors (ComfyUI's own types); MESH = `core.mesh.Mesh` (host
numpy, as in the JAX package); GS_PLY = `core.gaussian.GaussianSplat` on
the run's device; ORBIT_CAMPOSES = a list of [radius, elevation, azimuth,
cx, cy, cz]. Loader and model nodes build on `node_device()`.

The path constants are read from the same `COMFY3D_*` variables as the JAX
package's, at import; the node modules read them through this module at
call time, so a test may patch them here.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Dict, Type

import numpy as np
import torch

from .. import default_device, resolve_device

NODE_CLASS_MAPPINGS: Dict[str, Type] = {}
NODE_DISPLAY_NAME_MAPPINGS: Dict[str, str] = {}

ROOT_PATH = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CKPT_ROOT_PATH = os.environ.get(
    "COMFY3D_CHECKPOINTS", os.path.join(ROOT_PATH, "checkpoints"))
INPUT_ROOT_PATH = os.environ.get(
    "COMFY3D_INPUT", os.path.join(ROOT_PATH, "input"))
OUTPUT_ROOT_PATH = os.environ.get(
    "COMFY3D_OUTPUT", os.path.join(ROOT_PATH, "output"))

SUPPORTED_3D_EXTENSIONS = (".obj", ".ply", ".glb", ".gltf")
SUPPORTED_3DGS_EXTENSIONS = (".ply",)
SUPPORTED_CHECKPOINTS_EXTENSIONS = (".ckpt", ".bin", ".safetensors",
                                    ".pth", ".pt")

_RUN_DEVICE: contextvars.ContextVar = contextvars.ContextVar(
    "comfy3d_run_device", default=None)


def node_device() -> torch.device:
    """The device of the `run_workflow` call that is running, else
    `default_device()` (the card)."""
    dev = _RUN_DEVICE.get()
    return default_device() if dev is None else dev


@contextlib.contextmanager
def run_device(device=None):
    """Within it, `node_device()` is `resolve_device(device)`."""
    token = _RUN_DEVICE.set(resolve_device(device))
    try:
        yield
    finally:
        _RUN_DEVICE.reset(token)


def image_tensor(x) -> torch.Tensor:
    """An IMAGE or MASK edge's value (a tensor, a numpy array or nested
    lists) as a float32 CPU tensor."""
    if torch.is_tensor(x):
        return x.detach().to(device="cpu", dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32))


def image_batch(x) -> torch.Tensor:
    """`image_tensor`, a single [H, W, C] image given a batch axis."""
    t = image_tensor(x)
    return t[None] if t.ndim == 3 else t


def register(cls=None, *, comfy3d: bool = True):
    """Class decorator: add to the node registry."""
    def deco(c):
        name = c.__name__
        key = f"[Comfy3D] {name.replace('_', ' ')}" if comfy3d else name
        NODE_CLASS_MAPPINGS[key] = c
        NODE_DISPLAY_NAME_MAPPINGS[key] = key
        return c
    return deco(cls) if cls is not None else deco


def parse_save_filename(save_path: str, output_dir: str,
                        supported_extensions, class_name: str):
    """Timestamp-token expansion and the extension check (reference
    `shared_utils/common_utils.py:22-45`); None, with a notice, for an
    unsupported extension."""
    import datetime
    now = datetime.datetime.now()
    tokens = {"%Y": f"{now.year:04d}", "%M": f"{now.month:02d}",
              "%D": f"{now.day:02d}", "%h": f"{now.hour:02d}",
              "%m": f"{now.minute:02d}", "%s": f"{now.second:02d}"}
    for t, v in tokens.items():
        save_path = save_path.replace(t, v)
    path = os.path.join(output_dir, save_path)
    ext = os.path.splitext(path)[1].lower()
    if ext not in supported_extensions:
        print(f"[{class_name}] unsupported save extension {ext!r}; "
              f"expected one of {supported_extensions}")
        return None
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def get_list_filenames(directory: str, extensions) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(
        f for f in os.listdir(directory)
        if os.path.splitext(f)[1].lower() in extensions)


def error_none(class_name: str, message: str):
    """The reference's failure for a bad user input: a notice and a None
    result (nodes.py:1308-1311)."""
    print(f"[{class_name}] {message}")
    return (None,)


def resume_or_download_model_from_hf(checkpoints_dir: str, repo_id: str,
                                     model_name: str,
                                     class_name: str = "") -> str:
    """Local-first checkpoint resolution (reference
    `shared_utils/common_utils.py`'s resume-or-download role):
    `<checkpoints_dir>/<model_name>` when it exists, else the hub's cache,
    else, only with `COMFY3D_ALLOW_DOWNLOAD=1`, a download; otherwise
    FileNotFoundError naming the path to place the file at."""
    path = os.path.join(checkpoints_dir, model_name)
    if os.path.exists(path):
        return path
    try:
        from huggingface_hub import hf_hub_download
        os.makedirs(checkpoints_dir, exist_ok=True)
        try:   # a hub cache hit needs no network
            return hf_hub_download(repo_id=repo_id, filename=model_name,
                                   local_dir=checkpoints_dir,
                                   local_files_only=True)
        except Exception:
            pass
        if os.environ.get("COMFY3D_ALLOW_DOWNLOAD", "0") != "1":
            raise RuntimeError(
                "network download disabled (set "
                "COMFY3D_ALLOW_DOWNLOAD=1 to enable)")
        return hf_hub_download(repo_id=repo_id, filename=model_name,
                               local_dir=checkpoints_dir)
    except Exception as exc:
        raise FileNotFoundError(
            f"[{class_name}] checkpoint {model_name!r} not found at "
            f"{path} and download from {repo_id!r} unavailable "
            f"({type(exc).__name__}). Place the file at that path.")
