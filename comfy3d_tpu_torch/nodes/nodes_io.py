"""Import / export and preview nodes (reference nodes.py:212-416) and the
ComfyUI-builtin image nodes the example workflows rely on.

Port of `comfy3d_tpu/nodes/nodes_io.py`. Meshes load and save on the host;
a GS-PLY loads onto the run's device (`base.node_device()`); images load
with `cv2` as float32 CPU tensors."""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.io import load_gs_ply, save_gs_ply
from ..core.mesh import Mesh
from . import base
from .base import register


@register
class Load_3D_Mesh:
    """reference nodes.py:281"""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "mesh_file_path": ("STRING", {"default": ""}),
            "resize": ("BOOLEAN", {"default": False}),
            "renormal": ("BOOLEAN", {"default": True}),
            "flip_yz_axis": ("BOOLEAN", {"default": False}),
            "centering_to_origin": ("BOOLEAN", {"default": False}),
        }}

    RETURN_TYPES = ("MESH",)
    RETURN_NAMES = ("mesh",)
    FUNCTION = "load_mesh"
    CATEGORY = "Comfy3D/Import|Export"

    def load_mesh(self, mesh_file_path, resize=False, renormal=True,
                  flip_yz_axis=False, centering_to_origin=False):
        if not os.path.isabs(mesh_file_path):
            mesh_file_path = os.path.join(base.INPUT_ROOT_PATH,
                                          mesh_file_path)
        if not os.path.exists(mesh_file_path):
            return base.error_none(self.__class__.__name__,
                                   f"file not found: {mesh_file_path}")
        mesh = Mesh.load(mesh_file_path)
        if flip_yz_axis:
            mesh = mesh.switch_axis("+x+z-y")
        if centering_to_origin:
            lo, hi = mesh.aabb()
            mesh.v = mesh.v - (lo + hi) / 2.0
        if resize:
            mesh = mesh.auto_size()
        if renormal or mesh.vn is None:
            mesh = mesh.auto_normal()
        return (mesh,)


@register
class Save_3D_Mesh:
    """reference nodes.py:358"""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "mesh": ("MESH",),
            "save_path": ("STRING",
                          {"default": "Mesh_%Y-%M-%D-%h-%m-%s.glb"}),
        }}

    RETURN_TYPES = ("STRING",)
    RETURN_NAMES = ("save_path",)
    FUNCTION = "save_mesh"
    CATEGORY = "Comfy3D/Import|Export"
    OUTPUT_NODE = True

    def save_mesh(self, mesh, save_path):
        path = base.parse_save_filename(
            save_path, base.OUTPUT_ROOT_PATH,
            base.SUPPORTED_3D_EXTENSIONS, self.__class__.__name__)
        if path is None:
            return (None,)
        mesh.write(path)
        return (path,)


@register
class Load_3DGS:
    """reference nodes.py:323"""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "gs_file_path": ("STRING", {"default": ""}),
        }}

    RETURN_TYPES = ("GS_PLY",)
    RETURN_NAMES = ("gs_ply",)
    FUNCTION = "load_gs"
    CATEGORY = "Comfy3D/Import|Export"

    def load_gs(self, gs_file_path):
        if not os.path.isabs(gs_file_path):
            gs_file_path = os.path.join(base.INPUT_ROOT_PATH, gs_file_path)
        if not os.path.exists(gs_file_path):
            return base.error_none(self.__class__.__name__,
                                   f"file not found: {gs_file_path}")
        return (load_gs_ply(gs_file_path, device=base.node_device()),)


@register
class Save_3DGS:
    """reference nodes.py:387"""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "gs_ply": ("GS_PLY",),
            "save_path": ("STRING",
                          {"default": "3DGS_%Y-%M-%D-%h-%m-%s.ply"}),
        }}

    RETURN_TYPES = ("STRING",)
    RETURN_NAMES = ("save_path",)
    FUNCTION = "save_gs"
    CATEGORY = "Comfy3D/Import|Export"
    OUTPUT_NODE = True

    def save_gs(self, gs_ply, save_path):
        path = base.parse_save_filename(
            save_path, base.OUTPUT_ROOT_PATH,
            base.SUPPORTED_3DGS_EXTENSIONS, self.__class__.__name__)
        if path is None:
            return (None,)
        save_gs_ply(path, gs_ply)
        return (path,)


@register
class Preview_3DMesh:
    """reference nodes.py:245, headless: records the path for the UI."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "mesh_file_path": ("STRING", {"default": ""}),
        }}

    RETURN_TYPES = ()
    FUNCTION = "preview_mesh"
    CATEGORY = "Comfy3D/Visualize"
    OUTPUT_NODE = True

    def preview_mesh(self, mesh_file_path, *extra):
        return {"ui": {"previews": [{"filepath": mesh_file_path or ""}]},
                "result": ()}


@register
class Preview_3DGS:
    """reference nodes.py:212"""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "gs_file_path": ("STRING", {"default": ""}),
        }}

    RETURN_TYPES = ()
    FUNCTION = "preview_gs"
    CATEGORY = "Comfy3D/Visualize"
    OUTPUT_NODE = True

    def preview_gs(self, gs_file_path, *extra):
        return {"ui": {"previews": [{"filepath": gs_file_path or ""}]},
                "result": ()}


# ------------------------------------------------------------------ #
# ComfyUI builtin equivalents (the executor stands alone)
# ------------------------------------------------------------------ #
def read_image(path: str):
    """An image file → (RGB [H, W, 3], alpha [H, W] or None), float32 numpy
    in [0, 1]."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 2:
        img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
    if img.shape[2] == 4:
        rgba = cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA)
        return (rgba[..., :3].astype(np.float32) / 255.0,
                rgba[..., 3].astype(np.float32) / 255.0)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0, \
        None


@register(comfy3d=False)
class LoadImage:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "image": ("STRING", {"default": ""}),
        }}

    RETURN_TYPES = ("IMAGE", "MASK")
    FUNCTION = "load_image"
    CATEGORY = "image"

    def load_image(self, image, *extra):
        path = image
        if not os.path.isabs(path):
            cand = os.path.join(base.INPUT_ROOT_PATH, path)
            if os.path.exists(cand):
                path = cand
        rgb, alpha = read_image(path)
        # ComfyUI's mask is 1 − α
        mask = (np.zeros(rgb.shape[:2], np.float32) if alpha is None
                else 1.0 - alpha)
        return torch.from_numpy(rgb)[None], torch.from_numpy(mask)[None]


@register(comfy3d=False)
class InvertMask:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"mask": ("MASK",)}}

    RETURN_TYPES = ("MASK",)
    FUNCTION = "invert"
    CATEGORY = "mask"

    def invert(self, mask):
        return (1.0 - base.image_tensor(mask),)


@register(comfy3d=False)
class SaveImage:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "images": ("IMAGE",),
            "filename_prefix": ("STRING", {"default": "ComfyUI"}),
        }}

    RETURN_TYPES = ()
    FUNCTION = "save_images"
    CATEGORY = "image"
    OUTPUT_NODE = True

    def save_images(self, images, filename_prefix="ComfyUI", *extra):
        import cv2
        os.makedirs(base.OUTPUT_ROOT_PATH, exist_ok=True)
        paths = []
        for i, img in enumerate(base.image_tensor(images).numpy()):
            # a prefix may name a subfolder, as ComfyUI's does
            path = os.path.join(base.OUTPUT_ROOT_PATH,
                                f"{filename_prefix}_{i:05d}.png")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            arr = np.clip(img * 255.0, 0, 255).astype(np.uint8)
            if not cv2.imwrite(path, cv2.cvtColor(arr, cv2.COLOR_RGB2BGR)):
                raise OSError(f"[SaveImage] could not write {path}")
            paths.append(path)
        return {"ui": {"images": paths}, "result": ()}


@register(comfy3d=False)
class PreviewImage(SaveImage):
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"images": ("IMAGE",)}}
