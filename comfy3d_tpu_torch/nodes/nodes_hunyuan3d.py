"""Hunyuan3D-2.1 shape-generation nodes (reference nodes.py:4449, 5209,
5397).

Port of `comfy3d_tpu/nodes/nodes_hunyuan3d.py`'s 2.1 nodes and the glue
they share: `_estimate_alpha` (the background estimate) and `_cleanup`
(the floater and degenerate-face removal through `native.clean_mesh`).
Unlike the JAX package, `_cleanup` lets a failure of the native library
raise rather than return the raw mesh.

Not ported (ROADMAP A.10): the V1 and V2 nodes (`Load_Hunyuan3D_V2_
ShapeGen_Pipeline`, `Hunyuan3D_V2_DiT_Flow_Matching_Model`,
`Hunyuan3D_V2_ShapeGen_MV`, `Hunyuan3D_V1_*`).
"""

from __future__ import annotations

import os

import numpy as np
from torch.profiler import record_function

from .. import native
from ..core.mesh import Mesh
from . import base
from .base import image_batch, image_tensor, register

BG_DISTANCE = 0.12       # `_estimate_alpha`'s threshold
CLEAN_SPAN = "hunyuan3d.clean"   # `_cleanup`'s profiler span


def _cleanup(mesh: Mesh) -> Mesh:
    """The FloaterRemover and DegenerateFaceRemover role
    (shapegen/postprocessors.py): `native.clean_mesh(weld_eps=0,
    min_component_frac=0.05)`, then vertex normals; under `CLEAN_SPAN`."""
    with record_function(CLEAN_SPAN):
        v, f = native.clean_mesh(np.asarray(mesh.v), np.asarray(mesh.f),
                                 weld_eps=0.0, min_component_frac=0.05)
        return Mesh(v=v, f=f).auto_normal()


def _estimate_alpha(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] → a [H, W] foreground mask: the distance from the border's
    median colour over 0.12 (the reference's BiRefNet rembg role,
    `hy3dgen/rembg.py`, without a network)."""
    img = np.asarray(img, np.float32)
    border = np.concatenate([img[0], img[-1], img[:, 0], img[:, -1]])
    bg = np.median(border, axis=0)
    dist = np.linalg.norm(img - bg, axis=-1)
    return (dist > BG_DISTANCE).astype(np.float32)


@register
class Multi_Background_Remover:
    """reference nodes.py:4449: one to three views → a list of RGBA
    images [H, W, 4]."""

    CATEGORY = "Comfy3D/Preprocessors"
    RETURN_TYPES = ("LIST",)
    RETURN_NAMES = ("images",)
    FUNCTION = "run"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"image_front": ("IMAGE",)},
                "optional": {"image_back": ("IMAGE",),
                             "image_left": ("IMAGE",)}}

    def run(self, image_front, image_back=None, image_left=None,
            image_right=None):
        out = []
        for view in (image_front, image_back, image_left, image_right):
            if view is None:
                continue
            img = image_batch(view)[0].numpy()
            if img.shape[-1] != 4:
                alpha = _estimate_alpha(img)
                img = np.concatenate([img, alpha[..., None]], axis=-1)
            out.append(image_tensor(img))
        return (out,)


@register
class Load_Hunyuan3D_21_ShapeGen_Pipeline:
    """reference nodes.py:5209: the 2.1 shape DiT (the V2 architecture),
    from the tencent/Hunyuan3D-2.1 layout."""

    CATEGORY = "Comfy3D/Algorithm/Hunyuan3D-2.1"
    RETURN_TYPES = ("DIFFUSERS_PIPE",)
    RETURN_NAMES = ("shapegen_pipe",)
    FUNCTION = "load"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "use_fp16": ("BOOLEAN", {"default": True}),
        }}

    def load(self, use_fp16=True):
        from ..models.hunyuan3d import (Hunyuan3DShapeConfig,
                                        Hunyuan3DShapePipeline)
        dev = base.node_device()
        root = os.path.join(base.CKPT_ROOT_PATH, "Diffusers", "tencent",
                            "Hunyuan3D-2.1")
        dit = os.path.join(root, "hunyuan3d-dit-v2-1",
                           "model.fp16.safetensors")
        vae = os.path.join(root, "hunyuan3d-vae-v2-1",
                           "model.fp16.safetensors")
        cfg = Hunyuan3DShapeConfig()
        if os.path.exists(dit) and os.path.exists(vae):
            return (Hunyuan3DShapePipeline.from_pretrained(
                dit, vae, cfg=cfg, device=dev),)
        print("[Load_Hunyuan3D_21_ShapeGen_Pipeline] checkpoints "
              f"not found under {root} — initializing random weights")
        return (Hunyuan3DShapePipeline.init_random(cfg=cfg, device=dev),)


def shapegen_image(image, remove_background: bool = True) -> np.ndarray:
    """The ShapeGen node's input: the first image [H, W, 3], with
    `remove_background` composited on white over `_estimate_alpha`."""
    img = image_batch(image)[0].numpy()
    if remove_background:
        alpha = _estimate_alpha(img)[..., None]
        img = img * alpha + (1.0 - alpha)
    return img


@register
class Hunyuan3D_21_ShapeGen:
    """reference nodes.py:5397: image → mesh and the processed image."""

    CATEGORY = "Comfy3D/Algorithm/Hunyuan3D-2.1"
    RETURN_TYPES = ("MESH", "IMAGE")
    RETURN_NAMES = ("mesh", "processed_image")
    FUNCTION = "generate"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "shapegen_pipe": ("DIFFUSERS_PIPE",),
            "image": ("IMAGE",),
            "seed": ("INT", {"default": 1234, "min": 0,
                             "max": 0xffffffffffffffff}),
            "steps": ("INT", {"default": 30, "min": 1, "max": 100}),
            "guidance_scale": ("FLOAT", {"default": 7.5, "min": 0.0,
                                         "step": 0.1}),
            "octree_resolution": ("INT", {"default": 256, "min": 64,
                                          "max": 512}),
            "remove_background": ("BOOLEAN", {"default": True}),
            "auto_cleanup": ("BOOLEAN", {"default": True}),
        }}

    def generate(self, shapegen_pipe, image, seed=1234, steps=30,
                 guidance_scale=7.5, octree_resolution=256,
                 remove_background=True, auto_cleanup=True):
        img = shapegen_image(image, remove_background)
        mesh = shapegen_pipe(
            img, seed=int(seed), num_steps=int(steps),
            guidance_scale=float(guidance_scale),
            octree_resolution=int(octree_resolution))[0]
        return (_cleanup(mesh), image_tensor(img)[None])
