"""PartCrafter nodes (reference nodes.py:5592-5989).

Port of `comfy3d_tpu/nodes/nodes_partcrafter.py`. The object pipe
("wgsxm/PartCrafter") and the scene pipe ("wgsxm/PartCrafter-Scene") share
one architecture, so both loaders build a `PartCrafterPipeline`, read from
`<CKPT_ROOT_PATH>/Diffusers/<repo_id>` onto the run's device
(`base.node_device()`) when it holds weights, else drawn at the full
default config on that device; the scene loader sets `is_scene`, which
nothing reads (as in the JAX package). `PartCrafter Generate` writes each
part as a GLB into `<OUTPUT_ROOT_PATH>/partcrafter_parts/parts.zip` and the
parts pushed out from their centroid (`_explode`) and merged as one
coloured mesh into `partcrafter_scenes/scene.glb`, and reads its
`num_tokens` widget no more than the JAX node does (the latents per part
are the config's `vae.num_latents`).
"""

from __future__ import annotations

import os
import zipfile

import numpy as np

from . import base
from .base import image_tensor, register
from .nodes_diffusers import ckpt_diffusers_path, has_weights


def _explode(meshes, factor: float = 0.3):
    """Each part translated outward from the parts' mean centre by
    `factor` times its offset (`explode_mesh`'s role)."""
    from ..core.mesh import Mesh
    centers = [np.asarray(m.v).mean(0) for m in meshes if m.num_vertices]
    if not centers:
        return meshes
    global_c = np.stack(centers).mean(0)
    out = []
    for m in meshes:
        if not m.num_vertices:
            out.append(m)
            continue
        off = (np.asarray(m.v).mean(0) - global_c) * factor
        out.append(Mesh(v=np.asarray(m.v) + off, f=m.f, vc=m.vc, vn=m.vn))
    return out


class _PartCrafterLoaderBase:
    CATEGORY = "Comfy3D/Algorithm/PartCrafter"
    FUNCTION = "load"
    _SCENE = False

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {}}

    def load(self):
        from ..models.partcrafter import PartCrafterPipeline
        ckpt = os.path.join(ckpt_diffusers_path(), self._REPO_ID)
        dev = base.node_device()
        if has_weights(ckpt):
            print(f"[{type(self).__name__}] loading {ckpt}")
            pipe = PartCrafterPipeline.from_pretrained(ckpt, device=dev)
        else:
            print(f"[{type(self).__name__}] initializing random weights "
                  f"(no local checkpoint for {self._REPO_ID})")
            pipe = PartCrafterPipeline.init_random(device=dev)
        pipe.is_scene = self._SCENE
        return (pipe,)


@register
class Load_PartCrafter_Pipeline(_PartCrafterLoaderBase):
    """reference nodes.py:5592 — the part-level object pipe."""
    RETURN_TYPES = ("DIFFUSERS_PIPE",)
    RETURN_NAMES = ("partcrafter_pipe",)
    _REPO_ID = "wgsxm/PartCrafter"


@register
class Load_PartCrafter_Scene_Pipeline(_PartCrafterLoaderBase):
    """reference nodes.py:5795 — the scene decomposition pipe."""
    RETURN_TYPES = ("DIFFUSERS_PIPE",)
    RETURN_NAMES = ("partcrafter_scene_pipe",)
    _REPO_ID = "wgsxm/PartCrafter-Scene"
    _SCENE = True


@register
class PartCrafter_Generate:
    """reference nodes.py:5650/:5854 — image → `num_parts` part meshes;
    saves the per-part GLB zip and the merged scene GLB and returns their
    paths, the image it ran on and the merged mesh."""

    CATEGORY = "Comfy3D/Algorithm/PartCrafter"
    RETURN_TYPES = ("STRING", "STRING", "IMAGE", "MESH")
    RETURN_NAMES = ("parts_zip_path", "glb_mesh_path",
                    "processed_image", "merged_mesh")
    FUNCTION = "generate"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "partcrafter_pipe": ("DIFFUSERS_PIPE",),
            "image": ("IMAGE",),
            "num_parts": ("INT", {"default": 4, "min": 1, "max": 16}),
            "seed": ("INT", {"default": 1234, "min": 0,
                             "max": 0xffffffffffffffff}),
            "num_tokens": ("INT", {"default": 1024, "min": 256,
                                   "max": 2048}),
            "num_inference_steps": ("INT", {"default": 50, "min": 1,
                                            "max": 100}),
            "guidance_scale": ("FLOAT", {"default": 7.0, "min": 0.0,
                                         "step": 0.1}),
            "octree_resolution": ("INT", {"default": 128, "min": 16}),
            "explode_factor": ("FLOAT", {"default": 0.3, "min": 0.0,
                                         "step": 0.01}),
        }}

    def generate(self, partcrafter_pipe, image, num_parts=4, seed=1234,
                 num_tokens=1024, num_inference_steps=50,
                 guidance_scale=7.0, octree_resolution=128,
                 explode_factor=0.3):
        from ..models.partcrafter import merge_parts
        img = image_tensor(image)
        if img.dim() == 4:
            img = img[0]
        if img.shape[-1] == 4:
            a = img[..., 3:4]
            img = img[..., :3] * a + (1.0 - a)
        parts = partcrafter_pipe(
            img, num_parts=int(num_parts), seed=int(seed),
            num_steps=int(num_inference_steps),
            guidance_scale=float(guidance_scale),
            octree_resolution=int(octree_resolution))

        parts_dir = os.path.join(base.OUTPUT_ROOT_PATH, "partcrafter_parts")
        scene_dir = os.path.join(base.OUTPUT_ROOT_PATH, "partcrafter_scenes")
        os.makedirs(parts_dir, exist_ok=True)
        os.makedirs(scene_dir, exist_ok=True)
        zip_path = os.path.join(parts_dir, "parts.zip")
        with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
            for i, m in enumerate(parts):
                p = os.path.join(parts_dir, f"part_{i:02d}.glb")
                m.auto_normal().write(p)
                zf.write(p, f"part_{i:02d}.glb")
                os.remove(p)

        merged = merge_parts(_explode(parts, float(explode_factor)))
        scene_path = os.path.join(scene_dir, "scene.glb")
        merged.auto_normal().write(scene_path)
        print(f"[PartCrafter_Generate] {len(parts)} parts → {zip_path}, "
              f"merged scene → {scene_path}")
        return (zip_path, "partcrafter_scenes/scene.glb", img[None], merged)
