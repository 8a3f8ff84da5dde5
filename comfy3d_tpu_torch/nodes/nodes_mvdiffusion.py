"""Multi-view diffusion nodes: Wonder3D and Era3D (reference nodes.py:1621,
2587).

Port of `comfy3d_tpu/nodes/nodes_mvdiffusion.py`. The loaders read
`<CKPT_ROOT_PATH>/Diffusers/<repo_id>` onto the run's device
(`base.node_device()`) when it holds weights, else print a notice and build
the default config with random weights drawn on that device. The model
nodes composite the reference image on white through its mask and return
the colour views, the normal maps (IMAGE, on the host) and the views'
orbit poses. `Era3D MVDiffusion Model` takes `image_crop_size` and `eta`
and does not read them, as the JAX package's node.
"""

from __future__ import annotations

import os

from ..core import image as img_utils
from . import base
from .base import image_batch, register
from .nodes_diffusers import (DIFFUSERS_PIPE_FACTORIES, ckpt_diffusers_path,
                              has_weights)


def _load(pipeline_name: str, repo_id: str, node: str):
    """`Load_Diffusers_Pipeline`'s factory for `pipeline_name` on the run's
    device, from the local checkpoint when there is one."""
    factory = DIFFUSERS_PIPE_FACTORIES[pipeline_name]
    ckpt = os.path.join(ckpt_diffusers_path(), repo_id)
    dev = base.node_device()
    if has_weights(ckpt):
        print(f"[{node}] loading {ckpt}")
        return factory(ckpt_dir=ckpt, device=dev)
    print(f"[{node}] initializing random weights (no local checkpoints for "
          f"{repo_id})")
    return factory(device=dev)


def _composite(reference_image, reference_mask):
    """The first reference image on white through its mask, [H, W, 3]."""
    return img_utils.composite_background(image_batch(reference_image),
                                          image_batch(reference_mask))[0]


def _views(pipe, reference_image, reference_mask, **kw):
    colors, normals = pipe(_composite(reference_image, reference_mask), **kw)
    return colors.detach().cpu(), normals.detach().cpu()


@register
class Load_Wonder3D_Pipeline:
    """The Wonder3D joint colour + normal multi-view pipeline (the
    reference builds it through Load_Diffusers_Pipeline)."""

    CATEGORY = "Comfy3D/Import|Export"
    RETURN_TYPES = ("DIFFUSERS_PIPE",)
    RETURN_NAMES = ("mvdiffusion_pipe",)
    FUNCTION = "load"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "repo_id": ("STRING", {"default": "flamehaze1115/wonder3d-v1.0",
                                   "multiline": False}),
        }}

    def load(self, repo_id="flamehaze1115/wonder3d-v1.0"):
        return (_load("Wonder3DMVDiffusionPipeline", repo_id,
                      "Load_Wonder3D_Pipeline"),)


@register
class Wonder3D_MVDiffusion_Model:
    """reference nodes.py:1621 — image + mask → 6 views, 6 normal maps and
    their camera poses."""

    # the camera table's elevations and azimuths in degrees
    _POSES = [[4.0, 0.0, 0.0], [4.0, -13.5, 46.6], [4.0, -9.7, 97.0],
              [4.0, 29.9, 180.0], [4.0, 39.6, 277.1], [4.0, 21.4, 320.1]]

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "mvdiffusion_pipe": ("DIFFUSERS_PIPE",),
            "reference_image": ("IMAGE",),
            "reference_mask": ("MASK",),
            "seed": ("INT", {"default": 0, "min": 0,
                             "max": 0xffffffffffffffff}),
            "mv_guidance_scale": ("FLOAT", {"default": 1.0, "min": 0.0,
                                            "step": 0.01}),
            "num_inference_steps": ("INT", {"default": 50, "min": 1}),
        }}

    RETURN_TYPES = ("IMAGE", "IMAGE", "ORBIT_CAMPOSES")
    RETURN_NAMES = ("multiview_images", "multiview_normals",
                    "orbit_camposes")
    FUNCTION = "run_model"
    CATEGORY = "Comfy3D/Algorithm"

    def run_model(self, mvdiffusion_pipe, reference_image, reference_mask,
                  seed=0, mv_guidance_scale=1.0, num_inference_steps=50):
        colors, normals = _views(
            mvdiffusion_pipe, reference_image, reference_mask,
            num_inference_steps=int(num_inference_steps),
            guidance_scale=float(mv_guidance_scale), seed=int(seed))
        poses = [[r, e, a, 0.0, 0.0, 0.0] for r, e, a in self._POSES]
        return (colors, normals, poses)


@register
class Load_Era3D_Pipeline:
    CATEGORY = "Comfy3D/Import|Export"
    RETURN_TYPES = ("DIFFUSERS_PIPE",)
    RETURN_NAMES = ("era3d_pipe",)
    FUNCTION = "load"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "repo_id": ("STRING", {"default":
                                   "pengHTYX/MacLab-Era3D-512-6view",
                                   "multiline": False}),
        }}

    def load(self, repo_id="pengHTYX/MacLab-Era3D-512-6view"):
        return (_load("Era3DPipeline", repo_id, "Load_Era3D_Pipeline"),)


@register
class Era3D_MVDiffusion_Model:
    """reference nodes.py:2587 — image + mask → 6 views, normal maps and
    camera poses on an orbit at `radius`."""

    _AZIMUTHS = [0.0, 45.0, 90.0, 180.0, 270.0, 315.0]

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "era3d_pipe": ("DIFFUSERS_PIPE",),
            "reference_image": ("IMAGE",),
            "reference_mask": ("MASK",),
            "image_crop_size": ("INT", {"default": 420, "min": 400,
                                        "max": 8192}),
            "seed": ("INT", {"default": 600, "min": 0,
                             "max": 0xffffffffffffffff}),
            "guidance_scale": ("FLOAT", {"default": 3.0, "min": 0.0,
                                         "step": 0.01}),
            "num_inference_steps": ("INT", {"default": 40, "min": 1}),
            "eta": ("FLOAT", {"default": 1.0, "min": 0.0, "step": 0.01}),
            "radius": ("FLOAT", {"default": 4.0, "min": 0.1,
                                 "step": 0.01}),
        }}

    RETURN_TYPES = ("IMAGE", "IMAGE", "ORBIT_CAMPOSES")
    RETURN_NAMES = ("multiviews", "multiview_normals", "orbit_camposes")
    FUNCTION = "run_model"
    CATEGORY = "Comfy3D/Algorithm"

    def run_model(self, era3d_pipe, reference_image, reference_mask,
                  image_crop_size=420, seed=600, guidance_scale=3.0,
                  num_inference_steps=40, eta=1.0, radius=4.0):
        colors, normals = _views(
            era3d_pipe, reference_image, reference_mask,
            num_inference_steps=int(num_inference_steps),
            guidance_scale=float(guidance_scale), seed=int(seed))
        poses = [[float(radius), 0.0, a, 0.0, 0.0, 0.0]
                 for a in self._AZIMUTHS]
        return (colors, normals, poses)
