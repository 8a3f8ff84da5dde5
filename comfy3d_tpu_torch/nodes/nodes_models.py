"""Model-family nodes (reference nodes.py:1716-2543): TripoSR,
InstantMesh, Zero123Plus, MVDream and LGM.

Port of `comfy3d_tpu/nodes/nodes_models.py` for the families configs 1–5
reach. A loader reads its checkpoint onto the run's device
(`base.node_device()`); without one it prints a notice and builds the
model at its full default config with random weights drawn on that
device (`init_random(device=...)`), as the JAX package falls back to
`init_random()`. Images cross into the pipelines as float32 tensors.

TripoSG's image and scribble nodes run the pipeline of `Load TripoSG
Pipeline` or of `Load Diffusers Pipeline`'s TripoSG factories; the scribble
node runs the conditional pass alone, as its CFG-distilled model is run
(the JAX package blends at guidance 0, ROADMAP §C.10), and reads its prompt
and confidences no more than the JAX package's does.

Not ported (ROADMAP A.10): SF3D, TGS, Craftsman, `Fast_Normal_Maps_To_Mesh`
and `ExplicitTarget_Mesh_Optimization`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core import image as img_utils
from ..core.camera import ORBITPOSE_PRESETS
from . import base
from .base import error_none, image_tensor, register


class _CheckpointLoader:
    """A loader node's checkpoint listing: the files under
    `<CKPT_ROOT_PATH>/<checkpoints_dir>`, read at call time, and the
    default name."""

    checkpoints_dir = ""
    default_ckpt_name = ""

    @classmethod
    def _names(cls):
        names = base.get_list_filenames(
            os.path.join(base.CKPT_ROOT_PATH, cls.checkpoints_dir),
            base.SUPPORTED_CHECKPOINTS_EXTENSIONS)
        if cls.default_ckpt_name not in names:
            names = names + [cls.default_ckpt_name]
        return names

    def _ckpt(self, model_name: str) -> str:
        return os.path.join(base.CKPT_ROOT_PATH, self.checkpoints_dir,
                            model_name)


@register
class Load_TripoSR_Model(_CheckpointLoader):
    """reference nodes.py:1939"""

    checkpoints_dir = "TripoSR"
    default_ckpt_name = "model.ckpt"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "model_name": (cls._names(),),
            "chunk_size": ("INT", {"default": 8192, "min": 1,
                                   "max": 10000}),
        }}

    RETURN_TYPES = ("TSR_MODEL",)
    RETURN_NAMES = ("tsr_model",)
    FUNCTION = "load_TSR"
    CATEGORY = "Comfy3D/Import|Export"

    def load_TSR(self, model_name="model.ckpt", chunk_size=8192):
        from ..models.triposr import TripoSRPipeline
        dev = base.node_device()
        ckpt = self._ckpt(model_name)
        if os.path.exists(ckpt):
            return (TripoSRPipeline.from_pretrained(ckpt, device=dev),)
        print(f"[Load_TripoSR_Model] checkpoint {ckpt} not found — "
              "initializing random weights (set COMFY3D_CHECKPOINTS "
              "or place the file to load real weights)")
        return (TripoSRPipeline.init_random(device=dev),)


@register
class TripoSR:
    """reference nodes.py:1985: image and mask → mesh."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "tsr_model": ("TSR_MODEL",),
            "reference_image": ("IMAGE",),
            "reference_mask": ("MASK",),
            "geometry_extract_resolution": ("INT", {"default": 256,
                                                    "min": 16}),
            "marching_cude_threshold": ("FLOAT", {"default": 25.0,
                                                  "min": 0.0}),
        }}

    RETURN_TYPES = ("MESH",)
    RETURN_NAMES = ("mesh",)
    FUNCTION = "run_TSR"
    CATEGORY = "Comfy3D/Algorithm"

    def run_TSR(self, tsr_model, reference_image, reference_mask,
                geometry_extract_resolution=256,
                marching_cude_threshold=25.0):
        img = image_tensor(reference_image)[0]
        mask = image_tensor(reference_mask)[0][..., None]
        # the reference fills the background with 0.5 grey
        # (nodes.py:2028-2032)
        img = img * mask + 0.5 * (1.0 - mask)
        codes = tsr_model.scene_codes(img[None])
        mesh = tsr_model.extract_mesh(
            codes[0], resolution=geometry_extract_resolution,
            threshold=marching_cude_threshold)
        if mesh.num_vertices == 0:
            # the graph runs on (downstream nodes take empty meshes); the
            # reference would print and return None here
            print(f"[TripoSR] no surface at threshold "
                  f"{marching_cude_threshold} (random weights produce "
                  "near-uniform density)")
        return (mesh,)


@register
class Load_InstantMesh_Reconstruction_Model(_CheckpointLoader):
    """reference nodes.py:2476"""

    checkpoints_dir = "InstantMesh"
    default_ckpt_name = "instant_mesh_large.ckpt"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"model_name": (cls._names(),)}}

    RETURN_TYPES = ("LRM_MODEL",)
    RETURN_NAMES = ("lrm_model",)
    FUNCTION = "load_LRM"
    CATEGORY = "Comfy3D/Import|Export"

    def load_LRM(self, model_name="instant_mesh_large.ckpt"):
        from ..models.instantmesh import InstantMeshPipeline
        dev = base.node_device()
        ckpt = self._ckpt(model_name)
        if os.path.exists(ckpt):
            return (InstantMeshPipeline.from_pretrained(ckpt, device=dev),)
        print(f"[Load_InstantMesh] checkpoint {ckpt} not found — "
              "initializing random weights")
        return (InstantMeshPipeline.init_random(device=dev),)


@register
class InstantMesh_Reconstruction_Model:
    """reference nodes.py:2532: six views and their poses → a mesh."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "lrm_model": ("LRM_MODEL",),
            "multiview_images": ("IMAGE",),
            "orbit_camera_poses": ("ORBIT_CAMPOSES",),
            "orbit_camera_fovy": ("FLOAT", {"default": 30.0}),
            "texture_resolution": ("INT", {"default": 1024}),
        }}

    RETURN_TYPES = ("MESH",)
    RETURN_NAMES = ("mesh",)
    FUNCTION = "run_LRM"
    CATEGORY = "Comfy3D/Algorithm"

    def run_LRM(self, lrm_model, multiview_images, orbit_camera_poses,
                orbit_camera_fovy=30.0, texture_resolution=1024):
        from ..models.instantmesh import orbit_poses_to_input_cameras
        imgs = image_tensor(multiview_images)
        n = imgs.shape[0]
        if len(orbit_camera_poses) != n:
            return error_none(self.__class__.__name__,
                              f"{n} images != "
                              f"{len(orbit_camera_poses)} poses")
        # antialiased bilinear, as `jax.image.resize` shrinks
        imgs = img_utils.resize_images(imgs.to(lrm_model.device), 320, 320)
        poses = np.asarray(orbit_camera_poses, np.float32)
        cams = orbit_poses_to_input_cameras(
            poses[:, 2], poses[:, 1], radius=4.0, fov_deg=orbit_camera_fovy)
        planes = lrm_model.forward_planes(imgs[None], cams[None])
        return (lrm_model.extract_mesh(planes[0]),)


@register
class Zero123Plus_Diffusion_Model:
    """reference nodes.py:2414: one image → a 3×2 grid of six views."""

    checkpoints_dir = "Zero123Plus"

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "zero123plus_pipe": ("DIFFUSERS_PIPE",),
                "reference_image": ("IMAGE",),
                "reference_mask": ("MASK",),
                "seed": ("INT", {"default": 1234, "min": 0,
                                 "max": 0xffffffffffffffff}),
                "guidance_scale": ("FLOAT", {"default": 4.0,
                                             "min": 0.0,
                                             "step": 0.01}),
                "num_inference_steps": ("INT", {"default": 28,
                                                "min": 1}),
            },
        }

    RETURN_TYPES = ("IMAGE", "ORBIT_CAMPOSES")
    RETURN_NAMES = ("multiviews", "orbit_camposes")
    FUNCTION = "run_model"
    CATEGORY = "Comfy3D/Algorithm"

    # the pipeline built when no pipe is wired, one per device
    _cached: dict = {}

    @classmethod
    def _default_pipe(cls):
        from ..models.zero123plus import Zero123PlusPipeline
        from .nodes_diffusers import ckpt_diffusers_path, has_weights
        dev = base.node_device()
        if dev not in cls._cached:
            default = os.path.join(ckpt_diffusers_path(), "sudo-ai",
                                   "zero123plus-v1.2")
            if has_weights(default):
                cls._cached[dev] = Zero123PlusPipeline.from_pretrained(
                    default, device=dev)
            else:
                print("[Zero123Plus] no pipe wired and no local "
                      f"checkpoint at {default} — random weights")
                cls._cached[dev] = Zero123PlusPipeline.init_random(device=dev)
        return cls._cached[dev]

    def run_model(self, zero123plus_pipe=None, reference_image=None,
                  reference_mask=None, seed=1234, guidance_scale=4.0,
                  num_inference_steps=28, **_):
        pipe = zero123plus_pipe if zero123plus_pipe is not None \
            else self._default_pipe()
        img = img_utils.composite_background(
            image_tensor(reference_image), image_tensor(reference_mask),
            (1.0, 1.0, 1.0))[0]
        grid = pipe(img, num_inference_steps=int(num_inference_steps),
                    guidance_scale=float(guidance_scale),
                    seed=int(seed) % (2 ** 31))
        # 3 rows × 2 columns of views, row by row → [6, S, S, 3]
        views = img_utils.split_image_grid(grid.detach().cpu(), 3, 2)
        camposes = [[1.2, e, a, 0.0, 0.0, 0.0]
                    for e, a in ORBITPOSE_PRESETS["Zero123Plus(6)"]]
        return (views.contiguous(), camposes)


@register
class MVDream_Model:
    """reference nodes.py:1716: text (or, for ImageDream, the reference
    image) → four orbit views. The prompt strings are not read (no
    tokenizer vocab ships here; the pipeline's default embedding is the
    checkpoint's empty prompt), as the JAX node does. An ImageDream
    pipeline (`ip_dim` > 0) takes the reference image composited on white
    through its mask."""

    @classmethod
    def INPUT_TYPES(cls):
        # widget ORDER must match the reference (nodes.py:1719-1734):
        # workflow JSONs carry positional widgets_values
        return {"required": {
            "mvdream_pipe": ("DIFFUSERS_PIPE",),
            "reference_image": ("IMAGE",),
            "reference_mask": ("MASK",),
            "prompt": ("STRING", {"default": "", "multiline": True}),
            "prompt_neg": ("STRING", {
                "default": "ugly, blurry, pixelated obscure, unnatural "
                "colors, poor lighting, dull, unclear, cropped, lowres, "
                "low quality, artifacts, duplicate", "multiline": True}),
            "seed": ("INT", {"default": 0, "min": 0,
                             "max": 0xffffffffffffffff}),
            "mv_guidance_scale": ("FLOAT", {"default": 5.0,
                                            "min": 0.0, "step": 0.01}),
            "num_inference_steps": ("INT", {"default": 30, "min": 1}),
            "elevation": ("FLOAT", {"default": 0.0}),
        }}

    RETURN_TYPES = ("IMAGE", "ORBIT_CAMPOSES")
    RETURN_NAMES = ("multiview_images", "orbit_camposes")
    FUNCTION = "run_model"
    CATEGORY = "Comfy3D/Algorithm"

    def run_model(self, mvdream_pipe, reference_image, reference_mask,
                  prompt="", prompt_neg="", seed=42,
                  mv_guidance_scale=7.0,
                  num_inference_steps=30, elevation=0.0):
        image = None
        if mvdream_pipe.cfg.ip_dim > 0 and reference_image is not None:
            image = image_tensor(reference_image)
            if reference_mask is not None:
                image = img_utils.composite_background(
                    image, image_tensor(reference_mask), (1.0, 1.0, 1.0))
            image = image[0]
        out = mvdream_pipe(
            image=image, num_inference_steps=int(num_inference_steps),
            guidance_scale=float(mv_guidance_scale),
            generator=torch.Generator().manual_seed(int(seed)),
            elevation=elevation).detach().cpu()
        camposes = [[4.0, e, a, 0.0, 0.0, 0.0]
                    for e, a in ORBITPOSE_PRESETS["MVDream(4)"]]
        return (out, camposes[:out.shape[0]])


@register
class Load_Large_Multiview_Gaussian_Model(_CheckpointLoader):
    """reference nodes.py:1785"""

    checkpoints_dir = "LGM"
    default_ckpt_name = "model_fp16.safetensors"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"model_name": (cls._names(),)}}

    RETURN_TYPES = ("LGM_MODEL",)
    RETURN_NAMES = ("lgm_model",)
    FUNCTION = "load_LGM"
    CATEGORY = "Comfy3D/Import|Export"

    def load_LGM(self, model_name="model_fp16.safetensors"):
        from ..models.lgm import LGMPipeline
        dev = base.node_device()
        ckpt = self._ckpt(model_name)
        if os.path.exists(ckpt):
            print(f"[Load_LGM] loading {ckpt}")
            return (LGMPipeline.from_pretrained(ckpt, device=dev),)
        print(f"[Load_LGM] checkpoint {ckpt} not found — random "
              "weights")
        return (LGMPipeline.init_random(device=dev),)


@register
class Large_Multiview_Gaussian_Model:
    """reference nodes.py:1837: four views → 3D Gaussians."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "lgm_model": ("LGM_MODEL",),
            "multiview_images": ("IMAGE",),
        }}

    RETURN_TYPES = ("GS_PLY",)
    RETURN_NAMES = ("gs_ply",)
    FUNCTION = "run_LGM"
    CATEGORY = "Comfy3D/Algorithm"

    def run_LGM(self, lgm_model, multiview_images):
        imgs = image_tensor(multiview_images)
        if imgs.shape[0] != lgm_model.cfg.num_views:
            return error_none(
                self.__class__.__name__,
                f"expected {lgm_model.cfg.num_views} views, got "
                f"{imgs.shape[0]}")
        return (lgm_model.forward_gaussians(imgs),)


def _rgb_on_white(image) -> torch.Tensor:
    """The first image of a batch, an RGBA one composited on white."""
    img = image_tensor(image)
    if img.dim() == 4:
        img = img[0]
    if img.shape[-1] == 4:
        a = img[..., 3:4]
        img = img[..., :3] * a + (1.0 - a)
    return img


@register
class TripoSG_I23D_Model:
    """reference nodes.py:4157 — image (+ mask) → mesh by rectified-flow
    latent-set diffusion."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "tsg_pipe": ("DIFFUSERS_PIPE",),
                "reference_image": ("IMAGE",),
                "seed": ("INT", {"default": 42, "min": 0,
                                 "max": 0xffffffffffffffff}),
                "guidance_scale": ("FLOAT", {"default": 7.0, "min": 0.0,
                                             "step": 0.01}),
                "num_inference_steps": ("INT", {"default": 50, "min": 1}),
                "use_flash_decoder": ("BOOLEAN", {"default": True}),
                "flash_octree_depth": ("INT", {"default": 9, "min": 1}),
                "hierarchical_octree_depth": ("INT", {"default": 9,
                                                      "min": 1}),
                "dense_octree_depth": ("INT", {"default": 8, "min": 1}),
            },
            "optional": {"reference_mask": ("MASK",)},
        }

    RETURN_TYPES = ("MESH",)
    RETURN_NAMES = ("mesh",)
    FUNCTION = "run_model"
    CATEGORY = "Comfy3D/Algorithm"

    def run_model(self, tsg_pipe, reference_image, seed=42,
                  guidance_scale=7.0, num_inference_steps=50,
                  use_flash_decoder=True, flash_octree_depth=9,
                  hierarchical_octree_depth=9, dense_octree_depth=8,
                  reference_mask=None, **_):
        if reference_mask is not None:
            img = img_utils.composite_background(
                image_tensor(reference_image), image_tensor(reference_mask))[0]
        else:
            img = _rgb_on_white(reference_image)
        mesh = tsg_pipe(img, seed=int(seed),
                        num_steps=int(num_inference_steps),
                        guidance_scale=float(guidance_scale),
                        octree_resolution=2 ** int(dense_octree_depth))[0]
        return (mesh.auto_normal(),)


@register
class Load_TripoSG_Pipeline:
    CATEGORY = "Comfy3D/Import|Export"
    RETURN_TYPES = ("DIFFUSERS_PIPE",)
    RETURN_NAMES = ("triposg_pipe",)
    FUNCTION = "load"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "repo_id": ("STRING", {"default": "VAST-AI/TripoSG",
                                   "multiline": False}),
        }}

    def load(self, repo_id="VAST-AI/TripoSG"):
        from .nodes_mvdiffusion import _load
        return (_load("TripoSGPipeline", repo_id, "Load_TripoSG_Pipeline"),)


@register
class TripoSG_Scribble_Model:
    """reference nodes.py:4217 — scribble sketch (+ prompt) → mesh through
    the CFG-distilled TripoSG-scribble DiT: the conditional pass alone, as
    the `TripoSGScribblePipeline` factory marks its pipeline
    (`is_scribble`)."""

    CATEGORY = "Comfy3D/Algorithm"
    RETURN_TYPES = ("MESH",)
    RETURN_NAMES = ("mesh",)
    FUNCTION = "run_model"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "tsg_scribble_pipe": ("DIFFUSERS_PIPE",),
            "scribble_image": ("IMAGE",),
            "prompt": ("STRING", {"default": "3D assets",
                                  "multiline": True}),
            "seed": ("INT", {"default": 42, "min": 0,
                             "max": 0xffffffffffffffff}),
            "num_inference_steps": ("INT", {"default": 16, "min": 1}),
            "scribble_confidence": ("FLOAT", {"default": 0.4,
                                              "min": 0.0, "step": 0.01}),
            "prompt_confidence": ("FLOAT", {"default": 1.0, "min": 0.0,
                                            "step": 0.01}),
            "dense_octree_depth": ("INT", {"default": 8, "min": 1}),
        }}

    def run_model(self, tsg_scribble_pipe, scribble_image,
                  prompt="3D assets", seed=42, num_inference_steps=16,
                  scribble_confidence=0.4, prompt_confidence=1.0,
                  dense_octree_depth=8, **_):
        mesh = tsg_scribble_pipe(
            _rgb_on_white(scribble_image), seed=int(seed),
            num_steps=int(num_inference_steps),
            octree_resolution=2 ** int(dense_octree_depth))[0]
        return (mesh.auto_normal(),)
