"""Texture and colour-projection nodes (reference nodes.py:3045, 3137,
5277, 5472).

Port of `comfy3d_tpu/nodes/nodes_texture.py`'s `ExplicitTarget_Color_
Projection`, `Convert_Vertex_Color_To_Texture` and the Hunyuan3D-2.1
TexGen nodes. The bakes run on the run's device (`base.node_device()`);
meshes stay host `Mesh`es. Unlike the JAX package, the TexGen loader
raises NotImplementedError when a RealESRGAN checkpoint is present, rather
than wiring superres in (ESRGAN: ROADMAP A.10).

Not ported (ROADMAP A.10): the V2 paint nodes
(`Load_Hunyuan3D_V2_TexGen_Pipeline`, `Hunyuan3D_V2_Paint_Model`,
`Hunyuan3D_V2_Paint_Model_Turbo_MV`).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import native
from ..core.camera import Camera
from ..core.image import composite_background
from ..core.mesh import Mesh
from . import base
from .base import error_none, image_batch, image_tensor, register

REMESH_FACES = 40_000    # the TexGen node's `use_remesh` target
TEXGEN_STEPS = {"Turbo": 8, "Standard": 25}


@register
class ExplicitTarget_Color_Projection:
    """reference nodes.py:3045: multi-view images projected onto a mesh's
    vertex colours (Unique3D's `multiview_color_projection` role)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "mesh": ("MESH",),
            "reference_images": ("IMAGE",),
            "reference_masks": ("MASK",),
            "projection_resolution": ("INT", {"default": 1024,
                                              "min": 128, "max": 8192}),
            "complete_unseen_rgb": ("BOOLEAN", {"default": True}),
            "render_orbit_camera_fovy": ("FLOAT",
                                         {"default": 47.5, "min": 0.0,
                                          "max": 180.0, "step": 0.1}),
            "projection_weights": ("STRING",
                                   {"default": "2.0, 0.2, 1.0, 0.2"}),
            "confidence_threshold": ("FLOAT",
                                     {"default": 0.02, "min": 0.001,
                                      "max": 1.0, "step": 0.001}),
        }, "optional": {
            "reference_orbit_camera_poses": ("ORBIT_CAMPOSES",),
        }}

    RETURN_TYPES = ("MESH",)
    RETURN_NAMES = ("mesh",)
    FUNCTION = "run_color_projection"
    CATEGORY = "Comfy3D/Algorithm"

    def run_color_projection(self, mesh, reference_images,
                             reference_masks,
                             projection_resolution=1024,
                             complete_unseen_rgb=True,
                             render_orbit_camera_fovy=47.5,
                             projection_weights="2.0, 0.2, 1.0, 0.2",
                             confidence_threshold=0.02,
                             reference_orbit_camera_poses=None):
        from ..algorithms import color_project
        dev = base.node_device()
        imgs = composite_background(image_tensor(reference_images),
                                    image_tensor(reference_masks),
                                    (1.0, 1.0, 1.0))
        n = imgs.shape[0]
        if reference_orbit_camera_poses is None:
            az = np.linspace(0.0, 360.0, n, endpoint=False)
            poses = [[1.8, 0.0, a, 0, 0, 0] for a in az]
        else:
            poses = reference_orbit_camera_poses
        if len(poses) != n:
            return error_none(self.__class__.__name__,
                              f"{n} images vs {len(poses)} poses")
        poses = torch.as_tensor(np.asarray(poses, np.float32))
        cams = Camera.from_orbit(
            poses[:, 1], poses[:, 2], poses[:, 0], target=poses[:, 3:6],
            fovy_deg=render_orbit_camera_fovy,
            width=int(projection_resolution),
            height=int(projection_resolution), device=dev)
        return (color_project.project_and_inpaint(
            mesh, imgs, cams,
            confidence_min=float(confidence_threshold)
            if complete_unseen_rgb else -1.0, device=dev),)


@register
class Convert_Vertex_Color_To_Texture:
    """reference nodes.py:3137: vertex colours → a UV albedo texture."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "mesh": ("MESH",),
            "texture_resolution": ("INT", {"default": 1024, "min": 128,
                                           "max": 8192}),
            "batch_size": ("INT", {"default": 128, "min": 1}),
        }}

    RETURN_TYPES = ("MESH",)
    RETURN_NAMES = ("mesh",)
    FUNCTION = "run_convert_func"
    CATEGORY = "Comfy3D/Algorithm"

    def run_convert_func(self, mesh, texture_resolution=1024,
                         batch_size=128):
        from ..ops import texture as T
        if mesh.vc is None:
            print(f"[{self.__class__.__name__}] no vertex colors; "
                  "skipping")
            return (mesh,)
        if mesh.vt is None or mesh.ft is None:
            vt, ft, _ = T.auto_unwrap(mesh.v, mesh.f)
            mesh = dataclasses.replace(mesh, vt=vt, ft=ft)
        albedo = T.bake_vertex_colors(
            mesh.v, mesh.f, mesh.vt, mesh.ft, mesh.vc,
            texture_size=int(texture_resolution), device=base.node_device())
        return (dataclasses.replace(mesh, albedo=albedo.cpu().numpy()),)


def texgen_remesh(mesh: Mesh, faces: int | None = None) -> Mesh:
    """The TexGen node's `use_remesh` (upstream hy3dpaint `remesh_mesh`,
    `utils/simplify_mesh_utils.py:19-32`): QEM decimation to `faces`
    (default `REMESH_FACES`) before the UV wrap and texturing, then vertex
    normals."""
    v, f = native.decimate_mesh(np.asarray(mesh.v), np.asarray(mesh.f),
                                REMESH_FACES if faces is None else faces)
    return dataclasses.replace(mesh, v=v, f=f, vn=None, fn=None, vt=None,
                               ft=None, vc=None, albedo=None).auto_normal()


def texgen_image(image) -> np.ndarray:
    """The TexGen node's reference image: the first [H, W, C], an RGBA one
    composited on white, as [H, W, 3] numpy."""
    img = image_batch(image)[0].numpy()
    if img.shape[-1] == 4:
        a = img[..., 3:4]
        img = img[..., :3] * a + (1.0 - a)
    return img


@register
class Hunyuan3D_21_TexGen:
    """reference nodes.py:5472: a textured mesh from a reference image
    through the PBR multi-view paint pipeline
    (hy3dpaint/textureGenPipeline.py:97-217); a single-view projection bake
    when the pipe is no paint pipeline."""

    CATEGORY = "Comfy3D/Algorithm/Hunyuan3D-2.1"
    RETURN_TYPES = ("MESH",)
    RETURN_NAMES = ("textured_mesh",)
    FUNCTION = "generate"

    @classmethod
    def INPUT_TYPES(cls):
        # the reference contract (nodes.py:5475-5484): the mesh arrives as
        # a FILE PATH (linked from Save 3D Mesh's STRING output)
        return {
            "required": {
                "texgen_pipe": ("DIFFUSERS_PIPE",),
                "mesh_path": ("STRING", {"default": ""}),
                "image": ("IMAGE",),
                "create_pbr": ("BOOLEAN", {"default": True}),
                "use_remesh": ("BOOLEAN", {"default": False}),
            },
            "optional": {
                "mesh": ("MESH",),
            },
        }

    def generate(self, texgen_pipe, mesh_path="", image=None,
                 create_pbr=True, use_remesh=False, mesh=None):
        from ..models.hunyuan3d import Hunyuan3DPaintPipeline
        if mesh is None:
            if not mesh_path or not os.path.exists(mesh_path):
                return error_none(self.__class__.__name__,
                                  f"mesh file not found: {mesh_path}")
            mesh = Mesh.load(mesh_path)
        if use_remesh:
            mesh = texgen_remesh(mesh)
        img = texgen_image(image)
        if isinstance(texgen_pipe, Hunyuan3DPaintPipeline):
            steps = getattr(texgen_pipe, "default_steps", 8)
            out = texgen_pipe(mesh, img, num_steps=steps)
            if not create_pbr:
                out.metallic_roughness = None
            return (out,)
        from ..algorithms import color_project
        dev = base.node_device()
        cam = Camera.from_orbit(0.0, 0.0, 1.9, width=img.shape[1],
                                height=img.shape[0], device=dev)
        mesh = color_project.bake_projection(mesh, img[None], cam,
                                             texture_size=1024, device=dev)
        return (mesh.auto_normal(),)


@register
class Load_Hunyuan3D_21_TexGen_Pipeline:
    """reference nodes.py:5277: the 2.1 PBR multi-view paint pipeline
    (hy3dpaint/textureGenPipeline.py:75-95): albedo and metallic-roughness
    attribute groups. A RealESRGAN checkpoint under
    `Checkpoints/RealESRGAN` raises (ESRGAN: ROADMAP A.10)."""

    CATEGORY = "Comfy3D/Algorithm/Hunyuan3D-2.1"
    RETURN_TYPES = ("DIFFUSERS_PIPE",)
    RETURN_NAMES = ("texgen_pipe",)
    FUNCTION = "load"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "model_variant": (["Turbo", "Standard"],),
        }}

    def load(self, model_variant="Turbo"):
        from ..models.hunyuan3d import Hunyuan3DPaintPipeline
        from ..models.hunyuan3d.paint import PaintConfig
        sr_ckpt = os.path.join(base.CKPT_ROOT_PATH, "RealESRGAN",
                               "RealESRGAN_x4plus.pth")
        if os.path.exists(sr_ckpt):
            raise NotImplementedError(
                f"RealESRGAN superres ({sr_ckpt}) is not ported (ROADMAP "
                "A.10: esrgan); move the checkpoint away to paint without "
                "it")
        dev = base.node_device()
        model_dir = os.path.join(base.CKPT_ROOT_PATH, "Diffusers",
                                 "tencent", "Hunyuan3D-2.1",
                                 "hunyuan3d-paintpbr-v2-1")
        if os.path.isdir(os.path.join(model_dir, "unet")):
            pipe = Hunyuan3DPaintPipeline.from_pretrained(model_dir, pbr=True,
                                                          device=dev)
        else:
            print("[Load_Hunyuan3D_21_TexGen_Pipeline] no local PBR "
                  f"paint checkpoint under {model_dir} — initializing "
                  "random weights")
            pipe = Hunyuan3DPaintPipeline.init_random(
                cfg=PaintConfig(pbr_settings=("albedo", "mr")), device=dev)
        pipe.default_steps = TEXGEN_STEPS[model_variant]
        return (pipe,)
