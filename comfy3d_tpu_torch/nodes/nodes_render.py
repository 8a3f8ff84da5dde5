"""Renderer and optimisation nodes (reference nodes.py:1011-1413,
2685-2835).

Port of `comfy3d_tpu/nodes/nodes_render.py`. The renderers run on the
run's device (`base.node_device()`; a splat on its own device) and each
IMAGE / MASK output is copied to the host once; the GS orbit renderer
reaches the coarse-bin compositor kernel (K1′) once per view, the 3DGS
fit its forward and backward kernels (K1′, K3′) once per view of each
step; `Fitting_Mesh_With_Multiview_Images` fits a mesh to views on the
run's device (`algorithms/diff_mesh.py`).

Not ported: `FlexiCubes_MVS` (`sdf_fit`: ROADMAP A.10).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.camera import ORBITPOSE_PRESETS, Camera
from ..core.gaussian import GaussianSplat
from ..ops import gs_render, mesh_render
from . import base
from .base import error_none, image_tensor, register


def _cams_from_poses(orbit_camposes, fovy, width, height, device):
    return Camera.from_camposes(orbit_camposes, fovy_deg=fovy, width=width,
                                height=height, device=device)


@register
class Mesh_Orbit_Renderer:
    """reference nodes.py:1011"""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "mesh": ("MESH",),
            "render_image_size": ("INT", {"default": 512, "min": 64,
                                          "max": 4096}),
            "render_orbit_camera_poses": ("ORBIT_CAMPOSES",),
            "render_orbit_camera_fovy": ("FLOAT", {"default": 49.1}),
            "render_background_color_r": ("FLOAT", {"default": 1.0}),
            "render_background_color_g": ("FLOAT", {"default": 1.0}),
            "render_background_color_b": ("FLOAT", {"default": 1.0}),
        }}

    # reference order (nodes.py:1033-1046): images, masks, depths,
    # normals, viewcos
    RETURN_TYPES = ("IMAGE", "MASK", "IMAGE", "IMAGE", "IMAGE")
    RETURN_NAMES = ("rendered_mesh_images", "rendered_mesh_masks",
                    "all_rendered_depths", "all_rendered_normals",
                    "all_rendered_viewcos")
    FUNCTION = "render_mesh"
    CATEGORY = "Comfy3D/Algorithm"

    def render_mesh(self, mesh, render_image_size,
                    render_orbit_camera_poses, render_orbit_camera_fovy,
                    render_background_color_r=1.0,
                    render_background_color_g=1.0,
                    render_background_color_b=1.0):
        dev = base.node_device()
        cams = _cams_from_poses(render_orbit_camera_poses,
                                render_orbit_camera_fovy,
                                render_image_size, render_image_size, dev)
        bg = torch.tensor([render_background_color_r,
                           render_background_color_g,
                           render_background_color_b], device=dev)

        def t(a):
            return torch.as_tensor(a, device=dev)

        if mesh.vt is not None and mesh.ft is not None \
                and mesh.albedo is not None:
            # face-varying UVs take the unpadded faces
            out = mesh_render.render_mesh(
                t(mesh.v), t(mesh.f), cams,
                vn=t(mesh.vn) if mesh.vn is not None else None,
                vt=t(mesh.vt), ft=t(mesh.ft), albedo=t(mesh.albedo),
                background=bg)
        else:
            d = mesh.device_arrays(device=dev)
            kw = {"vc": d["vc"]} if mesh.vc is not None else {}
            out = mesh_render.render_mesh(
                d["v"], d["f"], cams, background=bg,
                face_valid=torch.arange(d["f"].shape[0], device=dev)
                < mesh.num_faces, **kw)
        depth = out["depth"][..., None].expand(
            *out["depth"].shape, 3)
        depth = depth / depth.max().clamp_min(1e-6)
        viewcos = out["viewcos"]
        if viewcos.ndim == 3:
            viewcos = viewcos[..., None].expand(*viewcos.shape, 3)
        return (image_tensor(out["image"]), image_tensor(out["alpha"]),
                image_tensor(depth), image_tensor(out["normal"] * 0.5 + 0.5),
                image_tensor(viewcos))


@register
class Gaussian_Splatting_Orbit_Renderer:
    """reference nodes.py:1100"""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "gs_ply": ("GS_PLY",),
            "render_image_size": ("INT", {"default": 512, "min": 64,
                                          "max": 4096}),
            "render_orbit_camera_poses": ("ORBIT_CAMPOSES",),
            "render_orbit_camera_fovy": ("FLOAT", {"default": 49.1}),
            "render_background_color_r": ("FLOAT", {"default": 1.0}),
            "render_background_color_g": ("FLOAT", {"default": 1.0}),
            "render_background_color_b": ("FLOAT", {"default": 1.0}),
        }}

    # the reference (nodes.py:1116-1125) also returns per-view depths
    RETURN_TYPES = ("IMAGE", "MASK", "IMAGE")
    RETURN_NAMES = ("rendered_gs_images", "rendered_gs_masks",
                    "rendered_gs_depths")
    FUNCTION = "render_gs"
    CATEGORY = "Comfy3D/Algorithm"

    def render_gs(self, gs_ply, render_image_size,
                  render_orbit_camera_poses, render_orbit_camera_fovy,
                  render_background_color_r=1.0,
                  render_background_color_g=1.0,
                  render_background_color_b=1.0):
        cams = _cams_from_poses(render_orbit_camera_poses,
                                render_orbit_camera_fovy,
                                render_image_size, render_image_size,
                                gs_ply.device)
        out = gs_render.render(
            gs_ply, cams,
            background=(render_background_color_r,
                        render_background_color_g,
                        render_background_color_b))
        depth = out["depth"]
        if depth.ndim == 3:
            depth = depth[..., None].expand(*depth.shape, 3)
        # normalised by the whole batch's maximum, on the device
        depth = depth / depth.max().clamp_min(1e-6)
        return (image_tensor(out["image"]), image_tensor(out["alpha"]),
                image_tensor(depth))


@register
class Gaussian_Splatting_3D:
    """reference nodes.py:1165: multi-view 3DGS optimisation."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "reference_images": ("IMAGE",),
                "reference_masks": ("MASK",),
                "reference_orbit_camera_poses": ("ORBIT_CAMPOSES",),
                "reference_orbit_camera_fovy": ("FLOAT",
                                                {"default": 49.1}),
                "training_iterations": ("INT", {"default": 30000,
                                                "min": 1}),
                "batch_size": ("INT", {"default": 1, "min": 1}),
                "ms_ssim_loss_weight": ("FLOAT", {"default": 0.2}),
                "alpha_loss_weight": ("FLOAT", {"default": 3.0}),
                "offset_loss_weight": ("FLOAT", {"default": 0.0}),
                "offset_opacity_loss_weight": ("FLOAT", {"default": 0.0}),
                "invert_background_probability": ("FLOAT",
                                                  {"default": 0.5}),
            },
            "optional": {
                "points_cloud_to_initialize_gaussian": ("POINTCLOUD",),
                "ply_to_initialize_gaussian": ("GS_PLY",),
                "mesh_to_initialize_gaussian": ("MESH",),
            },
        }

    RETURN_TYPES = ("GS_PLY",)
    RETURN_NAMES = ("gs_ply",)
    FUNCTION = "run_gs"
    CATEGORY = "Comfy3D/Algorithm"

    def run_gs(self, reference_images, reference_masks,
               reference_orbit_camera_poses, reference_orbit_camera_fovy,
               training_iterations=30000, batch_size=1,
               ms_ssim_loss_weight=0.2, alpha_loss_weight=3.0,
               offset_loss_weight=0.0, offset_opacity_loss_weight=0.0,
               invert_background_probability=0.5,
               points_cloud_to_initialize_gaussian=None,
               ply_to_initialize_gaussian=None,
               mesh_to_initialize_gaussian=None):
        from ..algorithms import gs_trainer

        dev = base.node_device()
        imgs = image_tensor(reference_images)
        masks = image_tensor(reference_masks)
        if len(imgs) != len(reference_orbit_camera_poses):
            return error_none(
                self.__class__.__name__,
                f"number of reference images {len(imgs)} != number of "
                f"camera poses {len(reference_orbit_camera_poses)}")
        if ply_to_initialize_gaussian is not None:
            splat = ply_to_initialize_gaussian
            dev = splat.device
        elif points_cloud_to_initialize_gaussian is not None:
            pc = points_cloud_to_initialize_gaussian
            splat = GaussianSplat.from_points(
                pc["points"], colors=pc.get("colors"), capacity=65536,
                device=dev)
        elif mesh_to_initialize_gaussian is not None:
            pts, cols = mesh_to_initialize_gaussian.convert_to_pointcloud()
            splat = GaussianSplat.from_points(pts, colors=cols,
                                              capacity=65536, device=dev)
        else:
            # 5,000 points in a ball of radius 0.5, from a generator seeded
            # 0 on the device (the JAX package draws from PRNGKey(0)),
            # padded to 65,536
            splat = GaussianSplat.random(
                torch.Generator(dev).manual_seed(0), 5000, radius=0.5,
                device=dev)
            splat = GaussianSplat.from_points(
                splat.xyz[splat.alive].cpu().numpy(), capacity=65536,
                device=dev)
        cams = _cams_from_poses(reference_orbit_camera_poses,
                                reference_orbit_camera_fovy,
                                imgs.shape[2], imgs.shape[1], dev)
        cfg = gs_trainer.GSTrainConfig(
            iterations=training_iterations, batch_size=batch_size,
            lambda_ssim=ms_ssim_loss_weight,
            lambda_alpha=alpha_loss_weight,
            invert_bg_prob=invert_background_probability)
        return (gs_trainer.train(splat, cams, imgs, masks, cfg),)


@register
class Instant_NGP:
    """reference nodes.py:2685: a NeRF fit and its mesh."""

    @classmethod
    def INPUT_TYPES(cls):
        # names and order mirror the reference (nodes.py:2688-2700):
        # workflow links address inputs by name, widgets by position
        return {"required": {
            "reference_image": ("IMAGE",),
            "reference_mask": ("MASK",),
            "reference_orbit_camera_poses": ("ORBIT_CAMPOSES",),
            "reference_orbit_camera_fovy": ("FLOAT", {"default": 49.1}),
            "training_iterations": ("INT", {"default": 512, "min": 1}),
            "training_resolution": ("INT", {"default": 128,
                                            "min": 16}),
            "marching_cude_grids_resolution": ("INT", {"default": 256,
                                                       "min": 1}),
            "marching_cude_grids_batch_size": ("INT", {"default": 128,
                                                       "min": 1}),
            "marching_cude_threshold": ("FLOAT", {"default": 10.0,
                                                  "min": 0.0}),
            "texture_resolution": ("INT", {"default": 1024,
                                           "min": 128}),
            "background_color": ("FLOAT", {"default": 1.0, "min": 0.0,
                                           "max": 1.0}),
            "force_cuda_rast": ("BOOLEAN", {"default": False}),
        }}

    RETURN_TYPES = ("MESH",)
    RETURN_NAMES = ("mesh",)
    FUNCTION = "run_instant_ngp"
    CATEGORY = "Comfy3D/Algorithm"

    def run_instant_ngp(self, reference_image, reference_mask,
                        reference_orbit_camera_poses,
                        reference_orbit_camera_fovy,
                        training_iterations=512,
                        training_resolution=128,
                        marching_cude_grids_resolution=256,
                        marching_cude_grids_batch_size=128,
                        marching_cude_threshold=10.0,
                        texture_resolution=1024, background_color=1.0,
                        force_cuda_rast=False, batch_size=4096, **_):
        from ..algorithms import ngp as ngp_mod
        from ..ops import tetra

        dev = base.node_device()
        imgs = image_tensor(reference_image)
        masks = image_tensor(reference_mask)
        cams = _cams_from_poses(reference_orbit_camera_poses,
                                reference_orbit_camera_fovy,
                                imgs.shape[2], imgs.shape[1], dev)
        cfg = ngp_mod.NGPConfig(iterations=training_iterations,
                                ray_batch=batch_size)
        field, _occ = ngp_mod.fit(cams, imgs, masks, cfg, device=dev)
        with torch.no_grad():
            grid = ngp_mod.density_grid(field, cfg,
                                        res=marching_cude_grids_resolution)
        bounds = (-cfg.bound, cfg.bound)
        mesh = tetra.extract_isosurface(grid, iso=marching_cude_threshold,
                                        bounds=bounds)
        if mesh.num_vertices == 0:
            # a short fit or a faint scene can sit wholly under the
            # threshold: retry at the field's 98th percentile
            adaptive = float(np.quantile(grid.cpu().numpy(), 0.98))
            print(f"[{self.__class__.__name__}] empty surface at "
                  f"threshold {marching_cude_threshold}; retrying at "
                  f"98th-percentile density {adaptive:.4f}")
            mesh = tetra.extract_isosurface(grid, iso=adaptive,
                                            bounds=bounds)
        if mesh.num_vertices == 0:
            return error_none(self.__class__.__name__,
                              "empty surface at threshold "
                              f"{marching_cude_threshold}")
        # vertex colours from the fitted field, seen from outside
        with torch.no_grad():
            v = torch.as_tensor(mesh.v, device=dev)
            dirs = -v / torch.linalg.vector_norm(
                v, dim=-1, keepdim=True).clamp_min(1e-8)
            _, rgb = field(v, dirs)
        mesh.vc = rgb.clamp(0, 1).cpu().numpy()
        return (mesh.auto_normal(),)


@register
class Convert_3DGS_to_Mesh_with_NeRF_and_Marching_Cubes:
    """reference nodes.py:1873 (LGM's GS→mesh converter role)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "gs_ply": ("GS_PLY",),
            "gs_config": (["Big", "Default", "Small"],
                          {"default": "Default"}),
            "training_nerf_iterations": ("INT", {"default": 384,
                                                 "min": 32}),
            "marching_cube_grids_resolution": ("INT", {"default": 192}),
            "marching_cube_threshold": ("FLOAT", {"default": 10.0}),
            "texture_resolution": ("INT", {"default": 1024}),
        }}

    RETURN_TYPES = ("MESH",)
    RETURN_NAMES = ("mesh",)
    FUNCTION = "convert_gs_to_mesh"
    CATEGORY = "Comfy3D/Algorithm"

    def convert_gs_to_mesh(self, gs_ply, gs_config="Default",
                           training_nerf_iterations=384,
                           marching_cube_grids_resolution=192,
                           marching_cube_threshold=10.0,
                           texture_resolution=1024):
        from ..algorithms import gs_to_mesh
        render_size = {"Big": 512, "Default": 256, "Small": 128}.get(
            gs_config, 256)
        cfg = gs_to_mesh.GSToMeshConfig(
            render_size=render_size,
            ngp_iters=training_nerf_iterations,
            grid_resolution=marching_cube_grids_resolution,
            density_threshold=marching_cube_threshold,
            texture_size=texture_resolution)
        return (gs_to_mesh.convert(gs_ply, cfg),)


@register
class Fitting_Mesh_With_Multiview_Images:
    """reference nodes.py:1315 — DiffRastMesh's textured-mesh fit."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "mesh": ("MESH",),
            "reference_images": ("IMAGE",),
            "reference_masks": ("MASK",),
            "reference_orbit_camera_poses": ("ORBIT_CAMPOSES",),
            "reference_orbit_camera_fovy": ("FLOAT", {"default": 49.1}),
            "training_iterations": ("INT", {"default": 1024, "min": 1}),
            "batch_size": ("INT", {"default": 3, "min": 1}),
            "texture_learning_rate": ("FLOAT", {"default": 0.1}),
            "train_mesh_geometry": ("BOOLEAN", {"default": True}),
            "remesh_after_n_iteration": ("INT", {"default": 512,
                                                 "min": 128,
                                                 "max": 100000}),
            "texture_resolution": ("INT", {"default": 512}),
        }}

    RETURN_TYPES = ("MESH",)
    RETURN_NAMES = ("trained_mesh",)
    FUNCTION = "fit_mesh"
    CATEGORY = "Comfy3D/Algorithm"

    def fit_mesh(self, mesh, reference_images, reference_masks,
                 reference_orbit_camera_poses,
                 reference_orbit_camera_fovy, training_iterations=1024,
                 batch_size=3, texture_learning_rate=0.1,
                 train_mesh_geometry=True, remesh_after_n_iteration=512,
                 texture_resolution=512):
        import dataclasses

        from ..algorithms import diff_mesh
        from ..ops import texture as texture_ops

        imgs = image_tensor(reference_images)
        masks = image_tensor(reference_masks)
        if len(imgs) != len(reference_orbit_camera_poses):
            return error_none(
                self.__class__.__name__,
                f"{len(imgs)} images != "
                f"{len(reference_orbit_camera_poses)} poses")
        cams = _cams_from_poses(reference_orbit_camera_poses,
                                reference_orbit_camera_fovy,
                                imgs.shape[2], imgs.shape[1],
                                base.node_device())
        if mesh.vt is None or mesh.ft is None:
            # the reference unwraps with xatlas
            vt, ft, _ = texture_ops.auto_unwrap(mesh.v, mesh.f)
            mesh = dataclasses.replace(mesh, vt=vt, ft=ft)
        cfg = diff_mesh.DiffMeshConfig(
            iterations=training_iterations, batch_size=batch_size,
            lr_texture=texture_learning_rate,
            lr_verts=1e-3 if train_mesh_geometry else 0.0,
            remesh_every=(remesh_after_n_iteration
                          if train_mesh_geometry else 0),
            texture_size=texture_resolution)
        return (diff_mesh.fit(mesh, cams, imgs, masks, cfg),)


@register
class OrbitPoses_JK:
    """reference nodes.py:3432: fixed orbit pose presets."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "preset": (list(ORBITPOSE_PRESETS.keys()),
                       {"default": "FOUR_VIEWS"}),
            "orbit_radius": ("FLOAT", {"default": 1.75}),
        }}

    RETURN_TYPES = ("ORBIT_CAMPOSES",)
    RETURN_NAMES = ("orbit_camposes",)
    FUNCTION = "get_camposes"
    CATEGORY = "Comfy3D/Preprocessor"

    def get_camposes(self, preset="FOUR_VIEWS", orbit_radius=1.75):
        return ([[orbit_radius, e, a, 0.0, 0.0, 0.0]
                 for e, a in ORBITPOSE_PRESETS[preset]],)
