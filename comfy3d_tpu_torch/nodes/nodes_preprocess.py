"""Image, mask and mesh preprocessing and camera nodes (reference
nodes.py:417-1010).

Port of `comfy3d_tpu/nodes/nodes_preprocess.py`: images are float32 CPU
tensors through `core/image.py`; meshes stay on the host (the native mesh
ops); splats stay on their device."""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..core import image as img_utils
from ..core import sh as sh_utils
from ..core.mesh import Mesh
from .base import image_tensor, register


@register
class Image_Add_Pure_Color_Background:
    """reference nodes.py:417"""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "images": ("IMAGE",),
            "masks": ("MASK",),
            "R": ("INT", {"default": 255, "min": 0, "max": 255}),
            "G": ("INT", {"default": 255, "min": 0, "max": 255}),
            "B": ("INT", {"default": 255, "min": 0, "max": 255}),
        }}

    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("images",)
    FUNCTION = "add_background"
    CATEGORY = "Comfy3D/Preprocessor"

    def add_background(self, images, masks, R=255, G=255, B=255):
        return (img_utils.composite_background(
            image_tensor(images), image_tensor(masks),
            (R / 255.0, G / 255.0, B / 255.0)),)


@register
class Resize_Image_Foreground:
    """reference nodes.py:455"""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "images": ("IMAGE",),
            "masks": ("MASK",),
            "foreground_ratio": ("FLOAT", {"default": 0.85, "min": 0.01,
                                           "max": 1.0}),
        }}

    RETURN_TYPES = ("IMAGE", "MASK")
    RETURN_NAMES = ("images", "masks")
    FUNCTION = "resize_fg"
    CATEGORY = "Comfy3D/Preprocessor"

    def resize_fg(self, images, masks, foreground_ratio=0.85):
        imgs, ms = [], []
        for img, m in zip(image_tensor(images).numpy(),
                          image_tensor(masks).numpy()):
            i2, m2 = img_utils.resize_foreground(img, m, foreground_ratio)
            imgs.append(i2)
            ms.append(m2)
        return image_tensor(np.stack(imgs)), image_tensor(np.stack(ms))


@register
class Make_Image_Grid:
    """reference nodes.py:486"""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "images": ("IMAGE",),
            "grid_side_num": ("INT", {"default": 1, "min": 1,
                                      "max": 8192}),
            "use_rows": ("BOOLEAN", {"default": True}),
        }}

    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("image_grid",)
    FUNCTION = "make_image_grid"
    CATEGORY = "Comfy3D/Preprocessor"

    def make_image_grid(self, images, grid_side_num=1, use_rows=True):
        imgs = image_tensor(images)
        n = imgs.shape[0]
        side = max(1, int(grid_side_num))
        other = -(-n // side)
        rows, cols = (side, other) if use_rows else (other, side)
        pad = rows * cols - n
        if pad:
            imgs = torch.cat([imgs, imgs.new_zeros((pad,) + imgs.shape[1:])])
        return (img_utils.make_image_grid(imgs, rows, cols)[None],)


@register
class Split_Image_Grid:
    """reference nodes.py:523"""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "image": ("IMAGE",),
            "grid_side_num": ("INT", {"default": 1, "min": 1,
                                      "max": 8192}),
            "use_rows": ("BOOLEAN", {"default": True}),
        }}

    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("images",)
    FUNCTION = "split_grid"
    CATEGORY = "Comfy3D/Preprocessor"

    def split_grid(self, image, grid_side_num=1, use_rows=True):
        side = max(1, int(grid_side_num))
        outs = []
        for g in image_tensor(image):
            h, w = g.shape[0], g.shape[1]
            if use_rows:
                rows = side
                cols = max(1, round(w / (h / rows)))
            else:
                cols = side
                rows = max(1, round(h / (w / cols)))
            outs.append(img_utils.split_image_grid(g, rows, cols))
        return (torch.cat(outs),)


@register
class Get_Masks_From_Normal_Maps:
    """reference nodes.py:562"""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"normal_maps": ("IMAGE",)}}

    RETURN_TYPES = ("MASK",)
    RETURN_NAMES = ("masks",)
    FUNCTION = "get_masks"
    CATEGORY = "Comfy3D/Preprocessor"

    def get_masks(self, normal_maps):
        return (img_utils.masks_from_normal_maps(image_tensor(normal_maps)),)


@register
class Rotate_Normal_Maps_Horizontally:
    """reference nodes.py:588"""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "normal_maps": ("IMAGE",),
            "masks": ("MASK",),
            "azimuth_degree": ("FLOAT", {"default": 0.0}),
        }}

    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("normal_maps",)
    FUNCTION = "rotate"
    CATEGORY = "Comfy3D/Preprocessor"

    def rotate(self, normal_maps, masks, azimuth_degree=0.0):
        out = img_utils.rotate_normals_horizontally(
            image_tensor(normal_maps), azimuth_degree)
        return (out * image_tensor(masks)[..., None],)


@register
class Switch_Mesh_Axis:
    """reference nodes.py:707"""

    @classmethod
    def INPUT_TYPES(cls):
        axes = ["+x", "-x", "+y", "-y", "+z", "-z"]
        return {"required": {
            "mesh": ("MESH",),
            "axis_x_to": (axes, {"default": "+x"}),
            "axis_y_to": (axes, {"default": "+y"}),
            "axis_z_to": (axes, {"default": "+z"}),
            "flip_normal": ("BOOLEAN", {"default": False}),
        }}

    RETURN_TYPES = ("MESH",)
    RETURN_NAMES = ("switched_mesh",)
    FUNCTION = "switch_axis"
    CATEGORY = "Comfy3D/Preprocessor"

    def switch_axis(self, mesh, axis_x_to="+x", axis_y_to="+y",
                    axis_z_to="+z", flip_normal=False):
        out = mesh.switch_axis(f"{axis_x_to}{axis_y_to}{axis_z_to}")
        if flip_normal:
            out = out.flip_faces()
        return (out,)


@register
class Switch_3DGS_Axis:
    """reference nodes.py:676"""

    @classmethod
    def INPUT_TYPES(cls):
        axes = ["+x", "-x", "+y", "-y", "+z", "-z"]
        return {"required": {
            "gs_ply": ("GS_PLY",),
            "axis_x_to": (axes, {"default": "+x"}),
            "axis_y_to": (axes, {"default": "+y"}),
            "axis_z_to": (axes, {"default": "+z"}),
        }}

    RETURN_TYPES = ("GS_PLY",)
    RETURN_NAMES = ("switched_gs_ply",)
    FUNCTION = "switch_axis"
    CATEGORY = "Comfy3D/Preprocessor"

    def switch_axis(self, gs_ply, axis_x_to="+x", axis_y_to="+y",
                    axis_z_to="+z"):
        return (gs_ply.switch_axis(f"{axis_x_to}{axis_y_to}{axis_z_to}"),)


@register
class Convert_Mesh_To_Pointcloud:
    """reference nodes.py:767"""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"mesh": ("MESH",)}}

    RETURN_TYPES = ("POINTCLOUD",)
    RETURN_NAMES = ("points_cloud",)
    FUNCTION = "convert"
    CATEGORY = "Comfy3D/Preprocessor"

    def convert(self, mesh):
        pts, cols = mesh.convert_to_pointcloud()
        return ({"points": pts, "colors": cols},)


@register
class Convert_3DGS_To_Pointcloud:
    """reference nodes.py:742"""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"gs_ply": ("GS_PLY",)}}

    RETURN_TYPES = ("POINTCLOUD",)
    RETURN_NAMES = ("points_cloud",)
    FUNCTION = "convert"
    CATEGORY = "Comfy3D/Preprocessor"

    def convert(self, gs_ply):
        alive = gs_ply.alive
        cols = sh_utils.sh_to_rgb(gs_ply.sh[:, 0, :])[alive].clamp(0, 1)
        return ({"points": gs_ply.xyz[alive].cpu().numpy(),
                 "colors": cols.cpu().numpy()},)


@register
class Stack_Orbit_Camera_Poses:
    """reference nodes.py:792: the cartesian pose stacker."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "orbit_radius_start": ("FLOAT", {"default": 1.75}),
            "orbit_radius_stop": ("FLOAT", {"default": 1.75}),
            "orbit_radius_step": ("FLOAT", {"default": 0.1}),
            "elevation_start": ("FLOAT", {"default": 0.0}),
            "elevation_stop": ("FLOAT", {"default": 0.0}),
            "elevation_step": ("FLOAT", {"default": 30.0}),
            "azimuth_start": ("FLOAT", {"default": 0.0}),
            "azimuth_stop": ("FLOAT", {"default": 360.0}),
            "azimuth_step": ("FLOAT", {"default": 30.0}),
        }}

    RETURN_TYPES = ("ORBIT_CAMPOSES", "FLOAT", "FLOAT", "FLOAT")
    RETURN_NAMES = ("orbit_camposes", "orbit_radius_list",
                    "elevation_list", "azimuth_list")
    FUNCTION = "stack_poses"
    CATEGORY = "Comfy3D/Preprocessor"

    def stack_poses(self, orbit_radius_start=1.75, orbit_radius_stop=1.75,
                    orbit_radius_step=0.1, elevation_start=0.0,
                    elevation_stop=0.0, elevation_step=30.0,
                    azimuth_start=0.0, azimuth_stop=360.0,
                    azimuth_step=30.0):
        def span(a, b, s):
            if s <= 0 or a == b:
                return [a]
            n = max(int(round(abs(b - a) / s)), 1)
            sign = 1.0 if b >= a else -1.0
            return [a + sign * s * i for i in range(n)]

        radii = span(orbit_radius_start, orbit_radius_stop,
                     orbit_radius_step)
        elevs = span(elevation_start, elevation_stop, elevation_step)
        azims = span(azimuth_start, azimuth_stop, azimuth_step)
        poses, rl, el, al = [], [], [], []
        for r in radii:
            for e in elevs:
                for a in azims:
                    poses.append([r, e, a % 360.0, 0.0, 0.0, 0.0])
                    rl.append(r)
                    el.append(e)
                    al.append(a % 360.0)
        return poses, rl, el, al


@register
class Get_Camposes_From_List_Indexed:
    """reference nodes.py:980"""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            # reference nodes.py:993 names this input
            # `original_orbit_camera_poses`; workflow JSONs link by name
            "original_orbit_camera_poses": ("ORBIT_CAMPOSES",),
            "indexes": ("STRING", {"default": "0"}),
        }}

    RETURN_TYPES = ("ORBIT_CAMPOSES",)
    RETURN_NAMES = ("orbit_camposes",)
    FUNCTION = "pick"
    CATEGORY = "Comfy3D/Preprocessor"

    def pick(self, original_orbit_camera_poses, indexes="0"):
        idx = [int(t) for t in str(indexes).replace(",", " ").split()]
        return ([original_orbit_camera_poses[i] for i in idx],)


@register
class Fast_Clean_Mesh:
    """reference nodes.py:618 (pymeshlab's clean role → native/)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "mesh": ("MESH",),
            "weld_epsilon": ("FLOAT", {"default": 1e-6, "min": 0.0}),
            "min_component_fraction": ("FLOAT", {"default": 0.05,
                                                 "min": 0.0, "max": 1.0}),
        }}

    RETURN_TYPES = ("MESH",)
    RETURN_NAMES = ("cleaned_mesh",)
    FUNCTION = "clean"
    CATEGORY = "Comfy3D/Preprocessor"

    def clean(self, mesh, weld_epsilon=1e-6, min_component_fraction=0.05):
        v, f = native.clean_mesh(mesh.v, mesh.f, weld_eps=weld_epsilon,
                                 min_component_frac=min_component_fraction)
        return (Mesh(v=v, f=f).auto_normal(),)


@register
class Decimate_Mesh:
    """reference nodes.py:649 (fast-simplification's role → native/)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "mesh": ("MESH",),
            "target_faces_num": ("INT", {"default": 50000, "min": 4}),
            "remesh": ("BOOLEAN", {"default": True}),
            "optimalplacement": ("BOOLEAN", {"default": True}),
        }}

    RETURN_TYPES = ("MESH",)
    RETURN_NAMES = ("decimated_mesh",)
    FUNCTION = "decimate"
    CATEGORY = "Comfy3D/Preprocessor"

    def decimate(self, mesh, target_faces_num=50000, remesh=True,
                 optimalplacement=True):
        # the native decimator always weighs the endpoints and the midpoint
        # (pymeshlab's `optimalplacement` knob has no counterpart)
        del optimalplacement
        v, f = native.decimate_mesh(mesh.v, mesh.f, target_faces_num)
        if remesh:
            # the reference follows decimation with pymeshlab's isotropic
            # explicit remeshing at 1 % (`mesh_utils.py:255-258`)
            v, f = native.isotropic_remesh(v, f, target_frac=0.01,
                                           iterations=3)
        return (Mesh(v=v, f=f).auto_normal(),)
