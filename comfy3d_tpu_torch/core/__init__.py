"""Core containers, cameras, SH, meshes, texture dilation, and file I/O."""

from . import camera, gaussian, image, io, mesh, sh
from .camera import Camera, compose_orbit_camposes, get_rays, orbit_c2w
from .gaussian import GaussianSplat
from .mesh import Mesh

__all__ = [
    "camera", "gaussian", "image", "io", "mesh", "sh",
    "Camera", "GaussianSplat", "Mesh",
    "compose_orbit_camposes", "get_rays", "orbit_c2w",
]
