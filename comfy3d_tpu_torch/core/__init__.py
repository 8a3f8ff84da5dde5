"""Core containers, cameras, SH, meshes, and file I/O."""

from . import camera, gaussian, io, mesh, sh
from .camera import Camera, compose_orbit_camposes, get_rays, orbit_c2w
from .gaussian import GaussianSplat
from .mesh import Mesh

__all__ = [
    "camera", "gaussian", "io", "mesh", "sh",
    "Camera", "GaussianSplat", "Mesh",
    "compose_orbit_camposes", "get_rays", "orbit_c2w",
]
