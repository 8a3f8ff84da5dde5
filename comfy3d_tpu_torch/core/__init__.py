"""Core containers, cameras, SH, and splat file I/O."""

from . import camera, gaussian, io, sh
from .camera import Camera, compose_orbit_camposes, get_rays, orbit_c2w
from .gaussian import GaussianSplat

__all__ = [
    "camera", "gaussian", "io", "sh",
    "Camera", "GaussianSplat",
    "compose_orbit_camposes", "get_rays", "orbit_c2w",
]
