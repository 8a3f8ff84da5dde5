"""Device ops: 3DGS projection, binning, the bin and tile compositors,
SSIM, volume decodes, marching tets, ray marching, and the mesh
rasterizer and renderer.

Lazy imports, as in the package root."""

import importlib as _importlib

_SUBMODULES = ("binning", "gs_flat", "gs_render", "gs_tile", "mesh_render",
               "rasterize", "raymarch", "ssim", "tetra", "volume")


def __getattr__(name):
    if name in _SUBMODULES:
        return _importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
