"""Device ops: 3DGS projection, binning, the bin and tile compositors,
SSIM, volume decodes, marching tets, FlexiCubes, ray marching, the
hash-grid encoding, the mesh rasterizer (with the soft silhouette's
kernels) and renderer, and UV unwrapping and baking.

Lazy imports, as in the package root."""

import importlib as _importlib

_SUBMODULES = ("binning", "flexicubes", "gs_flat", "gs_render", "gs_tile",
               "hashgrid", "mesh_render", "rasterize", "raymarch", "ssim",
               "tetra", "texture", "uv_atlas", "volume")


def __getattr__(name):
    if name in _SUBMODULES:
        return _importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
