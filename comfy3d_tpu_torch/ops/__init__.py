"""Device ops: 3DGS projection, binning, the bin and tile compositors, SSIM.

Lazy imports, as in the package root."""

import importlib as _importlib

_SUBMODULES = ("binning", "gs_flat", "gs_render", "gs_tile", "ssim")


def __getattr__(name):
    if name in _SUBMODULES:
        return _importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
