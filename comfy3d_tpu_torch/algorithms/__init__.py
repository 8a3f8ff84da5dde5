"""Per-asset optimisers: the 3DGS trainer, the Instant-NGP NeRF fit, and
the GS→mesh converter built on it; the multi-view colour projection and
bake of Hunyuan3D paint (`color_project`).

Lazy imports, as in the package root."""

import importlib as _importlib

_SUBMODULES = ("color_project", "gs_to_mesh", "gs_trainer", "ngp")


def __getattr__(name):
    if name in _SUBMODULES:
        return _importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
