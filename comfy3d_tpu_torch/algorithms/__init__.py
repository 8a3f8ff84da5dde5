"""Optimisers over splats: the per-asset 3DGS trainer.

Lazy imports, as in the package root."""

import importlib as _importlib

_SUBMODULES = ("gs_trainer",)


def __getattr__(name):
    if name in _SUBMODULES:
        return _importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
