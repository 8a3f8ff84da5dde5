"""The model zoo: shared transformer blocks (`common`), the diffusion
substrate (`diffusion`: UNet, VAE, the samplers, the diffusers directory
loaders), CLIP's text and vision encoders (`clip`), DINOv2 (`dinov2`), the vecset substrate (`vecset`: ShapeVAE and
its octree decode, the flow DiT and its schedule), checkpoint files
(`loader`) and the model families (`triposr`, `instantmesh`, `mvdream`,
`lgm`, `zero123plus`, `hunyuan3d`: shape generation and paint, `crm`:
the convolutional reconstruction model and CRM T2I's adapter, `triposg`:
image / scribble → mesh).

Lazy imports, as in the package root."""

import importlib as _importlib

_SUBMODULES = ("clip", "common", "crm", "diffusion", "dinov2", "hunyuan3d",
               "instantmesh", "lgm", "loader", "mvdream", "triposg", "triposr",
               "vecset", "zero123plus")


def __getattr__(name):
    if name in _SUBMODULES:
        return _importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
