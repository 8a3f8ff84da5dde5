"""The node layer: ComfyUI-compatible node classes and the workflow
executor.

Port of `comfy3d_tpu/nodes/`. Importing the package registers every node
class (`load_node_mappings`) under the JAX package's keys, so the same
workflow dict runs on either package; `run_workflow(workflow, overrides,
verbose, device=None)` runs it on the card unless the caller asks for the
CPU. `UNPORTED` maps each key the JAX package registers and the port does
not to the ROADMAP item that brings it: a graph naming one raises
`WorkflowError`, as for an unknown type.
"""

from .base import NODE_CLASS_MAPPINGS, NODE_DISPLAY_NAME_MAPPINGS, register
from .graph import WorkflowError, load_node_mappings, run_workflow

# populate the registry on import (each module registers its classes)
load_node_mappings()


def _keys(item: str, *names: str) -> dict:
    return {f"[Comfy3D] {n}": item for n in names}


UNPORTED = {
    **_keys("A.10 charactergen", "Load CharacterGen MVDiffusion Model",
            "CharacterGen MVDiffusion Model",
            "Load CharacterGen Reconstruction Model",
            "CharacterGen Reconstruction Model"),
    **_keys("A.10 unique3d", "Set Diffusers Pipeline State Dict",
            "Load Unique3D Custom UNet", "Unique3D MVDiffusion Model",
            "Fast Normal Maps To Mesh", "ExplicitTarget Mesh Optimization"),
    **_keys("A.10 hunyuan3d_v1", "Load Hunyuan3D V2 ShapeGen Pipeline",
            "Hunyuan3D V2 DiT Flow Matching Model",
            "Hunyuan3D V2 ShapeGen MV", "Hunyuan3D V1 MVDiffusion Model",
            "Load Hunyuan3D V1 Reconstruction Model",
            "Hunyuan3D V1 Reconstruction Model",
            "Load Hunyuan3D V2 TexGen Pipeline", "Hunyuan3D V2 Paint Model",
            "Hunyuan3D V2 Paint Model Turbo MV"),
    **_keys("A.10 sf3d", "Load SF3D Model", "StableFast3D"),
    **_keys("A.10 tgs", "Load Triplane Gaussian Transformers",
            "Triplane Gaussian Transformers"),
    **_keys("A.10 craftsman", "Load Craftsman Shape Diffusion Model",
            "Craftsman Shape Diffusion Model"),
    **_keys("A.10 mvadapter", "Load MVAdapter IG2MV Pipeline",
            "MVAdapter IG2MV", "Load MVAdapter TG2MV Pipeline",
            "MVAdapter TG2MV", "Load MVAdapter Texture Pipeline",
            "MVAdapter Texture Projection"),
    **_keys("A.10 partcrafter", "Load PartCrafter Pipeline",
            "Load PartCrafter Scene Pipeline", "PartCrafter Generate"),
    **_keys("A.10 stablegen", "Load StableGen Trellis Pipeline",
            "Load StableGen StableX Pipeline",
            "StableGen StableX Process Image",
            "StableGen Trellis Image To 3D"),
    **_keys("A.10 trellis", "Load Trellis Structured 3D Latents Models",
            "Trellis Structured 3D Latents Models"),
    "UpscaleModelLoader": "A.10 esrgan",
    "ImageUpscaleWithModel": "A.10 esrgan",
}

__all__ = ["NODE_CLASS_MAPPINGS", "NODE_DISPLAY_NAME_MAPPINGS", "UNPORTED",
           "WorkflowError", "register", "run_workflow", "load_node_mappings"]
