"""Diffusers-pipeline plumbing (reference nodes.py:1510, 1560).

Port of `comfy3d_tpu/nodes/nodes_diffusers.py`'s `Load_Diffusers_Pipeline`
and `Set_Diffusers_Pipeline_Scheduler`. The reference resolves pipeline
classes from DIFFUSERS_PIPE_DICT (nodes.py:146-161); each name maps to the
port's pipeline that fills that role, read from
`<CKPT_ROOT_PATH>/Diffusers/<repo_id>` when weights are there and else
built with random weights drawn on the run's device. The factory table
keeps all thirteen names, so the combo widget lists the JAX package's;
the factories of families not yet ported raise NotImplementedError naming
their ROADMAP A.10 family.

Not ported: `Set_Diffusers_Pipeline_State_Dict`,
`Load_Unique3D_Custom_UNet` and `Unique3D_MVDiffusion_Model` (A.10).
"""

from __future__ import annotations

import dataclasses
import os

from . import base
from .base import register


def ckpt_diffusers_path() -> str:
    """`<CKPT_ROOT_PATH>/Diffusers`, read at call time."""
    return os.path.join(base.CKPT_ROOT_PATH, "Diffusers")


def has_weights(path: str) -> bool:
    """Whether the directory tree holds a weights file: a real checkpoint,
    not one of the config skeletons the reference ships under
    `Checkpoints/` as placeholders."""
    if not os.path.isdir(path):
        return False
    for _root, _dirs, files in os.walk(path):
        for f in files:
            if f.endswith((".safetensors", ".bin", ".ckpt", ".pth")):
                return True
    return False


def _mvdream(ckpt_dir=None, device=None):
    from ..models.mvdream import MVDreamPipeline
    if ckpt_dir:
        return MVDreamPipeline.from_pretrained(ckpt_dir, device=device)
    return MVDreamPipeline.init_random(device=device)


def _zero123plus(ckpt_dir=None, device=None):
    from ..models.zero123plus import Zero123PlusPipeline
    if ckpt_dir:
        return Zero123PlusPipeline.from_pretrained(ckpt_dir, device=device)
    return Zero123PlusPipeline.init_random(device=device)


def _hunyuan_dit(ckpt_dir=None, device=None):
    from ..models.hunyuan3d import Hunyuan3DShapePipeline

    def find(subdir):
        # each file's extension on its own: a directory may mix
        # model.fp16.safetensors with model.fp16.ckpt
        for ext in ("safetensors", "ckpt"):
            cand = os.path.join(ckpt_dir, subdir, f"model.fp16.{ext}")
            if os.path.exists(cand):
                return cand
        return None

    if ckpt_dir:
        dit = find("hunyuan3d-dit-v2-0")
        vae = find("hunyuan3d-vae-v2-0")
        if dit and vae:
            return Hunyuan3DShapePipeline.from_pretrained(dit, vae,
                                                          device=device)
    return Hunyuan3DShapePipeline.init_random(device=device)


def _wonder3d(ckpt_dir=None, device=None):
    from ..models.wonder3d import Wonder3DPipeline
    if ckpt_dir:
        return Wonder3DPipeline.from_pretrained(ckpt_dir, device=device)
    return Wonder3DPipeline.init_random(device=device)


def _era3d(ckpt_dir=None, device=None):
    from ..models.era3d import Era3DPipeline
    if ckpt_dir:
        return Era3DPipeline.from_pretrained(ckpt_dir, device=device)
    return Era3DPipeline.init_random(device=device)


def _unported(family: str):
    def factory(ckpt_dir=None, device=None):
        raise NotImplementedError(
            f"the {family} pipeline is not ported (ROADMAP A.10: {family})")
    return factory


DIFFUSERS_PIPE_FACTORIES = {
    "MVDreamPipeline": _mvdream,
    "Wonder3DMVDiffusionPipeline": _wonder3d,
    "Zero123PlusPipeline": _zero123plus,
    "DiffusionPipeline": _zero123plus,
    "StableDiffusionPipeline": _unported("stablegen"),
    "Era3DPipeline": _era3d,
    "Unique3DImage2MVCustomPipeline": _unported("unique3d"),
    "Unique3DImageCustomPipeline": _unported("unique3d"),
    "HunYuan3DMVDStdPipeline": _unported("hunyuan3d_v1"),
    "Hunyuan3DMVDLitePipeline": _unported("hunyuan3d_v1"),
    "Hunyuan3DDiTFlowMatchingPipeline": _hunyuan_dit,
    "TripoSGPipeline": _unported("triposg"),
    "TripoSGScribblePipeline": _unported("triposg"),
}

DIFFUSERS_SCHEDULER_NAMES = [
    "EulerAncestralDiscreteScheduler",
    "EulerDiscreteScheduler",
    "DDIMScheduler",
    "DDIMParallelScheduler",
    "LCMScheduler",
    "KDPM2AncestralDiscreteScheduler",
    "KDPM2DiscreteScheduler",
]


@register
class Load_Diffusers_Pipeline:
    """reference nodes.py:1510: a pipeline by name."""

    CATEGORY = "Comfy3D/Import|Export"
    RETURN_TYPES = ("DIFFUSERS_PIPE",)
    RETURN_NAMES = ("pipe",)
    FUNCTION = "load_diffusers_pipe"

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "diffusers_pipeline_name":
                    (list(DIFFUSERS_PIPE_FACTORIES.keys()),),
                "repo_id": ("STRING",
                            {"default": "ashawkey/imagedream-ipmv-diffusers",
                             "multiline": False}),
                "custom_pipeline": ("STRING", {"default": "",
                                               "multiline": False}),
                "force_download": ("BOOLEAN", {"default": False}),
            },
            "optional": {
                "checkpoint_sub_dir": ("STRING", {"default": "",
                                                  "multiline": False}),
                "force_disable_xformers": ("BOOLEAN", {"default": False}),
            },
        }

    def load_diffusers_pipe(self, diffusers_pipeline_name, repo_id="",
                            custom_pipeline="", force_download=False,
                            checkpoint_sub_dir="",
                            force_disable_xformers=False):
        factory = DIFFUSERS_PIPE_FACTORIES[diffusers_pipeline_name]
        ckpt_dir = os.path.join(ckpt_diffusers_path(), repo_id)
        if checkpoint_sub_dir:
            ckpt_dir = os.path.join(ckpt_dir, checkpoint_sub_dir)
        dev = base.node_device()
        if has_weights(ckpt_dir):
            pipe = factory(ckpt_dir=ckpt_dir, device=dev)
            print(f"[Load_Diffusers_Pipeline] loaded "
                  f"{diffusers_pipeline_name} from {ckpt_dir}")
        else:
            print(f"[Load_Diffusers_Pipeline] no local checkpoint at "
                  f"{ckpt_dir} — initializing "
                  f"{diffusers_pipeline_name} with random weights")
            pipe = factory(device=dev)
        pipe.repo_id = repo_id
        return (pipe,)


@register
class Set_Diffusers_Pipeline_Scheduler:
    """reference nodes.py:1560: swap the sampler, always with trailing
    timestep spacing (the reference's `from_config(...,
    timestep_spacing='trailing')`)."""

    CATEGORY = "Comfy3D/Import|Export"
    RETURN_TYPES = ("DIFFUSERS_PIPE",)
    RETURN_NAMES = ("pipe",)
    FUNCTION = "set_pipe_scheduler"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "pipe": ("DIFFUSERS_PIPE",),
            "diffusers_scheduler_name": (DIFFUSERS_SCHEDULER_NAMES,),
        }}

    def set_pipe_scheduler(self, pipe, diffusers_scheduler_name):
        cfg = getattr(pipe, "cfg", None)
        if cfg is not None and hasattr(cfg, "scheduler"):
            sched = dataclasses.replace(cfg.scheduler,
                                        timestep_spacing="trailing")
            pipe.cfg = dataclasses.replace(cfg, scheduler=sched)
        pipe.scheduler_name = diffusers_scheduler_name
        return (pipe,)
