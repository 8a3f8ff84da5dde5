"""CRM nodes (reference nodes.py:2155-2412, 3479-3790): the image → six
views → six CCMs → mesh chain, and CRM T2I's normal-map-conditioned views.

Port of `comfy3d_tpu/nodes/nodes_crm.py`. The two multi-view samplers are
ImageDream pipelines of six views (`MVDreamPipeline`): the pixel stage
conditions on the reference image (IP tokens and the pinned seventh
frame), the CCM stage also on the pixel views' latents (stage 2, 8 input
channels). The reconstructor is `CRMReconPipeline`. Loaders read
`<CKPT_ROOT_PATH>/CRM/*.pth` onto the run's device (`base.node_device()`);
without a file they print a notice and build the JAX package's fallback
configs with random weights drawn on that device. CRM T2I V2/V3 run the
pixel sampler without the image, conditioned by a T2I-Adapter on the
normal maps; V3 folds its LoRA / DoRA file into the sampler at load.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ..core import image as img_utils
from ..core.camera import ORBITPOSE_PRESETS
from . import base
from .base import image_batch, register


def _masked_ref(image, mask):
    """The reference image composited on white through its mask (reference
    nodes.py:2325-2326: `torch_imgs_to_pils` + `process_pixel_img`) →
    [H, W, 3] float32, or None."""
    if image is None:
        return None
    img = image_batch(image)[0]
    if mask is not None:
        m = image_batch(mask)[0]
        img = img * m[..., None] + (1.0 - m[..., None])
    return img


def _mvdream_6view(ckpt_path=None, stage2=False):
    """CRM's ImageDream 6-view sampler on the run's device: the checkpoint's
    (`from_ldm_checkpoint`, its input channels read from `conv_in`), or the
    JAX package's fallback with random weights: an SD-1.5-class UNet (8
    heads) with a 1,024-wide context and 16 IP tokens, 8 input channels
    for the CCM stage (`stage2`)."""
    from ..models.mvdream import MVDreamConfig, MVDreamPipeline
    dev = base.node_device()
    if ckpt_path:
        return MVDreamPipeline.from_ldm_checkpoint(ckpt_path, device=dev,
                                                   num_views=6)
    cfg = MVDreamConfig()
    cfg = dataclasses.replace(
        cfg, num_views=6, ip_dim=16, prompt_dim=1024,
        unet=dataclasses.replace(cfg.unet, mv_views=6, ip_dim=16,
                                 cross_attention_dim=1024,
                                 in_channels=8 if stage2 else 4))
    return MVDreamPipeline.init_random(cfg=cfg, device=dev)


def _crm6_camposes():
    return [[1.63634, e, a, 0.0, 0.0, 0.0]
            for e, a in ORBITPOSE_PRESETS["CRM(6)"]]


def _views(sampler, seed, **kw):
    """The sampler's views [V, S, S, 3] on the CPU, the initial noise drawn
    from a CPU generator seeded with `seed`."""
    return sampler(generator=torch.Generator().manual_seed(int(seed)),
                   **kw).detach().cpu()


@register
class Load_CRM_MVDiffusion_Model:
    """reference nodes.py:2155 — the pixel and CCM samplers."""

    CATEGORY = "Comfy3D/Import|Export"
    RETURN_TYPES = ("CRM_MVDIFFUSION_SAMPLER", "CRM_MVDIFFUSION_SAMPLER")
    RETURN_NAMES = ("crm_mvdiffusion_sampler", "crm_ccm_sampler")
    FUNCTION = "load"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "model_name": (["ccm-diffusion", "pixel-diffusion"],),
        }}

    def load(self, model_name="pixel-diffusion"):
        root = os.path.join(base.CKPT_ROOT_PATH, "CRM")
        out = []
        for name in ("pixel-diffusion", "ccm-diffusion"):
            path = os.path.join(root, f"{name}.pth")
            if os.path.exists(path):
                print(f"[Load_CRM_MVDiffusion_Model] loading {path}")
                out.append(_mvdream_6view(path))
            else:
                print(f"[Load_CRM_MVDiffusion_Model] {path} not found "
                      "— random weights")
                out.append(_mvdream_6view(stage2=name == "ccm-diffusion"))
        return tuple(out)


@register
class CRM_Images_MVDiffusion_Model:
    """reference nodes.py:2213 — six orbit RGB views of the reference."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "crm_mvdiffusion_sampler": ("CRM_MVDIFFUSION_SAMPLER",),
            "reference_image": ("IMAGE",),
            "reference_mask": ("MASK",),
            "prompt": ("STRING", {"default": "3D assets",
                                  "multiline": True}),
            "prompt_neg": ("STRING", {"default": "ugly, blurry",
                                      "multiline": True}),
            "seed": ("INT", {"default": 1234, "min": 0,
                             "max": 0xffffffffffffffff}),
            "mv_guidance_scale": ("FLOAT", {"default": 5.5, "min": 0.0,
                                            "step": 0.01}),
            "num_inference_steps": ("INT", {"default": 50, "min": 1}),
        }}

    RETURN_TYPES = ("IMAGE", "ORBIT_CAMPOSES")
    RETURN_NAMES = ("multiview_images", "orbit_camposes")
    FUNCTION = "run_model"
    CATEGORY = "Comfy3D/Algorithm"

    def run_model(self, crm_mvdiffusion_sampler, reference_image,
                  reference_mask, prompt="3D assets", prompt_neg="",
                  seed=1234, mv_guidance_scale=5.5,
                  num_inference_steps=50):
        out = _views(crm_mvdiffusion_sampler, int(seed) % (2 ** 31),
                     image=_masked_ref(reference_image, reference_mask),
                     num_inference_steps=int(num_inference_steps),
                     guidance_scale=float(mv_guidance_scale))
        return (out, _crm6_camposes())


@register
class CRM_CCMs_MVDiffusion_Model:
    """reference nodes.py:2279 — six canonical coordinate maps conditioned
    on the pixel views."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "crm_mvdiffusion_sampler": ("CRM_MVDIFFUSION_SAMPLER",),
            "reference_image": ("IMAGE",),
            "reference_mask": ("MASK",),
            "multiview_images": ("IMAGE",),
            "prompt": ("STRING", {"default": "3D assets",
                                  "multiline": True}),
            "prompt_neg": ("STRING", {"default": "ugly, blurry",
                                      "multiline": True}),
            "seed": ("INT", {"default": 1234, "min": 0,
                             "max": 0xffffffffffffffff}),
            "mv_guidance_scale": ("FLOAT", {"default": 5.5, "min": 0.0,
                                            "step": 0.01}),
            "num_inference_steps": ("INT", {"default": 50, "min": 1}),
        }}

    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("multiview_CCMs",)
    FUNCTION = "run_model"
    CATEGORY = "Comfy3D/Algorithm"

    def run_model(self, crm_mvdiffusion_sampler, reference_image=None,
                  reference_mask=None, multiview_images=None,
                  prompt="3D assets", prompt_neg="", seed=1234,
                  mv_guidance_scale=5.5, num_inference_steps=50):
        out = _views(crm_mvdiffusion_sampler, int(seed) % (2 ** 31) + 1,
                     image=_masked_ref(reference_image, reference_mask),
                     pixel_images=(None if multiview_images is None
                                   else image_batch(multiview_images)),
                     num_inference_steps=int(num_inference_steps),
                     guidance_scale=float(mv_guidance_scale))
        return (out,)


@register
class Load_Convolutional_Reconstruction_Model:
    """reference nodes.py:2341."""

    CATEGORY = "Comfy3D/Import|Export"
    RETURN_TYPES = ("CRM_MODEL",)
    RETURN_NAMES = ("crm_model",)
    FUNCTION = "load"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"model_name": (["CRM.pth"],)}}

    def load(self, model_name="CRM.pth"):
        from ..models.crm import CRMReconPipeline
        dev = base.node_device()
        path = os.path.join(base.CKPT_ROOT_PATH, "CRM", model_name)
        if os.path.exists(path):
            print(f"[Load_Convolutional_Reconstruction_Model] loading "
                  f"{path}")
            return (CRMReconPipeline.from_pretrained(path, device=dev),)
        print(f"[Load_Convolutional_Reconstruction_Model] {path} not "
              "found — random weights")
        return (CRMReconPipeline.init_random(device=dev),)


@register
class Convolutional_Reconstruction_Model:
    """reference nodes.py:2382 — six views + six CCMs → a mesh."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "crm_model": ("CRM_MODEL",),
            "multiview_images": ("IMAGE",),
            "multiview_CCMs": ("IMAGE",),
        }}

    RETURN_TYPES = ("MESH",)
    RETURN_NAMES = ("mesh",)
    FUNCTION = "run_model"
    CATEGORY = "Comfy3D/Algorithm"

    def run_model(self, crm_model, multiview_images, multiview_CCMs):
        return (crm_model(image_batch(multiview_images),
                          image_batch(multiview_CCMs)),)


# ------------------------------------------------------------------ #
# CRM T2I (adapter-conditioned multi-view diffusion, V2 RGB / V3 PBR)
# ------------------------------------------------------------------ #
class _T2IAdapterRunner:
    """The T2IADAPTER_V2 edge: a `T2IAdapter` and its call on normal maps
    [V, H, W, 3] → the NCHW feature maps, on the adapter's device."""

    def __init__(self, model):
        self.model = model
        self.cfg = model.cfg

    @torch.no_grad()
    def __call__(self, cond_images):
        p = next(self.model.parameters())
        x = torch.as_tensor(cond_images, dtype=torch.float32, device=p.device)
        return self.model(x.permute(0, 3, 1, 2))


def _adapter_for(sampler):
    """The T2IAdapterV2: the weights of `<CKPT_ROOT_PATH>/T2I_V2` when
    present (reference nodes.py:3560/3693), else random at the sampler's
    UNet block widths, on the run's device."""
    from ..models.crm.t2i_adapter import T2IAdapter, T2IAdapterConfig
    from ..models.crm.t2i_convert import load_adapter_dir
    dev = base.node_device()
    adir = os.path.join(base.CKPT_ROOT_PATH, "T2I_V2")
    loaded = load_adapter_dir(adir, dev) if os.path.isdir(adir) else None
    if loaded is not None:
        print(f"[Load_CRM_T2I] loaded T2IAdapterV2 from {adir}")
        return _T2IAdapterRunner(loaded[1])
    return _T2IAdapterRunner(T2IAdapter.init_random(
        cfg=T2IAdapterConfig(
            channels=tuple(sampler.cfg.unet.block_out_channels)),
        device=dev))


@register
class Load_CRM_T2I_V2_Models:
    """reference nodes.py:3479 — T2IAdapterV2 + the pixel-diffusion
    sampler (`CRM_T2I_V2/model/t2i_adapter_v2.py:265`)."""

    CATEGORY = "Comfy3D/Import|Export"
    RETURN_TYPES = ("T2IADAPTER_V2", "CRM_MVDIFFUSION_SAMPLER_V2")
    RETURN_NAMES = ("t2iadapter_v2", "crm_mvdiffusion_sampler_v2")
    FUNCTION = "load_CRM"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "crm_model_name": (["pixel-diffusion.pth"],),
            "crm_config_path": (["sd_v2_base_ipmv_zero_SNR.yaml"],),
        }}

    def load_CRM(self, crm_model_name="pixel-diffusion.pth",
                 crm_config_path="sd_v2_base_ipmv_zero_SNR.yaml"):
        path = os.path.join(base.CKPT_ROOT_PATH, "CRM", crm_model_name)
        if os.path.exists(path):
            print(f"[Load_CRM_T2I_V2_Models] loading {path}")
            sampler = _mvdream_6view(path)
        else:
            print("[Load_CRM_T2I_V2_Models] initializing random "
                  f"weights ({path} not found)")
            sampler = _mvdream_6view()
        return (_adapter_for(sampler), sampler)


@register
class Load_CRM_T2I_V3_Models:
    """reference nodes.py:3629 — the Hyper-SD LoRA / DoRA PBR variant: the
    low-rank delta is folded into the sampler's weights at load
    (`fold_lora_checkpoint`), so it runs as V2 does; `rank` and `use_dora`
    are recorded."""

    CATEGORY = "Comfy3D/Import|Export"
    RETURN_TYPES = ("T2IADAPTER_V2", "CRM_MVDIFFUSION_SAMPLER_V3")
    RETURN_NAMES = ("t2iadapter_v2", "crm_mvdiffusion_sampler_v3")
    FUNCTION = "load_CRM"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "crm_model_name": (["pixel-diffusion_Hyper.pth"],),
            "crm_t2i_v3_model_name":
                (["pixel-diffusion_lora_80k_rank_60_Hyper.pth",
                  "pixel-diffusion_dora_90k_rank_128_Hyper.pth"],),
            "crm_config_path": (["sd_v2_base_ipmv_zero_SNR_Hyper.yaml"],),
            "rank": ("INT", {"default": 64, "min": 1}),
            "use_dora": ("BOOLEAN", {"default": False}),
        }}

    def load_CRM(self, crm_model_name="pixel-diffusion_Hyper.pth",
                 crm_t2i_v3_model_name="", crm_config_path="",
                 rank=64, use_dora=False):
        path = os.path.join(base.CKPT_ROOT_PATH, "CRM", crm_model_name)
        if os.path.exists(path):
            print(f"[Load_CRM_T2I_V3_Models] loading {path}")
            sampler = _mvdream_6view(path)
            lora = os.path.join(base.CKPT_ROOT_PATH, "CRM_T2I_V3",
                                crm_t2i_v3_model_name)
            if crm_t2i_v3_model_name and os.path.exists(lora):
                from ..models.mvdream.convert import fold_lora_checkpoint
                fold_lora_checkpoint(sampler, lora)
        else:
            print("[Load_CRM_T2I_V3_Models] initializing random "
                  f"weights ({path} not found)")
            sampler = _mvdream_6view()
        sampler.lora_rank = int(rank)
        sampler.use_dora = bool(use_dora)
        return (_adapter_for(sampler), sampler)


def _run_t2i_stage1(adapter, sampler, normal_maps, seed, guidance, steps):
    """V2/V3's stage 1 (nodes.py:3585-3607): the adapter's maps of the six
    normal maps, resized to 16× the sampler's latent size so that they line
    up with the UNet's down blocks (the reference feeds 512² maps to the
    256² sampler) → the adapter-conditioned six views."""
    nm = image_batch(normal_maps)
    v = sampler.cfg.num_views
    if nm.shape[0] != v:      # one map serves every view
        nm = nm[:1].expand(v, -1, -1, -1)
    target = sampler.cfg.image_size // sampler.cfg.vae_factor * 16
    if nm.shape[1:3] != (target, target):
        nm = img_utils.resize_images(nm.contiguous(), target, target)
    return _views(sampler, seed, num_inference_steps=int(steps),
                  guidance_scale=float(guidance),
                  adapter_residuals=adapter(nm))


_T2I_INPUTS = {
    "reference_image": ("IMAGE",),
    "reference_mask": ("MASK",),
    "normal_maps": ("IMAGE",),
    "prompt": ("STRING", {"default": "3D assets", "multiline": True}),
    "prompt_neg": ("STRING", {"default": "ugly, blurry",
                              "multiline": True}),
    "seed": ("INT", {"default": 1234, "min": 0,
                     "max": 0xffffffffffffffff}),
    "mv_guidance_scale": ("FLOAT", {"default": 5.5, "min": 0.0,
                                    "step": 0.01}),
    "num_inference_steps": ("INT", {"default": 50, "min": 1}),
}


@register
class CRM_T2I_V2_Models:
    """reference nodes.py:3547 — normal-map-conditioned six RGB views (the
    reference image and the prompts are not read, as in the JAX
    package)."""

    CATEGORY = "Comfy3D/Algorithm"
    RETURN_TYPES = ("IMAGE", "ORBIT_CAMPOSES")
    RETURN_NAMES = ("multiview_images", "orbit_camposes")
    FUNCTION = "run_model"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "t2iadapter_v2": ("T2IADAPTER_V2",),
            "crm_mvdiffusion_sampler_v2": ("CRM_MVDIFFUSION_SAMPLER_V2",),
            **_T2I_INPUTS}}

    def run_model(self, t2iadapter_v2, crm_mvdiffusion_sampler_v2,
                  reference_image, reference_mask, normal_maps,
                  prompt="3D assets", prompt_neg="", seed=1234,
                  mv_guidance_scale=5.5, num_inference_steps=50):
        views = _run_t2i_stage1(t2iadapter_v2, crm_mvdiffusion_sampler_v2,
                                normal_maps, seed, mv_guidance_scale,
                                num_inference_steps)
        return (views, _crm6_camposes())


@register
class CRM_T2I_V3_Models:
    """reference nodes.py:3730 — the PBR variant: albedo, metalness and
    roughness view sets, three samplings of the adapter-conditioned
    trajectory from seeds `seed`, `seed + 1`, `seed + 2`."""

    CATEGORY = "Comfy3D/Algorithm"
    RETURN_TYPES = ("IMAGE", "IMAGE", "IMAGE", "ORBIT_CAMPOSES")
    RETURN_NAMES = ("multiview_albedos", "multiview_metalness",
                    "multiview_roughness", "orbit_camposes")
    FUNCTION = "run_model"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "t2iadapter_v2": ("T2IADAPTER_V2",),
            "crm_mvdiffusion_sampler_v3": ("CRM_MVDIFFUSION_SAMPLER_V3",),
            **_T2I_INPUTS}}

    def run_model(self, t2iadapter_v2, crm_mvdiffusion_sampler_v3,
                  reference_image, reference_mask, normal_maps,
                  prompt="3D assets", prompt_neg="", seed=1234,
                  mv_guidance_scale=5.5, num_inference_steps=50):
        outs = [_run_t2i_stage1(t2iadapter_v2, crm_mvdiffusion_sampler_v3,
                                normal_maps, seed + k, mv_guidance_scale,
                                num_inference_steps) for k in range(3)]
        return (outs[0], outs[1], outs[2], _crm6_camposes())
