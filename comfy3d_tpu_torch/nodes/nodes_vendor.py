"""Vendor / ecosystem utility nodes the reference example workflows use.

Port of `comfy3d_tpu/nodes/nodes_vendor.py`. The reference runs inside
ComfyUI, where these ship with the host app or common custom-node packs
(WAS, VideoHelperSuite, Impact, Eden, Inspire); the standalone executor
carries minimal counterparts. Images are float32 CPU tensors; resizes are
`core/image.py::resize_images` (`jax.image.resize`'s kernels). The path
constants are read through `base` at call time.

Not ported: `UpscaleModelLoader` and `ImageUpscaleWithModel` (ESRGAN,
ROADMAP A.10).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..core.image import resize_images
from . import base
from .base import (NODE_CLASS_MAPPINGS, NODE_DISPLAY_NAME_MAPPINGS,
                   image_batch, image_tensor, register)
from .nodes_io import read_image

IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".webp")


@register(comfy3d=False)
class Reroute:
    """ComfyUI pass-through."""

    CATEGORY = "utils"
    RETURN_TYPES = ("*",)
    FUNCTION = "route"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"": ("*",)}}

    def route(self, **kwargs):
        return (next(iter(kwargs.values())),)


@register(comfy3d=False)
class ImageScale:
    CATEGORY = "image/upscaling"
    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "upscale"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "image": ("IMAGE",),
            "upscale_method": (["nearest-exact", "bilinear", "area",
                                "bicubic", "lanczos"],),
            "width": ("INT", {"default": 512, "min": 0}),
            "height": ("INT", {"default": 512, "min": 0}),
            "crop": (["disabled", "center"],),
        }}

    def upscale(self, image, upscale_method="bilinear", width=512,
                height=512, crop="disabled"):
        method = {"nearest-exact": "nearest", "lanczos": "lanczos3",
                  "bicubic": "bicubic"}.get(upscale_method, "bilinear")
        return (resize_images(image_batch(image), int(height), int(width),
                              method),)


@register(comfy3d=False)
class ImageToMask:
    CATEGORY = "mask"
    RETURN_TYPES = ("MASK",)
    FUNCTION = "image_to_mask"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "image": ("IMAGE",),
            "channel": (["red", "green", "blue", "alpha"],),
        }}

    def image_to_mask(self, image, channel="red"):
        img = image_batch(image)
        idx = {"red": 0, "green": 1, "blue": 2, "alpha": 3}[channel]
        if idx >= img.shape[-1]:
            idx = 0
        return (img[..., idx],)


def _mask_batch(mask) -> torch.Tensor:
    m = image_tensor(mask)
    return m[None] if m.ndim == 2 else m


@register(comfy3d=False)
class MaskToImage:
    CATEGORY = "mask"
    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "mask_to_image"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"mask": ("MASK",)}}

    def mask_to_image(self, mask):
        return (_mask_batch(mask)[..., None].repeat(1, 1, 1, 3),)


@register(comfy3d=False)
class ConvertToGrayscale:
    """ControlAltAI-style channel utility used by the CRM T2I V3
    LoRA/DoRA example workflows (`CRM_T2I_V3_to_MV_to_Texture_*.json`):
    rec.601 luma, replicated back to 3 channels."""

    CATEGORY = "image"
    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "convert"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"image": ("IMAGE",)}}

    def convert(self, image):
        img = image_batch(image)
        luma = (0.299 * img[..., 0] + 0.587 * img[..., 1]
                + 0.114 * img[..., 2])
        return (luma[..., None].repeat(1, 1, 1, 3),)


@register(comfy3d=False)
class MergeImageChannels:
    """Compose an RGB image from per-channel sources (each source's
    first channel); an optional mask becomes alpha."""

    CATEGORY = "image"
    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("image",)
    FUNCTION = "merge"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "red": ("IMAGE",),
            "green": ("IMAGE",),
            "blue": ("IMAGE",),
        }, "optional": {"mask": ("MASK",)}}

    def merge(self, red, green, blue, mask=None):
        chans = [image_batch(c)[..., 0] for c in (red, green, blue)]
        n = max(c.shape[0] for c in chans)
        h = max(c.shape[1] for c in chans)
        w = max(c.shape[2] for c in chans)
        out = torch.zeros((n, h, w, 3))
        for i, c in enumerate(chans):
            out[:, :c.shape[1], :c.shape[2], i] = c[:n]
        if mask is not None:
            m = _mask_batch(mask)
            alpha = torch.ones((n, h, w, 1))
            alpha[:, :m.shape[1], :m.shape[2], 0] = m[:n]
            out = torch.cat([out, alpha], dim=-1)
        return (out,)


@register(comfy3d=False)
class GetImagesFromBatchIndexed:
    """Impact pack: images of a batch by an index list."""

    CATEGORY = "image"
    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "pick"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "images": ("IMAGE",),
            "indexes": ("STRING", {"default": "0,1"}),
        }}

    def pick(self, images, indexes="0,1"):
        img = image_batch(images)
        idx = [int(i) for i in str(indexes).replace(" ", "").split(",")
               if i != ""]
        idx = [i for i in idx if -img.shape[0] <= i < img.shape[0]]
        return (img[idx],)


@register(comfy3d=False)
class ImageListToImageBatch:
    CATEGORY = "image"
    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "doit"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"images": ("IMAGE",)}}

    def doit(self, images):
        if isinstance(images, (list, tuple)):
            images = torch.cat([image_batch(i) for i in images])
        return (image_batch(images),)


@register(comfy3d=False)
class PrimitiveString:
    CATEGORY = "utils/primitive"
    RETURN_TYPES = ("STRING",)
    FUNCTION = "execute"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"value": ("STRING", {"default": ""})}}

    def execute(self, value=""):
        return (value,)


@register(comfy3d=False)
class PrimitiveNode:
    CATEGORY = "utils/primitive"
    RETURN_TYPES = ("*",)
    FUNCTION = "execute"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"value": ("STRING", {"default": ""})}}

    def execute(self, value=""):
        return (value,)


@register(comfy3d=False)
class INTConstant:
    CATEGORY = "utils/primitive"
    RETURN_TYPES = ("INT",)
    FUNCTION = "get_value"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"value": ("INT", {"default": 0})}}

    def get_value(self, value=0):
        return (int(value),)


@register(comfy3d=False)
class ImpactFloat:
    CATEGORY = "ImpactPack"
    RETURN_TYPES = ("FLOAT",)
    FUNCTION = "doit"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"value": ("FLOAT", {"default": 0.0})}}

    def doit(self, value=0.0):
        return (float(value),)


@register(comfy3d=False)
class PreviewAny:
    CATEGORY = "utils"
    RETURN_TYPES = ()
    OUTPUT_NODE = True
    FUNCTION = "run"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"source": ("*",)}}

    def run(self, source=None):
        print(f"[PreviewAny] {type(source).__name__}: "
              f"{str(source)[:200]}")
        return ()


@register(comfy3d=False)
class Note:
    CATEGORY = "utils"
    RETURN_TYPES = ()
    OUTPUT_NODE = True
    FUNCTION = "noop"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {}}

    def noop(self, **kwargs):
        return ()


class _RembgBase:
    """Corner-sampled background estimate: the distance from the corners'
    median colour → a soft alpha (the Image Rembg role without the u2net
    checkpoint)."""

    @staticmethod
    def _alpha(img: np.ndarray) -> np.ndarray:
        corners = np.concatenate([
            img[:4, :4].reshape(-1, 3), img[:4, -4:].reshape(-1, 3),
            img[-4:, :4].reshape(-1, 3), img[-4:, -4:].reshape(-1, 3)])
        bg = np.median(corners, axis=0)
        dist = np.linalg.norm(img - bg, axis=-1)
        return np.clip((dist - 0.08) / 0.25, 0.0, 1.0)


@register(comfy3d=False)
class Image_Rembg_Remove_Background(_RembgBase):
    CATEGORY = "WAS Suite/Image/AI"
    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "image_rembg"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "images": ("IMAGE",),
            "transparency": ("BOOLEAN", {"default": True}),
            "model": (["u2net"],),
            "post_processing": ("BOOLEAN", {"default": False}),
            "only_mask": ("BOOLEAN", {"default": False}),
            "alpha_matting": ("BOOLEAN", {"default": False}),
            "alpha_matting_foreground_threshold":
                ("INT", {"default": 240}),
            "alpha_matting_background_threshold":
                ("INT", {"default": 10}),
            "alpha_matting_erode_size": ("INT", {"default": 10}),
            "background_color": (["none", "black", "white"],),
        }}

    def image_rembg(self, images, transparency=True, model="u2net",
                    only_mask=False, background_color="none", **_):
        out = []
        for im in image_batch(images).numpy():
            a = self._alpha(im[..., :3])
            if only_mask:
                out.append(np.repeat(a[..., None], 3, -1))
            elif transparency:
                out.append(np.concatenate([im[..., :3], a[..., None]], -1))
            else:
                bgc = 1.0 if background_color == "white" else 0.0
                out.append(im[..., :3] * a[..., None]
                           + bgc * (1 - a[..., None]))
        return (image_tensor(np.stack(out)),)


# ComfyUI type names with spaces or parentheses are no Python identifiers:
# the canonical workflow name is registered explicitly
NODE_CLASS_MAPPINGS["Image Rembg (Remove Background)"] = \
    Image_Rembg_Remove_Background
NODE_DISPLAY_NAME_MAPPINGS["Image Rembg (Remove Background)"] = \
    "Image Rembg (Remove Background)"


@register(comfy3d=False)
class Morphology:
    """comfy core morphology (erode / dilate / open / close ...)."""

    CATEGORY = "image/postprocessing"
    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "process"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "image": ("IMAGE",),
            "operation": (["erode", "dilate", "open", "close",
                           "gradient", "bottom_hat", "top_hat"],),
            "kernel_size": ("INT", {"default": 3, "min": 3, "max": 999,
                                    "step": 2}),
        }}

    def process(self, image, operation="erode", kernel_size=3):
        img = image_batch(image).permute(0, 3, 1, 2)
        k = int(kernel_size)

        def dilate(x):     # max over the k×k window, the border -inf
            return F.max_pool2d(x, k, stride=1, padding=k // 2)

        def erode(x):
            return -dilate(-x)

        ops = {
            "erode": erode, "dilate": dilate,
            "open": lambda x: dilate(erode(x)),
            "close": lambda x: erode(dilate(x)),
            "gradient": lambda x: dilate(x) - erode(x),
            "top_hat": lambda x: x - dilate(erode(x)),
            "bottom_hat": lambda x: erode(dilate(x)) - x,
        }
        out = ops[operation](img).clamp(0, 1)
        return (out.permute(0, 2, 3, 1).contiguous(),)


@register(comfy3d=False)
class ResizeMask:
    CATEGORY = "mask"
    RETURN_TYPES = ("MASK",)
    FUNCTION = "resize"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "mask": ("MASK",),
            "width": ("INT", {"default": 512, "min": 1}),
            "height": ("INT", {"default": 512, "min": 1}),
            "keep_proportions": ("BOOLEAN", {"default": False}),
        }}

    def resize(self, mask, width=512, height=512,
               keep_proportions=False, **_):
        m = _mask_batch(mask)[..., None]
        return (resize_images(m, int(height), int(width))[..., 0],)


@register(comfy3d=False)
class RemapImageRange:
    CATEGORY = "image"
    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "remap"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "image": ("IMAGE",),
            "min": ("FLOAT", {"default": 0.0, "step": 0.01}),
            "max": ("FLOAT", {"default": 1.0, "step": 0.01}),
            "clamp": ("BOOLEAN", {"default": True}),
        }}

    def remap(self, image, min=0.0, max=1.0, clamp=True):
        out = image_batch(image) * (float(max) - float(min)) + float(min)
        if clamp:
            out = out.clamp(0.0, 1.0)
        return (out,)


@register(comfy3d=False)
class Eden_IMG_padder:
    """Pad an image to square with a fill colour (Eden pack role)."""

    CATEGORY = "Eden"
    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "pad"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "image": ("IMAGE",),
            "pad_value": ("FLOAT", {"default": 1.0, "min": 0.0,
                                    "max": 1.0}),
        }}

    def pad(self, image, pad_value=1.0, **_):
        img = image_batch(image)
        b, h, w, c = img.shape
        m = max(h, w)
        out = torch.full((b, m, m, c), float(pad_value))
        y0, x0 = (m - h) // 2, (m - w) // 2
        out[:, y0:y0 + h, x0:x0 + w] = img
        return (out,)


def _load_dir(d: str, names, mask_of) -> tuple:
    """The images `names` of directory `d` → (RGB images, `mask_of(rgb,
    alpha or None)` each), numpy; unreadable files are skipped."""
    imgs, masks = [], []
    for f in names:
        try:
            rgb, alpha = read_image(os.path.join(d, f))
        except FileNotFoundError:
            continue
        imgs.append(rgb)
        masks.append(mask_of(rgb, alpha))
    return imgs, masks


@register(comfy3d=False)
class VHS_LoadImagesPath:
    """VideoHelperSuite: every image of a directory."""

    CATEGORY = "Video Helper Suite"
    RETURN_TYPES = ("IMAGE", "MASK", "INT")
    FUNCTION = "load_images"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "directory": ("STRING", {"default": ""}),
            "image_load_cap": ("INT", {"default": 0, "min": 0}),
            "skip_first_images": ("INT", {"default": 0, "min": 0}),
            "select_every_nth": ("INT", {"default": 1, "min": 1}),
        }}

    def load_images(self, directory="", image_load_cap=0,
                    skip_first_images=0, select_every_nth=1, **_):
        d = directory if os.path.isabs(directory) else os.path.join(
            base.INPUT_ROOT_PATH, directory)
        files = sorted(f for f in os.listdir(d)
                       if f.lower().endswith(IMAGE_SUFFIXES))
        files = files[int(skip_first_images)::int(select_every_nth)]
        if image_load_cap:
            files = files[:int(image_load_cap)]
        imgs, masks = _load_dir(d, files, lambda rgb, a: np.zeros(
            rgb.shape[:2], np.float32) if a is None else 1.0 - a)
        return (image_tensor(np.stack(imgs)), image_tensor(np.stack(masks)),
                len(imgs))


@register(comfy3d=False)
class VHS_MergeImages:
    CATEGORY = "Video Helper Suite"
    RETURN_TYPES = ("IMAGE", "INT")
    FUNCTION = "merge"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "images_A": ("IMAGE",),
            "images_B": ("IMAGE",),
            "merge_strategy": (["match A", "match B"],),
            "scale_method": (["nearest-exact", "bilinear"],),
            "crop": (["none", "center"],),
        }}

    def merge(self, images_A, images_B, merge_strategy="match A",
              scale_method="bilinear", crop="none"):
        a, b = image_batch(images_A), image_batch(images_B)
        target = tuple(a.shape[1:3] if merge_strategy == "match A"
                       else b.shape[1:3])

        def fit(x):
            if tuple(x.shape[1:3]) == target:
                return x
            return resize_images(x, *target)

        out = torch.cat([fit(a), fit(b)])
        return (out, out.shape[0])


class LoadImagesFromDirInspire:
    """Inspire pack's `LoadImagesFromDir //Inspire`: every image of a
    directory (sorted) from `start_index`, up to a cap; the FlexiCubes
    depth / normal / mask feeder of the reference workflows. Its masks are
    the images' alpha (1 without one), not ComfyUI's 1 − α."""

    CATEGORY = "InspirePack/image"
    RETURN_TYPES = ("IMAGE", "MASK", "INT")
    RETURN_NAMES = ("images", "masks", "count")
    FUNCTION = "load_images"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "directory": ("STRING", {"default": ""}),
            "image_load_cap": ("INT", {"default": 0, "min": 0}),
            "start_index": ("INT", {"default": 0, "min": 0}),
        }}

    def load_images(self, directory="", image_load_cap=0,
                    start_index=0, **_):
        names = sorted(
            f for f in (os.listdir(directory)
                        if os.path.isdir(directory) else [])
            if f.lower().endswith(IMAGE_SUFFIXES + (".bmp",)))
        names = names[int(start_index):]
        if image_load_cap:
            names = names[:int(image_load_cap)]
        imgs, masks = _load_dir(directory, names, lambda rgb, a: np.ones(
            rgb.shape[:2], np.float32) if a is None else a)
        if not imgs:
            raise ValueError(
                f"LoadImagesFromDir: no images under {directory!r}")
        return (image_tensor(np.stack(imgs)), image_tensor(np.stack(masks)),
                len(imgs))


# the Inspire pack registers with a display-name suffix the class-name
# decorator cannot express
NODE_CLASS_MAPPINGS["LoadImagesFromDir //Inspire"] = \
    LoadImagesFromDirInspire
NODE_DISPLAY_NAME_MAPPINGS["LoadImagesFromDir //Inspire"] = \
    "Load Images From Dir (Inspire)"
