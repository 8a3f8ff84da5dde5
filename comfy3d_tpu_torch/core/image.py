"""Image utilities on the node-layer tensor conventions.

Port of the parts of `comfy3d_tpu/core/image.py` that the ported paths
run: `composite_background`, `resize_images`, `make_image_grid` and
`split_image_grid` (the Zero123Plus → InstantMesh chain), on the node
layer's IMAGE = float32 [N, H, W, 3] in [0, 1] and MASK = [N, H, W]; and
`dilate_texture` (the GS→mesh converter), which grows a baked texture
[H, W, C] into the empty UV space around its charts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def composite_background(images: torch.Tensor, masks: torch.Tensor,
                         color=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """Alpha-composite [N, H, W, 3] images with masks [N, H, W] over a pure
    colour (ref `image_utils.py:16-42`)."""
    c = torch.as_tensor(color, dtype=images.dtype, device=images.device)
    m = masks[..., None]
    return images * m + c * (1.0 - m)


def resize_images(images: torch.Tensor, height: int, width: int,
                  method: str = "bilinear") -> torch.Tensor:
    """[N, H, W, C] resize as `jax.image.resize` does it: "bilinear" (a
    triangle kernel) or "bicubic" (Keys, a = −0.5), each widened by the
    scale when it shrinks (antialiased)."""
    if method not in ("bilinear", "bicubic"):
        raise ValueError(f"resize method {method!r}")
    x = F.interpolate(images.permute(0, 3, 1, 2), size=(height, width),
                      mode=method, align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def make_image_grid(images: torch.Tensor, rows: int,
                    cols: int) -> torch.Tensor:
    """[N, H, W, C] → one [rows·H, cols·W, C] grid, row by row."""
    n, h, w, c = images.shape
    if n != rows * cols:
        raise ValueError(f"{n} images != {rows}x{cols}")
    return (images.reshape(rows, cols, h, w, c).permute(0, 2, 1, 3, 4)
            .reshape(rows * h, cols * w, c))


def split_image_grid(image: torch.Tensor, rows: int,
                     cols: int) -> torch.Tensor:
    """One [H, W, C] grid → [rows·cols, H/rows, W/cols, C], row by row."""
    gh, gw, c = image.shape
    h, w = gh // rows, gw // cols
    return (image[:rows * h, :cols * w].reshape(rows, h, cols, w, c)
            .permute(0, 2, 1, 3, 4).reshape(rows * cols, h, w, c))


def _box_sum3(x: torch.Tensor) -> torch.Tensor:
    """3×3 sums with zero padding of x [C, H, W] (XLA's "SAME"
    `reduce_window` add)."""
    return F.avg_pool2d(x[None], 3, stride=1, padding=1,
                        count_include_pad=True, divisor_override=1)[0]


def dilate_texture(image: torch.Tensor, mask: torch.Tensor,
                   iterations: int = 8) -> torch.Tensor:
    """Grow valid texels into empty UV space: each round, every texel where
    the mask is 0 takes the mean of the valid texels among its 3×3
    neighbours (their sum over their count), and the mask grows by one
    texel (ref `troch_image_dilate`, image_utils.py:43-89).

    image [H, W, C]; mask [H, W] (1 = valid). Returns the image."""
    img, m = image, mask.to(image.dtype)
    for _ in range(iterations):
        ksum = _box_sum3((img * m[..., None]).permute(2, 0, 1))
        msum = _box_sum3(m[None])[0]
        fill = (ksum / msum.clamp_min(1e-8)).permute(1, 2, 0)
        img = torch.where(m[..., None] > 0, img, fill)
        m = torch.maximum(m, msum.clamp(0.0, 1.0))
    return img
