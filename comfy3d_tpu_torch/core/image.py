"""Image utilities on the node-layer tensor conventions.

Port of the part of `comfy3d_tpu/core/image.py` that the GS→mesh converter
runs: `dilate_texture`, which grows a baked texture into the empty UV space
around its charts. Images are float32 [H, W, C], masks [H, W] (1 = valid).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
