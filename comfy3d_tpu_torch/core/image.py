"""Image utilities on the node-layer tensor conventions.

Port of `comfy3d_tpu/core/image.py`: `composite_background`,
`resize_images`, `make_image_grid`, `split_image_grid`, `erode_mask`,
`resize_foreground`, `masks_from_normal_maps` and
`rotate_normals_horizontally` on the node layer's IMAGE = float32
[N, H, W, 3] in [0, 1] and MASK = [N, H, W]; and `dilate_texture` (the
GS→mesh converter), which grows a baked texture [H, W, C] into the empty UV
space around its charts.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def composite_background(images: torch.Tensor, masks: torch.Tensor,
                         color=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """Alpha-composite [N, H, W, 3] images with masks [N, H, W] over a pure
    colour (ref `image_utils.py:16-42`)."""
    c = torch.as_tensor(color, dtype=images.dtype, device=images.device)
    m = masks[..., None]
    return images * m + c * (1.0 - m)


def _lanczos3_weights(n_in: int, n_out: int, dtype, device) -> torch.Tensor:
    """[n_out, n_in] sampling weights of `jax.image.resize`'s "lanczos3":
    the kernel sinc(x)·sinc(x/3) on |x| < 3, widened by the scale when it
    shrinks, each row normalised, rows outside the input zero."""
    scale = n_out / n_in
    ks = max(1.0 / scale, 1.0)
    f = (torch.arange(n_out, dtype=torch.float64) + 0.5) / scale - 0.5
    x = (f[:, None] - torch.arange(n_in, dtype=torch.float64)[None]).abs() \
        / ks
    w = torch.where(x < 3.0, torch.sinc(x) * torch.sinc(x / 3.0),
                    torch.zeros_like(x))
    total = w.sum(1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    w = torch.where(((f >= -0.5) & (f <= n_in - 0.5))[:, None], w, 0.0)
    return w.to(dtype=dtype, device=device)


def resize_images(images: torch.Tensor, height: int, width: int,
                  method: str = "bilinear") -> torch.Tensor:
    """[N, H, W, C] resize as `jax.image.resize` does it: "bilinear" (a
    triangle kernel), "bicubic" (Keys, a = −0.5) or "lanczos3", each
    widened by the scale when it shrinks (antialiased), or "nearest" (the
    pixel whose centre is nearest)."""
    if method == "nearest":
        x = F.interpolate(images.permute(0, 3, 1, 2), size=(height, width),
                          mode="nearest-exact")
    elif method == "lanczos3":
        _, h, w, _ = images.shape
        wy = _lanczos3_weights(h, height, images.dtype, images.device)
        wx = _lanczos3_weights(w, width, images.dtype, images.device)
        return torch.einsum("yh,nhwc,xw->nyxc", wy, images, wx)
    elif method in ("bilinear", "bicubic"):
        x = F.interpolate(images.permute(0, 3, 1, 2), size=(height, width),
                          mode=method, align_corners=False, antialias=True)
    else:
        raise ValueError(f"resize method {method!r}")
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


def erode_mask(masks: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Binary erosion of [N, H, W] masks by a (2r+1)² min-pool, the border
    padded with +inf (ref `image_utils.py:142-154`)."""
    if radius <= 0:
        return masks
    k = 2 * radius + 1
    return -F.max_pool2d(-masks[:, None], k, stride=1, padding=radius)[:, 0]


def resize_foreground(image, mask, ratio: float = 0.85):
    """Crop [H, W, C] and its mask [H, W] to the mask's bounding box and
    re-pad so the object fills `ratio` of a square frame, resized back to
    H × W (`cv2.INTER_LINEAR`; ref `pils_resize_foreground`,
    image_utils.py:155-199). Host-side (the crop's shape depends on the
    data); numpy in and out."""
    import cv2
    image = np.asarray(image)
    mask = np.asarray(mask)
    ys, xs = np.where(mask > 0.5)
    if len(ys) == 0:
        return image, mask
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    fg, fg_m = image[y0:y1, x0:x1], mask[y0:y1, x0:x1]
    side = int(round(max(fg.shape[0], fg.shape[1]) / ratio))
    out = np.zeros((side, side, image.shape[2]), image.dtype)
    out_m = np.zeros((side, side), mask.dtype)
    oy, ox = (side - fg.shape[0]) // 2, (side - fg.shape[1]) // 2
    out[oy:oy + fg.shape[0], ox:ox + fg.shape[1]] = fg
    out_m[oy:oy + fg.shape[0], ox:ox + fg.shape[1]] = fg_m
    h, w = image.shape[:2]
    out = cv2.resize(out, (w, h), interpolation=cv2.INTER_LINEAR)
    out_m = cv2.resize(out_m, (w, h), interpolation=cv2.INTER_LINEAR)
    return out.astype(np.float32), out_m.astype(np.float32)


def masks_from_normal_maps(normals: torch.Tensor,
                           threshold: float = 0.99) -> torch.Tensor:
    """[N, H, W, 3] normal maps → [N, H, W] masks: 1 where the normal is
    farther than 1 − threshold from the background's (0.5, 0.5, 1) (ref
    Get_Masks_From_Normal_Maps, nodes.py:562)."""
    bg = torch.tensor([0.5, 0.5, 1.0], dtype=normals.dtype,
                      device=normals.device)
    dist = torch.linalg.vector_norm(normals - bg, dim=-1)
    return (dist > (1.0 - threshold)).to(normals.dtype)


def rotate_normals_horizontally(normals: torch.Tensor,
                                angle_deg: float) -> torch.Tensor:
    """World-space normal maps [..., 3] in [0, 1] rotated about +Y by
    `angle_deg` (ref nodes.py:588)."""
    a = math.radians(angle_deg)
    n = normals * 2.0 - 1.0
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    x2 = x * math.cos(a) + z * math.sin(a)
    z2 = -x * math.sin(a) + z * math.cos(a)
    return (torch.stack([x2, y, z2], -1) + 1.0) / 2.0


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
