"""SSIM / MS-SSIM image losses.

Port of `comfy3d_tpu/ops/ssim.py` (the 3DGS trainer's structural loss).
Images are NHWC float in [0, 1], as in the JAX package. The separable
"valid" Gaussian blur is two depthwise `F.conv2d` calls (`groups=C`), one
along the width and one along the height, as the JAX package's two
`conv_general_dilated` calls are: library convolutions, since the JAX
package leaves these to XLA and has no kernel of its own here.

On the card a float32 convolution follows `torch.backends.cudnn.allow_tf32`
(True by default, which keeps ~3 decimal digits); a caller that needs full
float32 SSIM sets it to False.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    """The normalised 1-D window, built in float64 and rounded to f32."""
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-0.5 * (x / sigma) ** 2)
    return torch.as_tensor((g / g.sum()).astype(np.float32), device=device)


def _blur(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable 'valid' Gaussian blur of NCHW, per channel."""
    k = win.shape[0]
    c = img.shape[1]
    out = F.conv2d(img, win.reshape(1, 1, 1, k).expand(c, 1, 1, k),
                   groups=c)
    return F.conv2d(out, win.reshape(1, 1, k, 1).expand(c, 1, k, 1),
                    groups=c)


def ssim(x: torch.Tensor, y: torch.Tensor, win_size: int = 11,
         sigma: float = 1.5, data_range: float = 1.0, full: bool = False):
    """Mean SSIM over NHWC batches (and the mean contrast term when full)."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    win = _gaussian_kernel(win_size, sigma, x.device)
    x = x.permute(0, 3, 1, 2)
    y = y.permute(0, 3, 1, 2)

    mu_x = _blur(x, win)
    mu_y = _blur(y, win)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sig_x = _blur(x * x, win) - mu_xx
    sig_y = _blur(y * y, win) - mu_yy
    sig_xy = _blur(x * y, win) - mu_xy

    cs = (2 * sig_xy + c2) / (sig_x + sig_y + c2)
    s = ((2 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs
    if full:
        return s.mean(), cs.mean()
    return s.mean()


def ms_ssim(x: torch.Tensor, y: torch.Tensor, win_size: int = 11,
            sigma: float = 1.5, data_range: float = 1.0,
            levels: int = 5) -> torch.Tensor:
    """Multi-scale SSIM (Wang et al. weights, renormalised to `levels`),
    NHWC. Each level's window is clamped to an odd size that fits."""
    weights = torch.tensor(_MSSSIM_WEIGHTS[:levels], dtype=torch.float32,
                           device=x.device)
    weights = weights / weights.sum()
    vals = []
    for lvl in range(levels):
        fit = min(win_size, x.shape[1], x.shape[2])
        fit = fit if fit % 2 == 1 else fit - 1
        s, cs = ssim(x, y, win_size=fit, sigma=sigma, data_range=data_range,
                     full=True)
        vals.append(s if lvl == levels - 1 else cs)
        if lvl < levels - 1:
            x = _downsample2(x)
            y = _downsample2(y)
    vals = torch.stack(vals)
    return torch.prod(torch.clamp_min(vals, 1e-6) ** weights)


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    n, h, w, c = img.shape
    h2, w2 = h // 2, w // 2
    return img[:, :h2 * 2, :w2 * 2].reshape(n, h2, 2, w2, 2, c).mean((2, 4))


def psnr(x: torch.Tensor, y: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean((x - y) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp_min(mse, 1e-12))
