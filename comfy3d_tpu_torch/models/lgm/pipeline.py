"""LGM pipeline: four multiview images → `GaussianSplat`.

Port of `comfy3d_tpu/models/lgm/pipeline.py` (the reference's
Large_Multiview_Gaussian_Model node → `forward_gaussians`). Weights are
drawn from a seed (`init_random`; on the target device) or read from
upstream's
`model_fp16.safetensors` in its own names (`from_pretrained`). Images cross
the boundary as the node protocol holds them, [V, H, W, 3] in [0, 1]; the
network runs NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core import sh as sh_utils
from ...core.gaussian import GaussianSplat
from ..common import init_weights_, seeded_model
from .model import LGMConfig, LGMUNet, decode_gaussians, plucker_rays


class LGMPipeline:
    def __init__(self, model: LGMUNet):
        self.model = model.eval()
        self.cfg = model.cfg

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @classmethod
    def init_random(cls, seed: int = 0, cfg: LGMConfig = LGMConfig(),
                    device=None) -> "LGMPipeline":
        """Weights drawn from `seed` in the JAX package's scheme
        (`common.init_weights_`) on `device` (default: the card;
        `common.seeded_model`)."""
        return cls(seeded_model(lambda: LGMUNet(cfg), init_weights_, seed,
                                device))

    @classmethod
    def from_pretrained(cls, ckpt_path: str, cfg: LGMConfig = LGMConfig(),
                        device=None) -> "LGMPipeline":
        """The public LGM checkpoint (`model_fp16.safetensors`, reference
        nodes.py:1807-1815) in its own names, loaded strictly as float32
        onto `device` (default: the card)."""
        from ..diffusion.config import load_module
        from ..loader import load_state_dict
        return cls(load_module(lambda: LGMUNet(cfg),
                               load_state_dict(ckpt_path), device))

    @torch.no_grad()
    def forward_gaussians(self, images, elevations=None, azimuths=None
                          ) -> GaussianSplat:
        """images [V, H, W, 3] in [0, 1] (default cameras: MVDream's orbit,
        elevation 0, azimuths i·360/V) → a GaussianSplat of V·splat_size²
        splats, view-major then row-major over each view's splat map (the
        JAX package's order), SH degree 0, all alive. Images of another
        size are resized bilinearly (antialiased when shrinking, as
        `jax.image.resize`)."""
        c = self.cfg
        dev = self.device
        images = torch.as_tensor(images, dtype=torch.float32, device=dev)
        v = images.shape[0]
        x = images.permute(0, 3, 1, 2)
        if images.shape[1] != c.input_size or images.shape[2] != c.input_size:
            x = F.interpolate(x, size=(c.input_size, c.input_size),
                              mode="bilinear", align_corners=False,
                              antialias=True)
        if elevations is None:
            elevations = [0.0] * v
        if azimuths is None:
            azimuths = [i * (360.0 / v) for i in range(v)]
        rays = plucker_rays(c, elevations, azimuths, device=dev)
        x = torch.cat([x, rays.permute(0, 3, 1, 2)], dim=1)   # [V, 9, S, S]
        raw = self.model(x)                                   # [V, 14, s, s]
        g = decode_gaussians(raw.permute(0, 2, 3, 1).reshape(
            -1, c.out_channels))
        n = g["xyz"].shape[0]
        op = torch.clamp(g["opacity"], 1e-4, 1 - 1e-4)
        return GaussianSplat(
            xyz=g["xyz"],
            sh=sh_utils.rgb_to_sh(g["rgb"])[:, None, :],
            opacity_raw=torch.log(op / (1 - op)),
            scale_raw=torch.log(torch.clamp_min(g["scale"], 1e-8)),
            rot_raw=g["rotation"],
            alive=torch.ones((n,), dtype=torch.bool, device=dev))
