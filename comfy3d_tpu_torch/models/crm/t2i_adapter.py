"""T2I-Adapter (CRM T2I V2/V3): a control image → one feature map per UNet
down block.

Port of `comfy3d_tpu/models/crm/t2i_adapter.py`
(`CRM_T2I_V2/model/t2i_adapter_v2.py:265`, `T2IAdapterV2`, the full
adapter): an image encoder (`conv2d_img_encoder`: a 3×3 conv in, then per
stage a same-width 3×3 conv and a stride-2 widening 3×3 conv, SiLU after
each, and a 3×3 conv out to the UNet's first block width; /16 at the
default widths) followed by one adapter block per down block (`body.{b}`:
a 2×2 average pool but for the first, a 1×1 channel-change conv where the
width changes, and `num_res_blocks` resnets of 3×3 → ReLU → 1×1 + the
input). The maps are the UNet's `adapter_residuals`. Submodules carry the
diffusers `T2IAdapterV2` checkpoint's names under `adapter.`
(`conv2d_img_encoder.{conv_in, blocks.{n}, conv_out}`, `body.{b}.{in_conv,
resnets.{r}.block{1,2}}`; `blocks.{2i}` the same-width conv of stage i,
`blocks.{2i+1}` its stride-2 conv). Images are NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch.nn.functional as F
from torch import nn

from ..common import init_weights_, seeded_model


@dataclasses.dataclass(frozen=True)
class T2IAdapterConfig:
    in_channels: int = 3
    channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    num_res_blocks: int = 2
    cond_channels: Tuple[int, ...] = (16, 32, 64, 128, 256)

    @classmethod
    def tiny(cls, channels=(8, 16)) -> "T2IAdapterConfig":
        return cls(channels=tuple(channels), num_res_blocks=1,
                   cond_channels=(4, 8))


class _ImageEncoder(nn.Module):
    def __init__(self, cfg: T2IAdapterConfig):
        super().__init__()
        cc = cfg.cond_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, cc[0], 3, padding=1)
        blocks = []
        for i, ch in enumerate(cc[1:]):
            blocks += [nn.Conv2d(cc[i], cc[i], 3, padding=1),
                       nn.Conv2d(cc[i], ch, 3, stride=2, padding=1)]
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(cc[-1], cfg.channels[0], 3, padding=1)

    def forward(self, x):
        h = F.silu(self.conv_in(x))
        for conv in self.blocks:
            h = F.silu(conv(h))
        return self.conv_out(h)


class _AdapterResnet(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.block1 = nn.Conv2d(ch, ch, 3, padding=1)
        self.block2 = nn.Conv2d(ch, ch, 1)

    def forward(self, x):
        return x + self.block2(F.relu(self.block1(x)))


class _AdapterBlock(nn.Module):
    def __init__(self, ch_in: int, ch: int, n_res: int, down: bool):
        super().__init__()
        self.down = down
        self.in_conv = nn.Conv2d(ch_in, ch, 1) if ch_in != ch else None
        self.resnets = nn.ModuleList([_AdapterResnet(ch)
                                      for _ in range(n_res)])

    def forward(self, h):
        if self.down:
            h = F.avg_pool2d(h, 2)
        if self.in_conv is not None:
            h = self.in_conv(h)
        for res in self.resnets:
            h = res(h)
        return h


class _FullAdapter(nn.Module):
    def __init__(self, cfg: T2IAdapterConfig):
        super().__init__()
        self.conv2d_img_encoder = _ImageEncoder(cfg)
        ch = (cfg.channels[0],) + tuple(cfg.channels)
        self.body = nn.ModuleList([
            _AdapterBlock(ch[b], ch[b + 1], cfg.num_res_blocks, b > 0)
            for b in range(len(cfg.channels))])


class T2IAdapter(nn.Module):
    def __init__(self, cfg: T2IAdapterConfig = T2IAdapterConfig()):
        super().__init__()
        self.cfg = cfg
        self.adapter = _FullAdapter(cfg)

    def forward(self, cond):
        """cond [B, C, H, W] (normal maps in [0, 1]) → [feature b at
        H/(16·2^b) with channels[b] channels, for each down block b]."""
        h = self.adapter.conv2d_img_encoder(cond)
        features = []
        for block in self.adapter.body:
            h = block(h)
            features.append(h)
        return features

    @classmethod
    def init_random(cls, seed: int = 0,
                    cfg: T2IAdapterConfig = T2IAdapterConfig(),
                    device=None) -> "T2IAdapter":
        """Weights drawn from `seed` in the JAX package's scheme on `device`
        (default: the card)."""
        return seeded_model(lambda: cls(cfg), init_weights_, seed,
                            device).eval()
