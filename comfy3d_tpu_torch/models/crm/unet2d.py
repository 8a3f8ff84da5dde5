"""The unconditional diffusers `UNet2DModel` (NCHW): CRM's triplane refiner.

Port of `comfy3d_tpu/models/crm/unet2d.py`. CRM's `UNetPP`
(`CRM/model/archs/unet.py:16-45`) wraps a `UNet2DModel` of 7 blocks,
self-attention on down blocks 3-5 and up blocks 1-3, two resnets per block
and a fixed timestep. The resnets are the conditional UNet's
(`diffusion/unet.py::ResnetBlock`: GroupNorm eps 1e-5, the projected time
embedding added), the attention blocks diffusers' `Attention` as
Attn{Down,Up}Block2D build it (GroupNorm eps 1e-5, biased q/k/v/out, heads
of `attention_head_dim` channels, + the input), the resamplers a stride-2
conv and a nearest 2× upsample + conv. Submodules carry diffusers' names
(`time_embedding.linear_{1,2}`, `conv_in`, `down_blocks.{i}.{resnets,
attentions, downsamplers}`, `mid_block`, `up_blocks.{i}.{resnets,
attentions, upsamplers}`, `conv_norm_out`, `conv_out`), `CRM.pth`'s
layout under `unet2.unet.`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..common import Attention
from ..diffusion.unet import (Downsample, ResnetBlock, Upsample, _block,
                              timestep_embedding)


@dataclasses.dataclass(frozen=True)
class UNet2DModelConfig:
    in_channels: int = 32
    out_channels: int = 32
    block_out_channels: Tuple[int, ...] = (64, 128, 128, 256, 256, 512,
                                           512)
    # True where the block type is Attn{Down,Up}Block2D
    down_attn: Tuple[bool, ...] = (False, False, False, True, True, True,
                                   False)
    up_attn: Tuple[bool, ...] = (False, True, True, True, False, False,
                                 False)
    layers_per_block: int = 2
    attention_head_dim: int = 8
    norm_groups: int = 32

    @classmethod
    def crm(cls) -> "UNet2DModelConfig":
        """The UNetPP instantiation (unet.py:17-41)."""
        return cls()

    @classmethod
    def tiny(cls) -> "UNet2DModelConfig":
        return cls(in_channels=8, out_channels=8,
                   block_out_channels=(8, 16), down_attn=(False, True),
                   up_attn=(True, False), layers_per_block=1,
                   attention_head_dim=4, norm_groups=4)


class SelfAttnBlock2D(Attention):
    """GroupNorm → multi-head self-attention over the H·W tokens (biased
    q/k/v/out) → + the input."""

    def __init__(self, channels: int, head_dim: int, norm_groups: int):
        heads = max(channels // head_dim, 1)
        super().__init__(channels, heads=heads, dim_head=channels // heads,
                         qkv_bias=True)
        self.group_norm = nn.GroupNorm(norm_groups, channels, eps=1e-5)

    def forward(self, x):
        b, c, h, w = x.shape
        hid = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        out = super().forward(hid)
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class UNet2DModel(nn.Module):
    def __init__(self, cfg: UNet2DModelConfig = UNet2DModelConfig()):
        super().__init__()
        self.cfg = c = cfg
        ch0 = c.block_out_channels[0]
        temb_dim, g = ch0 * 4, c.norm_groups
        self.time_embedding = nn.ModuleDict({
            "linear_1": nn.Linear(ch0, temb_dim),
            "linear_2": nn.Linear(temb_dim, temb_dim)})
        self.conv_in = nn.Conv2d(c.in_channels, ch0, 3, padding=1)

        def attn(ch):
            return SelfAttnBlock2D(ch, c.attention_head_dim, g)

        skip_ch, cur, down = [ch0], ch0, []
        last = len(c.block_out_channels) - 1
        for i, ch in enumerate(c.block_out_channels):
            resnets, attns = [], []
            for _ in range(c.layers_per_block):
                resnets.append(ResnetBlock(cur, ch, temb_dim, g))
                cur = ch
                if c.down_attn[i]:
                    attns.append(attn(ch))
                skip_ch.append(ch)
            ds = Downsample(ch) if i < last else None
            if ds is not None:
                skip_ch.append(ch)
            down.append(_block(resnets, attns, ds, "downsamplers"))
        self.down_blocks = nn.ModuleList(down)

        mid = c.block_out_channels[-1]
        self.mid_block = nn.ModuleDict({
            "resnets": nn.ModuleList([ResnetBlock(cur, mid, temb_dim, g),
                                      ResnetBlock(mid, mid, temb_dim, g)]),
            "attentions": nn.ModuleList([attn(mid)])})
        cur, up = mid, []
        for i, ch in enumerate(reversed(c.block_out_channels)):
            resnets, attns = [], []
            for _ in range(c.layers_per_block + 1):
                resnets.append(ResnetBlock(cur + skip_ch.pop(), ch, temb_dim,
                                           g))
                cur = ch
                if c.up_attn[i]:
                    attns.append(attn(ch))
            us = Upsample(ch) if i < last else None
            up.append(_block(resnets, attns, us, "upsamplers"))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = nn.GroupNorm(g, ch0, eps=1e-5)
        self.conv_out = nn.Conv2d(ch0, c.out_channels, 3, padding=1)

    def forward(self, x, t):
        """x [B, Cin, H, W]; t a timestep (scalar or [B]) → [B, Cout, H, W]."""
        te = self.time_embedding
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        temb = timestep_embedding(t.expand(x.shape[0]),
                                  self.cfg.block_out_channels[0])
        temb = te["linear_2"](F.silu(te["linear_1"](temb)))
        h = self.conv_in(x)
        skips = [h]
        for block in self.down_blocks:
            attns = block["attentions"]
            for li, res in enumerate(block["resnets"]):
                h = res(h, temb)
                if len(attns):
                    h = attns[li](h)
                skips.append(h)
            for ds in block["downsamplers"]:
                h = ds(h)
                skips.append(h)
        mid = self.mid_block
        h = mid["resnets"][1](mid["attentions"][0](mid["resnets"][0](h, temb)),
                              temb)
        for block in self.up_blocks:
            attns = block["attentions"]
            for li, res in enumerate(block["resnets"]):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if len(attns):
                    h = attns[li](h)
            for us in block["upsamplers"]:
                h = us(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))
