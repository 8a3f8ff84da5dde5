"""LGM — Large Multiview Gaussian Model (NCHW).

Port of `comfy3d_tpu/models/lgm/model.py`: an asymmetric UNet over four
views × (RGB + Plücker ray) 9-channel inputs that gives a 14-channel splat
map per view, decoded as position (3, clamped to ±1), opacity (1, σ), scale
(3, 0.1·softplus), rotation (4, normalised wxyz) and RGB (3, 0.5·tanh +
0.5). Cross-view reasoning is `MVAttention`: GroupNorm → fused-qkv attention
over all V·H·W tokens of a sample → + the input, with the √0.5 skip scale
the whole UNet uses.

Submodules carry the names of LGM's checkpoint (`unet.{conv_in,
down_blocks.{i}.{nets, attns, downsample}, mid_block.{nets, attns},
up_blocks.{i}.{nets, attns, upsample}, norm_out, conv_out}` and the
trailing 1×1 `conv`), the layout the JAX package's
`models/lgm/convert.py::lgm_rules` reads. GroupNorm eps is 1e-5.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..common import _attend


@dataclasses.dataclass(frozen=True)
class LGMConfig:
    input_size: int = 256
    splat_size: int = 64
    in_channels: int = 9
    out_channels: int = 14
    down_channels: Tuple[int, ...] = (64, 128, 256, 512, 1024, 1024)
    down_attention: Tuple[bool, ...] = (False, False, False, True, True,
                                        True)
    mid_attention: bool = True
    up_channels: Tuple[int, ...] = (1024, 1024, 512, 256)
    up_attention: Tuple[bool, ...] = (True, True, True, False)
    layers_per_block: int = 2
    num_views: int = 4
    attention_heads: int = 16
    norm_groups: int = 32
    cam_radius: float = 1.5
    fovy: float = 49.1

    @property
    def skip_scale(self) -> float:
        return float(np.sqrt(0.5))


class LGMResnet(nn.Module):
    """GN-SiLU-conv-GN-SiLU-conv, + the (1×1-projected) input, ×
    `skip_scale`. (The JAX module's `resample="down"` average pool has no
    caller and is not ported.)"""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 32,
                 skip_scale: float = 1.0):
        super().__init__()
        self.skip_scale = skip_scale
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=1e-5)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=1e-5)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                         if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return (h + x) * self.skip_scale


class MVAttention(nn.Module):
    """GroupNorm → attention across all views' tokens of a sample → + the
    input, × `skip_scale`. Input [B·V, C, H, W]."""

    def __init__(self, dim: int, heads: int, num_views: int,
                 groups: int = 32, skip_scale: float = 1.0):
        super().__init__()
        self.heads = heads
        self.num_views = num_views
        self.skip_scale = skip_scale
        self.norm = nn.GroupNorm(groups, dim, eps=1e-5)
        self.attn = nn.ModuleDict({"qkv": nn.Linear(dim, 3 * dim, bias=False),
                                   "proj": nn.Linear(dim, dim)})

    def forward(self, x):
        bv, c, h, w = x.shape
        b = bv // self.num_views
        hid = self.norm(x).permute(0, 2, 3, 1).reshape(
            b, self.num_views * h * w, c)
        q, k, v = self.attn["qkv"](hid).chunk(3, dim=-1)
        out = self.attn["proj"](_attend(q, k, v, self.heads))
        out = out.reshape(bv, h, w, c).permute(0, 3, 1, 2)
        return (out + x) * self.skip_scale


class LGMUNet(nn.Module):
    """[B·V, 9, S, S] → [B·V, 14, S/4, S/4] splat maps (asymmetric: fewer
    up blocks than down blocks), then the trailing 1×1 `conv`."""

    def __init__(self, cfg: LGMConfig = LGMConfig()):
        super().__init__()
        self.cfg = c = cfg
        ss, g = c.skip_scale, c.norm_groups

        def res(i, o):
            return LGMResnet(i, o, groups=g, skip_scale=ss)

        def attn(ch):
            return MVAttention(ch, c.attention_heads, c.num_views, g, ss)

        unet = nn.Module()
        unet.conv_in = nn.Conv2d(c.in_channels, c.down_channels[0], 3,
                                 padding=1)
        skip_ch = [c.down_channels[0]]
        cur = c.down_channels[0]
        blocks = []
        for i, out_ch in enumerate(c.down_channels):
            blk = nn.Module()
            nets, attns = [], []
            for _ in range(c.layers_per_block):
                nets.append(res(cur, out_ch))
                cur = out_ch
                if c.down_attention[i]:
                    attns.append(attn(out_ch))
                skip_ch.append(cur)
            blk.nets = nn.ModuleList(nets)
            blk.attns = nn.ModuleList(attns)
            if i != len(c.down_channels) - 1:
                blk.downsample = nn.Conv2d(out_ch, out_ch, 3, stride=2,
                                           padding=1)
                skip_ch.append(cur)
            blocks.append(blk)
        unet.down_blocks = nn.ModuleList(blocks)

        mid = nn.Module()
        mid.nets = nn.ModuleList([res(cur, cur), res(cur, cur)])
        mid.attns = nn.ModuleList([attn(cur)] if c.mid_attention else [])
        unet.mid_block = mid

        blocks = []
        for i, out_ch in enumerate(c.up_channels):
            blk = nn.Module()
            nets, attns = [], []
            for _ in range(c.layers_per_block + 1):
                nets.append(res(cur + skip_ch.pop(), out_ch))
                cur = out_ch
                if c.up_attention[i]:
                    attns.append(attn(out_ch))
            blk.nets = nn.ModuleList(nets)
            blk.attns = nn.ModuleList(attns)
            if i != len(c.up_channels) - 1:
                blk.upsample = nn.Conv2d(out_ch, out_ch, 3, padding=1)
            blocks.append(blk)
        unet.up_blocks = nn.ModuleList(blocks)
        unet.norm_out = nn.GroupNorm(g, cur, eps=1e-5)
        unet.conv_out = nn.Conv2d(cur, c.out_channels, 3, padding=1)
        self.unet = unet
        self.conv = nn.Conv2d(c.out_channels, c.out_channels, 1)

    def forward(self, x):
        u = self.unet
        x = u.conv_in(x)
        skips = [x]
        for blk in u.down_blocks:
            for li, net in enumerate(blk.nets):
                x = net(x)
                if len(blk.attns):
                    x = blk.attns[li](x)
                skips.append(x)
            if hasattr(blk, "downsample"):
                x = blk.downsample(x)
                skips.append(x)

        mid = u.mid_block
        x = mid.nets[0](x)
        for a in mid.attns:
            x = a(x)
        x = mid.nets[1](x)

        for blk in u.up_blocks:
            for li, net in enumerate(blk.nets):
                x = net(torch.cat([x, skips.pop()], dim=1))
                if len(blk.attns):
                    x = blk.attns[li](x)
            if hasattr(blk, "upsample"):
                x = blk.upsample(F.interpolate(x, scale_factor=2.0,
                                               mode="nearest"))

        x = u.conv_out(F.silu(u.norm_out(x)))
        return self.conv(x)


def decode_gaussians(raw: torch.Tensor) -> dict:
    """[N, 14] UNet output → activated splat fields: xyz, opacity, scale,
    rotation (normalised wxyz), rgb."""
    pos = torch.clamp(raw[..., 0:3], -1.0, 1.0)
    opacity = torch.sigmoid(raw[..., 3])
    scale = 0.1 * F.softplus(raw[..., 4:7])
    rot = raw[..., 7:11]
    rot = rot / torch.clamp_min(
        torch.linalg.vector_norm(rot, dim=-1, keepdim=True), 1e-8)
    rgb = 0.5 * torch.tanh(raw[..., 11:14]) + 0.5
    return {"xyz": pos, "opacity": opacity, "scale": scale,
            "rotation": rot, "rgb": rgb}


def plucker_rays(cfg: LGMConfig, elevations, azimuths, device=None):
    """Per-view Plücker ray embeddings [V, S, S, 6] = (o × d, d) of the
    orbit cameras at `cfg.cam_radius` (default device: the card)."""
    from ...core.camera import Camera, get_rays
    cams = Camera.from_orbit(elevations, azimuths, cfg.cam_radius,
                             fovy_deg=cfg.fovy, width=cfg.input_size,
                             height=cfg.input_size, device=device)
    o, d = get_rays(cams)
    return torch.cat([torch.linalg.cross(o, d, dim=-1), d], dim=-1)
