"""AutoencoderKL (the SD VAE), NCHW: latent encode and decode.

Port of `comfy3d_tpu/models/diffusion/vae.py`. Submodules carry diffusers'
`AutoencoderKL` names (`encoder.{conv_in, down_blocks.{i}.{resnets,
downsamplers}, mid_block.{resnets, attentions}, conv_norm_out, conv_out}`,
`quant_conv`, `post_quant_conv`, `decoder.{…, up_blocks.{i}.{resnets,
upsamplers}}`), the layout the JAX package's
`models/diffusion/convert.py::vae_rules` reads. GroupNorm eps is 1e-6
throughout; each stride-2 conv of the encoder is preceded by diffusers'
asymmetric (0, 1) pad.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..common import Attention


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.18215


class VAEResnet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 norm_groups: int = 32):
        super().__init__()
        self.norm1 = nn.GroupNorm(norm_groups, in_channels, eps=1e-6)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = nn.GroupNorm(norm_groups, out_channels, eps=1e-6)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(Attention):
    """GroupNorm → one-head attention over the H·W tokens (biased q/k/v)
    → + the input."""

    def __init__(self, channels: int, norm_groups: int = 32):
        super().__init__(channels, heads=1, dim_head=channels, qkv_bias=True)
        self.group_norm = nn.GroupNorm(norm_groups, channels, eps=1e-6)

    def forward(self, x):
        b, c, h, w = x.shape
        hid = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        out = super().forward(hid)
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


def _mid_block(ch: int, groups: int) -> nn.ModuleDict:
    return nn.ModuleDict({
        "resnets": nn.ModuleList([VAEResnet(ch, ch, groups),
                                  VAEResnet(ch, ch, groups)]),
        "attentions": nn.ModuleList([VAEAttention(ch, groups)])})


def _run_mid(mid, h):
    h = mid["resnets"][0](h)
    h = mid["attentions"][0](h)
    return mid["resnets"][1](h)


class Encoder(nn.Module):
    """images → 2·latent_channels moments (before `quant_conv`)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        c = cfg
        g = c.norm_groups
        self.conv_in = nn.Conv2d(c.in_channels, c.block_out_channels[0], 3,
                                 padding=1)
        blocks = []
        cur = c.block_out_channels[0]
        last = len(c.block_out_channels) - 1
        for bi, out_ch in enumerate(c.block_out_channels):
            resnets = []
            for _ in range(c.layers_per_block):
                resnets.append(VAEResnet(cur, out_ch, g))
                cur = out_ch
            ds = ([nn.ModuleDict({"conv": nn.Conv2d(out_ch, out_ch, 3,
                                                    stride=2)})]
                  if bi < last else [])
            blocks.append(nn.ModuleDict({
                "resnets": nn.ModuleList(resnets),
                "downsamplers": nn.ModuleList(ds)}))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _mid_block(cur, g)
        self.conv_norm_out = nn.GroupNorm(g, cur, eps=1e-6)
        self.conv_out = nn.Conv2d(cur, 2 * c.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            for res in block["resnets"]:
                h = res(h)
            for ds in block["downsamplers"]:
                # diffusers pads (0, 1) on H and W before the stride-2 conv
                h = ds["conv"](F.pad(h, (0, 1, 0, 1)))
        h = _run_mid(self.mid_block, h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    """latents (after `post_quant_conv`) → images in [-1, 1]."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        c = cfg
        g = c.norm_groups
        top = c.block_out_channels[-1]
        self.conv_in = nn.Conv2d(c.latent_channels, top, 3, padding=1)
        self.mid_block = _mid_block(top, g)
        blocks = []
        cur = top
        rev = list(reversed(c.block_out_channels))
        for bi, out_ch in enumerate(rev):
            resnets = []
            for _ in range(c.layers_per_block + 1):
                resnets.append(VAEResnet(cur, out_ch, g))
                cur = out_ch
            us = ([nn.ModuleDict({"conv": nn.Conv2d(out_ch, out_ch, 3,
                                                    padding=1)})]
                  if bi < len(rev) - 1 else [])
            blocks.append(nn.ModuleDict({
                "resnets": nn.ModuleList(resnets),
                "upsamplers": nn.ModuleList(us)}))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(g, cur, eps=1e-6)
        self.conv_out = nn.Conv2d(cur, c.in_channels, 3, padding=1)

    def forward(self, z):
        h = _run_mid(self.mid_block, self.conv_in(z))
        for block in self.up_blocks:
            for res in block["resnets"]:
                h = res(h)
            for us in block["upsamplers"]:
                h = us["conv"](F.interpolate(h, scale_factor=2.0,
                                             mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        lat = cfg.latent_channels
        self.encoder = Encoder(cfg)
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)
        self.decoder = Decoder(cfg)

    def encode(self, images, generator: Optional[torch.Generator] = None):
        """images [B, 3, H, W] in [-1, 1] → scaled latents [B, 4, H/8, W/8]:
        the posterior's mean, or a draw from it with `generator` (on the
        images' device)."""
        mean, logvar = self.quant_conv(self.encoder(images)).chunk(2, dim=1)
        if generator is not None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device, dtype=mean.dtype)
            mean = mean + torch.exp(0.5 * torch.clamp(logvar, -30, 20)) \
                * noise
        return mean * self.cfg.scaling_factor

    def decode(self, latents):
        """scaled latents → images [B, 3, H, W] in [-1, 1]."""
        return self.decoder(
            self.post_quant_conv(latents / self.cfg.scaling_factor))

    def forward(self, images):
        return self.decode(self.encode(images))
