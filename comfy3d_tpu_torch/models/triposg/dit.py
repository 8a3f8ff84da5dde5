"""TripoSG's rectified-flow DiT and its block family.

Port of `comfy3d_tpu/models/triposg/dit.py` (upstream's `TripoSGDiTModel`,
`triposg_transformer.py`) under upstream's torch names, so a native
checkpoint loads with `strict=True`: the time embedding rides as an extra
token prepended to the latents (dropped again before `proj_out`); blocks are
pre-LN self-attention (no qkv bias, RMS qk-norm in float32), cross-attention
into the DINOv2 tokens (an optional LayerNorm on the context) and an
exact-GELU feed-forward; the second half of the blocks takes UNet-style
skips, `skip_linear` on [skip, x] first and `skip_norm` after.

Upstream's attention processor splits the concatenated projections head
first: head h reads channels [h·3d, h·3d + d) of [to_q | to_k | to_v] (of
[to_k | to_v] in cross-attention), d the head width. The modules here take
the checkpoint's weights as they are and split so; the JAX package repacks
the weights instead (`convert.triposg_state_dict_from_flax` undoes that).

`DiTBlock` is importable on its own: the TripoSG VAE, PartCrafter and
Craftsman-class models build on it.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class TripoSGDiTConfig:
    width: int = 2048
    in_channels: int = 64
    num_layers: int = 21
    heads: int = 16
    cross_attention_dim: int = 1024
    mlp_ratio: float = 4.0


def _rms(x, scale, eps: float = 1e-6):
    """RMS norm over the last axis, computed in float32."""
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * r).to(x.dtype) * scale


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return _rms(x, self.weight)


class Attention(nn.Module):
    """Self- (`kv_dim` None) or cross-attention with upstream's head-major
    split of the concatenated projections."""

    def __init__(self, dim: int, heads: int, kv_dim: int | None = None,
                 qkv_bias: bool = False, qk_norm: bool = True,
                 norm_cross: bool = False):
        super().__init__()
        self.heads, self.cross = heads, kv_dim is not None
        kv_dim = kv_dim or dim
        hd = dim // heads
        self.norm_cross = (nn.LayerNorm(kv_dim, eps=1e-5) if norm_cross
                           else None)
        self.to_q = nn.Linear(dim, dim, bias=qkv_bias)
        self.to_k = nn.Linear(kv_dim, dim, bias=qkv_bias)
        self.to_v = nn.Linear(kv_dim, dim, bias=qkv_bias)
        if qk_norm:
            self.norm_q, self.norm_k = RMSNorm(hd), RMSNorm(hd)
        else:
            self.norm_q = self.norm_k = None
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, context=None):
        b, nq, dim = x.shape
        h = self.heads
        hd = dim // h
        ctx = x if context is None else context
        if self.norm_cross is not None:
            ctx = self.norm_cross(ctx)
        nk = ctx.shape[1]
        if self.cross:
            q = self.to_q(x).view(b, nq, h, hd)
            kv = torch.cat([self.to_k(ctx), self.to_v(ctx)], -1)
            k, v = kv.view(b, nk, h, 2 * hd).split(hd, -1)
        else:
            qkv = torch.cat([self.to_q(x), self.to_k(x), self.to_v(x)], -1)
            q, k, v = qkv.view(b, nq, h, 3 * hd).split(hd, -1)
        if self.norm_q is not None:
            q, k = self.norm_q(q), self.norm_k(k)
        out = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        return self.to_out[0](out.transpose(1, 2).reshape(b, nq, dim))


class _GELUProj(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner)

    def forward(self, x):
        return F.gelu(self.proj(x))


class FeedForward(nn.Module):
    """`ff.net.0.proj` (exact GELU) and `ff.net.2`, diffusers' names."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.net = nn.ModuleList([_GELUProj(dim, inner), nn.Identity(),
                                  nn.Linear(inner, dim)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class DiTBlock(nn.Module):
    """Upstream's DiTBlock (triposg_transformer.py:129-371); the VAE and
    PartCrafter instantiate it without self- or cross-attention."""

    def __init__(self, cfg: TripoSGDiTConfig, skip: bool = False,
                 self_attn: bool = True, cross_attn: bool = True,
                 qk_norm: bool = True, cross_norm: bool = False):
        super().__init__()
        w = cfg.width
        if skip:
            self.skip_linear = nn.Linear(2 * w, w)
            self.skip_norm = nn.LayerNorm(w, eps=1e-5)
        else:
            self.skip_linear = self.skip_norm = None
        if self_attn:
            self.norm1 = nn.LayerNorm(w, eps=1e-5)
            self.attn1 = Attention(w, cfg.heads, qk_norm=qk_norm)
        else:
            self.norm1 = self.attn1 = None
        if cross_attn:
            self.norm2 = nn.LayerNorm(w, eps=1e-5)
            self.attn2 = Attention(w, cfg.heads, cfg.cross_attention_dim,
                                   qk_norm=qk_norm, norm_cross=cross_norm)
        else:
            self.norm2 = self.attn2 = None
        self.norm3 = nn.LayerNorm(w, eps=1e-5)
        self.ff = FeedForward(w, int(w * cfg.mlp_ratio))

    def forward(self, x, context=None, skip_x=None):
        if self.skip_linear is not None:
            # skip_concat_front, skip_norm_last: Linear first, LayerNorm after
            x = self.skip_norm(self.skip_linear(torch.cat([skip_x, x], -1)))
        if self.attn1 is not None:
            x = x + self.attn1(self.norm1(x))
        if self.attn2 is not None:
            x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


def _sinusoidal(t, dim: int):
    """[sin, cos] of t·10000^(−i/half), i < half = dim // 2."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.sin(args), torch.cos(args)], -1)


class TimestepEmbedding(nn.Module):
    """diffusers' TimestepEmbedding(width, 4·width, out_dim=width), GELU."""

    def __init__(self, width: int):
        super().__init__()
        self.linear_1 = nn.Linear(width, 4 * width)
        self.linear_2 = nn.Linear(4 * width, width)

    def forward(self, x):
        return self.linear_2(F.gelu(self.linear_1(x)))


class TripoSGDiT(nn.Module):
    def __init__(self, cfg: TripoSGDiTConfig = TripoSGDiTConfig()):
        super().__init__()
        self.cfg = c = cfg
        mid = c.num_layers // 2
        self.time_proj = TimestepEmbedding(c.width)
        self.proj_in = nn.Linear(c.in_channels, c.width)
        self.blocks = nn.ModuleList([DiTBlock(c, skip=i > mid)
                                     for i in range(c.num_layers)])
        self.norm_out = nn.LayerNorm(c.width, eps=1e-5)
        self.proj_out = nn.Linear(c.width, c.in_channels)

    def forward(self, x, t, context):
        """x [B, N, C]; t [B] (flow σ·1000); context [B, M, D] → velocity
        [B, N, C]."""
        c = self.cfg
        n = x.shape[1]
        temb = self.time_proj(_sinusoidal(t, c.width))
        h = torch.cat([temb[:, None], self.proj_in(x)], 1)
        mid = c.num_layers // 2
        skips = []
        for i, block in enumerate(self.blocks):
            h = block(h, context, skips.pop() if i > mid else None)
            if i < mid:
                skips.append(h)
        return self.proj_out(self.norm_out(h)[:, -n:])
