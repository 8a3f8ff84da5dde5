"""Hunyuan3D flow-matching DiT.

Port of `comfy3d_tpu/models/vecset/dit.py`: a FLUX-style denoiser without
rotary positions — double-stream blocks (the latents and the condition
tokens each with their own weights, attending jointly, the condition
first), then single-stream blocks over the merged sequence — in the
upstream torch names (`hunyuan3ddit.py`): `latent_in`, `time_in`,
`guidance_in`, `cond_in`, `double_blocks.{i}.{img,txt}_{mod.lin, attn.qkv,
attn.norm.{query,key}_norm.scale, attn.proj, mlp.0, mlp.2}`,
`single_blocks.{i}.{linear1, linear2, norm, modulation.lin}`,
`final_layer.{linear, adaLN_modulation.1}`.

Arithmetic of the JAX package: qkv channels K-major, [3, H, D] (plain
width-wide q | k | v blocks, unlike the VAE's per-head packing); the RMS qk
norm in float32; LayerNorms without affine, eps 1e-6; the tanh GELU; the
modulation chunks in the order shift, scale, gate; the timestep embedding
in the order cos | sin, with `time_factor` passed as its max period as
upstream does (t is also scaled by `time_factor`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    # defaults = hunyuan3d-dit-v2-0
    in_channels: int = 64
    context_in_dim: int = 1536
    hidden_size: int = 1024
    mlp_ratio: float = 4.0
    num_heads: int = 16
    depth: int = 16
    depth_single_blocks: int = 32
    qkv_bias: bool = True
    time_factor: float = 1000.0
    guidance_embed: bool = False     # True for the -turbo distillations


def timestep_embedding(t, dim: int, max_period=10000,
                       time_factor: float = 1000.0):
    """Sinusoidal embedding of t [B] → [B, dim], cos | sin."""
    t = time_factor * t
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([args.cos(), args.sin()], dim=-1)


class MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.in_layer = nn.Linear(in_dim, hidden)
        self.out_layer = nn.Linear(hidden, hidden)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        rrms = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6)
        return (x32 * rrms).to(x.dtype) * self.scale


class QKNorm(nn.Module):
    def __init__(self, head_dim: int):
        super().__init__()
        self.query_norm = RMSNorm(head_dim)
        self.key_norm = RMSNorm(head_dim)

    def forward(self, q, k):
        return self.query_norm(q), self.key_norm(k)


class SelfAttention(nn.Module):
    """`qkv`, `norm`, `proj` (the joint attention itself is the block's)."""

    def __init__(self, dim: int, heads: int, qkv_bias: bool = True):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.norm = QKNorm(dim // heads)
        self.proj = nn.Linear(dim, dim)

    def qkv_heads(self, x):
        """x [B, L, W] → normed q, k and v, each [B, L, H, D]."""
        q, k, v = _split_qkv(self.qkv(x), self.heads)
        q, k = self.norm(q, k)
        return q, k, v


def _split_qkv(qkv, heads):
    """[B, L, 3·H·D] (K-major) → three [B, L, H, D]."""
    b, l, w = qkv.shape
    qkv = qkv.view(b, l, 3, heads, w // (3 * heads))
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _attention(q, k, v):
    """[B, L, H, D] each → [B, L, H·D]."""
    b, l, h, d = q.shape
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return out.transpose(1, 2).reshape(b, l, h * d)


class Modulation(nn.Module):
    """silu(vec) → `lin` → n chunks [B, 1, dim]."""

    def __init__(self, dim: int, n: int):
        super().__init__()
        self.n = n
        self.lin = nn.Linear(dim, n * dim)

    def forward(self, vec):
        return self.lin(F.silu(vec))[:, None, :].chunk(self.n, dim=-1)


def _ln(x):
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


def _mlp(hidden: int, mlp_dim: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(hidden, mlp_dim),
                         nn.GELU(approximate="tanh"),
                         nn.Linear(mlp_dim, hidden))


class DoubleStreamBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_ratio: float,
                 qkv_bias: bool = True):
        super().__init__()
        mlp_dim = int(hidden * mlp_ratio)
        self.img_mod = Modulation(hidden, 6)
        self.img_attn = SelfAttention(hidden, heads, qkv_bias)
        self.img_mlp = _mlp(hidden, mlp_dim)
        self.txt_mod = Modulation(hidden, 6)
        self.txt_attn = SelfAttention(hidden, heads, qkv_bias)
        self.txt_mlp = _mlp(hidden, mlp_dim)

    def forward(self, img, txt, vec):
        i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = self.img_mod(vec)
        t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = self.txt_mod(vec)
        iq, ik, iv = self.img_attn.qkv_heads((1 + i_sc1) * _ln(img) + i_sh1)
        tq, tk, tv = self.txt_attn.qkv_heads((1 + t_sc1) * _ln(txt) + t_sh1)
        attn = _attention(torch.cat([tq, iq], 1), torch.cat([tk, ik], 1),
                          torch.cat([tv, iv], 1))
        n_txt = txt.shape[1]
        txt_attn, img_attn = attn[:, :n_txt], attn[:, n_txt:]

        img = img + i_g1 * self.img_attn.proj(img_attn)
        img = img + i_g2 * self.img_mlp((1 + i_sc2) * _ln(img) + i_sh2)
        txt = txt + t_g1 * self.txt_attn.proj(txt_attn)
        txt = txt + t_g2 * self.txt_mlp((1 + t_sc2) * _ln(txt) + t_sh2)
        return img, txt


class SingleStreamBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.hidden, self.heads = hidden, heads
        mlp_dim = int(hidden * mlp_ratio)
        self.linear1 = nn.Linear(hidden, 3 * hidden + mlp_dim)
        self.linear2 = nn.Linear(hidden + mlp_dim, hidden)
        self.norm = QKNorm(hidden // heads)
        self.modulation = Modulation(hidden, 3)

    def forward(self, x, vec):
        shift, scale, gate = self.modulation(vec)
        qkv, mlp = self.linear1((1 + scale) * _ln(x) + shift).split(
            [3 * self.hidden, self.linear1.out_features - 3 * self.hidden],
            dim=-1)
        q, k, v = _split_qkv(qkv, self.heads)
        q, k = self.norm(q, k)
        out = self.linear2(torch.cat(
            [_attention(q, k, v), F.gelu(mlp, approximate="tanh")], -1))
        return x + gate * out


class LastLayer(nn.Module):
    def __init__(self, hidden: int, out_channels: int):
        super().__init__()
        self.linear = nn.Linear(hidden, out_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                              nn.Linear(hidden, 2 * hidden))

    def forward(self, x, vec):
        shift, scale = self.adaLN_modulation(vec)[:, None, :].chunk(2, -1)
        return self.linear((1 + scale) * _ln(x) + shift)


class Hunyuan3DDiT(nn.Module):
    def __init__(self, cfg: DiTConfig = DiTConfig()):
        super().__init__()
        self.cfg = c = cfg
        h = c.hidden_size
        self.latent_in = nn.Linear(c.in_channels, h)
        self.time_in = MLPEmbedder(256, h)
        self.guidance_in = MLPEmbedder(256, h) if c.guidance_embed else None
        self.cond_in = nn.Linear(c.context_in_dim, h)
        self.double_blocks = nn.ModuleList([
            DoubleStreamBlock(h, c.num_heads, c.mlp_ratio, c.qkv_bias)
            for _ in range(c.depth)])
        self.single_blocks = nn.ModuleList([
            SingleStreamBlock(h, c.num_heads, c.mlp_ratio)
            for _ in range(c.depth_single_blocks)])
        self.final_layer = LastLayer(h, c.in_channels)

    def forward(self, x, t, cond, guidance: Optional[torch.Tensor] = None):
        """x [B, N, C] latents; t [B] in [0, 1]; cond [B, M, ctx_dim] →
        velocity [B, N, C]."""
        c = self.cfg
        latent = self.latent_in(x)
        vec = self.time_in(timestep_embedding(t, 256,
                                              max_period=c.time_factor))
        if self.guidance_in is not None:
            if guidance is None:
                raise ValueError("guidance-distilled model needs guidance")
            vec = vec + self.guidance_in(timestep_embedding(
                guidance, 256, max_period=c.time_factor))
        cond = self.cond_in(cond)
        for block in self.double_blocks:
            latent, cond = block(latent, cond, vec)
        n_cond = cond.shape[1]
        merged = torch.cat([cond, latent], dim=1)
        for block in self.single_blocks:
            merged = block(merged, vec)
        return self.final_layer(merged[:, n_cond:], vec)
