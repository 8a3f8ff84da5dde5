"""Vecset (latent-set) attention blocks.

Port of `comfy3d_tpu/models/vecset/blocks.py`, in the upstream torch
module names (`attention_blocks.py` of Hunyuan3D-2's shape generator), so
a native checkpoint loads strictly:

  * `VecSelfAttention`: `c_qkv`, `c_proj`, the optional qk LayerNorms
    `attention.{q,k}_norm`; `VecCrossAttention`: `c_q`, `c_kv`, `c_proj`;
  * `VecMLP`: `c_fc`, `c_proj`, the exact GELU;
  * `ResidualAttentionBlock` (`ln_1`, `attn`, `ln_2`, `mlp`) and
    `VecTransformer` (`resblocks.{i}`);
  * `ResidualCrossAttentionBlock` (`ln_1`, `ln_2`, `attn`, `ln_3`, `mlp`)
    and `CrossAttentionDecoder` (`query_proj`, `latents_proj`,
    `cross_attn_decoder`, `ln_post`, `output_proj`).

Two packings of the attention's output channels, as upstream: `c_qkv` is
per head, [H, (q | k | v)·D], and `c_kv` is per head, [H, (k | v)·D] —
not three (two) width-wide blocks. LayerNorms use eps 1e-6, `ln_post`
1e-5; the decoder's qk norm is on only with `ln_post`. Attention runs
through `F.scaled_dot_product_attention`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class FourierConfig:
    num_freqs: int = 8
    include_pi: bool = True
    input_dim: int = 3
    include_input: bool = True

    @property
    def out_dim(self) -> int:
        extra = 1 if (self.include_input or self.num_freqs == 0) else 0
        return self.input_dim * (self.num_freqs * 2 + extra)


def fourier_embed(x: torch.Tensor, cfg: FourierConfig = FourierConfig()
                  ) -> torch.Tensor:
    """[..., D] → [..., D·(2F + 1)]: (x, sin(f·x), cos(f·x)) with the
    frequencies 2^i (× π) in float32, each input dimension's F products
    side by side."""
    if cfg.num_freqs == 0:
        return x
    freqs = 2.0 ** np.arange(cfg.num_freqs, dtype=np.float32)
    if cfg.include_pi:
        freqs = freqs * np.float32(np.pi)
    f = torch.as_tensor(freqs, device=x.device)
    emb = (x[..., None] * f).reshape(*x.shape[:-1], -1)
    parts = ([x] if cfg.include_input else []) + [emb.sin(), emb.cos()]
    return torch.cat(parts, dim=-1)


def _attend_heads(q, k, v):
    """q [B, Nq, H, D], k / v [B, Nk, H, D] → [B, Nq, H·D]."""
    b, nq, h, d = q.shape
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return out.transpose(1, 2).reshape(b, nq, h * d)


def _qk_norms(head_dim: int) -> nn.ModuleDict:
    return nn.ModuleDict({"q_norm": nn.LayerNorm(head_dim, eps=1e-6),
                          "k_norm": nn.LayerNorm(head_dim, eps=1e-6)})


class VecSelfAttention(nn.Module):
    def __init__(self, width: int, heads: int, qkv_bias: bool = True,
                 qk_norm: bool = False):
        super().__init__()
        self.heads = heads
        self.c_qkv = nn.Linear(width, 3 * width, bias=qkv_bias)
        self.c_proj = nn.Linear(width, width)
        self.attention = _qk_norms(width // heads) if qk_norm else None

    def forward(self, x):                          # [B, N, W]
        b, n, w = x.shape
        qkv = self.c_qkv(x).view(b, n, self.heads, 3 * (w // self.heads))
        q, k, v = qkv.chunk(3, dim=-1)             # per-head packing
        if self.attention is not None:
            q = self.attention["q_norm"](q)
            k = self.attention["k_norm"](k)
        return self.c_proj(_attend_heads(q, k, v))


class VecCrossAttention(nn.Module):
    def __init__(self, width: int, heads: int, data_width=None,
                 qkv_bias: bool = True, qk_norm: bool = False):
        super().__init__()
        self.heads = heads
        self.c_q = nn.Linear(width, width, bias=qkv_bias)
        self.c_kv = nn.Linear(data_width or width, 2 * width, bias=qkv_bias)
        self.c_proj = nn.Linear(width, width)
        self.attention = _qk_norms(width // heads) if qk_norm else None

    def forward(self, x, data):            # [B, Nq, W], [B, Nd, DW]
        b, nq, w = x.shape
        hd = w // self.heads
        q = self.c_q(x).view(b, nq, self.heads, hd)
        kv = self.c_kv(data).view(b, data.shape[1], self.heads, 2 * hd)
        k, v = kv.chunk(2, dim=-1)
        if self.attention is not None:
            q = self.attention["q_norm"](q)
            k = self.attention["k_norm"](k)
        return self.c_proj(_attend_heads(q, k, v))


class VecMLP(nn.Module):
    def __init__(self, width: int, expand_ratio: int = 4,
                 output_width=None):
        super().__init__()
        self.c_fc = nn.Linear(width, width * expand_ratio)
        self.c_proj = nn.Linear(width * expand_ratio, output_width or width)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, qkv_bias: bool = True,
                 qk_norm: bool = False):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-6)
        self.attn = VecSelfAttention(width, heads, qkv_bias, qk_norm)
        self.ln_2 = nn.LayerNorm(width, eps=1e-6)
        self.mlp = VecMLP(width)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class VecTransformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int,
                 qkv_bias: bool = True, qk_norm: bool = False):
        super().__init__()
        self.resblocks = nn.ModuleList([
            ResidualAttentionBlock(width, heads, qkv_bias, qk_norm)
            for _ in range(layers)])

    def forward(self, x):
        for block in self.resblocks:
            x = block(x)
        return x


class ResidualCrossAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, data_width=None,
                 mlp_expand_ratio: int = 4, qkv_bias: bool = True,
                 qk_norm: bool = False):
        super().__init__()
        dw = data_width or width
        self.ln_1 = nn.LayerNorm(width, eps=1e-6)
        self.ln_2 = nn.LayerNorm(dw, eps=1e-6)
        self.attn = VecCrossAttention(width, heads, dw, qkv_bias, qk_norm)
        self.ln_3 = nn.LayerNorm(width, eps=1e-6)
        self.mlp = VecMLP(width, mlp_expand_ratio)

    def forward(self, x, data):
        x = x + self.attn(self.ln_1(x), self.ln_2(data))
        return x + self.mlp(self.ln_3(x))


class CrossAttentionDecoder(nn.Module):
    """Fourier-embedded query points cross-attend into the latent set →
    occupancy logits."""

    def __init__(self, width: int, heads: int, out_channels: int = 1,
                 mlp_expand_ratio: int = 4, downsample_ratio: int = 1,
                 enable_ln_post: bool = True, qkv_bias: bool = True,
                 qk_norm: bool = False,
                 fourier: FourierConfig = FourierConfig()):
        super().__init__()
        self.fourier = fourier
        self.query_proj = nn.Linear(fourier.out_dim, width)
        self.latents_proj = (nn.Linear(width * downsample_ratio, width)
                             if downsample_ratio != 1 else None)
        self.cross_attn_decoder = ResidualCrossAttentionBlock(
            width, heads, width, mlp_expand_ratio, qkv_bias,
            qk_norm and enable_ln_post)
        self.ln_post = (nn.LayerNorm(width, eps=1e-5) if enable_ln_post
                        else None)
        self.output_proj = nn.Linear(width, out_channels)

    def forward(self, queries, latents):
        """queries [B, M, 3]; latents [B, N, W·ds] → [B, M, out]."""
        q = self.query_proj(fourier_embed(queries, self.fourier))
        if self.latents_proj is not None:
            latents = self.latents_proj(latents)
        x = self.cross_attn_decoder(q, latents)
        if self.ln_post is not None:
            x = self.ln_post(x)
        return self.output_proj(x)
