"""Shared transformer building blocks for the model zoo.

Port of `comfy3d_tpu/models/common.py`. Submodules carry the names of the
upstream checkpoints' native torch layout, so a checkpoint's state dict
loads with a strict `load_state_dict` and no conversion table:

  * the diffusers-style stack: `Attention` (to_q, to_k, to_v, to_out.0),
    `FeedForward` (net.0.proj, net.2), `BasicTransformerBlock` (norm1,
    attn1, norm2, attn2, norm3, ff) and `Transformer1D` (norm, proj_in,
    transformer_blocks.{i}, proj_out);
  * Hugging Face `ViTModel`: embeddings.{cls_token, position_embeddings,
    patch_embeddings.projection}, encoder.layer.{i}.{attention.attention.
    {query, key, value}, attention.output.dense, intermediate.dense,
    output.dense, layernorm_before, layernorm_after}, layernorm and
    pooler.dense.

The arithmetic is the JAX package's: LayerNorm eps 1e-6 (the ViT's 1e-12),
GroupNorm 32 groups with eps 1e-6, `GEGLU` gated by the tanh-approximate
GELU and the ViT MLP by the exact one, and the ViT's position grid resized
by a Keys cubic (a = -0.5) renormalised at the border, which is
`jax.image.resize(..., "bicubic")` (`F.interpolate(..., antialias=True)`).
Attention runs through `F.scaled_dot_product_attention`. Images are NCHW.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _attend(q, k, v, heads: int, bias=None):
    """[B, Nq, H·D] queries against [B, Nk, H·D] keys/values."""
    b, nq, inner = q.shape
    nk = k.shape[1]
    d = inner // heads
    q = q.view(b, nq, heads, d).transpose(1, 2)
    k = k.view(b, nk, heads, d).transpose(1, 2)
    v = v.view(b, nk, heads, d).transpose(1, 2)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    return out.transpose(1, 2).reshape(b, nq, inner)


class Attention(nn.Module):
    """Multi-head (self or cross) attention, diffusers `Attention` layout."""

    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64,
                 cross_attention_dim: Optional[int] = None,
                 out_bias: bool = True, qkv_bias: bool = False):
        super().__init__()
        inner = heads * dim_head
        kv_dim = cross_attention_dim or query_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(kv_dim, inner, bias=qkv_bias)
        self.to_v = nn.Linear(kv_dim, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim,
                                               bias=out_bias)])

    def forward(self, x, context=None, mask=None, extra_kv=None):
        """x [B, Nq, query_dim]; context [B, Nk, kv_dim]; mask [B, Nk] bool
        (True = attend), applied as a -1e9 bias as in the JAX package;
        extra_kv [B, Ne, kv_dim] appended to the keys' and values' tokens
        (reference attention), the queries unchanged."""
        ctx = x if context is None else context
        if extra_kv is not None:
            ctx = torch.cat([ctx, extra_kv], dim=1)
        bias = None
        if mask is not None:
            bias = torch.where(mask[:, None, None, :], 0.0, -1e9).to(x.dtype)
        out = _attend(self.to_q(x), self.to_k(ctx), self.to_v(ctx),
                      self.heads, bias)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        # the JAX package's `nn.gelu` default: the tanh approximation
        return a * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """diffusers FeedForward: GEGLU → Linear (net.0.proj / net.2; net.1 is
    the parameterless dropout slot)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """LayerNorm→self-attn→LayerNorm→cross-attn→LayerNorm→GEGLU-FF, each
    with a residual.

    Reference attention (Zero123Plus): `ref_mode="write"` runs plain
    self-attention and returns (x, norm1(x)); `ref_mode="read"` appends
    `ref_hidden`, a tensor an earlier write recorded, to attn1's keys and
    values (never to attn2's)."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = Attention(dim, heads, dim_head)
        if cross_attention_dim is not None:
            self.norm2 = nn.LayerNorm(dim, eps=1e-6)
            self.attn2 = Attention(dim, heads, dim_head,
                                   cross_attention_dim=cross_attention_dim)
        else:
            self.norm2 = self.attn2 = None
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim)

    def forward(self, x, context=None, mask=None, context_mask=None,
                ref_mode=None, ref_hidden=None):
        if ref_mode not in (None, "write", "read"):
            raise ValueError(f"ref_mode {ref_mode!r}")
        h = self.norm1(x)
        x = x + self.attn1(h, mask=mask, extra_kv=ref_hidden
                           if ref_mode == "read" else None)
        if self.attn2 is not None:
            x = x + self.attn2(self.norm2(x), context=context,
                               mask=context_mask)
        x = x + self.ff(self.norm3(x))
        return (x, h) if ref_mode == "write" else x


class Transformer1D(nn.Module):
    """Channel-major 1D transformer: GroupNorm over channels → proj_in → N
    blocks → proj_out → + residual. Input and output [B, C, T]."""

    def __init__(self, in_channels: int, num_layers: int, heads: int,
                 dim_head: int, cross_attention_dim: Optional[int] = None,
                 norm_num_groups: int = 32):
        super().__init__()
        inner = heads * dim_head
        self.norm = nn.GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head,
                                  cross_attention_dim=cross_attention_dim)
            for _ in range(num_layers)])
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, x, context=None):
        h = self.proj_in(self.norm(x).transpose(1, 2))      # [B, T, inner]
        for block in self.transformer_blocks:
            h = block(h, context=context)
        return self.proj_out(h).transpose(1, 2) + x


# ------------------------------------------------------------------ #
# ViT (DINO) — Hugging Face `ViTModel` layout, the image tokenizers' encoder
# ------------------------------------------------------------------ #
class ViTSelfAttention(nn.Module):
    """HF `ViTAttention`: attention.{query,key,value} → output.dense."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.attention = nn.ModuleDict({
            name: nn.Linear(hidden, hidden)
            for name in ("query", "key", "value")})
        self.output = nn.ModuleDict({"dense": nn.Linear(hidden, hidden)})

    def forward(self, x):
        a = self.attention
        out = _attend(a["query"](x), a["key"](x), a["value"](x), self.heads)
        return self.output["dense"](out)


class ViTBlock(nn.Module):
    """HF `ViTLayer`: pre-LN attention and exact-GELU MLP, each with a
    residual."""

    def __init__(self, hidden: int, heads: int, mlp_dim: int):
        super().__init__()
        self.layernorm_before = nn.LayerNorm(hidden, eps=1e-12)
        self.attention = ViTSelfAttention(hidden, heads)
        self.layernorm_after = nn.LayerNorm(hidden, eps=1e-12)
        self.intermediate = nn.ModuleDict(
            {"dense": nn.Linear(hidden, mlp_dim)})
        self.output = nn.ModuleDict({"dense": nn.Linear(mlp_dim, hidden)})

    def forward(self, x):
        x = x + self.attention(self.layernorm_before(x))
        h = F.gelu(self.intermediate["dense"](self.layernorm_after(x)))
        return x + self.output["dense"](h)


class ViTEmbeddings(nn.Module):
    """Patch embedding, cls token and the checkpoint's position grid."""

    def __init__(self, hidden: int, patch: int, pretrain_grid: int):
        super().__init__()
        self.pretrain_grid = pretrain_grid
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden))
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, pretrain_grid ** 2 + 1, hidden))
        self.patch_embeddings = nn.ModuleDict({"projection": nn.Conv2d(
            3, hidden, patch, stride=patch)})

    def forward(self, images):
        x = self.patch_embeddings["projection"](images)   # [B, D, gh, gw]
        b, d, gh, gw = x.shape
        x = x.flatten(2).transpose(1, 2)                   # [B, gh·gw, D]
        pos = self.position_embeddings
        pos_cls, pos_patch = pos[:, :1], pos[:, 1:]
        g = self.pretrain_grid
        if (gh, gw) != (g, g):
            grid = pos_patch.reshape(1, g, g, d).permute(0, 3, 1, 2)
            grid = F.interpolate(grid, size=(gh, gw), mode="bicubic",
                                 align_corners=False, antialias=True)
            pos_patch = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, d)
        cls = (self.cls_token + pos_cls).expand(b, 1, d)
        return torch.cat([cls, x + pos_patch], dim=1)


class ViT(nn.Module):
    """DINO / HF-ViT encoder: conv patch embedding + cls token +
    interpolated position embeddings + pre-LN blocks + final LN.

    Input NCHW in the ImageNet-normalised range (callers normalise; it is
    model-specific). Returns the last hidden state [B, 1 + gh·gw, hidden].
    It holds HF's pooler.dense, as `ViTModel` does by default, so a
    checkpoint that has it loads strictly; no output reads it, as no image
    tokenizer does.
    """

    def __init__(self, hidden: int = 768, layers: int = 12, heads: int = 12,
                 mlp_dim: int = 3072, patch: int = 16, pretrain_grid: int = 14):
        super().__init__()
        self.embeddings = ViTEmbeddings(hidden, patch, pretrain_grid)
        self.encoder = nn.ModuleDict({"layer": nn.ModuleList([
            ViTBlock(hidden, heads, mlp_dim) for _ in range(layers)])})
        self.layernorm = nn.LayerNorm(hidden, eps=1e-12)
        self.pooler = nn.ModuleDict({"dense": nn.Linear(hidden, hidden)})

    def forward(self, images):
        x = self.embeddings(images)
        for block in self.encoder["layer"]:
            x = block(x)
        return self.layernorm(x)


def init_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded weights in the JAX package's scheme, in place: Linear, conv
    and transposed-conv kernels (and `nn.MultiheadAttention`'s projection
    matrices) normal with std 1/sqrt(fan_in), biases 0, norms 1 and 0."""
    def draw(w, fan_in):
        w.copy_(torch.randn(w.shape, generator=generator) / fan_in ** 0.5)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                w = mod.weight
                draw(w, w.shape[0] * w[0, 0].numel()
                     if isinstance(mod, nn.ConvTranspose2d) else w[0].numel())
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.MultiheadAttention):
                for w in (mod.in_proj_weight, mod.q_proj_weight,
                          mod.k_proj_weight, mod.v_proj_weight):
                    if w is not None:
                        draw(w, w.shape[1])
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_normalize(images):
    """images [B, 3, H, W] in [0, 1]."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype,
                        device=images.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, dtype=images.dtype,
                       device=images.device)[:, None, None]
    return (images - mean) / std
