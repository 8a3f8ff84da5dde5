"""DINOv2 vision encoder, the vecset families' image conditioner.

Port of `comfy3d_tpu/models/dinov2.py` in the names of
`transformers.Dinov2Model` (`embeddings.{cls_token, mask_token,
position_embeddings, patch_embeddings.projection}`,
`encoder.layer.{i}.{norm1, attention.attention.{query,key,value},
attention.output.dense, layer_scale1.lambda1, norm2, mlp.{fc1,fc2} or
mlp.{weights_in,weights_out}, layer_scale2.lambda1}`, `layernorm`), so an
HF checkpoint loads strictly. `mask_token` is held and read by nothing, as
in the JAX package.

Patch-14 convolution, the class token, the checkpoint's position grid
resized by the antialiased Keys cubic (`models/common.py::ViTEmbeddings`),
pre-LN blocks (LayerNorm eps 1e-6, not the ViT's 1e-12) with LayerScale,
an exact-GELU MLP or SwiGLU (the giant model: `swiglu_hidden` 4,096), a
final LayerNorm. Options: `num_registers` register tokens
(`embeddings.register_tokens`, inserted after the class token once the
positions are added), `return_prenorm` (the last block's output, no final
norm) and `modulation_dim` (SF3D's adaLN: `norm{1,2}_modulation.linear2`
on silu(cond), x·(1 + scale) + shift). Images are NCHW, already
ImageNet-normalised.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .common import ViTEmbeddings, ViTSelfAttention

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class Dinov2Config:
    hidden: int = 1024               # large; giant = 1536
    layers: int = 24
    heads: int = 16
    mlp_ratio: int = 4
    patch: int = 14
    pretrain_image_size: int = 518   # → 37² patches
    use_swiglu: bool = False         # giant: True
    layer_norm_eps: float = 1e-6
    num_registers: int = 0
    return_prenorm: bool = False
    modulation_dim: int = 0

    @property
    def swiglu_hidden(self) -> int:
        h = int(self.hidden * self.mlp_ratio)
        return (int(h * 2 / 3) + 7) // 8 * 8


class Dinov2Embeddings(ViTEmbeddings):
    def __init__(self, cfg: Dinov2Config):
        super().__init__(cfg.hidden, cfg.patch,
                         cfg.pretrain_image_size // cfg.patch)
        self.mask_token = nn.Parameter(torch.zeros(1, cfg.hidden))
        self.register_tokens = (
            nn.Parameter(torch.zeros(1, cfg.num_registers, cfg.hidden))
            if cfg.num_registers else None)

    def forward(self, images):
        x = super().forward(images)
        if self.register_tokens is None:
            return x
        reg = self.register_tokens.expand(x.shape[0], -1, -1)
        return torch.cat([x[:, :1], reg, x[:, 1:]], dim=1)


class _Modulation(nn.Module):
    def __init__(self, cond_dim: int, hidden: int):
        super().__init__()
        self.linear2 = nn.Linear(cond_dim, 2 * hidden)

    def forward(self, x, cond):
        scale, shift = self.linear2(F.silu(cond)).chunk(2, dim=-1)
        return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class LayerScale(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.ones(hidden))

    def forward(self, x):
        return x * self.lambda1


class SwiGLU(nn.Module):
    def __init__(self, hidden: int, inner: int):
        super().__init__()
        self.weights_in = nn.Linear(hidden, 2 * inner)
        self.weights_out = nn.Linear(inner, hidden)

    def forward(self, x):
        x1, x2 = self.weights_in(x).chunk(2, dim=-1)
        return self.weights_out(F.silu(x1) * x2)


class GeluMLP(nn.Module):
    def __init__(self, hidden: int, inner: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, inner)
        self.fc2 = nn.Linear(inner, hidden)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Dinov2Layer(nn.Module):
    def __init__(self, cfg: Dinov2Config):
        super().__init__()
        c = cfg
        self.norm1 = nn.LayerNorm(c.hidden, eps=c.layer_norm_eps)
        self.attention = ViTSelfAttention(c.hidden, c.heads)
        self.layer_scale1 = LayerScale(c.hidden)
        self.norm2 = nn.LayerNorm(c.hidden, eps=c.layer_norm_eps)
        self.mlp = (SwiGLU(c.hidden, c.swiglu_hidden) if c.use_swiglu
                    else GeluMLP(c.hidden, c.hidden * c.mlp_ratio))
        self.layer_scale2 = LayerScale(c.hidden)
        if c.modulation_dim:
            self.norm1_modulation = _Modulation(c.modulation_dim, c.hidden)
            self.norm2_modulation = _Modulation(c.modulation_dim, c.hidden)
        else:
            self.norm1_modulation = self.norm2_modulation = None

    def forward(self, x, mod_cond=None):
        h = self.norm1(x)
        if self.norm1_modulation is not None:
            h = self.norm1_modulation(h, mod_cond)
        x = x + self.layer_scale1(self.attention(h))
        h = self.norm2(x)
        if self.norm2_modulation is not None:
            h = self.norm2_modulation(h, mod_cond)
        return x + self.layer_scale2(self.mlp(h))


class Dinov2(nn.Module):
    def __init__(self, cfg: Dinov2Config = Dinov2Config()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Dinov2Embeddings(cfg)
        self.encoder = nn.ModuleDict({"layer": nn.ModuleList([
            Dinov2Layer(cfg) for _ in range(cfg.layers)])})
        self.layernorm = nn.LayerNorm(cfg.hidden, eps=cfg.layer_norm_eps)

    def forward(self, images, mod_cond=None):
        """images [B, 3, H, W] → tokens [B, 1 + registers + N, hidden];
        `mod_cond` [B, modulation_dim] where the config has modulation."""
        x = self.embeddings(images)
        for layer in self.encoder["layer"]:
            x = layer(x, mod_cond)
        return x if self.cfg.return_prenorm else self.layernorm(x)


def init_dinov2_(model: Dinov2, generator: torch.Generator) -> None:
    """Seeded values for what `common.init_weights_` leaves: the class
    token and positions normal with std 0.02, LayerScale 1, the mask and
    register tokens 0."""
    emb = model.embeddings
    with torch.no_grad():
        for p in (emb.cls_token, emb.position_embeddings):
            p.copy_(torch.randn(p.shape, generator=generator, device=generator.device) * 0.02)
        emb.mask_token.zero_()
        if emb.register_tokens is not None:
            emb.register_tokens.zero_()
        for layer in model.encoder["layer"]:
            layer.layer_scale1.lambda1.fill_(1.0)
            layer.layer_scale2.lambda1.fill_(1.0)
