"""InstantMesh: six posed views → triplanes → SDF, deformation and colour.

Port of `comfy3d_tpu/models/instantmesh/model.py`:

  DINO ViT-B/16 whose blocks are modulated by the camera (adaLN: SiLU →
  Linear to shift/scale before the attention and before the MLP; the
  camera embedding is Linear(16 → 768) → SiLU → Linear of [12 c2w + 4
  intrinsics])
  → TriplaneTransformer (learned position tokens [3·32², 1024], 16 ×
  (cross-attention → self-attention → exact-GELU MLP), final LN,
  ConvTranspose 2× to triplanes [3, 80, 64, 64])
  → OSGDecoder: sdf (1), deformation (3), rgb (3, sigmoid·1.002 − 0.001)
  and cube-weight (21, ×0.1) ReLU MLPs over the three planes' features.

Submodules carry the upstream checkpoint's names (`encoder.model.*` in HF
ViT layout with `adaLN_modulation.1`, `encoder.camera_embedder.{0,2}`,
`transformer.layers.{i}.{norm1,cross_attn,norm2,self_attn,norm3,mlp}`
with `nn.MultiheadAttention`'s keys, `transformer.{pos_embed,norm,deconv}`,
`synthesizer.decoder.net_{sdf,deformation,rgb,weight}.{0,2,4,6}`), so its
state dict loads with a strict `load_state_dict`. Triplanes are
[B, 3, C, H, W] (the JAX package's are [B, 3, H, W, C]). The arithmetic is
the JAX package's: the ViT's LayerNorms use eps 1e-12, the transformer
blocks' 1e-5 and its final norm flax's default 1e-6.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..common import ViTBlock, ViTEmbeddings, _attend, imagenet_normalize
from ..triposr.model import grid_sample_2d


@dataclasses.dataclass(frozen=True)
class InstantMeshConfig:
    encoder_feat_dim: int = 768
    transformer_dim: int = 1024
    transformer_layers: int = 16
    transformer_heads: int = 16
    triplane_low_res: int = 32
    triplane_high_res: int = 64
    triplane_dim: int = 80
    grid_res: int = 128
    grid_scale: float = 2.1
    deformation_multiplier: float = 4.0
    decoder_hidden: int = 64
    decoder_layers: int = 4
    # ViT
    vit_layers: int = 12
    vit_heads: int = 12
    vit_mlp: int = 3072
    patch: int = 16
    vit_pretrain_grid: int = 14


class ViTBlockAdaLN(ViTBlock):
    """HF `ViTLayer` with a DiT-style camera modulation head
    (`adaLN_modulation.1`): h·(1 + scale) + shift after each pre-norm."""

    def __init__(self, hidden: int, heads: int, mlp_dim: int):
        super().__init__(hidden, heads, mlp_dim)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                              nn.Linear(hidden, 4 * hidden))

    def forward(self, x, adaln_input):
        shift_msa, scale_msa, shift_mlp, scale_mlp = \
            self.adaLN_modulation(adaln_input)[:, None].chunk(4, dim=-1)
        h = self.layernorm_before(x) * (1 + scale_msa) + shift_msa
        x = x + self.attention(h)
        h = self.layernorm_after(x) * (1 + scale_mlp) + shift_mlp
        h = F.gelu(self.intermediate["dense"](h))
        return x + self.output["dense"](h)


class DinoViTAdaLN(nn.Module):
    """The encoder's `model`: HF ViT layout without a pooler, blocks
    modulated by the camera embedding."""

    def __init__(self, hidden: int, layers: int, heads: int, mlp_dim: int,
                 patch: int, pretrain_grid: int):
        super().__init__()
        self.embeddings = ViTEmbeddings(hidden, patch, pretrain_grid)
        self.encoder = nn.ModuleDict({"layer": nn.ModuleList([
            ViTBlockAdaLN(hidden, heads, mlp_dim) for _ in range(layers)])})
        self.layernorm = nn.LayerNorm(hidden, eps=1e-12)

    def forward(self, images, adaln_input):
        x = self.embeddings(images)
        for block in self.encoder["layer"]:
            x = block(x, adaln_input)
        return self.layernorm(x)


class DinoAdaLN(nn.Module):
    """The camera-conditioned image encoder: `model` and
    `camera_embedder`."""

    def __init__(self, hidden: int = 768, layers: int = 12, heads: int = 12,
                 mlp_dim: int = 3072, patch: int = 16,
                 pretrain_grid: int = 14):
        super().__init__()
        self.model = DinoViTAdaLN(hidden, layers, heads, mlp_dim, patch,
                                  pretrain_grid)
        self.camera_embedder = nn.Sequential(
            nn.Linear(16, hidden), nn.SiLU(), nn.Linear(hidden, hidden))

    def forward(self, images, cameras):
        """images [B, 3, H, W] in [0, 1]; cameras [B, 16] →
        [B, 1 + gh·gw, hidden]."""
        return self.model(imagenet_normalize(images),
                          self.camera_embedder(cameras))


def _mha(attn: nn.MultiheadAttention, x, ctx):
    """`nn.MultiheadAttention` without biases, from its own weights: packed
    `in_proj_weight` (self) or separate `{q,k,v}_proj_weight` (kdim ≠
    embed_dim), through `F.scaled_dot_product_attention`."""
    if attn.in_proj_weight is not None:
        wq, wk, wv = attn.in_proj_weight.chunk(3)
    else:
        wq, wk, wv = attn.q_proj_weight, attn.k_proj_weight, \
            attn.v_proj_weight
    out = _attend(F.linear(x, wq), F.linear(ctx, wk), F.linear(ctx, wv),
                  attn.num_heads)
    return attn.out_proj(out)


class LRMBlock(nn.Module):
    """cross-attention → self-attention → exact-GELU MLP, pre-norm with
    residuals; no attention biases."""

    def __init__(self, dim: int, heads: int, cond_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.cross_attn = nn.MultiheadAttention(
            dim, heads, bias=False, kdim=cond_dim, vdim=cond_dim,
            batch_first=True)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.self_attn = nn.MultiheadAttention(dim, heads, bias=False,
                                               batch_first=True)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = nn.Sequential(nn.Linear(dim, 4 * dim), nn.GELU(),
                                 nn.Dropout(0.0), nn.Linear(4 * dim, dim))

    def forward(self, x, cond):
        x = x + _mha(self.cross_attn, self.norm1(x), cond)
        h = self.norm2(x)
        x = x + _mha(self.self_attn, h, h)
        return x + self.mlp(self.norm3(x))


class TriplaneTransformer(nn.Module):
    def __init__(self, cfg: InstantMeshConfig):
        super().__init__()
        c = cfg
        self.low_res = c.triplane_low_res
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 3 * c.triplane_low_res ** 2, c.transformer_dim))
        self.layers = nn.ModuleList([
            LRMBlock(c.transformer_dim, c.transformer_heads,
                     c.encoder_feat_dim)
            for _ in range(c.transformer_layers)])
        self.norm = nn.LayerNorm(c.transformer_dim, eps=1e-6)
        self.deconv = nn.ConvTranspose2d(c.transformer_dim, c.triplane_dim,
                                         2, stride=2)

    def forward(self, image_feats):
        """image_feats [B, L, cond] → triplanes [B, 3, C, 2·low, 2·low]."""
        b = image_feats.shape[0]
        lr = self.low_res
        x = self.pos_embed.expand(b, -1, -1)
        for layer in self.layers:
            x = layer(x, image_feats)
        x = self.norm(x)
        x = x.reshape(b * 3, lr, lr, -1).permute(0, 3, 1, 2)
        x = self.deconv(x)
        return x.reshape(b, 3, *x.shape[1:])


def _head(in_dim: int, hidden: int, layers: int, out_dim: int):
    mods = [nn.Linear(in_dim, hidden), nn.ReLU()]
    for _ in range(layers - 2):
        mods += [nn.Linear(hidden, hidden), nn.ReLU()]
    mods.append(nn.Linear(hidden, out_dim))
    return nn.Sequential(*mods)


class OSGDecoder(nn.Module):
    """sdf / deformation / rgb / cube-weight heads over [M, 3C] features
    ([M, 8·3C] for the weights)."""

    def __init__(self, n_features: int, hidden: int = 64, layers: int = 4):
        super().__init__()
        self.net_sdf = _head(3 * n_features, hidden, layers, 1)
        self.net_rgb = _head(3 * n_features, hidden, layers, 3)
        self.net_deformation = _head(3 * n_features, hidden, layers, 3)
        self.net_weight = _head(8 * 3 * n_features, hidden, layers, 21)

    def forward(self, feats, mode: str):
        if mode == "sdf":
            return self.net_sdf(feats)
        if mode == "deformation":
            return self.net_deformation(feats)
        if mode == "rgb":
            return torch.sigmoid(self.net_rgb(feats)) * (1 + 2 * 0.001) \
                - 0.001
        if mode == "weight":
            return self.net_weight(feats) * 0.1
        raise ValueError(mode)


class InstantMesh(nn.Module):
    """`forward`: views + cameras → triplanes; `query_geometry` /
    `query_color`: one asset's triplanes + points → field."""

    def __init__(self, cfg: InstantMeshConfig = InstantMeshConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.encoder = DinoAdaLN(c.encoder_feat_dim, c.vit_layers,
                                 c.vit_heads, c.vit_mlp, c.patch,
                                 c.vit_pretrain_grid)
        self.transformer = TriplaneTransformer(c)
        self.synthesizer = nn.ModuleDict({"decoder": OSGDecoder(
            c.triplane_dim, c.decoder_hidden, c.decoder_layers)})

    @property
    def decoder(self) -> OSGDecoder:
        return self.synthesizer["decoder"]

    def forward(self, images, cameras):
        """images [B, N, 3, H, W] in [0, 1]; cameras [B, N, 16] →
        triplanes [B, 3, C, 2·low, 2·low]."""
        b, n = images.shape[:2]
        feats = self.encoder(images.flatten(0, 1), cameras.flatten(0, 1))
        return self.transformer(feats.reshape(b, -1, feats.shape[-1]))

    def sample_triplane(self, planes, pts):
        """planes [3, C, H, W]; pts [M, 3] in the grid_scale box → [M, 3C]
        from the (x, y), (x, z) and (z, y) planes."""
        half = torch.tensor(self.cfg.grid_scale * 0.5, dtype=pts.dtype,
                            device=pts.device)
        u = pts / half
        return torch.cat([grid_sample_2d(planes[0], u[:, [0, 1]]),
                          grid_sample_2d(planes[1], u[:, [0, 2]]),
                          grid_sample_2d(planes[2], u[:, [2, 1]])], -1)

    def query_geometry(self, planes, pts):
        """→ (sdf [M], deformation [M, 3] bounded to a cell's fraction)."""
        c = self.cfg
        feats = self.sample_triplane(planes, pts)
        sdf = self.decoder(feats, "sdf")[:, 0]
        deform = torch.tanh(self.decoder(feats, "deformation")) \
            / (c.grid_res * c.deformation_multiplier)
        return sdf, deform * c.grid_scale

    def query_color(self, planes, pts):
        return self.decoder(self.sample_triplane(planes, pts), "rgb")
