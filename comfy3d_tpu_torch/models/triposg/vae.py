"""TripoSG's latent-set VAE.

Port of `comfy3d_tpu/models/triposg/vae.py` (upstream's `TripoSGVAEModel`,
`autoencoder_kl_triposg.py`) under upstream's names: a frequency embedding
of points (`freq_embed`, no π by default), an encoder of one cross-attention
block and `num_layers_encoder` self-attention blocks (`encode`), a decoder
of `num_layers_decoder` self-attention blocks whose output is the kv cache
(`forward`), and a query cross-attention block over the embedded points
(`decoder.blocks[-1]`) whose logits come out sign-flipped (`query`). The
blocks are `dit.DiTBlock` without qk-norm, a LayerNorm on the
cross-attention's context.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from .dit import DiTBlock, TripoSGDiTConfig


@dataclasses.dataclass(frozen=True)
class TripoSGVAEConfig:
    latent_channels: int = 64
    num_latents: int = 2048          # the sampling-time token count
    heads: int = 8
    width_encoder: int = 512
    width_decoder: int = 1024
    num_layers_encoder: int = 8
    num_layers_decoder: int = 16
    num_freqs: int = 8
    include_pi: bool = False
    scale_factor: float = 1.0
    in_channels: int = 3             # point features beside the embedding

    @property
    def embed_out_dim(self) -> int:
        return 3 * (2 * self.num_freqs + 1)


def freq_embed(x, num_freqs: int = 8, include_pi: bool = False):
    """[x, sin(x⊗f), cos(x⊗f)], f = 2^0 … 2^(F−1) (·π), dimension-major."""
    freqs = 2.0 ** np.arange(num_freqs, dtype=np.float32)
    if include_pi:
        freqs = freqs * np.pi
    f = torch.as_tensor(freqs, device=x.device)
    emb = (x[..., None] * f).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(emb), torch.cos(emb)], -1)


def _block_cfg(width: int, heads: int) -> TripoSGDiTConfig:
    return TripoSGDiTConfig(width=width, heads=heads,
                            cross_attention_dim=width)


class _Encoder(nn.Module):
    def __init__(self, c: TripoSGVAEConfig):
        super().__init__()
        cfg = _block_cfg(c.width_encoder, c.heads)
        self.proj_in = nn.Linear(c.embed_out_dim + c.in_channels,
                                 c.width_encoder)
        self.blocks = nn.ModuleList([
            DiTBlock(cfg, self_attn=i > 0, cross_attn=i == 0, qk_norm=False,
                     cross_norm=i == 0)
            for i in range(c.num_layers_encoder + 1)])
        self.norm_out = nn.LayerNorm(c.width_encoder, eps=1e-5)


class _Decoder(nn.Module):
    def __init__(self, c: TripoSGVAEConfig):
        super().__init__()
        cfg = _block_cfg(c.width_decoder, c.heads)
        # blocks[num_layers_decoder] is the query block
        self.blocks = nn.ModuleList(
            [DiTBlock(cfg, cross_attn=False, qk_norm=False)
             for _ in range(c.num_layers_decoder)]
            + [DiTBlock(cfg, self_attn=False, qk_norm=False,
                        cross_norm=True)])
        self.proj_query = nn.Linear(c.embed_out_dim, c.width_decoder)
        self.norm_out = nn.LayerNorm(c.width_decoder, eps=1e-5)
        self.proj_out = nn.Linear(c.width_decoder, 1)


class TripoSGVAE(nn.Module):
    def __init__(self, cfg: TripoSGVAEConfig = TripoSGVAEConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.encoder = _Encoder(c)
        self.quant = nn.Linear(c.width_encoder, 2 * c.latent_channels)
        self.post_quant = nn.Linear(c.latent_channels, c.width_decoder)
        self.decoder = _Decoder(c)

    def encode(self, x_q, x_kv):
        """Queries [B, N_tok, D] and context [B, N_all, D], D =
        embed_out_dim + in_channels ([freq_embed(xyz), features], the
        tokens sampled by the caller) → [B, N_tok, 2·latent] (mean |
        logvar)."""
        enc = self.encoder
        h, ctx = enc.proj_in(x_q), enc.proj_in(x_kv)
        for i, block in enumerate(enc.blocks):
            h = block(h, ctx) if i == 0 else block(h)
        return self.quant(enc.norm_out(h))

    def forward(self, latents):
        """[B, N, latent_channels] → the decoded kv cache [B, N, width]."""
        h = self.post_quant(latents)
        for block in self.decoder.blocks[:-1]:
            h = block(h)
        return h

    def query(self, decoded, points):
        """decoded [B, N, W]; points [B, M, 3] → SDF logits [B, M],
        sign-flipped."""
        c, dec = self.cfg, self.decoder
        q = dec.proj_query(freq_embed(points, c.num_freqs, c.include_pi))
        h = dec.blocks[-1](q, decoded)
        return -dec.proj_out(dec.norm_out(h))[..., 0]
