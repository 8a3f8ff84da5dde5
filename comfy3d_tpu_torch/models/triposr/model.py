"""TripoSR: one image → triplane NeRF.

Port of `comfy3d_tpu/models/triposr/model.py`:

  DINO ViT-B/16 tokenizer (512² image, interpolated position grid)
  → learned triplane tokens [3·32², 1024]
  → 16-layer Transformer1D (16 heads × 64, cross-attention dim 768)
  → ConvTranspose 2× upsample to triplanes [3, 40, 64, 64]
  → NeRFMLP (120 → 64 × 10 SiLU layers → density + rgb)
  with density_act = exp(density − 1) and colour = sigmoid(features).

Submodules carry the public checkpoint's names (`image_tokenizer.model.*`
in HF ViT layout, `tokenizer.embeddings` [3, C, P, P], `backbone.*`,
`post_processor.upsample`, `decoder.layers.{0,2,…}`), so `model.ckpt` loads
with a strict `load_state_dict`. Scene codes are [B, 3, C, H, W] (the JAX
package's are [B, 3, H, W, C]).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..common import Transformer1D, ViT, imagenet_normalize


@dataclasses.dataclass(frozen=True)
class TripoSRConfig:
    cond_image_size: int = 512
    # triplane tokenizer
    plane_size: int = 32
    token_channels: int = 1024
    # backbone
    num_layers: int = 16
    heads: int = 16
    dim_head: int = 64
    cross_attention_dim: int = 768
    # post-processor / decoder
    triplane_channels: int = 40
    mlp_neurons: int = 64
    mlp_hidden_layers: int = 9
    # renderer
    radius: float = 0.87
    density_bias: float = -1.0
    num_samples_per_ray: int = 128
    # ViT
    vit_hidden: int = 768
    vit_layers: int = 12
    vit_heads: int = 12
    vit_mlp_dim: int = 3072
    vit_patch: int = 16
    vit_pretrain_grid: int = 14


class ImageTokenizer(nn.Module):
    """The checkpoint's `image_tokenizer`: a ViT under `.model`."""

    def __init__(self, cfg: TripoSRConfig):
        super().__init__()
        self.model = ViT(hidden=cfg.vit_hidden, layers=cfg.vit_layers,
                         heads=cfg.vit_heads, mlp_dim=cfg.vit_mlp_dim,
                         patch=cfg.vit_patch,
                         pretrain_grid=cfg.vit_pretrain_grid)

    def forward(self, images):
        return self.model(imagenet_normalize(images))


class TriplaneTokenizer(nn.Module):
    """Learned triplane tokens, read as one channel-major sequence
    [B, C, 3·P²] in (plane, row, column) order."""

    def __init__(self, plane_size: int, channels: int):
        super().__init__()
        self.embeddings = nn.Parameter(
            torch.zeros(3, channels, plane_size, plane_size))

    def forward(self, batch: int):
        e = self.embeddings
        seq = e.transpose(0, 1).reshape(e.shape[1], -1)
        return seq.expand(batch, -1, -1)

    def detokenize(self, tokens):
        """[B, C, 3·P²] → [B, 3, C, P, P]."""
        b, c, _ = tokens.shape
        p = self.embeddings.shape[-1]
        return tokens.reshape(b, c, 3, p, p).transpose(1, 2)


class TriplaneUpsample(nn.Module):
    """ConvTranspose2d(k=2, s=2) on each plane."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.upsample = nn.ConvTranspose2d(in_channels, out_channels, 2,
                                           stride=2)

    def forward(self, planes):                   # [B, 3, C, H, W]
        b, n, c, h, w = planes.shape
        x = self.upsample(planes.reshape(b * n, c, h, w))
        return x.reshape(b, n, *x.shape[1:])


class NeRFMLP(nn.Module):
    """(hidden_layers + 1)-layer SiLU MLP → (density [N], features [N, 3])."""

    def __init__(self, in_channels: int, neurons: int, hidden_layers: int):
        super().__init__()
        layers = [nn.Linear(in_channels, neurons), nn.SiLU()]
        for _ in range(hidden_layers - 1):
            layers += [nn.Linear(neurons, neurons), nn.SiLU()]
        layers.append(nn.Linear(neurons, 4))
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        out = self.layers(x)
        return out[..., 0], out[..., 1:]


def grid_sample_2d(plane, uv):
    """Bilinear sample with zero padding outside the plane, torch
    `grid_sample(align_corners=False)` semantics, as the JAX function
    computes it. plane [C, H, W]; uv [..., 2] in [-1, 1], uv[..., 0] = x
    indexes W. Returns [..., C]. Differentiable."""
    out = F.grid_sample(plane[None], uv.reshape(1, 1, -1, 2), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out[0, :, 0].t().reshape(uv.shape[:-1] + (plane.shape[0],))


class TripoSR(nn.Module):
    """`forward`: images [B, 3, H, W] in [0, 1] → scene codes
    [B, 3, C, 2P, 2P]; `query`: one scene's triplanes + points → field."""

    def __init__(self, cfg: TripoSRConfig = TripoSRConfig()):
        super().__init__()
        self.cfg = cfg
        self.image_tokenizer = ImageTokenizer(cfg)
        self.tokenizer = TriplaneTokenizer(cfg.plane_size, cfg.token_channels)
        self.backbone = Transformer1D(
            in_channels=cfg.token_channels, num_layers=cfg.num_layers,
            heads=cfg.heads, dim_head=cfg.dim_head,
            cross_attention_dim=cfg.cross_attention_dim)
        self.post_processor = TriplaneUpsample(cfg.token_channels,
                                               cfg.triplane_channels)
        self.decoder = NeRFMLP(3 * cfg.triplane_channels, cfg.mlp_neurons,
                               cfg.mlp_hidden_layers)

    def forward(self, images):
        tok = self.image_tokenizer(images)                # [B, T, 768]
        seq = self.backbone(self.tokenizer(images.shape[0]), context=tok)
        return self.post_processor(self.tokenizer.detokenize(seq))

    def query(self, triplanes, positions):
        """triplanes [3, C, H, W] (one scene); positions [N, 3] in world
        units → (sigma [N], rgb [N, 3]). Planes (x,y), (x,z), (y,z), no
        clip: the sample is zero outside [-1, 1]."""
        c = self.cfg
        p = positions / c.radius
        feat = torch.cat([grid_sample_2d(triplanes[0], p[:, [0, 1]]),
                          grid_sample_2d(triplanes[1], p[:, [0, 2]]),
                          grid_sample_2d(triplanes[2], p[:, [1, 2]])], -1)
        density, features = self.decoder(feat)
        return torch.exp(density + c.density_bias), torch.sigmoid(features)
