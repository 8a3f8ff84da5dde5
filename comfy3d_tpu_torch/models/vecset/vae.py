"""ShapeVAE: latent set → occupancy field → mesh.

Port of `comfy3d_tpu/models/vecset/vae.py`: `ShapeVAE` (`post_kl`,
`transformer`, `geo_decoder`; `forward` decodes the sampled latents into
the latent set, `query` reads occupancy logits at points), the dense
volume decode, the coarse-to-fine (octree) decode and the surface
extraction.

The decodes take `query_fn(decoded, points [B, M, 3]) → logits [B, M]`
and sweep the points in chunks of `num_chunks` on the latent set's device.
The JAX package's `params` slot is gone (the module holds its weights), and
so is its `mesh=` argument (one card has no device mesh).

The octree decode follows the JAX package where a plainer form would give
other numbers: the coarse-to-fine upsample is a trilinear resize with
half-pixel centres (`align_corners=False`), so fine sample 2i is not coarse
sample i; each level re-queries a fixed top-K of cells by nearest-corner
|logit|, taken with a stable sort so that equal values keep the lower cell
index, as `jax.lax.top_k` does (neighbouring cells that share their nearest
corner tie exactly); the dense grid's points come from a float32 linspace
and the refined points from index·step − bounds in float32, which differ
in the last bits.

Each decode runs under a `torch.profiler.record_function` span: the dense
grid under "vecset.decode_volume", octree level l under
"vecset.decode_level{l}".
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from .blocks import CrossAttentionDecoder, FourierConfig, VecTransformer


@dataclasses.dataclass(frozen=True)
class ShapeVAEConfig:
    num_latents: int = 3072
    embed_dim: int = 64
    width: int = 1024
    heads: int = 16
    num_decoder_layers: int = 16
    geo_decoder_downsample_ratio: int = 1
    geo_decoder_mlp_expand_ratio: int = 4
    geo_decoder_ln_post: bool = True
    num_freqs: int = 8
    include_pi: bool = True
    qkv_bias: bool = True
    qk_norm: bool = False
    scale_factor: float = 1.0188137142395404     # hunyuan3d-vae-v2-0


class ShapeVAE(nn.Module):
    def __init__(self, cfg: ShapeVAEConfig = ShapeVAEConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.post_kl = nn.Linear(c.embed_dim, c.width)
        self.transformer = VecTransformer(c.width, c.num_decoder_layers,
                                          c.heads, c.qkv_bias, c.qk_norm)
        ds = c.geo_decoder_downsample_ratio
        self.geo_decoder = CrossAttentionDecoder(
            width=c.width // ds, heads=c.heads // ds, out_channels=1,
            mlp_expand_ratio=c.geo_decoder_mlp_expand_ratio,
            downsample_ratio=ds, enable_ln_post=c.geo_decoder_ln_post,
            qkv_bias=c.qkv_bias, qk_norm=c.qk_norm,
            fourier=FourierConfig(c.num_freqs, c.include_pi))

    def forward(self, latents):
        """[B, N, embed_dim] sampled latents → [B, N, width] latent set."""
        return self.transformer(self.post_kl(latents))

    def query(self, decoded, points):
        """decoded [B, N, W]; points [B, M, 3] → logits [B, M]."""
        return self.geo_decoder(points, decoded)[..., 0]


def _sweep(query_fn, decoded, pts, num_chunks: int):
    """pts [B, P, 3] → logits [B, P], `num_chunks` points per call."""
    return torch.cat([query_fn(decoded, pts[:, i:i + num_chunks])
                      for i in range(0, pts.shape[1], num_chunks)], dim=1)


def decode_volume(query_fn, decoded, octree_resolution: int = 256,
                  bounds: float = 1.01, num_chunks: int = 65536):
    """Dense occupancy grid [B, R+1, R+1, R+1] over [−bounds, bounds]³ (R+1
    samples per axis, indexing ij)."""
    r = int(octree_resolution) + 1
    lin = torch.as_tensor(np.linspace(-bounds, bounds, r, dtype=np.float32),
                          device=decoded.device)
    pts = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"),
                      dim=-1).reshape(1, -1, 3)
    b = decoded.shape[0]
    with record_function("vecset.decode_volume"):
        logits = _sweep(query_fn, decoded, pts.expand(b, -1, -1), num_chunks)
    return logits.reshape(b, r, r, r)


def _corner_min(g):
    """min |logit| over each cell's 8 corners: [B, R, R, R] of [B, R+1, …]."""
    g = g.abs()
    out = None
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                c = g[:, di:di + g.shape[1] - 1, dj:dj + g.shape[2] - 1,
                      dk:dk + g.shape[3] - 1]
                out = c if out is None else torch.minimum(out, c)
    return out


def decode_volume_hierarchical(query_fn, decoded,
                               octree_resolution: int = 256,
                               coarse_resolution: int = 64,
                               bounds: float = 1.01,
                               num_chunks: int = 65536,
                               band_cells_per_level=None):
    """Coarse-to-fine decode: a dense grid at `coarse_resolution`, then per
    2× level a trilinear upsample in which the K cells whose nearest corner
    is closest to the iso level are queried again (K = min(R³, max(4096,
    14·R²)) per level of R coarse cells, or `band_cells_per_level[level]`).
    Returns [B, R+1, R+1, R+1] like `decode_volume`."""
    r0 = int(coarse_resolution)
    levels = 0
    while r0 << levels < int(octree_resolution):
        levels += 1
    if r0 << levels != int(octree_resolution):
        raise ValueError(f"octree resolution {octree_resolution} is not "
                         f"{r0}·2^k")
    grid = decode_volume(query_fn, decoded, octree_resolution=r0,
                         bounds=bounds,
                         num_chunks=min(num_chunks, (r0 + 1) ** 3))
    b, dev = grid.shape[0], grid.device
    off = torch.arange(3, device=dev)
    oi, oj, ok = (o.reshape(-1) for o in torch.meshgrid(off, off, off,
                                                        indexing="ij"))
    for lvl in range(levels):
        rc = r0 << lvl                       # coarse cells per axis
        rf = rc * 2
        if band_cells_per_level is not None:
            k = int(band_cells_per_level[lvl])
        else:
            k = min(rc ** 3, max(4096, 14 * rc * rc))
        with record_function(f"vecset.decode_level{lvl}"):
            fine = F.interpolate(grid[:, None], size=(rf + 1,) * 3,
                                 mode="trilinear", align_corners=False)[:, 0]
            cm = _corner_min(grid).reshape(b, -1)
            cell = torch.argsort(cm, dim=1, stable=True)[:, :k]
            ci = torch.div(cell, rc * rc, rounding_mode="floor")
            cj = torch.div(cell, rc, rounding_mode="floor") % rc
            ck = cell % rc
            fi = (2 * ci[..., None] + oi).reshape(b, -1)       # [B, K·27]
            fj = (2 * cj[..., None] + oj).reshape(b, -1)
            fk = (2 * ck[..., None] + ok).reshape(b, -1)
            step = 2.0 * bounds / rf
            pts = torch.stack([fi, fj, fk], -1).float() * step - bounds
            vals = _sweep(query_fn, decoded, pts, min(num_chunks, k * 27))
            bidx = torch.arange(b, device=dev)[:, None].expand_as(fi)
            # duplicate indices write equal values (to rounding)
            fine[bidx, fi, fj, fk] = vals
        grid = fine
    return grid


def decode_volume_auto(query_fn, decoded, octree_resolution: int = 256,
                       bounds: float = 1.01, num_chunks: int = 65536,
                       coarse_resolution: int = 64):
    """The octree decode where the resolution is a power-of-2 multiple of
    the coarse grid (the node's 256 from 64), else the dense one."""
    r = int(octree_resolution)
    rc = min(int(coarse_resolution), r)
    ratio = r // rc if rc else 1
    if r > rc and r % rc == 0 and (ratio & (ratio - 1)) == 0:
        return decode_volume_hierarchical(
            query_fn, decoded, octree_resolution=r, coarse_resolution=rc,
            bounds=bounds, num_chunks=num_chunks)
    return decode_volume(query_fn, decoded, octree_resolution=r,
                         bounds=bounds, num_chunks=num_chunks)


def grid_to_mesh(grid, bounds: float = 1.01, mc_level: float = 0.0,
                 max_tris: int = 2_000_000):
    """[R, R, R] logits → `Mesh` by marching tets on the grid's device and
    the host weld, over [−bounds, bounds]³; inside where grid > mc_level."""
    from ...ops import tetra
    return tetra.extract_isosurface(grid, iso=float(mc_level),
                                    bounds=(-bounds, bounds),
                                    max_tris=max_tris, on_overflow="retry")
