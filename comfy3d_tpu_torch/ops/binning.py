"""Coarse (bin|depth) key sort: the front half of the 3DGS bin compositor.

Port of `comfy3d_tpu/ops/binning.py::bin_coarse`. One key per (primitive,
bin-slot): `bin_id << depth_bits | f32_bits(depth) >> bin_bits`. Positive
IEEE floats are order-isomorphic to their bit patterns, so one sort gives
every bin's pairs as a contiguous, front-to-back segment.

Differences from the JAX function, none of them in what it returns:
  * keys are built in int64 (the u32 key values, sentinel 0xFFFFFFFF),
    since `torch.sort` on uint32 is not supported on every CUDA build;
  * `bounds` comes from `torch.searchsorted` on the sorted keys;
  * the sort is unstable, as in JAX, so pairs whose truncated depth keys
    are equal may come out of a bin in another order.
"""

from __future__ import annotations

import torch

TILE = 16  # shading tile (pixels)
BIN = 32   # default coarse-bin size (pixels) for the flat compositor

_SENTINEL = 0xFFFFFFFF


def num_bins(height: int, width: int, bin_px: int = BIN) -> tuple[int, int]:
    return -(-height // bin_px), -(-width // bin_px)


def bin_coarse(means2d: torch.Tensor, depth: torch.Tensor,
               radii: torch.Tensor, active: torch.Tensor,
               nbins_y: int, nbins_x: int, k: int = 4, bin_px: int = BIN):
    """Returns (sorted_prim [N*k] int64, bounds [nbins+1] int32,
    overflow [] bool).

    Bin t's depth-ordered segment is sorted_prim[bounds[t]:bounds[t+1]].
    Overflow is set when a primitive's bin footprint exceeds `k` slots."""
    n = means2d.shape[0]
    dev = means2d.device
    nbins = nbins_y * nbins_x
    bin_bits = (nbins + 1).bit_length()
    depth_bits = 32 - bin_bits
    if nbins >= (1 << bin_bits) - 1:
        raise ValueError(f"{nbins} bins do not fit the key")

    r = torch.clamp_min(radii, 0.0)
    inv = 1.0 / bin_px
    mx, my = means2d[:, 0], means2d[:, 1]
    bx0 = torch.clamp(torch.floor((mx - r) * inv), 0, nbins_x - 1).long()
    by0 = torch.clamp(torch.floor((my - r) * inv), 0, nbins_y - 1).long()
    bx1 = torch.clamp(torch.floor((mx + r) * inv), 0, nbins_x - 1).long()
    by1 = torch.clamp(torch.floor((my + r) * inv), 0, nbins_y - 1).long()
    offscreen = ((mx + r < 0) | (my + r < 0)
                 | (mx - r >= nbins_x * bin_px)
                 | (my - r >= nbins_y * bin_px))
    act = active & ~offscreen & (radii > 0)

    w = bx1 - bx0 + 1
    h = by1 - by0 + 1
    footprint = w * h
    overflow = torch.any(act & (footprint > k))
    kk = torch.where(act, torch.clamp_max(footprint, k),
                     torch.zeros_like(footprint))

    j = torch.arange(k, device=dev)[None, :]
    valid = j < kk[:, None]
    w_safe = torch.clamp_min(w, 1)[:, None]
    row = torch.div(j, w_safe, rounding_mode="floor")
    col = j - row * w_safe
    bin_id = (by0[:, None] + row) * nbins_x + bx0[:, None] + col

    # positive-f32 bits are order-isomorphic to the float values
    dbits = torch.clamp_min(depth, 1e-12).contiguous().view(torch.int32)
    dq = dbits.long() >> (32 - depth_bits)
    keys = (bin_id << depth_bits) | dq[:, None]
    keys = torch.where(valid, keys, torch.full_like(keys, _SENTINEL))
    skeys, order = torch.sort(keys.reshape(-1))
    sprim = torch.div(order, k, rounding_mode="floor")
    probe = torch.arange(nbins + 1, device=dev, dtype=torch.int64) \
        << depth_bits
    bounds = torch.searchsorted(skeys, probe, side="left").to(torch.int32)
    return sprim, bounds, overflow
