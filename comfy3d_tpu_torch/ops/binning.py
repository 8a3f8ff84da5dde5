"""Screen-space binning: the front half of the 3DGS compositors.

Port of `comfy3d_tpu/ops/binning.py`:

`bin_coarse` (the coarse-bin path). One key per (primitive, bin-slot):
`bin_id << depth_bits | f32_bits(depth) >> bin_bits`. Positive IEEE floats
are order-isomorphic to their bit patterns, so one sort gives every bin's
pairs as a contiguous, front-to-back segment. Differences from the JAX
function, none of them in what it returns:
  * keys are built in int64 (the u32 key values, sentinel 0xFFFFFFFF),
    since `torch.sort` on uint32 is not supported on every CUDA build;
  * `bounds` comes from `torch.searchsorted` on the sorted keys;
  * the sort is unstable, as in JAX, so pairs whose truncated depth keys
    are equal may come out of a bin in another order.

`bin_primitives` (the per-16-px-tile path), with `num_tiles`, `TileBins`,
`tile_pixel_centers` and `tiles_to_image`. One int64 key per (primitive,
tile-slot), `tile << prim_bits | prim`: the keys are unique, so the sort is
exact and each tile's list comes out in ascending primitive index, which
covers both of the JAX function's branches (the packed u32 key and the
stable two-key sort above 32 bits). Each tile's padded list is a gather
from its start in the sorted keys (JAX: a vmapped `dynamic_slice`).
"""

from __future__ import annotations

import dataclasses

import torch

TILE = 16  # shading tile (pixels)
BIN = 32   # default coarse-bin size (pixels) for the flat compositor

_SENTINEL = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class TileBins:
    """Per-tile padded primitive lists."""
    prim_idx: torch.Tensor    # [num_tiles, max_per_tile] int64 (clamped)
    valid: torch.Tensor       # [num_tiles, max_per_tile] bool
    count: torch.Tensor       # [num_tiles] int32 (pre-truncation count)
    overflow: torch.Tensor    # [] bool — any footprint/tile truncation


def num_tiles(height: int, width: int) -> tuple[int, int]:
    return -(-height // TILE), -(-width // TILE)


def bin_primitives(bbox_min: torch.Tensor, bbox_max: torch.Tensor,
                   active: torch.Tensor, grid_h: int, grid_w: int,
                   max_per_tile: int | None,
                   max_tiles_per_prim: int = 16
                   ) -> TileBins:
    """Bin primitives into 16-px screen tiles.

    bbox_min / bbox_max: [N, 2] pixel-space (x, y) bounds per primitive;
    active: [N] bool, culled primitives produce no pairs. A primitive's
    footprint is its clipped tile rectangle, cut to the first
    `max_tiles_per_prim` tiles in row-major order; each tile keeps the
    first `max_per_tile` of its primitives (None: every one, the lists as
    long as the longest). Either cut sets `overflow`.
    Within a tile the list is in ascending primitive index (pre-sort the
    primitives if that order matters); invalid slots hold index 0, and
    `count` is the count before truncation.
    """
    n = bbox_min.shape[0]
    dev = bbox_min.device
    ntiles = grid_h * grid_w
    prim_bits = max(n - 1, 1).bit_length()
    if (ntiles << prim_bits) >= 1 << 62:
        raise ValueError(f"{ntiles} tiles × {n} primitives do not fit the "
                         f"int64 key")

    def tile_of(x, hi):
        return torch.clamp(torch.floor(x / TILE), 0, hi - 1).long()

    tx0, ty0 = tile_of(bbox_min[:, 0], grid_w), tile_of(bbox_min[:, 1], grid_h)
    tx1, ty1 = tile_of(bbox_max[:, 0], grid_w), tile_of(bbox_max[:, 1], grid_h)
    offscreen = ((bbox_max[:, 0] < 0) | (bbox_max[:, 1] < 0)
                 | (bbox_min[:, 0] >= grid_w * TILE)
                 | (bbox_min[:, 1] >= grid_h * TILE))
    active = active & ~offscreen

    w = tx1 - tx0 + 1
    h = ty1 - ty0 + 1
    footprint = w * h
    prim_overflow = active & (footprint > max_tiles_per_prim)
    k = torch.where(active, torch.clamp_max(footprint, max_tiles_per_prim),
                    torch.zeros_like(footprint))

    # dense [N, K] keys; the sentinel (above every tile's keys) for unused
    # slots sorts to the end and masks to primitive 0
    j = torch.arange(max_tiles_per_prim, device=dev)[None, :]
    valid = j < k[:, None]
    w_safe = torch.clamp_min(w, 1)[:, None]
    row = torch.div(j, w_safe, rounding_mode="floor")
    tile = (ty0[:, None] + row) * grid_w + tx0[:, None] + (j - row * w_safe)
    prims = torch.arange(n, device=dev)[:, None]
    keys = torch.where(valid, (tile << prim_bits) | prims,
                       torch.full_like(tile, ntiles << prim_bits))
    skeys, _ = torch.sort(keys.reshape(-1))
    sorted_prims = skeys & ((1 << prim_bits) - 1)

    # per-tile ranges: search the sorted keys at tile boundaries
    probe = torch.arange(ntiles + 1, device=dev, dtype=torch.int64) \
        << prim_bits
    bounds = torch.searchsorted(skeys, probe, side="left")
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    if max_per_tile is None:
        max_per_tile = max(int(counts.max()), 1) if ntiles else 1

    # each tile's padded list: a gather from its start (zero padding keeps
    # every read in bounds)
    padded = torch.cat([sorted_prims, sorted_prims.new_zeros(max_per_tile)])
    slot = torch.arange(max_per_tile, device=dev)
    rows = padded[starts[:, None] + slot[None, :]]
    out_valid = slot[None, :] < torch.clamp_max(counts, max_per_tile)[:, None]
    prim_idx = torch.where(out_valid, torch.clamp_max(rows, n - 1),
                           torch.zeros_like(rows))
    overflow = torch.any(prim_overflow) | torch.any(counts > max_per_tile)
    return TileBins(prim_idx=prim_idx, valid=out_valid,
                    count=counts.to(torch.int32), overflow=overflow)


def tile_pixel_centers(grid_h: int, grid_w: int,
                       device=None) -> torch.Tensor:
    """[num_tiles, TILE*TILE, 2] pixel-center coordinates per tile."""
    ty, tx = torch.meshgrid(torch.arange(grid_h, device=device),
                            torch.arange(grid_w, device=device),
                            indexing="ij")
    py, px = torch.meshgrid(
        torch.arange(TILE, dtype=torch.float32, device=device),
        torch.arange(TILE, dtype=torch.float32, device=device),
        indexing="ij")
    cx = (tx.reshape(-1, 1) * TILE + px.reshape(-1)[None, :]) + 0.5
    cy = (ty.reshape(-1, 1) * TILE + py.reshape(-1)[None, :]) + 0.5
    return torch.stack([cx, cy], dim=-1).to(torch.float32)


def tiles_to_image(tile_vals: torch.Tensor, grid_h: int, grid_w: int,
                   height: int, width: int) -> torch.Tensor:
    """[num_tiles, TILE*TILE, C] (or [num_tiles, TILE*TILE]) → [H, W, C]."""
    squeeze = tile_vals.dim() == 2
    if squeeze:
        tile_vals = tile_vals[..., None]
    c = tile_vals.shape[-1]
    img = tile_vals.reshape(grid_h, grid_w, TILE, TILE, c)
    img = img.permute(0, 2, 1, 3, 4).reshape(grid_h * TILE, grid_w * TILE, c)
    img = img[:height, :width]
    return img[..., 0] if squeeze else img


def num_bins(height: int, width: int, bin_px: int = BIN) -> tuple[int, int]:
    return -(-height // bin_px), -(-width // bin_px)


def coarse_footprint(means2d: torch.Tensor, radii: torch.Tensor,
                     active: torch.Tensor, nbins_y: int, nbins_x: int,
                     bin_px: int = BIN):
    """Each primitive's box of bins for `bin_coarse`: (bx0, by0, w, h)
    int64 [N], the box's first bin column and row and its width and height
    in bins, and `act` bool [N], the primitives that are binned at all
    (active, on screen, radius > 0). A primitive overflows where
    act & (w·h > k)."""
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
    return bx0, by0, bx1 - bx0 + 1, by1 - by0 + 1, act


def bin_coarse(means2d: torch.Tensor, depth: torch.Tensor,
               radii: torch.Tensor, active: torch.Tensor,
               nbins_y: int, nbins_x: int, k: int = 4, bin_px: int = BIN):
    """Returns (sorted_prim [N*k] int64, bounds [nbins+1] int32,
    overflow [] bool).

    Bin t's depth-ordered segment is sorted_prim[bounds[t]:bounds[t+1]].
    Overflow is set when a primitive's bin footprint exceeds `k` slots."""
    dev = means2d.device
    nbins = nbins_y * nbins_x
    bin_bits = (nbins + 1).bit_length()
    depth_bits = 32 - bin_bits
    if nbins >= (1 << bin_bits) - 1:
        raise ValueError(f"{nbins} bins do not fit the key")

    bx0, by0, w, h, act = coarse_footprint(means2d, radii, active, nbins_y,
                                           nbins_x, bin_px)
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
