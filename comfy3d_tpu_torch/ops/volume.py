"""Dense and coarse-to-fine decodes of a field over a lattice.

Port of `comfy3d_tpu/ops/volume.py`. `query_fn(pts [N, 3]) -> vals [N, ...]`
is any callable on the device's tensors (a closure over the model and its
scene code). The JAX module folds the chunk loop into one jit; here it is a
plain loop over chunks on the device, which bounds memory (a 257³ lattice
holds 17.0 M points).

The hierarchical decode decodes a coarse lattice densely, then at each 2×
level re-queries only a band of the cells nearest the iso value (surface
area scaling: O(R²) of the O(R³) cells); the other vertices keep their
corner-aligned linear upsample.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device


def _f32(x, device):
    return torch.tensor(x, dtype=torch.float32, device=device)


def _linspace(lo: float, hi: float, n: int, device):
    """The JAX package's `jnp.linspace` arithmetic in float32:
    lo·(1 − i/(n−1)) + hi·(i/(n−1)), then hi itself. The divisors here and
    below are tensors: PyTorch's CUDA kernels multiply by the reciprocal
    of a Python-number divisor, which would move the lattice by an ulp
    between the card and the CPU."""
    lo, hi = _f32(lo, device), _f32(hi, device)
    if n == 1:
        return lo[None]
    step = (torch.arange(n - 1, dtype=torch.float32, device=device)
            / _f32(n - 1, device))
    return torch.cat([lo * (1 - step) + hi * step, hi[None]])


def grid_points(resolution: int, bounds, device=None):
    """[R³, 3] float32 lattice over the cube, ij-ordered (x major).
    `bounds` is b (→ [-b, b]) or (lo, hi)."""
    lo, hi = (bounds if isinstance(bounds, (tuple, list))
              else (-bounds, bounds))
    lin = _linspace(lo, hi, resolution, resolve_device(device))
    gx, gy, gz = torch.meshgrid(lin, lin, lin, indexing="ij")
    return torch.stack([gx, gy, gz], -1).reshape(-1, 3)


def query_chunked(query_fn, pts, chunk: int = 1 << 20):
    """query_fn over [N, ...] points, `chunk` points at a time; the output
    keeps query_fn's trailing shape."""
    n = pts.shape[0]
    if n <= chunk:
        return query_fn(pts)
    return torch.cat([query_fn(pts[i:i + chunk])
                      for i in range(0, n, chunk)])


def _upsample2_corner(g):
    """[R]³ → [2R-1]³ corner-aligned linear upsample: even indices copy the
    coarse lattice exactly (fine vertex 2i is coarse vertex i), odd ones
    are midpoints."""
    def up1(x, axis):
        a = x.movedim(axis, 0)
        out = a.new_empty((2 * a.shape[0] - 1,) + a.shape[1:])
        out[::2] = a
        out[1::2] = 0.5 * (a[:-1] + a[1:])
        return out.movedim(0, axis)
    return up1(up1(up1(g, 0), 1), 2)


def _decode_dense(query_fn, resolution: int, bounds: float, chunk: int,
                  device):
    pts = grid_points(resolution, bounds, device)
    return query_chunked(query_fn, pts, chunk).reshape((resolution,) * 3)


def _corner_min(g):
    """Per cell, the least of its 8 corners (the JAX module's order)."""
    m = torch.minimum
    return m(m(m(g[:-1, :-1, :-1], g[1:, :-1, :-1]),
               m(g[:-1, 1:, :-1], g[:-1, :-1, 1:])),
             m(m(g[1:, 1:, :-1], g[1:, :-1, 1:]),
               m(g[:-1, 1:, 1:], g[1:, 1:, 1:])))


def _decode_hier(query_fn, coarse_resolution: int, bounds: float,
                 iso: float, chunk: int, band_cells: tuple, device):
    """Coarse dense lattice, then per level: the `band_cells[level]` cells
    whose corners come nearest `iso` (ties: the lower cell index, as
    `lax.top_k` breaks them) have their 27 fine vertices re-queried. Each
    level doubles the cells (fine vertices 2R-1)."""
    grid = _decode_dense(query_fn, coarse_resolution, bounds, chunk, device)
    b32, iso32 = _f32(bounds, grid.device), _f32(iso, grid.device)
    off = torch.arange(3, device=grid.device)
    oi, oj, ok = (o.reshape(-1) for o in
                  torch.meshgrid(off, off, off, indexing="ij"))
    for k in band_cells:
        rv = grid.shape[0]
        nc = rv - 1
        corner_min = _corner_min((grid - iso32).abs()).reshape(-1)
        cell = torch.sort(corner_min, stable=True).indices[:k]
        ci = cell // (nc * nc)
        cj = (cell // nc) % nc
        ck = cell % nc
        fine = _upsample2_corner(grid)
        rf = 2 * rv - 1
        fi = (2 * ci[:, None] + oi).reshape(-1)
        fj = (2 * cj[:, None] + oj).reshape(-1)
        fk = (2 * ck[:, None] + ok).reshape(-1)
        step = 2.0 * b32 / _f32(rf - 1, grid.device)
        pts = torch.stack([fi, fj, fk], -1).float() * step - b32
        fine[fi, fj, fk] = query_chunked(query_fn, pts, chunk)
        grid = fine
    return grid


_COARSE_CANDIDATES = (65, 49, 33, 25, 17)


def hier_plan(resolution: int, coarse_resolution: int = 65):
    """(coarse_res, levels) with resolution-1 = (coarse-1)·2^levels, or None
    if no candidate chain reaches `resolution` exactly."""
    for rc in (coarse_resolution,) + _COARSE_CANDIDATES:
        nc, n = rc - 1, resolution - 1
        if n > nc and n % nc == 0:
            ratio = n // nc
            if ratio & (ratio - 1) == 0:
                return rc, int(np.log2(ratio))
    return None


def decode_grid(query_fn, resolution: int, bounds: float, iso: float = 0.0,
                chunk: int = 1 << 20, coarse_resolution: int = 65,
                band_mult: float = 3.0, device=None):
    """[R, R, R] decode of query_fn over the cube [-bounds, bounds]³ on
    `device` (default: the card); hierarchical when a coarse chain exists
    (R-1 = (rc-1)·2^L for a candidate rc), dense otherwise.

    band_mult scales each level's band: K = band_mult·n² cells at an
    n³-cell level (at least 4,096, at most every cell). An undersized band
    leaves upsampled (smoother, not wrong-signed) values behind.
    """
    device = resolve_device(device)
    r = int(resolution)
    plan = hier_plan(r, coarse_resolution)
    if plan is None:
        return _decode_dense(query_fn, r, bounds, chunk, device)
    rc, levels = plan
    band = []
    for lvl in range(levels):
        n = (rc - 1) << lvl          # cells at this level
        band.append(int(min(n ** 3, max(4096, band_mult * (2 * n) ** 2))))
    return _decode_hier(query_fn, rc, bounds, iso, chunk, tuple(band),
                        device)
