"""Iso-surface extraction by marching tetrahedra, and the vertex weld.

Port of the parts of `comfy3d_tpu/ops/tetra.py` that the image → mesh path
runs: the 16-case table derived at import (`_build_case_table`), the per-tet
triangles (`_tet_triangles`), active cells → compacted soup
(`_cells_to_tris`), `marching_tets_grid` and `marching_tets_deformed` (the
same sweep over a deformed lattice), `grid_tets`, the host `weld`,
`weld_device` and `extract_isosurface_device` with its capacity doubling,
and `extract_isosurface` (the sweep in blocks on the device, the weld on
the host, under the `record_function` spans of `EXTRACT_SPANS`).

Each cube splits into 6 tets around its 0→6 diagonal; each tet yields 0–2
triangles, oriented away from its inside corners. Arrays are laid out
item-major ([cells, 8, 3], [tets, 4, 3]), the GPU's order, but triangles
are enumerated in the JAX package's order — triangle slot, then tet, then
cell, cells in index order — so the soup, its clip under overflow and the
welded mesh agree with it element by element. Where the JAX package's
compiler fuses a·b + c into one rounding (lattice positions, edge crossing
points), `_fma` rounds once too, on every device.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from torch.profiler import record_function

from .. import resolve_device
from ..core.mesh import Mesh

# `extract_isosurface`'s profiler spans: the sweep (with the soups' copy
# to the host) and the host weld
EXTRACT_SPANS = ("extract_isosurface.sweep", "extract_isosurface.weld")

# cube corners by bit pattern (x, y, z)
_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], np.int64)

# six tets around the 0→6 diagonal: each path 0→a→b→6 over cube edges
_TETS = np.array([
    [0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
    [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6],
], np.int64)

# tet edges by local vertex pair
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64)


def _build_case_table():
    """[16, 2, 3] triangle edge ids (-1 pad) + [16] counts, derived by
    enumerating the inside set of each sign case. Winding is arbitrary here;
    `_tet_triangles` orients each triangle."""
    edge_of = {}
    for e, (a, b) in enumerate(_TET_EDGES):
        edge_of[(a, b)] = e
        edge_of[(b, a)] = e
    table = -np.ones((16, 2, 3), np.int64)
    counts = np.zeros((16,), np.int64)
    for case in range(16):
        inside = [i for i in range(4) if case & (1 << i)]
        outside = [i for i in range(4) if not case & (1 << i)]
        if len(inside) in (0, 4):
            continue
        if len(inside) == 1 or len(inside) == 3:
            a = inside[0] if len(inside) == 1 else outside[0]
            others = [i for i in range(4) if i != a]
            table[case, 0] = [edge_of[(a, o)] for o in others]
            counts[case] = 1
        else:  # 2 inside / 2 outside → quad across 4 crossing edges
            a, b = inside
            c, d = outside
            pac, pad = edge_of[(a, c)], edge_of[(a, d)]
            pbc, pbd = edge_of[(b, c)], edge_of[(b, d)]
            table[case, 0] = [pac, pad, pbd]
            table[case, 1] = [pac, pbd, pbc]
            counts[case] = 2
    return table, counts


_CASE_TABLE, _CASE_COUNTS = _build_case_table()


def _fma(a, b, c):
    """a·b + c in float32 with one rounding: the product of two float32 is
    exact in float64, so only the sum rounds (then to float32)."""
    return (a.double() * b.double() + c.double()).float()


def _cross(a, b):
    """Cross product over the last axis, `jnp.cross`'s formula."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def _tet_triangles(pos, val, inside):
    """Per-tet triangle extraction.

    pos [N, 4, 3] tet corner positions; val [N, 4] field values (signed:
    > 0 inside); inside [N, 4] bool. Returns (tris [N, 2, 3, 3],
    valid [N, 2]). Normals point toward the outside (val < 0) region."""
    dev = pos.device
    case = (inside[:, 0].long() + 2 * inside[:, 1] + 4 * inside[:, 2]
            + 8 * inside[:, 3])                                  # [N]
    ea = torch.as_tensor(_TET_EDGES[:, 0], device=dev)
    eb = torch.as_tensor(_TET_EDGES[:, 1], device=dev)

    # the crossing point on every tet edge (invalid ones masked later)
    va, vb = val[:, ea], val[:, eb]                              # [N, 6]
    denom = va - vb
    t = va / torch.where(denom.abs() < 1e-12, 1e-12, denom)
    t = t.clamp(0.0, 1.0)
    pa, pb = pos[:, ea], pos[:, eb]                              # [N, 6, 3]
    cross_pts = _fma(t[..., None], pb - pa, pa)

    edges = torch.as_tensor(_CASE_TABLE, device=dev)[case]       # [N, 2, 3]
    n = pos.shape[0]
    tris = cross_pts[torch.arange(n, device=dev)[:, None],
                     edges.clamp_min(0).reshape(n, 6)].reshape(n, 2, 3, 3)
    ntri = torch.as_tensor(_CASE_COUNTS, device=dev)[case]
    valid = torch.stack([ntri >= 1, ntri >= 2], 1)               # [N, 2]

    # outward orientation: flip if the normal points toward the centroid of
    # the inside corners
    w_in = inside.float()                                        # [N, 4]
    w = w_in[..., None]
    c_in = ((pos[:, 0] * w[:, 0] + pos[:, 1] * w[:, 1] + pos[:, 2] * w[:, 2]
             + pos[:, 3] * w[:, 3])
            / w_in.sum(1, keepdim=True).clamp_min(1.0))          # [N, 3]
    v0 = tris[:, :, 0]
    n0, n1, n2 = _cross(tris[:, :, 1] - v0, tris[:, :, 2] - v0).unbind(-1)
    d0, d1, d2 = (c_in[:, None] - v0).unbind(-1)                 # [N, 2]
    # summed in one fixed order, so every device decides alike
    flip = n0 * d0 + n1 * d1 + n2 * d2 > 0
    tris = torch.where(flip[..., None, None], tris.flip(2), tris)
    return tris, valid


def _cells_to_tris(pos, val, max_tris: int):
    """Active cells → compacted triangle soup.

    pos [K, 8, 3] cell corner positions; val [K, 8] signed field (> 0
    inside). Returns (soup [max_tris, 3, 3], count, overflow): count is
    min(true count, max_tris), the soup holds the first `count` triangles
    in (slot, tet, cell) order and zeros after them."""
    k = val.shape[0]
    tets = torch.as_tensor(_TETS, device=val.device)
    # tet-major: tet j of cell c is item j·K + c
    tp = pos[:, tets].transpose(0, 1).reshape(6 * k, 4, 3)
    tv = val[:, tets].transpose(0, 1).reshape(6 * k, 4)
    tris, valid = _tet_triangles(tp, tv, tv > 0)
    # slot-major: slot s of item i is s·6K + i
    order = torch.nonzero(valid.t().reshape(-1)).squeeze(1)
    count = order.numel()
    order = order[:max_tris]
    soup = tris.new_zeros((max_tris, 3, 3))
    soup[:order.numel()] = tris[order % (6 * k), order // (6 * k)]
    return soup, min(count, max_tris), count > max_tris


def _active_cells(field, max_tris: int, cell_cap: int | None):
    """The cells of a [X, Y, Z] field whose corners differ in sign (> 0
    inside), in index order, cut at `cell_cap` (default max(4096,
    max_tris // 4), a crossing cell yielding 1-12 triangles, typically ~2;
    clipped to the cell count). Returns (ci, cj, ck, n_active, cell_cap)."""
    ncx, ncy, ncz = (s - 1 for s in field.shape)
    if cell_cap is None:
        cell_cap = max(4096, max_tris // 4)
    cell_cap = min(cell_cap, ncx * ncy * ncz)
    inside = field > 0
    corner = [inside[dx:dx + ncx, dy:dy + ncy, dz:dz + ncz]
              for dx, dy, dz in _CORNERS]
    any_in, all_in = corner[0], corner[0]
    for c in corner[1:]:
        any_in = any_in | c
        all_in = all_in & c
    # the JAX package's `top_k` over the 0/1 mask pads the crossing cells
    # with non-crossing ones, which yield no triangle
    active = torch.nonzero((any_in & ~all_in).reshape(-1)).squeeze(1)
    cell = active[:cell_cap]
    return (cell // (ncy * ncz), (cell // ncz) % ncy, cell % ncz,
            active.numel(), cell_cap)


def marching_tets_grid(grid, iso: float = 0.0, origin=(-1.0, -1.0, -1.0),
                       spacing=None, max_tris: int = 200_000,
                       cell_cap: int | None = None):
    """Iso-surface of a dense [X, Y, Z] field, as a triangle soup.

    `grid` is read relative to `iso`: the surface is where grid == iso,
    inside where grid > iso (density convention; negate an SDF first).
    Returns (soup [max_tris, 3, 3], count, overflow) with count and
    overflow as Python values: overflow when more than `max_tris`
    triangles or more than `cell_cap` crossing cells (the first `cell_cap`
    in index order are swept) were found.
    """
    dev = grid.device
    if spacing is None:
        spacing = 2.0 / (grid.shape[0] - 1)
    spacing = torch.tensor(spacing, dtype=torch.float32, device=dev)
    origin = torch.as_tensor(np.asarray(origin, np.float32), device=dev)
    field = grid - torch.tensor(iso, dtype=torch.float32, device=dev)
    ci, cj, ck, n_active, cell_cap = _active_cells(field, max_tris,
                                                   cell_cap)
    # corners of the active cells, then the tet cases
    val = torch.stack([field[ci + dx, cj + dy, ck + dz]
                       for dx, dy, dz in _CORNERS], 1)           # [K, 8]
    base = torch.stack([ci, cj, ck], 1).float()                  # [K, 3]
    corners = torch.as_tensor(_CORNERS, dtype=torch.float32, device=dev)
    pos = _fma(base[:, None] + corners, spacing, origin)         # [K, 8, 3]

    soup, count, tri_ovf = _cells_to_tris(pos, val, max_tris)
    return soup, count, tri_ovf or n_active > cell_cap


def marching_tets_deformed(v_def, sdf, res: int, max_tris: int = 200_000,
                           cell_cap: int | None = None):
    """Marching tets over a deformed res³ lattice, as a triangle soup.

    v_def [res³, 3] deformed vertex positions (the lattice's topology,
    x-major); sdf [res³] signed field (> 0 inside). The crossing cells are
    those of `marching_tets_grid`, in index order, and their corners are
    gathered from `v_def`. Returns (soup [max_tris, 3, 3], count, overflow)
    with Python count and overflow: overflow when more than `max_tris`
    triangles or more than `cell_cap` crossing cells were found. Gradients
    reach `v_def` and `sdf` through the edge interpolation; the topology is
    not differentiated."""
    ci, cj, ck, n_active, cell_cap = _active_cells(
        sdf.reshape(res, res, res), max_tris, cell_cap)
    vids = torch.stack([((ci + dx) * res + (cj + dy)) * res + (ck + dz)
                        for dx, dy, dz in _CORNERS], 1)          # [K, 8]
    soup, count, tri_ovf = _cells_to_tris(v_def[vids], sdf[vids], max_tris)
    return soup, count, tri_ovf or n_active > cell_cap


def grid_vertices(res: int) -> np.ndarray:
    """[res³, 3] float32 lattice over [-1, 1]³, x-major (numpy)."""
    lin = np.linspace(-1.0, 1.0, res, dtype=np.float32)
    gx, gy, gz = np.meshgrid(lin, lin, lin, indexing="ij")
    return np.stack([gx, gy, gz], -1).reshape(-1, 3)


def grid_tets(res: int):
    """Regular tet decomposition of a res³ vertex grid in [-1, 1]³ →
    (verts [res³, 3], tets [(res-1)³·6, 4] int32), numpy, each cube split
    into `_TETS`."""
    def vid(x, y, z):
        return (x * res + y) * res + z

    ix = np.arange(res - 1)
    cx, cy, cz = np.meshgrid(ix, ix, ix, indexing="ij")
    corner_ids = np.stack([
        vid(cx + _CORNERS[k, 0], cy + _CORNERS[k, 1], cz + _CORNERS[k, 2])
        for k in range(8)], -1).reshape(-1, 8)
    tets = corner_ids[:, _TETS].reshape(-1, 4).astype(np.int32)
    return grid_vertices(res), tets


def weld(tri_soup: np.ndarray, tri_count: int, decimals: int = 6):
    """Host vertex weld: triangle soup → (v [Nv,3], f [Nf,3]).

    Packs the quantized coordinates into one int64 key so the dedup is a
    1-D np.unique; falls back to the row-wise unique only if the quantized
    range cannot fit 63 bits."""
    tris = np.asarray(tri_soup[:tri_count]).reshape(-1, 3)
    if len(tris) == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    q = np.round(tris * (10.0 ** decimals)).astype(np.int64)
    q -= q.min(0)
    spans = q.max(0) + 1
    bits = [int(s).bit_length() for s in spans]
    if sum(bits) <= 63:
        key = ((q[:, 0] << (bits[1] + bits[2]))
               | (q[:, 1] << bits[2]) | q[:, 2])
        uniq, first, inv = np.unique(key, return_index=True,
                                     return_inverse=True)
    else:   # huge coordinate range: row-wise unique (slow, exact)
        keys = np.round(tris, decimals)
        uniq_rows, inv = np.unique(keys, axis=0, return_inverse=True)
        order = np.arange(len(inv))
        first = np.full(len(uniq_rows), len(inv), np.int64)
        np.minimum.at(first, inv, order)
    v = tris[first].astype(np.float32)
    f = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces produced by welding
    keep = ((f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2])
            & (f[:, 0] != f[:, 2]))
    return v, f[keep]


def weld_device(soup, count: int, max_verts: int, decimals: int = 6):
    """Device vertex weld: soup [T, 3, 3] + count → compact mesh.

    Returns (v [max_verts, 3], f [T, 3] int32, nv, nf, overflow), the first
    nv / nf rows valid and zeros after them. Quantizes to 10^-decimals and
    sorts the triples lexicographically, stably (the JAX package's
    `lexsort`), so each vertex is the soup's first point of its run, which
    matches the host `weld`; invalid points carry the int32-max sentinel
    and sort last. On vertex overflow the first `max_verts` - 1 vertices
    and the last one are kept, and faces may index past them."""
    t = soup.shape[0]
    dev = soup.device
    pts = soup.reshape(-1, 3)                                    # [3T, 3]
    valid = torch.arange(3 * t, device=dev) < 3 * int(count)
    q = torch.round(pts * 10.0 ** decimals).to(torch.int32)
    big = 2 ** 31 - 1
    q = torch.where(valid[:, None], q, big).long()
    # lexsort on (q0, q1, q2): a stable sort on the exact int64 key of
    # (q1, q2), then a stable sort on q0
    key12 = q[:, 1] * 2 ** 32 + (q[:, 2] + 2 ** 31)
    order = torch.sort(key12, stable=True).indices
    order = order[torch.sort(q[order, 0], stable=True).indices]
    qs = q[order]
    first = torch.ones(3 * t, dtype=torch.bool, device=dev)
    first[1:] = (qs[1:] != qs[:-1]).any(1)
    first &= qs[:, 0] != big
    vid_sorted = (torch.cumsum(first, 0) - 1).to(torch.int32)
    starts = torch.nonzero(first).squeeze(1)
    nv = starts.numel()

    v_out = pts.new_zeros((max_verts, 3))
    keep = starts[:max_verts]
    if nv > max_verts:
        # the JAX package's clipped scatter leaves the last vertex in the
        # last row
        keep = torch.cat([keep[:-1], starts[-1:]])
    v_out[:keep.numel()] = pts[order[keep]]

    # faces through the inverse permutation of the sort
    inv = torch.empty(3 * t, dtype=torch.int32, device=dev)
    inv[order] = vid_sorted
    f = inv.reshape(t, 3)
    valid_f = ((torch.arange(t, device=dev) < int(count))
               & (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2])
               & (f[:, 0] != f[:, 2]))
    rows = torch.nonzero(valid_f).squeeze(1)
    nf = rows.numel()
    f_out = torch.zeros_like(f)
    f_out[:nf] = f[rows]
    return v_out, f_out, nv, nf, nv > max_verts


def extract_isosurface_device(grid, iso: float = 0.0, bounds=(-1.0, 1.0),
                              max_tris: int = 400_000,
                              on_overflow: str = "retry"):
    """Sweep + weld on the grid's device.

    Returns (v [cap, 3], f [cap, 3], nv, nf): tensors on the grid's device
    (the caller slices; the colours can be queried on v first) and Python
    counts. On overflow, `on_overflow` "retry" doubles the capacity (up to
    8×), "raise" raises, "warn" warns and keeps the clipped mesh."""
    if on_overflow not in ("retry", "raise", "warn"):
        raise ValueError(f"on_overflow must be retry, raise or warn, got "
                         f"{on_overflow!r}")
    r = grid.shape[0]
    spacing = (bounds[1] - bounds[0]) / (r - 1)
    cap = max_tris
    for attempt in range(4):
        last = attempt == 3
        soup, count, overflow = marching_tets_grid(
            grid, iso=iso, origin=(bounds[0],) * 3, spacing=spacing,
            max_tris=cap)
        # check the sweep before welding: the previous attempt's buffers
        # must be free before the doubled capacity allocates
        if overflow:
            if on_overflow == "raise":
                raise RuntimeError(
                    f"marching tets overflow: capacity {cap} hit")
            if on_overflow == "retry" and not last:
                del soup
                cap *= 2
                continue
            warnings.warn(
                f"marching tets overflow: capacity {cap} hit (clipped)")
        v, f, nv, nf, v_ovf = weld_device(soup, count, max_verts=cap)
        del soup
        if not v_ovf:
            return v, f, nv, nf
        if on_overflow == "raise":
            raise RuntimeError(f"weld overflow: vertex capacity {cap} hit")
        if on_overflow != "retry" or last:
            warnings.warn(f"weld overflow: vertex capacity {cap} hit")
            return v, f, min(nv, cap), nf
        del v, f
        cap *= 2
    raise AssertionError("unreachable")


def _soup_to_host(soup, count: int) -> np.ndarray:
    """The first `count` triangles of a soup [cap, 3, 3], sliced on its
    device before the copy, as a host [count, 3, 3] array."""
    if not count:
        return np.zeros((0, 3, 3), np.float32)
    return soup[:count].cpu().numpy()


def extract_isosurface(grid, iso: float = 0.0, bounds=(-1.0, 1.0),
                       max_tris: int = 400_000, max_block: int = 288,
                       on_overflow: str = "retry", device=None):
    """Grid → welded `Mesh`: the sweep on the grid's device, the weld on
    the host.

    `grid` [R, R, R] is a tensor (swept on its own device) or an array
    (swept on `device`, default: the card); inside where grid > iso. Grids
    larger than `max_block` per axis are swept in overlapping y/z blocks
    of `max_block`, then welded into one mesh. On overflow of a block,
    `on_overflow` "retry" sweeps it again with doubled capacity (up to
    8×), "raise" raises, "warn" warns and keeps the clipped soup."""
    if on_overflow not in ("retry", "raise", "warn"):
        raise ValueError(f"on_overflow must be retry, raise or warn, got "
                         f"{on_overflow!r}")
    if not torch.is_tensor(grid):
        grid = torch.as_tensor(np.asarray(grid, np.float32),
                               device=resolve_device(device))
    r = grid.shape[0]
    spacing = (bounds[1] - bounds[0]) / (r - 1)

    def sweep_retry(sub, org, what):
        cap = max_tris
        for attempt in range(4):
            soup, count, overflow = marching_tets_grid(
                sub, iso=iso, origin=org, spacing=spacing, max_tris=cap)
            if not overflow:
                return _soup_to_host(soup, count)
            if on_overflow == "raise":
                raise RuntimeError(
                    f"marching tets overflow: capacity {cap} hit ({what})")
            if on_overflow != "retry" or attempt == 3:
                warnings.warn(
                    f"marching tets overflow: capacity {cap} hit ({what})")
                return _soup_to_host(soup, count)
            del soup
            cap *= 2
        raise AssertionError("unreachable")

    with record_function(EXTRACT_SPANS[0]):
        if r <= max_block:
            allsoup = sweep_retry(grid, (bounds[0],) * 3, "single block")
        else:
            nblocks = -(-(r - 1) // (max_block - 1))
            soups = []
            for bj in range(nblocks):
                y0 = bj * (max_block - 1)
                y1 = min(y0 + max_block, r)
                for bi in range(nblocks):
                    z0 = bi * (max_block - 1)
                    z1 = min(z0 + max_block, r)
                    soups.append(sweep_retry(
                        grid[:, y0:y1, z0:z1].contiguous(),
                        (bounds[0], bounds[0] + y0 * spacing,
                         bounds[0] + z0 * spacing), f"block {bj},{bi}"))
            allsoup = np.concatenate(soups)
    with record_function(EXTRACT_SPANS[1]):
        v, f = weld(allsoup, len(allsoup))
    return Mesh(v=v, f=f)
