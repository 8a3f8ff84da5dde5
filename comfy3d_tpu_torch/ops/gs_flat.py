"""Coarse-bin 3DGS compositor, forward and backward: the CUDA kernels'
wrappers and their plain PyTorch versions.

Forward with its pair-row gather. Replaces the TPU kernels
`comfy3d_tpu/ops/pallas/gs_flat.py::_fwd_kernel_merged` (:339, the default)
and `::_fwd_kernel` (:198, `COMFY3D_GS_MERGED=0`), both reached through
`composite_bins_fwd` (:481), and the gather of their pair payload
(`comfy3d_tpu/ops/gs_render.py:601`). The kernel is `csrc/gs_flat_fwd.cu`
(with `csrc/gs_fwd_common.cuh`); both TPU kernels are modes of it; the
wrapper is `composite_bins_fwd_rows`.

What it computes, per coarse bin t (bin_px = 32: 2×2 sub-tiles of 16 px):
walk the bin's depth-sorted pair segment [bounds[t], bounds[t+1]), pair g
holding the splat row `rows[sprim[g]]`, front to back in 128-pair chunks
counted from the segment start rounded down to 128 (the first `skip` slots
are dead), and composite
    α = min(op·exp(min(power, 0)), 0.99), zero where op·G < 1/255 or the
    pair's 3σ square misses the 16-px sub-tile;
    acc += chan·α·T,  T *= 1 − α.
Before each chunk, a group whose largest T is below EPS_T stops: the whole
bin in merged mode (sub-tiles whose origin lies outside the image start at
T = 0 and never hold the exit back), each in-image sub-tile in per-sub-tile
mode (out-of-image sub-tiles stay at acc 0, T 1). `stops` counts the chunks
each sub-tile composited; the backward pass re-walks exactly that prefix.
The plain version (`composite_bins_fwd_rows_plain`) gathers the payload
[DPAY, P] as the TPU path does (`gather_payload`) and runs
`composite_bins_fwd_plain`, the TPU kernels' function on it.

What bounds it on the card: operations, not bytes. Each pair-pixel visit
costs ~20 f32 operations and one exp, against a 64-byte row and an index
per pair that every pixel of the sub-tile shares (`chip_smoke.py` counts
both). What the design does about it: one CTA per 16-px sub-tile, one
thread per pixel, the sub-tiles of a bin in one thread-block cluster whose
CTAs vote on the merged exit through distributed shared memory; each CTA
reads its chunk's pair indices and copies the rows with cp.async into a
two-stage ring, compacts the chunk to the pairs whose 3σ square meets its
sub-tile, and skips a pair for a warp whose two pixel rows miss the pair's
conservative box (`gs_tile.splat_box`), so dead visits cost no exp.

Backward with its per-splat scatter. Replaces
`comfy3d_tpu/ops/pallas/gs_flat.py::_bwd_kernel` (:552, reached through
`composite_bins_bwd` :730) and the XLA scatter after it
(`comfy3d_tpu/ops/gs_render.py:641-644`). The kernel is
`csrc/gs_flat_bwd.cu`. Per in-image sub-tile it walks the composited prefix
(chunks below `stops`) back to front, rebuilding T in log space from the
forward's final T (floored at e^-80: within the last chunk T can underflow
to 0) and carrying S = Σ_later chan·g_acc·α·T, sums each pair's gradient
(d μx, d μy, d conic a, b, c, d opacity, d chan_0..C-1) over the
sub-tile's pixels and adds it into the pair's splat row `sprim[g]` of
g [n, 6 + C]. The visit decisions (footprint bit, α ≥ 1/255, α < 0.99,
power ≤ 0) are re-derived with the forward's operations, so they equal the
forward's. Bounded by operations as the forward is (~75 per live visit);
one CTA per 16-px sub-tile, one thread per pixel, each chunk compacted to
the sub-tile's footprint pairs and walked in 16-pair sub-chunks, pixel-major
(phase A, per-(pair, pixel) scalars into shared memory) and then slot-major
(phase B, one half-warp lane per pair), each pair's sums added into its
splat's row with atomics. The plain version
(`composite_bins_bwd_splats_plain`) is the per-pair plain function
`composite_bins_bwd_plain`, which keeps the TPU kernel's per-pair columns
[DG, P] and is held against it, followed by one `index_add_` of the walked
pairs.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from . import _build

TILE = 16                  # shading tile (pixels)
NPIX = TILE * TILE
DEFAULT_BIN = 32           # coarse bin size (pixels); 32, 48 or 64
CHUNK = 128                # pairs per compositing step
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
EPS_T = 1.0e-3             # saturation threshold on a group's largest T
LOG_FLOOR = -80.0          # floor of the backward's log T
MAX_CHAN = 6               # channels the kernels are instantiated for


def merged_default() -> bool:
    """The mode `merged=None` selects: `COMFY3D_GS_MERGED` (default "1"), as
    the JAX package reads it."""
    return os.environ.get("COMFY3D_GS_MERGED", "1") == "1"


def grad_rows(nchan: int) -> int:
    """DG, the backward's output rows: 6 + nchan, padded to a multiple of 8."""
    return -(-(6 + nchan) // 8) * 8


def _lib(name):
    lib = _build.load(name)
    if not getattr(lib, "_argtypes_set", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = getattr(lib, name)
        fn.argtypes = {
            # rows, n_rows, d, sprim, nsprim, bounds, nbins, nbins_x, nchan,
            # sub_n, width, height, merged, acc, trans, stops, stream
            "gs_flat_fwd": [vp, i64, i32, vp, i64, vp] + [i32] * 7
            + [vp] * 4,
            # data, ppad, dpay, bounds, sprim, nsprim, trans, stops, g_acc,
            # g_trans, nbins, nbins_x, nchan, sub_n, width, height, n_rows,
            # g, stream
            "gs_flat_bwd": [vp, i64, i32, vp, vp, i64] + [vp] * 4
            + [i32] * 6 + [i64, vp, vp],
        }[name]
        fn.restype = i32
        err = getattr(lib, name + "_error_string")
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _raise_on(err, lib, name):
    if err != 0:
        msg = getattr(lib, name + "_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def _check(data, bounds, nbins_x, nbins_y, nchan, bin_px):
    if data.dtype != torch.float32 or data.dim() != 2:
        raise ValueError(f"data must be a 2-D float32 tensor [DPAY, P], got "
                         f"{data.dtype} {tuple(data.shape)}")
    if not 1 <= nchan <= MAX_CHAN or data.shape[0] < 7 + nchan:
        raise ValueError(f"nchan {nchan} needs 1..{MAX_CHAN} channels and "
                         f"≥ {7 + nchan} payload rows, data has "
                         f"{data.shape[0]}")
    if bin_px not in (32, 48, 64):
        raise ValueError(f"bin_px must be 32, 48 or 64, got {bin_px}")
    nbins = nbins_x * nbins_y
    if bounds.dtype != torch.int32 or tuple(bounds.shape) != (nbins + 1,):
        raise ValueError(f"bounds must be int32 [{nbins + 1}], got "
                         f"{bounds.dtype} {tuple(bounds.shape)}")
    if bounds.device != data.device:
        raise ValueError(f"bounds on {bounds.device}, data on {data.device}")


def _check_bwd(data, trans, stops, g_acc, g_trans, nbins, nchan, bin_px):
    nsub = (bin_px // TILE) ** 2
    want = {"trans": (trans, torch.float32, (nbins, nsub, 1, NPIX)),
            "stops": (stops, torch.int32, (nbins, nsub)),
            "g_acc": (g_acc, torch.float32, (nbins, nsub, nchan, NPIX)),
            "g_trans": (g_trans, torch.float32, (nbins, nsub, 1, NPIX))}
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != data.device:
            raise ValueError(f"{name} on {x.device}, data on {data.device}")


def _check_pairs(data, sprim, n):
    if sprim.dtype != torch.int64 or sprim.dim() != 1:
        raise ValueError(f"sprim must be a 1-D int64 tensor, got "
                         f"{sprim.dtype} {tuple(sprim.shape)}")
    if sprim.device != data.device:
        raise ValueError(f"sprim on {sprim.device}, data on {data.device}")
    if not 0 <= n < 2 ** 31:
        raise ValueError(f"n (splats) must be in 0..2^31-1, got {n}")


def payload_width(nchan: int) -> int:
    """DPAY, the width of the pair rows and of the payload: 7 + nchan
    values padded to a multiple of 8."""
    return -(-(7 + nchan) // 8) * 8


def _check_rows(rows, sprim, bounds, nbins_x, nbins_y, nchan, bin_px):
    if rows.dtype != torch.float32 or rows.dim() != 2:
        raise ValueError(f"rows must be a 2-D float32 tensor [N, DPAY], got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if not 1 <= nchan <= MAX_CHAN or rows.shape[1] != payload_width(nchan):
        raise ValueError(f"nchan {nchan} needs 1..{MAX_CHAN} channels and "
                         f"rows {payload_width(nchan)} wide, rows are "
                         f"{rows.shape[1]}")
    _check_pairs(rows, sprim, rows.shape[0])
    if bin_px not in (32, 48, 64):
        raise ValueError(f"bin_px must be 32, 48 or 64, got {bin_px}")
    nbins = nbins_x * nbins_y
    if bounds.dtype != torch.int32 or tuple(bounds.shape) != (nbins + 1,):
        raise ValueError(f"bounds must be int32 [{nbins + 1}], got "
                         f"{bounds.dtype} {tuple(bounds.shape)}")
    if bounds.device != rows.device:
        raise ValueError(f"bounds on {bounds.device}, rows on {rows.device}")


def composite_bins_fwd_rows(rows, sprim, bounds, nbins_x: int, nbins_y: int,
                            nchan: int, width: int, height: int,
                            bin_px: int = DEFAULT_BIN,
                            merged: bool | None = None):
    """rows [N, DPAY] f32 (per splat: μx, μy, conic a, b, c, opacity, nchan
    channels, 3σ radius, zero pad; DPAY = `payload_width(nchan)`); sprim
    [≥ P] i64, the splat of each pair in sorted order; bounds [nbins+1]
    i32, each bin's pair segment.

    Returns (acc [nbins, NSUB, C, 256], trans [nbins, NSUB, 1, 256],
    stops [nbins, NSUB] i32). On a CUDA tensor it launches the kernel,
    which reads the rows by index (indices outside [0, N) read as a zero
    row), or raises (a refused launch raises too); on a CPU tensor it runs
    `composite_bins_fwd_rows_plain`; any other device raises."""
    if merged is None:
        merged = merged_default()
    _check_rows(rows, sprim, bounds, nbins_x, nbins_y, nchan, bin_px)
    if rows.device.type == "cpu":
        return composite_bins_fwd_rows_plain(rows, sprim, bounds, nbins_x,
                                             nbins_y, nchan, width, height,
                                             bin_px, merged)
    if rows.device.type != "cuda":
        raise ValueError(f"composite_bins_fwd_rows runs on cuda (kernel) or "
                         f"cpu (plain version), not {rows.device}")
    if not all(x.is_contiguous() for x in (rows, sprim, bounds)):
        raise ValueError("composite_bins_fwd_rows needs contiguous inputs")
    if rows.data_ptr() % 16 != 0:
        raise ValueError("rows must be 16-byte aligned")
    nbins = nbins_x * nbins_y
    nsub = (bin_px // TILE) ** 2
    dev = rows.device
    acc = torch.empty((nbins, nsub, nchan, NPIX), dtype=torch.float32,
                      device=dev)
    trans = torch.empty((nbins, nsub, 1, NPIX), dtype=torch.float32,
                        device=dev)
    stops = torch.empty((nbins, nsub), dtype=torch.int32, device=dev)
    if rows.shape[0] == 0:
        raise ValueError("composite_bins_fwd_rows needs at least one row")
    lib = _lib("gs_flat_fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gs_flat_fwd(rows.data_ptr(), rows.shape[0], rows.shape[1],
                              sprim.data_ptr(), sprim.numel(),
                              bounds.data_ptr(), nbins, nbins_x, nchan,
                              bin_px // TILE, width, height, int(merged),
                              acc.data_ptr(), trans.data_ptr(),
                              stops.data_ptr(), stream)
    _raise_on(err, lib, "gs_flat_fwd")
    composite_bins_fwd_rows.launches += 1
    return acc, trans, stops


composite_bins_fwd_rows.launches = 0     # kernel launches since the last reset


def composite_bins_bwd_splats(data, bounds, sprim, n: int, trans, stops,
                              g_acc, g_trans, nbins_x: int, nbins_y: int,
                              nchan: int, width: int, height: int,
                              bin_px: int = DEFAULT_BIN):
    """Backward of `composite_bins_fwd_rows` with its per-splat scatter,
    on the payload `gather_payload` builds (`data`):
    `trans`/`stops` are its outputs, `g_acc`/`g_trans` the cotangents of
    acc/trans, `sprim` [≥ P] i64 the splat (of n) of each pair.

    Returns g [n, 6 + C] f32, one row per splat: d μx, d μy, d a, d b, d c,
    d op, d chan_0..C-1, summed over the splat's pairs that a sub-tile
    walked. On a CUDA tensor it launches the kernel (the atomics' order
    varies, so the rows vary in their last bits); on a CPU tensor it runs
    `composite_bins_bwd_splats_plain`; any other device raises."""
    _check(data, bounds, nbins_x, nbins_y, nchan, bin_px)
    nbins = nbins_x * nbins_y
    _check_bwd(data, trans, stops, g_acc, g_trans, nbins, nchan, bin_px)
    _check_pairs(data, sprim, n)
    if data.device.type == "cpu":
        return composite_bins_bwd_splats_plain(
            data, bounds, sprim, n, trans, stops, g_acc, g_trans, nbins_x,
            nbins_y, nchan, width, height, bin_px)
    if data.device.type != "cuda":
        raise ValueError(f"composite_bins_bwd_splats runs on cuda (kernel) "
                         f"or cpu (plain version), not {data.device}")
    ins = (data, bounds, sprim, trans, stops, g_acc, g_trans)
    if not all(x.is_contiguous() for x in ins):
        raise ValueError("composite_bins_bwd_splats needs contiguous inputs")
    g = torch.zeros((n, 6 + nchan), dtype=torch.float32, device=data.device)
    if n == 0:
        return g
    lib = _lib("gs_flat_bwd")
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = lib.gs_flat_bwd(data.data_ptr(), data.shape[1], data.shape[0],
                              bounds.data_ptr(), sprim.data_ptr(),
                              sprim.numel(), trans.data_ptr(),
                              stops.data_ptr(), g_acc.data_ptr(),
                              g_trans.data_ptr(), nbins, nbins_x, nchan,
                              bin_px // TILE, width, height, n, g.data_ptr(),
                              stream)
    _raise_on(err, lib, "gs_flat_bwd")
    composite_bins_bwd_splats.launches += 1
    return g


composite_bins_bwd_splats.launches = 0   # kernel launches since the last reset


# ------------------------------------------------------------------ #
# Plain versions
# ------------------------------------------------------------------ #
def _bin_geometry(bounds, nbins_x, nbins_y, width, height, bin_px, dev):
    """What both plain versions derive from `bounds` and the image size."""
    sub = bin_px // TILE
    nsub = sub * sub
    nbins = nbins_x * nbins_y
    b = bounds.to(torch.int64)
    b0, b1 = b[:-1], b[1:]
    b0_al = torch.div(b0, CHUNK, rounding_mode="floor") * CHUNK
    nch = torch.where(
        b1 > b0, torch.div(b1 - b0_al + CHUNK - 1, CHUNK,
                           rounding_mode="floor"), torch.zeros_like(b0))
    t = torch.arange(nbins, device=dev)
    s = torch.arange(nsub, device=dev)
    bin_x, bin_y = t % nbins_x, torch.div(t, nbins_x, rounding_mode="floor")
    ox = (bin_x[:, None] * sub + s % sub) * TILE
    oy = (bin_y[:, None] * sub + torch.div(s, sub, rounding_mode="floor")) \
        * TILE
    sx0 = ((s % sub) * TILE).to(torch.float32)             # [nsub]
    sy0 = (torch.div(s, sub, rounding_mode="floor") * TILE).to(torch.float32)
    p = torch.arange(NPIX, device=dev)
    return dict(
        nbins=nbins, nsub=nsub, b0=b0, b1=b1, b0_al=b0_al, nch=nch,
        in_img=(ox < width) & (oy < height),               # [nbins, nsub]
        bin_ox=(bin_x * (sub * TILE)).to(torch.float32),
        bin_oy=(bin_y * (sub * TILE)).to(torch.float32),
        sx0=sx0, sy0=sy0,
        # bin-local pixel centres [nsub, NPIX]
        px=(p % TILE).to(torch.float32)[None, :] + (sx0[:, None] + 0.5),
        py=torch.div(p, TILE, rounding_mode="floor").to(torch.float32)
        [None, :] + (sy0[:, None] + 0.5))


def _chunk_visits(data, geo, sel, q, runs, nchan):
    """Chunk q of bins `sel`, in the sub-tiles `runs` [nb, nsub] walks:
    the pairs' columns and every pair-pixel term both plain versions use.
    The power is evaluated with the kernels' operations in their order, so
    on the card both round it identically."""
    ppad = data.shape[1]
    lane = torch.arange(CHUNK, device=data.device)
    g = geo["b0_al"][sel, None] + q * CHUNK + lane         # [nb, CHUNK]
    valid = (g >= geo["b0"][sel, None]) & (g < geo["b1"][sel, None]) \
        & (g < ppad)
    cols = data[:, g.clamp(0, max(ppad - 1, 0))]           # [D, nb, CHUNK]
    mxl = cols[0] - geo["bin_ox"][sel, None]
    myl = cols[1] - geo["bin_oy"][sel, None]
    r = cols[6 + nchan]
    sx0, sy0 = geo["sx0"], geo["sy0"]
    # [nb, CHUNK, nsub]: the pair's 3σ square meets the sub-tile
    ov = (valid[..., None] & runs[:, None, :]
          & (mxl[..., None] + r[..., None] > sx0)
          & (mxl[..., None] - r[..., None] < sx0 + TILE)
          & (myl[..., None] + r[..., None] > sy0)
          & (myl[..., None] - r[..., None] < sy0 + TILE))
    e = (...,) + (None, None)
    dx = geo["px"] - mxl[e]                                # [nb,CHUNK,nsub,NPIX]
    dy = geo["py"] - myl[e]
    a, bb, c, op = cols[2][e], cols[3][e], cols[4][e], cols[5][e]
    power = -0.5 * (a * dx * dx + c * dy * dy) - bb * dx * dy
    G = torch.exp(torch.clamp_max(power, 0.0))
    raw = op * G
    live = (raw >= ALPHA_MIN) & ov[..., None]
    alpha = torch.where(live, torch.clamp_max(raw, ALPHA_MAX),
                        torch.zeros_like(raw))
    return dict(g=g, valid=valid, chans=cols[6:6 + nchan], a=a, b=bb, c=c,
                op=op, dx=dx, dy=dy, power=power, G=G, raw=raw, live=live,
                alpha=alpha)


def gather_payload(rows, sprim):
    """The pair payload [DPAY, P] of rows [N, DPAY]: column g is row
    `sprim[g]`, as the TPU path gathers it (`comfy3d_tpu/ops/
    gs_render.py:601`)."""
    return rows[sprim].t().contiguous()


def composite_bins_fwd_rows_plain(rows, sprim, bounds, nbins_x: int,
                                  nbins_y: int, nchan: int, width: int,
                                  height: int, bin_px: int = DEFAULT_BIN,
                                  merged: bool | None = None):
    """Plain PyTorch version of `composite_bins_fwd_rows` (same contract):
    `gather_payload`, then `composite_bins_fwd_plain`."""
    _check_rows(rows, sprim, bounds, nbins_x, nbins_y, nchan, bin_px)
    return composite_bins_fwd_plain(gather_payload(rows, sprim), bounds,
                                    nbins_x, nbins_y, nchan, width, height,
                                    bin_px, merged)


def composite_bins_fwd_plain(data, bounds, nbins_x: int, nbins_y: int,
                             nchan: int, width: int, height: int,
                             bin_px: int = DEFAULT_BIN,
                             merged: bool | None = None):
    """The TPU kernels' function (`gs_flat.py::composite_bins_fwd`) on a
    gathered payload, in plain PyTorch: data [DPAY, P] f32 (rows μx, μy,
    conic a, b, c, opacity, nchan channels, 3σ radius, zero pad), bounds
    [nbins+1] i32 → (acc [nbins, NSUB, C, 256], trans [nbins, NSUB, 1,
    256], stops [nbins, NSUB] i32).

    Vectorised over bins, a Python loop over the chunk index, `cumprod`
    inside a chunk."""
    if merged is None:
        merged = merged_default()
    _check(data, bounds, nbins_x, nbins_y, nchan, bin_px)
    dev = data.device
    geo = _bin_geometry(bounds, nbins_x, nbins_y, width, height, bin_px, dev)
    nbins, nsub, nch, in_img = (geo["nbins"], geo["nsub"], geo["nch"],
                                geo["in_img"])
    if merged:
        T = in_img.to(torch.float32)[..., None].repeat(1, 1, NPIX)
    else:
        T = torch.ones((nbins, nsub, NPIX), dtype=torch.float32, device=dev)
    acc = torch.zeros((nbins, nsub, nchan, NPIX), dtype=torch.float32,
                      device=dev)
    stops = torch.zeros((nbins, nsub), dtype=torch.int32, device=dev)
    max_chunks = int(nch.max()) if nbins else 0

    for q in range(max_chunks):
        tmax = T.amax(-1)                                  # [nbins, nsub]
        has_chunk = q < nch
        if merged:
            run = ((tmax.amax(-1) >= EPS_T) & has_chunk)[:, None] \
                .expand(nbins, nsub)
        else:
            run = (tmax >= EPS_T) & in_img & has_chunk[:, None]
        sel = run.any(-1).nonzero()[:, 0]
        if sel.numel() == 0:
            break
        runs = run[sel]                                    # [nb, nsub]
        v = _chunk_visits(data, geo, sel, q, runs, nchan)
        alpha = v["alpha"]
        cp = torch.cumprod(1.0 - alpha, dim=1)
        t_excl = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        w = alpha * t_excl
        contrib = torch.einsum("cnk,nksp->nscp", v["chans"], w)
        t_sel = T[sel]
        acc[sel] = acc[sel] + t_sel[:, :, None, :] * contrib
        T[sel] = t_sel * cp[:, -1]
        stops[sel] = torch.where(runs, torch.full_like(stops[sel], q + 1),
                                 stops[sel])

    return acc, T[:, :, None, :], stops


def composite_bins_bwd_splats_plain(data, bounds, sprim, n: int, trans,
                                    stops, g_acc, g_trans, nbins_x: int,
                                    nbins_y: int, nchan: int, width: int,
                                    height: int, bin_px: int = DEFAULT_BIN):
    """Plain PyTorch version of `composite_bins_bwd_splats` (same
    contract): the per-pair columns of `composite_bins_bwd_plain`, then one
    `index_add_` of the pairs that some in-image sub-tile walked (pair g of
    bin t, in chunk q of the bin's walk, below that sub-tile's stop)."""
    _check_pairs(data, sprim, n)
    cols = composite_bins_bwd_plain(data, bounds, trans, stops, g_acc,
                                    g_trans, nbins_x, nbins_y, nchan, width,
                                    height, bin_px)            # [DG, P]
    geo = _bin_geometry(bounds, nbins_x, nbins_y, width, height, bin_px,
                        data.device)
    npair = min(int(geo["b1"][-1]) if geo["nbins"] else 0, sprim.numel(),
                data.shape[1])
    g = torch.arange(npair, device=data.device)
    t = torch.searchsorted(geo["b1"], g, right=True)       # b0[t] ≤ g < b1[t]
    q = torch.div(g - geo["b0_al"][t], CHUNK, rounding_mode="floor")
    last = torch.where(geo["in_img"], stops.to(torch.int64),
                       torch.zeros_like(stops, dtype=torch.int64))
    walked = q < last.amax(-1)[t]
    rows = cols[:6 + nchan, :npair].t()[walked]
    return cols.new_zeros((n, 6 + nchan)).index_add_(0, sprim[:npair][walked],
                                                     rows)


def composite_bins_bwd_plain(data, bounds, trans, stops, g_acc, g_trans,
                             nbins_x: int, nbins_y: int, nchan: int,
                             width: int, height: int,
                             bin_px: int = DEFAULT_BIN):
    """The TPU kernel's function (`gs_flat.py::composite_bins_bwd`), in
    plain PyTorch: per-pair gradient columns [DG, P] f32 (rows d μx, d μy,
    d a, d b, d c, d op, d chan_0..C-1, zero pad); columns of pairs no
    sub-tile walked are 0.

    Vectorised over bins, a Python loop over the chunk index from the last
    walked chunk to the first; inside a chunk, `cumsum` of log(1−α) rebuilds
    each pair's T_i from the chunk's end and `cumsum` of u = chan·g·α·T_i
    gives the later pairs' sum S, as the JAX kernel's prefix sums do."""
    _check(data, bounds, nbins_x, nbins_y, nchan, bin_px)
    nbins = nbins_x * nbins_y
    _check_bwd(data, trans, stops, g_acc, g_trans, nbins, nchan, bin_px)
    dev = data.device
    geo = _bin_geometry(bounds, nbins_x, nbins_y, width, height, bin_px, dev)
    in_img = geo["in_img"]
    out = torch.zeros((grad_rows(nchan), data.shape[1]), dtype=torch.float32,
                      device=dev)
    tfin = trans[:, :, 0, :]                               # [nbins,nsub,NPIX]
    g_t = g_trans[:, :, 0, :]
    log_t = torch.log(torch.clamp_min(tfin, math.exp(LOG_FLOOR)))
    S = torch.zeros_like(log_t)
    walked = torch.where(in_img, stops, torch.zeros_like(stops))
    max_chunks = int(walked.max()) if nbins else 0

    for q in range(max_chunks - 1, -1, -1):
        run = in_img & (q < stops)                         # [nbins, nsub]
        sel = run.any(-1).nonzero()[:, 0]
        v = _chunk_visits(data, geo, sel, q, run[sel], nchan)
        alpha, G, live = v["alpha"], v["G"], v["live"]
        one_m = torch.clamp_min(1.0 - alpha, 1.0 - ALPHA_MAX)
        log_om = torch.log(one_m)                          # 0 off the visits
        lcp = torch.cumsum(log_om, dim=1)
        total_log = lcp[:, -1:]
        lt = log_t[sel]
        t_i = torch.exp(torch.clamp(lt[:, None] + (lcp - log_om) - total_log,
                                    LOG_FLOOR, 0.0))
        gacc = g_acc[sel]                                  # [nb,nsub,C,NPIX]
        colgdot = torch.einsum("cnk,nscp->nksp", v["chans"], gacc)
        wc = alpha * t_i
        u = colgdot * wc
        pu = torch.cumsum(u, dim=1)
        total_u = pu[:, -1:]
        s_k = (total_u - pu) + S[sel][:, None]
        d_alpha = torch.where(
            live & (v["raw"] < ALPHA_MAX),
            colgdot * t_i - s_k / one_m
            - g_t[sel][:, None] * (tfin[sel][:, None] / one_m),
            torch.zeros_like(alpha))
        d_power = torch.where(v["power"] <= 0.0, d_alpha * v["op"] * G,
                              torch.zeros_like(alpha))
        a, b, c, dx, dy = v["a"], v["b"], v["c"], v["dx"], v["dy"]
        rows = [d_power * (a * dx + b * dy), d_power * (c * dy + b * dx),
                -0.5 * d_power * dx * dx, -d_power * dx * dy,
                -0.5 * d_power * dy * dy, d_alpha * G]
        grads = torch.stack([r.sum((2, 3)) for r in rows]
                            + list(torch.einsum("nksp,nscp->cnk", wc, gacc)))
        valid = v["valid"]
        out[:6 + nchan, v["g"][valid]] = grads[:, valid]
        S[sel] = S[sel] + total_u[:, 0]
        log_t[sel] = torch.clamp_min(lt - total_log[:, 0], LOG_FLOOR)

    return out
