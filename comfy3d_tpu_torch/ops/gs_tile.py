"""Per-16-px-tile 3DGS compositor, forward and backward: the CUDA kernels'
wrappers and their plain PyTorch versions.

Forward with its splat-row gather. Replaces the TPU kernel
`comfy3d_tpu/ops/pallas/gs_tile.py::_fwd_kernel` (:92, reached through
`composite_tiles_fwd` :206) and the gather that builds its [T, D, M] block
(`comfy3d_tpu/ops/gs_render.py:445-462`). The kernel is
`csrc/gs_tile_fwd.cu` (with `csrc/gs_fwd_common.cuh`); the wrapper is
`composite_tiles_fwd_rows`.

What it computes, per 16-px tile t: walk the tile's depth-ordered slots
front to back over the first min(counts[t], M), slot j holding the splat
row `rows[prim_idx[t, j]]` (μx, μy, conic a, b, c, opacity, C channels,
zero pad) with its opacity times `valid[t, j]`, in 128-slot chunks, and
composite per pixel
    power = -0.5·(a·mx² + c·my²) - b·mx·my   (mx = μx - px, my = μy - py)
    α = min(op·exp(min(power, 0)), 0.99), zero where power > 0 or
        op·G < 1/255;
    acc += chan·α·T,  T *= 1 − α.
There is no saturation exit: every counted slot is walked. The plain
version (`composite_tiles_fwd_rows_plain`) gathers the block as the TPU
path does (`gather_tile_block`, [T, D, M]) and runs
`composite_tiles_fwd_plain`, which keeps the TPU kernel's arithmetic:
within a chunk the exclusive transmittance is exp of a log-space prefix sum
(Hillis-Steele doubling, as the TPU kernel sums), floored at e^-80; the
chunk's product carries T. The kernel multiplies T sequentially; the two
differ only in rounding, and where T < e^-80, where every term is below
2e-35. On request (`keep_block`, when a backward will follow) both also
return the [T, D, M] block the backward reads.

What bounds it on the card: operations. Each slot-pixel visit costs ~17
f32 operations and one exp, against a 64-byte row and an index per slot
that the tile's 256 pixels share (`chip_smoke.py` counts both on its
input). What the design does about it: one CTA per tile, one thread per
pixel; the CTA reads its slots' indices and copies their rows with
cp.async into a two-stage ring of shared memory, so the next chunk streams
in while this one is walked; each slot gets a conservative box around its
mean (`splat_box` is its Python copy), and a warp whose two pixel rows miss
the box skips the slot with one uniform branch, so dead visits cost no exp.

Backward with its per-splat scatter. Replaces `gs_tile.py::_bwd_kernel`
(:127, reached through `composite_tiles_bwd` :240) and the XLA scatter
after it (`comfy3d_tpu/ops/gs_render.py:534-537`). The kernel is
`csrc/gs_tile_bwd.cu`. Per tile it walks the counted slots back to front,
rebuilding T in log space from log max(T_fin, e^-80) and carrying
S·g = Σ_later chan·g_acc·α·T, sums each slot's gradient (d μx, d μy, d a,
d b, d c, d op, d chan_0..C-1) over the tile's pixels and adds it into
the slot's splat row `prim_idx[t, j]` of g [n, 6 + C]; invalid slots and
slots past the count add nothing. Where T underflows within a chunk the
log rebuild overstates T_i there (ROADMAP §C, shared with the reference and
kept for parity). Bounded by operations as the forward is; one CTA per
tile, one thread per pixel, each 16-slot sub-chunk walked pixel-major
(phase A, per-(slot, pixel) scalars into shared memory) and then summed
slot-major (phase B, one half-warp lane per slot), each slot's sums added
into its splat's row with atomics. The plain version
(`composite_tiles_bwd_splats_plain`) is the per-slot plain function
`composite_tiles_bwd_plain`, which keeps the TPU kernel's per-slot
columns [T, D, M] and is held against it, followed by one `index_add_` of
the valid, walked slots.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

TILE = 16                  # pixels per tile side
NPIX = TILE * TILE
CHUNK = 128                # slots per compositing step
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
LOG_FLOOR = -80.0          # exp(-80) ≈ 1.8e-35: transmittance underflow clamp
MAX_CHAN = 6               # channels the kernels are instantiated for
TILE_BLOCK = 256           # tiles per step of the plain versions


def _lib(name):
    lib = _build.load(name)
    if not getattr(lib, "_argtypes_set", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = getattr(lib, name)
        fn.argtypes = {
            # rows, n_rows, d, prim_idx, valid, counts, ntiles, m, grid_w,
            # nchan, acc, trans, block, stream
            "gs_tile_fwd": [vp, i64, i32] + [vp] * 3 + [i32] * 4 + [vp] * 4,
            # data, counts, prim_idx, valid, trans, g_acc, g_trans, ntiles,
            # d, m, grid_w, nchan, n_rows, g, stream
            "gs_tile_bwd": [vp] * 7 + [i32] * 5 + [i64] + [vp] * 2,
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


def _check(tile_data, counts, grid_w, nchan):
    if tile_data.dtype != torch.float32 or tile_data.dim() != 3:
        raise ValueError(f"tile_data must be a 3-D float32 tensor [T, D, M], "
                         f"got {tile_data.dtype} {tuple(tile_data.shape)}")
    t, d, m = tile_data.shape
    if m % CHUNK != 0 or m == 0:
        raise ValueError(f"max_per_tile {m} must be a positive multiple of "
                         f"{CHUNK}")
    if not 1 <= nchan <= MAX_CHAN or d < 6 + nchan:
        raise ValueError(f"nchan {nchan} needs 1..{MAX_CHAN} channels and "
                         f"≥ {6 + nchan} rows, tile_data has {d}")
    if grid_w <= 0:
        raise ValueError(f"grid_w must be positive, got {grid_w}")
    if counts.dtype != torch.int32 or tuple(counts.shape) != (t,):
        raise ValueError(f"counts must be int32 [{t}], got {counts.dtype} "
                         f"{tuple(counts.shape)}")
    if counts.device != tile_data.device:
        raise ValueError(f"counts on {counts.device}, tile_data on "
                         f"{tile_data.device}")


def _check_bwd(tile_data, trans, g_acc, g_trans, nchan):
    t = tile_data.shape[0]
    want = {"trans": (trans, (t, 1, NPIX)), "g_acc": (g_acc, (t, nchan, NPIX)),
            "g_trans": (g_trans, (t, 1, NPIX))}
    for name, (x, shape) in want.items():
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != tile_data.device:
            raise ValueError(f"{name} on {x.device}, tile_data on "
                             f"{tile_data.device}")


def _check_slots(tile_data, prim_idx, valid, n):
    t, _, m = tile_data.shape
    want = {"prim_idx": (prim_idx, torch.int64), "valid": (valid, torch.bool)}
    for name, (x, dtype) in want.items():
        if x.dtype != dtype or tuple(x.shape) != (t, m):
            raise ValueError(f"{name} must be {dtype} {(t, m)}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != tile_data.device:
            raise ValueError(f"{name} on {x.device}, tile_data on "
                             f"{tile_data.device}")
    if not 0 <= n < 2 ** 31:
        raise ValueError(f"n (splats) must be in 0..2^31-1, got {n}")


def _device_kind(x, fn):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn} runs on cuda (kernel) or cpu (plain "
                         f"version), not {x.device}")
    return x.device.type


def rows_width(nchan: int) -> int:
    """D, the width of the splat rows and of the tile data: 6 + nchan
    values padded to a multiple of 8."""
    return -(-(6 + nchan) // 8) * 8


def _check_rows(rows, prim_idx, valid, counts, grid_w, nchan):
    if rows.dtype != torch.float32 or rows.dim() != 2:
        raise ValueError(f"rows must be a 2-D float32 tensor [N, D], got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if not 1 <= nchan <= MAX_CHAN or rows.shape[1] != rows_width(nchan):
        raise ValueError(f"nchan {nchan} needs 1..{MAX_CHAN} channels and "
                         f"rows {rows_width(nchan)} wide, rows are "
                         f"{rows.shape[1]}")
    if prim_idx.dtype != torch.int64 or prim_idx.dim() != 2:
        raise ValueError(f"prim_idx must be a 2-D int64 tensor [T, M], got "
                         f"{prim_idx.dtype} {tuple(prim_idx.shape)}")
    t, m = prim_idx.shape
    if m % CHUNK != 0 or m == 0:
        raise ValueError(f"max_per_tile {m} must be a positive multiple of "
                         f"{CHUNK}")
    if grid_w <= 0:
        raise ValueError(f"grid_w must be positive, got {grid_w}")
    want = {"valid": (valid, torch.bool, (t, m)),
            "counts": (counts, torch.int32, (t,))}
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    for name, x in (("prim_idx", prim_idx), ("valid", valid),
                    ("counts", counts)):
        if x.device != rows.device:
            raise ValueError(f"{name} on {x.device}, rows on {rows.device}")


def composite_tiles_fwd_rows(rows, prim_idx, valid, counts, grid_w: int,
                             nchan: int, keep_block: bool = False):
    """rows [N, D] f32 (per splat: μx, μy, conic a, b, c, opacity, nchan
    channels, zero pad; D = `rows_width(nchan)`); prim_idx [T, M] i64 and
    valid [T, M] bool (each tile's slots, M a multiple of 128); counts [T]
    i32.

    Returns (acc [T, C, 256], trans [T, 1, 256], block): block is the
    [T, D, M] tile data the backward reads (`gather_tile_block`'s value on
    every slot below each tile's count) when `keep_block`, else None. On a
    CUDA tensor it launches the kernel, which reads the rows by index (its
    block holds zeros from the count to the end of the last walked chunk
    and is not written past it; indices outside [0, N) read as a zero row);
    on a CPU tensor it runs `composite_tiles_fwd_rows_plain`; any other
    device raises."""
    _check_rows(rows, prim_idx, valid, counts, grid_w, nchan)
    if _device_kind(rows, "composite_tiles_fwd_rows") == "cpu":
        return composite_tiles_fwd_rows_plain(rows, prim_idx, valid, counts,
                                              grid_w, nchan, keep_block)
    ins = (rows, prim_idx, valid, counts)
    if not all(x.is_contiguous() for x in ins):
        raise ValueError("composite_tiles_fwd_rows needs contiguous inputs")
    if rows.data_ptr() % 16 != 0:
        raise ValueError("rows must be 16-byte aligned")
    t, m = prim_idx.shape
    n, d = rows.shape
    dev = rows.device
    acc = torch.empty((t, nchan, NPIX), dtype=torch.float32, device=dev)
    trans = torch.empty((t, 1, NPIX), dtype=torch.float32, device=dev)
    block = (torch.empty((t, d, m), dtype=torch.float32, device=dev)
             if keep_block else None)
    if n == 0:
        raise ValueError("composite_tiles_fwd_rows needs at least one row")
    if t == 0:
        return acc, trans, block
    lib = _lib("gs_tile_fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gs_tile_fwd(rows.data_ptr(), n, d, prim_idx.data_ptr(),
                              valid.data_ptr(), counts.data_ptr(), t, m,
                              grid_w, nchan, acc.data_ptr(), trans.data_ptr(),
                              None if block is None else block.data_ptr(),
                              stream)
    _raise_on(err, lib, "gs_tile_fwd")
    composite_tiles_fwd_rows.launches += 1
    return acc, trans, block


composite_tiles_fwd_rows.launches = 0   # kernel launches since the last reset


def composite_tiles_bwd_splats(tile_data, counts, prim_idx, valid, n: int,
                               grid_w: int, trans, g_acc, g_trans,
                               nchan: int):
    """Backward of `composite_tiles_fwd_rows` with its per-splat scatter,
    on the block it returns (`tile_data`):
    `trans` is its output, `g_acc` [T, C, 256] and `g_trans` [T, 1, 256]
    the cotangents of acc and trans; `prim_idx` [T, M] i64 and `valid`
    [T, M] bool say which of the n splats each slot holds.

    Returns g [n, 6 + C] f32, one row per splat: d μx, d μy, d a, d b, d c,
    d op, d chan_0..C-1, summed over the splat's valid slots below each
    tile's count. On a CUDA tensor it launches the kernel (the atomics'
    order varies, so the rows vary in their last bits); on a CPU tensor it
    runs `composite_tiles_bwd_splats_plain`; any other device raises."""
    _check(tile_data, counts, grid_w, nchan)
    _check_bwd(tile_data, trans, g_acc, g_trans, nchan)
    _check_slots(tile_data, prim_idx, valid, n)
    if _device_kind(tile_data, "composite_tiles_bwd_splats") == "cpu":
        return composite_tiles_bwd_splats_plain(
            tile_data, counts, prim_idx, valid, n, grid_w, trans, g_acc,
            g_trans, nchan)
    ins = (tile_data, counts, prim_idx, valid, trans, g_acc, g_trans)
    if not all(x.is_contiguous() for x in ins):
        raise ValueError("composite_tiles_bwd_splats needs contiguous inputs")
    t, d, m = tile_data.shape
    g = torch.zeros((n, 6 + nchan), dtype=torch.float32,
                    device=tile_data.device)
    if t == 0 or n == 0:
        return g
    lib = _lib("gs_tile_bwd")
    with torch.cuda.device(tile_data.device):
        stream = torch.cuda.current_stream(tile_data.device).cuda_stream
        err = lib.gs_tile_bwd(tile_data.data_ptr(), counts.data_ptr(),
                              prim_idx.data_ptr(), valid.data_ptr(),
                              trans.data_ptr(), g_acc.data_ptr(),
                              g_trans.data_ptr(), t, d, m, grid_w, nchan, n,
                              g.data_ptr(), stream)
    _raise_on(err, lib, "gs_tile_bwd")
    composite_tiles_bwd_splats.launches += 1
    return g


composite_tiles_bwd_splats.launches = 0   # kernel launches since the last reset


# ------------------------------------------------------------------ #
# Plain versions
# ------------------------------------------------------------------ #
def _prefix_sum(x):
    """Inclusive prefix sum over dim 1 of [B, CHUNK, N] by Hillis-Steele
    doubling: the TPU kernel's order of additions."""
    n = x.shape[1]
    k = 1
    while k < n:
        x = x + torch.cat([torch.zeros_like(x[:, :k]), x[:, :n - k]], dim=1)
        k *= 2
    return x


def _chunk_terms(dT, ox, oy, count_in_chunk):
    """dT [B, CHUNK, D] (slots on dim 1) of tiles with origins ox, oy [B]
    and count_in_chunk [B] → per slot-pixel terms [B, CHUNK, NPIX], in the
    TPU kernel's operations (`gs_tile.py::_chunk_terms`)."""
    dev = dT.device
    idx = torch.arange(NPIX, device=dev)
    px = (idx % TILE).to(torch.float32)[None, None, :] + 0.5 \
        + ox[:, None, None]
    py = torch.div(idx, TILE, rounding_mode="floor").to(torch.float32)[
        None, None, :] + 0.5 + oy[:, None, None]
    slot = torch.arange(CHUNK, device=dev)
    in_count = (slot[None, :] < count_in_chunk[:, None])[..., None]
    mu_x, mu_y, a, b, c, op = (dT[:, :, i:i + 1] for i in range(6))
    mx = mu_x - px
    my = mu_y - py
    power = -0.5 * (a * mx * mx + c * my * my) - b * mx * my
    G = torch.exp(torch.clamp_max(power, 0.0))
    raw = op * G
    live = (power <= 0.0) & (raw >= ALPHA_MIN) & in_count
    alpha = torch.where(live, torch.clamp_max(raw, ALPHA_MAX),
                        torch.zeros_like(raw))
    log_one_m = torch.log1p(-alpha)
    return dict(alpha=alpha, G=G, power=power, raw=raw, live=live,
                log_one_m=log_one_m, mx=mx, my=my, a=a, b=b, c=c, op=op)


def _tile_origins(sel, grid_w):
    ox = ((sel % grid_w) * TILE).to(torch.float32)
    oy = (torch.div(sel, grid_w, rounding_mode="floor") * TILE).to(
        torch.float32)
    return ox, oy


def composite_tiles_fwd_plain(tile_data, counts, grid_w: int, nchan: int,
                              tile_block: int = TILE_BLOCK):
    """The TPU kernel's function (`gs_tile.py::composite_tiles_fwd`) on a
    gathered block, in plain PyTorch: tile_data [T, D, M] f32 (rows μx,
    μy, conic a, b, c, opacity, nchan channels, zero pad; M a multiple of
    128), counts [T] i32 → (acc [T, C, 256], trans [T, 1, 256]).

    Blocks of `tile_block` tiles, a Python loop over the chunk index, the
    TPU kernel's log-space prefix inside a chunk."""
    _check(tile_data, counts, grid_w, nchan)
    t_tiles, _, m = tile_data.shape
    dev = tile_data.device
    acc = torch.zeros((t_tiles, nchan, NPIX), dtype=torch.float32,
                      device=dev)
    trans = torch.ones((t_tiles, 1, NPIX), dtype=torch.float32, device=dev)
    count = torch.clamp(counts.to(torch.int64), 0, m)
    nsteps = torch.div(count + CHUNK - 1, CHUNK, rounding_mode="floor")
    for lo in range(0, t_tiles, tile_block):
        blk = torch.arange(lo, min(lo + tile_block, t_tiles), device=dev)
        for i in range(int(nsteps[blk].max()) if blk.numel() else 0):
            sel = blk[nsteps[blk] > i]
            ox, oy = _tile_origins(sel, grid_w)
            dT = tile_data[sel, :, i * CHUNK:(i + 1) * CHUNK].transpose(1, 2)
            v = _chunk_terms(dT, ox, oy, count[sel] - i * CHUNK)
            log_one_m = v["log_one_m"]
            lcp = _prefix_sum(log_one_m)
            t_excl = torch.exp(torch.clamp_min(lcp - log_one_m, LOG_FLOOR))
            w = v["alpha"] * t_excl                       # [B, CHUNK, NPIX]
            colors = dT[:, :, 6:6 + nchan]                # [B, CHUNK, C]
            contrib = torch.bmm(colors.transpose(1, 2), w)  # [B, C, NPIX]
            t_cur = trans[sel]                            # [B, 1, NPIX]
            acc[sel] = acc[sel] + t_cur * contrib
            chunk_prod = torch.exp(torch.clamp_min(
                log_one_m.sum(dim=1, keepdim=True), LOG_FLOOR))
            trans[sel] = t_cur * chunk_prod
    return acc, trans


def gather_tile_block(rows, prim_idx, valid):
    """The tile data [T, D, M] of rows [N, D]: slot j of tile t holds row
    `prim_idx[t, j]` with its opacity (value 5) times `valid[t, j]`, as
    the TPU path's gather builds it (`comfy3d_tpu/ops/gs_render.py:
    445-462`); invalid slots' gradient columns are then exactly 0."""
    gathered = rows[prim_idx]                            # [T, M, D]
    gathered[..., 5] *= valid
    return gathered.transpose(1, 2).contiguous()


def composite_tiles_fwd_rows_plain(rows, prim_idx, valid, counts,
                                   grid_w: int, nchan: int,
                                   keep_block: bool = False):
    """Plain PyTorch version of `composite_tiles_fwd_rows` (same contract):
    `gather_tile_block`, then `composite_tiles_fwd_plain`."""
    _check_rows(rows, prim_idx, valid, counts, grid_w, nchan)
    block = gather_tile_block(rows, prim_idx, valid)
    acc, trans = composite_tiles_fwd_plain(block, counts, grid_w, nchan)
    return acc, trans, block if keep_block else None


def composite_tiles_bwd_splats_plain(tile_data, counts, prim_idx, valid,
                                     n: int, grid_w: int, trans, g_acc,
                                     g_trans, nchan: int):
    """Plain PyTorch version of `composite_tiles_bwd_splats` (same
    contract): the per-slot columns of `composite_tiles_bwd_plain`, then
    one `index_add_` of the valid slots below each tile's count."""
    _check_slots(tile_data, prim_idx, valid, n)
    cols = composite_tiles_bwd_plain(tile_data, counts, grid_w, trans, g_acc,
                                     g_trans, nchan)        # [T, D, M]
    m = tile_data.shape[2]
    walked = valid & (torch.arange(m, device=valid.device)[None, :]
                      < counts.to(torch.int64)[:, None])
    rows = cols.transpose(1, 2)[walked][:, :6 + nchan]
    return cols.new_zeros((n, 6 + nchan)).index_add_(0, prim_idx[walked],
                                                     rows)


def composite_tiles_bwd_plain(tile_data, counts, grid_w: int, trans, g_acc,
                              g_trans, nchan: int,
                              tile_block: int = TILE_BLOCK):
    """The TPU kernel's function (`gs_tile.py::composite_tiles_bwd`), in
    plain PyTorch: per-slot gradient columns [T, D, M] f32 in `tile_data`'s
    layout (rows d μx, d μy, d a, d b, d c, d op, d chan_0..C-1, zero rows
    after; slots past min(count, M) are 0).

    Blocks of `tile_block` tiles, a Python loop over the chunk index from
    each tile's last chunk to its first; inside a chunk the TPU kernel's
    prefix sums rebuild each slot's T_i from the chunk's end (log space)
    and the later slots' sum S·g."""
    _check(tile_data, counts, grid_w, nchan)
    _check_bwd(tile_data, trans, g_acc, g_trans, nchan)
    t_tiles, _, m = tile_data.shape
    dev = tile_data.device
    out = torch.zeros_like(tile_data)
    count = torch.clamp(counts.to(torch.int64), 0, m)
    nsteps = torch.div(count + CHUNK - 1, CHUNK, rounding_mode="floor")
    for lo in range(0, t_tiles, tile_block):
        blk = torch.arange(lo, min(lo + tile_block, t_tiles), device=dev)
        tfin = trans[blk]                                 # [nb, 1, NPIX]
        log_t = torch.log(torch.clamp_min(tfin, math.exp(LOG_FLOOR)))
        s_dot_g = torch.zeros_like(log_t)
        nmax = int(nsteps[blk].max()) if blk.numel() else 0
        for i in range(nmax - 1, -1, -1):
            rel = (nsteps[blk] > i).nonzero()[:, 0]       # rows of blk
            sel = blk[rel]
            ox, oy = _tile_origins(sel, grid_w)
            off = i * CHUNK
            dT = tile_data[sel, :, off:off + CHUNK].transpose(1, 2)
            v = _chunk_terms(dT, ox, oy, count[sel] - off)
            alpha, G, live, log_one_m = (v["alpha"], v["G"], v["live"],
                                         v["log_one_m"])
            one_m = torch.clamp_min(1.0 - alpha, 1.0 - ALPHA_MAX)
            lcp = _prefix_sum(log_one_m)
            total_log = log_one_m.sum(dim=1, keepdim=True)
            log_t_after = log_t[rel]
            log_t_i = log_t_after + (lcp - log_one_m) - total_log
            t_i = torch.exp(torch.clamp(log_t_i, LOG_FLOOR, 0.0))
            wc = alpha * t_i
            colors = dT[:, :, 6:6 + nchan]                # [B, CHUNK, C]
            gacc = g_acc[sel]                             # [B, C, NPIX]
            colgdot = torch.bmm(colors, gacc)             # [B, CHUNK, NPIX]
            u = colgdot * wc
            total_u = u.sum(dim=1, keepdim=True)
            incl_u = _prefix_sum(u)
            s_k = (total_u - incl_u) + s_dot_g[rel]
            d_alpha_c = colgdot * t_i - s_k / one_m
            d_alpha_t = -g_trans[sel] * (tfin[rel] / one_m)
            d_alpha = torch.where(live & (v["raw"] < ALPHA_MAX),
                                  d_alpha_c + d_alpha_t,
                                  torch.zeros_like(alpha))
            d_G = d_alpha * v["op"]
            d_op = (d_alpha * G * live).sum(dim=2)
            d_power = d_G * G * (v["power"] <= 0.0)
            mx, my, a, b, c = v["mx"], v["my"], v["a"], v["b"], v["c"]
            rows = [(d_power * (-(a * mx + b * my))).sum(dim=2),
                    (d_power * (-(c * my + b * mx))).sum(dim=2),
                    (-0.5 * mx * mx * d_power).sum(dim=2),
                    (-mx * my * d_power).sum(dim=2),
                    (-0.5 * my * my * d_power).sum(dim=2), d_op]
            d_col = torch.bmm(wc * live, gacc.transpose(1, 2))  # [B,CHUNK,C]
            grads = torch.cat([torch.stack(rows, dim=1),
                               d_col.transpose(1, 2)], dim=1)   # [B,6+C,CHUNK]
            out[sel, :6 + nchan, off:off + CHUNK] = grads
            s_dot_g[rel] = s_dot_g[rel] + total_u
            log_t[rel] = torch.clamp_min(log_t_after - total_log, LOG_FLOOR)
    return out


# ------------------------------------------------------------------ #
# The per-splat box of the redesigned forwards (K4′, K1′)
# ------------------------------------------------------------------ #
# Margins of the box, derived in `splat_box`'s docstring; the kernels use
# the same constants (csrc/gs_fwd_common.cuh).
BOX_TAU_SLACK = 1e-4     # added to τ: expf's 2 ulp, op·G's rounding, logs
BOX_ETA = 1e-6           # relative error of the f32 power's terms
BOX_WIDEN = 1e-6         # relative widening of the half-extents
BOX_MIN_DET = 1e-9       # det' / (a'c') below this: no box (whole tile)


def _round_dir(x, up: bool):
    """float64 → float32, rounded toward +inf (`up`) or −inf, as CUDA's
    __double2float_ru / __double2float_rd."""
    f = x.to(torch.float32)
    back = f.to(torch.float64)
    if up:
        return torch.where(back < x, torch.nextafter(f, torch.full_like(
            f, math.inf)), f)
    return torch.where(back > x, torch.nextafter(f, torch.full_like(
        f, -math.inf)), f)


def splat_box(mu_x, mu_y, a, b, c, op):
    """The conservative box (x0, x1, y0, y1), f32, around each splat's mean
    (mu_x, mu_y) outside which no pixel centre (px, py) can pass the
    forwards' visit test `op·expf(min(power, 0)) ≥ 1/255` (K4 also asks
    power ≤ 0), with power evaluated in f32 as the kernels evaluate it
    from m = mu − p (or p − mu):  power = -0.5·(a·mx·mx + c·my·my) − b·mx·my.
    The Python copy of `box_of` in csrc/gs_fwd_common.cuh: float64, the
    same constants and the same directed roundings.

    Derivation (u = 2⁻²⁴). A visit passes only if op·expf(p_c)·(1 + 4u)
    (1 + u) ≥ α (α = f32(1/255); expf's 2 ulp, op·G's rounding), so the
    computed power p_c ≥ −τ/2 − 5u with τ = 2·ln(op/α). Evaluated in f32
    without contractions, p_c differs from p = −Q/2 (Q = A + C + 2B,
    A = a·mx², C = c·my², B = b·mx·my) by at most 1.5u(|A| + |C|) + 2u|B|
    + u|p_c| ≤ 2.1u·S, S = |A| + |C| + 2|B|. A passing visit so has
    Q − 4.2u·S ≤ τ + 10u, and with η = BOX_ETA > 4.2u
    (1−η)a·mx² − 2(1+η)|b|·|mx·my| + (1−η)c·my² ≤ τ' = τ + BOX_TAU_SLACK.
    Where that form is positive definite (a' = (1−η)a > 0, c' > 0,
    det' = a'c' − (1+η)²b² > BOX_MIN_DET·a'c', so that float64's
    cancellation in det' stays below 1e-6 of it) it bounds
    |mx| ≤ √(τ'c'/det') and |my| ≤ √(τ'a'/det'). The half-extents are
    widened by BOX_WIDEN (the float64 roundings, and the rounding of mx
    itself, u relative) and the box's ends are rounded outward to f32.
    Special cases: any input not finite → the whole plane (every visit
    takes the exact test); op < α → empty (op·G ≤ op with G ≤ 1, so no
    pixel passes); a form that is not positive definite → the whole plane.

    Inputs are f32 tensors of one shape; returns four f32 tensors of it
    (empty: x0 = y0 = +inf, x1 = y1 = −inf; whole: ∓inf)."""
    f64 = [x.to(torch.float64) for x in (mu_x, mu_y, a, b, c, op)]
    mx, my, a_, b_, c_, op_ = f64
    alpha = float(torch.tensor(ALPHA_MIN, dtype=torch.float32))
    finite = torch.ones_like(mx, dtype=torch.bool)
    for x in f64:
        finite &= torch.isfinite(x)
    empty = finite & (op.to(torch.float32) < alpha)
    tau = 2.0 * (torch.log(op_.clamp_min(alpha)) - math.log(alpha)) \
        + BOX_TAU_SLACK
    a1 = a_ * (1.0 - BOX_ETA)
    c1 = c_ * (1.0 - BOX_ETA)
    b1 = b_.abs() * (1.0 + BOX_ETA)
    det = a1 * c1 - b1 * b1
    pd = finite & (a1 > 0) & (c1 > 0) & (det > BOX_MIN_DET * a1 * c1)
    safe = torch.where(pd, det, torch.ones_like(det))
    hx = torch.sqrt(tau * c1.clamp_min(0) / safe) * (1.0 + BOX_WIDEN)
    hy = torch.sqrt(tau * a1.clamp_min(0) / safe) * (1.0 + BOX_WIDEN)
    inf = torch.full_like(mu_x, math.inf, dtype=torch.float32)
    out = []
    for lo, hi in ((mx - hx, mx + hx), (my - hy, my + hy)):
        lo32, hi32 = _round_dir(lo, False), _round_dir(hi, True)
        lo32 = torch.where(pd & ~empty, lo32, -inf)
        hi32 = torch.where(pd & ~empty, hi32, inf)
        out += [torch.where(empty, inf, lo32), torch.where(empty, -inf, hi32)]
    return tuple(out)


def box_misses(box, x_lo, x_hi, y_lo, y_hi):
    """True where the rectangle of pixel centres [x_lo, x_hi] × [y_lo, y_hi]
    lies wholly outside `box` (x0, x1, y0, y1): the kernels' warp-uniform
    skip (a warp's rectangle is two 16-px pixel rows). Broadcasts."""
    x0, x1, y0, y1 = box
    return (x1 < x_lo) | (x0 > x_hi) | (y1 < y_lo) | (y0 > y_hi)
