"""Per-16-px-tile 3DGS compositor, forward and backward: the CUDA kernels'
wrappers and their plain PyTorch versions.

Forward. Replaces the TPU kernel `comfy3d_tpu/ops/pallas/gs_tile.py::
_fwd_kernel` (:92, reached through `composite_tiles_fwd` :206). The kernel
is `csrc/gs_tile_fwd.cu`.

What it computes, per 16-px tile t: walk the tile's padded, depth-ordered
list `tile_data[t]` ([D, M]: rows μx, μy, conic a, b, c, opacity, C
channels, zero pad) front to back over its first min(counts[t], M) slots,
in 128-slot chunks, and composite per pixel
    power = -0.5·(a·mx² + c·my²) - b·mx·my   (mx = μx - px, my = μy - py)
    α = min(op·exp(min(power, 0)), 0.99), zero where power > 0 or
        op·G < 1/255;
    acc += chan·α·T,  T *= 1 − α.
There is no saturation exit: every counted slot is walked. The plain
version keeps the TPU kernel's arithmetic: within a chunk the exclusive
transmittance is exp of a log-space prefix sum (Hillis-Steele doubling, as
the TPU kernel sums), floored at e^-80; the chunk's product carries T. The
kernel multiplies T sequentially; the two differ only in rounding, and where
T < e^-80, where every term is below 2e-35.

What bounds it on the card: operations. Each slot-pixel visit costs ~17
f32 operations and one exp, against 4·(6 + C) bytes of a slot that the
tile's 256 pixels share (`chip_smoke.py` counts both on its input).
What the design does about it: one CTA per tile, one thread per pixel, so
a slot's columns are read from device memory once per tile, staged in
shared memory one 128-slot chunk at a time.

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
            # data, counts, ntiles, d, m, grid_w, nchan, acc, trans, stream
            "gs_tile_fwd": [vp, vp] + [i32] * 5 + [vp] * 3,
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


def composite_tiles_fwd(tile_data, counts, grid_w: int, nchan: int):
    """tile_data [T, D, M] f32 (rows μx, μy, conic a, b, c, opacity, nchan
    channels, zero pad; M a multiple of 128); counts [T] i32.

    Returns (acc [T, C, 256], trans [T, 1, 256]). On a CUDA tensor it
    launches the kernel; on a CPU tensor it runs `composite_tiles_fwd_plain`;
    any other device raises."""
    _check(tile_data, counts, grid_w, nchan)
    if _device_kind(tile_data, "composite_tiles_fwd") == "cpu":
        return composite_tiles_fwd_plain(tile_data, counts, grid_w, nchan)
    if not (tile_data.is_contiguous() and counts.is_contiguous()):
        raise ValueError("tile_data and counts must be contiguous")
    t, d, m = tile_data.shape
    dev = tile_data.device
    acc = torch.empty((t, nchan, NPIX), dtype=torch.float32, device=dev)
    trans = torch.empty((t, 1, NPIX), dtype=torch.float32, device=dev)
    if t == 0:
        return acc, trans
    lib = _lib("gs_tile_fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gs_tile_fwd(tile_data.data_ptr(), counts.data_ptr(), t, d,
                              m, grid_w, nchan, acc.data_ptr(),
                              trans.data_ptr(), stream)
    _raise_on(err, lib, "gs_tile_fwd")
    composite_tiles_fwd.launches += 1
    return acc, trans


composite_tiles_fwd.launches = 0    # kernel launches since the last reset


def composite_tiles_bwd_splats(tile_data, counts, prim_idx, valid, n: int,
                               grid_w: int, trans, g_acc, g_trans,
                               nchan: int):
    """Backward of `composite_tiles_fwd` with its per-splat scatter:
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
    """Plain PyTorch version of `composite_tiles_fwd` (same contract).

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
