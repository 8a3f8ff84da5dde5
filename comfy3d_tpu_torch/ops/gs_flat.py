"""Coarse-bin 3DGS compositor, forward: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces the TPU kernels `comfy3d_tpu/ops/pallas/gs_flat.py::_fwd_kernel_merged`
(:339, the default) and `::_fwd_kernel` (:198, `COMFY3D_GS_MERGED=0`), both
reached through `composite_bins_fwd` (:481). The kernel is
`csrc/gs_flat_fwd.cu`; both TPU kernels are modes of it.

What it computes, per coarse bin t (bin_px = 32: 2×2 sub-tiles of 16 px):
walk the bin's depth-sorted pair segment [bounds[t], bounds[t+1]) of `data`
front to back in 128-pair chunks counted from the segment start rounded
down to 128 (the first `skip` slots are dead), and composite
    α = min(op·exp(min(power, 0)), 0.99), zero where op·G < 1/255 or the
    pair's 3σ square misses the 16-px sub-tile;
    acc += chan·α·T,  T *= 1 − α.
Before each chunk, a group whose largest T is below EPS_T stops: the whole
bin in merged mode (sub-tiles whose origin lies outside the image start at
T = 0 and never hold the exit back), each in-image sub-tile in per-sub-tile
mode (out-of-image sub-tiles stay at acc 0, T 1). `stops` counts the chunks
each sub-tile composited; the backward pass re-walks exactly that prefix.

What bounds it on the card: operations, not bytes. Each pair-pixel visit
costs ~20 f32 operations and one exp, against 44 bytes of payload per pair
that every pixel of the bin shares; at 800²/100k splats the function moves
~27 MB but makes ~7.7e7 visits (`chip_smoke.py` counts both).

What the design does about it: one CTA per bin, one thread per pixel of
each sub-tile (256 threads × NSUB pixels in registers), so the payload is
read from device memory once per bin and staged in shared memory one
128-pair chunk at a time; each pair's per-sub-tile footprint bits are
computed once at staging, so a pair that misses a sub-tile costs its 256
threads one uniform branch; the saturation exit is a block-wide
`__syncthreads_or` vote per chunk (per sub-tile in per-sub-tile mode).
"""

from __future__ import annotations

import ctypes
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
MAX_CHAN = 6               # channels the kernel is instantiated for

_SRC = "gs_flat_fwd"


def merged_default() -> bool:
    """The mode `merged=None` selects: `COMFY3D_GS_MERGED` (default "1"), as
    the JAX package reads it."""
    return os.environ.get("COMFY3D_GS_MERGED", "1") == "1"


def _lib():
    lib = _build.load(_SRC)
    if not getattr(lib, "_argtypes_set", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.gs_flat_fwd.argtypes = [vp, ctypes.c_longlong, i32, vp, i32,
                                    i32, i32, i32, i32, i32, i32,
                                    vp, vp, vp, vp]
        lib.gs_flat_fwd.restype = i32
        lib.gs_flat_error_string.argtypes = [i32]
        lib.gs_flat_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


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


def composite_bins_fwd(data, bounds, nbins_x: int, nbins_y: int, nchan: int,
                       width: int, height: int, bin_px: int = DEFAULT_BIN,
                       merged: bool | None = None):
    """data [DPAY, P] f32 pair payload (rows μx, μy, conic a, b, c, opacity,
    nchan channels, 3σ radius, zero pad); bounds [nbins+1] i32.

    Returns (acc [nbins, NSUB, C, 256], trans [nbins, NSUB, 1, 256],
    stops [nbins, NSUB] i32). On a CUDA tensor it launches the kernel; on a
    CPU tensor it runs `composite_bins_fwd_plain`; any other device raises.
    """
    if merged is None:
        merged = merged_default()
    _check(data, bounds, nbins_x, nbins_y, nchan, bin_px)
    if data.device.type == "cpu":
        return composite_bins_fwd_plain(data, bounds, nbins_x, nbins_y,
                                        nchan, width, height, bin_px, merged)
    if data.device.type != "cuda":
        raise ValueError(f"composite_bins_fwd runs on cuda (kernel) or cpu "
                         f"(plain version), not {data.device}")
    if not (data.is_contiguous() and bounds.is_contiguous()):
        raise ValueError("data and bounds must be contiguous")
    nbins = nbins_x * nbins_y
    nsub = (bin_px // TILE) ** 2
    dev = data.device
    acc = torch.empty((nbins, nsub, nchan, NPIX), dtype=torch.float32,
                      device=dev)
    trans = torch.empty((nbins, nsub, 1, NPIX), dtype=torch.float32,
                        device=dev)
    stops = torch.empty((nbins, nsub), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gs_flat_fwd(data.data_ptr(), data.shape[1], data.shape[0],
                              bounds.data_ptr(), nbins, nbins_x, nchan,
                              bin_px // TILE, width, height, int(merged),
                              acc.data_ptr(), trans.data_ptr(),
                              stops.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gs_flat_fwd launch failed: CUDA error {err} "
                           f"({lib.gs_flat_error_string(err).decode()})")
    composite_bins_fwd.launches += 1
    return acc, trans, stops


composite_bins_fwd.launches = 0     # kernel launches since the last reset


def composite_bins_fwd_plain(data, bounds, nbins_x: int, nbins_y: int,
                             nchan: int, width: int, height: int,
                             bin_px: int = DEFAULT_BIN,
                             merged: bool | None = None):
    """Plain PyTorch version of `composite_bins_fwd` (same contract).

    Vectorised over bins, a Python loop over the chunk index, `cumprod`
    inside a chunk. The power is evaluated with the kernel's operations in
    the kernel's order, so on the card both round it identically."""
    if merged is None:
        merged = merged_default()
    _check(data, bounds, nbins_x, nbins_y, nchan, bin_px)
    dev = data.device
    sub = bin_px // TILE
    nsub = sub * sub
    nbins = nbins_x * nbins_y
    ppad = data.shape[1]

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
    in_img = (ox < width) & (oy < height)                  # [nbins, nsub]
    bin_ox = (bin_x * (sub * TILE)).to(torch.float32)
    bin_oy = (bin_y * (sub * TILE)).to(torch.float32)
    sx0 = ((s % sub) * TILE).to(torch.float32)             # [nsub]
    sy0 = (torch.div(s, sub, rounding_mode="floor") * TILE).to(torch.float32)
    p = torch.arange(NPIX, device=dev)
    # bin-local pixel centres [nsub, NPIX]
    px = (p % TILE).to(torch.float32)[None, :] + (sx0[:, None] + 0.5)
    py = torch.div(p, TILE, rounding_mode="floor").to(torch.float32)[None, :] \
        + (sy0[:, None] + 0.5)

    if merged:
        T = in_img.to(torch.float32)[..., None].repeat(1, 1, NPIX)
    else:
        T = torch.ones((nbins, nsub, NPIX), dtype=torch.float32, device=dev)
    acc = torch.zeros((nbins, nsub, nchan, NPIX), dtype=torch.float32,
                      device=dev)
    stops = torch.zeros((nbins, nsub), dtype=torch.int32, device=dev)
    lane = torch.arange(CHUNK, device=dev)
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
        g = b0_al[sel, None] + q * CHUNK + lane            # [nb, CHUNK]
        valid = (g >= b0[sel, None]) & (g < b1[sel, None]) & (g < ppad)
        cols = data[:, g.clamp(0, max(ppad - 1, 0))]       # [D, nb, CHUNK]
        mxl = cols[0] - bin_ox[sel, None]
        myl = cols[1] - bin_oy[sel, None]
        r = cols[6 + nchan]
        # [nb, CHUNK, nsub]: the pair's 3σ square meets the sub-tile
        ov = (valid[..., None] & runs[:, None, :]
              & (mxl[..., None] + r[..., None] > sx0)
              & (mxl[..., None] - r[..., None] < sx0 + TILE)
              & (myl[..., None] + r[..., None] > sy0)
              & (myl[..., None] - r[..., None] < sy0 + TILE))

        e = (...,) + (None, None)
        dx = px - mxl[e]                                   # [nb,CHUNK,nsub,NPIX]
        dy = py - myl[e]
        a, bb, c, op = cols[2][e], cols[3][e], cols[4][e], cols[5][e]
        power = -0.5 * (a * dx * dx + c * dy * dy) - bb * dx * dy
        G = torch.exp(torch.clamp_max(power, 0.0))
        raw = op * G
        live = (raw >= ALPHA_MIN) & ov[..., None]
        alpha = torch.where(live, torch.clamp_max(raw, ALPHA_MAX),
                            torch.zeros_like(raw))
        cp = torch.cumprod(1.0 - alpha, dim=1)
        t_excl = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        w = alpha * t_excl
        contrib = torch.einsum("cnk,nksp->nscp", cols[6:6 + nchan], w)
        t_sel = T[sel]
        acc[sel] = acc[sel] + t_sel[:, :, None, :] * contrib
        T[sel] = t_sel * cp[:, -1]
        stops[sel] = torch.where(runs, torch.full_like(stops[sel], q + 1),
                                 stops[sel])

    return acc, T[:, :, None, :], stops
