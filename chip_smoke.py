#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`comfy3d_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--out RECORD.json]   # repository root, one card

Phases, in order; the first failure ends the run with a non-zero exit:
  1. the card: its name, and `nvidia-smi`'s name and power limit;
  2. build every CUDA source under comfy3d_tpu_torch/csrc with nvcc, all
     at once;
  3. the coarse-bin forward (`gs_flat_fwd`, K1′/K2′: splat rows read by
     index) against its plain version on the gathered payload, on the same
     inputs, in merged and per-sub-tile mode at 20k splats / 256² and 100k
     splats / 800², and with 48- and 64-px bins (clusters of 9 and 16
     CTAs) at 20k / 256²;
  4. the render path — a 100k-splat GS-PLY written with `save_gs_ply`,
     read back with `load_gs_ply(device="cuda")`, rendered from 8 orbit
     views at 800² with `render` — with every kernel's launch count reset
     just before and read just after; then times of a frame, the kernel,
     its plain version, the coarse sort and the gather the kernel took in,
     with CUDA events; a profile of one frame, which must gather no pair
     rows; the per-splat box on view 0 (no live visit outside it);
  5. the compositor backward with its per-splat scatter (`gs_flat_bwd`)
     against its plain version on the same scenes and modes, from the
     forward kernel's trans/stops and seeded random cotangents: each
     gradient row within 1e-3 of its largest value, the rows of splats no
     walked pair holds exactly 0, splat 0's row the sum of its own pairs'
     plain columns;
  6. the trainer learns: 64 random splats fitted to 4 views of a 4-splat
     scene at 64² for 120 steps at batch 2 (loss must fall below 0.7× its
     start);
  7. the training path at full width (`bench.py::bench_gs_train_step`'s
     set-up: 100k splats, 800², 4 orbit views, batch 1, `GSTrainConfig`
     defaults) — 10 steps with the launch counts reset just before and read
     just after, step and kernel times, a profile of one step (which must
     hold no `index_add_`, and gather the payload rows once, for the
     backward), one densify and one opacity reset, and the trained splat
     through GS-PLY and back; on the trained splat's view 0 the forward
     and backward kernels' times and bounds and the per-splat box; beside
     the backward kernel, the counts of the per-slot design on the same
     input (warp reductions, their shuffle bound, walk lengths) and the
     time of its per-step scatter (`index_add_` × 4 of the plain per-slot
     columns);
  8. the tile compositor forward and backward (`gs_tile_fwd`, K4′: splat
     rows read by index; `gs_tile_bwd`, K5′, fed the block K4′ writes)
     against their plain versions on the card, at 20k splats / 256² with
     `max_per_tile` 512 and 100k splats / 800² with 1024, the backward
     with phase 5's gates; K4′'s block equal to the gathered one below
     each tile's count;
  9. the tile render path — phase 4's GS-PLY from the same 8 views with
     `render(..., backend="tile", max_per_tile=1024)`, launch counts reset
     just before and read just after; tile-vs-flat PSNR per view and on the
     20k/256² parity scene; on that scene `render_arrays` at
     `max_per_tile=64, chunk=8` (lists padded to 128 slots) through the
     kernels against the same call through their plain versions, outputs
     and gradients with phases 3 and 5's gates, one launch of each; times of a frame, the kernel, its plain
     version, `bin_primitives` and the gather the kernel took in, a profile
     of one frame (no splat-row gather) and the per-splat box on view 0;
 10. the tile train path — the learning check of phase 6 and phase 7's 10
     steps with `GSTrainConfig(backend="tile")` (M = 512), with launch
     counts, step and kernel times, a profile of one step (no splat-row
     gather) and phase 7's view-0 measures;
 11. TripoSR image → mesh (`TripoSRPipeline`, `TripoSRConfig()` widths:
     ViT-B/16 on a 512² image, a 1,024-channel backbone over 3×32² tokens,
     40-channel 64² triplanes, a 10-layer NeRF MLP; weights from a seed).
     It reaches none of the compositor kernels. a. the card against the
     port's CPU path with TF32 off, at full width but 2 ViT and 2 backbone
     layers: scene codes, and σ and rgb at 32,768 probes, each within 1e-3
     of its largest value; b. full depth: `scene_codes` by CUDA events
     (warm-up, then 5 runs; TF32 off, then on) and peak memory; c. an
     analytic sphere (radius 0.5 in the 0.87 box) decoded hierarchically
     at 257³ and swept + welded on the card and on the CPU: equal counts
     and faces, vertices within 1e-5, area within 1 % of π, no overflow;
     d. `extract_mesh` at 256 (→ 257³) with the threshold at the 98th
     percentile of σ at 32,768 seeded probes, 2 M triangles, clipped on
     overflow (a random-weight field is a noise surface), with colours:
     the total time of one call, then its split from a profile of one
     more call (the host and device ms of each of `extract_mesh`'s
     spans: decode, sweep + weld, the copy to the host, colours, the
     host's vertex normals), counts, the overflow flag, and the mesh
     through GLB and back; e. one 128² orbit render (finite, alpha in
     [0, 1]).
 12. InstantMesh posed views → mesh (`InstantMeshPipeline`,
     `InstantMeshConfig()` widths: a camera-modulated ViT-B/16 over six
     320² views, a 16-layer 1,024-wide transformer over 3×32² tokens, 80-
     channel 64² triplanes; weights from seed 0; `bench.py::
     bench_instantmesh_wallclock`'s views and cameras). a. the card against
     the port's CPU path with TF32 off at 2 ViT + 2 transformer layers:
     triplanes, and SDF, deformation and rgb at 32,768 probes, each within
     1e-3 of its largest value; b. full depth: `forward_planes` by CUDA
     events (warm-up, then 5 runs; TF32 off, then on), the parameter count
     and peak memory; c. `marching_tets_deformed` + `weld_device` on a
     sphere's SDF over a smoothly deformed 97³ lattice, card against CPU:
     equal counts and faces, vertices within 1e-5, no overflow; d.
     `extract_mesh` at 96 (the bench's) and 129 (the default): a first call
     that climbs the capacity ladder (its rungs counted), one warm call
     timed, one more profiled by its spans (`models/instantmesh/
     pipeline.py::EXTRACT_STAGES`), counts, the capacity reached, the
     overflow flag (reported, not gated: random weights make a noise
     surface), the 96³ mesh through GLB and back.
 13. the mesh orbit renderer (`ops/mesh_render.py::render_mesh` with the
     `Mesh_Orbit_Renderer` node's defaults: 512², fovy 49.1, background 1,
     "binned"; meshes through `Mesh.device_arrays` with `face_valid`, as
     the node passes them), on a unit sphere from
     `extract_isosurface_device` at 97³ with vertex colours and a
     subdivided cube with per-face UVs onto a seeded 1024² albedo. a. one
     view of each, card against CPU: face ids equal on ≥ 99.9 % of pixels,
     image, alpha, depth, normal and viewcos within 1e-4 where they agree;
     on the card `"binned"` equal to `"bruteforce"` (no tile overflowed);
     b. the gradients with respect to v, vc and albedo, finite, card
     against CPU within 1e-3 of their largest value; c. the 8-view orbit
     batch of the sphere by CUDA events, one frame and its rasterization,
     a profile of one frame (device-busy ms, idle share, device ops), one
     view at `ssaa=2`; d. phase 12's 96³ mesh from the same 8 views: the
     time and the covered-pixel share (not gated).
Phases 11–13 launch none of the compositor kernels (counted).
It prints a `{"triposr": {...}}`, an `{"instantmesh": {...}}` and a
`{"mesh_render": {...}}` line, one `{"kernels": [...]}` line, then
the `nvidia-smi` line, and as its last line `{"ok": true, "device":
{...}}`. With `--out`, the full record
(per-phase errors, times, profile) is also written as JSON to that path.
Without a CUDA device, or without the repository beside this file, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 outside tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
TOL_ABS = 1e-4          # acc / trans, kernel vs plain
TOL_PSNR_DB = 60.0      # rendered image, kernel vs plain
MAX_STOPS_MISMATCH = 1e-3   # share of bins whose stops may differ
TOL_BWD_REL = 1e-3      # gradient rows, kernel vs plain, / the row's max |plain|
TOL_TILE_FLAT_DB = 40.0  # tile vs coarse-bin render on the 20k/256² scene
LOSS_DROP = 0.7         # trainer learns: last-10 mean loss < 0.7 × first-10
DEAD_SLOTS = 1024       # dead slots after the full-width splat's 100k
# the learning check's render size: at 128² the initial splats' 3σ boxes
# span more than the k = 4 coarse bins a splat may occupy
# (`max_tiles_per_prim` 16, as in the JAX package) and are cut off
LEARN_SIZE = 64


def log(msg):
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_frames(fn, frames, rows=None):
    """torch.profiler over `frames` calls of fn: device-busy ms per frame,
    device-side ops per frame, and the ops with the most device time. With
    `rows` (a shape [n, D]), also the row gathers per frame: the indexing
    ops (`aten::index`, `index_select`, `gather`, `take`) whose source has
    that shape, i.e. a gather of the per-splat rows a forward kernel reads
    by index."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=rows is not None) as prof:
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # device-side entries only (kernels, copies, memsets): a host op's
    # entry repeats the device time of the kernels it launched
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    ops.sort(key=dev_us, reverse=True)
    # PyTorch's index_add_ kernels (indexFuncLargeIndex / SmallIndex)
    scatter = [e for e in ops if "indexFunc" in e.key]
    out = dict(
        device_busy_ms=sum(dev_us(e) for e in ops) / 1e3 / frames,
        device_ops=sum(e.count for e in ops) / frames,
        index_add_ms=sum(dev_us(e) for e in scatter) / 1e3 / frames,
        index_add_launches=sum(e.count for e in scatter) / frames,
        top=[dict(name=e.key[:80], ms=dev_us(e) / 1e3 / frames,
                  count=e.count / frames) for e in ops[:10]])
    if rows is not None:
        names = ("aten::index", "aten::index_select", "aten::gather",
                 "aten::take")
        hits = [e for e in prof.key_averages(group_by_input_shape=True)
                if e.key in names and e.input_shapes
                and list(e.input_shapes[0]) == list(rows)]
        out["row_gathers"] = sum(e.count for e in hits) / frames
        out["row_gather_ops"] = [
            dict(name=e.key, input_shapes=str(e.input_shapes)[:160],
                 count=e.count / frames) for e in hits]
    return out


def smi(fields):
    """One line of `nvidia-smi --query-gpu=<fields>` for card 0."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def subtiles_in_image(inp):
    """[nbins, 4] bool: the 16-px sub-tiles whose origin lies in the
    image."""
    import torch
    from comfy3d_tpu_torch.ops.gs_flat import TILE
    t = torch.arange(inp["nbx"] * inp["nby"],
                     device=inp["data"].device)[:, None]
    s = torch.arange(4, device=t.device)[None, :]
    ox = ((t % inp["nbx"]) * 2 + s % 2) * TILE
    oy = (torch.div(t, inp["nbx"], rounding_mode="floor") * 2
          + torch.div(s, 2, rounding_mode="floor")) * TILE
    return (ox < inp["W"]) & (oy < inp["H"])


def psnr(a, b):
    mse = float(((a - b) ** 2).mean())
    return 10.0 * math.log10(1.0 / max(mse, 1e-20))


def make_splat(n, scale, seed, device):
    """bench.py's scene: n random splats in a 0.8 ball, SH degree 0, scale
    `scale`, opacity_raw 1.0 (random weights from a seed)."""
    import dataclasses
    import torch
    from comfy3d_tpu_torch.core.gaussian import GaussianSplat
    s = GaussianSplat.random(torch.Generator().manual_seed(seed), n,
                             sh_degree=0, radius=0.8, device=device)
    return dataclasses.replace(
        s, scale_raw=torch.full_like(s.scale_raw, math.log(scale)),
        opacity_raw=torch.full_like(s.opacity_raw, 1.0))


def flat_inputs(splat, cam, bin_px=32):
    """The compositor's inputs for one camera, as `render_arrays` builds
    them: projection, SH colour, coarse sort, the per-splat rows the kernel
    reads by index; and the gathered payload its plain version takes."""
    import torch
    from comfy3d_tpu_torch.ops import binning, gs_flat
    from comfy3d_tpu_torch.ops import gs_render as G
    W, H = cam.width, cam.height
    means2d, depth, conic, radii, visible = G.project_gaussians(
        splat.xyz, splat.scale, splat.rotation, cam.w2c, cam.intrinsics,
        W, H)
    active = visible & splat.alive & (splat.opacity > G.ALPHA_MIN)
    chans = torch.cat([splat.colors_toward(cam.campos), depth[:, None]], -1)
    nby, nbx = binning.num_bins(H, W, bin_px)
    k = G.max_tiles_per_prim_coarse(16)
    sprim, bounds, _ = binning.bin_coarse(means2d, depth, radii, active,
                                          nby, nbx, k=k, bin_px=bin_px)
    r_row = torch.where(active, torch.clamp_min(radii, 0.5),
                        torch.zeros_like(radii))
    pack_args = (means2d, conic, splat.opacity, chans, r_row)
    rows = G.payload_rows(*pack_args)
    data = gs_flat.gather_payload(rows, sprim)
    sort_args = (means2d, depth, radii, active, nby, nbx, k)
    return dict(data=data, rows=rows, bounds=bounds, nbx=nbx, nby=nby, W=W,
                H=H, C=chans.shape[-1], sort_args=sort_args, sprim=sprim,
                n=means2d.shape[0], bin_px=bin_px, pack_args=pack_args)


def flat_gather(inp):
    """The payload gather K1′ took in (once the forward's input, now the
    backward's): the rows packed and gathered in pair order."""
    from comfy3d_tpu_torch.ops import gs_flat
    from comfy3d_tpu_torch.ops import gs_render as G
    return gs_flat.gather_payload(G.payload_rows(*inp["pack_args"]),
                                  inp["sprim"])


def flat_kernel_args(inp, merged):
    """K1′'s arguments (`composite_bins_fwd_rows`) for this input, and its
    plain version's on the gathered payload (`composite_bins_fwd_plain`)."""
    geo = (inp["bounds"], inp["nbx"], inp["nby"], inp["C"], inp["W"],
           inp["H"], inp["bin_px"], merged)
    return (inp["rows"], inp["sprim"], *geo), (inp["data"], *geo)


def to_image(acc, trans, inp):
    from comfy3d_tpu_torch.ops import gs_render as G
    geo = (inp["nby"], inp["nbx"], inp["H"], inp["W"], inp["bin_px"])
    img = G._bins_to_image(acc, *geo)
    tr = G._bins_to_image(trans, *geo)
    return img[..., :-1] + tr * 1.0         # rgb + (1 - alpha) · white


def visits(inp, stops):
    """Pair-pixel visits this input makes up to `stops`: pairs of the
    composited chunks whose 3σ square meets a sub-tile, × 256 pixels."""
    import torch
    from comfy3d_tpu_torch.ops.gs_flat import CHUNK, TILE
    data, bounds = inp["data"], inp["bounds"].long()
    nbins = inp["nbx"] * inp["nby"]
    counts = bounds[1:] - bounds[:-1]
    g = torch.arange(int(bounds[-1]), device=data.device)
    t = torch.repeat_interleave(torch.arange(nbins, device=data.device),
                                counts)
    q = torch.div(g - torch.div(bounds[:-1], CHUNK, rounding_mode="floor")
                  [t] * CHUNK, CHUNK, rounding_mode="floor")
    bx = (t % inp["nbx"]) * 2 * TILE
    by = torch.div(t, inp["nbx"], rounding_mode="floor") * 2 * TILE
    mxl, myl = data[0, :g.numel()] - bx, data[1, :g.numel()] - by
    r = data[6 + inp["C"], :g.numel()]
    total = 0
    for s in range(4):
        sx0, sy0 = (s % 2) * TILE, (s // 2) * TILE
        ov = ((mxl + r > sx0) & (mxl - r < sx0 + TILE)
              & (myl + r > sy0) & (myl - r < sy0 + TILE))
        total += int((ov & (q < stops[t, s].long())).sum())
    return total * TILE * TILE


def kernel_vs_plain(label, inp, merged):
    """K1′ (merged) or K2′ against its plain version on the gathered
    payload: stops, acc/trans max abs error, the image's PSNR."""
    import torch
    from comfy3d_tpu_torch.ops import gs_flat
    args, plain_args = flat_kernel_args(inp, merged)
    acc, tr, st = gs_flat.composite_bins_fwd_rows(*args)
    torch.cuda.synchronize()
    p_acc, p_tr, p_st = gs_flat.composite_bins_fwd_plain(*plain_args)
    bad = (st != p_st).any(-1)
    n_bad = int(bad.sum())
    if n_bad:
        log(f"{label}: stops differ in bins {bad.nonzero()[:, 0].tolist()}")
    check(n_bad <= MAX_STOPS_MISMATCH * bad.numel(),
          f"{label}: stops differ in {n_bad} of {bad.numel()} bins")
    keep = ~bad
    err_acc = float((acc - p_acc).abs()[keep].max())
    err_tr = float((tr - p_tr).abs()[keep].max())
    db = psnr(to_image(acc, tr, inp), to_image(p_acc, p_tr, inp))
    rec = dict(max_abs_err_acc=err_acc, max_abs_err_trans=err_tr,
               stops_mismatch_bins=n_bad, psnr_db=db,
               pairs=int(inp["bounds"][-1]), bin_px=inp["bin_px"],
               max_stop=int(st.max()))
    log(f"{label}: {rec}")
    check(err_acc <= TOL_ABS and err_tr <= TOL_ABS,
          f"{label}: acc err {err_acc}, trans err {err_tr} > {TOL_ABS}")
    check(db >= TOL_PSNR_DB, f"{label}: PSNR {db:.2f} dB < {TOL_PSNR_DB}")
    return rec, (acc, tr, st), to_image(p_acc, p_tr, inp)


def pair_bins(inp):
    """Per pair column g < pairs: its bin t and its chunk q within the bin's
    aligned walk."""
    import torch
    from comfy3d_tpu_torch.ops.gs_flat import CHUNK
    bounds = inp["bounds"].long()
    dev = bounds.device
    nbins = inp["nbx"] * inp["nby"]
    g = torch.arange(int(bounds[-1]), device=dev)
    t = torch.repeat_interleave(torch.arange(nbins, device=dev),
                                bounds[1:] - bounds[:-1])
    q = torch.div(g - torch.div(bounds[:-1], CHUNK, rounding_mode="floor")
                  [t] * CHUNK, CHUNK, rounding_mode="floor")
    return g, t, q


def walked_subtiles(inp, stops, t, q):
    """[pairs, 4] bool: in-image sub-tiles whose composited prefix holds the
    pair's chunk (what the backward walks)."""
    return subtiles_in_image(inp)[t] & (q[:, None] < stops[t].long())


def bwd_visits(inp, stops, block=16384):
    """The backward's pair-pixel visits on this input: footprint (walked
    sub-tiles the pair's 3σ square meets), live (of those the pixels with
    op·G ≥ 1/255), unsat (of those the ones with op·G < 0.99), evaluated
    with the kernel's operations; and two counts of the per-slot
    one-CTA-per-bin design: pair_warps_live, its warp reductions (walked
    pairs × the 8 warps of 32 pixel slots, each over the 4 sub-tiles, with
    a live lane), and pairs_walked (pairs with a footprint bit in a walked
    sub-tile); pair_subtiles (walked (pair, sub-tile) footprint entries)."""
    import torch
    from comfy3d_tpu_torch.ops.gs_flat import ALPHA_MAX, ALPHA_MIN, TILE
    data, C = inp["data"], inp["C"]
    g, t, q = pair_bins(inp)
    walk = walked_subtiles(inp, stops, t, q)
    p = torch.arange(TILE * TILE, device=data.device)
    s = torch.arange(4, device=data.device)
    sx0 = ((s % 2) * TILE).float()
    sy0 = (torch.div(s, 2, rounding_mode="floor") * TILE).float()
    px = (p % TILE).float()[None, :] + (sx0[:, None] + 0.5)
    py = torch.div(p, TILE, rounding_mode="floor").float()[None, :] \
        + (sy0[:, None] + 0.5)
    fp = live = unsat = warps_live = pairs_walked = 0
    for lo in range(0, g.numel(), block):
        sl = slice(lo, min(lo + block, g.numel()))
        tt = t[sl]
        mxl = data[0, sl] - ((tt % inp["nbx"]) * 2 * TILE).float()
        myl = data[1, sl] - (torch.div(tt, inp["nbx"], rounding_mode="floor")
                             * 2 * TILE).float()
        r = data[6 + C, sl]
        ov = walk[sl] & ((mxl[:, None] + r[:, None] > sx0)
                         & (mxl[:, None] - r[:, None] < sx0 + TILE)
                         & (myl[:, None] + r[:, None] > sy0)
                         & (myl[:, None] - r[:, None] < sy0 + TILE))
        e = (slice(None), None, None)
        dx = px - mxl[e]
        dy = py - myl[e]
        a, b, c, op = (data[i, sl][e] for i in (2, 3, 4, 5))
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        raw = op * torch.exp(torch.clamp_max(power, 0.0))
        hit = ov[..., None] & (raw >= ALPHA_MIN)          # [b, 4, 256]
        fp += int(ov.sum()) * TILE * TILE
        live += int(hit.sum())
        unsat += int((hit & (raw < ALPHA_MAX)).sum())
        warps_live += int(hit.reshape(hit.shape[0], 4, 8, 32).any(-1)
                          .any(1).sum())
        pairs_walked += int(ov.any(-1).sum())
    return dict(footprint_visits=fp, live_visits=live, unsat_visits=unsat,
                pair_warps_live=warps_live, pairs_walked=pairs_walked,
                pair_subtiles=fp // (TILE * TILE))


def bwd_bound(inp, stops):
    """The least time of K3's function, the coarse-bin backward with its
    per-splat scatter, on this input: bytes (payload rows, trans, g_acc,
    g_trans, stops, bounds and the pairs' splat indices read, the [n, 6 + C]
    per-splat rows written, each once) against f32 operations counted from
    the kernel's arithmetic per visit: 15 per footprint visit (offsets,
    power, exp, raw, test), 12 + 4C more per live one (alpha, log, log T_i,
    exp, chan·g, α·T_i, d chan, S), 33 more per unsaturated one (dα, d op,
    d power, d μ, d conic), and 6 + C adds per walked (pair, sub-tile)."""
    C = inp["C"]
    nbins = inp["nbx"] * inp["nby"]
    pairs = int(inp["bounds"][-1])
    pix = nbins * 4 * 256
    in_bytes = ((7 + C) * pairs + (C + 2) * pix + nbins * 4 + nbins + 1) * 4 \
        + pairs * 8
    out_bytes = inp["n"] * (6 + C) * 4
    v = bwd_visits(inp, stops)
    ops = 15 * v["footprint_visits"] + (12 + 4 * C) * v["live_visits"] \
        + 33 * v["unsat_visits"] + (6 + C) * v["pair_subtiles"]
    return _bound(in_bytes, out_bytes, ops, **v)


def bwd_args(inp, fwd, seed):
    """K3's arguments (`composite_bins_bwd_splats`) for a forward kernel's
    (acc, trans, stops), with cotangents drawn from a seeded generator on
    the card; and the per-pair plain function's
    (`composite_bins_bwd_plain`) for the same inputs."""
    import torch
    acc, trans, stops = fwd
    gen = torch.Generator(device=acc.device).manual_seed(seed)
    g_acc = torch.randn(acc.shape, generator=gen, device=acc.device)
    g_trans = torch.randn(trans.shape, generator=gen, device=acc.device)
    geo = (inp["nbx"], inp["nby"], inp["C"], inp["W"], inp["H"])
    return ((inp["data"], inp["bounds"], inp["sprim"], inp["n"], trans,
             stops, g_acc, g_trans, *geo),
            (inp["data"], inp["bounds"], trans, stops, g_acc, g_trans, *geo))


def walked_pair_rows(inp, stops, cols):
    """The per-pair plain columns [DG, P] of the pairs some in-image
    sub-tile walked, as rows [S, 6 + C], and their splats [S]."""
    g, t, q = pair_bins(inp)
    g = g[walked_subtiles(inp, stops, t, q).any(-1)]
    return cols[:6 + inp["C"], g].t(), inp["sprim"][g]


def walked_slot_rows(inp, cols):
    """The per-slot plain columns [T, D, M] of the valid slots below each
    tile's count, as rows [S, 6 + C], and their splats [S]."""
    import torch
    m = cols.shape[2]
    walked = inp["valid"] & (torch.arange(m, device=cols.device)[None, :]
                             < inp["counts"][:, None])
    return (cols.transpose(1, 2)[walked][:, :6 + inp["C"]],
            inp["prim_idx"][walked])


def splat_rows_vs_plain(label, k, p, rows, idx):
    """A backward kernel's per-splat rows k [n, 6 + C] against its plain
    version's p: per gradient row max |k − p| / max |p|; the rows of splats
    that no walked slot holds (none of `idx`) exactly 0 in both; splat 0's
    row against the sum of its own walked slots' plain `rows`, per row
    relative to that row's max |p|."""
    import torch
    nrow = k.shape[1]
    scale = p.abs().amax(0).clamp_min(1e-30)
    rel = (((k - p).abs().amax(0)) / scale).tolist()
    worst = max(range(nrow), key=lambda r: rel[r])
    held = torch.zeros(k.shape[0], dtype=torch.bool, device=k.device)
    held[idx] = True
    untouched_zero = not bool(k[~held].any()) and not bool(p[~held].any())
    own = rows[idx == 0].sum(0)
    row0_rel = float(((k[0] - own).abs() / scale).max())
    rec = dict(max_rel_err=rel[worst], worst_row=worst, rel_err_rows=rel,
               max_abs_err=float((k - p).abs().max()),
               splats_held=int(held.sum()), untouched_zero=untouched_zero,
               splat0_slots=int((idx == 0).sum()), splat0_rel_err=row0_rel)
    log(f"bwd {label}: worst row {worst} rel err {rel[worst]:.3g}, max abs "
        f"err {rec['max_abs_err']:.3g}, {rec['splats_held']} splats held, "
        f"untouched zero {untouched_zero}, splat 0 ({rec['splat0_slots']} "
        f"slots) rel err {row0_rel:.3g}")
    check(bool(torch.isfinite(k).all()), f"bwd {label}: non-finite")
    check(rel[worst] <= TOL_BWD_REL,
          f"bwd {label}: row {worst} rel err {rel[worst]} > {TOL_BWD_REL}")
    check(untouched_zero, f"bwd {label}: rows of untouched splats are not 0")
    check(row0_rel <= TOL_BWD_REL, f"bwd {label}: splat 0's row is not the "
          f"sum of its slots (rel err {row0_rel})")
    return rec


def bwd_vs_plain(label, inp, fwd, seed):
    """K3 against its plain version (`splat_rows_vs_plain`)."""
    import torch
    from comfy3d_tpu_torch.ops import gs_flat
    args, pair_args = bwd_args(inp, fwd, seed)
    k = gs_flat.composite_bins_bwd_splats(*args)
    torch.cuda.synchronize()
    p = gs_flat.composite_bins_bwd_splats_plain(*args)
    rows, idx = walked_pair_rows(
        inp, fwd[2], gs_flat.composite_bins_bwd_plain(*pair_args))
    return splat_rows_vs_plain(label, k, p, rows, idx)


def synthetic_views(dev, size, n_views=4):
    """tests/test_gs_trainer.py's scene: 4 coloured splats rendered by the
    port from an orbit at elevation 0 → (cameras, images, alpha masks)."""
    import dataclasses
    import numpy as np
    import torch
    from comfy3d_tpu_torch.core.camera import Camera
    from comfy3d_tpu_torch.core.gaussian import GaussianSplat
    from comfy3d_tpu_torch.ops import gs_render as G
    gt = GaussianSplat.from_points(
        np.array([[0.0, 0, 0], [0.25, 0, 0], [0, 0.25, 0], [0, 0, 0.25]],
                 np.float32),
        colors=np.array([[0.9, 0.1, 0.1], [0.1, 0.9, 0.1],
                         [0.1, 0.1, 0.9], [0.9, 0.9, 0.1]], np.float32),
        initial_scale=0.12, device=dev)
    gt = dataclasses.replace(gt, opacity_raw=torch.full_like(
        gt.opacity_raw, 3.0))
    cams = Camera.from_orbit([0.0] * n_views,
                             [i * 360.0 / n_views for i in range(n_views)],
                             2.0, width=size, height=size, device=dev)
    out = G.render(gt, cams, background=(1.0, 1.0, 1.0))
    return cams, out["image"], out["alpha"]


def trainer_learns(dev, backend="flat"):
    """Phase 6 (and 10, with backend "tile"): 64 random splats fitted to
    the synthetic views."""
    import torch
    from comfy3d_tpu_torch.algorithms import gs_trainer as T
    from comfy3d_tpu_torch.core.gaussian import GaussianSplat
    from comfy3d_tpu_torch.ops import gs_render as G
    cams, imgs, masks = synthetic_views(dev, LEARN_SIZE)
    init = GaussianSplat.random(torch.Generator().manual_seed(1), 64,
                                radius=0.4, device=dev)
    check(not bool(G.render(init, cams, backend=backend)["overflow"].any()),
          f"initial splats overflow their {backend} lists at {LEARN_SIZE}²")
    cfg = T.GSTrainConfig(iterations=120, batch_size=2,
                          density_start_iter=10_000,
                          position_lr_init=0.002, position_lr_final=0.0002,
                          backend=backend)
    step = T.make_train_step(cfg, cams, imgs, masks)
    state = T.init_state(init)
    gen = torch.Generator().manual_seed(2)
    losses = []
    t0 = time.perf_counter()
    for _ in range(cfg.iterations):
        state, m = step(state, *T.draw_step_inputs(gen, 4, 2, 0.5))
        losses.append(m["loss"])
    losses = torch.stack(losses).tolist()
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    rec = dict(backend=backend, steps=cfg.iterations, size=LEARN_SIZE,
               first10=first, last10=last,
               ratio=last / first, seconds=time.perf_counter() - t0)
    log(f"trainer learns ({backend}): {rec}")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    check(last < LOSS_DROP * first,
          f"loss {first:.4f} → {last:.4f}, not below {LOSS_DROP}×")
    return rec


def pad_dead(splat, extra):
    """The splat with `extra` dead slots appended (zeros, unit rotation)."""
    import dataclasses
    import torch

    def pad(x):
        return torch.cat([x, x.new_zeros((extra,) + tuple(x.shape[1:]))])

    rot = pad(splat.rot_raw)
    rot[-extra:, 0] = 1.0
    return dataclasses.replace(
        splat, xyz=pad(splat.xyz), sh=pad(splat.sh),
        opacity_raw=pad(splat.opacity_raw), scale_raw=pad(splat.scale_raw),
        rot_raw=rot, alive=pad(splat.alive))


def reset_launches():
    """Every kernel wrapper's launch count to 0."""
    from comfy3d_tpu_torch.ops import gs_flat, gs_tile
    for fn in (gs_flat.composite_bins_fwd_rows,
               gs_flat.composite_bins_bwd_splats,
               gs_tile.composite_tiles_fwd_rows,
               gs_tile.composite_tiles_bwd_splats):
        fn.launches = 0


def read_launches():
    from comfy3d_tpu_torch.ops import gs_flat, gs_tile
    return {"gs_flat_fwd": gs_flat.composite_bins_fwd_rows.launches,
            "gs_flat_bwd": gs_flat.composite_bins_bwd_splats.launches,
            "gs_tile_fwd": gs_tile.composite_tiles_fwd_rows.launches,
            "gs_tile_bwd": gs_tile.composite_tiles_bwd_splats.launches}


def expect_launches(launches, backend, fwd, bwd, what):
    want = {k: 0 for k in launches}
    want[f"gs_{backend}_fwd"] = fwd
    want[f"gs_{backend}_bwd"] = bwd
    check(launches == want, f"{what}: launches {launches}, not {want}")


def train_full_width(dev, asset_dir, backend="flat", size=800, n=100_000,
                     n_views=4, clock_mhz=1980.0):
    """Phase 7 (and 10, with backend "tile"): bench.py's gs_train_step
    set-up on the card."""
    import numpy as np
    import torch
    from comfy3d_tpu_torch.algorithms import gs_trainer as T
    from comfy3d_tpu_torch.core.camera import Camera
    from comfy3d_tpu_torch.core.io.ply import load_gs_ply, save_gs_ply
    from comfy3d_tpu_torch.ops import gs_flat, gs_tile
    splat = pad_dead(make_splat(n, 0.01, 5, dev), DEAD_SLOTS)
    cams = Camera.from_orbit([0.0] * n_views, [0.0, 90.0, 180.0, 270.0],
                             2.2, width=size, height=size, device=dev)
    imgs = torch.as_tensor(np.random.RandomState(7).rand(
        n_views, size, size, 3).astype(np.float32), device=dev)
    masks = torch.ones((n_views, size, size), device=dev)
    cfg = T.GSTrainConfig(batch_size=1, backend=backend)
    step = T.make_train_step(cfg, cams, imgs, masks)
    holder = {"state": T.init_state(splat)}
    dead = ~splat.alive
    dead_before = {k: v[dead].clone() for k, v in
                   holder["state"].params.items()}
    gen = torch.Generator().manual_seed(3)

    def one_step():
        holder["state"], m = step(holder["state"],
                                  *T.draw_step_inputs(gen, n_views, 1, 0.5))
        return m

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    losses = [one_step()["loss"] for _ in range(10)]
    torch.cuda.synchronize()
    first10_s = time.perf_counter() - t0
    launches = read_launches()
    losses = torch.stack(losses).tolist()
    log(f"train path ({backend}): 10 steps at {size}²/{n} in "
        f"{first10_s * 1e3:.0f} ms (first calls), launches {launches}, "
        f"losses {losses}")
    expect_launches(launches, backend, 10, 10, f"10 {backend} train steps")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    state = holder["state"]
    check(all(torch.equal(state.params[k][dead], dead_before[k])
              for k in dead_before), "dead slots changed")

    times = {"train_step_ms": cuda_ms(one_step, 10)}
    width = gs_tile.rows_width(4) if backend == "tile" \
        else gs_flat.payload_width(4)      # SH colour (3) and depth
    prof = profile_frames(one_step, 3, rows=(splat.num_capacity, width))
    prof["device_idle_share"] = 1.0 - prof["device_busy_ms"] \
        / times["train_step_ms"]
    log(f"train step ({backend}) {times['train_step_ms']:.2f} ms; profile "
        f"{prof}")
    check(prof["index_add_launches"] == 0, f"the {backend} train step still "
          f"scatters with index_add_ ({prof['index_add_ms']:.3f} ms)")
    # the tile step's forward writes the backward's block itself; the flat
    # step gathers the payload once, for its backward
    check(prof["row_gathers"] == (0 if backend == "tile" else 1),
          f"the {backend} train step's row gathers: "
          f"{prof['row_gather_ops']}")

    # the backward kernel alone, on the trained splat's compositor inputs
    # for view 0; its launches here are not the path's
    cam0 = Camera.from_orbit(0.0, 0.0, 2.2, width=size, height=size,
                             device=dev)
    trained = holder["state"].to_splat()
    if backend == "flat":
        inp = flat_inputs(trained, cam0)
        fargs, _ = flat_kernel_args(inp, True)
        fwd = gs_flat.composite_bins_fwd_rows(*fargs)
        times["kernel_fwd_ms"] = cuda_ms(
            lambda: gs_flat.composite_bins_fwd_rows(*fargs), 20)
        box = flat_box_stats(inp, fwd[2])
        fwd_bound = flat_fwd_bound(inp, fwd[2], box)
        args, pair_args = bwd_args(inp, fwd, 11)
        kernel, plain = gs_flat.composite_bins_bwd_splats, \
            gs_flat.composite_bins_bwd_splats_plain
        bound = bwd_bound(inp, fwd[2])
        in_img = subtiles_in_image(inp)
        stops = torch.where(in_img, fwd[2], torch.zeros_like(fwd[2]))
        old = old_design(bound["pair_warps_live"], inp["C"],
                         stops.amax(-1), clock_mhz)
        new_walks = stops[in_img].float()
        cols = gs_flat.composite_bins_bwd_plain(*pair_args)
        rows, idx = cols[:, :inp["sprim"].numel()].t(), inp["sprim"]
    else:
        inp = tile_inputs(trained, cam0, cfg.max_per_tile)
        fwd = gs_tile.composite_tiles_fwd_rows(*tile_kernel_args(inp, True))
        times["kernel_fwd_ms"] = cuda_ms(
            lambda: gs_tile.composite_tiles_fwd_rows(
                *tile_kernel_args(inp, True)), 20)
        box = tile_box_stats(inp)
        fwd_bound = tile_fwd_bound(inp, box, keep_block=True)
        args, slot_args = tile_bwd_args(inp, fwd, 11)
        kernel, plain = gs_tile.composite_tiles_bwd_splats, \
            gs_tile.composite_tiles_bwd_splats_plain
        bound = tile_bwd_bound(inp)
        walks = torch.div(inp["counts"] + 127, 128, rounding_mode="floor")
        old = old_design(bound["slot_warps_live"], inp["C"], walks,
                         clock_mhz)
        new_walks = walks.float()
        cols = gs_tile.composite_tiles_bwd_plain(*slot_args)
        rows = cols.transpose(1, 2).reshape(-1, cols.shape[1])
        idx = inp["prim_idx"].reshape(-1)
    log(f"{backend} train view 0, forward kernel "
        f"{times['kernel_fwd_ms']:.4f} ms, bound {fwd_bound}, per-splat box "
        f"{box}")
    check_box(box, f"{backend} train view 0")
    old.update(new_walk_chunks_max=int(new_walks.max()),
               new_walk_chunks_mean=float(new_walks.mean()),
               new_ctas=new_walks.numel())
    times["kernel_bwd_ms"] = cuda_ms(lambda: kernel(*args), 20)
    times["plain_bwd_ms"] = cuda_ms(lambda: plain(*args), 3, warmup=1)
    # the old design's per-step scatter, on the plain per-slot columns
    times["old_scatter_ms"] = cuda_ms(
        lambda: scatter_columns(rows, idx, inp["n"], inp["C"]), 20)
    old["scatter_device_ms"] = profile_frames(
        lambda: scatter_columns(rows, idx, inp["n"], inp["C"]),
        3)["device_busy_ms"]
    log(f"{'K3' if backend == 'flat' else 'K5'} at {size}²/{n}: kernel "
        f"{times['kernel_bwd_ms']:.3f} ms, plain "
        f"{times['plain_bwd_ms']:.1f} ms, old scatter "
        f"{times['old_scatter_ms']:.3f} ms, bound {bound}, old design {old}")
    del cols, rows

    # densify and prune, opacity reset, GS-PLY round trip
    cap = splat.num_capacity
    noise = torch.randn((2, cap, 3), generator=gen).to(dev)
    state = T.make_densify_step(cfg)(holder["state"], noise[0], noise[1])
    state = T.reset_opacity(state)
    check(state.alive.shape[0] == cap and all(
        v.shape[0] == cap for v in state.params.values()),
        "capacity changed")
    check(all(bool(torch.isfinite(v).all()) for v in state.params.values()),
          "non-finite parameters after densify / reset")
    check(float(torch.sigmoid(state.params["opacity_raw"]).max()) <= 0.0101,
          "opacity reset left an opacity above 0.01")
    path = os.path.join(asset_dir, f"trained_100k_{backend}.ply")
    trained = state.to_splat()
    save_gs_ply(path, trained)
    back = load_gs_ply(path, device=dev)
    check(torch.equal(back.xyz, trained.xyz[trained.alive]),
          "trained splat changed through GS-PLY")
    rec = dict(backend=backend, splats=n, dead_slots=DEAD_SLOTS, size=size,
               views=n_views, batch=1, max_per_tile=cfg.max_per_tile,
               launches=launches, losses=losses,
               first_10_steps_s=first10_s,
               alive_after_densify=int(state.alive.sum()),
               ply_splats=back.num_capacity, old_design=old, box=box,
               fwd_bound=fwd_bound)
    return rec, times, prof, bound


# ------------------------------------------------------------------ #
# The per-16-px-tile compositor (phases 8-10)
# ------------------------------------------------------------------ #
def tile_inputs(splat, cam, max_per_tile):
    """The tile compositor's inputs for one camera, as `render_tiles` builds
    them: projection, SH colour, depth order, binning, tile-data gather."""
    import torch
    from comfy3d_tpu_torch.ops import binning
    from comfy3d_tpu_torch.ops import gs_render as G
    W, H = cam.width, cam.height
    means2d, depth, conic, radii, visible = G.project_gaussians(
        splat.xyz, splat.scale, splat.rotation, cam.w2c, cam.intrinsics,
        W, H)
    active = visible & splat.alive & (splat.opacity > G.ALPHA_MIN)
    chans = torch.cat([splat.colors_toward(cam.campos), depth[:, None]], -1)
    grid_h, grid_w = binning.num_tiles(H, W)
    order = torch.argsort(torch.where(active, depth, math.inf), stable=True)
    s_m2d, s_r = means2d[order], radii[order][:, None]
    bin_args = (s_m2d - s_r, s_m2d + s_r, active[order], grid_h, grid_w,
                max_per_tile)
    bins = binning.bin_primitives(*bin_args)
    gather_args = (s_m2d, conic[order], splat.opacity[order], chans[order],
                   bins.prim_idx, bins.valid)
    rows = G.tile_rows(*gather_args[:4])
    data = G._build_tile_data(*gather_args)
    return dict(data=data, rows=rows,
                counts=torch.clamp_max(bins.count, max_per_tile),
                prim_idx=bins.prim_idx, valid=bins.valid, n=means2d.shape[0],
                grid_w=grid_w, grid_h=grid_h, W=W, H=H, C=chans.shape[-1],
                overflow=bool(bins.overflow), bin_args=bin_args,
                gather_args=gather_args)


def tile_kernel_args(inp, keep_block):
    """K4′'s arguments (`composite_tiles_fwd_rows`) for this input."""
    return (inp["rows"], inp["prim_idx"], inp["valid"], inp["counts"],
            inp["grid_w"], inp["C"], keep_block)


def tile_plain(inp):
    """K4's plain version on this input: (acc, trans)."""
    from comfy3d_tpu_torch.ops import gs_tile
    return gs_tile.composite_tiles_fwd_plain(inp["data"], inp["counts"],
                                             inp["grid_w"], inp["C"])


def tile_to_image(acc, trans, inp):
    from comfy3d_tpu_torch.ops import binning
    geo = (inp["grid_h"], inp["grid_w"], inp["H"], inp["W"])
    img = binning.tiles_to_image(acc.transpose(1, 2), *geo)
    tr = binning.tiles_to_image(trans.transpose(1, 2), *geo)
    return img[..., :-1] + tr * 1.0         # rgb + (1 - alpha) · white


def tile_visits(inp, block=8192):
    """The walked slot-pixel visits of this input (slots below each tile's
    count × 256 pixels), of those the live ones (power ≤ 0, op·G ≥ 1/255)
    and of those the unsaturated ones (op·G < 0.99), evaluated with the
    kernels' operations; the walked slots; and slot_warps_live, the per-slot
    tile backward's warp reductions (walked slots × the 8 warps of 32
    pixels with a live lane)."""
    import torch
    from comfy3d_tpu_torch.ops.gs_tile import ALPHA_MAX, ALPHA_MIN, TILE
    data, counts = inp["data"], inp["counts"]
    dev = data.device
    m = data.shape[2]
    t, slot = (torch.arange(m, device=dev)[None, :]
               < counts[:, None]).nonzero(as_tuple=True)
    p = torch.arange(TILE * TILE, device=dev)
    live = unsat = warps_live = 0
    for lo in range(0, t.numel(), block):
        tt, ss = t[lo:lo + block], slot[lo:lo + block]
        cols = data[tt, :, ss]                          # [b, D]
        px = (p % TILE).float()[None, :] + 0.5 \
            + ((tt % inp["grid_w"]) * TILE).float()[:, None]
        py = torch.div(p, TILE, rounding_mode="floor").float()[None, :] \
            + 0.5 + (torch.div(tt, inp["grid_w"], rounding_mode="floor")
                     * TILE).float()[:, None]
        mx = cols[:, 0:1] - px
        my = cols[:, 1:2] - py
        a, b, c, op = (cols[:, i:i + 1] for i in (2, 3, 4, 5))
        power = -0.5 * (a * mx * mx + c * my * my) - b * mx * my
        raw = op * torch.exp(torch.clamp_max(power, 0.0))
        hit = (power <= 0.0) & (raw >= ALPHA_MIN)
        live += int(hit.sum())
        unsat += int((hit & (raw < ALPHA_MAX)).sum())
        warps_live += int(hit.reshape(-1, 8, 32).any(-1).sum())
    return dict(slots=t.numel(), visits=t.numel() * TILE * TILE, live=live,
                unsat=unsat, slot_warps_live=warps_live)


def tile_box_stats(inp, block=8192):
    """The per-splat box (`gs_tile.splat_box`) on this tile input: the
    share of warp-slots (walked slots × the 8 warps of two pixel rows) whose
    rectangle misses the box, the visits the box admits (32 per warp-slot
    that is not skipped), and the live visits (power ≤ 0, op·G ≥ 1/255, in
    the kernels' operations) whose pixel lies outside the box, which must
    be 0."""
    import torch
    from comfy3d_tpu_torch.ops import gs_tile
    from comfy3d_tpu_torch.ops.gs_tile import ALPHA_MIN, TILE
    data, counts = inp["data"], inp["counts"]
    dev = data.device
    m = data.shape[2]
    t, slot = (torch.arange(m, device=dev)[None, :]
               < counts[:, None]).nonzero(as_tuple=True)
    p = torch.arange(TILE * TILE, device=dev)
    w = torch.arange(8, device=dev).float()
    skipped = outside = 0
    for lo in range(0, t.numel(), block):
        tt, ss = t[lo:lo + block], slot[lo:lo + block]
        cols = data[tt, :, ss]                          # [b, D]
        box = gs_tile.splat_box(*(cols[:, i] for i in range(6)))
        ox = ((tt % inp["grid_w"]) * TILE).float()
        oy = (torch.div(tt, inp["grid_w"], rounding_mode="floor")
              * TILE).float()
        miss = gs_tile.box_misses(
            [b[:, None] for b in box], ox[:, None] + 0.5,
            ox[:, None] + 15.5, oy[:, None] + 2 * w + 0.5,
            oy[:, None] + 2 * w + 1.5)                  # [b, 8]
        skipped += int(miss.sum())
        px = (p % TILE).float()[None, :] + 0.5 + ox[:, None]
        py = torch.div(p, TILE, rounding_mode="floor").float()[None, :] \
            + 0.5 + oy[:, None]
        mx = cols[:, 0:1] - px
        my = cols[:, 1:2] - py
        a, b, c, op = (cols[:, i:i + 1] for i in (2, 3, 4, 5))
        power = -0.5 * (a * mx * mx + c * my * my) - b * mx * my
        raw = op * torch.exp(torch.clamp_max(power, 0.0))
        hit = (power <= 0.0) & (raw >= ALPHA_MIN)
        x0, x1, y0, y1 = (v[:, None] for v in box)
        inside = (x0 <= px) & (px <= x1) & (y0 <= py) & (py <= y1)
        outside += int((hit & ~inside).sum())
    warp_slots = t.numel() * 8
    return dict(warp_slots=warp_slots, warp_slots_skipped=skipped,
                skip_share=skipped / max(warp_slots, 1),
                box_visits=(warp_slots - skipped) * 32,
                live_outside_box=outside)


def flat_box_stats(inp, stops, block=16384):
    """`tile_box_stats` for a coarse-bin input (bin_px 32) and the stops of
    its forward: warp-slots are the walked (pair, sub-tile) footprint
    entries × 8 warps; the box is taken in the bin-local frame
    (mxl = μx − the bin's origin) the kernels stage, and a live visit
    there is op·G ≥ 1/255 (K1's test has no power ≤ 0)."""
    import torch
    from comfy3d_tpu_torch.ops import gs_tile
    from comfy3d_tpu_torch.ops.gs_flat import ALPHA_MIN, TILE
    data, C = inp["data"], inp["C"]
    g, t, q = pair_bins(inp)
    walk = walked_subtiles(inp, stops, t, q)
    dev = data.device
    p = torch.arange(TILE * TILE, device=dev)
    s = torch.arange(4, device=dev)
    sx0 = ((s % 2) * TILE).float()
    sy0 = (torch.div(s, 2, rounding_mode="floor") * TILE).float()
    px = (p % TILE).float()[None, :] + (sx0[:, None] + 0.5)     # [4, 256]
    py = torch.div(p, TILE, rounding_mode="floor").float()[None, :] \
        + (sy0[:, None] + 0.5)
    w = torch.arange(8, device=dev).float()
    entries = skipped = outside = 0
    for lo in range(0, g.numel(), block):
        sl = slice(lo, min(lo + block, g.numel()))
        tt = t[sl]
        mxl = data[0, sl] - ((tt % inp["nbx"]) * 2 * TILE).float()
        myl = data[1, sl] - (torch.div(tt, inp["nbx"], rounding_mode="floor")
                             * 2 * TILE).float()
        r = data[6 + C, sl]
        ov = walk[sl] & ((mxl[:, None] + r[:, None] > sx0)
                         & (mxl[:, None] - r[:, None] < sx0 + TILE)
                         & (myl[:, None] + r[:, None] > sy0)
                         & (myl[:, None] - r[:, None] < sy0 + TILE))
        a, b, c, op = (data[i, sl] for i in (2, 3, 4, 5))
        box = gs_tile.splat_box(mxl, myl, a, b, c, op)
        e3 = (slice(None), None, None)
        miss = gs_tile.box_misses(
            [v[e3] for v in box], sx0[None, :, None] + 0.5,
            sx0[None, :, None] + 15.5, sy0[None, :, None] + 2 * w + 0.5,
            sy0[None, :, None] + 2 * w + 1.5)          # [b, 4, 8]
        entries += int(ov.sum())
        skipped += int((miss & ov[..., None]).sum())
        dx = px - mxl[e3]
        dy = py - myl[e3]
        a, b, c, op = (x[e3] for x in (a, b, c, op))
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        raw = op * torch.exp(torch.clamp_max(power, 0.0))
        hit = ov[..., None] & (raw >= ALPHA_MIN)
        x0, x1, y0, y1 = (v[e3] for v in box)
        inside = (x0 <= px) & (px <= x1) & (y0 <= py) & (py <= y1)
        outside += int((hit & ~inside).sum())
    warp_slots = entries * 8
    return dict(warp_slots=warp_slots, warp_slots_skipped=skipped,
                skip_share=skipped / max(warp_slots, 1),
                box_visits=(warp_slots - skipped) * 32,
                live_outside_box=outside)


def check_box(box, what):
    """The per-splat box's gate: no live visit outside the box."""
    check(box["live_outside_box"] == 0,
          f"{what}: {box['live_outside_box']} live visits outside the box")


def _bound(in_bytes, out_bytes, ops, **counts):
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_OPS_S * 1e3
    return dict(counts, ops=ops, bytes=in_bytes + out_bytes,
                bound_ms=max(t_bytes, t_ops),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


# f32 comparisons of the per-splat box test, per warp-slot (box_misses)
BOX_TEST_OPS = 4


def _full_walk(ops):
    """The operations of the design that tests every walked visit, and
    their time at the f32 peak: kept beside a bound for reference only."""
    return dict(ops_full_walk=ops,
                bound_ms_full_walk=ops / PEAK_F32_OPS_S * 1e3)


def tile_fwd_bound(inp, box, keep_block=False):
    """The least time of K4′'s function, the tile forward with its row
    gather, on this input: bytes (the walked slots' indices and valid
    flags, the distinct splat rows they hold (6 + C values each) and the
    counts read, acc and trans written, and the walked slots' D-wide block
    columns when the block is kept, each once) against the f32 operations
    this input needs, counted from csrc/gs_tile_fwd.cu: 17 per visit the
    per-splat box admits (`box`, `tile_box_stats`: offsets, power, exp,
    raw, tests), 4 + 2C more per live one (α, α·T, acc, T), and the box
    test of every warp-slot (a visit outside the box is dead wherever its
    pixel lies, so it needs nothing more). Beside it, for reference only,
    the count of the full walk (17 per walked slot-pixel visit)."""
    import torch
    C, ntiles = inp["C"], inp["prim_idx"].shape[0]
    v = tile_visits(inp)
    walked = torch.arange(inp["prim_idx"].shape[1],
                          device=inp["counts"].device)[None, :] \
        < inp["counts"][:, None]
    splats = int(torch.unique(inp["prim_idx"][walked]).numel())
    block = v["slots"] * inp["rows"].shape[1] * 4 if keep_block else 0
    live_ops = (4 + 2 * C) * v["live"]
    return _bound(v["slots"] * 9 + splats * (6 + C) * 4 + ntiles * 4,
                  ntiles * (C + 1) * 256 * 4 + block,
                  17 * box["box_visits"] + live_ops
                  + BOX_TEST_OPS * box["warp_slots"],
                  splats_read=splats, block_kept=keep_block,
                  box_visits=box["box_visits"],
                  warp_slots=box["warp_slots"], **v,
                  **_full_walk(17 * v["visits"] + live_ops))


def flat_fwd_bound(inp, stops, box=None):
    """The least time of K1′'s function, the coarse-bin forward with its
    row gather, on this input (bin_px 32) and the stops of its run: bytes
    (the pairs' indices, the distinct splat rows they hold (7 + C values
    each) and the bounds read, acc, trans and stops written, each once)
    against the f32 operations this input needs: 20 + 2C per footprint
    visit the per-splat box admits (`box`, `flat_box_stats` for these
    stops, computed when not given) and the box test of every footprint
    warp-slot. Beside it, for reference only, the count of the full walk
    (20 + 2C per footprint visit, `visits`: pairs of the composited chunks
    whose 3σ square meets a sub-tile, × 256 pixels)."""
    import torch
    C = inp["C"]
    if box is None:
        box = flat_box_stats(inp, stops)
    nbins = inp["nbx"] * inp["nby"]
    nsub = (inp["bin_px"] // 16) ** 2
    pairs = int(inp["bounds"][-1])
    splats = int(torch.unique(inp["sprim"][:pairs]).numel())
    v = visits(inp, stops)
    return _bound(pairs * 8 + splats * (7 + C) * 4 + (nbins + 1) * 4,
                  nbins * nsub * ((C + 1) * 256 * 4 + 4),
                  (20 + 2 * C) * box["box_visits"]
                  + BOX_TEST_OPS * box["warp_slots"],
                  visits=v, box_visits=box["box_visits"],
                  warp_slots=box["warp_slots"], splats_read=splats,
                  **_full_walk((20 + 2 * C) * v))


def tile_bwd_bound(inp):
    """The least time of K5's function, the tile backward with its
    per-splat scatter, on this input: bytes (the walked slots' 6 + C rows,
    splat indices and valid flags, counts, trans, g_acc and g_trans read,
    the [n, 6 + C] per-splat rows written, each once) against f32
    operations counted from the kernel's arithmetic: 17 per visit, 11 + 4C
    more per live one (one_m, log1p, log T, clamp, exp, α·T, chan·g, d chan
    and its sum, S), 35 more per unsaturated one (dα, d power, d μ, d conic,
    d op and their sums), and 6 + C adds per walked slot."""
    C = inp["C"]
    ntiles = inp["data"].shape[0]
    v = tile_visits(inp)
    return _bound(v["slots"] * ((6 + C) * 4 + 8 + 1) + ntiles * 4
                  + ntiles * (C + 2) * 256 * 4, inp["n"] * (6 + C) * 4,
                  17 * v["visits"] + (11 + 4 * C) * v["live"]
                  + 35 * v["unsat"] + (6 + C) * v["slots"], **v)


def old_design(reductions, nchan, walks, clock_mhz):
    """The per-slot design's backward kernels reduce each slot's 6 + C
    sums per warp with 5 warp shuffles each: their shuffles on this input
    and the least time the card takes to issue them (one shuffle per clock
    per SM, 132 SMs, at `clock_mhz`, nvidia-smi's clocks.max.sm), beside
    the CTAs' walk lengths in 128-slot chunks."""
    shuffles = reductions * (6 + nchan) * 5
    walks = walks.float()
    return dict(warp_reductions=reductions, shuffles=shuffles,
                shuffle_bound_ms=shuffles / (132 * clock_mhz * 1e6) * 1e3,
                sm_clock_max_mhz=clock_mhz, ctas=walks.numel(),
                walk_chunks_max=int(walks.max()),
                walk_chunks_mean=float(walks.mean()))


def scatter_columns(rows, idx, n, nchan):
    """The per-slot design's per-step scatter: per-slot (or per-pair) rows
    [S, D] added per splat by four `index_add_`s, as `_CompositeTiles` /
    `_CompositeFlat.backward` did."""
    def one(r):
        return r.new_zeros((n,) + r.shape[1:]).index_add_(0, idx, r)
    return (one(rows[:, 0:2]), one(rows[:, 2:5]), one(rows[:, 5]),
            one(rows[:, 6:6 + nchan]))


def tile_kernel_vs_plain(label, inp):
    """K4′ against its plain version on the gathered block: acc/trans max
    abs error and the image's PSNR; and the block K4′ writes for the
    backward against the gathered one on every slot below each tile's
    count (equal), finite and with opacity 0 from there to the end of the
    last walked chunk (the kernel writes zeros)."""
    import torch
    from comfy3d_tpu_torch.ops import gs_tile
    acc, tr, block = gs_tile.composite_tiles_fwd_rows(
        *tile_kernel_args(inp, True))
    torch.cuda.synchronize()
    p_acc, p_tr = tile_plain(inp)
    err_acc = float((acc - p_acc).abs().max())
    err_tr = float((tr - p_tr).abs().max())
    plain_img = tile_to_image(p_acc, p_tr, inp)
    db = psnr(tile_to_image(acc, tr, inp), plain_img)
    m = block.shape[2]
    slot = torch.arange(m, device=block.device)[None, :]
    below = slot < inp["counts"][:, None]
    tail = ~below & (slot < (inp["counts"][:, None] + 127) // 128 * 128)
    block_equal = bool(torch.equal(block.transpose(1, 2)[below],
                                   inp["data"].transpose(1, 2)[below]))
    tail_cols = block.transpose(1, 2)[tail]
    tail_zero = not bool(tail_cols[:, 5].any()) \
        and bool(torch.isfinite(tail_cols).all())
    rec = dict(max_abs_err_acc=err_acc, max_abs_err_trans=err_tr,
               psnr_db=db, walked_slots=int(inp["counts"].sum()),
               max_count=int(inp["counts"].max()),
               max_per_tile=m, overflow=inp["overflow"],
               block_equal_below_count=block_equal,
               block_tail_transparent=tail_zero)
    log(f"tile {label}: {rec}")
    check(bool(torch.isfinite(acc).all()) and bool(torch.isfinite(tr).all()),
          f"tile {label}: non-finite")
    check(err_acc <= TOL_ABS and err_tr <= TOL_ABS,
          f"tile {label}: acc err {err_acc}, trans err {err_tr} > {TOL_ABS}")
    check(db >= TOL_PSNR_DB, f"tile {label}: PSNR {db:.2f} dB < "
          f"{TOL_PSNR_DB}")
    check(block_equal, f"tile {label}: K4′'s block differs from the gather")
    check(tail_zero, f"tile {label}: K4′'s block past the count (to the end "
          f"of the last walked chunk) is not finite with opacity 0")
    return rec, (acc, tr, block), plain_img


def tile_bwd_args(inp, fwd, seed):
    """K5′'s arguments (`composite_tiles_bwd_splats`) for a forward kernel's
    (acc, trans, block), fed the block K4′ wrote, with cotangents drawn
    from a seeded generator on the card; and the per-slot plain function's
    (`composite_tiles_bwd_plain`) for the same inputs on the gathered
    block."""
    import torch
    acc, trans, block = fwd
    gen = torch.Generator(device=acc.device).manual_seed(seed)
    g_acc = torch.randn(acc.shape, generator=gen, device=acc.device)
    g_trans = torch.randn(trans.shape, generator=gen, device=acc.device)
    return ((block, inp["counts"], inp["prim_idx"], inp["valid"],
             inp["n"], inp["grid_w"], trans, g_acc, g_trans, inp["C"]),
            (inp["data"], inp["counts"], inp["grid_w"], trans, g_acc,
             g_trans, inp["C"]))


def tile_bwd_vs_plain(label, inp, fwd, seed):
    """K5′, fed K4′'s block, against its plain version on the gathered
    block (`splat_rows_vs_plain`)."""
    import torch
    from comfy3d_tpu_torch.ops import gs_tile
    args, slot_args = tile_bwd_args(inp, fwd, seed)
    k = gs_tile.composite_tiles_bwd_splats(*args)
    torch.cuda.synchronize()
    p = gs_tile.composite_tiles_bwd_splats_plain(inp["data"], *args[1:])
    rows, idx = walked_slot_rows(
        inp, gs_tile.composite_tiles_bwd_plain(*slot_args))
    return splat_rows_vs_plain(f"tile {label}", k, p, rows, idx)


def tile_cap_below_chunk(parity_scene):
    """`render_arrays(backend="tile", max_per_tile=64, chunk=8)` on the
    card, whose lists the renderer pads to the kernels' 128-slot chunks,
    against the same call with the plain versions in place of the two
    kernel wrappers, on the same inputs (the parity scene, its scales made
    anisotropic): outputs and the gradients of a seeded random cotangent,
    with the kernels' launch counts."""
    import torch
    from comfy3d_tpu_torch.ops import gs_tile
    from comfy3d_tpu_torch.ops import gs_render as G
    max_per_tile, chunk = 64, 8
    p_splat, p_cam = parity_scene
    w2c = p_cam.w2c.reshape(-1, 4, 4)[0]
    intr = p_cam.intrinsics.reshape(-1, 4)[0]
    W, H = p_cam.width, p_cam.height
    gen = torch.Generator(device=w2c.device).manual_seed(9)
    # the scene's scales made anisotropic, so the rotations take gradients
    leaves = [x.detach().clone() for x in (
        p_splat.xyz, p_splat.scale * (0.5 + torch.rand(
            p_splat.scale.shape, generator=gen, device=w2c.device)),
        p_splat.rotation, p_splat.opacity,
        p_splat.colors_toward(p_cam.campos.reshape(-1, 3)[0]))]
    cot = {k: torch.rand(shape, generator=gen, device=w2c.device)
           for k, shape in (("image", (H, W, 3)), ("alpha", (H, W)),
                            ("depth", (H, W)))}

    def run():
        xs = [x.clone().requires_grad_() for x in leaves]
        out = G.render_arrays(*xs, p_splat.alive, w2c, intr, W, H,
                              backend="tile", max_per_tile=max_per_tile,
                              chunk=chunk)
        sum((out[k] * c).sum() for k, c in cot.items()).backward()
        return out, [x.grad for x in xs]

    torch.cuda.synchronize()
    reset_launches()
    out, grads = run()
    torch.cuda.synchronize()
    launches = read_launches()
    kernels = (gs_tile.composite_tiles_fwd_rows,
               gs_tile.composite_tiles_bwd_splats)
    gs_tile.composite_tiles_fwd_rows = gs_tile.composite_tiles_fwd_rows_plain
    gs_tile.composite_tiles_bwd_splats = \
        gs_tile.composite_tiles_bwd_splats_plain
    try:
        ref, ref_grads = run()
    finally:
        (gs_tile.composite_tiles_fwd_rows,
         gs_tile.composite_tiles_bwd_splats) = kernels
    expect_launches(launches, "tile", 1, 1, f"the tile path at "
                    f"max_per_tile={max_per_tile}, chunk={chunk}")
    rec = {"max_per_tile": max_per_tile, "chunk": chunk,
           "launches": launches, "size": [W, H],
           "splats": int(leaves[0].shape[0]),
           "overflow": bool(out["overflow"])}
    for k in ("image", "alpha", "depth"):
        a, b = out[k].detach(), ref[k].detach()
        scale = max(1.0, float(b.abs().max()))
        rec[f"{k}_max_abs_err"] = float((a - b).abs().max())
        check(rec[f"{k}_max_abs_err"] <= TOL_ABS * scale,
              f"tile cap {max_per_tile}: {k} err {rec[k + '_max_abs_err']}")
    for name, g, r in zip(("xyz", "scale", "rotation", "opacity", "colors"),
                          grads, ref_grads):
        check(bool(r.abs().max() > 0), f"tile cap: d {name} is all zero")
        rec[f"d_{name}_rel_err"] = float((g - r).abs().max()
                                         / r.abs().max())
        check(rec[f"d_{name}_rel_err"] <= TOL_BWD_REL,
              f"tile cap {max_per_tile}: d {name} rel err "
              f"{rec['d_' + name + '_rel_err']} > {TOL_BWD_REL}")
    # the cap bites: some tile held more splats than it keeps
    check(rec["overflow"], f"no tile list reached {max_per_tile}")
    log(f"tile path at max_per_tile={max_per_tile}, chunk={chunk} (lists "
        f"padded to {gs_tile.CHUNK} slots), kernels vs plain: {rec}")
    return rec


def tile_render_path(dev, splat, cams, cam0, flat_imgs, parity_scene):
    """Phase 9: the tile render path, 8 views at 800², M = 1024 (the sizes
    are read from `splat` and `cams`)."""
    import torch
    from comfy3d_tpu_torch.ops import gs_tile
    from comfy3d_tpu_torch.ops import gs_render as G
    kw = dict(backend="tile", max_per_tile=1024)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = G.render(splat, cams, **kw)
    torch.cuda.synchronize()
    render8_s = time.perf_counter() - t0
    launches = read_launches()
    log(f"tile render path: {cams.batch_shape} views in "
        f"{render8_s * 1e3:.1f} ms (first call), launches {launches}")
    nview, size = cams.batch_shape[0], cams.height
    expect_launches(launches, "tile", nview, 0, f"{nview} tile views")
    img, alpha = out["image"], out["alpha"]
    check(tuple(img.shape) == (nview, size, cams.width, 3),
          f"image shape {img.shape}")
    check(bool(torch.isfinite(img).all()) and bool(
        torch.isfinite(alpha).all()) and bool(
        torch.isfinite(out["depth"]).all()), "non-finite tile output")
    mean_alpha = float(alpha.mean())
    check(0.0 < mean_alpha < 1.0, f"tile mean alpha {mean_alpha}")
    vs_flat = [psnr(img[i], flat_imgs[i]) for i in range(nview)]
    # bench.py::bench_render_parity_psnr's scene: tile vs coarse-bin
    p_splat, p_cam = parity_scene
    parity_db = psnr(G.render(p_splat, p_cam, **dict(kw, max_per_tile=512))
                     ["image"], G.render(p_splat, p_cam)["image"])
    log(f"tile vs flat PSNR per view {vs_flat}; 20k/256² parity "
        f"{parity_db:.2f} dB")
    check(parity_db >= TOL_TILE_FLAT_DB, f"tile vs flat on the parity "
          f"scene: {parity_db:.2f} dB < {TOL_TILE_FLAT_DB}")
    cap_64 = tile_cap_below_chunk(parity_scene)

    inp = tile_inputs(splat, cam0, 1024)
    kargs = tile_kernel_args(inp, False)
    times = {
        "frame_ms": cuda_ms(lambda: G.render(splat, cam0, **kw), 20),
        "kernel_fwd_ms": cuda_ms(
            lambda: gs_tile.composite_tiles_fwd_rows(*kargs), 20),
        "plain_fwd_ms": cuda_ms(
            lambda: gs_tile.composite_tiles_fwd_rows_plain(*kargs), 3,
            warmup=1),
        "bin_primitives_ms": cuda_ms(
            lambda: G.binning.bin_primitives(*inp["bin_args"]), 20),
        # the gather K4′ took in (`_build_tile_data`), for reference
        "old_gather_ms": cuda_ms(
            lambda: G._build_tile_data(*inp["gather_args"]), 20),
        "prep_ms": cuda_ms(lambda: tile_inputs(splat, cam0, 1024), 20),
        "render_8_views_ms": cuda_ms(lambda: G.render(splat, cams, **kw), 5),
    }
    log(f"tile times at 800²/100k: {times}")
    prof = profile_frames(lambda: G.render(splat, cam0, **kw), 5,
                          rows=tuple(inp["rows"].shape))
    prof["device_idle_share"] = 1.0 - prof["device_busy_ms"] \
        / times["frame_ms"]
    log(f"profile of one tile frame: {prof}")
    check(prof["row_gathers"] == 0, f"the tile frame still gathers splat "
          f"rows: {prof['row_gather_ops']}")
    box = tile_box_stats(inp)
    log(f"tile render view 0, per-splat box: {box}")
    check_box(box, "tile render view 0")
    rec = dict(views=nview, size=size, splats=splat.num_capacity,
               max_per_tile=1024,
               launches=launches, mean_alpha=mean_alpha,
               overflow_views=int(out["overflow"].sum()),
               vs_flat_psnr_db=vs_flat, parity_20k_256_psnr_db=parity_db,
               first_call_8_views_s=render8_s, box=box,
               cap_64_chunk_8=cap_64)
    return rec, times, prof, tile_fwd_bound(inp, box)


# ------------------------------------------------------------------ #
# TripoSR image → mesh (phase 11)
# ------------------------------------------------------------------ #
TOL_TRIPOSR_REL = 1e-3   # card vs CPU, of the largest value, TF32 off
TOL_MESH_V = 1e-5        # analytic mesh, card vs CPU
PROBES = 32768
CPU_LAYERS = 2           # ViT and backbone layers of the card-vs-CPU check
MESH_RES = 256           # extract_mesh's resolution (bumped to 257)
ANALYTIC_RES = 257       # the analytic sphere's lattice
RENDER_PX = 128          # the orbit render's size


def rel_err(a, b):
    """max |a - b| over max |b|, with b on the CPU."""
    a = a.detach().float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def sphere_density(pts):
    """0.5 − |p|: a sphere of radius 0.5, positive inside, in separate
    elementwise operations so every device rounds alike. The square root
    is taken in float64: PyTorch's CUDA float32 `sqrt` differs from the
    CPU's correctly rounded one by an ulp on 0.6 % of uniform inputs in
    [0, 1) (measured on an H100)."""
    import torch
    x, y, z = pts.unbind(-1)
    return 0.5 - torch.sqrt((x * x + y * y + z * z).double()).float()


def mesh_area(v, f):
    a, b, c = (v[f[:, i].long()] for i in range(3))
    return float(0.5 * (b - a).cross(c - a, dim=-1).norm(dim=-1).sum())


def profile_spans(fn, names):
    """One call of fn under torch.profiler: its wall seconds and, for each
    `record_function` span in `names`, the host ms the span lasted and the
    device ms of the kernels launched inside it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0))

    spans = {}
    for name in names:
        evs = [e for e in prof.events()
               if e.name == name and e.device_type == DeviceType.CPU]
        spans[name] = {"calls": len(evs),
                       "host_ms": sum(e.cpu_time_total for e in evs) / 1e3,
                       "device_ms": sum(dev_us(e) for e in evs) / 1e3}
    return out, wall_s, spans


def triposr_path(dev, asset_dir, smi_line):
    """Phase 11, at `TripoSRConfig()`'s widths."""
    import dataclasses
    import warnings

    import numpy as np
    import torch
    from comfy3d_tpu_torch.core.camera import Camera
    from comfy3d_tpu_torch.core.mesh import Mesh
    from comfy3d_tpu_torch.models.triposr import (TripoSRConfig,
                                                  TripoSRPipeline)
    from comfy3d_tpu_torch.models.triposr.pipeline import EXTRACT_STAGES
    from comfy3d_tpu_torch.ops import tetra, volume

    cfg = TripoSRConfig()
    r = cfg.radius
    s = cfg.cond_image_size
    rec = {"card": smi_line, "config": dataclasses.asdict(cfg), "seed": 0}
    img = np.random.RandomState(0).rand(1, s, s, 3).astype(np.float32)
    probe_np = np.random.RandomState(2).uniform(
        -r, r, (PROBES, 3)).astype(np.float32)
    cpu = torch.device("cpu")

    # a. the card against the port's CPU path, TF32 off
    t0 = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    small = dataclasses.replace(cfg, vit_layers=CPU_LAYERS,
                                num_layers=CPU_LAYERS)
    th = time.perf_counter()
    host = TripoSRPipeline.init_random(0, small, device=cpu)
    with torch.no_grad():
        h_codes = host.scene_codes(img)
        h_sig, h_rgb = host.model.query(h_codes[0], torch.as_tensor(probe_np))
    host_s = time.perf_counter() - th
    del host
    card = TripoSRPipeline.init_random(0, small, device=dev)
    with torch.no_grad():
        c_codes = card.scene_codes(img)
        c_sig, c_rgb = card.model.query(c_codes[0],
                                        torch.as_tensor(probe_np, device=dev))
    del card
    parity = {"layers": CPU_LAYERS, "host_s": host_s,
              "codes_rel_err": rel_err(c_codes, h_codes),
              "sigma_rel_err": rel_err(c_sig, h_sig),
              "rgb_rel_err": rel_err(c_rgb, h_rgb),
              "codes_shape": list(c_codes.shape)}
    log(f"triposr a. card vs CPU ({CPU_LAYERS}+{CPU_LAYERS} layers, TF32 "
        f"off; host {host_s:.1f} s): {parity}")
    check(tuple(c_codes.shape) == (1, 3, cfg.triplane_channels,
                                   2 * cfg.plane_size, 2 * cfg.plane_size),
          f"scene codes {tuple(c_codes.shape)}")
    for k in ("codes", "sigma", "rgb"):
        check(parity[f"{k}_rel_err"] <= TOL_TRIPOSR_REL,
              f"triposr {k}: card vs CPU {parity[k + '_rel_err']:.3g} of "
              f"the largest value")
    rec["card_vs_cpu"] = parity
    rec["a_s"] = time.perf_counter() - t0

    # b. full depth: scene codes by CUDA events, peak memory
    t0 = time.perf_counter()
    pipe = TripoSRPipeline.init_random(0, cfg, device=dev)
    init_s = time.perf_counter() - t0
    img_dev = torch.as_tensor(img, device=dev)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in pipe.model.parameters())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    codes_ms = cuda_ms(lambda: pipe.scene_codes(img_dev), 5, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        codes_tf32_ms = cuda_ms(lambda: pipe.scene_codes(img_dev), 5,
                                warmup=1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    codes = pipe.scene_codes(img_dev)
    check(bool(torch.isfinite(codes).all()), "non-finite scene codes")
    rec["scene_codes"] = {
        "ms": codes_ms, "ms_tf32": codes_tf32_ms, "init_s": init_s,
        "peak_bytes": peak, "weight_bytes": weight_bytes,
        "params": sum(p.numel() for p in pipe.model.parameters())}
    log(f"triposr b. full depth: {rec['scene_codes']}")
    rec["b_s"] = time.perf_counter() - t0

    # c. an analytic sphere at 257³, card against CPU
    t0 = time.perf_counter()
    analytic = {}
    for d in (dev, cpu):
        torch.cuda.synchronize()
        ta = time.perf_counter()
        grid = volume.decode_grid(sphere_density, ANALYTIC_RES, r, iso=0.0,
                                  device=d)
        torch.cuda.synchronize()
        tb = time.perf_counter()
        v, f, nv, nf = tetra.extract_isosurface_device(
            grid, iso=0.0, bounds=(-r, r), max_tris=2_000_000,
            on_overflow="raise")
        torch.cuda.synchronize()
        analytic[d.type] = dict(v=v[:nv].cpu(), f=f[:nf].cpu(), nv=nv, nf=nf,
                                decode_s=tb - ta,
                                sweep_weld_s=time.perf_counter() - tb)
        del grid
    a, b = analytic[dev.type], analytic["cpu"]
    area = mesh_area(a["v"], a["f"])
    sphere = {"nv": a["nv"], "nf": a["nf"], "cpu_nv": b["nv"],
              "cpu_nf": b["nf"], "area": area,
              "area_rel_err": abs(area - math.pi) / math.pi,
              "decode_s": a["decode_s"], "sweep_weld_s": a["sweep_weld_s"],
              "cpu_decode_s": b["decode_s"],
              "cpu_sweep_weld_s": b["sweep_weld_s"]}
    check((a["nv"], a["nf"]) == (b["nv"], b["nf"]),
          f"analytic mesh counts: card {a['nv']}/{a['nf']}, CPU "
          f"{b['nv']}/{b['nf']}")
    check(torch.equal(a["f"], b["f"]), "analytic mesh: faces differ")
    sphere["v_max_abs_err"] = float((a["v"] - b["v"]).abs().max())
    check(sphere["v_max_abs_err"] <= TOL_MESH_V,
          f"analytic mesh vertices: {sphere['v_max_abs_err']:.3g}")
    check(sphere["area_rel_err"] <= 0.01, f"analytic area {area:.5f}")
    log(f"triposr c. analytic sphere at {ANALYTIC_RES}³: {sphere}")
    rec["analytic_sphere"] = sphere
    del analytic, a, b
    rec["c_s"] = time.perf_counter() - t0

    # d. image → mesh at full width
    t0 = time.perf_counter()
    with torch.no_grad():
        sig = pipe.model.query(codes[0], torch.as_tensor(probe_np,
                                                         device=dev))[0]
    threshold = float(np.quantile(sig.cpu().numpy(), 0.98))
    kw = dict(resolution=MESH_RES, threshold=threshold,
              max_tris=2_000_000, on_overflow="warn", with_color=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pipe.extract_mesh(codes[0], **kw)                     # warm-up
        torch.cuda.synchronize()
        tm = time.perf_counter()
        mesh = pipe.extract_mesh(codes[0], **kw)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - tm
        # the split: the spans of one more call, profiled
        _, profiled_s, spans = profile_spans(
            lambda: pipe.extract_mesh(codes[0], **kw), EXTRACT_STAGES)
    overflow = [str(w.message) for w in caught if "overflow" in
                str(w.message)]
    check(all(sp["calls"] == 1 for sp in spans.values()),
          f"extract_mesh's spans: {spans}")
    res = MESH_RES + 1 if volume.hier_plan(MESH_RES) is None else MESH_RES
    check(mesh.num_vertices > 0 and mesh.num_faces > 0, "empty mesh")
    check(bool(np.isfinite(mesh.v).all()) and
          np.abs(mesh.v).max() <= r + 1e-5, "mesh vertices off the box")
    check(int(mesh.f.max()) < mesh.num_vertices, "faces past the vertices")
    check(mesh.vc is not None and mesh.vc.shape == mesh.v.shape,
          "no vertex colours")
    glb = os.path.join(asset_dir, "triposr_mesh.glb")
    mesh.write(glb)
    back = Mesh.load(glb)
    check(np.array_equal(back.v, mesh.v) and np.array_equal(back.f, mesh.f),
          "GLB round trip changed the mesh")
    rec["image_to_mesh"] = {
        "resolution": res, "threshold": threshold, "max_tris": 2_000_000,
        "nv": mesh.num_vertices, "nf": mesh.num_faces,
        "overflow": bool(overflow), "overflow_warnings": overflow,
        "total_s": total_s, "profiled_total_s": profiled_s,
        "stages": {k.split(".")[-1]: v for k, v in spans.items()},
        "glb_bytes": os.path.getsize(glb)}
    log(f"triposr d. image → mesh at {res}³: {rec['image_to_mesh']}")
    rec["d_s"] = time.perf_counter() - t0

    # e. one orbit render
    t0 = time.perf_counter()
    cam = Camera.from_orbit(0.0, 30.0, 1.9, fovy_deg=40.0, width=RENDER_PX,
                            height=RENDER_PX, device=dev)
    out = pipe.render(codes[0], cam)
    rgb, alpha = out["rgb"], out["alpha"]
    check(tuple(rgb.shape) == (RENDER_PX, RENDER_PX, 3),
          f"render shape {tuple(rgb.shape)}")
    check(all(bool(torch.isfinite(out[k]).all()) for k in out),
          "non-finite render")
    check(float(alpha.min()) >= 0.0 and float(alpha.max()) <= 1.0 + 1e-6,
          f"alpha in [{float(alpha.min())}, {float(alpha.max())}]")
    torch.cuda.synchronize()
    rec["render"] = {"px": RENDER_PX, "mean_alpha": float(alpha.mean()),
                     "s": time.perf_counter() - t0}
    log(f"triposr e. {RENDER_PX}² render: {rec['render']}")
    rec["e_s"] = rec["render"]["s"]
    return rec


# ------------------------------------------------------------------ #
# InstantMesh posed views → mesh (phase 12)
# ------------------------------------------------------------------ #
TOL_IM_REL = 1e-3        # card vs CPU, of the largest value, TF32 off
IM_AZIMUTHS = (30.0, 90.0, 150.0, 210.0, 270.0, 330.0)
IM_ELEVATIONS = (20.0, -10.0, 20.0, -10.0, 20.0, -10.0)
IM_SIZE = 320            # the six views' size
IM_SPHERE_RES = 97       # the deformed analytic sphere's lattice
IM_RESOLUTIONS = (96, 129)   # extract_mesh: the bench's and the default


def deformed_sphere(res, scale):
    """The res³ lattice over the ±scale box, each vertex moved by a smooth
    field of up to a quarter cell, and a radius-0.6 sphere's SDF (> 0
    inside) at the moved vertices: numpy float32 from float64, so every
    device gets the same inputs."""
    from comfy3d_tpu_torch.ops import tetra
    import numpy as np
    verts = tetra.grid_vertices(res) * scale
    p = verts.astype(np.float64)
    d = 0.25 * (2 * scale / (res - 1)) * np.stack(
        [np.sin(3 * p[:, 1] + 1), np.sin(3 * p[:, 2] + 2),
         np.sin(3 * p[:, 0] + 3)], -1)
    v_def = (verts + d.astype(np.float32)).astype(np.float32)
    sdf = 0.6 - np.linalg.norm(v_def.astype(np.float64), axis=-1)
    return v_def, sdf.astype(np.float32)


class count_calls:
    """Counts the calls of `module.name` while the block runs."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def counted(*args, **kw):
            self.calls += 1
            return self.real(*args, **kw)
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def instantmesh_path(dev, asset_dir, smi_line):
    """Phase 12, at `InstantMeshConfig()`'s widths (`bench.py::
    bench_instantmesh_wallclock`'s set-up). Returns (record, the 96³
    mesh)."""
    import dataclasses
    import warnings

    import numpy as np
    import torch
    from comfy3d_tpu_torch.core.mesh import Mesh
    from comfy3d_tpu_torch.models.instantmesh import (
        InstantMeshConfig, InstantMeshPipeline, orbit_poses_to_input_cameras)
    from comfy3d_tpu_torch.models.instantmesh.pipeline import EXTRACT_STAGES
    from comfy3d_tpu_torch.ops import tetra

    cfg = InstantMeshConfig()
    half = cfg.grid_scale * 0.5
    rec = {"card": smi_line, "config": dataclasses.asdict(cfg), "seed": 0,
           "views": len(IM_AZIMUTHS), "size": IM_SIZE}
    imgs = np.random.RandomState(1).rand(1, len(IM_AZIMUTHS), IM_SIZE,
                                         IM_SIZE, 3).astype(np.float32)
    cams = orbit_poses_to_input_cameras(np.array(IM_AZIMUTHS),
                                        np.array(IM_ELEVATIONS))[None]
    probe = torch.as_tensor(np.random.RandomState(2).uniform(
        -half, half, (PROBES, 3)).astype(np.float32))
    cpu = torch.device("cpu")

    # a. the card against the port's CPU path, TF32 off
    t0 = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    small = dataclasses.replace(cfg, vit_layers=CPU_LAYERS,
                                transformer_layers=CPU_LAYERS)
    outs = {}
    for d in (cpu, dev):
        th = time.perf_counter()
        pipe = InstantMeshPipeline.init_random(0, small, device=d)
        with torch.no_grad():
            planes = pipe.forward_planes(imgs, cams)
            sdf, deform = pipe.model.query_geometry(planes[0], probe.to(d))
            rgb = pipe.model.query_color(planes[0], probe.to(d))
        outs[d.type] = dict(planes=planes, sdf=sdf, deform=deform, rgb=rgb,
                            s=time.perf_counter() - th)
        del pipe
    h, c = outs["cpu"], outs[dev.type]
    parity = {"layers": CPU_LAYERS, "host_s": h["s"],
              "planes_shape": list(c["planes"].shape)}
    for k in ("planes", "sdf", "deform", "rgb"):
        parity[f"{k}_rel_err"] = rel_err(c[k], h[k])
    log(f"instantmesh a. card vs CPU ({CPU_LAYERS}+{CPU_LAYERS} layers, "
        f"TF32 off): {parity}")
    lo = cfg.triplane_low_res
    check(tuple(c["planes"].shape) == (1, 3, cfg.triplane_dim, 2 * lo,
                                       2 * lo),
          f"planes {tuple(c['planes'].shape)}")
    for k in ("planes", "sdf", "deform", "rgb"):
        check(parity[f"{k}_rel_err"] <= TOL_IM_REL,
              f"instantmesh {k}: card vs CPU {parity[k + '_rel_err']:.3g} "
              f"of the largest value")
    rec["card_vs_cpu"] = parity
    del outs, h, c
    rec["a_s"] = time.perf_counter() - t0

    # b. full depth: forward_planes by CUDA events, peak memory
    t0 = time.perf_counter()
    pipe = InstantMeshPipeline.init_random(0, cfg, device=dev)
    init_s = time.perf_counter() - t0
    imgs_dev = torch.as_tensor(imgs, device=dev)
    cams_dev = torch.as_tensor(cams, device=dev)
    params = sum(p.numel() for p in pipe.model.parameters())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    planes_ms = cuda_ms(lambda: pipe.forward_planes(imgs_dev, cams_dev), 5,
                        warmup=1)
    peak = torch.cuda.max_memory_allocated()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        planes_tf32_ms = cuda_ms(
            lambda: pipe.forward_planes(imgs_dev, cams_dev), 5, warmup=1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    planes = pipe.forward_planes(imgs_dev, cams_dev)
    check(bool(torch.isfinite(planes).all()), "non-finite triplanes")
    rec["forward_planes"] = {
        "ms": planes_ms, "ms_tf32": planes_tf32_ms, "init_s": init_s,
        "peak_bytes": peak, "params": params,
        "weight_bytes": sum(p.numel() * p.element_size()
                            for p in pipe.model.parameters())}
    log(f"instantmesh b. full depth: {rec['forward_planes']}")
    rec["b_s"] = time.perf_counter() - t0

    # c. marching tets over a deformed lattice + weld, card against CPU
    t0 = time.perf_counter()
    v_def, sdf = deformed_sphere(IM_SPHERE_RES, half)
    swept = {}
    for d in (dev, cpu):
        torch.cuda.synchronize()
        ta = time.perf_counter()
        soup, count, ovf = tetra.marching_tets_deformed(
            torch.as_tensor(v_def, device=d), torch.as_tensor(sdf, device=d),
            IM_SPHERE_RES, max_tris=262_144)
        v, f, nv, nf, v_ovf = tetra.weld_device(soup, count,
                                                max_verts=262_144)
        torch.cuda.synchronize()
        swept[d.type] = dict(v=v[:nv].cpu(), f=f[:nf].cpu(), nv=nv, nf=nf,
                             count=count, overflow=bool(ovf or v_ovf),
                             s=time.perf_counter() - ta)
    a, b = swept[dev.type], swept["cpu"]
    sphere = {"res": IM_SPHERE_RES, "triangles": a["count"], "nv": a["nv"],
              "nf": a["nf"], "cpu_nv": b["nv"], "cpu_nf": b["nf"],
              "overflow": a["overflow"] or b["overflow"], "s": a["s"],
              "cpu_s": b["s"]}
    check((a["count"], a["nv"], a["nf"]) == (b["count"], b["nv"], b["nf"]),
          f"deformed sphere counts: card {a['count']}/{a['nv']}/{a['nf']}, "
          f"CPU {b['count']}/{b['nv']}/{b['nf']}")
    check(not sphere["overflow"], "deformed sphere overflowed")
    check(torch.equal(a["f"], b["f"]), "deformed sphere: faces differ")
    sphere["v_max_abs_err"] = float((a["v"] - b["v"]).abs().max())
    check(sphere["v_max_abs_err"] <= TOL_MESH_V,
          f"deformed sphere vertices: {sphere['v_max_abs_err']:.3g}")
    log(f"instantmesh c. deformed sphere at {IM_SPHERE_RES}³: {sphere}")
    rec["deformed_sphere"] = sphere
    del swept, a, b
    rec["c_s"] = time.perf_counter() - t0

    # d. extract_mesh at the bench's 96 and the default 129
    t0 = time.perf_counter()
    meshes, rec["extract_mesh"] = {}, {}
    for res in IM_RESOLUTIONS:
        pipe._cap_memo.pop(res, None)
        with warnings.catch_warnings(record=True) as caught, \
                count_calls(tetra, "marching_tets_deformed") as rungs:
            warnings.simplefilter("always")
            torch.cuda.synchronize()
            tc = time.perf_counter()
            pipe.extract_mesh(planes[0], resolution=res)     # the ladder
            torch.cuda.synchronize()
            cold_s, cold_rungs = time.perf_counter() - tc, rungs.calls
            tm = time.perf_counter()
            mesh = pipe.extract_mesh(planes[0], resolution=res)
            torch.cuda.synchronize()
            total_s, warm_rungs = time.perf_counter() - tm, \
                rungs.calls - cold_rungs
            _, profiled_s, spans = profile_spans(
                lambda: pipe.extract_mesh(planes[0], resolution=res),
                EXTRACT_STAGES)
        overflow = [str(w.message) for w in caught
                    if "overflow" in str(w.message)]
        check(all(sp["calls"] == 1 for sp in spans.values()),
              f"extract_mesh's spans: {spans}")
        check(mesh.num_vertices > 0 and mesh.num_faces > 0, "empty mesh")
        check(bool(np.isfinite(mesh.v).all()), "non-finite vertices")
        check(int(mesh.f.max()) < mesh.num_vertices, "faces past the vertices")
        check(mesh.vc is not None and mesh.vc.shape == mesh.v.shape,
              "no vertex colours")
        r = {"resolution": res, "nv": mesh.num_vertices,
             "nf": mesh.num_faces, "capacity": pipe._cap_memo[res],
             "cold_rungs": cold_rungs, "warm_rungs": warm_rungs,
             "overflow": bool(overflow), "overflow_warnings": overflow[:2],
             "cold_s": cold_s, "total_s": total_s,
             "profiled_total_s": profiled_s,
             "stages": {k.split(".")[-1]: v for k, v in spans.items()}}
        if res == IM_RESOLUTIONS[0]:
            glb = os.path.join(asset_dir, "instantmesh_mesh.glb")
            mesh.write(glb)
            back = Mesh.load(glb)
            check(np.array_equal(back.v, mesh.v)
                  and np.array_equal(back.f, mesh.f),
                  "GLB round trip changed the mesh")
            r["glb_bytes"] = os.path.getsize(glb)
        log(f"instantmesh d. extract_mesh at {res}³: {r}")
        rec["extract_mesh"][str(res)] = r
        meshes[res] = mesh
    rec["d_s"] = time.perf_counter() - t0
    del pipe, planes
    torch.cuda.empty_cache()
    return rec, meshes[IM_RESOLUTIONS[0]]


# ------------------------------------------------------------------ #
# The mesh orbit renderer (phase 13)
# ------------------------------------------------------------------ #
MR_SIZE = 512            # the Mesh_Orbit_Renderer node's defaults
MR_FOVY = 49.1
MR_RADIUS = 2.6          # the orbit's camera distance
# the sphere: radius 1 in a ±3 lattice of 97³ (28,524 faces), so no 16-px
# tile of the 8 views at 512² holds more than 216 faces: `max_per_tile`
# 256 cuts none, and binned must equal brute force
MR_SPHERE_RES = 97
MR_SPHERE_BOUND = 3.0
MR_TEXTURE = 1024
MR_BF_CHUNK = 128        # brute force's faces per step on the card
TOL_MR = 1e-4            # buffers where the face ids agree, card vs CPU
MR_FACE_AGREE = 0.999    # share of pixels whose face id agrees
TOL_MR_GRAD_REL = 1e-3   # gradients, card vs CPU, of their largest value


def sphere_mesh():
    """A unit sphere from `extract_isosurface_device` at MR_SPHERE_RES³ over
    ±MR_SPHERE_BOUND (on the CPU; the field rooted in float64), with vertex
    colours from the position."""
    import numpy as np
    import torch
    from comfy3d_tpu_torch.core.mesh import Mesh
    from comfy3d_tpu_torch.ops import tetra
    bound = MR_SPHERE_BOUND
    lin = np.linspace(-bound, bound, MR_SPHERE_RES)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    grid = (1.0 - np.sqrt(x * x + y * y + z * z)).astype(np.float32)
    v, f, nv, nf = tetra.extract_isosurface_device(
        torch.as_tensor(grid), bounds=(-bound, bound), max_tris=400_000,
        on_overflow="raise")
    v, f = v[:nv].numpy(), f[:nf].numpy()
    return Mesh(v=v, f=f, vc=np.clip(v * 0.5 + 0.5, 0.0, 1.0))


def uv_cube():
    """A cube of half-size 0.5, each face split into 4 × 4 quads (two
    triangles each), its vertices shared between faces, with per-face UVs
    (vt/ft) into a 3 × 2 atlas of a seeded MR_TEXTURE² albedo."""
    import numpy as np
    from comfy3d_tpu_torch.core.mesh import Mesh
    n = 4
    s = np.linspace(-0.5, 0.5, n + 1)
    a, b = np.meshgrid(s, s, indexing="ij")
    pts, uvs, tris = [], [], []
    for k in range(6):
        axis, sign = k // 2, (-1.0, 1.0)[k % 2]
        p = np.zeros(a.shape + (3,))
        p[..., axis] = 0.5 * sign
        p[..., (axis + 1) % 3], p[..., (axis + 2) % 3] = a, b
        uv = np.stack([(k % 3 + a + 0.5) / 3.0,
                       (k // 3 + b + 0.5) / 2.0], -1)
        idx = k * (n + 1) ** 2 + np.arange((n + 1) ** 2).reshape(n + 1,
                                                                  n + 1)
        q0, q1, q2, q3 = (idx[:-1, :-1], idx[1:, :-1], idx[1:, 1:],
                          idx[:-1, 1:])
        tris.append(np.stack([q0, q1, q2], -1).reshape(-1, 3))
        tris.append(np.stack([q0, q2, q3], -1).reshape(-1, 3))
        pts.append(p.reshape(-1, 3))
        uvs.append(uv.reshape(-1, 2))
    pts, uvs, ft = np.concatenate(pts), np.concatenate(uvs), \
        np.concatenate(tris)
    v, inv = np.unique(np.round(pts, 6), axis=0, return_inverse=True)
    albedo = np.random.RandomState(0).rand(MR_TEXTURE, MR_TEXTURE, 3)
    return Mesh(v=v, f=inv.reshape(-1)[ft], vt=uvs, ft=ft, albedo=albedo)


def render_inputs(mesh, device):
    """The orbit-renderer node's inputs: `Mesh.device_arrays` with
    `face_valid` over the padded faces, and the colour source."""
    import torch
    d = mesh.device_arrays(device=device)
    kw = dict(face_valid=torch.arange(d["f"].shape[0], device=device)
              < mesh.num_faces)
    if "albedo" in d and "ft" in d:
        kw.update(vt=d["vt"], ft=d["ft"], albedo=d["albedo"])
    elif "vc" in d:
        kw["vc"] = d["vc"]
    return d["v"], d["f"], kw


def orbit_cameras(device):
    """The 8-view orbit at MR_RADIUS."""
    from comfy3d_tpu_torch.core.camera import Camera, compose_orbit_camposes
    poses = compose_orbit_camposes([MR_RADIUS] * 8,
                                   [15.0, 30.0, 0.0, -15.0] * 2,
                                   [30.0 + 45.0 * i for i in range(8)])
    return Camera.from_camposes(poses, fovy_deg=MR_FOVY, width=MR_SIZE,
                                height=MR_SIZE, device=device)


def _view(cams, i):
    import dataclasses
    return dataclasses.replace(cams, c2w=cams.c2w[i],
                               fovy_deg=cams.fovy_deg[i])


def mesh_render_path(dev, im_mesh):
    """Phase 13: `render_mesh` with the Mesh_Orbit_Renderer node's defaults
    (fovy 49.1, background 1, "binned") on two fixtures, then the 8-view
    orbit batch, then phase 12's mesh."""
    import dataclasses

    import numpy as np
    import torch
    from comfy3d_tpu_torch.ops import mesh_render as MR
    from comfy3d_tpu_torch.ops import rasterize as R

    cpu = torch.device("cpu")
    size = MR_SIZE
    fixtures = {"sphere_vc": sphere_mesh(), "cube_albedo": uv_cube()}
    rec = {"size": size, "fovy": MR_FOVY, "radius": MR_RADIUS,
           "fixtures": {k: {"nv": m.num_vertices, "nf": m.num_faces}
                        for k, m in fixtures.items()}}
    # one set of camera poses, copied to the card: both devices see the
    # same c2w bits (a sin or cos on the card may differ by an ulp)
    cams = {"cpu": orbit_cameras(cpu)}
    cams[dev.type] = dataclasses.replace(
        cams["cpu"], c2w=cams["cpu"].c2w.to(dev),
        fovy_deg=cams["cpu"].fovy_deg.to(dev))

    # a. one view of each fixture, card against CPU; binned = brute force
    t0 = time.perf_counter()
    rec["parity"] = {}
    for name, mesh in fixtures.items():
        out = {}
        for d in (dev, cpu):
            v, f, kw = render_inputs(mesh, d)
            cam = _view(cams[d.type], 0)
            rast = R.rasterize(v, f, cam.view_proj, size, size,
                               face_valid=kw["face_valid"])
            img = MR.render_mesh(v, f, cam, **kw)
            out[d.type] = (rast, {k: x.cpu() for k, x in img.items()})
            if d == dev:
                brute = R.rasterize(v, f, cam.view_proj, size, size,
                                    face_valid=kw["face_valid"],
                                    method="bruteforce", chunk=MR_BF_CHUNK)
                same = {k: bool(torch.equal(getattr(rast, k),
                                            getattr(brute, k)))
                        for k in ("face_id", "bary", "depth")}
                check(all(same.values()),
                      f"{name}: binned differs from brute force: {same}")
        (cr, ci), (hr, hi) = out[dev.type], out["cpu"]
        agree = (cr.face_id.cpu() == hr.face_id)
        r = {"coverage": float(hi["alpha"].mean()),
             "face_id_agree": float(agree.float().mean())}
        for k in ("image", "alpha", "depth", "normal", "viewcos"):
            diff = (ci[k] - hi[k]).abs()
            if diff.dim() == 3:
                diff = diff.amax(-1)
            r[f"{k}_max_abs_err"] = float(diff[agree].max())
        log(f"mesh_render a. {name}, card vs CPU at {size}²: {r}")
        check(0.02 < r["coverage"] < 0.98, f"{name}: coverage {r}")
        check(r["face_id_agree"] >= MR_FACE_AGREE,
              f"{name}: face ids agree on {r['face_id_agree']:.5f}")
        for k in ("image", "alpha", "depth", "normal", "viewcos"):
            check(r[f"{k}_max_abs_err"] <= TOL_MR,
                  f"{name}: {k} card vs CPU {r[k + '_max_abs_err']:.3g}")
        rec["parity"][name] = r
    rec["a_s"] = time.perf_counter() - t0

    # b. gradients with respect to v, vc and albedo, card against CPU
    t0 = time.perf_counter()
    w = np.random.RandomState(5).rand(size, size, 3).astype(np.float32)
    rec["gradients"] = {}
    for name, mesh, leaf in (("sphere_vc", fixtures["sphere_vc"], "vc"),
                             ("cube_albedo", fixtures["cube_albedo"],
                              "albedo")):
        grads = {}
        for d in (dev, cpu):
            v, f, kw = render_inputs(mesh, d)
            v = v.clone().requires_grad_()
            kw[leaf] = kw[leaf].clone().requires_grad_()
            img = MR.render_mesh(v, f, _view(cams[d.type], 0), **kw)
            (img["image"] * torch.as_tensor(w, device=d)).sum().backward()
            grads[d.type] = {"v": v.grad.cpu(), leaf: kw[leaf].grad.cpu()}
        r = {}
        for k, g in grads[dev.type].items():
            ref = grads["cpu"][k]
            check(bool(torch.isfinite(g).all()), f"{name}: non-finite d{k}")
            check(float(ref.abs().max()) > 0, f"{name}: d{k} is zero")
            r[f"d{k}_rel_err"] = rel_err(g, ref)
            check(r[f"d{k}_rel_err"] <= TOL_MR_GRAD_REL,
                  f"{name}: d{k} card vs CPU {r[f'd{k}_rel_err']:.3g}")
        log(f"mesh_render b. {name} gradients: {r}")
        rec["gradients"][name] = r
    rec["b_s"] = time.perf_counter() - t0

    # c. the 8-view orbit batch of the sphere
    t0 = time.perf_counter()
    v, f, kw = render_inputs(fixtures["sphere_vc"], dev)
    cam8, cam0 = cams[dev.type], _view(cams[dev.type], 0)
    out = MR.render_mesh(v, f, cam8, **kw)
    check(tuple(out["image"].shape) == (8, size, size, 3),
          f"8-view image {tuple(out['image'].shape)}")
    check(all(bool(torch.isfinite(x).all()) for x in out.values()),
          "non-finite 8-view render")
    batch_ms = cuda_ms(lambda: MR.render_mesh(v, f, cam8, **kw), 3,
                       warmup=1)
    frame_ms = cuda_ms(lambda: MR.render_mesh(v, f, cam0, **kw), 5,
                       warmup=1)
    raster_ms = cuda_ms(lambda: R.rasterize(
        v, f, cam0.view_proj, size, size, face_valid=kw["face_valid"]), 5,
        warmup=1)
    prof = profile_frames(lambda: MR.render_mesh(v, f, cam0, **kw), 3)
    prof["device_idle_share"] = 1.0 - prof["device_busy_ms"] / frame_ms
    ss = MR.render_mesh(v, f, cam0, ssaa=2, **kw)
    check(tuple(ss["image"].shape) == (size, size, 3)
          and all(bool(torch.isfinite(x).all()) for x in ss.values()),
          "ssaa=2 render")
    ssaa_ms = cuda_ms(lambda: MR.render_mesh(v, f, cam0, ssaa=2, **kw), 2,
                      warmup=0)
    rec["orbit"] = {"views": 8, "batch_ms": batch_ms,
                    "ms_per_frame": batch_ms / 8, "frame_ms": frame_ms,
                    "rasterize_ms": raster_ms, "ssaa2_frame_ms": ssaa_ms,
                    "mean_alpha": float(out["alpha"].mean()),
                    "profile": {k: x for k, x in prof.items() if k != "top"},
                    "profile_top": prof["top"][:6]}
    log(f"mesh_render c. 8-view orbit at {size}²: {rec['orbit']}")
    rec["c_s"] = time.perf_counter() - t0

    # d. phase 12's mesh from the same 8 views (a noise surface: tiles
    # may overflow, so nothing is gated but finiteness)
    t0 = time.perf_counter()
    v, f, kw = render_inputs(im_mesh, dev)
    out = MR.render_mesh(v, f, cam8, **kw)
    check(all(bool(torch.isfinite(x).all()) for x in out.values()),
          "non-finite render of the InstantMesh mesh")
    im_ms = cuda_ms(lambda: MR.render_mesh(v, f, cam8, **kw), 1, warmup=0)
    rec["instantmesh_mesh"] = {
        "nv": im_mesh.num_vertices, "nf": im_mesh.num_faces,
        "batch_ms": im_ms, "ms_per_frame": im_ms / 8,
        "covered_share": float(out["alpha"].mean())}
    log(f"mesh_render d. the InstantMesh mesh, 8 views: "
        f"{rec['instantmesh_mesh']}")
    rec["d_s"] = time.perf_counter() - t0
    return rec


def main(out_path=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from comfy3d_tpu_torch.core.camera import Camera, compose_orbit_camposes
    from comfy3d_tpu_torch.core.io.ply import load_gs_ply, save_gs_ply
    from comfy3d_tpu_torch.ops import _build, gs_flat
    from comfy3d_tpu_torch.ops import gs_render as G

    # the plain versions' einsum is a matmul: keep it in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    record = {}
    phase_s = {}
    t_lap = [time.perf_counter()]

    def lap(name):
        """Seconds since the last lap, under `name` (phases in order)."""
        now = time.perf_counter()
        phase_s[name] = now - t_lap[0]
        t_lap[0] = now
        log(f"phase {name}: {phase_s[name]:.1f} s")

    # 1. the card
    card = torch.cuda.get_device_name(0)
    smi_line = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    log(f"device {card} | nvidia-smi: {smi_line}, SM clock max {clock_mhz} "
        f"MHz | torch {torch.__version__} cuda {torch.version.cuda}")
    record["device"] = dict(name=card, nvidia_smi=smi_line,
                            sm_clock_max_mhz=clock_mhz,
                            torch=torch.__version__, cuda=torch.version.cuda)

    lap("card")
    # 2. build
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    log(f"built {_build.sources()} in {build_s:.1f} s")
    ptxas = {}
    for src, out in _build.build_log.items():
        ptxas[src] = [line.strip() for line in out.splitlines()
                      if any(k in line for k in ("entry function",
                                                 "registers", "spill"))]
        for line in ptxas[src]:
            log(f"  {src}: {line}")
    record.update(build_s=build_s, ptxas=ptxas)

    lap("2_build")
    # 3. kernel vs plain on the card
    poses = compose_orbit_camposes(
        [2.2] * 8, [15.0, 30.0, 0.0, -15.0] * 2,
        [30.0 + 45.0 * i for i in range(8)])
    scenes = {
        "20k_256": (make_splat(20_000, 0.02, 3, dev),
                    Camera.from_orbit(20.0, 45.0, 2.2, width=256, height=256,
                                      device=dev)),
        # the main path's splat and its first view
        "100k_800": (make_splat(100_000, 0.01, 0, dev),
                     Camera.from_camposes(poses[0], width=800, height=800,
                                          device=dev)),
    }
    compare, inputs, stops_by, plain_img = {}, {}, {}, {}
    fwd_out, scene_of = {}, {}
    for sname, (splat, cam) in scenes.items():
        inputs[sname] = inp = flat_inputs(splat, cam)
        for merged in (True, False):
            label = f"{sname}_{'merged' if merged else 'per_subtile'}"
            compare[label], fwd_out[label], img = kernel_vs_plain(
                label, inp, merged)
            stops_by[label] = fwd_out[label][2]
            scene_of[label] = sname
            if merged:
                plain_img[sname] = img
    # bins of 48 and 64 px: clusters of 9 and 16 sub-tile CTAs
    for bin_px in (48, 64):
        wide = flat_inputs(*scenes["20k_256"], bin_px=bin_px)
        for merged in (True, False):
            label = f"20k_256_bin{bin_px}_" \
                f"{'merged' if merged else 'per_subtile'}"
            compare[label] = kernel_vs_plain(label, wide, merged)[0]
        del wide
    record["kernel_vs_plain"] = compare

    lap("3_flat_kernels")
    # 4. the main path: GS-PLY → load on the card → 8 orbit views at 800²
    asset_dir = os.path.join(_build.BUILD_DIR, "chip_smoke")
    os.makedirs(asset_dir, exist_ok=True)
    ply_path = os.path.join(asset_dir, "splat_100k.ply")
    save_gs_ply(ply_path, scenes["100k_800"][0])
    splat = load_gs_ply(ply_path, device="cuda")
    check(splat.device.type == "cuda", "load_gs_ply did not load on cuda")
    check(torch.equal(splat.xyz, scenes["100k_800"][0].xyz),
          "GS-PLY round trip changed the splat")
    cams = Camera.from_camposes(poses, width=800, height=800, device="cuda")

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = G.render(splat, cams)
    torch.cuda.synchronize()
    render8_s = time.perf_counter() - t0
    launches = read_launches()
    log(f"main path: 8 views in {render8_s * 1e3:.1f} ms (first call), "
        f"launches {launches}")
    expect_launches(launches, "flat", 8, 0, "8 views")
    img, alpha = out["image"], out["alpha"]
    check(tuple(img.shape) == (8, 800, 800, 3), f"image shape {img.shape}")
    check(bool(torch.isfinite(img).all()) and bool(
        torch.isfinite(alpha).all()) and bool(
        torch.isfinite(out["depth"]).all()), "non-finite output")
    mean_alpha = float(alpha.mean())
    check(0.0 < mean_alpha < 1.0, f"mean alpha {mean_alpha}")
    view0_db = psnr(img[0], plain_img["100k_800"])
    check(view0_db >= TOL_PSNR_DB,
          f"view 0 vs the plain compositor: {view0_db:.2f} dB")
    # splats whose 3σ box spans more than k = 4 bins keep only 4 of them,
    # as in the JAX package; the flag is reported, not an error
    overflow_views = int(out["overflow"].sum())

    # timings (CUDA events), after the counted run
    cam0 = Camera.from_camposes(poses[0], width=800, height=800, device=dev)
    inp = inputs["100k_800"]
    kargs = {m: flat_kernel_args(inp, m == "merged")
             for m in ("merged", "per_subtile")}
    times = {
        "frame_ms": cuda_ms(lambda: G.render(splat, cam0), 20),
        "kernel_merged_ms": cuda_ms(
            lambda: gs_flat.composite_bins_fwd_rows(*kargs["merged"][0]), 20),
        "kernel_per_subtile_ms": cuda_ms(
            lambda: gs_flat.composite_bins_fwd_rows(
                *kargs["per_subtile"][0]), 20),
        "plain_merged_ms": cuda_ms(
            lambda: gs_flat.composite_bins_fwd_rows_plain(
                *kargs["merged"][0]), 5, warmup=1),
        "plain_per_subtile_ms": cuda_ms(
            lambda: gs_flat.composite_bins_fwd_rows_plain(
                *kargs["per_subtile"][0]), 5, warmup=1),
        "sort_ms": cuda_ms(
            lambda: G.binning.bin_coarse(*inp["sort_args"]), 20),
        "old_gather_ms": cuda_ms(lambda: flat_gather(inp), 20),
        "prep_ms": cuda_ms(lambda: flat_inputs(splat, cam0), 20),
        "render_8_views_ms": cuda_ms(lambda: G.render(splat, cams), 5),
    }
    log(f"times at 800²/100k: {times}")
    prof = profile_frames(lambda: G.render(splat, cam0), 5,
                          rows=tuple(inp["rows"].shape))
    prof["device_idle_share"] = 1.0 - prof["device_busy_ms"] / times["frame_ms"]
    log(f"profile of one frame: {prof}")
    check(prof["row_gathers"] == 0, f"the flat frame still gathers pair "
          f"rows: {prof['row_gather_ops']}")
    box = flat_box_stats(inp, stops_by["100k_800_merged"])
    log(f"flat render view 0, per-splat box: {box}")
    check_box(box, "flat render view 0")

    # bounds of the function with its gather, per mode, from this input
    bounds_rec = {
        "merged": flat_fwd_bound(inp, stops_by["100k_800_merged"], box),
        "per_subtile": flat_fwd_bound(inp, stops_by["100k_800_per_subtile"])}
    log(f"bounds: {bounds_rec}")

    def err(label):
        return max(compare[label]["max_abs_err_acc"],
                   compare[label]["max_abs_err_trans"])

    kernel = {
        "name": "gs_flat_fwd", "route": "cuda",
        "source": "comfy3d_tpu_torch/csrc/gs_flat_fwd.cu",
        "replaces": "comfy3d_tpu/ops/pallas/gs_flat.py:339",
        "launches": launches["gs_flat_fwd"],
        "max_abs_err": max(err(k) for k in compare),
        "ms": times["kernel_merged_ms"],
        "kernel_ms": times["kernel_merged_ms"],
        "plain_ms": times["plain_merged_ms"],
        "bound_ms": bounds_rec["merged"]["bound_ms"],
        "bound_by": bounds_rec["merged"]["bound_by"],
        "library_ms": None,
        "modes": {
            "merged": {
                "replaces": "comfy3d_tpu/ops/pallas/gs_flat.py:339",
                "ms": times["kernel_merged_ms"],
                "plain_ms": times["plain_merged_ms"],
                "max_abs_err": max(err(k) for k in compare
                                   if k.endswith("_merged")),
                **bounds_rec["merged"]},
            "per_subtile": {
                "replaces": "comfy3d_tpu/ops/pallas/gs_flat.py:198",
                "ms": times["kernel_per_subtile_ms"],
                "plain_ms": times["plain_per_subtile_ms"],
                "max_abs_err": max(err(k) for k in compare
                                   if k.endswith("_per_subtile")),
                **bounds_rec["per_subtile"]},
        },
    }
    record.update(main_path=dict(views=8, size=800, splats=100_000,
                                 launches=launches, mean_alpha=mean_alpha,
                                 view0_vs_plain_psnr_db=view0_db,
                                 overflow_views=overflow_views,
                                 first_call_8_views_s=render8_s, box=box),
                  times=times, profile=prof)

    lap("4_render_path")
    # 5. the compositor backward vs its plain version, both scenes and modes
    bwd_compare = {label: bwd_vs_plain(label, inputs[scene_of[label]],
                                       fwd_out[label], seed)
                   for seed, label in enumerate(fwd_out)}
    record["bwd_vs_plain"] = bwd_compare
    del fwd_out, stops_by
    torch.cuda.empty_cache()

    lap("5_flat_backward")
    # 6. the trainer learns; 7. the training path at full width
    record["trainer_learns"] = trainer_learns(dev)
    train_rec, train_times, train_prof, bwd_bound_rec = train_full_width(
        dev, asset_dir, clock_mhz=clock_mhz)
    record.update(train_path=train_rec, train_times=train_times,
                  train_profile=train_prof, bwd_bound=bwd_bound_rec)
    torch.cuda.empty_cache()

    lap("6_7_train_path")
    # 8. the tile compositor, forward and backward, vs its plain versions
    tile_cmp, tile_bwd_cmp = {}, {}
    for seed, (sname, m) in enumerate((("20k_256", 512), ("100k_800", 1024))):
        t_inp = tile_inputs(*scenes[sname], m)
        label = f"{sname}_m{m}"
        tile_cmp[label], t_fwd, _ = tile_kernel_vs_plain(label, t_inp)
        tile_bwd_cmp[label] = tile_bwd_vs_plain(label, t_inp, t_fwd, seed)
        del t_inp, t_fwd
    record.update(tile_vs_plain=tile_cmp, tile_bwd_vs_plain=tile_bwd_cmp)
    torch.cuda.empty_cache()

    lap("8_tile_kernels")
    # 9. the tile render path; 10. the tile train path
    tile_rec, tile_times, tile_prof, tile_fwd_bound_rec = tile_render_path(
        dev, splat, cams, cam0, img, scenes["20k_256"])
    record.update(tile_render_path=tile_rec, tile_times=tile_times,
                  tile_profile=tile_prof, tile_fwd_bound=tile_fwd_bound_rec)
    del out, img, alpha
    torch.cuda.empty_cache()
    record["tile_trainer_learns"] = trainer_learns(dev, backend="tile")
    (tile_train_rec, tile_train_times, tile_train_prof,
     tile_bwd_bound_rec) = train_full_width(dev, asset_dir, backend="tile",
                                            clock_mhz=clock_mhz)
    record.update(tile_train_path=tile_train_rec,
                  tile_train_times=tile_train_times,
                  tile_train_profile=tile_train_prof,
                  tile_bwd_bound=tile_bwd_bound_rec)
    del splat, cams
    torch.cuda.empty_cache()

    lap("9_10_tile_paths")
    # 11. TripoSR image → mesh; no compositor kernel may launch
    reset_launches()
    t0 = time.perf_counter()
    record["triposr"] = triposr_path(dev, asset_dir, smi_line)
    record["triposr"]["s"] = time.perf_counter() - t0
    record["triposr"]["launches"] = read_launches()
    check(not any(record["triposr"]["launches"].values()),
          f"the TripoSR path launched a compositor kernel: "
          f"{record['triposr']['launches']}")

    lap("11_triposr")
    # 12. InstantMesh posed views → mesh; 13. the mesh orbit renderer; no
    # compositor kernel may launch on either
    for phase, path, run in (
            (12, "instantmesh",
             lambda: instantmesh_path(dev, asset_dir, smi_line)),
            (13, "mesh_render", lambda: mesh_render_path(dev, im_mesh))):
        reset_launches()
        t0 = time.perf_counter()
        out = run()
        if path == "instantmesh":
            out, im_mesh = out
        record[path] = out
        record[path]["s"] = time.perf_counter() - t0
        record[path]["launches"] = read_launches()
        check(not any(record[path]["launches"].values()),
              f"the {path} path launched a compositor kernel: "
              f"{record[path]['launches']}")
        torch.cuda.empty_cache()
        lap(f"{phase}_{path}")
    del im_mesh

    def by_path(name):
        return {"render_8_views": launches[name],
                "train_10_steps": train_rec["launches"][name],
                "tile_render_8_views": tile_rec["launches"][name],
                "tile_train_10_steps": tile_train_rec["launches"][name],
                "triposr": record["triposr"]["launches"][name],
                "instantmesh": record["instantmesh"]["launches"][name],
                "mesh_render": record["mesh_render"]["launches"][name]}

    kernel["launches_by_path"] = by_path("gs_flat_fwd")
    kernel["design"] = ("one CTA per sub-tile, a cluster per bin, rows "
                        "read by index (cp.async ring), box skip")
    kernel["by_path"] = {
        "render_view0": dict(ms=times["kernel_merged_ms"],
                             bound_ms=bounds_rec["merged"]["bound_ms"],
                             launches=launches["gs_flat_fwd"]),
        "train_view0_trained": dict(
            ms=train_times["kernel_fwd_ms"],
            bound_ms=train_rec["fwd_bound"]["bound_ms"],
            launches=train_rec["launches"]["gs_flat_fwd"])}
    kernel_bwd = {
        "name": "gs_flat_bwd", "route": "cuda",
        "source": "comfy3d_tpu_torch/csrc/gs_flat_bwd.cu",
        "replaces": "comfy3d_tpu/ops/pallas/gs_flat.py:552",
        "launches": train_rec["launches"]["gs_flat_bwd"],
        "launches_by_path": by_path("gs_flat_bwd"),
        "max_abs_err": max(r["max_abs_err"] for r in bwd_compare.values()),
        "max_rel_err": max(r["max_rel_err"] for r in bwd_compare.values()),
        "ms": train_times["kernel_bwd_ms"],
        "kernel_ms": train_times["kernel_bwd_ms"],
        "plain_ms": train_times["plain_bwd_ms"],
        "bound_ms": bwd_bound_rec["bound_ms"],
        "bound_by": bwd_bound_rec["bound_by"],
        "library_ms": None,
        "computes": "backward + per-splat scatter",
        "old_scatter_ms": train_times["old_scatter_ms"],
        "old_design": train_rec["old_design"],
    }
    kernel_tile_fwd = {
        "name": "gs_tile_fwd", "route": "cuda",
        "source": "comfy3d_tpu_torch/csrc/gs_tile_fwd.cu",
        "replaces": "comfy3d_tpu/ops/pallas/gs_tile.py:92",
        "launches": tile_rec["launches"]["gs_tile_fwd"],
        "launches_by_path": by_path("gs_tile_fwd"),
        "max_abs_err": max(max(r["max_abs_err_acc"], r["max_abs_err_trans"])
                           for r in tile_cmp.values()),
        "ms": tile_times["kernel_fwd_ms"],
        "kernel_ms": tile_times["kernel_fwd_ms"],
        "plain_ms": tile_times["plain_fwd_ms"],
        "bound_ms": tile_fwd_bound_rec["bound_ms"],
        "bound_by": tile_fwd_bound_rec["bound_by"],
        "library_ms": None,
        "design": "rows read by index (cp.async ring), box skip, writes "
                  "the backward's block when asked",
        "by_path": {
            "render_view0_m1024": dict(
                ms=tile_times["kernel_fwd_ms"],
                bound_ms=tile_fwd_bound_rec["bound_ms"],
                launches=tile_rec["launches"]["gs_tile_fwd"]),
            "train_view0_trained_m512": dict(
                ms=tile_train_times["kernel_fwd_ms"],
                bound_ms=tile_train_rec["fwd_bound"]["bound_ms"],
                launches=tile_train_rec["launches"]["gs_tile_fwd"],
                block_kept=True)},
    }
    kernel_tile_bwd = {
        "name": "gs_tile_bwd", "route": "cuda",
        "source": "comfy3d_tpu_torch/csrc/gs_tile_bwd.cu",
        "replaces": "comfy3d_tpu/ops/pallas/gs_tile.py:127",
        "launches": tile_train_rec["launches"]["gs_tile_bwd"],
        "launches_by_path": by_path("gs_tile_bwd"),
        "max_abs_err": max(r["max_abs_err"] for r in tile_bwd_cmp.values()),
        "max_rel_err": max(r["max_rel_err"] for r in tile_bwd_cmp.values()),
        "ms": tile_train_times["kernel_bwd_ms"],
        "kernel_ms": tile_train_times["kernel_bwd_ms"],
        "plain_ms": tile_train_times["plain_bwd_ms"],
        "bound_ms": tile_bwd_bound_rec["bound_ms"],
        "bound_by": tile_bwd_bound_rec["bound_by"],
        "library_ms": None,
        "computes": "backward + per-splat scatter",
        "old_scatter_ms": tile_train_times["old_scatter_ms"],
        "old_design": tile_train_rec["old_design"],
    }
    record["phase_s"] = phase_s
    record["kernels"] = [kernel, kernel_bwd, kernel_tile_fwd, kernel_tile_bwd]
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(record, f, indent=1)

    print(json.dumps({"main_path": record["main_path"], "times": times,
                      "profile": {k: v for k, v in prof.items()
                                  if k != "top"},
                      "train_path": train_rec, "train_times": train_times,
                      "train_profile": {k: v for k, v in train_prof.items()
                                        if k != "top"},
                      "trainer_learns": record["trainer_learns"],
                      "tile_render_path": tile_rec, "tile_times": tile_times,
                      "tile_profile": {k: v for k, v in tile_prof.items()
                                       if k != "top"},
                      "tile_train_path": tile_train_rec,
                      "tile_train_times": tile_train_times,
                      "tile_train_profile": {
                          k: v for k, v in tile_train_prof.items()
                          if k != "top"},
                      "tile_trainer_learns": record["tile_trainer_learns"]}))
    print(json.dumps({"phase_s": phase_s}))
    print(json.dumps({"triposr": record["triposr"]}))
    print(json.dumps({"instantmesh": record["instantmesh"]}))
    print(json.dumps({"mesh_render": record["mesh_render"]}))
    print(json.dumps({"kernels": record["kernels"]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full record (JSON) here")
    sys.exit(main(ap.parse_args().out))
