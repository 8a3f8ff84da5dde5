#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`comfy3d_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--out RECORD.json]   # repository root, one card

Phases, in order; the first failure ends the run with a non-zero exit:
  1. the card: its name, and `nvidia-smi`'s name and power limit;
  2. build every CUDA source under comfy3d_tpu_torch/csrc with nvcc;
  3. each kernel against its plain PyTorch version on the card, on the same
     inputs: the bin compositor (`gs_flat_fwd`) in merged and per-sub-tile
     mode at 20k splats / 256² and 100k splats / 800²;
  4. the main path — a 100k-splat GS-PLY written with `save_gs_ply`, read
     back with `load_gs_ply(device="cuda")`, rendered from 8 orbit views at
     800² with `render` — with every kernel's launch count reset just before
     and read just after; then times of a frame, the kernel, its plain
     version and the coarse sort, with CUDA events.
It prints one `{"kernels": [...]}` line, then the `nvidia-smi` line, and as
its last line `{"ok": true, "device": {...}}`. With `--out`, the full record
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


def profile_frames(fn, frames):
    """torch.profiler over `frames` calls of fn: device-busy ms per frame,
    device-side ops per frame, and the ops with the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    return dict(
        device_busy_ms=sum(dev_us(e) for e in ops) / 1e3 / frames,
        device_ops=sum(e.count for e in ops) / frames,
        top=[dict(name=e.key[:80], ms=dev_us(e) / 1e3 / frames,
                  count=e.count / frames) for e in ops[:10]])


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


def flat_inputs(splat, cam):
    """The compositor's inputs for one camera, as `render_arrays` builds
    them: projection, SH colour, coarse sort, payload gather."""
    import torch
    from comfy3d_tpu_torch.ops import binning
    from comfy3d_tpu_torch.ops import gs_render as G
    W, H = cam.width, cam.height
    means2d, depth, conic, radii, visible = G.project_gaussians(
        splat.xyz, splat.scale, splat.rotation, cam.w2c, cam.intrinsics,
        W, H)
    active = visible & splat.alive & (splat.opacity > G.ALPHA_MIN)
    chans = torch.cat([splat.colors_toward(cam.campos), depth[:, None]], -1)
    nby, nbx = binning.num_bins(H, W)
    k = G.max_tiles_per_prim_coarse(16)
    sprim, bounds, _ = binning.bin_coarse(means2d, depth, radii, active,
                                          nby, nbx, k=k)
    r_row = torch.where(active, torch.clamp_min(radii, 0.5),
                        torch.zeros_like(radii))
    data = G.pack_payload(means2d, conic, splat.opacity, chans, r_row, sprim)
    sort_args = (means2d, depth, radii, active, nby, nbx, k)
    return dict(data=data, bounds=bounds, nbx=nbx, nby=nby, W=W, H=H,
                C=chans.shape[-1], sort_args=sort_args)


def to_image(acc, trans, inp):
    from comfy3d_tpu_torch.ops import gs_render as G
    img = G._bins_to_image(acc, inp["nby"], inp["nbx"], inp["H"], inp["W"])
    tr = G._bins_to_image(trans, inp["nby"], inp["nbx"], inp["H"], inp["W"])
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
    import torch
    from comfy3d_tpu_torch.ops import gs_flat
    args = (inp["data"], inp["bounds"], inp["nbx"], inp["nby"], inp["C"],
            inp["W"], inp["H"])
    acc, tr, st = gs_flat.composite_bins_fwd(*args, merged=merged)
    torch.cuda.synchronize()
    p_acc, p_tr, p_st = gs_flat.composite_bins_fwd_plain(*args,
                                                         merged=merged)
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
               pairs=int(inp["bounds"][-1]),
               max_stop=int(st.max()))
    log(f"{label}: {rec}")
    check(err_acc <= TOL_ABS and err_tr <= TOL_ABS,
          f"{label}: acc err {err_acc}, trans err {err_tr} > {TOL_ABS}")
    check(db >= TOL_PSNR_DB, f"{label}: PSNR {db:.2f} dB < {TOL_PSNR_DB}")
    return rec, st, to_image(p_acc, p_tr, inp)


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

    # 1. the card
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    record["device"] = dict(name=name, nvidia_smi=smi,
                            torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    log(f"built {_build.sources()} in {build_s:.1f} s")
    for src, out in _build.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")
    record["build_s"] = build_s

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
    for sname, (splat, cam) in scenes.items():
        inputs[sname] = inp = flat_inputs(splat, cam)
        for merged in (True, False):
            label = f"{sname}_{'merged' if merged else 'per_subtile'}"
            compare[label], stops_by[label], img = kernel_vs_plain(
                label, inp, merged)
            if merged:
                plain_img[sname] = img
    record["kernel_vs_plain"] = compare

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
    gs_flat.composite_bins_fwd.launches = 0
    t0 = time.perf_counter()
    out = G.render(splat, cams)
    torch.cuda.synchronize()
    render8_s = time.perf_counter() - t0
    launches = {"gs_flat_fwd": gs_flat.composite_bins_fwd.launches}
    log(f"main path: 8 views in {render8_s * 1e3:.1f} ms (first call), "
        f"launches {launches}")
    check(launches["gs_flat_fwd"] == 8,
          f"gs_flat_fwd launched {launches['gs_flat_fwd']} times, not 8")
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
    kargs = (inp["data"], inp["bounds"], inp["nbx"], inp["nby"], inp["C"],
             inp["W"], inp["H"])
    times = {
        "frame_ms": cuda_ms(lambda: G.render(splat, cam0), 20),
        "kernel_merged_ms": cuda_ms(
            lambda: gs_flat.composite_bins_fwd(*kargs, merged=True), 20),
        "kernel_per_subtile_ms": cuda_ms(
            lambda: gs_flat.composite_bins_fwd(*kargs, merged=False), 20),
        "plain_merged_ms": cuda_ms(
            lambda: gs_flat.composite_bins_fwd_plain(*kargs, merged=True),
            5, warmup=1),
        "plain_per_subtile_ms": cuda_ms(
            lambda: gs_flat.composite_bins_fwd_plain(*kargs, merged=False),
            5, warmup=1),
        "sort_ms": cuda_ms(
            lambda: G.binning.bin_coarse(*inp["sort_args"]), 20),
        "prep_ms": cuda_ms(lambda: flat_inputs(splat, cam0), 20),
        "render_8_views_ms": cuda_ms(lambda: G.render(splat, cams), 5),
    }
    log(f"times at 800²/100k: {times}")
    prof = profile_frames(lambda: G.render(splat, cam0), 5)
    prof["device_idle_share"] = 1.0 - prof["device_busy_ms"] / times["frame_ms"]
    log(f"profile of one frame: {prof}")

    # bound: bytes each input read once + outputs written once, against
    # f32 operations of the visits this input makes (20 + 2C per visit)
    nbins = inp["nbx"] * inp["nby"]
    pairs = int(inp["bounds"][-1])
    C = inp["C"]
    out_bytes = nbins * 4 * (C + 1) * 256 * 4 + nbins * 4 * 4
    in_bytes = (7 + C) * pairs * 4 + (nbins + 1) * 4
    bounds_rec = {}
    for mode, label in (("merged", "100k_800_merged"),
                        ("per_subtile", "100k_800_per_subtile")):
        v = visits(inp, stops_by[label])
        t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_S * 1e3
        t_ops = v * (20 + 2 * C) / PEAK_F32_OPS_S * 1e3
        bounds_rec[mode] = dict(
            visits=v, bytes=in_bytes + out_bytes, bound_ms=max(t_bytes, t_ops),
            bound_by="operations" if t_ops >= t_bytes else "bytes")
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
                "max_abs_err": max(err("20k_256_merged"),
                                   err("100k_800_merged")),
                **bounds_rec["merged"]},
            "per_subtile": {
                "replaces": "comfy3d_tpu/ops/pallas/gs_flat.py:198",
                "ms": times["kernel_per_subtile_ms"],
                "plain_ms": times["plain_per_subtile_ms"],
                "max_abs_err": max(err("20k_256_per_subtile"),
                                   err("100k_800_per_subtile")),
                **bounds_rec["per_subtile"]},
        },
    }
    record.update(main_path=dict(views=8, size=800, splats=100_000,
                                 launches=launches, mean_alpha=mean_alpha,
                                 view0_vs_plain_psnr_db=view0_db,
                                 overflow_views=overflow_views,
                                 first_call_8_views_s=render8_s),
                  times=times, profile=prof, kernels=[kernel])
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(record, f, indent=1)

    print(json.dumps({"main_path": record["main_path"], "times": times,
                      "profile": {k: v for k, v in prof.items()
                                  if k != "top"}}))
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full record (JSON) here")
    sys.exit(main(ap.parse_args().out))
