#!/usr/bin/env python3
"""Split the time of the two compositor forward kernels on one NVIDIA GPU.

    python3 chip_fwd_split.py [--csrc DIR] [--out RECORD.json]   # one card

Builds source variants of the tile forward `csrc/gs_tile_fwd.cu` (K4′),
each with one part of the kernel taken out or changed, and of the
coarse-bin forward `csrc/gs_flat_fwd.cu` (K1′, K2′; also built without
its 6-CTA launch bound, bound_none, and for 5, bound5), and times each
with CUDA events on the inputs of view 0 of `chip_smoke.py`'s cells (100k
splats, 800²): the render cell (tile lists of 1,024 slots) and the train
cell before training (lists of 512). The variants of K4′:
  base        the kernel as built;
  no_exp      G = 1 + min(power, 0) in place of expf (the visit test keeps
              its shape, so its branch and the live path still run);
  dead_only   every visit taken as dead: staging, the syncs, the test;
  no_staging  the chunk's loads replaced by zeros (every visit then dead):
              dead_only less this is the cost of the loads;
  no_box      the per-warp box skip taken out: every warp walks every
              slot;
  bound5, bound6  the kernel built for at least 5 or 6 CTAs per SM
              (__launch_bounds__: fewer registers, some spilled);
  longest_first  CTA i takes the i-th longest tile list (a device-side
              order, set through an added entry point), timed beside the
              argsort of the counts that order costs.
`--csrc` points at another tree's sources of the same design (for
example a later commit's, unpacked from git), so one call can time
both. Beside the times: ptxas's registers and shared memory with the CTAs
per SM they allow, the CTAs' walks in 128-slot
chunks, the separate row gathers' device time (`torch.profiler`), and the
per-splat box's warp-slot skip share and its count of live visits outside
the box (`chip_smoke.tile_box_stats`, `flat_box_stats`), from the inputs.
Prints one JSON object with the card's name and power limit. Needs nvcc
and a card; without either it raises.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))

# {variant: [(text in gs_tile_fwd.cu, replacement)]}
TILE_VARIANTS = {
    "base": [],
    "no_exp": [("const float G = expf(fminf(power, 0.f));",
                "const float G = 1.f + fminf(power, 0.f);")],
    "dead_only": [("if (power <= 0.f && raw >= ALPHA_MIN) {",
                   "if (power <= 0.f && raw >= ALPHA_MIN && op < -1.f) {")],
    "no_staging": [(
        "if (tid < CHUNK) stage_row<D>(&s_row[buf][tid][0], rows, nidx, nok);",
        "if (tid < CHUNK) stage_row<D>(&s_row[buf][tid][0], rows, nidx, false);")],
    "no_box": [("wx0, wx1,\n              wy0, wy1, hits);",
                "-INFINITY, INFINITY,\n              -INFINITY, INFINITY, "
                "hits);")],
    "bound5": [("__launch_bounds__(NPIX)\ngs_tile",
                "__launch_bounds__(NPIX, 5)\ngs_tile")],
    "bound6": [("__launch_bounds__(NPIX)\ngs_tile",
                "__launch_bounds__(NPIX, 6)\ngs_tile")],
    "longest_first": [
        ("using namespace gs_fwd;",
         "using namespace gs_fwd;\n__device__ const int* g_order = nullptr;"),
        ("const int t = (int)blockIdx.x;",
         "const int t = g_order[blockIdx.x];"),
        ('extern "C" const char* gs_tile_fwd_error_string',
         'extern "C" int gs_tile_fwd_set_order(const int* p) {\n'
         '  return (int)cudaMemcpyToSymbol(g_order, &p, sizeof(p));\n}\n\n'
         'extern "C" const char* gs_tile_fwd_error_string')],
}
# {variant: [(text in gs_flat_fwd.cu, replacement)]}
FLAT_VARIANTS = {
    "base": [],
    "bound_none": [("__launch_bounds__(NPIX, 6)", "__launch_bounds__(NPIX)")],
    "bound5": [("__launch_bounds__(NPIX, 6)", "__launch_bounds__(NPIX, 5)")],
}


def ctas_per_sm(regs, smem_bytes, threads=256):
    """CTAs of `threads` threads an H100 SM holds with `regs` registers a
    thread (allocated per warp in units of 256) and `smem_bytes` of shared
    memory a CTA (+1 KB reserved per CTA, 228 KB per SM)."""
    warps = threads // 32
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = 65536 // (per_warp * warps)
    by_smem = (228 * 1024) // (smem_bytes + 1024) if smem_bytes else 32
    return min(by_regs, by_smem, 2048 // threads, 32)


def ptxas_summary(log):
    """[{kernel, registers, smem_bytes, spill_store_bytes, ctas_per_sm}]
    from nvcc -Xptxas -v."""
    out, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and name:
            regs, smem = int(m.group(1)), int(m.group(2))
            out.append(dict(kernel=name[:60], registers=regs,
                            smem_bytes=smem, spill_store_bytes=spill,
                            ctas_per_sm=ctas_per_sm(regs, smem)))
    return out


def build_all(build, csrc):
    """Compile every K4′ and K1′ variant, all nvcc processes at once;
    returns ({name: library}, {name: ptxas summary})."""
    headers = [f for f in os.listdir(csrc) if f.endswith(".cuh")]
    jobs = {f"gs_tile_fwd:{v}": ("gs_tile_fwd", e)
            for v, e in TILE_VARIANTS.items()}
    jobs.update({f"gs_flat_fwd:{v}": ("gs_flat_fwd", e)
                 for v, e in FLAT_VARIANTS.items()})
    procs = {}
    for key, (src, edits) in jobs.items():
        d = tempfile.mkdtemp(prefix=key.replace(":", "_") + "_")
        text = open(os.path.join(csrc, src + ".cu")).read()
        for a, b in edits:
            assert a in text, (key, a)
            text = text.replace(a, b)
        with open(os.path.join(d, src + ".cu"), "w") as f:
            f.write(text)
        for h in headers:
            with open(os.path.join(csrc, h)) as fi, \
                    open(os.path.join(d, h), "w") as fo:
                fo.write(fi.read())
        so = os.path.join(d, "lib.so")
        procs[key] = (src, so, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", so,
             os.path.join(d, src + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs, ptxas = {}, {}
    for key, (src, so, proc) in procs.items():
        log, _ = proc.communicate()
        log = log.decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        ptxas[key] = ptxas_summary(log)
        libs[key] = ctypes.CDLL(so)
    return libs, ptxas


def main(csrc=None, out_path=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_fwd_split: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as S
    from comfy3d_tpu_torch.core.camera import Camera, compose_orbit_camposes
    from comfy3d_tpu_torch.ops import _build
    from comfy3d_tpu_torch.ops import gs_render as G

    csrc = os.path.abspath(csrc or _build.CSRC)
    dev = torch.device("cuda")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs, ptxas = build_all(_build, csrc)
    fns = {}
    for key, lib in libs.items():
        fn = fns[key] = getattr(lib, key.split(":")[0])
        fn.restype = i32
        fn.argtypes = ([vp, i64, i32, vp, vp, vp] + [i32] * 4 + [vp] * 4
                       if key.startswith("gs_tile") else
                       [vp, i64, i32, vp, i64, vp] + [i32] * 7 + [vp] * 4)
    set_order = libs["gs_tile_fwd:longest_first"].gs_tile_fwd_set_order
    set_order.argtypes, set_order.restype = [vp], i32

    render_splat = S.make_splat(100_000, 0.01, 0, dev)
    pose = compose_orbit_camposes([2.2], [15.0], [30.0])[0]
    render_cam = Camera.from_camposes(pose, width=800, height=800,
                                      device=dev)
    train_splat = S.pad_dead(S.make_splat(100_000, 0.01, 5, dev),
                             S.DEAD_SLOTS)
    train_cam = Camera.from_orbit(0.0, 0.0, 2.2, width=800, height=800,
                                  device=dev)
    cells = {"render_m1024": (render_splat, render_cam, 1024),
             "train_m512": (train_splat, train_cam, 512)}

    def tile_call(key, inp):
        t = inp["data"].shape[0]
        acc = torch.empty((t, inp["C"], 256), device=dev)
        tr = torch.empty((t, 1, 256), device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        rows = inp["rows"]
        err = fns[key](rows.data_ptr(), *rows.shape,
                       inp["prim_idx"].data_ptr(), inp["valid"].data_ptr(),
                       inp["counts"].data_ptr(), t, inp["prim_idx"].shape[1],
                       inp["grid_w"], inp["C"], acc.data_ptr(), tr.data_ptr(),
                       None, stream)
        if err != 0:
            raise RuntimeError(f"{key} launch failed: CUDA error {err}")
        return acc, tr

    def flat_call(inp, merged, key="gs_flat_fwd:base"):
        nbins = inp["nbx"] * inp["nby"]
        acc = torch.empty((nbins, 4, inp["C"], 256), device=dev)
        tr = torch.empty((nbins, 4, 1, 256), device=dev)
        st = torch.empty((nbins, 4), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        geo = (nbins, inp["nbx"], inp["C"], 2, inp["W"], inp["H"],
               int(merged), acc.data_ptr(), tr.data_ptr(), st.data_ptr(),
               stream)
        rows = inp["rows"]
        err = fns[key](rows.data_ptr(), *rows.shape, inp["sprim"].data_ptr(),
                       inp["sprim"].numel(), inp["bounds"].data_ptr(), *geo)
        if err != 0:
            raise RuntimeError(f"gs_flat_fwd launch failed: CUDA error {err}")
        return acc, tr, st

    rec = dict(device=torch.cuda.get_device_name(0),
               nvidia_smi=S.smi("name,power.limit"), csrc=csrc,
               ptxas=ptxas, ms={}, cells={})
    inputs = {}
    for cell, (splat, cam, m) in cells.items():
        t_inp = S.tile_inputs(splat, cam, m)
        f_inp = S.flat_inputs(splat, cam)
        inputs[cell] = (t_inp, f_inp)
        acc, tr = tile_call("gs_tile_fwd:base", t_inp)
        p_acc, p_tr = S.tile_plain(t_inp)
        f_acc, f_tr, f_st = flat_call(f_inp, True)
        walks = torch.div(t_inp["counts"] + 127, 128, rounding_mode="floor")
        in_img = S.subtiles_in_image(f_inp)
        bin_walks = torch.where(in_img, f_st, torch.zeros_like(f_st)) \
            .amax(-1).float()
        gather_t = S.profile_frames(
            lambda: G._build_tile_data(*t_inp["gather_args"]), 3)
        gather_f = S.profile_frames(
            lambda: S.flat_gather(f_inp), 3)
        rec["cells"][cell] = dict(
            max_per_tile=m,
            k4_vs_plain_max_abs_err=max(float((acc - p_acc).abs().max()),
                                        float((tr - p_tr).abs().max())),
            k4_walk_chunks_max=int(walks.max()),
            k4_walk_chunks_mean=float(walks.float().mean()),
            k4_ctas=walks.numel(),
            k1_walk_chunks_max=int(bin_walks.max()),
            k1_walk_chunks_mean=float(bin_walks.mean()),
            k1_bins=bin_walks.numel(),
            tile_gather_device_ms=gather_t["device_busy_ms"],
            tile_gather_top=gather_t["top"][:3],
            flat_gather_device_ms=gather_f["device_busy_ms"],
            flat_gather_top=gather_f["top"][:3],
            tile_box=S.tile_box_stats(t_inp),
            flat_box=S.flat_box_stats(f_inp, f_st))
        print(json.dumps({cell: rec["cells"][cell]}), file=sys.stderr,
              flush=True)
    tile_keys = [k for k in fns if k.startswith("gs_tile")]
    # the longest_first variant's tile order for each cell, kept alive
    orders = {cell: torch.argsort(inputs[cell][0]["counts"], descending=True,
                                  stable=True).to(torch.int32)
              for cell in cells}

    def use_order(cell):
        err = set_order(orders[cell].data_ptr())
        if err != 0:
            raise RuntimeError(f"gs_tile_fwd_set_order: CUDA error {err}")

    for cell in cells:                      # warm-up, then two rounds
        t_inp, f_inp = inputs[cell]
        use_order(cell)
        for key in tile_keys:
            tile_call(key, t_inp)
    for _ in range(2):
        for cell in cells:
            t_inp, f_inp = inputs[cell]
            use_order(cell)
            for key in tile_keys:
                rec["ms"].setdefault(f"{cell}:{key}", []).append(
                    S.cuda_ms(lambda: tile_call(key, t_inp), 20))
            rec["ms"].setdefault(f"{cell}:argsort_counts", []).append(
                S.cuda_ms(lambda: torch.argsort(
                    t_inp["counts"], descending=True, stable=True), 20))
            for key in (k for k in fns if k.startswith("gs_flat")):
                for merged in (True, False):
                    name = "merged" if merged else "per_subtile"
                    rec["ms"].setdefault(f"{cell}:{key}:{name}",
                                         []).append(S.cuda_ms(
                                             lambda: flat_call(f_inp, merged,
                                                               key), 20))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", help="the kernel sources to build (default: "
                    "this tree's comfy3d_tpu_torch/csrc)")
    ap.add_argument("--out", help="also write the record (JSON) here")
    a = ap.parse_args()
    sys.exit(main(a.csrc, a.out))
