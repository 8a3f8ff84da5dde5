#!/usr/bin/env python3
"""Split the time of the two compositor backward kernels on one NVIDIA GPU.

    python3 chip_bwd_split.py [--out RECORD.json]   # repository root, one card

Builds source variants of `csrc/gs_tile_bwd.cu` (K5') and
`csrc/gs_flat_bwd.cu` (K3'), each with one part of the kernel taken out,
and times every variant with CUDA events on the same inputs: view 0 of
`chip_smoke.py`'s train cell (100k splats, 800², tile lists of 512 slots),
before training. The differences between variants split the kernel's time:
  base          the kernel as built for the port;
  no_atomics    the epilogue sums the partials but adds nothing to g;
  no_phase_b    phase A only (no slot-major sums, no epilogue);
  dead_only     phase A with every visit taken as dead, and no phase B:
                staging, the syncs and the visit test;
  fast_log_exp  (K5' only) the T rebuild with __logf(1 - a) and __expf in
                place of log1pf and expf, with its error against base.
Prints one JSON object with the card's name and power limit. Needs nvcc and
a card; without either it raises.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))

ATOMIC = "if (sum != 0.f) atomicAdd(g + (long long)row * L::NF + f, sum);"
NO_B = {"gs_tile_bwd": ["      slot_sums<C>(smem, j0, jn, ox, oy);\n",
                        "      add_rows<C>(smem, j0, jn, g);\n"],
        "gs_flat_bwd": ["      slot_sums<C>(smem, j0, jn, px0, py0);\n",
                        "      add_rows<C>(smem, j0, jn, g);\n"]}
LIVE = {"gs_tile_bwd": "if (power <= 0.f && raw >= ALPHA_MIN) {",
        "gs_flat_bwd": "if (raw >= ALPHA_MIN) {"}


def variants(src):
    """{name: (kernel source edits, header edits)} for source `src`."""
    no_b = [(line, "") for line in NO_B[src]]
    dead = [(LIVE[src], LIVE[src].replace(") {", " && op < -1.f) {"))]
    out = {"base": ([], []),
           "no_atomics": ([], [(ATOMIC, ATOMIC.replace("sum != 0.f",
                                                       "sum == 1.5e38f"))]),
           "no_phase_b": (no_b, []),
           "dead_only": (no_b + dead, [])}
    if src == "gs_tile_bwd":
        out["fast_log_exp"] = ([
            ("Lg = Lg - log1pf(-alpha);", "Lg = Lg - __logf(1.f - alpha);"),
            ("const float ti = expf(", "const float ti = __expf(")], [])
    return out


def build_all(build):
    """Compile every variant of both sources, all nvcc processes at once;
    returns {(src, name): the library's entry point}."""
    hdr = open(os.path.join(build.CSRC, "gs_bwd_common.cuh")).read()
    procs = {}
    for src in ("gs_tile_bwd", "gs_flat_bwd"):
        text = open(os.path.join(build.CSRC, src + ".cu")).read()
        for name, (edits, hdr_edits) in variants(src).items():
            d = tempfile.mkdtemp(prefix=f"{src}_{name}_")
            cu, h = text, hdr
            for a, b in edits:
                assert a in cu, (src, name, a)
                cu = cu.replace(a, b)
            for a, b in hdr_edits:
                assert a in h, (src, name, a)
                h = h.replace(a, b)
            with open(os.path.join(d, src + ".cu"), "w") as f:
                f.write(cu)
            with open(os.path.join(d, "gs_bwd_common.cuh"), "w") as f:
                f.write(h)
            so = os.path.join(d, "lib.so")
            procs[(src, name)] = (so, subprocess.Popen(
                [build.find_nvcc(), *build.NVCC_FLAGS, "-o", so,
                 os.path.join(d, src + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    fns = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log.decode()}")
        fns[key] = getattr(ctypes.CDLL(so), key[0])
    return fns


def main(out_path=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_bwd_split: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as S
    from comfy3d_tpu_torch.core.camera import Camera
    from comfy3d_tpu_torch.ops import _build, gs_flat, gs_tile

    dev = torch.device("cuda")
    splat = S.pad_dead(S.make_splat(100_000, 0.01, 5, dev), S.DEAD_SLOTS)
    cam = Camera.from_orbit(0.0, 0.0, 2.2, width=800, height=800, device=dev)
    t_inp = S.tile_inputs(splat, cam, 512)
    t_fwd = gs_tile.composite_tiles_fwd_rows(*S.tile_kernel_args(t_inp,
                                                                 True))
    t_args, _ = S.tile_bwd_args(t_inp, t_fwd, 11)
    f_inp = S.flat_inputs(splat, cam)
    f_fwd = gs_flat.composite_bins_fwd_rows(*S.flat_kernel_args(f_inp,
                                                                True)[0])
    f_args, _ = S.bwd_args(f_inp, f_fwd, 11)

    fns = build_all(_build)
    for (src, _), fn in fns.items():      # the port's own argument types
        ref = getattr(gs_tile if src == "gs_tile_bwd" else gs_flat, "_lib")
        fn.argtypes = getattr(ref(src), src).argtypes
        fn.restype = ctypes.c_int

    def call(key):
        """One launch of variant `key`, as the port's wrapper launches it."""
        stream = torch.cuda.current_stream().cuda_stream
        if key[0] == "gs_tile_bwd":
            data, counts, idx, valid, n, grid_w, tr, ga, gt, c = t_args
            g = torch.zeros((n, 6 + c), device=dev)
            err = fns[key](data.data_ptr(), counts.data_ptr(),
                           idx.data_ptr(), valid.data_ptr(), tr.data_ptr(),
                           ga.data_ptr(), gt.data_ptr(), *data.shape,
                           grid_w, c, n, g.data_ptr(), stream)
        else:
            (data, bounds, sprim, n, tr, stops, ga, gt, nbx, nby, c, w,
             h) = f_args
            g = torch.zeros((n, 6 + c), device=dev)
            err = fns[key](data.data_ptr(), data.shape[1], data.shape[0],
                           bounds.data_ptr(), sprim.data_ptr(),
                           sprim.numel(), tr.data_ptr(), stops.data_ptr(),
                           ga.data_ptr(), gt.data_ptr(), nbx * nby, nbx, c,
                           2, w, h, n, g.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"{key} launch failed: CUDA error {err}")
        return g

    rec = dict(device=torch.cuda.get_device_name(0),
               nvidia_smi=S.smi("name,power.limit"), ms={})
    for key in fns:                        # warm-up, then two rounds
        call(key)
    for _ in range(2):
        for key in fns:
            rec["ms"].setdefault(f"{key[0]}:{key[1]}", []).append(
                S.cuda_ms(lambda: call(key), 20))
    base = call(("gs_tile_bwd", "base"))
    fast = call(("gs_tile_bwd", "fast_log_exp"))
    rec["fast_log_exp_rel_err"] = float(
        ((fast - base).abs().amax(0) / base.abs().amax(0)).max())
    if out_path:
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the record (JSON) here")
    sys.exit(main(ap.parse_args().out))
