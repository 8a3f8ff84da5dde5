#!/usr/bin/env python3
"""Split the time of the soft-silhouette kernels on one NVIDIA GPU.

    python3 chip_sil_split.py [--parent PARENT/comfy3d_tpu_torch/csrc]
                              [--out RECORD.json]     # repository root

On `chip_smoke.py` phase 22's inputs (22b: the FlexiCubes fit's initial
res-128 training surface, view 0 at 512²; 22a: a seeded res-64 surface at
256²; σ 3e-4) it times `csrc/soft_silhouette.cu`'s forward and backward
with CUDA events, through their wrappers, at 1 to 64 face splits a tile
and at the wrappers' default, and builds source variants of it to split
the time:
  base       the kernels as built for the port;
  scan_only  the record pre-pass, the scan, the compaction and the gather,
             but no pair walked;
  timed      base with each CTA's start and end read from %globaltimer:
             the heaviest tile's time against the mean, and the span.
With `--parent`, the csrc directory of a tree whose silhouette kernels walk
every face for every pixel (the design before the window) is built too and
run in turns with this tree's (parent, change, change, parent): its L
against this tree's, bit for bit at one split, and its gradients. Counts
the pairs: every ok face against every pixel, the live ones (sigmoid
argument at least -87) and the ones the window walks (`rasterize.
silhouette_window` at each warp), per tile too. Prints one JSON object with
the card's name and power limit. Needs nvcc and a card; without either it
raises.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
SIGMA = 3e-4
SPLITS = (1, 4, 8, 16, 32, 64)
ITERS = 5

TIMER_DECL = """
__device__ unsigned long long sil_cta_t[2 * 262144];
__device__ __forceinline__ unsigned long long sil_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void sil_stamp(unsigned long long t0) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long b = blockIdx.x + (long long)gridDim.x *
                        (blockIdx.y + (long long)gridDim.y * blockIdx.z);
    sil_cta_t[2 * b] = t0;
    sil_cta_t[2 * b + 1] = sil_now();
  }
}
"""
TIMER_READ = """
extern "C" int sil_read_cta_times(unsigned long long* host, long long n) {
  return (int)cudaMemcpyFromSymbol(host, sil_cta_t, 16 * n);
}
"""
PLACE = "  const Place p = place(nf, h, w, splits);\n"
FWD_END = "  if (p.x < w && p.y < h)\n    out["
BWD_END = ("      gacc[i] = 0.0f;\n    }\n  });\n")
WALK = "    for (int j = 0; j < n; ++j) {\n      if (!(warps[j] & me))"


def variants(src):
    """{name: source} of the base source `src`."""
    for anchor in (PLACE, FWD_END, BWD_END, WALK, "}  // namespace\n"):
        assert anchor in src, anchor
    timed = src.replace("namespace {\n", "namespace {\n" + TIMER_DECL, 1)
    timed = timed.replace(
        PLACE, PLACE + "  const unsigned long long t_start = sil_now();\n")
    timed = timed.replace(FWD_END, "  sil_stamp(t_start);\n" + FWD_END)
    timed = timed.replace(BWD_END, BWD_END + "  sil_stamp(t_start);\n")
    timed += TIMER_READ
    scan = src.replace(WALK, WALK.replace("j < n", "j < 0"))
    return {"base": src, "scan_only": scan, "timed": timed}


def build_all(build, parent):
    """Compile every variant (and the parent's source), all nvcc processes
    at once; returns ({name: ctypes library}, {name: ptxas lines})."""
    src = open(os.path.join(build.CSRC, "soft_silhouette.cu")).read()
    srcs = variants(src)
    if parent:
        srcs["parent"] = open(os.path.join(parent,
                                           "soft_silhouette.cu")).read()
    procs = {}
    for name, text in srcs.items():
        d = tempfile.mkdtemp(prefix=f"sil_{name}_")
        cu = os.path.join(d, "soft_silhouette.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(d, "lib.so")
        procs[name] = (so, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs, ptxas = {}, {}
    for name, (so, proc) in procs.items():
        out = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        ptxas[name] = [ln.strip() for ln in out.splitlines()
                       if "registers" in ln or "spill" in ln]
        libs[name] = ctypes.CDLL(so)
    return libs, ptxas


def bind(lib, old=False):
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if old:
        lib.soft_silhouette_fwd.argtypes = [vp, vp, i32, i32, i32, f32, f32,
                                            vp, vp]
        lib.soft_silhouette_bwd.argtypes = [vp, vp, i32, i32, i32, f32, f32,
                                            vp, vp, vp]
    else:
        lib.soft_silhouette_fwd.argtypes = [vp, vp, i32, i32, i32, f32, f32,
                                            f32, i32, vp, vp, vp, vp]
        lib.soft_silhouette_bwd.argtypes = [vp, vp, i32, i32, i32, f32, f32,
                                            f32, i32, vp, vp, vp, vp]
    for fn in (lib.soft_silhouette_fwd, lib.soft_silhouette_bwd):
        fn.restype = i32
    lib.soft_silhouette_error_string.argtypes = [i32]
    lib.soft_silhouette_error_string.restype = ctypes.c_char_p
    lib._argtypes_set = True
    return lib


def main(parent=None, out_path=None):
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_sil_split: no CUDA device")
    sys.path.insert(0, HERE)
    import chip_smoke as CS
    from comfy3d_tpu_torch.algorithms import sdf_fit
    from comfy3d_tpu_torch.core.camera import Camera
    from comfy3d_tpu_torch.nodes import NODE_CLASS_MAPPINGS
    from comfy3d_tpu_torch.ops import _build
    from comfy3d_tpu_torch.ops import flexicubes as FC
    from comfy3d_tpu_torch.ops import rasterize as R

    dev = torch.device("cuda")
    rec = {"card": CS.smi("name,power.limit"),
           "kind": torch.cuda.get_device_name(0), "sigma": SIGMA}
    libs, rec["ptxas"] = build_all(_build, parent)
    for name, lib in libs.items():
        bind(lib, old=name == "parent")
    sil_lib, sil_splits = R._sil_lib, R._sil_splits

    def use(name):
        R._sil_lib = lambda: libs[name]

    def splits(s):
        """The wrappers' face ranges a tile: s, or their own rule."""
        R._sil_splits = sil_splits if s is None else (lambda *a: s)

    def surface(res, noise_seed=None):
        cfg = sdf_fit.SDFFitConfig(resolution=res)
        params, grid, _ = sdf_fit.init_params(cfg, device=dev)
        with torch.no_grad():
            v, w = grid, params["weights"]
            if noise_seed is not None:      # chip_smoke phase 22a's surface
                g = torch.Generator(dev).manual_seed(noise_seed)
                v = grid + (0.3 * 2.0 / res) * torch.randn(
                    grid.shape, generator=g, device=dev)
                w = 0.5 * torch.randn(w.shape, generator=g, device=dev)
            vd, _, faces, _, _ = FC.flexicubes(params["sdf"], v, res,
                                               weights=w, training=True)
            return vd[faces].reshape(-1, 3).contiguous()

    orbit = CS._orbit(2, CS.MR_RADIUS)
    poses = NODE_CLASS_MAPPINGS[orbit[1]]().stack_poses(*orbit[2])[0]
    cams = Camera.from_camposes(poses, fovy_deg=49.1, width=CS.FC_SIZE,
                                height=CS.FC_SIZE, device=dev)
    cam_a = Camera.from_orbit([15.0], [30.0], CS.MR_RADIUS,
                              width=CS.SIL_SIZE, height=CS.SIL_SIZE,
                              device=dev)
    cases = {"22b_res128_512": (surface(CS.FC_RES), cams.view_proj[0],
                                CS.FC_SIZE),
             "22a_res64_256": (surface(CS.SIL_RES, 22), cam_a.view_proj[0],
                               CS.SIL_SIZE)}
    for label, (flat, mvp, size) in cases.items():
        faces = torch.arange(flat.shape[0], device=dev,
                             dtype=torch.int32).reshape(-1, 3)
        tri, ok = R._face_screen(flat, faces, mvp, size, size, None)
        tri = tri.detach().contiguous()
        g = torch.Generator(dev).manual_seed(2)
        g_l = torch.randn((size, size), generator=g, device=dev)
        r = rec[label] = dict(faces=int(tri.shape[0]), ok_faces=int(ok.sum()),
                              size=size)
        pairs, live = CS.silhouette_pairs(tri, ok, size, size)
        walk = CS.silhouette_walk(tri, ok, size, size)
        r.update(pairs=pairs, live_pairs=live, walked_pairs=walk["pairs"],
                 tile_pairs_max=walk["tile_max"],
                 tile_pairs_mean=walk["tile_mean"],
                 kept_everywhere=walk["kept_everywhere"],
                 reach=R.silhouette_reach(SIGMA, size, size))

        def fwd(s=None):
            splits(s)
            return R.soft_silhouette_fwd(tri, ok, size, size, SIGMA)

        def bwd(s=None):
            splits(s)
            return R.soft_silhouette_bwd(tri, ok, g_l, size, size, SIGMA)

        def old_fwd():
            lib = libs["parent"]
            out = torch.empty((size, size), device=dev)
            err = lib.soft_silhouette_fwd(
                tri.data_ptr(), ok8.data_ptr(), tri.shape[0], size, size,
                1.0 / size, 1.0 / SIGMA, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
            return out

        def old_bwd():
            lib = libs["parent"]
            gt = torch.zeros_like(tri)
            err = lib.soft_silhouette_bwd(
                tri.data_ptr(), ok8.data_ptr(), tri.shape[0], size, size,
                1.0 / size, 1.0 / SIGMA, g_l.data_ptr(), gt.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
            return gt

        ok8 = ok.to(torch.uint8).contiguous()
        use("base")
        L1, G1 = fwd(1), bwd(1)
        torch.cuda.synchronize()
        gmax = float(G1.abs().max())
        r["splits"] = {}
        for s in SPLITS:
            Ls, Gs = fwd(s), bwd(s)
            r["splits"][s] = dict(
                fwd_ms=CS.cuda_ms(lambda: fwd(s), ITERS, warmup=1),
                bwd_ms=CS.cuda_ms(lambda: bwd(s), ITERS, warmup=1),
                fwd_max_abs_vs_1=float((Ls - L1).abs().max()),
                bwd_max_rel_vs_1=float((Gs - G1).abs().max()) / gmax)
        best = min(SPLITS, key=lambda s: r["splits"][s]["fwd_ms"]
                   + r["splits"][s]["bwd_ms"])
        r["best_splits"] = best
        r["default_splits"] = sil_splits(tri.shape[0], size, size)
        r["default_ms"] = (CS.cuda_ms(fwd, ITERS, warmup=1),
                           CS.cuda_ms(bwd, ITERS, warmup=1))
        use("scan_only")
        r["scan_only"] = {s: dict(
            fwd_ms=CS.cuda_ms(lambda: fwd(s), ITERS, warmup=1),
            bwd_ms=CS.cuda_ms(lambda: bwd(s), ITERS, warmup=1))
            for s in sorted({1, best})}
        use("timed")
        lib = libs["timed"]
        lib.sil_read_cta_times.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
        r["cta_ns"] = {}
        for s in sorted({1, best}):
            ntile = (-(-size // 16)) ** 2
            for part, fn in (("fwd", fwd), ("bwd", bwd)):
                fn(s)
                torch.cuda.synchronize()
                n = ntile * s
                host = (ctypes.c_ulonglong * (2 * n))()
                assert lib.sil_read_cta_times(host, n) == 0
                t = torch.tensor(list(host), dtype=torch.float64).reshape(n, 2)
                d = t[:, 1] - t[:, 0]
                r["cta_ns"][f"{part}_{s}"] = dict(
                    max=float(d.max()), mean=float(d.mean()),
                    median=float(d.median()),
                    span=float(t[:, 1].max() - t[:, 0].min()))
        use("base")
        if parent:
            Lo, Go = old_fwd(), old_bwd()
            torch.cuda.synchronize()
            r["fwd_bit_equal_parent"] = bool(torch.equal(Lo, L1))
            r["fwd_max_abs_vs_parent"] = float((Lo - L1).abs().max())
            r["bwd_max_rel_vs_parent"] = float(
                (Go - G1).abs().max()) / float(Go.abs().max())
            ab = []
            for who in ("parent", "change", "change", "parent"):
                if who == "parent":
                    ab.append((who, CS.cuda_ms(old_fwd, ITERS, warmup=1),
                               CS.cuda_ms(old_bwd, ITERS, warmup=1)))
                else:
                    ab.append((who, CS.cuda_ms(fwd, ITERS, warmup=1),
                               CS.cuda_ms(bwd, ITERS, warmup=1)))
            r["ab_ms"] = ab
        print(json.dumps({label: r}), file=sys.stderr, flush=True)
    R._sil_lib, R._sil_splits = sil_lib, sil_splits
    line = json.dumps(rec)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="csrc directory of the full-walk tree")
    ap.add_argument("--out", help="also write the record (JSON) here")
    a = ap.parse_args()
    sys.exit(main(a.parent, a.out))
