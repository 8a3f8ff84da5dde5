#!/usr/bin/env python3
"""The GS→mesh converter's NeRF surface on structured splat scenes, on one
NVIDIA GPU.

    python3 chip_gs_to_mesh_scenes.py [--out RECORD.json]   # one card

Runs the geometry half of `algorithms/gs_to_mesh.py::convert` at
`GSToMeshConfig()` (the 24-view orbit at 256², the 384-iteration NeRF fit
at `NGPConfig()` widths, `density_grid` at 192³, `extract_isosurface` at
σ = 10, `native.clean_mesh`) on four scenes of splats of radius 0.5, each
made from a seed by `chip_smoke.shell_splat`:
  shell_opaque  20,000 splats on the sphere, scale 0.02, opacity 0.95:
                about 16 splats' Gaussian weight covers each point of the
                wall, so one wall stops the light;
  shell_0.7     the same shell at opacity 0.076 per splat (a wall lets
                about 30 % of the light through, so the fit sees the
                interior; `chip_smoke.py` phase 15b's scene);
  shell_0.4     opacity 0.029 (about 60 % through);
  ball_opaque   40,000 splats filling the ball, opacity 0.95.
For each: the renders' mean alpha, the fit's reported losses, the faces
extracted and kept by the clean, the radii of their vertices (mean,
percentiles, the share within 0.1 of 0.5), σ's median over 64 seeded
directions at radii 0–0.95, and the seconds taken. Prints one JSON object
with the card's name and power limit. Needs a card; without one it
raises.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

OPAQUE = 1.0 / (1.0 + math.exp(-3.0))     # 0.953
SCENES = {  # name: (splats, filled, opacity per splat)
    "shell_opaque": (20_000, False, OPAQUE),
    "shell_0.7": (20_000, False, 0.076),
    "shell_0.4": (20_000, False, 0.029),
    "ball_opaque": (40_000, True, OPAQUE),
}
RADIUS = 0.5


def radii_stats(v):
    import numpy as np
    r = np.linalg.norm(v, axis=1) if len(v) else np.zeros(1)
    return {"mean": float(r.mean()),
            "pct_5_25_50_75_95": np.percentile(r, [5, 25, 50, 75, 95])
            .tolist(),
            "share_within_0.1": float((np.abs(r - RADIUS) <= 0.1).mean())}


def main(out_path=None) -> int:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_gs_to_mesh_scenes.py runs on the card")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from comfy3d_tpu_torch import native
    from comfy3d_tpu_torch.algorithms import gs_to_mesh as g2m
    from comfy3d_tpu_torch.algorithms import ngp
    from comfy3d_tpu_torch.ops import gs_render, tetra

    dev = torch.device("cuda")
    cfg = g2m.GSToMeshConfig()
    ncfg = ngp.NGPConfig(iterations=cfg.ngp_iters)
    cams = g2m.orbit_cameras(cfg, device=dev)
    dirs = torch.nn.functional.normalize(torch.randn(
        64, 3, generator=torch.Generator().manual_seed(0)), dim=-1).to(dev)
    rs = [round(0.05 * i, 2) for i in range(20)]
    rec = {"card": cs.smi("name,power.limit"), "config":
           dataclasses.asdict(cfg), "scale": cs.SHELL_SCALE,
           "radius": RADIUS}
    for name, (n, filled, opacity) in SCENES.items():
        t0 = time.perf_counter()
        splat = cs.shell_splat(dev, n, opacity=opacity, filled=filled)
        with torch.no_grad():
            out = gs_render.render(splat, cams, background=(1.0, 1.0, 1.0))
        losses = []
        field, _ = ngp.fit(cams, out["image"], (out["alpha"] > 0.5).float(),
                           ncfg, progress=lambda it, m: losses.append(
                               m["loss"]), device=dev)
        grid = ngp.density_grid(field, ncfg, res=cfg.grid_resolution)
        mesh = tetra.extract_isosurface(grid, iso=cfg.density_threshold,
                                        max_tris=g2m.MAX_TRIS)
        v, f = native.clean_mesh(mesh.v, mesh.f,
                                 min_component_frac=cfg.clean_min_component)
        with torch.no_grad():
            sigma = [float(field.density(dirs * r)[0].median()) for r in rs]
        torch.cuda.synchronize()
        rec[name] = {
            "splats": n, "filled": filled, "opacity": opacity,
            "mean_alpha": float(out["alpha"].mean()), "losses": losses,
            "faces_extracted": mesh.num_faces, "extracted": radii_stats(
                mesh.v), "faces_cleaned": len(f), "cleaned": radii_stats(v),
            "sigma_median_by_radius": dict(zip(map(str, rs), sigma)),
            "s": time.perf_counter() - t0}
        cs.log(f"{name}: {rec[name]}")
        del field, grid, mesh, out
        torch.cuda.empty_cache()
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as fh:
            json.dump(rec, fh, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the record (JSON) here")
    sys.exit(main(ap.parse_args().out))
