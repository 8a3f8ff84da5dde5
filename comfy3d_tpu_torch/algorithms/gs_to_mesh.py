"""3DGS → textured mesh by NeRF distillation and marching tets.

Port of `comfy3d_tpu/algorithms/gs_to_mesh.py`, the converter behind the
`Convert_3DGS_to_Mesh_with_NeRF_and_Marching_Cubes` node (the reference's
LGM `GSConverterNeRFMarchingCubes`): render the splats from an orbit
(`ops/gs_render.py`, the coarse-bin compositor K1′ on the card), fit a
hash-grid NeRF to the renders (`algorithms/ngp.py`), sample its density on
a grid and extract the surface (`ops/tetra.py`), clean and decimate it on
the host (`native/`), unwrap it (`ops/texture.py::auto_unwrap`) and bake the
NeRF's colour into an albedo.

Each stage runs inside a `torch.profiler.record_function` span named in
`STAGES`, so a profile splits the converter's time by stage.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from .. import native, resolve_device
from ..core.camera import Camera
from ..core.gaussian import GaussianSplat
from ..core.mesh import Mesh
from ..ops import gs_render, tetra, texture as texture_ops
from . import ngp as ngp_mod

# the `record_function` spans of `convert`, in order
STAGES = ("gs_to_mesh.render", "gs_to_mesh.fit", "gs_to_mesh.density_grid",
          "gs_to_mesh.extract", "gs_to_mesh.clean_decimate",
          "gs_to_mesh.unwrap", "gs_to_mesh.bake")
# `extract_isosurface`'s triangle capacity (doubled up to 8× on overflow)
MAX_TRIS = 4_000_000


@dataclasses.dataclass(frozen=True)
class GSToMeshConfig:
    n_views: int = 24
    render_size: int = 256
    radius: float = 2.0
    fovy_deg: float = 49.1
    ngp_iters: int = 384
    grid_resolution: int = 192
    density_threshold: float = 10.0
    decimate_target: int = 100_000
    texture_size: int = 1024
    clean_min_component: float = 0.05
    bake_texture: bool = True


def orbit_cameras(cfg: GSToMeshConfig, device=None) -> Camera:
    """The supervision orbit: `n_views` cameras at elevations −30/0/30
    repeating and azimuths i·360/n, at `radius`, `fovy_deg`, square
    `render_size`; on `device` (default: the card)."""
    n = cfg.n_views
    elevs = np.tile([-30.0, 0.0, 30.0], -(-n // 3))[:n].astype(np.float32)
    azims = np.arange(n, dtype=np.float32) * np.float32(360.0 / n)
    return Camera.from_orbit(elevs, azims, cfg.radius, fovy_deg=cfg.fovy_deg,
                             width=cfg.render_size, height=cfg.render_size,
                             device=resolve_device(device))


def convert(splat: GaussianSplat, cfg: GSToMeshConfig = GSToMeshConfig(),
            seed: int = 0, progress=None, draws=None, init=None,
            info: dict | None = None) -> Mesh:
    """Splats → a `Mesh` with `vt`, `ft` and an `albedo` (when
    `cfg.bake_texture`), on the splat's device (the card unless the caller
    made the splat on the CPU).

    `seed` seeds the NeRF's init and draws; `draws` and `init` go to
    `ngp.fit` (a test's replayed draws and initial field). `progress(it,
    {"loss"})` gets the fit's loss every 50 iterations. `info`, when given,
    receives the counts of the stages: faces extracted, after clean and
    after decimate, the unwrap that ran."""
    dev = splat.device
    info = {} if info is None else info

    # 1. the supervision set: the splats from an orbit, over white
    with record_function(STAGES[0]):
        cams = orbit_cameras(cfg, device=dev)
        out = gs_render.render(splat, cams, background=(1.0, 1.0, 1.0))
        images = out["image"]
        masks = (out["alpha"] > 0.5).float()

    # 2. distill into a hash-grid NeRF
    ncfg = ngp_mod.NGPConfig(iterations=cfg.ngp_iters)
    with record_function(STAGES[1]):
        field, _ = ngp_mod.fit(cams, images, masks, ncfg, seed=seed,
                               progress=progress, draws=draws, init=init,
                               device=dev)

    # 3. density grid → marching tets → clean and decimate
    with record_function(STAGES[2]):
        grid = ngp_mod.density_grid(field, ncfg, res=cfg.grid_resolution)
    with record_function(STAGES[3]):
        mesh = tetra.extract_isosurface(grid, iso=cfg.density_threshold,
                                        max_tris=MAX_TRIS, device=dev)
    info["faces_extracted"] = mesh.num_faces
    if mesh.num_faces == 0:
        return mesh
    with record_function(STAGES[4]):
        v, f = native.clean_mesh(mesh.v, mesh.f,
                                 min_component_frac=cfg.clean_min_component)
        info["faces_cleaned"] = len(f)
        if len(f) > cfg.decimate_target:
            v, f = native.decimate_mesh(v, f, cfg.decimate_target)
        info["faces"] = len(f)
        mesh = Mesh(v=v, f=f).auto_normal()

    # 4. unwrap, and bake the NeRF's colour field
    if cfg.bake_texture and mesh.num_faces:
        with record_function(STAGES[5]):
            vt, ft, info["unwrap"] = texture_ops.auto_unwrap(mesh.v, mesh.f)
        with record_function(STAGES[6]):

            def color_fn(pts):
                dirs = -pts / torch.linalg.vector_norm(
                    pts, dim=-1, keepdim=True).clamp_min(1e-8)
                return field.field(pts, dirs)[1]

            albedo = texture_ops.bake_color_fn(
                mesh.v, mesh.f, vt, ft, color_fn,
                texture_size=cfg.texture_size, device=dev)
            mesh = dataclasses.replace(
                mesh, vt=vt, ft=ft,
                albedo=albedo.clamp(0.0, 1.0).cpu().numpy())
    return mesh
