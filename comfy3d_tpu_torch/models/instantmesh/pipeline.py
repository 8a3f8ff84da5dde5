"""InstantMesh pipeline: posed views → triplanes → mesh with vertex colours.

Port of `comfy3d_tpu/models/instantmesh/pipeline.py`. Weights are either
drawn from a seed (`init_random`; drawn on the CPU, so a seed gives the
same weights on every device) or loaded from the upstream checkpoint's
native torch state dict (`from_pretrained`, strict, no conversion table).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from torch.profiler import record_function

from ... import resolve_device
from ...core.mesh import Mesh
from ...ops import tetra, volume
from ..common import init_weights_
from .model import InstantMesh, InstantMeshConfig

# the profiler spans of `InstantMeshPipeline.extract_mesh`, in the order it
# runs them: the lattice's SDF + deformation query, marching tets with the
# weld (every rung of the capacity ladder), the mesh's copy to the host,
# the vertex colours, the host's vertex normals
EXTRACT_STAGES = ("extract_mesh.geometry", "extract_mesh.sweep_weld",
                  "extract_mesh.to_host", "extract_mesh.colors",
                  "extract_mesh.normals")

# the capacity ladder's roof (triangles and welded vertices)
CAP_ROOF = 2_097_152


def orbit_poses_to_input_cameras(azimuths, elevations, radius=4.0,
                                 fov_deg=30.0):
    """The model's camera conditioning, z-up: each view's c2w (its first 3
    rows, flattened, 12) and normalised intrinsics (fx fy cx cy, 4) →
    [N, 16] float32 (numpy)."""
    az = np.deg2rad((np.asarray(azimuths, np.float64) + 360.0) % 360.0)
    el = np.deg2rad(-np.asarray(elevations, np.float64))
    r = np.broadcast_to(np.asarray(radius, np.float64), az.shape)
    xs = r * np.cos(el) * np.cos(az)
    ys = r * np.cos(el) * np.sin(az)
    zs = r * np.sin(el)
    campos = np.stack([xs, ys, zs], -1)

    up = np.array([0.0, 0.0, 1.0])
    z_axis = campos / np.linalg.norm(campos, axis=-1, keepdims=True)
    x_axis = np.cross(np.broadcast_to(up, z_axis.shape), z_axis)
    x_axis /= np.linalg.norm(x_axis, axis=-1, keepdims=True)
    y_axis = np.cross(z_axis, x_axis)
    c2w = np.concatenate([np.stack([x_axis, y_axis, z_axis], -1),
                          campos[..., None]], -1)        # [N, 3, 4]
    extr = c2w.reshape(len(az), 12)
    f = 0.5 / np.tan(np.deg2rad(fov_deg) * 0.5)
    intr = np.tile(np.array([f, f, 0.5, 0.5]), (len(az), 1))
    return np.concatenate([extr, intr], -1).astype(np.float32)


def _init_params(model: InstantMesh, generator: torch.Generator) -> None:
    """Seeded weights in the JAX package's scheme (`common.init_weights_`,
    which also draws the adaLN heads that flax starts at zero); the ViT's
    cls token and position grid normal with std 0.02 (HF's ViT init), the
    transformer's position tokens with std 1/sqrt(dim) (the flax init)."""
    init_weights_(model, generator)
    with torch.no_grad():
        emb = model.encoder.model.embeddings
        for p in (emb.cls_token, emb.position_embeddings):
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        pos = model.transformer.pos_embed
        pos.copy_(torch.randn(pos.shape, generator=generator)
                  / pos.shape[-1] ** 0.5)


def _as_f32(x, device):
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


class InstantMeshPipeline:
    def __init__(self, model: InstantMesh):
        self.model = model.eval()
        self.cfg = model.cfg
        # the capacity the ladder ended at, per resolution: warm calls
        # start there
        self._cap_memo = {}

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # -------------------------------------------------------------- #
    @classmethod
    def init_random(cls, seed: int = 0,
                    cfg: InstantMeshConfig = InstantMeshConfig(),
                    device=None) -> "InstantMeshPipeline":
        """Weights drawn from `seed`, placed on `device` (default: the
        card)."""
        dev = resolve_device(device)
        with torch.device("meta"):
            model = InstantMesh(cfg)
        model = model.to_empty(device="cpu")
        _init_params(model, torch.Generator().manual_seed(seed))
        return cls(model.to(dev))

    @classmethod
    def from_pretrained(cls, path: str,
                        cfg: InstantMeshConfig = InstantMeshConfig(),
                        device=None) -> "InstantMeshPipeline":
        """A torch state dict in the upstream checkpoint's layout (or a
        Lightning checkpoint holding one under `state_dict`), loaded
        strictly onto `device`."""
        dev = resolve_device(device)
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        with torch.device("meta"):
            model = InstantMesh(cfg)
        model.load_state_dict(sd, strict=True, assign=True)
        return cls(model.to(dev))

    # -------------------------------------------------------------- #
    @torch.no_grad()
    def forward_planes(self, images, cameras) -> torch.Tensor:
        """images [B, N, H, W, 3] in [0, 1]; cameras [B, N, 16] (numpy or
        tensors) → triplanes [B, 3, C, 64, 64]."""
        x = _as_f32(images, self.device).permute(0, 1, 4, 2, 3)
        return self.model(x, _as_f32(cameras, self.device))

    @torch.no_grad()
    def extract_mesh(self, planes, resolution: int | None = None,
                     max_tris: int | None = None, with_color: bool = True,
                     chunk: int = 1 << 20) -> Mesh:
        """One asset's triplanes [3, C, H, W] → marching-tets mesh over the
        deformed res³ lattice (res = `resolution`, default grid_res + 1),
        with uint8-quantized vertex colours; returns a host `Mesh`.

        The triangle capacity starts at `max_tris`, else at the one this
        resolution ended at before, else at min(2 M, max(262,144,
        24·(res − 1)²)), and doubles on overflow of the sweep or the weld
        up to `CAP_ROOF`, at most five rungs; the capacity reached is
        remembered per resolution, a clipped one too (with a warning).
        Each stage runs under a `torch.profiler.record_function` span named
        in `EXTRACT_STAGES`."""
        c = self.cfg
        res = resolution or (c.grid_res + 1)
        if max_tris is None:
            max_tris = self._cap_memo.get(
                res, min(2_000_000, max(262_144, 24 * (res - 1) ** 2)))
        dev = planes.device
        geometry, sweep, to_host, colors, normals = EXTRACT_STAGES

        with record_function(geometry):
            verts = torch.as_tensor(
                tetra.grid_vertices(res) * (c.grid_scale * 0.5), device=dev)

            def geo_fn(pts):
                sdf, deform = self.model.query_geometry(planes, pts)
                return torch.cat([sdf[:, None], deform], -1)

            geo = volume.query_chunked(geo_fn, verts, chunk=chunk)
            sdf = geo[:, 0].contiguous()
            v_def = verts + geo[:, 1:]
            del verts, geo

        with record_function(sweep):
            cap = min(max_tris, CAP_ROOF)
            for rung in range(5):
                if rung:                  # free the last rung's mesh first
                    del v, f
                soup, count, overflow = tetra.marching_tets_deformed(
                    v_def, sdf, res, max_tris=cap)
                v, f, nv, nf, v_ovf = tetra.weld_device(soup, count,
                                                        max_verts=cap)
                del soup
                done = not (overflow or v_ovf)
                if done or cap >= CAP_ROOF:
                    self._cap_memo[res] = cap
                    if not done:
                        warnings.warn("marching tets overflow in InstantMesh "
                                      f"extract_mesh (capacity {cap}, "
                                      "clipped)")
                    break
                cap = min(cap * 2, CAP_ROOF)
            del v_def, sdf

        with record_function(to_host):
            mesh = Mesh(v=v[:nv].cpu().numpy(), f=f[:nf].cpu().numpy())
        if with_color and nv:
            with record_function(colors):
                cols = volume.query_chunked(
                    lambda pts: self.model.query_color(planes, pts), v[:nv],
                    chunk=chunk)
                cols = torch.clamp(torch.round(cols * 255.0), 0, 255).to(
                    torch.uint8)
                mesh.vc = cols.cpu().numpy().astype(np.float32) / 255.0
        with record_function(normals):
            return mesh.auto_normal()
