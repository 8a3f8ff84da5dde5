"""Triangle-mesh container and its host-side geometry ops.

Port of `comfy3d_tpu/core/mesh.py` (the port's own copy). The canonical
`Mesh` lives on the host as numpy arrays, as in the JAX package: topology is
dynamic (loads, marching tets), file I/O is host work, and device paths take
fixed-capacity padded tensors from `device_arrays(device=...)`.

Fields: v [N,3] positions; f [M,3] int32 faces; vn/fn normals (+faces);
vt/ft uv coords (+faces); vc [N,3] vertex colours; albedo [H,W,3];
metallic_roughness [H,W,3] (G=roughness, B=metallic, glTF packing).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Mesh:
    v: np.ndarray                                  # [N, 3] float32
    f: np.ndarray                                  # [M, 3] int32
    vn: Optional[np.ndarray] = None                # [Nn, 3]
    fn: Optional[np.ndarray] = None                # [M, 3]
    vt: Optional[np.ndarray] = None                # [Nt, 2]
    ft: Optional[np.ndarray] = None                # [M, 3]
    vc: Optional[np.ndarray] = None                # [N, 3]
    albedo: Optional[np.ndarray] = None            # [H, W, 3] float32 [0,1]
    metallic_roughness: Optional[np.ndarray] = None  # [H, W, 3]

    def __post_init__(self):
        self.v = np.ascontiguousarray(self.v, dtype=np.float32)
        self.f = np.ascontiguousarray(self.f, dtype=np.int32)
        for name in ("vn", "vt", "vc", "albedo", "metallic_roughness"):
            a = getattr(self, name)
            if a is not None:
                setattr(self, name, np.ascontiguousarray(a, dtype=np.float32))
        for name in ("fn", "ft"):
            a = getattr(self, name)
            if a is not None:
                setattr(self, name, np.ascontiguousarray(a, dtype=np.int32))

    # ------------------------------------------------------------------ #
    # Introspection
    # ------------------------------------------------------------------ #
    @property
    def num_vertices(self) -> int:
        return int(self.v.shape[0])

    @property
    def num_faces(self) -> int:
        return int(self.f.shape[0])

    def aabb(self):
        return self.v.min(axis=0), self.v.max(axis=0)

    # ------------------------------------------------------------------ #
    # Canonical transforms
    # ------------------------------------------------------------------ #
    def auto_size(self, bound: float = 0.9) -> "Mesh":
        """Recenter and rescale into [-bound, bound]^3."""
        vmin, vmax = self.aabb()
        center = (vmin + vmax) / 2.0
        scale = 2.0 * bound / max(float((vmax - vmin).max()), 1e-20)
        return dataclasses.replace(
            self, v=(self.v - center) * scale, vn=self.vn, fn=self.fn)

    def auto_normal(self) -> "Mesh":
        """Area-weighted smooth vertex normals."""
        vn = vertex_normals_np(self.v, self.f)
        return dataclasses.replace(self, vn=vn, fn=self.f.copy())

    def flip_faces(self) -> "Mesh":
        out = dataclasses.replace(self, f=self.f[:, ::-1].copy())
        if out.fn is not None:
            out.fn = out.fn[:, ::-1].copy()
        if out.ft is not None:
            out.ft = out.ft[:, ::-1].copy()
        return out

    def switch_axis(self, axis: str = "-x+y+z") -> "Mesh":
        """Axis remap used by the Switch_Mesh_Axis node.

        `axis` is three signed axis tokens, e.g. "+y-z+x": output axis i is
        taken from the named input axis with the given sign.
        """
        v = _remap_axes(self.v, axis)
        out = dataclasses.replace(self, v=v)
        if self.vn is not None:
            out.vn = _remap_axes(self.vn, axis)
        # A reflection (odd number of sign flips / axis swaps) inverts
        # orientation; keep winding consistent.
        if _is_reflection(axis):
            out = out.flip_faces()
        return out

    def convert_to_pointcloud(self):
        """(points, colors) view of the vertex set."""
        colors = self.vc if self.vc is not None else np.ones_like(self.v) * 0.5
        return self.v.copy(), colors.copy()

    # ------------------------------------------------------------------ #
    # Device views
    # ------------------------------------------------------------------ #
    def device_arrays(self, capacity_v: Optional[int] = None,
                      capacity_f: Optional[int] = None, device=None):
        """Padded tensors on `device` (default: the card) for fixed-shape
        device compute.

        Returns a dict with `v`, `f`, `num_v`, `num_f` (+normals/uvs when
        present). Padding faces are degenerate (all indices 0) so rasterizers
        can cull them with a validity mask.
        """
        import torch

        from .. import resolve_device
        dev = resolve_device(device)

        def t(a):
            return torch.as_tensor(a, device=dev)

        cv = capacity_v or _round_up(self.num_vertices, 1024)
        cf = capacity_f or _round_up(self.num_faces, 1024)
        out = {
            "v": t(_pad(self.v, cv)),
            "f": t(_pad(self.f, cf)),
            "num_v": t(np.int32(self.num_vertices)),
            "num_f": t(np.int32(self.num_faces)),
        }
        if self.vn is not None and self.fn is not None:
            out["vn"] = t(_pad(self.vn, self.vn.shape[0] if
                               self.vn.shape[0] > cv else cv))
            out["fn"] = t(_pad(self.fn, cf))
        if self.vt is not None and self.ft is not None:
            out["vt"] = t(_pad(self.vt, max(cv, self.vt.shape[0])))
            out["ft"] = t(_pad(self.ft, cf))
        if self.vc is not None:
            out["vc"] = t(_pad(self.vc, cv))
        if self.albedo is not None:
            out["albedo"] = t(self.albedo)
        return out

    # ------------------------------------------------------------------ #
    # I/O (host)
    # ------------------------------------------------------------------ #
    @classmethod
    def load(cls, path: str) -> "Mesh":
        from .io import load_mesh
        return load_mesh(path)

    def write(self, path: str) -> None:
        from .io import save_mesh
        save_mesh(self, path)


def vertex_normals_np(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (numpy scatter-add)."""
    i0, i1, i2 = f[:, 0], f[:, 1], f[:, 2]
    e1 = v[i1] - v[i0]
    e2 = v[i2] - v[i0]
    fn = np.cross(e1, e2)  # magnitude ∝ 2*area → area weighting for free
    vn = np.zeros_like(v)
    np.add.at(vn, i0, fn)
    np.add.at(vn, i1, fn)
    np.add.at(vn, i2, fn)
    norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    return (vn / np.maximum(norm, 1e-20)).astype(np.float32)


_AXIS_IDX = {"x": 0, "y": 1, "z": 2}


def _parse_axis_spec(spec: str):
    spec = spec.replace(" ", "").lower()
    assert len(spec) == 6, f"axis spec must look like '+x-y+z', got {spec!r}"
    out = []
    for i in range(3):
        sign = 1.0 if spec[2 * i] == "+" else -1.0
        out.append((sign, _AXIS_IDX[spec[2 * i + 1]]))
    return out


def _remap_axes(arr: np.ndarray, spec: str) -> np.ndarray:
    parts = _parse_axis_spec(spec)
    return np.stack([sign * arr[:, idx] for sign, idx in parts],
                    axis=-1).astype(np.float32)


def _is_reflection(spec: str) -> bool:
    parts = _parse_axis_spec(spec)
    m = np.zeros((3, 3), np.float64)
    for i, (sign, idx) in enumerate(parts):
        m[i, idx] = sign
    return float(np.linalg.det(m)) < 0.0


def _pad(arr: np.ndarray, capacity: int) -> np.ndarray:
    n = arr.shape[0]
    if n >= capacity:
        return arr[:capacity]
    pad = np.zeros((capacity - n,) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def _round_up(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)
