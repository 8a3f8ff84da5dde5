"""3D Gaussian Splat container.

Port of `comfy3d_tpu/core/gaussian.py` as a dataclass of tensors. Storage is
in *raw* (pre-activation) space, like the GS-PLY schema, so PLY files
interoperate bit for bit with the JAX package's:
  xyz [N,3];  sh [N, K, 3] SH coefficients (K=(deg+1)^2, row 0 = DC);
  opacity_raw [N] (sigmoid→opacity);  scale_raw [N,3] (exp→scale);
  rot_raw [N,4] quaternion wxyz (normalize→unit).

Padded capacity: `alive` marks real Gaussians, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device as _resolve
from . import sh as sh_utils


@dataclasses.dataclass(frozen=True)
class GaussianSplat:
    xyz: torch.Tensor           # [N, 3]
    sh: torch.Tensor            # [N, K, 3]
    opacity_raw: torch.Tensor   # [N]
    scale_raw: torch.Tensor     # [N, 3]
    rot_raw: torch.Tensor       # [N, 4] wxyz
    alive: torch.Tensor         # [N] bool

    # ---------------- activations ---------------------------------------- #
    @property
    def num_capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def opacity(self):
        return torch.sigmoid(self.opacity_raw)

    @property
    def scale(self):
        return torch.exp(self.scale_raw)

    @property
    def rotation(self):
        q = self.rot_raw
        return q / torch.clamp_min(
            torch.linalg.vector_norm(q, dim=-1, keepdim=True), 1e-12)

    @property
    def sh_degree(self) -> int:
        return int(round(self.sh.shape[1] ** 0.5)) - 1

    def colors_toward(self, campos: torch.Tensor) -> torch.Tensor:
        """View-dependent RGB via SH toward a camera position. [N, 3]."""
        dirs = self.xyz - campos[None, :]
        dirs = dirs / torch.clamp_min(
            torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), 1e-12)
        shc = self.sh.transpose(1, 2)  # [N, 3, K]
        rgb = sh_utils.eval_sh(self.sh_degree, shc, dirs)
        return torch.clamp(rgb + 0.5, 0.0, 1.0)

    def covariance(self) -> torch.Tensor:
        """3D covariance Σ = R S Sᵀ Rᵀ, [N, 3, 3]."""
        R = quat_to_rotmat(self.rotation)
        RS = R * self.scale[:, None, :]
        return torch.einsum("nij,nkj->nik", RS, RS)

    # ---------------- constructors -------------------------------------- #
    @classmethod
    def from_points(cls, points, colors=None, sh_degree: int = 0,
                    capacity: int | None = None,
                    initial_scale: float | None = None,
                    device=None) -> "GaussianSplat":
        """Init from a point cloud; scales default to a global density
        estimate (extent / n^(1/3))."""
        points = np.asarray(points, np.float32)
        n = points.shape[0]
        cap = capacity or n
        K = (sh_degree + 1) ** 2

        if colors is None:
            colors = np.full((n, 3), 0.5, np.float32)
        sh = np.zeros((cap, K, 3), np.float32)
        sh[:n, 0] = sh_utils.rgb_to_sh(np.asarray(colors, np.float32))

        if initial_scale is None:
            extent = float((points.max(0) - points.min(0)).max()) if n else 1.0
            initial_scale = max(extent / max(n, 1) ** (1.0 / 3.0), 1e-4)
        xyz = np.zeros((cap, 3), np.float32)
        xyz[:n] = points
        scale_raw = np.full((cap, 3), np.log(initial_scale), np.float32)
        rot_raw = np.zeros((cap, 4), np.float32)
        rot_raw[:, 0] = 1.0
        opacity_raw = np.full((cap,), _inverse_sigmoid(0.1), np.float32)
        alive = np.zeros((cap,), bool)
        alive[:n] = True
        return _from_numpy(xyz, sh, opacity_raw, scale_raw, rot_raw, alive,
                           _resolve(device))

    @classmethod
    def random(cls, generator: torch.Generator, n: int, sh_degree: int = 0,
               radius: float = 0.5, device=None) -> "GaussianSplat":
        """Random points in a ball of `radius`, drawn from `generator` (on
        the generator's device), then `from_points` on `device`."""
        gdev = generator.device
        u = torch.rand((n, 3), generator=generator, device=gdev) * 2.0 - 1.0
        pts = u / torch.clamp_min(
            torch.linalg.vector_norm(u, dim=-1, keepdim=True), 1e-6)
        r = torch.rand((n, 1), generator=generator, device=gdev)
        pts = pts * r ** (1.0 / 3.0) * radius
        return cls.from_points(pts.cpu().numpy(), sh_degree=sh_degree,
                               device=device)

    # ---------------- PLY interop ---------------------------------------- #
    def to_ply_arrays(self):
        """Dict of numpy arrays in the GS-PLY column order."""
        n = self.num_capacity
        alive = self.alive.cpu().numpy()
        K = self.sh.shape[1]
        sh = self.sh.detach().cpu().numpy()
        f_dc = sh[:, 0, :]                                      # [N, 3]
        # GS-PLY layout: f_rest stored channel-major
        f_rest = np.transpose(sh[:, 1:, :], (0, 2, 1)).reshape(n, 3 * (K - 1))
        out = {
            "xyz": self.xyz.detach().cpu().numpy(),
            "normals": np.zeros((n, 3), np.float32),
            "f_dc": f_dc,
            "f_rest": f_rest,
            "opacity": self.opacity_raw.detach().cpu().numpy()[:, None],
            "scale": self.scale_raw.detach().cpu().numpy(),
            "rotation": self.rot_raw.detach().cpu().numpy(),
        }
        return {k: v[alive] for k, v in out.items()}

    @classmethod
    def from_ply_arrays(cls, xyz, f_dc, f_rest, opacity, scale, rotation,
                        capacity: int | None = None,
                        device=None) -> "GaussianSplat":
        n = xyz.shape[0]
        cap = capacity or n
        rest_cols = f_rest.shape[1] if f_rest is not None else 0
        K = 1 + rest_cols // 3
        sh = np.zeros((cap, K, 3), np.float32)
        sh[:n, 0] = f_dc
        if rest_cols:
            sh[:n, 1:] = np.transpose(
                f_rest.reshape(n, 3, K - 1), (0, 2, 1))

        def padded(a, shape):
            out = np.zeros((cap,) + shape, np.float32)
            out[:n] = a.reshape((n,) + shape)
            return out

        alive = np.zeros((cap,), bool)
        alive[:n] = True
        rot = padded(rotation, (4,))
        rot[n:, 0] = 1.0
        return _from_numpy(padded(xyz, (3,)), sh, padded(opacity, ()),
                           padded(scale, (3,)), rot, alive, _resolve(device))

    def switch_axis(self, spec: str = "+x+y+z") -> "GaussianSplat":
        """Axis remap for splats. Rotates xyz and the quaternion frame; SH
        beyond DC are left as they are (only positions are permuted)."""
        parts = _parse_axis_spec(spec)
        perm = [idx for _, idx in parts]
        signs = torch.tensor([s for s, _ in parts], device=self.device)
        xyz = self.xyz[:, perm] * signs[None, :]
        scale_raw = self.scale_raw[:, perm]
        m = torch.zeros((3, 3), device=self.device)
        for i, (s, idx) in enumerate(parts):
            m[i, idx] = s
        R = quat_to_rotmat(self.rotation)
        R2 = torch.einsum("ij,njk->nik", m, R)
        rot = rotmat_to_quat(R2)
        return dataclasses.replace(self, xyz=xyz, scale_raw=scale_raw,
                                   rot_raw=rot)


def _from_numpy(xyz, sh, opacity_raw, scale_raw, rot_raw, alive, device):
    t = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
    return GaussianSplat(xyz=t(xyz), sh=t(sh), opacity_raw=t(opacity_raw),
                         scale_raw=t(scale_raw), rot_raw=t(rot_raw),
                         alive=t(alive))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (wxyz) → rotation matrix. [..., 4] → [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → quaternion wxyz, branchless (numerically safe)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # four candidate constructions; pick the numerically largest pivot
    qw = torch.sqrt(torch.clamp_min(1 + tr, 1e-12)) / 2
    qx = torch.sqrt(torch.clamp_min(1 + m00 - m11 - m22, 1e-12)) / 2
    qy = torch.sqrt(torch.clamp_min(1 - m00 + m11 - m22, 1e-12)) / 2
    qz = torch.sqrt(torch.clamp_min(1 - m00 - m11 + m22, 1e-12)) / 2
    cand = torch.stack([
        torch.stack([qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw),
                     (m10 - m01) / (4 * qw)], -1),
        torch.stack([(m21 - m12) / (4 * qx), qx, (m01 + m10) / (4 * qx),
                     (m02 + m20) / (4 * qx)], -1),
        torch.stack([(m02 - m20) / (4 * qy), (m01 + m10) / (4 * qy), qy,
                     (m12 + m21) / (4 * qy)], -1),
        torch.stack([(m10 - m01) / (4 * qz), (m02 + m20) / (4 * qz),
                     (m12 + m21) / (4 * qz), qz], -1),
    ], -2)  # [..., 4, 4]
    pick = torch.argmax(torch.stack([tr, m00, m11, m22], -1), dim=-1)
    idx = pick[..., None, None].expand(pick.shape + (1, 4))
    q = torch.gather(cand, -2, idx)[..., 0, :]
    return q / torch.clamp_min(
        torch.linalg.vector_norm(q, dim=-1, keepdim=True), 1e-12)


_AXIS_IDX = {"x": 0, "y": 1, "z": 2}


def _parse_axis_spec(spec: str):
    """'+x-y+z' → [(sign, axis index)] * 3 (private copy of the JAX
    package's `core/mesh.py::_parse_axis_spec`)."""
    spec = spec.replace(" ", "").lower()
    if len(spec) != 6:
        raise ValueError(f"axis spec must look like '+x-y+z', got {spec!r}")
    out = []
    for i in range(3):
        sign = 1.0 if spec[2 * i] == "+" else -1.0
        out.append((sign, _AXIS_IDX[spec[2 * i + 1]]))
    return out


def _inverse_sigmoid(x: float) -> float:
    return float(np.log(x / (1.0 - x)))
