"""Camera math: orbit poses, view/projection matrices, ray generation.

Port of `comfy3d_tpu/core/camera.py`. A camera is a dataclass of tensors
whose leading batch shape is shared by all fields; the conventions are the
JAX package's:
  * World: right-handed, +Y up.
  * Camera-to-world (c2w, "OpenGL"): camera looks down its -Z axis, +X
    right, +Y up.
  * Orbit poses are rows of [radius, elevation_deg, azimuth_deg, cx, cy, cz]
    (the `ORBIT_CAMPOSES` node protocol). Elevation > 0 puts the camera
    above the target looking down; azimuth 0 places it on +Z looking
    toward -Z, azimuth 90 on +X.
  * Projection: OpenGL-style clip space, z in [-1, 1] after divide.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .. import resolve_device as _resolve

# Per-model-family orbit pose presets ([elevation, azimuth] per view).
ORBITPOSE_PRESETS = {
    "FOUR_VIEWS": [[0.0, 0.0], [0.0, 90.0], [0.0, 180.0], [0.0, 270.0]],
    "SIX_VIEWS_ZERO123PLUS": [
        [30.0, 30.0], [-20.0, 90.0], [30.0, 150.0],
        [-20.0, 210.0], [30.0, 270.0], [-20.0, 330.0],
    ],
    "SIX_VIEWS_WONDER3D": [
        [0.0, 0.0], [0.0, 45.0], [0.0, 90.0],
        [0.0, 180.0], [0.0, 270.0], [0.0, 315.0],
    ],
    "CRM(6)": [
        [0.0, -90.0], [90.0, 0.0], [0.0, 180.0],
        [0.0, 90.0], [-90.0, 0.0], [0.0, 0.0],
    ],
    "Wonder3D(6)": [
        [0.0, 0.0], [0.0, 45.0], [0.0, 90.0],
        [0.0, 180.0], [0.0, -90.0], [0.0, -45.0],
    ],
    "Zero123Plus(6)": [
        [-20.0, 30.0], [10.0, 90.0], [-20.0, 150.0],
        [10.0, -150.0], [-20.0, -90.0], [10.0, -30.0],
    ],
    "Era3D(6)": [
        [0.0, 0.0], [0.0, 45.0], [0.0, 90.0],
        [0.0, 180.0], [0.0, -90.0], [0.0, -45.0],
    ],
    "MVDream(4)": [[0.0, 0.0], [0.0, 90.0], [0.0, 180.0], [0.0, -90.0]],
    "Unique3D(4)": [[0.0, 0.0], [0.0, 90.0], [0.0, 180.0], [0.0, -90.0]],
    "CharacterGen(4)": [
        [0.0, -90.0], [0.0, 180.0], [0.0, 90.0], [0.0, 0.0],
    ],
}


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def look_at(campos: torch.Tensor, target: torch.Tensor, up=None):
    """c2w rotation [..., 3, 3] for cameras at `campos` (a tensor [..., 3])
    looking at `target`; the result lies on `campos`'s device.

    Columns are the camera's (right, up, back) axes in world space."""
    campos = campos.to(torch.float32)
    target = _f32(target, campos.device)
    if up is None:
        up = torch.tensor([0.0, 1.0, 0.0], device=campos.device)
    back = _normalize(campos - target)          # camera +Z (looks down -Z)
    up = _f32(up, campos.device).expand_as(back)
    right = _normalize(torch.linalg.cross(up, back, dim=-1))
    up2 = _normalize(torch.linalg.cross(back, right, dim=-1))
    return torch.stack([right, up2, back], dim=-1)


def _normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v * torch.rsqrt(torch.clamp_min((v * v).sum(-1, keepdim=True),
                                           eps))


def orbit_c2w(elevation_deg, azimuth_deg, radius, target=None,
              device=None) -> torch.Tensor:
    """Camera-to-world 4x4 for orbit poses; broadcasts over leading dims."""
    device = _resolve(device)
    elevation = torch.deg2rad(_f32(elevation_deg, device))
    azimuth = torch.deg2rad(_f32(azimuth_deg, device))
    radius = _f32(radius, device)
    elevation, azimuth, radius = torch.broadcast_tensors(
        elevation, azimuth, radius)
    shape = elevation.shape
    if target is None:
        target = torch.zeros(shape + (3,), device=device)
    else:
        target = _f32(target, device).expand(shape + (3,))
    x = radius * torch.cos(elevation) * torch.sin(azimuth)
    y = radius * torch.sin(elevation)
    z = radius * torch.cos(elevation) * torch.cos(azimuth)
    campos = torch.stack([x, y, z], dim=-1) + target

    c2w = torch.zeros(shape + (4, 4), device=device)
    c2w[..., :3, :3] = look_at(campos, target)
    c2w[..., :3, 3] = campos
    c2w[..., 3, 3] = 1.0
    return c2w


def perspective(fovy_deg, aspect=1.0, near=0.01, far=100.0,
                device=None, dtype=torch.float32) -> torch.Tensor:
    """OpenGL perspective projection 4x4 (z_clip in [-1, 1])."""
    if device is None and torch.is_tensor(fovy_deg):
        device = fovy_deg.device
    fovy = torch.deg2rad(torch.as_tensor(fovy_deg, dtype=dtype,
                                         device=_resolve(device)))
    f = 1.0 / torch.tan(fovy / 2.0)
    z = torch.zeros(fovy.shape + (4, 4), dtype=dtype, device=fovy.device)
    z[..., 0, 0] = f / aspect
    z[..., 1, 1] = f
    z[..., 2, 2] = (far + near) / (near - far)
    z[..., 2, 3] = 2.0 * far * near / (near - far)
    z[..., 3, 2] = -1.0
    return z


def orthographic(left=-1.0, right=1.0, bottom=-1.0, top=1.0,
                 near=0.01, far=100.0, device=None) -> torch.Tensor:
    """OpenGL orthographic projection 4x4 (z_clip in [-1, 1])."""
    m = torch.zeros((4, 4), device=_resolve(device))
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[2, 2] = -2.0 / (far - near)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = -(far + near) / (far - near)
    m[3, 3] = 1.0
    return m


def invert_rigid(c2w: torch.Tensor) -> torch.Tensor:
    """Fast inverse of a rigid 4x4 (rotation+translation)."""
    R = c2w[..., :3, :3]
    t = c2w[..., :3, 3]
    Rt = R.transpose(-1, -2)
    w2c = torch.zeros_like(c2w)
    w2c[..., :3, :3] = Rt
    w2c[..., :3, 3] = -torch.einsum("...ij,...j->...i", Rt, t)
    w2c[..., 3, 3] = 1.0
    return w2c


@dataclasses.dataclass(frozen=True)
class Camera:
    """A batch of pinhole cameras; all tensor fields share a batch shape."""

    c2w: torch.Tensor          # [..., 4, 4]
    fovy_deg: torch.Tensor     # [...]
    width: int = 512
    height: int = 512
    near: float = 0.01
    far: float = 100.0

    @property
    def batch_shape(self):
        return tuple(self.c2w.shape[:-2])

    @property
    def device(self) -> torch.device:
        return self.c2w.device

    @property
    def aspect(self):
        return self.width / self.height

    @property
    def campos(self):
        return self.c2w[..., :3, 3]

    @property
    def w2c(self):
        return invert_rigid(self.c2w)

    @property
    def proj(self):
        return perspective(self.fovy_deg, self.aspect, self.near, self.far)

    @property
    def view_proj(self):
        """[..., 4, 4] world → clip: proj @ w2c per camera, computed in
        float64 and rounded once to float32, so the card and the CPU give
        the same matrix for the same c2w (their float32 `tan` and matmul
        round differently, and a face seen edge-on turns an ulp of the
        matrix into a visible change of its barycentrics)."""
        proj = perspective(self.fovy_deg, self.aspect, self.near, self.far,
                           dtype=torch.float64)
        w2c = invert_rigid(self.c2w.double())
        return torch.einsum("...ij,...jk->...ik", proj, w2c).float()

    @property
    def intrinsics(self):
        """[..., 4] = (fx, fy, cx, cy) in pixels."""
        fovy = torch.deg2rad(self.fovy_deg)
        fy = 0.5 * self.height / torch.tan(0.5 * fovy)
        fx = fy  # square pixels; fovx derived from aspect
        cx = torch.full_like(fx, self.width / 2.0)
        cy = torch.full_like(fy, self.height / 2.0)
        return torch.stack([fx, fy, cx, cy], dim=-1)

    @classmethod
    def from_orbit(cls, elevation_deg, azimuth_deg, radius, target=None,
                   fovy_deg=49.1, width=512, height=512,
                   near=0.01, far=100.0, device=None) -> "Camera":
        c2w = orbit_c2w(elevation_deg, azimuth_deg, radius, target,
                        device=device)
        fov = _f32(fovy_deg, c2w.device).expand(c2w.shape[:-2]).clone()
        return cls(c2w=c2w, fovy_deg=fov, width=width, height=height,
                   near=near, far=far)

    @classmethod
    def from_camposes(cls, camposes, fovy_deg=49.1, width=512, height=512,
                      near=0.01, far=100.0, device=None) -> "Camera":
        """Build from ORBIT_CAMPOSES rows [radius, elevation, azimuth,
        cx, cy, cz]."""
        arr = _f32(camposes, _resolve(device))
        return cls.from_orbit(arr[..., 1], arr[..., 2], arr[..., 0],
                              target=arr[..., 3:6], fovy_deg=fovy_deg,
                              width=width, height=height, near=near, far=far,
                              device=arr.device)


def compose_orbit_camposes(radii, elevations, azimuths,
                           centers_x=None, centers_y=None, centers_z=None):
    """Stack per-axis lists into ORBIT_CAMPOSES rows."""
    n = len(radii)
    cx = centers_x if centers_x is not None else [0.0] * n
    cy = centers_y if centers_y is not None else [0.0] * n
    cz = centers_z if centers_z is not None else [0.0] * n
    return [[float(radii[i]), float(elevations[i]), float(azimuths[i]),
             float(cx[i]), float(cy[i]), float(cz[i])] for i in range(n)]


def get_rays(camera: Camera, normalize_dirs: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel ray origins and directions, [..., H, W, 3]."""
    H, W = camera.height, camera.width
    dev = camera.device
    intr = camera.intrinsics
    fx, fy = intr[..., 0], intr[..., 1]
    cx, cy = intr[..., 2], intr[..., 3]

    xs = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    ys = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")  # [H, W]

    bshape = camera.batch_shape
    expand = (...,) + (None,) * 2
    dir_x = (px - cx[expand]) / fx[expand]
    dir_y = -(py - cy[expand]) / fy[expand]       # +Y up in camera space
    dir_z = -torch.ones_like(dir_x)               # looks down -Z
    dirs_cam = torch.stack([dir_x, dir_y, dir_z], dim=-1)

    R = camera.c2w[..., :3, :3]
    dirs = torch.einsum("...ij,...hwj->...hwi", R, dirs_cam)
    if normalize_dirs:
        dirs = _normalize(dirs)
    origins = camera.campos[..., None, None, :].expand(
        bshape + (H, W, 3))
    return origins, dirs
