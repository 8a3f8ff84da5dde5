"""Volume ray marching with occupancy masking.

Port of `comfy3d_tpu/ops/raymarch.py`: a fixed number of stratified samples
per ray through the field, an optional occupancy grid as a multiplicative
mask, and front-to-back compositing weights. Jitter comes from an explicit
`torch.Generator`.
"""

from __future__ import annotations

from typing import Callable

import torch


def ray_aabb(origins, dirs, bound: float = 1.0):
    """Entry/exit distances of rays against the [-bound, bound]³ box.
    Returns (t_near [N], t_far [N]); t_near >= t_far means a miss."""
    tiny = torch.where(dirs >= 0, 1e-9, -1e-9)
    inv = 1.0 / torch.where(dirs.abs() < 1e-9, tiny, dirs)
    t0 = (-bound - origins) * inv
    t1 = (bound - origins) * inv
    tmin = torch.minimum(t0, t1).amax(-1)
    tmax = torch.maximum(t0, t1).amin(-1)
    return tmin.clamp_min(0.0), tmax


def sample_along_rays(origins, dirs, t_near, t_far, num_steps: int,
                      generator: torch.Generator | None = None):
    """Stratified fixed-count samples, jittered within each stratum when a
    generator is given. Returns (xyz [N, S, 3], ts [N, S], dt [N, 1])."""
    n = origins.shape[0]
    u = (torch.arange(num_steps, dtype=torch.float32, device=origins.device)
         + 0.5) / num_steps
    u = u[None, :].expand(n, num_steps)
    if generator is not None:
        noise = torch.rand((n, num_steps), generator=generator,
                           device=generator.device).to(origins.device)
        u = u + (noise - 0.5) / num_steps
    span = (t_far - t_near).clamp_min(0.0)
    ts = t_near[:, None] + u * span[:, None]
    dt = span[:, None] / num_steps
    xyz = origins[:, None, :] + ts[..., None] * dirs[:, None, :]
    return xyz, ts, dt


def occupancy_lookup(occ_grid, xyz, bound: float = 1.0):
    """Nearest-cell occupancy of points in an [R, R, R] bool/float grid;
    0 outside the box."""
    r = occ_grid.shape[0]
    u = (xyz / bound * 0.5 + 0.5) * r
    ijk = u.to(torch.int64).clamp(0, r - 1)
    inb = ((xyz >= -bound) & (xyz <= bound)).all(-1)
    occ = occ_grid[ijk[..., 0], ijk[..., 1], ijk[..., 2]]
    return occ.float() * inb.float()


def render_weights(sigma, dt):
    """Densities [N, S] and step sizes → compositing weights [N, S]:
    w_i = T_i (1 - exp(-σ_i dt_i)), T_i = exp(-Σ_{j<i} σ_j dt_j)."""
    tau = sigma * dt
    alpha = 1.0 - torch.exp(-tau)
    return torch.exp(-(torch.cumsum(tau, -1) - tau)) * alpha


def march(field_fn: Callable, origins, dirs, occ_grid=None,
          bound: float = 1.0, num_steps: int = 128,
          generator: torch.Generator | None = None):
    """Volume render of a batch of rays.

    field_fn: (xyz [M, 3], dirs [M, 3]) → (sigma [M], rgb [M, 3]).
    Returns dict(rgb [N, 3], alpha [N], depth [N], weights [N, S],
    ts [N, S])."""
    t_near, t_far = ray_aabb(origins, dirs, bound)
    xyz, ts, dt = sample_along_rays(origins, dirs, t_near, t_far, num_steps,
                                    generator)
    n, s, _ = xyz.shape
    flat_dirs = dirs[:, None, :].expand(n, s, 3).reshape(-1, 3)
    sigma, rgb = field_fn(xyz.reshape(-1, 3), flat_dirs)
    sigma = sigma.reshape(n, s)
    rgb = rgb.reshape(n, s, 3)
    if occ_grid is not None:
        sigma = sigma * occupancy_lookup(occ_grid, xyz, bound)
    sigma = torch.where(ts < t_far[:, None], sigma, 0.0)   # beyond the exit
    w = render_weights(sigma, dt)
    return {"rgb": (w[..., None] * rgb).sum(1), "alpha": w.sum(1),
            "depth": (w * ts).sum(1), "weights": w, "ts": ts}


def update_occupancy(occ_values, density_fn: Callable, res: int,
                     bound: float = 1.0, decay: float = 0.95,
                     generator: torch.Generator | None = None):
    """EMA occupancy-grid update: one point per cell (jittered within it
    when a generator is given), max with the decayed previous value.

    occ_values [R³] running density estimate; binarize the result with
    `> threshold` for `march`."""
    dev = occ_values.device
    lin = (torch.arange(res, dtype=torch.float32, device=dev) + 0.5) / res
    gx, gy, gz = torch.meshgrid(lin, lin, lin, indexing="ij")
    pts = torch.stack([gx, gy, gz], -1).reshape(-1, 3)
    if generator is not None:
        noise = torch.rand(pts.shape, generator=generator,
                           device=generator.device).to(dev)
        pts = pts + (noise - 0.5) / res
    sigma = density_fn((pts * 2.0 - 1.0) * bound)
    return torch.maximum(occ_values * decay, sigma)
