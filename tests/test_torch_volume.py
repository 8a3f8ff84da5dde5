"""Port parity, volume path: the density lattice and its dense and
hierarchical decodes, and ray marching, `comfy3d_tpu_torch` against
`comfy3d_tpu` on analytic fields."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.ops import raymarch as jray
from comfy3d_tpu.ops import volume as jvol

from comfy3d_tpu_torch.ops import raymarch, volume

from tests.test_torch_common import one_torch_thread  # noqa: F401


B = 0.87           # TripoSR's box


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# an off-centre ellipsoid (density convention: > 0 inside), in both
# packages' arithmetic
def _ellipsoid(lib, pts):
    x, y, z = pts[:, 0] - 0.05, pts[:, 1] + 0.03, pts[:, 2] - 0.02
    return 0.55 - lib.sqrt(x * x + 0.8 * (y * y) + 1.2 * (z * z))


def _jax_field(ctx, pts):
    return _ellipsoid(jnp, pts)


def _field(pts):
    return _ellipsoid(torch, pts)


def _lattice(r, b=B):
    lin = np.linspace(-b, b, r).astype(np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    return np.stack([x, y, z], -1).reshape(-1, 3)


def _grid(r):
    return _ellipsoid(np, _lattice(r)).reshape(r, r, r).astype(np.float32)


# ------------------------------------------------------------- volume
def test_grid_points_and_dense_decode_match_jax():
    np.testing.assert_allclose(
        _np(volume.grid_points(17, B, device="cpu")),
        np.asarray(jvol.grid_points(17, B)), atol=1e-7, rtol=0)
    np.testing.assert_array_equal(
        _np(volume.grid_points(5, (-1.0, 1.0), device="cpu")),
        np.asarray(jvol.grid_points(5, (-1.0, 1.0))))
    ref = jvol.decode_grid(_jax_field, None, 20, B, chunk=1000)
    port = volume.decode_grid(_field, 20, B, chunk=1000, device="cpu")
    assert volume.hier_plan(20) is None and tuple(port.shape) == (20,) * 3
    np.testing.assert_allclose(_np(port), np.asarray(ref), atol=1e-5,
                               rtol=0)
    g = torch.as_tensor(_grid(9))
    np.testing.assert_array_equal(_np(volume._upsample2_corner(g)),
                                  np.asarray(jvol._upsample2_corner(
                                      jnp.asarray(_grid(9)))))


@pytest.mark.parametrize("res,coarse", [(33, 17), (65, 17)])
def test_hierarchical_decode_matches_jax(res, coarse):
    """33³ from 17³ (one level, every cell re-queried) and 65³ from 17³
    (two levels; the second re-queries 12,288 of its 32,768 cells)."""
    assert volume.hier_plan(res, coarse) == jvol.hier_plan(res, coarse)
    ref = jvol.decode_grid(_jax_field, None, res, B, iso=0.01,
                           coarse_resolution=coarse, chunk=4096)
    port = volume.decode_grid(_field, res, B, iso=0.01,
                              coarse_resolution=coarse, chunk=4096,
                              device="cpu")
    np.testing.assert_allclose(_np(port), np.asarray(ref), atol=1e-5,
                               rtol=0)
    exact = _ellipsoid(np, _lattice(res)).reshape((res,) * 3)
    near = np.abs(exact - 0.01) < 0.05        # the band reaches the surface
    np.testing.assert_allclose(_np(port)[near], exact[near], atol=1e-5)


def test_query_chunked_matches_one_call():
    pts = torch.as_tensor(_lattice(9))
    np.testing.assert_array_equal(
        _np(volume.query_chunked(_field, pts, chunk=100)), _np(_field(pts)))


# --------------------------------------------------------- ray march
def _jax_rgb_field(xyz, dirs):
    s = jnp.maximum(0.6 - jnp.sqrt((xyz * xyz).sum(-1)), 0.0) * 8.0
    return s, 0.5 + 0.5 * jnp.sin(3.0 * xyz)


def _rgb_field(xyz, dirs):
    s = torch.clamp_min(0.6 - torch.sqrt((xyz * xyz).sum(-1)), 0.0) * 8.0
    return s, 0.5 + 0.5 * torch.sin(3.0 * xyz)


def _rays(n=64):
    rng = np.random.RandomState(3)
    o = (rng.randn(n, 3) * 0.2 + [0.0, 0.0, 2.5]).astype(np.float32)
    d = (rng.randn(n, 3) * 0.15 + [0.0, 0.0, -1.0]).astype(np.float32)
    d[0] = [1.0, 0.0, 0.0]                         # a miss
    d[1] = [0.0, 0.0, -1.0]                        # axis-aligned
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def test_march_matches_jax():
    o, d = _rays()
    occ = np.random.RandomState(4).rand(8, 8, 8) > 0.3
    for grid in (None, occ):
        ref = jray.march(_jax_rgb_field, jnp.asarray(o), jnp.asarray(d),
                         None if grid is None else jnp.asarray(grid),
                         bound=B, num_steps=48)
        port = raymarch.march(_rgb_field, torch.as_tensor(o),
                              torch.as_tensor(d),
                              None if grid is None else torch.as_tensor(grid),
                              bound=B, num_steps=48)
        for k in ("rgb", "alpha", "depth", "weights", "ts"):
            np.testing.assert_allclose(_np(port[k]), np.asarray(ref[k]),
                                       atol=2e-5, rtol=0, err_msg=k)
    assert float(port["alpha"][0]) == 0.0
    tn, tf = raymarch.ray_aabb(torch.as_tensor(o), torch.as_tensor(d), B)
    jn, jf = jray.ray_aabb(jnp.asarray(o), jnp.asarray(d), B)
    np.testing.assert_allclose(_np(tn), np.asarray(jn), atol=1e-6)
    np.testing.assert_allclose(_np(tf), np.asarray(jf), atol=1e-6)


def test_jitter_and_occupancy_update():
    o, d = map(torch.as_tensor, _rays())
    runs = [raymarch.march(_rgb_field, o, d, bound=B, num_steps=32,
                           generator=torch.Generator().manual_seed(s))
            for s in (5, 5, 6)]
    assert torch.equal(runs[0]["rgb"], runs[1]["rgb"])
    assert not torch.equal(runs[0]["ts"], runs[2]["ts"])
    plain = raymarch.march(_rgb_field, o, d, bound=B, num_steps=32)
    assert (runs[0]["ts"] - plain["ts"]).abs().max() > 0
    occ = np.random.RandomState(5).rand(6 ** 3).astype(np.float32)

    def sig(xyz):
        return _rgb_field(xyz, None)[0]

    def jsig(xyz):
        return _jax_rgb_field(xyz, None)[0]

    ref = jray.update_occupancy(jnp.asarray(occ), jsig, 6, bound=B)
    port = raymarch.update_occupancy(torch.as_tensor(occ), sig, 6, bound=B)
    np.testing.assert_allclose(_np(port), np.asarray(ref), atol=1e-5)
    jit = raymarch.update_occupancy(torch.as_tensor(occ), sig, 6, bound=B,
                                    generator=torch.Generator().manual_seed(1))
    assert jit.shape == port.shape and not torch.equal(jit, port)
