"""Port parity, InstantMesh's geometry: `grid_tets`, and
`marching_tets_deformed` with the weld on shared deformed lattices (soup,
counts, overflow flags, welded mesh and gradients), the camera conditioning,
the config, and the slice's entry points' device, `comfy3d_tpu_torch`
against `comfy3d_tpu`."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.models.instantmesh.model import \
    InstantMeshConfig as JConfig
from comfy3d_tpu.models.instantmesh.pipeline import \
    orbit_poses_to_input_cameras as j_orbit_cameras
from comfy3d_tpu.ops import tetra as jtet

from comfy3d_tpu_torch.core.mesh import Mesh
from comfy3d_tpu_torch.models.instantmesh import (
    InstantMeshConfig, InstantMeshPipeline, orbit_poses_to_input_cameras)
from comfy3d_tpu_torch.ops import tetra

from tests.test_torch_instantmesh import TINY
from tests.test_torch_common import one_torch_thread  # noqa: F401
from tests.test_torch_volume import _np

RES = 17


def _deformed_lattice(res=RES, scale=1.05):
    """A res³ lattice in the ±scale box, each vertex moved by a smooth
    field of up to a quarter cell, and an off-centre ellipsoid's SDF (> 0
    inside) at the moved vertices; numpy float32, shared by both
    packages."""
    verts = jtet.grid_tets(res)[0] * scale
    p = verts.astype(np.float64)
    cell = 2 * scale / (res - 1)
    d = 0.25 * cell * np.stack([np.sin(3 * p[:, 1] + 1), np.sin(3 * p[:, 2]
                                + 2), np.sin(3 * p[:, 0] + 3)], -1)
    v_def = (verts + d.astype(np.float32)).astype(np.float32)
    q = v_def.astype(np.float64) - [0.05, -0.03, 0.02]
    sdf = 0.6 - np.sqrt(q[:, 0] ** 2 + 0.8 * q[:, 1] ** 2
                        + 1.2 * q[:, 2] ** 2)
    return v_def, sdf.astype(np.float32)


def test_grid_tets_matches_jax():
    for res in (2, 5):
        verts, tets = tetra.grid_tets(res)
        jverts, jtets = jtet.grid_tets(res)
        np.testing.assert_array_equal(verts, jverts)
        np.testing.assert_array_equal(tets, jtets)
        assert tets.dtype == np.int32 and len(tets) == 6 * (res - 1) ** 3
    np.testing.assert_array_equal(tetra.grid_vertices(9),
                                  jtet.grid_tets(9)[0])


@pytest.mark.parametrize("max_tris,cell_cap", [
    (8000, None), (900, None), (8000, 150)],
    ids=["ample", "triangle_cap", "cell_cap"])
def test_marching_tets_deformed_matches_jax(max_tris, cell_cap):
    """The soup, its count and overflow flag, the welded mesh, equal
    element for element."""
    v_def, sdf = _deformed_lattice()
    kw = dict(max_tris=max_tris, cell_cap=cell_cap)
    soup, count, ovf = tetra.marching_tets_deformed(
        torch.as_tensor(v_def), torch.as_tensor(sdf), RES, **kw)
    jsoup, jcount, jovf = jtet.marching_tets_deformed(
        jnp.asarray(v_def), jnp.asarray(sdf), RES, **kw)
    assert (count, ovf) == (int(jcount), bool(jovf))
    assert ovf == (max_tris < 8000 or cell_cap is not None)
    assert count > 600
    np.testing.assert_array_equal(_np(soup), np.asarray(jsoup))
    out = tetra.weld_device(soup, count, max_verts=max_tris)
    ref = jtet.weld_device(jsoup, jcount, max_verts=max_tris)
    for a, b, name in zip(out, ref, ["v", "f", "nv", "nf", "overflow"]):
        np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=name)


def test_marching_tets_deformed_gradients_match_jax():
    """The gradients of a weighted sum of the soup with respect to the
    deformed vertices and the SDF (through the edge interpolation) within
    1e-5 of their largest value."""
    v_def, sdf = _deformed_lattice()
    kw = dict(max_tris=8000, cell_cap=None)
    w = np.random.RandomState(3).randn(8000, 3, 3).astype(np.float32)

    def jloss(v, s):
        return (jtet.marching_tets_deformed(v, s, RES, **kw)[0] * w).sum()

    jgv, jgs = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(v_def),
                                               jnp.asarray(sdf))
    tv = torch.tensor(v_def, requires_grad=True)
    ts = torch.tensor(sdf, requires_grad=True)
    (tetra.marching_tets_deformed(tv, ts, RES, **kw)[0]
     * torch.as_tensor(w)).sum().backward()
    for g, jg, name in ((tv.grad, jgv, "v_def"), (ts.grad, jgs, "sdf")):
        jg = np.asarray(jg)
        assert np.abs(jg).max() > 0, name
        err = np.abs(_np(g) - jg).max()
        assert err <= 1e-5 * np.abs(jg).max(), (name, err)


def test_orbit_cameras_and_config_match_jax():
    """The z-up camera conditioning [N, 16] equal to JAX's, azimuths below
    0 and above 360 and per-view radii included; the config's defaults
    equal."""
    az = np.array([30.0, -90.0, 150.0, 210.0, 400.0, 330.0])
    el = np.array([20.0, -10.0, 20.0, -10.0, 0.0, 45.0])
    for kw in ({}, dict(radius=np.linspace(2.0, 4.5, 6), fov_deg=40.0)):
        out = orbit_poses_to_input_cameras(az, el, **kw)
        assert out.dtype == np.float32 and out.shape == (6, 16)
        np.testing.assert_array_equal(out, j_orbit_cameras(az, el, **kw))
    assert dataclasses.asdict(InstantMeshConfig()) == \
        dataclasses.asdict(JConfig())


def test_entry_points_default_to_the_card(tmp_path):
    """Without a `device`, the slice's entry points place their tensors on
    the card; there is no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = InstantMeshConfig(**TINY)
    with pytest.raises((AssertionError, RuntimeError)):
        InstantMeshPipeline.init_random(0, cfg)
    path = tmp_path / "sd.ckpt"
    torch.save(InstantMeshPipeline.init_random(0, cfg, device="cpu")
               .model.state_dict(), path)
    with pytest.raises((AssertionError, RuntimeError)):
        InstantMeshPipeline.from_pretrained(str(path), cfg)
    mesh = Mesh(v=np.zeros((3, 3), np.float32), f=[[0, 1, 2]])
    with pytest.raises((AssertionError, RuntimeError)):
        mesh.device_arrays()
