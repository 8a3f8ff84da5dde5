"""Port parity, the GS→mesh converter: `extract_isosurface` in one block
and in `max_block` partitions and with its overflow modes, the native
`clean_mesh` / `decimate_mesh` against the JAX package's library, their
failed build, and `convert` as a whole at tiny widths, `comfy3d_tpu_torch`
against `comfy3d_tpu` on the same numpy inputs (the NeRF at the widths of
`tests/test_torch_ngp.py`, set in both packages' `gs_to_mesh` modules by
monkeypatching their `NGPConfig`)."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu import native as jnative
from comfy3d_tpu.algorithms import gs_to_mesh as jgm
from comfy3d_tpu.algorithms import ngp as jn
from comfy3d_tpu.core.gaussian import GaussianSplat as JSplat
from comfy3d_tpu.ops import gs_render as JG
from comfy3d_tpu.ops import tetra as jtet

from comfy3d_tpu_torch import convert, native
from comfy3d_tpu_torch.algorithms import gs_to_mesh as tgm
from comfy3d_tpu_torch.algorithms import ngp as tn
from comfy3d_tpu_torch.core.mesh import Mesh
from comfy3d_tpu_torch.ops import tetra

from tests.test_torch_common import (QUICK_XLA, _np, one_torch_thread,  # noqa: F401
                                     quick_jax)
from tests.test_torch_ngp import jax_cfg, jax_draws, port_cfg
from tests.test_torch_volume import _grid

# the converter at a tiny size: 6 views of 32², a 40-iteration fit, a 24³
# grid (a noise surface at σ = 0.6 after so few steps), a 64² texture, a
# decimation target the cleaned mesh exceeds
TINY = dict(n_views=6, render_size=32, ngp_iters=40, grid_resolution=24,
            density_threshold=0.6, texture_size=64, decimate_target=2000)


def _sphere_grid(r):
    """0.55 − |p| on an r³ lattice over [-1, 1]³ (> 0 inside)."""
    lin = np.linspace(-1.0, 1.0, r, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    return (0.55 - np.sqrt(x * x + y * y + z * z)).astype(np.float32)


def _assert_mesh_equal(m, ref, what=""):
    np.testing.assert_array_equal(m.f, ref.f, err_msg=what)
    np.testing.assert_array_equal(m.v, ref.v, err_msg=what)


@pytest.mark.parametrize("r,max_block", [(33, 288), (21, 11)])
def test_extract_isosurface_equals_jax(r, max_block):
    """An analytic sphere swept in one block at 33³, and at 21³ in the 2×2
    y/z blocks of 11 that `max_block` 11 cuts (overlapping by one plane),
    then welded on the host: faces and vertices equal element for
    element; a grid on the CPU and its numpy array give the same mesh."""
    g = _sphere_grid(r)
    m = tetra.extract_isosurface(torch.as_tensor(g), iso=0.0,
                                 max_block=max_block, max_tris=20_000)
    ref = jtet.extract_isosurface(g, iso=0.0, max_block=max_block,
                                  max_tris=20_000)
    assert m.num_faces > 500
    _assert_mesh_equal(m, ref)
    _assert_mesh_equal(tetra.extract_isosurface(
        g, iso=0.0, max_block=max_block, max_tris=20_000, device="cpu"), m)


def test_extract_isosurface_overflow_modes_match_jax():
    """A capacity of 1,000 triangles for 4,544: "retry" doubles it thrice
    as JAX does (equal meshes), "warn" keeps JAX's clipped soup, "raise"
    raises; an empty grid gives an empty mesh."""
    g = _grid(21)
    kw = dict(iso=0.0, bounds=(-0.87, 0.87), max_tris=1000)
    faces = {}
    for mode in ("retry", "warn"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m = tetra.extract_isosurface(torch.as_tensor(g), on_overflow=mode,
                                         **kw)
            ref = jtet.extract_isosurface(g, on_overflow=mode, **kw)
        _assert_mesh_equal(m, ref, mode)
        faces[mode] = m.num_faces
    assert faces == {"retry": 4544, "warn": 1000}
    with pytest.raises(RuntimeError, match="overflow"):
        tetra.extract_isosurface(torch.as_tensor(g), on_overflow="raise",
                                 **kw)
    empty = tetra.extract_isosurface(torch.full((9, 9, 9), -1.0), iso=0.0)
    assert empty.num_faces == 0 and empty.num_vertices == 0


def test_clean_and_decimate_equal_the_jax_native_library():
    """One mesh with welded duplicates, a degenerate and a repeated face and
    a small far component: `clean_mesh` (weld, drop, the component under
    5 % of the largest) and `decimate_mesh` (QEM to 600 faces) give the JAX
    package's native results element for element."""
    assert jnative._load(), "the JAX package's native library did not build"
    m = tetra.extract_isosurface(_sphere_grid(25), iso=0.0, device="cpu")
    nv = m.num_vertices
    far = np.array([[3, 3, 3], [3.1, 3, 3], [3, 3.1, 3]], np.float32)
    v = np.concatenate([m.v, m.v[:5], far])
    f = np.concatenate([m.f, m.f[:3] % 5 + nv, m.f[:1],
                        [[0, 0, 1]], [[nv + 5, nv + 6, nv + 7]]]) \
        .astype(np.int32)
    out = native.clean_mesh(v, f, min_component_frac=0.05)
    ref = jnative.clean_mesh(v, f, min_component_frac=0.05)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    assert len(out[1]) < len(f) and len(out[0]) <= nv
    dec = native.decimate_mesh(*out, 600)
    jdec = jnative.decimate_mesh(*ref, 600)
    for a, b in zip(dec, jdec):
        np.testing.assert_array_equal(a, b)
    assert 500 <= len(dec[1]) <= 600
    same = native.decimate_mesh(*out, 10 ** 6)
    assert np.array_equal(same[1], out[1]) and same[1] is not out[1]


def test_native_build_and_load_failures_raise(tmp_path, monkeypatch):
    """A source g++ rejects raises with the compiler's message, and a
    library that does not load raises: no fallback runs."""
    bad = tmp_path / "mesh_ops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.clean_mesh(np.zeros((3, 3)), np.array([[0, 1, 2]]))
    junk = tmp_path / "junk.so"
    junk.write_bytes(b"not a shared library")
    monkeypatch.setattr(native, "library_path", lambda: str(junk))
    with pytest.raises(OSError):
        native.decimate_mesh(np.zeros((4, 3)), np.array([[0, 1, 2],
                                                         [1, 2, 3]]), 1)


@pytest.fixture(scope="module")
def tiny_splat():
    """The JAX package's `test_convert_smoke` splat: 256 points of σ 0.15,
    random colours, scale 0.08, opacity_raw 2; and its port copy."""
    rng = np.random.RandomState(0)
    js = JSplat.from_points(rng.randn(256, 3).astype(np.float32) * 0.15,
                            colors=np.random.RandomState(1).rand(256, 3),
                            initial_scale=0.08)
    js = dataclasses.replace(js, opacity_raw=jnp.full_like(js.opacity_raw,
                                                           2.0))
    ts = convert.splat_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in convert.SPLAT_FIELDS}, "cpu")
    return js, ts


def test_convert_matches_jax(tiny_splat, monkeypatch, tmp_path):
    """`convert` at `TINY`, both packages given the same supervision renders
    (JAX's "pallas" path in interpret mode) and orbit cameras, the port
    JAX's init and draws. The fit: every field parameter within 2e-2 of its
    largest value (float rounding decides the fit's discrete turns — the
    occupancy threshold, Adam's steps near its ε — and 40 steps compound
    them),
    and the density grids within 2e-3. The stages after the fit — extract,
    clean, decimate, unwrap, bake — given JAX's fitted field and grid, give
    JAX's mesh: faces and vertices equal, UVs equal, the albedo within
    1e-5. The port's own mesh is non-empty with an albedo in [0, 1], and
    survives a GLB round trip."""
    js, ts = tiny_splat
    jcfg, tcfg = jgm.GSToMeshConfig(**TINY), tgm.GSToMeshConfig(**TINY)
    v, px = TINY["n_views"], TINY["render_size"]
    # `convert`'s orbit, as the JAX package builds it
    jcams = jgm.Camera.from_orbit(
        jnp.asarray(np.tile([-30.0, 0.0, 30.0], -(-v // 3))[:v], jnp.float32),
        jnp.arange(v) * (360.0 / v), 2.0, fovy_deg=49.1, width=px,
        height=px)
    ref = {k: np.asarray(v) for k, v in jax.jit(lambda s: JG.render(
        s, jcams, background=(1.0, 1.0, 1.0), backend="pallas",
        interpret=True), compiler_options=QUICK_XLA)(js).items()}

    class JaxRender:
        @staticmethod
        def render(splat, cams, background):
            return {k: jnp.asarray(v) for k, v in ref.items()}

    class PortRender:
        @staticmethod
        def render(splat, cams, background):
            return {k: torch.tensor(v) for k, v in ref.items()}

    captured = {}
    j_init, j_fit, j_grid = jn.init_params, jn.fit, jn.density_grid

    def jax_init(*a, **kw):
        captured["jinit"] = j_init(*a, **kw)
        return captured["jinit"]

    def jax_fit(*a, **kw):
        captured["jparams"], occ = j_fit(*a, **kw)
        return captured["jparams"], occ

    def jax_grid(*a, **kw):
        captured["jgrid"] = np.asarray(j_grid(*a, **kw))
        return captured["jgrid"]

    monkeypatch.setattr(jgm, "gs_render", JaxRender)
    monkeypatch.setattr(jn, "NGPConfig", lambda iterations: jax_cfg(
        iterations=iterations))
    monkeypatch.setattr(jn, "init_params", jax_init)
    monkeypatch.setattr(jn, "fit", jax_fit)
    monkeypatch.setattr(jn, "density_grid", jax_grid)
    # the JAX fit's jitted steps compile with `QUICK_XLA`
    monkeypatch.setattr(jn, "jax", quick_jax())
    jm = jgm.convert(js, jcfg)

    monkeypatch.setattr(tgm, "gs_render", PortRender)
    monkeypatch.setattr(tn, "NGPConfig", lambda iterations: port_cfg(
        iterations=iterations))
    monkeypatch.setattr(tgm, "orbit_cameras",
                        lambda cfg, device: convert.camera_from_numpy(
                            np.asarray(jcams.c2w), np.asarray(jcams.fovy_deg),
                            px, px, jcams.near, jcams.far, device))
    t_fit, t_grid = tn.fit, tn.density_grid

    def port_fit(*a, **kw):
        captured["field"], occ = t_fit(*a, **kw)
        return captured["field"], occ

    def port_grid(*a, **kw):
        grid = t_grid(*a, **kw)
        captured["grid"] = _np(grid)
        return grid

    monkeypatch.setattr(tn, "fit", port_fit)
    monkeypatch.setattr(tn, "density_grid", port_grid)
    init = tn.make_field(convert.ngp_state_from_flax(captured["jinit"]),
                         port_cfg(), device="cpu")
    info = {}
    tm = tgm.convert(ts, tcfg, draws=jax_draws(jax_cfg(iterations=40),
                                              v * px * px),
                     init=init, info=info)

    # the fit, and the grid, against JAX's
    sd = convert.ngp_state_from_flax(captured["jparams"])
    for k, v in captured["field"].state_dict().items():
        err = np.abs(_np(v) - sd[k]).max()
        assert err <= 2e-2 * np.abs(sd[k]).max(), (k, err)
    jgrid = captured["jgrid"]
    assert np.abs(captured["grid"] - jgrid).max() \
        <= 2e-3 * np.abs(jgrid).max()
    # the port's own mesh
    assert info["unwrap"] == "atlas" and tm.num_faces == info["faces"]
    assert info["faces_extracted"] >= info["faces_cleaned"] > 2000 \
        >= info["faces"] > 1500
    assert tm.albedo.shape == (64, 64, 3)
    assert np.isfinite(tm.albedo).all()
    assert tm.albedo.min() >= 0.0 and tm.albedo.max() <= 1.0
    path = str(tmp_path / "m.glb")
    tm.write(path)
    back = Mesh.load(path)
    np.testing.assert_array_equal(back.v[back.f], tm.v[tm.f])
    # the file stores v as 1 − v: an ulp from the round trip
    np.testing.assert_allclose(back.vt[back.ft], tm.vt[tm.ft], atol=1e-7,
                               rtol=0)
    # stored as 8-bit PNG, truncated
    assert np.abs(back.albedo - tm.albedo).max() <= 1.0 / 255

    # the stages after the fit, given JAX's field and grid
    jfield = tn.make_field(sd, port_cfg(), device="cpu")
    monkeypatch.setattr(tn, "fit", lambda *a, **kw: (jfield, None))
    monkeypatch.setattr(tn, "density_grid",
                        lambda *a, **kw: torch.tensor(jgrid))
    tail = tgm.convert(ts, tcfg)
    assert tail.num_faces == jm.num_faces
    _assert_mesh_equal(tail, jm)
    np.testing.assert_array_equal(tail.vt, jm.vt)
    np.testing.assert_array_equal(tail.ft, jm.ft)
    assert np.abs(tail.albedo - jm.albedo).max() <= 1e-5
    np.testing.assert_allclose(tail.vn, jm.vn, atol=1e-6, rtol=0)


def test_convert_without_a_surface_returns_the_empty_mesh(tiny_splat,
                                                           monkeypatch):
    """A threshold above every density: `convert` returns the empty
    extraction, without clean, unwrap or albedo."""
    _, ts = tiny_splat
    monkeypatch.setattr(tn, "NGPConfig", lambda iterations: port_cfg(
        iterations=iterations))
    info = {}
    m = tgm.convert(ts, tgm.GSToMeshConfig(**{**TINY, "ngp_iters": 2,
                                              "density_threshold": 1e6}),
                    info=info)
    assert m.num_faces == 0 and m.albedo is None and m.vt is None
    assert info == {"faces_extracted": 0}
