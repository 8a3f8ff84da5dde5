"""Port parity, marching tets: the case table, the triangle soup, the
weld and `extract_isosurface_device` with its capacity modes,
`comfy3d_tpu_torch` against `comfy3d_tpu` element for element on
analytic fields."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import warnings

import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.ops import tetra as jtet

from comfy3d_tpu_torch.ops import tetra

from tests.test_torch_volume import B, _grid, _np
from tests.test_torch_common import one_torch_thread  # noqa: F401


# ------------------------------------------------------ marching tets
def test_case_table_matches_jax():
    np.testing.assert_array_equal(tetra._CASE_TABLE, jtet._CASE_TABLE)
    np.testing.assert_array_equal(tetra._CASE_COUNTS, jtet._CASE_COUNTS)


@pytest.mark.parametrize("res,max_tris,cell_cap", [
    (17, 8000, None), (25, 1500, None), (25, 20000, 300)])
def test_marching_tets_and_weld_match_jax_element_for_element(
        res, max_tris, cell_cap):
    """The soup, its count and overflow flag, then the welded mesh, equal
    element for element: ample capacity, a clipped triangle capacity, and a
    clipped cell capacity."""
    g = _grid(res)
    spacing = 2 * B / (res - 1)
    kw = dict(iso=0.02, origin=(-B,) * 3, spacing=spacing,
              max_tris=max_tris, cell_cap=cell_cap)
    soup, count, ovf = tetra.marching_tets_grid(torch.as_tensor(g), **kw)
    jsoup, jcount, jovf = jtet.marching_tets_grid(jnp.asarray(g), **kw)
    assert (count, ovf) == (int(jcount), bool(jovf))
    assert ovf == (max_tris < 8000 or cell_cap is not None)
    np.testing.assert_array_equal(_np(soup), np.asarray(jsoup))
    cap = max_tris // 2
    out = tetra.weld_device(soup, count, max_verts=cap)
    ref = jtet.weld_device(jsoup, jcount, max_verts=cap)
    for a, b, name in zip(out, ref, ["v", "f", "nv", "nf", "overflow"]):
        np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=name)
    # and the host weld of the same soup
    hv, hf = tetra.weld(_np(soup), count)
    jv, jf = jtet.weld(np.asarray(jsoup), int(jcount))
    np.testing.assert_array_equal(hv, jv)
    np.testing.assert_array_equal(hf, jf)


def test_extract_isosurface_device_retries_like_jax():
    """A capacity that overflows (3,000 for 4,544 triangles): "retry"
    doubles it as JAX does (equal meshes), "warn" keeps JAX's clipped
    mesh, "raise" raises."""
    g = _grid(21)
    kw = dict(iso=0.0, bounds=(-B, B), max_tris=3000)
    for mode in ("retry", "warn"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            v, f, nv, nf = tetra.extract_isosurface_device(
                torch.as_tensor(g), on_overflow=mode, **kw)
            jv, jf, jnv, jnf = jtet.extract_isosurface_device(
                jnp.asarray(g), on_overflow=mode, **kw)
        assert (nv, nf) == (int(jnv), int(jnf)), mode
        assert tuple(v.shape) == jv.shape and tuple(f.shape) == jf.shape
        np.testing.assert_array_equal(_np(v), np.asarray(jv), err_msg=mode)
        np.testing.assert_array_equal(_np(f), np.asarray(jf), err_msg=mode)
    assert v.shape[0] == 3000                       # warn kept the cap
    with pytest.warns(UserWarning, match="overflow"):
        tetra.extract_isosurface_device(torch.as_tensor(g),
                                        on_overflow="warn", **kw)
    with pytest.raises(RuntimeError, match="overflow"):
        tetra.extract_isosurface_device(torch.as_tensor(g),
                                        on_overflow="raise", **kw)


def test_isosurface_of_a_sphere_is_closed_and_outward():
    r = 0.5
    lin = np.linspace(-B, B, 49).astype(np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    g = (r - np.sqrt(x * x + y * y + z * z)).astype(np.float32)
    v, f, nv, nf = tetra.extract_isosurface_device(
        torch.as_tensor(g), bounds=(-B, B), max_tris=100_000)
    v, f = _np(v)[:nv], _np(f)[:nf].astype(np.int64)
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), r, atol=2e-3)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    n = np.cross(b - a, c - a)
    area = 0.5 * np.linalg.norm(n, axis=1).sum()
    assert abs(area - 4 * np.pi * r * r) < 0.01 * 4 * np.pi * r * r
    assert ((n * (a + b + c)).sum(1) >= 0).all()    # outward
    edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]],
                                    f[:, [2, 0]]]), 1)
    _, per_edge = np.unique(edges, axis=0, return_counts=True)
    assert (per_edge == 2).all()                    # closed
