"""Port parity, UV unwrapping and texture baking: `box_unwrap`,
`atlas_unwrap` and `auto_unwrap` element for element, the UV
rasterization, `bake_vertex_colors`, `bake_color_fn` and `dilate_texture`,
`comfy3d_tpu_torch` against `comfy3d_tpu` on one mesh (an ellipsoid
extracted by marching tets) and one UV layout."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.core import image as jimage
from comfy3d_tpu.ops import texture as jtex
from comfy3d_tpu.ops import uv_atlas as jatlas

from comfy3d_tpu_torch.core import image as timage
from comfy3d_tpu_torch.ops import tetra, texture, uv_atlas

from tests.test_torch_common import QUICK_XLA, _np, one_torch_thread  # noqa: F401
from tests.test_torch_volume import _grid

SIZE = 64              # texture size
# baked textures against the JAX package: within this share of their
# largest value (barycentric sums in another order)
REL = 1e-5


@pytest.fixture(scope="module")
def mesh():
    """An off-centre ellipsoid swept at 15³ and welded: 2,200 faces."""
    m = tetra.extract_isosurface(_grid(15), iso=0.0, device="cpu")
    assert m.num_faces == 2200
    return m


@pytest.fixture(scope="module")
def atlas(mesh):
    vt, ft, kind = texture.auto_unwrap(mesh.v, mesh.f)
    assert kind == "atlas"
    return vt, ft


def _colors(v):
    return (0.5 + 0.5 * np.sin(3.0 * v + np.array([0.0, 1.0, 2.0]))) \
        .astype(np.float32)


def test_box_unwrap_equals_jax(mesh):
    """Charts by dominant normal, welded per chart: vt and ft equal."""
    vt, ft = texture.box_unwrap(mesh.v, mesh.f)
    jvt, jft = jtex.box_unwrap(mesh.v, mesh.f)
    np.testing.assert_array_equal(vt, jvt)
    np.testing.assert_array_equal(ft, jft)
    assert vt.min() >= 0.0 and vt.max() <= 1.0


def test_atlas_and_auto_unwrap_equal_jax(mesh, atlas):
    """The LSCM atlas (same charts, packing and face order) equal element
    for element, through `atlas_unwrap` and `auto_unwrap`; above
    `max_atlas_faces` both fall back to the box unwrap."""
    vt, ft = atlas
    jvt, jft = jtex.auto_unwrap(mesh.v, mesh.f)
    np.testing.assert_array_equal(vt, jvt)
    np.testing.assert_array_equal(ft, jft)
    avt, aft = uv_atlas.atlas_unwrap(mesh.v, mesh.f, padding=0.02)
    javt, jaft = jatlas.atlas_unwrap(mesh.v, mesh.f, padding=0.02)
    np.testing.assert_array_equal(avt, javt)
    np.testing.assert_array_equal(aft, jaft)
    bvt, bft, kind = texture.auto_unwrap(mesh.v, mesh.f, max_atlas_faces=10)
    jbvt, jbft = jtex.auto_unwrap(mesh.v, mesh.f, max_atlas_faces=10)
    assert kind == "box"
    np.testing.assert_array_equal(bvt, jbvt)
    np.testing.assert_array_equal(bft, jbft)


@pytest.mark.parametrize("method", ["binned", "bruteforce"])
def test_rasterize_uv_matches_jax(atlas, method):
    """Texel face ids equal and barycentrics within 1e-6 at 64²."""
    vt, ft = atlas
    rast = texture.rasterize_uv(vt, ft, SIZE, method=method, device="cpu")
    ref = jtex.rasterize_uv(jnp.asarray(vt), jnp.asarray(ft), SIZE,
                            method=method)
    np.testing.assert_array_equal(_np(rast.face_id), np.asarray(ref.face_id))
    np.testing.assert_allclose(_np(rast.bary), np.asarray(ref.bary),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(_np(rast.mask), np.asarray(ref.mask))
    assert 0.2 < float(rast.mask.mean()) < 0.9


def test_bake_vertex_colors_matches_jax(mesh, atlas):
    """Per-vertex colours baked, dilated 16 rounds and flipped v-up: within
    1e-5 of the largest value."""
    vt, ft = atlas
    cols = _colors(mesh.v)
    tex = texture.bake_vertex_colors(mesh.v, mesh.f, vt, ft, cols,
                                     texture_size=SIZE, device="cpu")
    ref = jtex.bake_vertex_colors(mesh.v, mesh.f, vt, ft, cols,
                                  texture_size=SIZE)
    assert tuple(tex.shape) == (SIZE, SIZE, 3)
    assert np.abs(_np(tex) - np.asarray(ref)).max() <= REL


def test_bake_color_fn_matches_jax(mesh, atlas):
    """A 3D colour field queried at the interpolated texel positions, in
    chunks of 1,000 texels: within 1e-5, the covered and dilated texels
    alike; the v-up flip puts row 0 at v = 0."""
    vt, ft = atlas

    def field(lib):
        return lambda p: 0.5 + 0.5 * lib.sin(3.0 * p
                                             + lib.asarray([0.0, 1.0, 2.0]))

    tex = texture.bake_color_fn(mesh.v, mesh.f, vt, ft, field(torch),
                                texture_size=SIZE, chunk=1000, device="cpu")
    ref = jtex.bake_color_fn(mesh.v, mesh.f, vt, ft, field(jnp),
                             texture_size=SIZE, chunk=1000)
    assert np.abs(_np(tex) - np.asarray(ref)).max() <= REL
    rast = texture.rasterize_uv(vt, ft, SIZE, device="cpu")
    covered = _np(rast.mask)[::-1] > 0
    assert (_np(tex)[covered] > 0).all()


def test_dilate_texture_matches_jax():
    """16 rounds of 3×3 sums with zero padding, fills where the mask is 0
    and a growing mask, on a sparse random texture: within 1e-6."""
    rng = np.random.RandomState(3)
    img = rng.rand(40, 48, 3).astype(np.float32)
    mask = (rng.rand(40, 48) > 0.93).astype(np.float32)
    out = timage.dilate_texture(torch.as_tensor(img), torch.as_tensor(mask),
                                iterations=16)
    ref = jax.jit(lambda i, m: jimage.dilate_texture(i, m, iterations=16),
                  compiler_options=QUICK_XLA)(jnp.asarray(img),
                                              jnp.asarray(mask))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(_np(out)[mask > 0], img[mask > 0])
