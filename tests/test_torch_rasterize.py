"""Port parity, the mesh rasterizer: `rasterize` by both methods (face ids,
barycentrics, depth and mask, with faces behind the camera, degenerate
faces, padding faces and a tile over `max_per_tile`), `recompute_barycentrics`
and `interpolate` with their gradients, `texture_sample` (wrap and clamp)
and `Camera.view_proj`, `comfy3d_tpu_torch` against `comfy3d_tpu` on the
same numpy inputs. The JAX references are jitted (one compile, not one per
eager op): the rasterizer with XLA's default options, whose fused edge
function the port rounds alike, so it is held element for element; the
differentiable functions with `QUICK_XLA`, held within a tolerance."""

import functools

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.core.camera import Camera as JCamera
from comfy3d_tpu.ops import rasterize as JR

from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.ops import rasterize as R

from tests.test_torch_common import QUICK_XLA, one_torch_thread  # noqa: F401
from tests.test_torch_volume import _np

H, W = 40, 56        # partial tiles on both axes


@functools.lru_cache(maxsize=None)
def _camera():
    """The test view's (c2w, campos, view_proj), numpy, from one compile of
    the JAX package's camera math (not one per eager op)."""
    def cam():
        c = JCamera.from_orbit(20.0, 30.0, 2.5, width=W, height=H)
        return c.c2w, c.campos, c.view_proj
    return tuple(np.array(a) for a in jax.jit(cam)())


# the JAX package's rasterizer, compiled once for each method and shape
_jrasterize = jax.jit(JR.rasterize, static_argnames=("height", "width",
                                                     "method"))


def scene(seed=0, nv=300, nf=400):
    """Random triangles in a 0.8 box (many spanning more than 64 tiles'
    worth of screen, so the binned path cuts them), then: one face with a
    corner behind the camera, one with a repeated corner, one with
    collinear corners, and padding faces (0, 0, 0) and one real-looking
    face, both marked invalid. Returns (v, f, face_valid, mvp, ids of the
    faces that may never win)."""
    rng = np.random.RandomState(seed)
    _, campos, view_proj = _camera()
    v = (rng.rand(nv, 3) * 1.6 - 0.8).astype(np.float32)
    f = rng.randint(0, nv - 3, (nf, 3))
    behind = campos * 1.3                           # past the camera
    v[nv - 3] = behind
    v[nv - 2] = 0.1 * campos + [0.05, 0.0, 0.0]
    v[nv - 1] = 0.2 * campos                        # collinear with -2, 0
    v[0] = 0.0
    extra = [[nv - 3, 1, 2], [5, 5, 6], [0, nv - 2, nv - 1],
             [0, 0, 0], [7, 8, 9]]
    f = np.concatenate([f, extra]).astype(np.int32)
    valid = np.ones(len(f), bool)
    valid[-2:] = False
    never = np.arange(nf, nf + len(extra))
    return v, f, valid, view_proj, never


def _raster_pair(v, f, valid, mvp, method):
    ref = _jrasterize(jnp.asarray(v), jnp.asarray(f), jnp.asarray(mvp),
                      height=H, width=W, face_valid=jnp.asarray(valid),
                      method=method)
    out = R.rasterize(torch.as_tensor(v), torch.as_tensor(f),
                      torch.as_tensor(mvp), H, W,
                      face_valid=torch.as_tensor(valid), method=method)
    return out, ref


def _assert_same_raster(out, ref):
    """Equal element for element: the scans round the edge function as
    the JAX package's compiled scans do (`rasterize._edge(fused=True)`)."""
    for name in ("face_id", "bary", "depth", "mask"):
        np.testing.assert_array_equal(_np(getattr(out, name)),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


@pytest.mark.parametrize("method", ["bruteforce", "binned"])
def test_rasterize_matches_jax(method):
    v, f, valid, mvp, never = scene()
    out, ref = _raster_pair(v, f, valid, mvp, method)
    _assert_same_raster(out, ref)
    fid = _np(out.face_id)
    assert out.face_id.dtype == torch.int32
    assert 0.2 < (fid >= 0).mean() < 1.0
    assert not np.isin(fid, never).any()
    assert (_np(out.depth)[fid < 0] == 0).all()


def test_binned_tile_over_max_per_tile_matches_jax():
    """405 small faces over one tile (the shapes of `scene()`, so the JAX
    package's compiled scan is reused): the tile keeps its first 256 faces
    in both packages, so binned differs from brute force there and nowhere
    else."""
    rng = np.random.RandomState(1)
    c2w, _, mvp = _camera()
    # 300 points within ±0.09 of the origin in the plane facing the camera:
    # ±1.6 px around the image centre, inside the tile at row 1, column 1
    right, up, back = c2w[:3, 0], c2w[:3, 1], c2w[:3, 2]
    pts = rng.rand(300, 3) * 0.18 - 0.09
    v = (pts[:, :1] * right + pts[:, 1:2] * up
         + 0.1 * pts[:, 2:] * back).astype(np.float32)
    f = rng.randint(0, 300, (405, 3)).astype(np.int32)
    valid = np.ones(405, bool)
    out, ref = _raster_pair(v, f, valid, mvp, "binned")
    _assert_same_raster(out, ref)
    brute = R.rasterize(torch.as_tensor(v), torch.as_tensor(f),
                        torch.as_tensor(mvp), H, W, method="bruteforce")
    differ = _np(out.face_id) != _np(brute.face_id)
    assert differ.any() and (_np(out.face_id)[differ] < 256).all()
    assert (_np(brute.face_id)[differ] >= 256).all()


def test_recompute_barycentrics_and_interpolate_match_jax():
    """The live weights (perspective and screen-space) and an attribute
    interpolated through them, within 1e-5; the gradient of a weighted sum
    with respect to the vertices and the attribute within 1e-5 of its
    largest value (padding faces give no NaN)."""
    v, f, valid, mvp, _ = scene()
    out, ref = _raster_pair(v, f, valid, mvp, "binned")
    attr = np.random.RandomState(2).randn(len(v), 4).astype(np.float32)
    w = np.random.RandomState(3).randn(H, W, 4).astype(np.float32)
    jf, jm = jnp.asarray(f), jnp.asarray(mvp)

    def jrefs(v_, a_):
        """Both weights, then the loss's value and gradient through the
        rasterizer's weights and through live ones: one compile."""
        def loss(live):
            def fn(v2, a2):
                jb = JR.recompute_barycentrics(v2, jm, jf, ref) if live \
                    else None
                img = JR.interpolate(a2, ref, jf, jb)
                return (img * w).sum(), img
            return jax.value_and_grad(fn, argnums=(0, 1), has_aux=True)(
                v_, a_)
        return ([JR.recompute_barycentrics(v_, jm, jf, ref, persp)
                 for persp in (True, False)],
                [loss(live) for live in (False, True)])

    jbarys, jlosses = jax.jit(jrefs, compiler_options=QUICK_XLA)(
        jnp.asarray(v), jnp.asarray(attr))
    for persp, jb in zip((True, False), jbarys):
        b = R.recompute_barycentrics(torch.as_tensor(v), torch.as_tensor(mvp),
                                     torch.as_tensor(f), out, persp)
        np.testing.assert_allclose(_np(b), np.asarray(jb), atol=1e-5, rtol=0)
    for live, ((_, jimg), jg) in zip((False, True), jlosses):
        tv = torch.tensor(v, requires_grad=True)
        ta = torch.tensor(attr, requires_grad=True)
        tb = R.recompute_barycentrics(tv, torch.as_tensor(mvp),
                                      torch.as_tensor(f), out) if live \
            else None
        img = R.interpolate(ta, out, torch.as_tensor(f), tb)
        (img * torch.as_tensor(w)).sum().backward()
        np.testing.assert_allclose(_np(img), np.asarray(jimg), atol=1e-5,
                                   rtol=0)
        grads = ((ta.grad, jg[1], "attr"),) + (
            ((tv.grad, jg[0], "v"),) if live else ())
        for g, r, name in grads:
            r = np.asarray(r)
            assert np.isfinite(_np(g)).all(), name
            err = np.abs(_np(g) - r).max()
            assert err <= 1e-5 * max(np.abs(r).max(), 1e-30), (name, err)


def test_texture_sample_matches_jax():
    """Bilinear lookup with uv inside, outside and on the border of
    [0, 1], wrapped and clamped, within 1e-6; the gradient with respect to
    the texture and the uv within 1e-5 of its largest value."""
    rng = np.random.RandomState(4)
    tex = rng.rand(6, 9, 3).astype(np.float32)
    uv = (rng.rand(7, 11, 2) * 1.6 - 0.3).astype(np.float32)
    uv[0, :4] = [[0, 0], [1, 1], [0.5, 1.0], [-1e-7, 0.2]]
    w = rng.randn(7, 11, 3).astype(np.float32)
    for mode in ("wrap", "clamp"):
        def jloss(t_, uv_):
            out = JR.texture_sample(t_, uv_, mode)
            return (out * w).sum(), out

        (_, ref), jg = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True),
            compiler_options=QUICK_XLA)(jnp.asarray(tex), jnp.asarray(uv))
        tt = torch.tensor(tex, requires_grad=True)
        tu = torch.tensor(uv, requires_grad=True)
        out = R.texture_sample(tt, tu, mode)
        (out * torch.as_tensor(w)).sum().backward()
        np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-6,
                                   rtol=0, err_msg=mode)
        for g, r, name in ((tt.grad, jg[0], "tex"), (tu.grad, jg[1], "uv")):
            r = np.asarray(r)
            err = np.abs(_np(g) - r).max()
            assert err <= 1e-5 * np.abs(r).max(), (mode, name, err)


def test_view_proj_matches_jax_and_methods_are_checked():
    """proj @ w2c for a batch of cameras within 1e-6 of its largest value;
    a method other than "binned" and "bruteforce" raises (the JAX package
    falls back to brute force for any other name)."""
    def jcam():
        c = JCamera.from_orbit(np.array([10.0, -30.0, 60.0]),
                               np.array([0.0, 120.0, 250.0]),
                               np.array([2.0, 3.5, 1.2]), fovy_deg=40.0,
                               width=64, height=48)
        return c, c.view_proj

    jc, ref = jax.jit(jcam)()
    cam = convert.camera_from_numpy(np.asarray(jc.c2w),
                                    np.asarray(jc.fovy_deg), 64, 48,
                                    jc.near, jc.far, "cpu")
    ref = np.asarray(ref)
    out = _np(cam.view_proj)
    assert out.shape == (3, 4, 4)
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()
    v, f, valid, mvp, _ = scene(nv=20, nf=10)
    with pytest.raises(ValueError, match="method"):
        R.rasterize(torch.as_tensor(v), torch.as_tensor(f),
                    torch.as_tensor(mvp), H, W, method="pallas")
