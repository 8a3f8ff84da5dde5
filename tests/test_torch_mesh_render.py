"""Port parity, the mesh orbit renderer: `render_mesh` with vertex colours
(through `Mesh.device_arrays` and `face_valid`, as the orbit-renderer node
passes them), an albedo texture with face-varying UVs, and flat grey, for a
batch of cameras and at `ssaa=2`; its gradients with respect to the
vertices, the vertex colours and the albedo; `vertex_normals`,
`comfy3d_tpu_torch` against `comfy3d_tpu` on the same numpy inputs. The
JAX references all come from one jitted function (one compile, not one
per eager op or per test), so XLA may fuse their arithmetic: the buffers
are held within 1e-4."""

import dataclasses
import functools

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.core.camera import Camera as JCamera
from comfy3d_tpu.ops import mesh_render as JM

from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.core.mesh import Mesh
from comfy3d_tpu_torch.ops import mesh_render as M
from comfy3d_tpu_torch.ops import tetra

from tests.test_torch_common import QUICK_XLA, one_torch_thread  # noqa: F401
from tests.test_torch_volume import _np

H, W = 24, 40
# outputs (values in [0, 1], depths about 2) against the JAX package
TOL = 1e-4
BG = np.array([0.2, 0.3, 0.4], np.float32)


@pytest.fixture(scope="module")
def mesh():
    """A closed off-centre ellipsoid from marching tets at 9³, with vertex
    colours and face-varying UVs (three vt rows per face) onto a 16 × 24
    albedo."""
    lin = np.linspace(-1, 1, 9, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    g = 0.7 - np.sqrt((x - 0.1) ** 2 + 0.8 * y ** 2 + 1.3 * z ** 2)
    v, f, nv, nf = tetra.extract_isosurface_device(torch.as_tensor(g),
                                                   max_tris=4000)
    v, f = _np(v[:nv]), _np(f[:nf])
    rng = np.random.RandomState(0)
    return Mesh(v=v, f=f, vc=rng.rand(len(v), 3),
                vt=rng.rand(3 * len(f), 2),
                ft=np.arange(3 * len(f)).reshape(-1, 3),
                albedo=rng.rand(16, 24, 3))


@functools.lru_cache(maxsize=None)
def _cameras():
    """Two views as a JAX camera (from one compile of its camera math, not
    one per eager op) and the port's (the same c2w)."""
    jcam = jax.jit(lambda: JCamera.from_orbit(
        np.array([15.0, -25.0]), np.array([30.0, 200.0]), 2.6, width=W,
        height=H))()
    cam = convert.camera_from_numpy(np.array(jcam.c2w),
                                    np.array(jcam.fovy_deg), W, H,
                                    jcam.near, jcam.far, "cpu")
    return jcam, cam


def _first(cam):
    """The first view of a batch of cameras."""
    return dataclasses.replace(cam, c2w=cam.c2w[0], fovy_deg=cam.fovy_deg[0])


def _inputs(mesh, kind):
    """The JAX and port keyword arguments of one colour source."""
    if kind == "vc":
        # padded to 1,024 rows with face_valid, as the node passes them
        d = mesh.device_arrays(device="cpu")
        kw = dict(vc=d["vc"],
                  face_valid=torch.arange(d["f"].shape[0]) < mesh.num_faces)
        return (d["v"], d["f"], kw,
                {k: jnp.asarray(_np(a)) for k, a in kw.items()})
    kw = {}
    if kind == "albedo":
        kw = dict(vt=mesh.vt, ft=mesh.ft, albedo=mesh.albedo)
    return (torch.as_tensor(mesh.v), torch.as_tensor(mesh.f),
            {k: torch.as_tensor(a) for k, a in kw.items()},
            {k: jnp.asarray(a) for k, a in kw.items()})


def _image_weights():
    return np.random.RandomState(1).rand(2, H, W, 3).astype(np.float32)


def _normal_weights(mesh):
    return np.random.RandomState(2).randn(*mesh.v.shape).astype(np.float32)


@pytest.fixture(scope="module")
def jrefs(mesh):
    """Every JAX reference of this file, numpy, from one compile: the two
    views of each colour source (vertex colours and albedo from the image
    loss's forward pass, on the node's padded arrays), the first view at
    ssaa 2, the image loss's gradients and the vertex normals with their
    loss's gradient."""
    jcam, _ = _cameras()
    v, f, _, jkw = _inputs(mesh, "vc")
    m = {k: jnp.asarray(getattr(mesh, k))
         for k in ("v", "f", "vc", "vt", "ft", "albedo")}
    w_img = jnp.asarray(_image_weights())
    w_vn = jnp.asarray(_normal_weights(mesh))
    bg = jnp.asarray(BG)

    def refs(v, f, jkw, m, cam):
        def image_loss(v, vc, albedo):
            a = JM.render_mesh(v, f, cam, vc=vc, background=bg,
                               face_valid=jkw["face_valid"])
            b = JM.render_mesh(v, m["f"], cam, vt=m["vt"], ft=m["ft"],
                               albedo=albedo, background=bg)
            return ((a["image"] + b["image"]) * w_img).sum(), \
                {"vc": a, "albedo": b}

        (_, out), grads = jax.value_and_grad(
            image_loss, argnums=(0, 1, 2), has_aux=True)(v, jkw["vc"],
                                                         m["albedo"])
        out["grads"] = grads
        out["grey"] = JM.render_mesh(m["v"], m["f"], cam, background=bg)
        out["ssaa"] = JM.render_mesh(m["v"], m["f"], _first(cam),
                                     vc=m["vc"], ssaa=2)

        def normal_loss(v):
            vn = JM.vertex_normals(v, m["f"])
            return (vn * w_vn).sum(), vn

        out["normals"] = jax.value_and_grad(normal_loss, has_aux=True)(
            m["v"])
        return out

    return jax.tree.map(np.asarray, jax.jit(
        refs, compiler_options=QUICK_XLA)(
            jnp.asarray(_np(v)), jnp.asarray(_np(f)), jkw, m, jcam))


def _assert_close(out, ref):
    for k in ("image", "alpha", "depth", "normal", "viewcos"):
        r = np.asarray(ref[k])
        assert tuple(out[k].shape) == r.shape, k
        np.testing.assert_allclose(_np(out[k]), r, atol=TOL, rtol=0,
                                   err_msg=k)
    np.testing.assert_array_equal(_np(out["alpha"]), np.asarray(ref["alpha"]))


@pytest.mark.parametrize("kind", ["vc", "albedo", "grey"])
def test_render_mesh_matches_jax(mesh, jrefs, kind):
    """Two views, each buffer within 1e-4, the coverage equal."""
    _, cam = _cameras()
    v, f, kw, _ = _inputs(mesh, kind)
    out = M.render_mesh(v, f, cam, background=torch.as_tensor(BG), **kw)
    _assert_close(out, jrefs[kind])
    alpha = _np(out["alpha"])
    assert 0.05 < alpha.mean() < 0.95
    np.testing.assert_array_equal(_np(out["image"])[alpha == 0],
                                  np.broadcast_to(BG, (int((alpha == 0)
                                                           .sum()), 3)))


def test_render_mesh_ssaa_matches_jax(mesh, jrefs):
    """One view rendered at 2× and average-pooled, within 1e-4."""
    out = M.render_mesh(torch.as_tensor(mesh.v), torch.as_tensor(mesh.f),
                        _first(_cameras()[1]), vc=torch.as_tensor(mesh.vc),
                        ssaa=2)
    _assert_close(out, jrefs["ssaa"])
    alpha = _np(out["alpha"])
    assert ((alpha > 0) & (alpha < 1)).any()       # partly covered pixels


def test_render_mesh_gradients_match_jax(mesh, jrefs):
    """The gradient of a weighted sum of both views' images, with vertex
    colours and with the albedo, with respect to the node's padded
    vertices and vertex colours and to the albedo, within 1e-4 of its
    largest value, and finite."""
    _, cam = _cameras()
    v, f, kw, _ = _inputs(mesh, "vc")
    tv, tvc = v.clone().requires_grad_(), kw["vc"].clone().requires_grad_()
    talb = torch.tensor(mesh.albedo, requires_grad=True)
    bg = torch.as_tensor(BG)
    a = M.render_mesh(tv, f, cam, vc=tvc, background=bg,
                      face_valid=kw["face_valid"])["image"]
    b = M.render_mesh(tv, torch.as_tensor(mesh.f), cam,
                      vt=torch.as_tensor(mesh.vt),
                      ft=torch.as_tensor(mesh.ft), albedo=talb,
                      background=bg)["image"]
    ((a + b) * torch.as_tensor(_image_weights())).sum().backward()
    for g, r, name in zip((tv.grad, tvc.grad, talb.grad), jrefs["grads"],
                          ("v", "vc", "albedo")):
        assert np.isfinite(_np(g)).all() and np.abs(r).max() > 0, name
        err = np.abs(_np(g) - r).max()
        assert err <= 1e-4 * np.abs(r).max(), (name, err)
    # the padding rows take no gradient
    assert not _np(tv.grad)[mesh.num_vertices:].any()


def test_vertex_normals_match_jax(mesh, jrefs):
    """Area-weighted unit normals within 1e-6, and the gradient of a
    weighted sum of them within 1e-4 of its largest value."""
    (_, ref), jg = jrefs["normals"]
    tv = torch.tensor(mesh.v, requires_grad=True)
    vn = M.vertex_normals(tv, torch.as_tensor(mesh.f))
    (vn * torch.as_tensor(_normal_weights(mesh))).sum().backward()
    np.testing.assert_allclose(_np(vn), ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(_np(vn), axis=-1), 1.0,
                               atol=1e-6)
    err = np.abs(_np(tv.grad) - jg).max()
    assert err <= 1e-4 * np.abs(jg).max(), err
