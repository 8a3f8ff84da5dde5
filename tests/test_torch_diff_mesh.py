"""Port parity, the multi-view mesh fit (`algorithms/diff_mesh.py`): the
adjacency tables, the Laplacian and normal-consistency regularisers, one
step's loss and gradients, replayed steps of a segment, a fit with the host
remesh between segments, and the slice as a whole — an image through Era3D
(tiny) and the fit node as one graph — `comfy3d_tpu_torch` against
`comfy3d_tpu` on the same numpy meshes, views and weights. The fits replay
the JAX package's view draws (`PRNGKey(seed + first step)` split every
step) and render through the binned rasterizer, which matches JAX's
element for element; the meshes are lumpy, so no pixel centre lies on an
edge."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from comfy3d_tpu.algorithms import diff_mesh as jdm
from comfy3d_tpu.core.camera import Camera as JCamera
from comfy3d_tpu.core.mesh import Mesh as JMesh
from comfy3d_tpu.ops import mesh_render as jmr
from comfy3d_tpu.ops import ssim as jssim

from comfy3d_tpu_torch.algorithms import diff_mesh as tdm
from comfy3d_tpu_torch.core.camera import Camera
from comfy3d_tpu_torch.core.mesh import Mesh

from tests.test_torch_common import (QUICK_XLA, _np,
                                     one_torch_thread)  # noqa: F401

# against the JAX package, of the largest value: losses, gradients and the
# fitted meshes
REL = 1e-4
N_VIEWS, SIZE = 6, 24


def _close(out, ref, rel=REL, what=""):
    out, ref = _np(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())


def lumpy_sphere(seed=0, textured=True):
    """`chip_smoke.uv_sphere` (6 × 12 quads, radius 0.6) with its points
    pushed out by up to 8 %, a seeded 16² albedo when `textured`."""
    rng = np.random.RandomState(seed)
    m = chip_smoke.uv_sphere(6, 12, 0.6,
                             rng.rand(16, 16, 3) if textured else None)
    m.v = (m.v * (1.0 + 0.08 * rng.rand(len(m.v), 1))).astype(np.float32)
    if not textured:
        m.vt = m.ft = None
        m.vc = rng.rand(len(m.v), 3).astype(np.float32)
    return m


def _jmesh(m):
    return JMesh(**{f.name: getattr(m, f.name) for f in dataclasses.fields(m)})


def cameras(n=N_VIEWS, size=SIZE):
    """n views at 15° elevation around a 2.0 orbit (both packages)."""
    elev = np.full((n,), 15.0, np.float32)
    azim = (np.arange(n) * (360.0 / n) + 10.0).astype(np.float32)
    return (JCamera.from_orbit(jnp.asarray(elev), jnp.asarray(azim), 2.0,
                               width=size, height=size),
            Camera.from_orbit(torch.as_tensor(elev), torch.as_tensor(azim),
                              2.0, width=size, height=size, device="cpu"))


@pytest.fixture(scope="module")
def scene():
    """Both packages' cameras and the views to fit: a second lumpy sphere,
    vertex-coloured, rendered by the JAX package (images, alpha). Within
    the module the JAX fit's step compiles with `QUICK_XLA` (its `jax.jit`
    wrapped)."""
    jcams, tcams = cameras()
    m = lumpy_sphere(1, textured=False)
    out = jax.jit(lambda v, vc: jmr.render_mesh(
        v, jnp.asarray(m.f), jcams, vc=vc, method="bruteforce"),
        compiler_options=QUICK_XLA)(jnp.asarray(m.v), jnp.asarray(m.vc))
    quick = types.SimpleNamespace(**{k: getattr(jax, k) for k in dir(jax)
                                     if not k.startswith("__")})
    quick.jit = lambda f, **kw: jax.jit(f, compiler_options=QUICK_XLA, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdm, "jax", quick)
        yield jcams, tcams, np.asarray(out["image"]), np.asarray(out["alpha"])


def jax_views(cfg, nviews, seed=0):
    """The JAX fit's view indices [iterations, batch] per step:
    `PRNGKey(seed + first step)` for each segment, split every step."""
    remesh = cfg.remesh_every > 0 and cfg.lr_verts > 0
    out, base = [], 0
    while base < cfg.iterations:
        seg = (min(cfg.remesh_every, cfg.iterations - base) if remesh
               else cfg.iterations - base)
        key = jax.random.PRNGKey(seed + base)
        for _ in range(seg):
            key, k = jax.random.split(key)
            out.append(np.asarray(jax.random.randint(
                k, (cfg.batch_size,), 0, nviews)))
        base += seg
    return np.stack(out)


def _same_mesh(tm, jm, what, rel=REL):
    assert np.array_equal(tm.f, np.asarray(jm.f)), what
    _close(tm.v, jm.v, rel, f"{what} v")
    _close(tm.vn, jm.vn, rel, f"{what} vn")
    for name in ("albedo", "vc"):
        if getattr(jm, name) is not None:
            _close(getattr(tm, name), getattr(jm, name), rel,
                   f"{what} {name}")


def test_adjacency_tables_match_jax():
    """The one-ring table (insertion order and the `max_degree` cut) and
    the face pairs equal the JAX package's host loops, on the UV sphere and
    on a random triangle soup with repeated and non-manifold edges."""
    soup = np.random.RandomState(2).randint(0, 30, (200, 3))
    for faces, nv, deg in ((lumpy_sphere().f, len(lumpy_sphere().v), 16),
                           (soup, 30, 4)):
        assert np.array_equal(tdm.build_adjacency(faces, nv, deg),
                              jdm.build_adjacency(faces, nv, deg))
        assert np.array_equal(tdm.build_face_adjacency(faces),
                              jdm.build_face_adjacency(faces))
    assert tdm.build_face_adjacency(np.zeros((0, 3))).shape == (0, 2)


def test_regularisers_match_jax():
    """The uniform-Laplacian and normal-consistency losses on the lumpy
    sphere, and their gradients in the vertices, within 1e-4 of their
    largest value (float32)."""
    m = lumpy_sphere()
    adj = jdm.build_adjacency(m.f, len(m.v))
    adj_f = jdm.build_face_adjacency(m.f)

    def losses(v):
        return (jdm.laplacian_loss(v, jnp.asarray(adj))
                + 2.0 * jdm.normal_consistency_loss(v, jnp.asarray(m.f),
                                                    jnp.asarray(adj_f)))

    val, grad = jax.jit(jax.value_and_grad(losses),
                        compiler_options=QUICK_XLA)(jnp.asarray(m.v))
    v = torch.as_tensor(m.v).requires_grad_()
    out = tdm.laplacian_loss(v, torch.as_tensor(adj).long()) \
        + 2.0 * tdm.normal_consistency_loss(v, torch.as_tensor(m.f),
                                            torch.as_tensor(adj_f))
    out.backward()
    _close(out.detach(), val, what="loss")
    _close(v.grad, grad, what="gradient")


def _jax_loss(jm, jcams, images, masks, cfg):
    """The JAX fit's objective (`diff_mesh._fit_segment`'s `loss_fn`) as a
    function of its params and a batch of view indices."""
    v0, faces = jnp.asarray(jm.v), jnp.asarray(jm.f)
    adj = jnp.asarray(jdm.build_adjacency(jm.f, len(jm.v)))
    adj_f = jnp.asarray(jdm.build_face_adjacency(jm.f))
    textured = jm.vt is not None
    n = images.shape[0]

    def loss(params, idx):
        v = v0 + params["offsets"]
        kw = (dict(vt=jnp.asarray(jm.vt), ft=jnp.asarray(jm.ft),
                   albedo=jax.nn.sigmoid(params["raw_albedo"]))
              if textured else dict(vc=jax.nn.sigmoid(params["raw_vc"])))
        cam = jax.tree.map(lambda a: a[idx] if a.ndim and a.shape[0] == n
                           else a, jcams)
        out = jmr.render_mesh(v, faces, cam, method=cfg.method, **kw)
        ref_m = jnp.asarray(masks)[idx]
        rendered = out["image"] * ref_m[..., None]
        target = jnp.asarray(images)[idx] * ref_m[..., None]
        mse = ((rendered - target) ** 2).mean()
        l_ssim = 1.0 - jssim.ms_ssim(target, rendered, levels=3)
        l_alpha = ((out["alpha"] - ref_m) ** 2).mean()
        return ((1 - cfg.lambda_ssim) * mse + cfg.lambda_ssim * l_ssim
                + cfg.lambda_alpha * l_alpha
                + cfg.lambda_lap * jdm.laplacian_loss(v, adj)
                + cfg.lambda_offset * (params["offsets"] ** 2).sum(-1).mean()
                + cfg.lambda_normal * jdm.normal_consistency_loss(
                    v, faces, adj_f))
    return loss


def test_step_loss_and_gradients_match_jax(scene):
    """One step's objective on views 1 and 4 (MSE, MS-SSIM at 3 levels,
    the alpha term, the Laplacian, the offset penalty and, at weight 0.5,
    normal consistency) for the textured sphere, its offsets and
    pre-sigmoid albedo perturbed from the init: the loss and each gradient
    within 1e-4 of their largest value (the vertex-coloured objective is
    held through the fit with the remesh below)."""
    jcams, tcams, images, masks = scene
    cfg = tdm.DiffMeshConfig(texture_size=16, lambda_normal=0.5)
    rng = np.random.RandomState(3)
    idx = np.array([1, 4])
    m = lumpy_sphere()
    fit = tdm.MeshFit(m, tcams, images, masks, cfg)
    params = fit.init_params()
    with torch.no_grad():
        for p in params.values():
            p.add_(torch.as_tensor(rng.randn(*p.shape).astype(np.float32))
                   * 0.01)
    jparams = {k: jnp.asarray(_np(p)) for k, p in params.items()}
    val, grads = jax.jit(
        jax.value_and_grad(_jax_loss(
            _jmesh(m), jcams, images, masks,
            jdm.DiffMeshConfig(**dataclasses.asdict(cfg)))),
        compiler_options=QUICK_XLA)(jparams, jnp.asarray(idx))
    loss = fit.loss(params, torch.as_tensor(idx))
    loss.backward()
    _close(loss.detach(), val, what="loss")
    for k, p in params.items():
        _close(p.grad, grads[k], what=f"d{k}")


def test_fit_replays_jax_steps(scene):
    """Three fit steps of the textured sphere (batches of 2 of 6 views,
    Adam per parameter group), the views replayed from the JAX package's
    draws: the vertices, their normals and the albedo within 1e-4 of their
    largest value of `comfy3d_tpu`'s `fit`."""
    jcams, tcams, images, masks = scene
    m = lumpy_sphere()
    cfg = tdm.DiffMeshConfig(iterations=3, batch_size=2, texture_size=16)
    jout = jdm.fit(_jmesh(m), jcams, images, masks,
                   jdm.DiffMeshConfig(**dataclasses.asdict(cfg)))
    tout = tdm.fit(m, tcams, images, masks, cfg,
                   views=jax_views(cfg, N_VIEWS))
    _same_mesh(tout, jout, "fit")
    assert np.abs(tout.v - m.v).max() > 1e-4


def test_fit_with_remesh_matches_jax(scene):
    """The vertex-coloured sphere fitted for 4 steps with a host remesh
    after the first 2 (`remesh_every`: weld and clean, isotropic remesh at
    0.08 of the diagonal, colours carried by the nearest vertex), the views
    replayed: the remeshed topology equals the JAX package's, the vertices,
    normals and colours within 1e-4 of their largest value."""
    jcams, tcams, images, masks = scene
    m = lumpy_sphere(textured=False)
    cfg = tdm.DiffMeshConfig(iterations=4, batch_size=2, remesh_every=2,
                             remesh_size=0.08)
    jout = jdm.fit(_jmesh(m), jcams, images, masks,
                   jdm.DiffMeshConfig(**dataclasses.asdict(cfg)))
    tout = tdm.fit(m, tcams, images, masks, cfg,
                   views=jax_views(cfg, N_VIEWS))
    assert tout.num_faces != m.num_faces
    _same_mesh(tout, jout, "remeshed fit")


def test_image_to_era3d_to_fitted_mesh_graph_matches_jax(tmp_path,
                                                         monkeypatch, scene):
    """The slice as a whole, `chip_smoke.config_graph("era3d_fit")` through
    both packages' `run_workflow` on the CPU: LoadImage → Load Era3D
    Pipeline (its random init wrapped to the tiny Era3D on shared weights)
    → Era3D MVDiffusion Model (2 DDIM steps under CFG 3 at 16², the port
    given JAX's noise) → Get Masks From Normal Maps → Load 3D Mesh (a lumpy
    UV sphere the test writes: on a symmetric one, Adam's first steps turn
    gradients of rounding size into steps of the learning rate's size) →
    Fitting Mesh With Multiview Images (3 steps, a 16² texture, the port
    given JAX's view draws) → Save 3D Mesh: the
    views, normal maps and fitted mesh (vertices, normals, albedo) within
    1e-4 of their largest value, the masks and poses equal, the GLBs read
    back."""
    from comfy3d_tpu.models.era3d import pipeline as je
    import copy

    from comfy3d_tpu.nodes import base as jbase, graph as jgraph
    from comfy3d_tpu.nodes import nodes_mvdiffusion as jnm
    from comfy3d_tpu_torch.models.era3d import pipeline as te
    from comfy3d_tpu_torch.nodes import base as tbase, graph as tgraph
    from tests import test_torch_mvdiffusion as mv
    for name, attr in (("in", "INPUT_ROOT_PATH"), ("out", "OUTPUT_ROOT_PATH"),
                       ("ckpt", "CKPT_ROOT_PATH")):
        (tmp_path / name).mkdir()
        for b in (jbase, tbase):
            monkeypatch.setattr(b, attr, str(tmp_path / name))
    chip_smoke.write_reference_images(str(tmp_path / "in"), 24)
    lumpy_sphere(4).write(str(tmp_path / "in" / "uv_sphere.glb"))
    ecfg = mv.era3d_cfg()
    params, (vcfg, vparams) = mv.era3d_params(ecfg, 5), mv.clip_params(6)
    extras = mv.era3d_extras(ecfg, 7)
    jpipe = mv.jax_era3d(ecfg, params, vparams, vcfg, extras)
    tpipe = mv.port_era3d(ecfg, params, vparams, extras)
    monkeypatch.setattr(je.Era3DPipeline, "init_random",
                        classmethod(lambda c, *a, **kw: jpipe))
    # the JAX node's pipeline unsharded and its call one jitted program
    monkeypatch.setattr(jnm, "maybe_shard", lambda pipe: pipe)
    jcall = je.Era3DPipeline.__call__

    def quick(self, image, num_inference_steps, guidance_scale, seed):
        def run(params, image):
            q = copy.copy(self)
            q.params = params
            return jcall(q, image, num_inference_steps, guidance_scale, seed)
        return jax.jit(run, compiler_options=QUICK_XLA)(self.params, image)

    monkeypatch.setattr(je.Era3DPipeline, "__call__", quick)
    monkeypatch.setattr(te.Era3DPipeline, "init_random",
                        classmethod(lambda c, *a, **kw: tpipe))
    call = te.Era3DPipeline.__call__
    monkeypatch.setattr(te.Era3DPipeline, "__call__", lambda self, *a, **kw: (
        call(self, *a, **kw, draws=mv.era3d_draws(ecfg, kw["seed"]))))
    fit = tdm.fit
    monkeypatch.setattr(tdm, "fit", lambda mesh, cams, im, ma, cfg: fit(
        mesh, cams, im, ma, cfg, views=jax_views(cfg, len(im))))
    graph = chip_smoke.config_graph("era3d_fit")
    overrides = {4: {"num_inference_steps": 2},
                 7: {"training_iterations": 3, "texture_resolution": 16}}
    jres = jgraph.run_workflow(graph, overrides)
    tres = tgraph.run_workflow(graph, overrides, device="cpu")
    for k, what in ((0, "views"), (1, "normal maps")):
        _close(tres[4][k], jres[4][k], what=what)
    assert tres[4][2] == jres[4][2]
    assert np.array_equal(_np(tres[5][0]), np.asarray(jres[5][0]))
    _same_mesh(tres[7][0], jres[7][0], "fitted mesh")
    out = tmp_path / "out" / f"{chip_smoke.WF_DIR}" / "era3d_fit_mesh.glb"
    back = Mesh.load(str(out))
    assert back.num_faces == tres[7][0].num_faces


def test_fit_node_maps_its_widgets_as_jax(monkeypatch):
    """`Fitting Mesh With Multiview Images` in both packages, `fit`
    captured: `DiffMeshConfig`'s defaults are JAX's; the node's config from
    its widgets (with and without geometry training) and its cameras (the
    poses' c2w and fovy at the views' size) are JAX's; a mesh without UVs
    is unwrapped first; images and poses of different counts give (None,)
    in both (the port's node on the CPU)."""
    from comfy3d_tpu.nodes import nodes_render as jnr
    from comfy3d_tpu_torch.nodes import base as tbase
    from comfy3d_tpu_torch.nodes import nodes_render as tnr
    monkeypatch.setattr(tbase, "node_device", lambda: torch.device("cpu"))
    assert dataclasses.asdict(tdm.DiffMeshConfig()) == dataclasses.asdict(
        jdm.DiffMeshConfig())
    seen = {}
    for pkg, mod in (("jax", jdm), ("port", tdm)):
        monkeypatch.setattr(mod, "fit", lambda mesh, cams, im, ma, cfg, _p=pkg:
                            seen.setdefault(_p, []).append(
                                (mesh, cams, cfg)) or mesh)
    m = lumpy_sphere()
    bare = Mesh(v=m.v, f=m.f)
    images = np.random.RandomState(5).rand(6, 20, 24, 3).astype(np.float32)
    masks = np.ones((6, 20, 24), np.float32)
    poses = [[4.0, 10.0 * i, 60.0 * i, 0.0, 0.0, 0.0] for i in range(6)]
    for geometry in (True, False):
        kw = dict(training_iterations=7, batch_size=2,
                  texture_learning_rate=0.05, train_mesh_geometry=geometry,
                  remesh_after_n_iteration=300, texture_resolution=16)
        jnr.Fitting_Mesh_With_Multiview_Images().fit_mesh(
            _jmesh(bare), images, masks, poses, 30.0, **kw)
        tnr.Fitting_Mesh_With_Multiview_Images().fit_mesh(
            bare, torch.as_tensor(images), torch.as_tensor(masks), poses,
            30.0, **kw)
    for (jm, jc, jcfg), (tm, tc, tcfg) in zip(seen["jax"], seen["port"]):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert (tc.width, tc.height) == (jc.width, jc.height) == (24, 20)
        _close(tc.c2w, jc.c2w, rel=1e-6, what="c2w")
        _close(tc.fovy_deg, jc.fovy_deg, rel=1e-6, what="fovy")
        assert tm.vt is not None and jm.vt is not None
        assert np.array_equal(tm.v, np.asarray(jm.v))
    assert [c.remesh_every for _, _, c in seen["port"]] == [300, 0]
    for node, img in ((jnr, images[:5]), (tnr, torch.as_tensor(images[:5]))):
        assert node.Fitting_Mesh_With_Multiview_Images().fit_mesh(
            bare, img, masks[:5], poses, 30.0) == (None,)
