"""Port parity, FlexiCubes multi-view depth → mesh: `ops/flexicubes.py` in
both modes, the soft silhouette's plain version, the mip chain and
antialias, the differentiable marching tets and the tet sweep, one
`SDFFit` step for both engines, a replayed 2-step fit and the
`Mesh_Orbit_Renderer → FlexiCubes_MVS` graph, `comfy3d_tpu_torch` against
`comfy3d_tpu` on the same numpy inputs. The fits replay the JAX package's
view draws (`PRNGKey(seed)` split every step); its fit compiles with
`QUICK_XLA` and hands its objective back through a patched
`jax.value_and_grad`. The soft-silhouette kernel itself runs only on the
card (`chip_smoke.py` phase 22a)."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from comfy3d_tpu.algorithms import sdf_fit as jsf
from comfy3d_tpu.core.camera import Camera as JCamera
from comfy3d_tpu.core.mesh import Mesh as JMesh
from comfy3d_tpu.ops import flexicubes as jfc
from comfy3d_tpu.ops import mesh_render as jmr
from comfy3d_tpu.ops import rasterize as jr
from comfy3d_tpu.ops import tetra as jt

from comfy3d_tpu_torch.algorithms import sdf_fit as tsf
from comfy3d_tpu_torch.core.camera import Camera
from comfy3d_tpu_torch.core.mesh import Mesh
from comfy3d_tpu_torch.ops import flexicubes as tfc
from comfy3d_tpu_torch.ops import rasterize as tr
from comfy3d_tpu_torch.ops import tetra as tt

from tests.test_torch_common import (QUICK_XLA, _np, one_torch_thread,  # noqa: F401
                                     quick_jax, quick_jax_renderers)

# against the JAX package, of the largest value: single passes (outputs and
# gradients) within REL; the fits (losses, gradients, vertices) within
# REL_FIT
REL = 1e-5
REL_FIT = 1e-4
N_VIEWS, SIZE = 4, 20


def _close(out, ref, rel=REL, what=""):
    out, ref = _np(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())


def jax_quads(mp):
    """The port's fits on the JAX package's FlexiCubes faces (ROADMAP
    §C.14): `sdf_fit`'s `flexicubes` with `quad_order="jax"`."""
    mp.setattr(tsf.FC, "flexicubes",
               functools.partial(tfc.flexicubes, quad_order="jax"))


def lumpy_sphere(seed=0):
    """`chip_smoke.uv_sphere` (6 × 12 quads, radius 0.55) with its points
    pushed out by up to 10 %: no pixel centre on an edge."""
    rng = np.random.RandomState(seed)
    m = chip_smoke.uv_sphere(6, 12, 0.55)
    v = (m.v * (1.0 + 0.1 * rng.rand(len(m.v), 1))).astype(np.float32)
    return Mesh(v=v, f=m.f).auto_normal()


def cameras(n=N_VIEWS, size=SIZE):
    elev = np.array([15.0, -10.0, 30.0, 5.0][:n], np.float32)
    azim = (np.arange(n) * (360.0 / n) + 10.0).astype(np.float32)
    return (JCamera.from_orbit(jnp.asarray(elev), jnp.asarray(azim), 2.2,
                               width=size, height=size),
            Camera.from_orbit(torch.as_tensor(elev), torch.as_tensor(azim),
                              2.2, width=size, height=size, device="cpu"))


def grid_case(res, seed):
    """A noisy sphere SDF on the (res+1)³ grid, deformed vertices and raw
    weights (numpy)."""
    rng = np.random.RandomState(seed)
    v = jfc.grid_verts(res)
    sdf = (0.55 - np.linalg.norm(v, axis=-1)
           + 0.1 * rng.randn(len(v))).astype(np.float32)
    verts = (v + 0.05 * rng.randn(*v.shape)).astype(np.float32)
    w = (0.5 * rng.randn(res ** 3, 21)).astype(np.float32)
    return sdf, verts, w


def test_flexicubes_matches_jax():
    """FlexiCubes at res 5 on a noisy sphere with deformed vertices and
    random weights, eval and training mode: the valid faces in the JAX
    package's order (eval: the same dual-vertex indices), their triangles
    and L_dev within 1e-5 of the largest value, and the gradients of a
    seeded function of the triangles plus L_dev with respect to the sdf,
    the vertices and the weights within 1e-5 (the port given the JAX
    package's quad order); without weights the faces of both packages
    agree too. On a sphere at res 8 the port's own quad order (ROADMAP
    §C.14) gives a closed surface, every edge in two faces, wound toward
    positive sdf; the JAX package's does not close."""
    res = 5
    sdf, verts, w = grid_case(res, 0)

    def refs(sdf, verts, w):
        out = {}
        for training in (False, True):
            def f(s, v, ww):
                vd, _, faces, fv, l_dev = jfc.flexicubes(
                    s, v, res, weights=ww, training=training)
                t = vd[faces]
                return (jnp.sin(3.0 * t).sum((1, 2)) * fv).sum() + l_dev
            vd, _, faces, fv, l_dev = jfc.flexicubes(
                sdf, verts, res, weights=w, training=training)
            out[str(training)] = (vd, faces, fv, l_dev,
                             jax.grad(f, argnums=(0, 1, 2))(sdf, verts, w))
        out["plain"] = jfc.flexicubes(sdf, verts, res)[2:4]
        return out

    ref = jax.jit(refs, compiler_options=QUICK_XLA)(sdf, verts, w)
    for training in (False, True):
        vd_j, f_j, fv_j, l_j, g_j = (np.asarray(a) if not isinstance(a, tuple)
                                     else a for a in ref[str(training)])
        s, v, ww = (torch.tensor(a, requires_grad=True)
                    for a in (sdf, verts, w))
        vd, vv, faces, fv, l_dev = tfc.flexicubes(s, v, res, weights=ww,
                                                  training=training,
                                                  quad_order="jax")
        assert bool(fv.all()) and vv.shape[0] == vd.shape[0]
        valid = f_j[fv_j]
        assert faces.shape[0] == len(valid) > 0
        if not training:
            assert np.array_equal(_np(faces), valid)
        t = vd[faces]
        _close(t, vd_j[valid], what=f"triangles {training}")
        _close(l_dev, l_j, what="L_dev")
        (torch.sin(3.0 * t).sum() + l_dev).backward()
        for name, a, b in zip(("sdf", "verts", "weights"), (s, v, ww), g_j):
            _close(a.grad, b, what=f"d{name} {training}")
    f_j, fv_j = map(np.asarray, ref["plain"])
    _, _, faces, _, _ = tfc.flexicubes(torch.as_tensor(sdf),
                                       torch.as_tensor(verts), res,
                                       quad_order="jax")
    assert np.array_equal(_np(faces), f_j[fv_j])
    np.testing.assert_array_equal(tfc.grid_verts(3), jfc.grid_verts(3))
    # the port's own quad order on a sphere: a closed surface wound inward
    # (toward positive sdf), where the JAX package's has edges of one face
    # and of three or four
    g = jfc.grid_verts(8)
    ball = torch.as_tensor(0.47 - np.linalg.norm(g, axis=-1),
                           dtype=torch.float32)
    for training in (False, True):
        sides = {}
        for order in ("cycle", "jax"):
            vd, _, f, _, _ = tfc.flexicubes(ball, torch.as_tensor(g), 8,
                                            training=training,
                                            quad_order=order)
            f = _np(f)
            e = np.sort(f[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2), 1)
            sides[order] = np.unique(np.unique(e, axis=0,
                                               return_counts=True)[1])
            if order == "cycle":
                t = vd[torch.as_tensor(f)]
                n = torch.linalg.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
                assert bool(((n * t.mean(1)).sum(-1) < 0).all())
        assert list(sides["cycle"]) == [2] and len(sides["jax"]) > 1


def test_soft_silhouette_plain_matches_jax():
    """The soft silhouette (σ 3e-4) of 40 random faces over 30 points at
    20², one point behind the camera (faces through it dropped), a fifth of
    the faces invalid, interior pixels clipped at 1 − 1e-7: the coverage and
    the vertex gradients of a seeded cotangent within 1e-5 of their largest
    value of the JAX package's; on the CPU `soft_silhouette` is
    `soft_silhouette_plain`, the kernel wrappers run the plain log-sum and
    its autograd, and no kernel launches."""
    rng = np.random.RandomState(0)
    v = (rng.rand(30, 3) * 1.2 - 0.6).astype(np.float32)
    v[0] = [0.0, 0.0, 3.0]
    faces = rng.randint(0, 30, (40, 3)).astype(np.int32)
    fv = rng.rand(40) > 0.2
    jcams, tcams = cameras()
    mvp = np.asarray(jcams.view_proj[0], np.float32)
    cot = rng.randn(SIZE, SIZE).astype(np.float32)

    def f(v):
        return jr.soft_silhouette(v, faces, mvp, SIZE, SIZE, sigma=3e-4,
                                  face_valid=fv)

    ref, g_ref = jax.jit(lambda v: (f(v), jax.grad(
        lambda v: (f(v) * cot).sum())(v)), compiler_options=QUICK_XLA)(v)
    tv = torch.tensor(v, requires_grad=True)
    args = (torch.as_tensor(faces), torch.as_tensor(mvp), SIZE, SIZE)
    out = tr.soft_silhouette_plain(tv, *args, sigma=3e-4,
                                   face_valid=torch.as_tensor(fv))
    (out * torch.as_tensor(cot)).sum().backward()
    _close(out, ref, what="coverage")
    _close(tv.grad, g_ref, what="dv")
    assert (np.asarray(ref) > 1 - 1e-6).sum() > 10
    tri, ok = tr._face_screen(torch.as_tensor(v), args[0], args[1], SIZE,
                              SIZE, torch.as_tensor(fv))
    assert not bool(ok[fv & (faces == 0).any(1)].any())
    launches = (tr.soft_silhouette_fwd.launches,
                tr.soft_silhouette_bwd.launches)
    same = tr.soft_silhouette(torch.as_tensor(v), *args, sigma=3e-4,
                              face_valid=torch.as_tensor(fv))
    assert torch.equal(same, out.detach())
    L = tr.soft_silhouette_fwd(tri, ok, SIZE, SIZE, 3e-4)
    _close(1.0 - torch.exp(L), ref, what="fwd wrapper")
    g_tri = tr.soft_silhouette_bwd(tri, ok, torch.as_tensor(cot), SIZE, SIZE,
                                   3e-4)
    t = tri.clone().requires_grad_()
    (tr.soft_silhouette_logsum_plain(t, ok, SIZE, SIZE, 3e-4)
     * torch.as_tensor(cot)).sum().backward()
    _close(g_tri, t.grad, rel=1e-6, what="bwd wrapper")
    assert (tr.soft_silhouette_fwd.launches,
            tr.soft_silhouette_bwd.launches) == launches


def window_faces(rng, height, width, reach):
    """[F, 3, 2] screen corners: small faces over and around the view,
    points, slivers, faces larger than the view, faces partly off-screen,
    and small faces whose box lies within a pixel of R from a warp's pixel
    centres (beside, below or diagonal to it; on either side)."""
    ext = np.array([width, height], np.float64)
    centre = rng.uniform(-reach, ext + reach, (60, 2))
    small = centre[:, None] + rng.uniform(-4.0, 4.0, (60, 3, 2))
    points = np.repeat(rng.uniform(0, ext, (8, 1, 2)), 3, 1)
    a = rng.uniform(0, ext, (8, 2))
    b = a + rng.uniform(-20.0, 20.0, (8, 2))
    c = (a + rng.uniform(0, 1, (8, 1)) * (b - a)
         + rng.uniform(-1e-3, 1e-3, (8, 2)))
    slivers = np.stack([a, b, c], 1)
    e = max(height, width)
    large = np.array([[[-2.0 * e, -2.0 * e], [4.0 * e, -e], [0.0, 4.0 * e]],
                      [[-e, 0.3 * height], [2.0 * e, 0.2 * height],
                       [0.5 * width, 3.0 * e]]])
    off = (rng.uniform(-0.1, 1.1, (8, 1, 2)) * ext
           + rng.uniform(-0.4, 0.4, (8, 3, 2)) * ext)
    rects = tr.silhouette_rects(height, width, tr.SIL_WARP_ROWS).numpy()
    rim = []
    for k in range(24):
        x0, y0, x1, y1 = rects[rng.randint(len(rects))]
        gap = reach + rng.uniform(-1.0, 1.0)
        way = k % 3        # beside, below, diagonal
        dx, dy = ((gap, 0.0), (0.0, gap),
                  (gap / np.sqrt(2), gap / np.sqrt(2)))[way]
        corner = np.array([x1 + dx, y1 + dy]) if way != 0 else \
            np.array([x1 + dx, rng.uniform(y0, y1)])
        rim.append(corner + np.array([[0.0, 0.0], [3.0, 1.0], [1.0, 3.0]]))
    return np.concatenate([small, points, slivers, large, off,
                           np.stack(rim)]).astype(np.float32)


@pytest.mark.parametrize("sigma,height,width", [
    (1e-4, 64, 64), (3e-4, 64, 64), (1e-4, 48, 80), (3e-4, 48, 80)])
def test_silhouette_window_holds_every_live_pair(sigma, height, width):
    """Every face-pixel pair whose plain sigmoid argument
    (`_signed_dist_to_tri`, as `soft_silhouette_logsum_plain` computes it)
    is at least −87 lies in the kernels' window: the face's box
    (`silhouette_boxes`) within `silhouette_reach` + 1 px
    (`silhouette_window`) of the pixel's 16 × 16 tile and of its warp's
    16 × 2 pixels. Random faces from a seed (`window_faces`), a fifth not
    ok. On the non-square views the reach taken from the smaller side
    would miss live pairs."""
    rng = np.random.RandomState(17)
    reach = tr.silhouette_reach(sigma, height, width)
    tri = torch.as_tensor(window_faces(rng, height, width, reach))
    ok = torch.as_tensor(rng.rand(tri.shape[0]) > 0.2)
    boxes = tr.silhouette_boxes(tri, ok, height, width, reach)[ok]
    t = tri[ok]
    px = tr._pixel_centers(height, width, "cpu")
    d = tr._signed_dist_to_tri(px[:, :, None], t[:, 0], t[:, 1],
                               t[:, 2]) * (1.0 / max(height, width))
    live = torch.sign(d) * d * d / sigma >= tr.SIL_S_MIN     # [H, W, F]
    assert int(live.sum()) > 0
    for rows in (tr.SIL_TILE, tr.SIL_WARP_ROWS):
        # each pixel's block of `rows` rows by 16 columns
        rects = tr.silhouette_rects(height, width, rows).reshape(
            -(-height // rows), -(-width // tr.SIL_TILE), 4)
        ys = torch.arange(height) // rows
        xs = torch.arange(width) // tr.SIL_TILE
        rect = rects[ys[:, None], xs[None, :]]                # [H, W, 4]
        window = tr.silhouette_window(boxes, reach, rect)
        assert not bool((live & ~window).any()), (rows, int(
            (live & ~window).sum()))
        assert bool((~window).any())
        if height != width:
            short = tr.silhouette_reach(sigma, height, min(height, width))
            assert bool((live & ~tr.silhouette_window(
                tr.silhouette_boxes(tri, ok, height, width, short)[ok],
                short, rect)).any())


def test_mip_chain_and_antialias_match_jax():
    """`build_mip_chain` (a 16 × 8 texture: 4 levels; with `max_levels` 2),
    `uv_mip_level`, `texture_sample_mip` in wrap and clamp mode, and
    `antialias` of a lumpy sphere's render at 20² with its vertex
    gradients, within 1e-5 of the largest value of the JAX package's."""
    rng = np.random.RandomState(1)
    tex = rng.rand(16, 8, 3).astype(np.float32)
    uv = (rng.rand(10, 12, 2) * 1.4 - 0.2).astype(np.float32)
    lod = (rng.rand(10, 12) * 5.0 - 1.0).astype(np.float32)
    m = lumpy_sphere(2)
    jcams, tcams = cameras(1)
    mvp = np.asarray(jcams.view_proj[0], np.float32)
    color = rng.rand(SIZE, SIZE, 3).astype(np.float32)
    bg = rng.rand(3).astype(np.float32)
    cot = rng.randn(SIZE, SIZE, 3).astype(np.float32)

    def refs(tex, uv, lod, v):
        f = jnp.asarray(m.f)
        rast = jr.rasterize(v, f, mvp, SIZE, SIZE, method="bruteforce")

        def aa(v):
            return jr.antialias(color, bg, v, f, mvp, rast, sigma=1e-4)
        return (jr.build_mip_chain(tex), jr.build_mip_chain(tex, 2),
                jr.uv_mip_level(uv, 16),
                [jr.texture_sample_mip(jr.build_mip_chain(tex), uv, lod, md)
                 for md in ("wrap", "clamp")],
                rast.face_id, aa(v),
                jax.grad(lambda v: (aa(v) * cot).sum())(v))

    (mips, mips2, level, samples, face_id, aa_ref,
     g_ref) = jax.jit(refs, compiler_options=QUICK_XLA)(tex, uv, lod, m.v)
    t_mips = tr.build_mip_chain(torch.as_tensor(tex))
    assert len(t_mips) == len(mips) == 4
    assert len(tr.build_mip_chain(torch.as_tensor(tex), 2)) == len(mips2)
    for a, b in zip(t_mips, mips):
        _close(a, b, what="mip")
    _close(tr.uv_mip_level(torch.as_tensor(uv), 16), level, what="lod")
    for md, ref in zip(("wrap", "clamp"), samples):
        _close(tr.texture_sample_mip(t_mips, torch.as_tensor(uv),
                                     torch.as_tensor(lod), md), ref, what=md)
    tv = torch.tensor(m.v, requires_grad=True)
    faces, tmvp = torch.as_tensor(m.f), torch.as_tensor(mvp)
    rast = tr.rasterize(tv, faces, tmvp, SIZE, SIZE, method="bruteforce")
    assert np.array_equal(_np(rast.face_id), np.asarray(face_id))
    out = tr.antialias(torch.as_tensor(color), torch.as_tensor(bg), tv,
                       faces, tmvp, rast, sigma=1e-4)
    (out * torch.as_tensor(cot)).sum().backward()
    _close(out, aa_ref, what="antialias")
    _close(tv.grad, g_ref, what="antialias dv")


def test_marching_tets_diff_and_sweep_match_jax():
    """`marching_tets_diff` on a deformed 5³ lattice's tets (a noisy sphere
    field): validity equal, triangles within 1e-5 of the largest value,
    the gradients of a seeded cotangent to vertices and field within 1e-5;
    `sweep_tets` in chunks of 200 tets, with and without the per-chunk cap
    (40) and the soup cap (300): soups and overflow flags equal."""
    rng = np.random.RandomState(3)
    v, tets = jt.grid_tets(5)
    sdf = (0.6 - np.linalg.norm(v, axis=-1)
           + 0.05 * rng.randn(len(v))).astype(np.float32)
    verts = (v + 0.03 * rng.randn(*v.shape)).astype(np.float32)
    cot = rng.randn(2 * len(tets), 3, 3).astype(np.float32)

    def refs(verts, sdf):
        def f(a, b):
            tris, valid = jt.marching_tets_diff(a, b, tets)
            return (tris * cot * valid[:, None, None]).sum()
        return jt.marching_tets_diff(verts, sdf, tets), jax.grad(
            f, argnums=(0, 1))(verts, sdf)

    (tris_j, valid_j), g_j = jax.jit(refs)(verts, sdf)
    a, b = (torch.tensor(x, requires_grad=True) for x in (verts, sdf))
    tris, valid = tt.marching_tets_diff(a, b, tets)
    assert np.array_equal(_np(valid), np.asarray(valid_j))
    _close(tris[valid], np.asarray(tris_j)[np.asarray(valid_j)],
           what="triangles")
    (tris * torch.as_tensor(cot) * valid[:, None, None]).sum().backward()
    _close(a.grad, g_j[0], what="dverts")
    _close(b.grad, g_j[1], what="dsdf")
    for kw in (dict(tet_chunk=200), dict(tet_chunk=200, cap=40,
                                         max_tris=300)):
        soup_j, ovf_j = jt.sweep_tets(verts, sdf, tets, **kw)
        soup, ovf = tt.sweep_tets(torch.as_tensor(verts),
                                  torch.as_tensor(sdf), tets, **kw)
        assert ovf == ovf_j and soup.shape == soup_j.shape, kw
        np.testing.assert_array_equal(soup, soup_j)


def _axis_norm(x, ord=None, axis=None, keepdims=False):
    """The port's face-normal length in place of `jnp.linalg.norm`: the JAX
    fit's `jnp.linalg.norm(fn, -1, keepdims=True)` passes -1 as `ord`, a
    matrix norm of all face normals together (ROADMAP §C.11); the port
    normalises each face's normal along that axis, its length floored at
    1e-12 inside the square root (a degenerate face gets no NaN
    gradient)."""
    return jnp.sqrt(jnp.maximum((x * x).sum(axis=ord if axis is None
                                            else axis, keepdims=keepdims),
                                1e-24))


def _patched_jax(monkeypatch, engine="flexicubes"):
    """The JAX fit's `jax` compiling with `QUICK_XLA`, its
    `value_and_grad` handing each step's (views, loss, gradients) back
    into the list returned (`jax.debug.callback`); its `jnp.linalg.norm` as
    `_axis_norm` and, for FlexiCubes, its `jnp.cross` negated: the port
    takes the outward normal of FlexiCubes' faces, which wind toward
    positive sdf, inward in the fit (ROADMAP §C.11)."""
    steps = []
    quick = quick_jax()

    def value_and_grad(fn):
        vg = jax.value_and_grad(fn)

        def run(params, view_idx):
            loss, g = vg(params, view_idx)
            jax.debug.callback(lambda *a: steps.append(a), view_idx, loss, g)
            return loss, g
        return run

    quick.value_and_grad = value_and_grad
    monkeypatch.setattr(jsf, "jax", quick)
    axis_jnp = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                        if not k.startswith("__")})
    axis_jnp.linalg = types.SimpleNamespace(norm=_axis_norm)
    if engine == "flexicubes":
        axis_jnp.cross = lambda a, b: -jnp.cross(a, b)
    monkeypatch.setattr(jsf, "jnp", axis_jnp)
    return steps


def jax_views(cfg, nviews, seed=0):
    """The JAX fit's view indices [iterations, batch]: `PRNGKey(seed)`
    split every step."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(cfg.iterations):
        key, k = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(k, (cfg.batch_size,), 0,
                                                 nviews)))
    return np.stack(out)


@pytest.fixture(scope="module")
def tets_fit():
    """The JAX package's 2-step fit of the marching-tets engine (res 6: no
    grid vertex lies on the initial sphere, whose zero-thickness sheets
    would tie in depth; one of 4 views at 20² a step) to a lumpy sphere's
    masks, depths and normals rendered by the JAX package, with each step's
    views, loss and gradients."""
    jcams, tcams = cameras()
    m = lumpy_sphere(1)
    out = jax.jit(lambda v: jmr.render_mesh(v, jnp.asarray(m.f), jcams,
                                            vn=jnp.asarray(m.vn),
                                            method="bruteforce"),
                  compiler_options=QUICK_XLA)(m.v)
    refs = (np.asarray(out["alpha"]), np.asarray(out["depth"]),
            np.asarray(out["normal"]) * 0.5 + 0.5)
    cfg = tsf.SDFFitConfig(resolution=6, iterations=2, batch_size=1,
                           engine="tets", lambda_depth=5.0)
    with pytest.MonkeyPatch.context() as mp:
        steps = _patched_jax(mp, "tets")
        mesh = jsf.fit(jcams, *refs, jsf.SDFFitConfig(**dataclasses.asdict(
            cfg)))
    return tcams, refs, cfg, steps, mesh


@pytest.fixture(scope="module")
def fc_graph(tmp_path_factory):
    """`chip_smoke.config_graph("flexicubes")` through both packages'
    `run_workflow` on the CPU: Load 3D Mesh (a lumpy sphere the test
    writes) → Stack Orbit Camera Poses (8 views) → Mesh Orbit Renderer at
    20² (the JAX renderer jitted with `QUICK_XLA`) → FlexiCubes MVS (res 5: no grid vertex on the initial sphere; 2
    steps of batch 2, the depths decoded over [0, 5], L_dev's weight 0: at
    the initial sphere each crossing point's deviation is rounding noise
    and |x|'s gradient there its sign, so L_dev is held in
    `test_flexicubes_matches_jax`) → Save 3D Mesh. The port's fit takes
    the JAX fit's view draws and quad order (ROADMAP §C.14); each node's
    fit inputs, and the JAX fit's steps, are recorded."""
    from comfy3d_tpu.nodes import base as jbase, graph as jgraph
    from comfy3d_tpu_torch.nodes import base as tbase, graph as tgraph
    tmp = tmp_path_factory.mktemp("flexicubes")
    inputs = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, attr in (("in", "INPUT_ROOT_PATH"),
                           ("out", "OUTPUT_ROOT_PATH"),
                           ("ckpt", "CKPT_ROOT_PATH")):
            (tmp / name).mkdir()
            for b in (jbase, tbase):
                mp.setattr(b, attr, str(tmp / name))
        lumpy_sphere(4).write(str(tmp / "in" / "fc_sphere.glb"))
        quick_jax_renderers(mp)
        steps = _patched_jax(mp, "flexicubes")
        jax_quads(mp)
        for pkg, mod in (("jax", jsf), ("port", tsf)):
            def recorded(cams, masks, ref_depths=None, ref_normals=None,
                         cfg=None, _fit=mod.fit, _pkg=pkg, **kw):
                inputs[_pkg] = (cams, masks, ref_depths, ref_normals, cfg)
                return _fit(cams, masks, ref_depths=ref_depths,
                            ref_normals=ref_normals, cfg=cfg, **kw)
            mp.setattr(mod, "fit", recorded)
        mp.setattr(tsf, "draw_views", lambda it, b, n, seed=0: jax_views(
            tsf.SDFFitConfig(iterations=it, batch_size=b), n, seed))
        graph = chip_smoke.config_graph("flexicubes", fit_size=SIZE,
                                        depth_range=(0.0, 5.0))
        overrides = {4: {"training_iterations": 2, "batch_size": 2,
                         "voxel_grids_resolution": 5,
                         "remove_floaters_weight": 0.0}}
        jres = jgraph.run_workflow(graph, overrides)
        tres = tgraph.run_workflow(graph, overrides, device="cpu")
    return jres, tres, inputs, steps, tmp


def test_sdf_fit_step_matches_jax(fc_graph, tets_fit, monkeypatch):
    """The first `SDFFit` step of each engine on the JAX fit's first views
    (FlexiCubes on the graph's inputs in the JAX package's quad order,
    ROADMAP §C.14; the mask, depth and normal terms, the sign regularizer,
    the deformation penalty and, for FlexiCubes, the weight stabilizer, its
    |w| differentiated at 0 as the JAX package does): the loss and the
    gradient of every parameter within 1e-4 of their largest value of the
    JAX fit's own; the configs' defaults equal. The JAX fit's face normals
    are normalised per face for this (`_axis_norm`), FlexiCubes' outward
    (`_patched_jax`): as written, the JAX package divides them all by one
    matrix norm (ROADMAP §C.11), shown here."""
    _, _, inputs, fc_steps, _ = fc_graph
    tcams, refs, tcfg, t_steps, _ = tets_fit
    jax_quads(monkeypatch)
    cams, masks, depths, normals, cfg = inputs["port"]
    for engine, args, steps in (
            ("flexicubes", (cams, masks, depths, normals, cfg), fc_steps),
            ("tets", (tcams, *refs, tcfg), t_steps)):
        views, loss_j, grads_j = steps[0]
        problem = tsf.SDFFit(*args[:4], cfg=args[4])
        loss = problem.loss(problem.params, views)
        loss.backward()
        _close(loss.detach(), loss_j, REL_FIT, f"{engine} loss")
        assert sorted(problem.params) == sorted(grads_j)
        for k, p in problem.params.items():
            _close(p.grad, grads_j[k], REL_FIT, f"{engine} d{k}")
    assert dataclasses.asdict(tsf.SDFFitConfig()) == dataclasses.asdict(
        jsf.SDFFitConfig())
    fn = np.random.RandomState(5).randn(6, 3).astype(np.float32)
    assert jnp.linalg.norm(fn, -1, keepdims=True).shape == (1, 1)


def test_fit_replays_jax_draws(tets_fit):
    """The 2-step marching-tets fit with the JAX fit's views (`PRNGKey(0)`
    split every step, replayed by `jax_views`): the welded mesh's triangles
    within 1e-4 of the largest value of the JAX package's, triangle by
    triangle (the weld's 1e-6 rounding may split a point in one package
    only)."""
    tcams, refs, cfg, steps, jmesh = tets_fit
    views = jax_views(cfg, N_VIEWS)
    assert np.array_equal(views, np.stack([s[0] for s in steps]))
    mesh = tsf.fit(tcams, *refs, cfg=cfg, views=views)
    assert mesh.num_faces > 20
    _close(mesh.v[mesh.f], np.asarray(jmesh.v)[np.asarray(jmesh.f)],
           REL_FIT, "triangles")


def test_flexicubes_graph_matches_jax(fc_graph):
    """The slice as a whole (`fc_graph`): the renders within 1e-5 of their
    largest value; the FlexiCubes node's fit inputs — cameras, masks, the
    decoded depths, normal maps and config — the JAX node's; the fitted
    mesh (the 2 steps replaying the JAX fit's draws) with the JAX package's
    faces, its vertices within 1e-4 (its vertex normals are not held:
    slivers of the fan make them sensitive to rounding); the GLB read
    back."""
    jres, tres, inputs, steps, tmp = fc_graph
    for k in range(4):
        _close(tres[3][k], jres[3][k], what=f"render {k}")
    (jc, *jarrays, jcfg), (tc, *tarrays, tcfg) = inputs["jax"], inputs["port"]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    _close(tc.c2w, jc.c2w, what="c2w")
    for a, b, what in zip(tarrays, jarrays, ("masks", "depths", "normals")):
        _close(a, b, what=what)
    assert len(steps) == 2
    mesh, jmesh = tres[4][0], jres[4][0]
    assert mesh.num_faces > 20
    assert np.array_equal(mesh.f, np.asarray(jmesh.f))
    _close(mesh.v, jmesh.v, REL_FIT, "v")
    out = tmp / "out" / chip_smoke.WF_DIR / "flexicubes_mesh.glb"
    assert Mesh.load(str(out)).num_faces == mesh.num_faces
    assert isinstance(jmesh, JMesh)
