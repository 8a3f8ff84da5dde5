"""Port parity, 3DGS training path: the compositor's backward (plain version
against the Pallas kernel in interpret mode), render and projection
gradients, SSIM, and the trainer's step, densify and opacity reset,
`comfy3d_tpu_torch` against `comfy3d_tpu` on the same numpy-built inputs."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.algorithms import gs_trainer as JT
from comfy3d_tpu.core.gaussian import GaussianSplat as JSplat
from comfy3d_tpu.ops import gs_render as JG
from comfy3d_tpu.ops import ssim as jssim
from comfy3d_tpu.ops.pallas import gs_flat as jflat

from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.algorithms import gs_trainer as T
from comfy3d_tpu_torch.core.gaussian import GaussianSplat
from comfy3d_tpu_torch.ops import gs_flat
from comfy3d_tpu_torch.ops import gs_render as G
from comfy3d_tpu_torch.ops import ssim as tssim

from tests.test_torch_gs_render import _np, both_cameras, make_scene
from tests.test_torch_kernels import CASES, _bwd_case, pair_splats
from tests.test_torch_tile import jax_scatter
from tests.test_torch_common import one_torch_thread  # noqa: F401


def _close_to_max(port, ref, atol, name=""):
    """Agreement relative to the reference's largest magnitude (gradients:
    sums in another order, and near-zero entries of either sign)."""
    port, ref = _np(port), np.asarray(ref)
    assert np.isfinite(port).all(), name
    denom = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(port / denom, ref / denom, atol=atol, rtol=0,
                               err_msg=name)


# ------------------------------------------------- compositor backward
@functools.lru_cache(maxsize=None)
def _pallas_bwd_case(case, merged):
    """The case's inputs, the Pallas forward's trans/stops and backward
    columns in interpret mode, and seeded cotangents (COMFY3D_GS_MERGED is
    set by the caller to match `merged`)."""
    data, bounds, nbx, nby, cfg = _bwd_case(case)
    geo = (nbx, nby, cfg["nchan"], cfg["W"], cfg["H"])
    acc, trans, stops = jflat.composite_bins_fwd(
        jnp.asarray(data), jnp.asarray(bounds), *geo, bin_px=cfg["bin_px"],
        interpret=True)
    rng = np.random.RandomState(1)
    g_acc = rng.randn(*acc.shape).astype(np.float32)
    g_trans = rng.randn(*trans.shape).astype(np.float32)
    ref = np.asarray(jflat.composite_bins_bwd(
        jnp.asarray(data), jnp.asarray(bounds), trans, stops,
        jnp.asarray(g_acc), jnp.asarray(g_trans), *geo, bin_px=cfg["bin_px"],
        interpret=True))
    return (data, bounds, geo, cfg, np.array(trans), np.array(stops), g_acc,
            g_trans, ref)


@pytest.mark.parametrize("form", ["pairs", "splats"])
@pytest.mark.parametrize("case", sorted(CASES) + ["deep"])
@pytest.mark.parametrize("merged", [True, False])
def test_composite_bwd_plain_matches_pallas(monkeypatch, case, merged, form):
    """Per-pair columns against the Pallas kernel; per-splat rows (the CPU
    branch of `composite_bins_bwd_splats`) against the Pallas kernel
    followed by the JAX scatter."""
    monkeypatch.setenv("COMFY3D_GS_MERGED", "1" if merged else "0")
    (data, bounds, geo, cfg, trans, stops, g_acc, g_trans,
     ref) = _pallas_bwd_case(case, merged)
    nchan, bin_px = cfg["nchan"], cfg["bin_px"]
    ins = [torch.as_tensor(x) for x in (data, bounds, trans, stops, g_acc,
                                        g_trans)]
    if form == "splats":
        sprim, n = pair_splats(data)
        n += 2                                    # two splats in no bin
        port = _np(gs_flat.composite_bins_bwd_splats(     # CPU → plain
            *ins[:2], torch.as_tensor(sprim), n, *ins[2:], *geo,
            bin_px=bin_px))
        r_g = jax_scatter(ref.T, sprim, n, nchan)
        assert port.shape == r_g.shape == (n, 6 + nchan)
        # the per-pair plain columns sum in `cumsum`'s order, not the
        # Pallas kernel's, and differ from its columns by up to ~6e-5 of a
        # row's max on these cases; the per-splat sums inherit that
        for row in range(6 + nchan):
            _close_to_max(port[:, row], r_g[:, row], 1e-4, f"row {row}")
        assert not port[-2:].any() and not r_g[-2:].any()
        return
    port = _np(gs_flat.composite_bins_bwd_plain(*ins, *geo, bin_px=bin_px))
    assert port.shape == ref.shape == (gs_flat.grad_rows(nchan),
                                       data.shape[1])
    p = int(bounds[-1])
    for row in range(6 + nchan):
        _close_to_max(port[row, :p], ref[row, :p], 2e-3, f"row {row}")
    # columns of chunks no sub-tile walked, padding and sentinels: exactly 0
    walked = np.zeros(data.shape[1], bool)
    for t in range(geo[0] * geo[1]):
        b0, b1 = int(bounds[t]), int(bounds[t + 1])
        end = min(b1, b0 // 128 * 128 + 128 * int(stops[t].max()))
        walked[b0:max(b0, end)] = True
    assert not port[:, ~walked].any() and not ref[:, ~walked].any()
    assert not port[6 + nchan:].any()
    # the cases exercise what they claim to
    if case == "deep":
        assert (trans[0] == 0.0).mean() > 0.5          # T underflowed
    else:
        sat = cfg["sat_bin"]
        chunks = -(-(bounds[sat + 1] - bounds[sat] // 128 * 128) // 128)
        assert stops[sat].max() < chunks and (~walked[:p]).any()


def test_bwd_wrapper_checks_its_inputs():
    data, bounds, nbx, nby, cfg = _bwd_case("32px")
    args = (torch.as_tensor(data), torch.as_tensor(bounds))
    sprim, n = pair_splats(data)
    sprim = torch.as_tensor(sprim)
    acc, trans, stops = gs_flat.composite_bins_fwd_plain(*args, nbx, nby, 4,
                                                         64, 40)
    rest = (nbx, nby, 4, 64, 40)
    with pytest.raises(ValueError, match="g_acc"):
        gs_flat.composite_bins_bwd_splats(*args, sprim, n, trans, stops,
                                          acc[:, :, :3], trans, *rest)
    with pytest.raises(ValueError, match="stops"):
        gs_flat.composite_bins_bwd_splats(*args, sprim, n, trans,
                                          stops.long(), acc, trans, *rest)
    with pytest.raises(ValueError, match="sprim"):
        gs_flat.composite_bins_bwd_splats(*args, sprim.int(), n, trans,
                                          stops, acc, trans, *rest)
    meta = [x.to("meta") for x in (*args, sprim, trans, stops, acc, trans)]
    with pytest.raises(ValueError, match="cuda"):
        gs_flat.composite_bins_bwd_splats(*meta[:3], n, *meta[3:], *rest)


# -------------------------------------------------- render gradients
def _render_loss_inputs():
    W = H = 32
    jc, tc = both_cameras(0.0, 0.0, 3.0, W, H)
    xyz, scale, rot, opacity, colors, alive = make_scene(2, n=12, spread=0.4)
    target = np.random.RandomState(9).rand(H, W, 3).astype(np.float32)
    return W, H, jc, tc, (xyz, scale, rot, opacity, colors), alive, target


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_render_gradients_match_jax(backend):
    W, H, jc, tc, arrs, alive, target = _render_loss_inputs()
    offset = np.zeros((arrs[0].shape[0], 2), np.float32)

    def jloss(args):
        out = JG.render_arrays(*args[:5], jnp.asarray(alive), jc.w2c,
                               jc.intrinsics, W, H, max_per_tile=128,
                               chunk=8, means2d_offset=args[5],
                               backend=backend, interpret=True)
        return jnp.mean((out["image"] - target) ** 2) \
            + 0.1 * jnp.mean(out["alpha"])

    ref = jax.grad(jloss)(tuple(map(jnp.asarray, arrs + (offset,))))

    # the port's coarse-bin path against both JAX paths, its tile path
    # against JAX's (the "xla" backend)
    for port_backend in {"pallas": ["flat"], "xla": ["flat", "tile"]}[backend]:
        ts = [torch.tensor(a, requires_grad=True) for a in arrs + (offset,)]
        out = G.render_arrays(*ts[:5], torch.as_tensor(alive), tc.w2c,
                              tc.intrinsics, W, H, max_per_tile=128,
                              means2d_offset=ts[5], backend=port_backend)
        loss = ((out["image"] - torch.as_tensor(target)) ** 2).mean() \
            + 0.1 * out["alpha"].mean()
        loss.backward()
        names = ["xyz", "scale", "rot", "opacity", "colors", "means2d_offset"]
        for t, r, name in zip(ts, ref, names):
            assert np.abs(np.asarray(r)).max() > 0, name
            _close_to_max(t.grad, r, 2e-3, f"{backend}/{port_backend} {name}")


def test_project_gaussians_gradient_matches_jax():
    W, H = 64, 48
    jc, tc = both_cameras(15.0, 30.0, 3.0, W, H)
    xyz, scale, rot, *_ = make_scene(1, n=64)
    rng = np.random.RandomState(4)
    w_m, w_d, w_c = (rng.randn(64, 2), rng.randn(64), rng.randn(64, 3))

    def weigh(m2d, depth, conic, lib):
        cw = lib.asarray(w_c, dtype=lib.float32)
        return ((m2d * lib.asarray(w_m, dtype=lib.float32)).sum()
                + (depth * lib.asarray(w_d, dtype=lib.float32)).sum()
                + (conic * cw).sum())

    ref = jax.grad(lambda a: weigh(*JG.project_gaussians(
        *a, jc.w2c, jc.intrinsics, W, H)[:3], jnp))(
        tuple(map(jnp.asarray, (xyz, scale, rot))))
    ts = [torch.tensor(a, requires_grad=True) for a in (xyz, scale, rot)]
    m2d, depth, conic, _, _ = G.project_gaussians(*ts, tc.w2c,
                                                  tc.intrinsics, W, H)
    weigh(m2d, depth, conic, torch).backward()
    for t, r, name in zip(ts, ref, ["xyz", "scale", "rot"]):
        _close_to_max(t.grad, r, 1e-5, name)


# ---------------------------------------------------------------- SSIM
@pytest.mark.parametrize("fn", ["ssim", "ssim_full", "ms_ssim_1",
                                "ms_ssim_2", "ms_ssim_3", "psnr"])
def test_ssim_matches_jax(fn):
    rng = np.random.RandomState(3)
    x = rng.rand(2, 40, 48, 3).astype(np.float32)
    y = np.clip(x + 0.1 * rng.randn(*x.shape), 0, 1).astype(np.float32)

    def call(lib, xx, yy):
        if fn == "ssim":
            return lib.ssim(xx, yy)
        if fn == "ssim_full":
            s, cs = lib.ssim(xx, yy, full=True)
            return s + 2.0 * cs
        if fn == "psnr":
            return lib.psnr(xx, yy)
        return lib.ms_ssim(xx, yy, levels=int(fn[-1]))

    ref = call(jssim, jnp.asarray(x), jnp.asarray(y))
    ref_g = jax.grad(lambda a: call(jssim, a, jnp.asarray(y)))(
        jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    val = call(tssim, tx, torch.as_tensor(y))
    val.backward()
    np.testing.assert_allclose(float(val), float(ref), rtol=1e-5)
    _close_to_max(tx.grad, ref_g, 1e-4, fn)


# ------------------------------------------------------------- trainer
def test_lr_schedule_and_adam_match_jax():
    for step in (0, 1, 150, 299, 301, 15_000, 30_000, 40_000):
        args = (step, 0.00016, 0.0000016, 0.01, 30_000)
        np.testing.assert_allclose(T.exponential_lr(*args),
                                   float(JT.exponential_lr(*args)),
                                   rtol=1e-6)
    rng = np.random.RandomState(0)
    shapes = {"xyz": (10, 3), "sh": (10, 1, 3), "opacity_raw": (10,),
              "scale_raw": (10, 3), "rot_raw": (10, 4)}
    tree = lambda: {k: rng.randn(*s).astype(np.float32)  # noqa: E731
                    for k, s in shapes.items()}
    p, g, m = tree(), tree(), tree()
    v = {k: np.abs(a) for k, a in tree().items()}
    cfg = JT.GSTrainConfig()
    for step in (0, 7):
        ref = JT._adam_update(*({k: jnp.asarray(a) for k, a in d.items()}
                                for d in (p, g, m, v)),
                              JT._lr_tree(cfg, jnp.int32(step)),
                              jnp.int32(step))
        port = T._adam_update(*({k: torch.as_tensor(a) for k, a in d.items()}
                                for d in (p, g, m, v)),
                              T._lr_tree(T.GSTrainConfig(), step), step)
        for r_tree, p_tree in zip(ref, port):
            for k in shapes:
                np.testing.assert_allclose(_np(p_tree[k]),
                                           np.asarray(r_tree[k]),
                                           rtol=1e-6, atol=1e-7,
                                           err_msg=f"step {step} {k}")


def _synthetic_views(W=32, n_views=4):
    """4 coloured splats rendered by the port from an orbit at elevation 0
    (the scene of tests/test_gs_trainer.py::synthetic_views), as numpy."""
    gt = GaussianSplat.from_points(
        np.array([[0.0, 0, 0], [0.25, 0, 0], [0, 0.25, 0], [0, 0, 0.25]],
                 np.float32),
        colors=np.array([[0.9, 0.1, 0.1], [0.1, 0.9, 0.1],
                         [0.1, 0.1, 0.9], [0.9, 0.9, 0.1]], np.float32),
        initial_scale=0.12, device="cpu")
    gt = dataclasses.replace(gt, opacity_raw=torch.full_like(
        gt.opacity_raw, 3.0))
    azim = np.arange(n_views) * (360.0 / n_views)
    jc, tc = both_cameras(np.zeros(n_views, np.float32),
                          azim.astype(np.float32), 2.0, W, W)
    out = G.render(gt, tc, background=(1.0, 1.0, 1.0))
    return jc, tc, _np(out["image"]), _np(out["alpha"])


def _init_splat_arrays(n=48, cap=64):
    rng = np.random.RandomState(1)
    s = JSplat.from_points(rng.randn(n, 3).astype(np.float32) * 0.25,
                           capacity=cap)
    arrays = {f: np.array(getattr(s, f)) for f in convert.SPLAT_FIELDS}
    # anisotropic and rotated, so every parameter has a gradient
    arrays["scale_raw"][:n] += rng.randn(n, 3).astype(np.float32) * 0.3
    arrays["rot_raw"][:n] = rng.randn(n, 4).astype(np.float32)
    return arrays


def _state_numpy(state):
    return {"params": {k: np.asarray(v) for k, v in state.params.items()},
            "adam_m": {k: np.asarray(v) for k, v in state.adam_m.items()},
            "adam_v": {k: np.asarray(v) for k, v in state.adam_v.items()},
            "alive": np.asarray(state.alive),
            "grad_accum": np.asarray(state.grad_accum),
            "denom": np.asarray(state.denom),
            "max_radii": np.asarray(state.max_radii),
            "step": int(state.step)}


@pytest.mark.parametrize("jax_backend,port_backend",
                         [("pallas", "flat"), ("xla", "tile")])
def test_train_step_matches_jax(monkeypatch, jax_backend, port_backend):
    jc, tc, imgs, masks = _synthetic_views()
    arrays = _init_splat_arrays()
    # the JAX trainer runs its Pallas kernels on the CPU in interpret mode
    monkeypatch.setattr(JT.gs_render, "render_arrays", functools.partial(
        JG.render_arrays, interpret=True))
    jcfg = JT.GSTrainConfig(batch_size=2, max_per_tile=128, chunk=8,
                            density_start_iter=10_000,
                            position_lr_init=0.002, position_lr_final=0.0002,
                            backend=jax_backend)
    jstate = JT.init_state(JSplat(**{k: jnp.asarray(v)
                                     for k, v in arrays.items()}))
    key = jax.random.PRNGKey(3)
    j_new, j_met = JT.make_train_step(jcfg, jc, jnp.asarray(imgs),
                                      jnp.asarray(masks))(jstate, key)
    # the JAX step's draws (gs_trainer.py:235-240), handed to the port
    k_view, k_bg = jax.random.split(jax.random.fold_in(key, 0))
    view_idx = np.asarray(jax.random.randint(k_view, (2,), 0, 4))
    bgs = np.asarray(jnp.where(jax.random.uniform(k_bg, (2, 1)) < 0.5,
                               0.0, 1.0) * jnp.ones((2, 3)))

    state = convert.train_state_from_numpy(_state_numpy(jstate), "cpu")
    cfg = T.GSTrainConfig(**dict(dataclasses.asdict(jcfg),
                                 backend=port_backend))
    new, met = T.make_train_step(cfg, tc, torch.as_tensor(imgs),
                                 torch.as_tensor(masks))(
        state, torch.as_tensor(view_idx), torch.as_tensor(bgs))

    for k in ("loss", "l1", "alpha", "ssim"):
        np.testing.assert_allclose(float(met[k]), float(j_met[k]),
                                   rtol=1e-4, err_msg=k)
    assert int(met["num_alive"]) == int(j_met["num_alive"]) == 48
    assert new.step == int(j_new.step) == 1
    # after one step from zero moments adam_m = 0.1·g: the gradients
    for k in T.PARAMS:
        assert np.abs(np.asarray(j_new.adam_m[k])).max() > 0, k
        _close_to_max(new.adam_m[k], j_new.adam_m[k], 2e-3, k)
    _close_to_max(new.grad_accum, j_new.grad_accum, 2e-3, "grad_accum")
    np.testing.assert_array_equal(_np(new.denom), np.asarray(j_new.denom))
    np.testing.assert_allclose(_np(new.max_radii),
                               np.asarray(j_new.max_radii), atol=1.0)
    # dead slots frozen in both
    for k in T.PARAMS:
        np.testing.assert_array_equal(_np(new.params[k])[48:],
                                      arrays[k][48:])


def test_dead_slots_stay_frozen():
    _, tc, imgs, masks = _synthetic_views()
    splat = convert.splat_from_numpy(_init_splat_arrays(n=16, cap=32), "cpu")
    cfg = T.GSTrainConfig(batch_size=1, density_start_iter=10_000)
    step = T.make_train_step(cfg, tc, torch.as_tensor(imgs),
                             torch.as_tensor(masks))
    state = T.init_state(splat)
    gen = torch.Generator().manual_seed(1)
    for _ in range(3):
        state, _ = step(state, *T.draw_step_inputs(gen, 4, 1, 0.5))
    for k in T.PARAMS:
        assert torch.equal(state.params[k][16:], getattr(splat, k)[16:]), k
        assert not torch.equal(state.params[k][:16], getattr(splat, k)[:16])


def _densify_state(step=5, n=24, cap=40, rotated=False):
    arrays = _init_splat_arrays(n=n, cap=cap)
    if not rotated:
        arrays["rot_raw"][:, 0], arrays["rot_raw"][:, 1:] = 1.0, 0.0
    rng = np.random.RandomState(2)
    arrays["scale_raw"][:n] = np.log(rng.uniform(0.005, 0.2, (n, 3)))
    arrays["scale_raw"][3] = np.log(0.6)                  # prune: world scale
    arrays["opacity_raw"][:n] = rng.randn(n)
    arrays["opacity_raw"][5] = -8.0                       # prune: opacity
    splat = JSplat(**{k: jnp.asarray(v) for k, v in arrays.items()})
    st = JT.init_state(splat)
    tree = lambda: {k: jnp.asarray(rng.randn(*v.shape).astype(np.float32))  # noqa: E731
                    for k, v in st.params.items()}
    accum = np.zeros(cap, np.float32)
    accum[:n] = rng.uniform(0.0, 0.5, n)
    radii = np.zeros(cap, np.float32)
    radii[:n] = rng.uniform(0, 18, n)
    radii[7] = 30.0                                       # prune: screen px
    return dataclasses.replace(
        st, adam_m=tree(), adam_v=tree(), grad_accum=jnp.asarray(accum),
        denom=jnp.asarray(np.where(accum > 0, 2.0, 0.0).astype(np.float32)),
        max_radii=jnp.asarray(radii), step=jnp.int32(step))


def _densify_both(rotated):
    jcfg = JT.GSTrainConfig(densify_grad_threshold=0.02, scene_extent=4.0,
                            prune_min_opacity=0.005)
    jstate = _densify_state(rotated=rotated)
    key = jax.random.PRNGKey(4)
    ref = JT.make_densify_step(jcfg)(jstate, key)
    # the JAX step's noise (gs_trainer.py:288,312-314), handed to the port
    k1 = jax.random.split(jax.random.fold_in(key, 5), 2)
    cap = jstate.alive.shape[0]
    noise = [np.asarray(jax.random.normal(k, (cap, 3))) for k in k1]
    state = convert.train_state_from_numpy(_state_numpy(jstate), "cpu")
    out = T.make_densify_step(T.GSTrainConfig(**dataclasses.asdict(jcfg)))(
        state, *map(torch.as_tensor, noise))
    return jstate, ref, out, noise


def test_densify_matches_jax():
    # identity rotations: the JAX step normalises quaternions by one matrix
    # norm (`jnp.linalg.norm(q, -1)` reads -1 as `ord`), the port each by
    # its own length; for identity rotations both give R = I
    jstate, ref, out, _ = _densify_both(rotated=False)
    cap = jstate.alive.shape[0]

    np.testing.assert_array_equal(_np(out.alive), np.asarray(ref.alive))
    # the case prunes slots 3, 5 and 7 (the first free slots, so children
    # land there) and has more children than free slots
    assert int(np.asarray(jstate.alive).sum()) < cap
    assert int(np.asarray(ref.alive).sum()) == cap
    moved = np.any(np.asarray(ref.params["xyz"])
                   != np.asarray(jstate.params["xyz"]), -1)
    assert moved[[3, 5, 7]].all()
    for k in T.PARAMS:
        np.testing.assert_allclose(_np(out.params[k]),
                                   np.asarray(ref.params[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(_np(out.adam_m[k]),
                                      np.asarray(ref.adam_m[k]))
        np.testing.assert_array_equal(_np(out.adam_v[k]),
                                      np.asarray(ref.adam_v[k]))
    for k in ("grad_accum", "denom", "max_radii"):
        assert not _np(getattr(out, k)).any(), k


def test_densify_rotates_split_offsets_per_splat():
    jstate, ref, out, noise = _densify_both(rotated=True)
    np.testing.assert_array_equal(_np(out.alive), np.asarray(ref.alive))
    for k in ("sh", "opacity_raw", "scale_raw", "rot_raw"):
        np.testing.assert_allclose(_np(out.params[k]),
                                   np.asarray(ref.params[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    # a split source moves to xyz + R(q/|q|)·(noise1·scale)
    p = {k: np.asarray(v, np.float64) for k, v in jstate.params.items()}
    split = np.asarray(ref.params["scale_raw"])[:, 0] < p["scale_raw"][:, 0]
    split &= np.asarray(jstate.alive)
    split[[3, 5, 7]] = False             # pruned, then refilled by children
    assert split.sum() >= 5
    q = p["rot_raw"] / np.linalg.norm(p["rot_raw"], axis=-1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)
    want = p["xyz"] + np.einsum("nij,nj->ni", R,
                                noise[0] * np.exp(p["scale_raw"]))
    np.testing.assert_allclose(_np(out.params["xyz"])[split], want[split],
                               atol=1e-6)


def test_reset_opacity_matches_jax():
    jstate = _densify_state()
    ref = JT.reset_opacity(jstate)
    out = T.reset_opacity(
        convert.train_state_from_numpy(_state_numpy(jstate), "cpu"))
    for k in T.PARAMS:
        np.testing.assert_allclose(_np(out.params[k]),
                                   np.asarray(ref.params[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(_np(out.adam_m[k]),
                                      np.asarray(ref.adam_m[k]))
    op = torch.sigmoid(out.params["opacity_raw"])
    assert float(op.max()) <= 0.01 + 1e-6


def test_train_api_densifies_and_returns_a_splat():
    _, tc, imgs, masks = _synthetic_views(W=24)
    splat = convert.splat_from_numpy(_init_splat_arrays(n=32, cap=64), "cpu")
    cfg = T.GSTrainConfig(iterations=30, batch_size=1,
                          density_start_iter=5, densification_interval=10,
                          densify_grad_threshold=1e-6,
                          opacity_reset_interval=10_000)
    calls = []
    out = T.train(splat, tc, imgs, masks, cfg,
                  generator=torch.Generator().manual_seed(0),
                  progress=lambda it, m: calls.append((it, m["loss"])))
    assert isinstance(out, GaussianSplat)
    assert [it for it, _ in calls] == [0, 29]
    assert all(np.isfinite(loss) for _, loss in calls)
    assert int(out.alive.sum()) > 32                      # densified
