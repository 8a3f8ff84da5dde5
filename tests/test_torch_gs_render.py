"""Port parity, 3DGS render path: projection, coarse binning, the bin
compositor's plain version (against the Pallas kernel in interpret mode) and
`render` end to end, `comfy3d_tpu_torch` against `comfy3d_tpu` on the same
numpy-built inputs."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import collections

import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.core.camera import Camera as JCamera
from comfy3d_tpu.core.gaussian import GaussianSplat as JSplat
from comfy3d_tpu.ops import binning as jbin
from comfy3d_tpu.ops import gs_render as JG
from comfy3d_tpu.ops.pallas import gs_flat as jflat

from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.core.gaussian import GaussianSplat
from comfy3d_tpu_torch.ops import _build, binning, gs_flat
from comfy3d_tpu_torch.ops import gs_render as G

from tests.test_torch_kernels import CASES, make_bins_case, rows_of_payload
from tests.test_torch_common import one_torch_thread  # noqa: F401


def make_scene(seed, n=24, spread=0.6):
    """numpy rebuild of tests/test_gs_render.py::make_scene."""
    rng = np.random.RandomState(seed)
    xyz = (rng.randn(n, 3) * spread).astype(np.float32)
    scale = (np.exp(rng.randn(n, 3) * 0.3) * 0.08).astype(np.float32)
    rot = rng.randn(n, 4).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    opacity = (1.0 / (1.0 + np.exp(-(rng.randn(n) + 1.0)))).astype(np.float32)
    colors = rng.rand(n, 3).astype(np.float32)
    alive = np.ones((n,), bool)
    return xyz, scale, rot, opacity, colors, alive


def both_cameras(elev, azim, radius, W, H):
    ref = JCamera.from_orbit(elev, azim, radius, width=W, height=H)
    port = convert.camera_from_numpy(np.asarray(ref.c2w),
                                     np.asarray(ref.fovy_deg), W, H,
                                     ref.near, ref.far, "cpu")
    return ref, port


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# --------------------------------------------------------- projection
@pytest.mark.parametrize("seed", [0, 1])
def test_project_gaussians_matches_jax(seed):
    W, H = 64, 48
    jc, tc = both_cameras(15.0, 30.0, 3.0, W, H)
    xyz, scale, rot, *_ = make_scene(seed, n=64)
    ref = JG.project_gaussians(jnp.asarray(xyz), jnp.asarray(scale),
                               jnp.asarray(rot), jc.w2c, jc.intrinsics, W, H)
    port = G.project_gaussians(torch.as_tensor(xyz), torch.as_tensor(scale),
                               torch.as_tensor(rot), tc.w2c, tc.intrinsics,
                               W, H)
    m2d, depth, conic, radii, vis = (_np(x) for x in port)
    r_m2d, r_depth, r_conic, r_radii, r_vis = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(m2d, r_m2d, atol=1e-4, rtol=0)
    np.testing.assert_allclose(depth, r_depth, rtol=1e-5)
    np.testing.assert_allclose(conic, r_conic, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(vis, r_vis)
    # radii = ceil(3·sqrt(λ)): equal, except ±1 where the value fed to ceil
    # lies within 1e-4 of an integer
    ca, cb, cc = (conic[:, i].astype(np.float64) for i in range(3))
    inv = 1.0 / (ca * cc - cb * cb)          # 2D covariance from the conic
    a, c, det = cc * inv, ca * inv, inv
    mid = 0.5 * (a + c)
    pre = 3.0 * np.sqrt(mid + np.sqrt(np.maximum(mid * mid - det, 0.0)))
    diff = radii - r_radii
    near_int = np.abs(pre - np.round(pre)) < 1e-4
    assert np.all((diff == 0) | ((np.abs(diff) == 1) & near_int))
    assert np.mean(diff == 0) > 0.9


# ------------------------------------------------------------ binning
def _bin_inputs(seed, n=300, W=96, H=72, huge=False):
    rng = np.random.RandomState(seed)
    means2d = (rng.rand(n, 2) * [W + 40, H + 40] - 20).astype(np.float32)
    depth = rng.uniform(0.5, 4.0, n).astype(np.float32)
    radii = np.ceil(rng.rand(n) * (60 if huge else 12)).astype(np.float32)
    radii[rng.rand(n) < 0.05] = 0.0
    active = rng.rand(n) > 0.1
    return means2d, depth, radii, active


@pytest.mark.parametrize("seed,huge", [(0, False), (1, False), (2, True)])
def test_bin_coarse_matches_jax(seed, huge):
    W, H = 96, 72
    nby, nbx = binning.num_bins(H, W)
    assert (nby, nbx) == jbin.num_bins(H, W)
    args = _bin_inputs(seed, W=W, H=H, huge=huge)
    r_sprim, r_bounds, r_over = jbin.bin_coarse(
        *(jnp.asarray(a) for a in args), nby, nbx, k=4)
    sprim, bounds, over = binning.bin_coarse(
        *(torch.as_tensor(a) for a in args), nby, nbx, k=4)
    r_bounds = np.asarray(r_bounds)
    np.testing.assert_array_equal(_np(bounds), r_bounds)
    assert bool(over) == bool(r_over) == huge
    r_sprim, sprim = np.asarray(r_sprim), _np(sprim)
    depth = args[1]
    for t in range(nbx * nby):
        seg = sprim[r_bounds[t]:r_bounds[t + 1]]
        r_seg = r_sprim[r_bounds[t]:r_bounds[t + 1]]
        assert collections.Counter(seg.tolist()) == \
            collections.Counter(r_seg.tolist()), t
        assert np.all(np.diff(depth[seg]) >= -1e-6 * depth[seg][1:]), t


# ---------------------------------------------------------- compositor
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("merged", [True, False])
def test_composite_plain_matches_pallas(monkeypatch, case, merged):
    cfg = CASES[case]
    data, bounds, nbx, nby = make_bins_case(0, **cfg)
    W, H, bin_px, nchan = cfg["W"], cfg["H"], cfg["bin_px"], cfg["nchan"]
    monkeypatch.setenv("COMFY3D_GS_MERGED", "1" if merged else "0")
    r_acc, r_tr, r_st = (np.asarray(x) for x in jflat.composite_bins_fwd(
        jnp.asarray(data), jnp.asarray(bounds), nbx, nby, nchan, W, H,
        bin_px=bin_px, interpret=True))
    rows, sprim = rows_of_payload(data)
    acc, tr, st = (_np(x) for x in gs_flat.composite_bins_fwd_rows(
        rows, sprim, torch.as_tensor(bounds), nbx, nby, nchan, W, H,
        bin_px=bin_px))                           # CPU → plain version
    np.testing.assert_array_equal(st, r_st)
    np.testing.assert_allclose(acc, r_acc, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tr, r_tr, atol=1e-4, rtol=0)

    # the case exercises what it claims to
    assert H % bin_px != 0
    chunks = [0 if b1 == b0 else -(-(b1 - b0 // 128 * 128) // 128)
              for b0, b1 in zip(bounds[:-1], bounds[1:])]
    sat = cfg["sat_bin"]
    assert st[sat].max() < chunks[sat]
    if case == "32px":
        assert bounds[1] % 128 > 0 and chunks[1] == 3
    if not merged:      # out-of-image sub-tiles: acc 0, T 1, stops 0
        out = st.min(-1) == 0
        assert out.any() and np.all(tr[st == 0] == 1.0)


def test_composite_mode_follows_the_environment(monkeypatch):
    data, bounds, nbx, nby = make_bins_case(1, **CASES["32px"])
    args = (*rows_of_payload(data), torch.as_tensor(bounds), nbx, nby, 4,
            64, 40)
    monkeypatch.setenv("COMFY3D_GS_MERGED", "0")
    per_sub = gs_flat.composite_bins_fwd_rows(*args)[2]
    monkeypatch.setenv("COMFY3D_GS_MERGED", "1")
    merged = gs_flat.composite_bins_fwd_rows(*args)[2]
    assert torch.equal(per_sub, gs_flat.composite_bins_fwd_rows(
        *args, merged=False)[2])
    assert bool((merged == merged[:, :1]).all())     # one value per bin
    assert not torch.equal(per_sub, merged)


# ------------------------------------------------------ end to end
def _render_jax(arrs, jc, W, H, backend):
    return JG.render_arrays(*map(jnp.asarray, arrs), jc.w2c, jc.intrinsics,
                            W, H, backend=backend, interpret=True,
                            max_per_tile=128, chunk=8)


@pytest.mark.parametrize("seed", [0, 3])
def test_render_arrays_matches_jax(seed):
    W, H = 64, 40
    jc, tc = both_cameras(10.0, 25.0, 3.0, W, H)
    arrs = make_scene(seed, n=40)
    port = G.render_arrays(*map(torch.as_tensor, arrs), tc.w2c,
                           tc.intrinsics, W, H)
    for backend in ("pallas", "xla"):
        ref = _render_jax(arrs, jc, W, H, backend)
        for key, atol in (("image", 1e-4), ("alpha", 1e-4), ("depth", 1e-3)):
            np.testing.assert_allclose(_np(port[key]), np.asarray(ref[key]),
                                       atol=atol, rtol=0,
                                       err_msg=f"{backend} {key}")
        np.testing.assert_allclose(_np(port["radii"]),
                                   np.asarray(ref["radii"]))
    assert not bool(port["overflow"])
    assert 0.0 < float(port["alpha"].mean()) < 1.0


def test_render_batch_of_three_matches_jax():
    W, H = 48, 48
    rng = np.random.RandomState(7)
    n = 64
    arrays = {
        "xyz": (rng.randn(n, 3) * 0.4).astype(np.float32),
        "sh": (rng.randn(n, 4, 3) * 0.5).astype(np.float32),
        "opacity_raw": (rng.randn(n) + 1.0).astype(np.float32),
        "scale_raw": (rng.randn(n, 3) * 0.2 + np.log(0.06)).astype(np.float32),
        "rot_raw": rng.randn(n, 4).astype(np.float32),
        "alive": rng.rand(n) > 0.1,
    }
    elev = np.array([0.0, 30.0, -15.0], np.float32)
    azim = np.array([0.0, 120.0, 250.0], np.float32)
    jc, tc = both_cameras(elev, azim, 2.5, W, H)
    jsplat = JSplat(**{k: jnp.asarray(v) for k, v in arrays.items()})
    port = G.render(convert.splat_from_numpy(arrays, "cpu"), tc,
                    background=(0.2, 0.4, 0.6))
    assert port["image"].shape == (3, H, W, 3)
    assert port["alpha"].shape == (3, H, W)
    for backend in ("pallas", "xla"):
        ref = JG.render(jsplat, jc, background=(0.2, 0.4, 0.6),
                        backend=backend, interpret=True, max_per_tile=128,
                        chunk=8)
        for key, atol in (("image", 1e-4), ("alpha", 1e-4), ("depth", 1e-3)):
            np.testing.assert_allclose(_np(port[key]), np.asarray(ref[key]),
                                       atol=atol, rtol=0,
                                       err_msg=f"{backend} {key}")


# ------------------------------------------------------------- hygiene
def test_backward_through_the_compositor_fills_every_grad():
    """The compositor's backward runs and fills every differentiable
    input's `.grad`."""
    W, H = 32, 32
    _, tc = both_cameras(0.0, 0.0, 3.0, W, H)
    xyz, scale, rot, opacity, colors, alive = (
        torch.as_tensor(a) for a in make_scene(2, n=12, spread=0.4))
    ins = [x.requires_grad_(True) for x in (xyz, scale, rot, opacity, colors)]
    out = G.render_arrays(xyz, scale, rot, opacity, colors, alive, tc.w2c,
                          tc.intrinsics, W, H)
    (out["image"].sum() + out["alpha"].sum() + out["depth"].sum()).backward()
    for x in ins:
        assert x.grad is not None and x.grad.shape == x.shape
        assert bool(torch.isfinite(x.grad).all()) and bool(x.grad.any())


def test_wrapper_runs_the_plain_version_only_on_the_cpu():
    data, bounds, nbx, nby = make_bins_case(0, **CASES["32px"])
    rows, sprim = rows_of_payload(data)
    b = torch.as_tensor(bounds)
    with pytest.raises(ValueError, match="cuda"):
        gs_flat.composite_bins_fwd_rows(rows.to("meta"), sprim.to("meta"),
                                        b.to("meta"), nbx, nby, 4, 64, 40)
    with pytest.raises(ValueError, match="bounds"):
        gs_flat.composite_bins_fwd_rows(rows, sprim, b.long(), nbx, nby, 4,
                                        64, 40)
    with pytest.raises(ValueError, match="rows"):
        gs_flat.composite_bins_fwd_rows(rows[:, :8], sprim, b, nbx, nby, 4,
                                        64, 40)
    with pytest.raises(ValueError, match="sprim"):
        gs_flat.composite_bins_fwd_rows(rows, sprim.int(), b, nbx, nby, 4,
                                        64, 40)
    # the CPU branch is the gather followed by the payload's plain version
    out = gs_flat.composite_bins_fwd_rows(rows, sprim, b, nbx, nby, 4, 64,
                                          40)
    ref = gs_flat.composite_bins_fwd_plain(torch.as_tensor(data), b, nbx,
                                           nby, 4, 64, 40)
    for x, y in zip(out, ref):
        assert torch.equal(x, y)


def test_no_cpu_fallback_for_a_cuda_request(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CUDA request succeeds")
    # entry points default to the card, and there is none: they raise
    with pytest.raises((RuntimeError, AssertionError)):
        GaussianSplat.random(torch.Generator().manual_seed(0), 16)
    # the kernel's build raises where nvcc is missing, naming it
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    try:
        _build.find_nvcc()
    except RuntimeError as e:
        assert "nvcc" in str(e)
    else:
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["gs_flat_fwd"])
