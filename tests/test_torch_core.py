"""Port parity, geometry core: SH, cameras, splats and GS-PLY of
`comfy3d_tpu_torch` against `comfy3d_tpu` on the same numpy inputs."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.core import sh as jsh
from comfy3d_tpu.core.camera import Camera as JCamera
from comfy3d_tpu.core.camera import get_rays as j_get_rays
from comfy3d_tpu.core.gaussian import GaussianSplat as JSplat
from comfy3d_tpu.core.gaussian import quat_to_rotmat as j_q2r
from comfy3d_tpu.core.gaussian import rotmat_to_quat as j_r2q
from comfy3d_tpu.core.io import ply as jply

import comfy3d_tpu_torch
from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.core import camera as tcam
from comfy3d_tpu_torch.core import sh as tsh
from comfy3d_tpu_torch.core.camera import Camera
from comfy3d_tpu_torch.core.gaussian import GaussianSplat
from comfy3d_tpu_torch.core.gaussian import quat_to_rotmat, rotmat_to_quat
from comfy3d_tpu_torch.core.io import ply as tply

from tests.test_torch_common import one_torch_thread  # noqa: F401

ATOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


def _splat_arrays(seed, n=32, deg=2):
    rng = np.random.RandomState(seed)
    k = (deg + 1) ** 2
    rot = rng.randn(n, 4).astype(np.float32)
    return {
        "xyz": (rng.randn(n, 3) * 0.5).astype(np.float32),
        "sh": (rng.randn(n, k, 3) * 0.4).astype(np.float32),
        "opacity_raw": rng.randn(n).astype(np.float32),
        "scale_raw": (rng.randn(n, 3) * 0.3 - 3.0).astype(np.float32),
        "rot_raw": rot,
        "alive": rng.rand(n) > 0.2,
    }


def _jax_splat(arrays):
    return JSplat(**{k: jnp.asarray(v) for k, v in arrays.items()})


# ------------------------------------------------------------------ SH
@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(deg):
    rng = np.random.RandomState(deg)
    coeffs = rng.randn(50, 3, (deg + 1) ** 2).astype(np.float32)
    dirs = rng.randn(50, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ref = jsh.eval_sh(deg, jnp.asarray(coeffs), jnp.asarray(dirs))
    _close(tsh.eval_sh(deg, torch.as_tensor(coeffs), torch.as_tensor(dirs)),
           ref)


def test_sh_rgb_roundtrip_matches_jax():
    rgb = np.random.RandomState(0).rand(10, 3).astype(np.float32)
    _close(tsh.rgb_to_sh(torch.as_tensor(rgb)), jsh.rgb_to_sh(jnp.asarray(rgb)))
    shc = tsh.rgb_to_sh(torch.as_tensor(rgb))
    _close(tsh.sh_to_rgb(shc), rgb, atol=1e-6)


# ------------------------------------------------------------- cameras
def _camera_fields_close(port, ref):
    _close(port.c2w, ref.c2w)
    _close(port.w2c, ref.w2c)
    _close(port.campos, ref.campos)
    _close(port.intrinsics, ref.intrinsics, atol=1e-4)   # pixels, ~1e3
    _close(port.proj, ref.proj)
    assert port.batch_shape == tuple(ref.batch_shape)


@pytest.mark.parametrize("batched", [False, True])
def test_camera_from_orbit_matches_jax(batched):
    if batched:
        elev = np.array([0.0, 30.0, -20.0, 89.0], np.float32)
        azim = np.array([0.0, 120.0, 250.0, -45.0], np.float32)
        radius = np.array([2.5, 3.0, 1.2, 4.0], np.float32)
    else:
        elev, azim, radius = 15.0, 30.0, 3.0
    ref = JCamera.from_orbit(elev, azim, radius, width=96, height=64)
    port = Camera.from_orbit(elev, azim, radius, width=96, height=64,
                             device="cpu")
    _camera_fields_close(port, ref)


def test_camera_from_camposes_matches_jax():
    poses = tcam.compose_orbit_camposes(
        [2.2, 2.2, 3.0], [10.0, -30.0, 0.0], [0.0, 135.0, 270.0],
        centers_y=[0.1, 0.0, -0.2])
    ref = JCamera.from_camposes(poses, fovy_deg=40.0, width=64, height=64)
    port = Camera.from_camposes(poses, fovy_deg=40.0, width=64, height=64,
                                device="cpu")
    _camera_fields_close(port, ref)
    back = convert.camera_from_numpy(np.asarray(ref.c2w),
                                     np.asarray(ref.fovy_deg), 64, 64,
                                     ref.near, ref.far, "cpu")
    _camera_fields_close(back, ref)


def test_presets_and_get_rays_match_jax():
    from comfy3d_tpu.core import camera as jcam
    assert tcam.ORBITPOSE_PRESETS == jcam.ORBITPOSE_PRESETS
    ref = JCamera.from_orbit(np.array([0.0, 20.0], np.float32),
                             np.array([0.0, 60.0], np.float32), 2.0,
                             width=12, height=8)
    port = Camera.from_orbit(np.array([0.0, 20.0], np.float32),
                             np.array([0.0, 60.0], np.float32), 2.0,
                             width=12, height=8, device="cpu")
    ro, rd = j_get_rays(ref)
    po, pd = tcam.get_rays(port)
    _close(po, ro)
    _close(pd, rd)
    _close(tcam.orthographic(-0.55, 0.55, -0.55, 0.55, device="cpu"),
           jcam.orthographic(-0.55, 0.55, -0.55, 0.55))


# -------------------------------------------------------------- splats
@pytest.mark.parametrize("deg", [0, 1, 3])
def test_splat_activations_and_colors_match_jax(deg):
    arrays = _splat_arrays(deg, deg=deg)
    ref = _jax_splat(arrays)
    port = convert.splat_from_numpy(arrays, "cpu")
    _close(port.opacity, ref.opacity)
    _close(port.scale, ref.scale)
    _close(port.rotation, ref.rotation)
    _close(port.covariance(), ref.covariance())
    assert port.sh_degree == ref.sh_degree == deg
    campos = np.array([0.3, 1.1, 2.4], np.float32)
    _close(port.colors_toward(torch.as_tensor(campos)),
           ref.colors_toward(jnp.asarray(campos)))


def test_from_points_and_rotations_match_jax():
    rng = np.random.RandomState(5)
    pts = rng.randn(40, 3).astype(np.float32)
    cols = rng.rand(40, 3).astype(np.float32)
    ref = JSplat.from_points(pts, colors=cols, sh_degree=1, capacity=48)
    port = GaussianSplat.from_points(pts, colors=cols, sh_degree=1,
                                     capacity=48, device="cpu")
    for f in ("xyz", "sh", "opacity_raw", "scale_raw", "rot_raw", "alive"):
        _close(getattr(port, f), getattr(ref, f))
    q = rng.randn(64, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = quat_to_rotmat(torch.as_tensor(q))
    _close(R, j_q2r(jnp.asarray(q)))
    _close(rotmat_to_quat(R), j_r2q(j_q2r(jnp.asarray(q))), atol=2e-6)


@pytest.mark.parametrize("spec", ["+x+y+z", "-z+x-y", "+y-x+z"])
def test_switch_axis_matches_jax(spec):
    arrays = _splat_arrays(3, deg=1)
    ref = _jax_splat(arrays).switch_axis(spec)
    port = convert.splat_from_numpy(arrays, "cpu").switch_axis(spec)
    _close(port.xyz, ref.xyz)
    _close(port.scale_raw, ref.scale_raw)
    # a quaternion and its negation are one rotation: compare matrices
    _close(quat_to_rotmat(port.rotation), j_q2r(ref.rotation), atol=2e-6)


def test_random_is_seeded_and_in_radius():
    a = GaussianSplat.random(torch.Generator().manual_seed(3), 500,
                             sh_degree=1, radius=0.8, device="cpu")
    b = GaussianSplat.random(torch.Generator().manual_seed(3), 500,
                             sh_degree=1, radius=0.8, device="cpu")
    assert torch.equal(a.xyz, b.xyz)
    assert a.sh.shape == (500, 4, 3) and bool(a.alive.all())
    assert float(torch.linalg.vector_norm(a.xyz, dim=-1).max()) <= 0.8 + 1e-6


# -------------------------------------------------------------- GS-PLY
@pytest.mark.parametrize("deg", [0, 2])
def test_gs_ply_is_interchangeable_with_jax(tmp_path, deg):
    arrays = _splat_arrays(10 + deg, deg=deg)
    jpath, tpath = str(tmp_path / "jax.ply"), str(tmp_path / "port.ply")
    jply.save_gs_ply(jpath, _jax_splat(arrays))
    tply.save_gs_ply(tpath, convert.splat_from_numpy(arrays, "cpu"))
    with open(jpath, "rb") as fj, open(tpath, "rb") as ft:
        assert fj.read() == ft.read()

    from_jax = tply.load_gs_ply(jpath, device="cpu")     # port reads JAX's
    from_port = jply.load_gs_ply(tpath)                   # JAX reads port's
    for f in ("xyz", "sh", "opacity_raw", "scale_raw", "rot_raw", "alive"):
        a = getattr(from_jax, f).numpy()
        b = np.asarray(getattr(from_port, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    alive = arrays["alive"]
    assert from_jax.num_capacity == int(alive.sum())
    assert from_jax.xyz.numpy().tobytes() == arrays["xyz"][alive].tobytes()


# ------------------------------------------------------------- hygiene
def test_package_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import comfy3d_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'comfy3d_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'comfy3d_tpu' or m.startswith('comfy3d_tpu.')]\n"
        "assert len(mods) >= 10, mods\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("ok")


def test_default_device_is_the_card():
    assert comfy3d_tpu_torch.default_device() == torch.device("cuda")
