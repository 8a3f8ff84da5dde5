"""Port parity, the tile backend's per-tile cap below one 128-slot chunk:
`max_per_tile=64, chunk=8`, which the JAX package's `xla` path takes, in
`render_arrays` (outputs and gradients) and in one train step,
`comfy3d_tpu_torch` against `comfy3d_tpu` on the same numpy inputs."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = pytest.mark.heavy

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.ops import gs_render as JG

from comfy3d_tpu_torch.ops import binning
from comfy3d_tpu_torch.ops import gs_render as G

from tests.test_torch_gs_render import _np, both_cameras, make_scene


def _crowded_scene(seed=5, n=160):
    """Enough splats that some 16-px tiles hold more than 64 of them."""
    xyz, scale, rot, opacity, colors, alive = make_scene(seed, n=n,
                                                         spread=0.25)
    return xyz, scale * 0.5, rot, opacity * 0.5, colors, alive


def test_tile_cap_below_one_chunk_matches_jax():
    """`max_per_tile=64, chunk=8`, which the JAX `xla` path takes: the port
    pads the lists to its 128-slot chunks with invalid slots; outputs and
    gradients of `render_arrays` match, and the cap bites."""
    W, H = 48, 48
    jc, tc = both_cameras(10.0, 25.0, 3.0, W, H)
    *arrs, alive = _crowded_scene()
    kw = dict(max_per_tile=64, chunk=8)
    target = np.random.RandomState(2).rand(H, W, 3).astype(np.float32)

    def jrender(args):
        return JG.render_arrays(*args, jnp.asarray(alive), jc.w2c,
                                jc.intrinsics, W, H, backend="xla", **kw)

    def jloss(args):
        out = jrender(args)
        return jnp.mean((out["image"] - target) ** 2) \
            + 0.1 * jnp.mean(out["alpha"])

    ref = jrender(tuple(map(jnp.asarray, arrs)))
    ref_g = jax.grad(jloss)(tuple(map(jnp.asarray, arrs)))
    ts = [torch.tensor(a, requires_grad=True) for a in arrs]
    port = G.render_arrays(*ts, torch.as_tensor(alive), tc.w2c,
                           tc.intrinsics, W, H, backend="tile", **kw)
    for key, atol in (("image", 1e-5), ("alpha", 1e-5), ("depth", 1e-5)):
        scale = max(1.0, float(np.abs(np.asarray(ref[key])).max()))
        np.testing.assert_allclose(_np(port[key]) / scale,
                                   np.asarray(ref[key]) / scale,
                                   atol=atol, rtol=0, err_msg=key)
    ((port["image"] - torch.as_tensor(target)) ** 2).mean().add(
        0.1 * port["alpha"].mean()).backward()
    for t, r, name in zip(ts, ref_g, ["xyz", "scale", "rot", "opacity",
                                      "colors"]):
        r = np.asarray(r)
        scale = np.abs(r).max()
        assert scale > 0, name
        np.testing.assert_allclose(_np(t.grad) / scale, r / scale,
                                   atol=1e-4, rtol=0, err_msg=name)
    # the cap bites: some tile held more than 64 splats
    means2d, _, _, radii, vis = G.project_gaussians(
        *(torch.as_tensor(a) for a in arrs[:3]), tc.w2c, tc.intrinsics, W, H)
    m = means2d.detach()
    r = radii.detach()[:, None]
    bins = binning.bin_primitives(m - r, m + r, vis & torch.as_tensor(alive),
                                  *binning.num_tiles(H, W), max_per_tile=64)
    assert int(bins.count.max()) > 64


def test_tile_train_step_below_one_chunk_matches_jax():
    """One `GSTrainConfig(backend="tile", max_per_tile=64, chunk=8)` step
    on the CPU against the JAX trainer's `xla` step from the same state."""
    from comfy3d_tpu.algorithms import gs_trainer as JT
    from comfy3d_tpu.core.gaussian import GaussianSplat as JSplat

    from comfy3d_tpu_torch import convert
    from comfy3d_tpu_torch.algorithms import gs_trainer as T

    from tests.test_torch_train import (_close_to_max, _init_splat_arrays,
                                        _state_numpy, _synthetic_views)
    jc, tc, imgs, masks = _synthetic_views()
    arrays = _init_splat_arrays()
    jcfg = JT.GSTrainConfig(batch_size=2, max_per_tile=64, chunk=8,
                            density_start_iter=10_000, backend="xla")
    jstate = JT.init_state(JSplat(**{k: jnp.asarray(v)
                                     for k, v in arrays.items()}))
    key = jax.random.PRNGKey(4)
    j_new, j_met = JT.make_train_step(jcfg, jc, jnp.asarray(imgs),
                                      jnp.asarray(masks))(jstate, key)
    k_view, k_bg = jax.random.split(jax.random.fold_in(key, 0))
    view_idx = np.asarray(jax.random.randint(k_view, (2,), 0, 4))
    bgs = np.asarray(jnp.where(jax.random.uniform(k_bg, (2, 1)) < 0.5,
                               0.0, 1.0) * jnp.ones((2, 3)))

    cfg = T.GSTrainConfig(**dict(dataclasses.asdict(jcfg), backend="tile"))
    state = convert.train_state_from_numpy(_state_numpy(jstate), "cpu")
    new, met = T.make_train_step(cfg, tc, torch.as_tensor(imgs),
                                 torch.as_tensor(masks))(
        state, torch.tensor(view_idx), torch.tensor(bgs))
    for k in ("loss", "l1", "alpha", "ssim"):
        np.testing.assert_allclose(float(met[k]), float(j_met[k]),
                                   rtol=1e-4, err_msg=k)
    for k in T.PARAMS:
        _close_to_max(new.adam_m[k], j_new.adam_m[k], 2e-3, k)
    # a cap that is no multiple of chunk is refused, as JAX cannot run it
    with pytest.raises(ValueError, match="chunk"):
        T.GSTrainConfig(backend="tile", max_per_tile=60, chunk=8)
    T.GSTrainConfig(backend="flat", max_per_tile=60, chunk=8)
