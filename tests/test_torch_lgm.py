"""Port parity, LGM views → splats: the resnet (plain and pooling) and
cross-view attention blocks, `LGMUNet`, `plucker_rays`,
`decode_gaussians`, `forward_gaussians`' splat fields and order, and the
state dict in LGM's checkpoint layout, `comfy3d_tpu_torch` against
`comfy3d_tpu` on the same numpy inputs and weights (flax params carried
across by `convert.lgm_state_dict_from_flax`). The slice as a whole, text
→ views → splats → orbit, is in `test_torch_mvdream.py`."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.models.lgm import model as jm
from comfy3d_tpu.models.lgm.convert import convert_lgm
from comfy3d_tpu.models.lgm.pipeline import LGMPipeline as JLGMPipeline

from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.models.lgm import model as tm
from comfy3d_tpu_torch.models.lgm import LGMConfig, LGMPipeline

from tests.test_torch_common import (QUICK_XLA, _load, _np, _params,
                                     one_torch_thread)  # noqa: F401

# `tests/test_workflows.py::_tiny_lgm`'s shapes: 32² views → 16² splat maps
TINY = dict(input_size=32, splat_size=16, down_channels=(8, 16, 32),
            down_attention=(False, False, True), mid_attention=True,
            up_channels=(32, 16), up_attention=(True, False),
            layers_per_block=1, attention_heads=4, norm_groups=4)
# outputs against the JAX package: within this share of their largest value
REL = 1e-4
SPLAT_FIELDS = ("xyz", "sh", "opacity_raw", "scale_raw", "rot_raw")


def _close(out, ref, rel=REL, what=""):
    out, ref = _np(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())


def nchw(a):
    return torch.as_tensor(np.asarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1)


def _views(seed, n=4, size=32):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(
        np.float32)


def _tiny_params(seed=4):
    """The tiny LGM's flax params, every leaf redrawn from a seed."""
    cfg = jm.LGMConfig(**TINY)
    return _params(jm.LGMUNet(cfg), jnp.zeros((4, 32, 32, 9)), seed=seed)


def _port_lgm(params):
    return LGMPipeline(_load(tm.LGMUNet(LGMConfig(**TINY)),
                             convert.lgm_state_dict_from_flax(params)))


def _block_sd(p):
    """One block's flax params → its port state dict, through the LGM
    converter's renames."""
    sd = convert._renamed_state_dict({"x": p}, convert._LGM_RENAMES)
    return {k[2:]: v for k, v in sd.items()}


def test_blocks_match_jax():
    """LGMResnet with and without its 1×1 shortcut, and MVAttention over
    the four views of each of two samples (≤ 1e-4 of the max)."""
    rng = np.random.RandomState(1)
    x = rng.randn(8, 8, 8, 16).astype(np.float32)
    ss = math.sqrt(0.5)
    cases = (
        (jm.LGMResnet(32, groups=4, skip_scale=ss),
         tm.LGMResnet(16, 32, groups=4, skip_scale=ss)),
        (jm.LGMResnet(16, groups=4, skip_scale=ss),
         tm.LGMResnet(16, 16, groups=4, skip_scale=ss)),
        (jm.MVAttention(16, 4, 4, 4, ss), tm.MVAttention(16, 4, 4, 4, ss)))
    for i, (jmod, tmod) in enumerate(cases):
        p = _params(jmod, jnp.asarray(x), seed=10 + i)
        ref = jax.jit(jmod.apply, compiler_options=QUICK_XLA)(
            {"params": p}, x)
        _load(tmod, _block_sd(p))
        with torch.no_grad():
            out = tmod(nchw(x))
        _close(nhwc(out), ref, what=f"block {i}")


def test_unet_matches_jax():
    """Four 32² views of 9 channels → four 16² maps of 14 (≤ 1e-4 of the
    max)."""
    params = _tiny_params()
    x = np.random.RandomState(2).randn(4, 32, 32, 9).astype(np.float32)
    jmod = jm.LGMUNet(jm.LGMConfig(**TINY))
    ref = jax.jit(jmod.apply, compiler_options=QUICK_XLA)(
        {"params": params}, x)
    pipe = _port_lgm(params)
    with torch.no_grad():
        out = pipe.model(nchw(x))
    assert tuple(out.shape) == (4, 14, 16, 16)
    _close(nhwc(out), ref)


def test_plucker_rays_and_decode_gaussians_match_jax():
    """The rays of four orbit cameras (two elevations), and the activations
    on raw values wide enough to clamp the positions and to saturate the
    sigmoid, softplus and tanh."""
    cfg, jcfg = LGMConfig(**TINY), jm.LGMConfig(**TINY)
    elev, azim = [0.0, 20.0, -10.0, 0.0], [0.0, 90.0, 180.0, 270.0]
    raw = (np.random.RandomState(3).randn(300, 14) * 4).astype(np.float32)
    j_rays, ref = jax.jit(lambda r: (jm.plucker_rays(jcfg, elev, azim),
                                     jm.decode_gaussians(r)),
                          compiler_options=QUICK_XLA)(raw)
    rays = tm.plucker_rays(cfg, elev, azim, device="cpu")
    assert tuple(rays.shape) == (4, 32, 32, 6)
    _close(rays, j_rays, what="rays")
    out = tm.decode_gaussians(torch.as_tensor(raw))
    assert (np.abs(raw[:, :3]) > 1).any()
    for k in ("xyz", "opacity", "scale", "rotation", "rgb"):
        _close(out[k], ref[k], what=k)


def test_forward_gaussians_matches_jax():
    """Four views → 4·16² splats in the JAX package's order (view-major,
    then row-major over each splat map), every field within 1e-4 of its
    largest value, all alive; views of 48² are resized to 32² first, as
    `jax.image.resize(..., "bilinear")` does."""
    params = _tiny_params()
    jref = jax.jit(lambda p, v: JLGMPipeline(
        p, jm.LGMConfig(**TINY)).forward_gaussians(v),
        compiler_options=QUICK_XLA)
    pipe = _port_lgm(params)
    for size in (32, 48):
        views = _views(5 + size, size=size)
        ref = jref(params, views)
        out = pipe.forward_gaussians(views)
        assert out.num_capacity == 4 * 16 * 16 and bool(out.alive.all())
        for f in SPLAT_FIELDS:
            _close(getattr(out, f), getattr(ref, f), what=f"{size} {f}")
    # the order: splat 16·3 + 5 of view 2 is raw pixel (3, 5) of its map
    with torch.no_grad():
        x = torch.cat([nchw(views := _views(7)), tm.plucker_rays(
            pipe.cfg, [0.0] * 4, [0.0, 90.0, 180.0, 270.0],
            device="cpu").permute(0, 3, 1, 2)], 1)
        raw = pipe.model(x)
    out = pipe.forward_gaussians(views)
    np.testing.assert_allclose(
        _np(out.xyz[2 * 256 + 16 * 3 + 5]),
        _np(raw[2, 0:3, 3, 5].clamp(-1, 1)), rtol=0, atol=1e-6)


def test_state_dict_round_trip_and_parameter_count():
    """flax params → the port's state dict → the JAX package's own
    `convert_lgm` (`lgm_rules`, which reads LGM's checkpoint names) → the
    same params leaf for leaf; the full config's parameter count equals the
    JAX package's (`jax.eval_shape`), 412,958,240; a seed gives the same
    weights every time."""
    params = _tiny_params()
    model = _port_lgm(params).model
    sd = model.state_dict()
    assert "unet.down_blocks.2.attns.0.attn.qkv.weight" in sd
    assert "unet.up_blocks.0.upsample.weight" in sd and "conv.bias" in sd
    tree = convert_lgm({k: v.numpy() for k, v in sd.items()})
    flat = jax.tree_util.tree_leaves_with_path(params)
    back = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(back) == len(flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(back[path], leaf,
                                      err_msg=jax.tree_util.keystr(path))

    shapes = jax.eval_shape(jm.LGMUNet(jm.LGMConfig()).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((4, 256, 256, 9)))["params"]
    n_jax = sum(math.prod(a.shape) for a in jax.tree.leaves(shapes))
    with torch.device("meta"):
        n_port = sum(p.numel() for p in tm.LGMUNet(LGMConfig()).parameters())
    assert n_port == n_jax == 412_958_240
    assert dataclasses.asdict(LGMConfig()) == dataclasses.asdict(
        jm.LGMConfig())

    key = "unet.mid_block.attns.0.attn.qkv.weight"
    a, b, c = (LGMPipeline.init_random(s, LGMConfig(**TINY), device="cpu")
               .model.state_dict()[key] for s in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_entry_points_default_to_the_card():
    """Without a `device`, the pipeline and the ray embedding go to the
    card; there is no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError)):
        LGMPipeline.init_random(0, LGMConfig(**TINY))
    with pytest.raises((AssertionError, RuntimeError)):
        tm.plucker_rays(LGMConfig(**TINY), [0.0], [0.0])
