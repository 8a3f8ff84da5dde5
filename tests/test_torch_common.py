"""Port parity, `models/common.py` blocks (attention, GEGLU, feed-forward)
and TripoSR's `grid_sample_2d`, `comfy3d_tpu_torch` against `comfy3d_tpu`
on the same numpy inputs and weights (flax params carried across by the
per-block functions of `convert`)."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.models import common as jc
from comfy3d_tpu.models.triposr.model import grid_sample_2d as j_grid_sample

from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.models import common as tc
from comfy3d_tpu_torch.models.triposr.model import grid_sample_2d


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# `jax.jit(..., compiler_options=QUICK_XLA)`: XLA:CPU compiles a reference
# held within a tolerance in about half the time; references held element
# for element keep the default options, whose fused arithmetic they match
QUICK_XLA = {"xla_backend_optimization_level": 0,
             "xla_llvm_disable_expensive_passes": True}


def quick_jax():
    """The `jax` module with `jit` compiling under `QUICK_XLA`: patched in
    for a JAX package module's own `jax` (`monkeypatch.setattr(module,
    "jax", quick_jax())`), its jitted reference compiles in about half the
    time."""
    import types
    quick = types.SimpleNamespace(**{k: getattr(jax, k) for k in dir(jax)
                                     if not k.startswith("__")})
    quick.jit = lambda f=None, **kw: (
        jax.jit(f, compiler_options=QUICK_XLA, **kw) if f is not None
        else (lambda g: jax.jit(g, compiler_options=QUICK_XLA, **kw)))
    return quick


def quick_jax_pipeline(jpipe, sample_static):
    """A JAX latent-set pipeline (TripoSG, PartCrafter, Craftsman) with its
    `_sample` (static argnums `sample_static`), `encode_cond` and VAE
    decode as `QUICK_XLA` jits on the instance, so its own calls and the
    JAX nodes' share one compile each: eager, they compile every op on its
    own (seconds each at tiny widths). The VAE's other methods (the query,
    traced inside the decode's `lax.map`) stay as they are."""
    import types
    fn = jax.jit(type(jpipe)._sample.__wrapped__,
                 static_argnums=sample_static, compiler_options=QUICK_XLA)
    jpipe._sample = lambda *a: fn(jpipe, *a)
    jpipe.encode_cond = jax.jit(jpipe.encode_cond, compiler_options=QUICK_XLA)
    vae = jpipe.vae
    decode = jax.jit(vae.apply, compiler_options=QUICK_XLA)
    jpipe.vae = types.SimpleNamespace(apply=lambda *a, method=None, **kw: (
        decode(*a, **kw) if method is None
        else vae.apply(*a, method=method, **kw)))
    return jpipe


@functools.lru_cache(maxsize=None)
def _orbit_jit(static):
    from comfy3d_tpu.core.camera import Camera
    return jax.jit(functools.partial(Camera.from_orbit, **dict(static)),
                   compiler_options=QUICK_XLA)


def jax_orbit_camera(elevation_deg, azimuth_deg, radius, **kw):
    """The JAX package's `Camera.from_orbit` as one `QUICK_XLA` jit for
    each width, height, near and far: eager, it compiles each op on its
    own (about 1 s for each new shape). Its matrices agree with the eager
    call's to 1 ulp."""
    static = tuple(sorted((k, kw.pop(k)) for k in
                          ("width", "height", "near", "far") if k in kw))
    return _orbit_jit(static)(elevation_deg, azimuth_deg, radius, **kw)


def quick_jax_renderers(monkeypatch):
    """The JAX renderer nodes' `mesh_render.render_mesh` and
    `gs_render.render` as single `QUICK_XLA` jits: their eager calls
    compile every op on its own."""
    import types

    from comfy3d_tpu.nodes import nodes_render as jnr
    from comfy3d_tpu.ops import gs_render as jgs
    from comfy3d_tpu.ops import mesh_render as jmr
    jit = functools.partial(jax.jit, compiler_options=QUICK_XLA)
    monkeypatch.setattr(jnr, "mesh_render", types.SimpleNamespace(
        render_mesh=jit(jmr.render_mesh, static_argnames=("method",
                                                          "ssaa"))))
    monkeypatch.setattr(jnr, "gs_render", types.SimpleNamespace(
        render=jit(jgs.render, static_argnames=("background", "backend"))))


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread for a module's tests, then as before:
    at these tiny shapes a thread pool buys nothing, and while the suite's
    other workers load every core its waits multiply a test's time (the
    brute-force raster test 0.8 → 6.2 s with six busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize(params, seed):
    """Every leaf of a flax param tree redrawn from a seed (the zeros and
    ones of a fresh init would leave biases, norms, position grids and cls
    tokens untested), at the scales of a trained model: kernels with std
    1/sqrt(fan_in), norm scales about 1, the rest with std 0.3."""
    rng = np.random.RandomState(seed)

    def draw(path, a):
        name = getattr(path[-1], "key", "")
        n = rng.randn(*a.shape)
        if name == "kernel":
            n = n / np.sqrt(np.prod(a.shape[:-1]))
        elif name == "scale":
            n = 1.0 + 0.1 * n
        else:
            n = 0.3 * n
        return n.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def _load(module, sd):
    module.load_state_dict({k: torch.as_tensor(np.array(v, np.float32))
                            for k, v in sd.items()}, strict=True)
    return module.eval()


def _block_case(name):
    """(flax module, its inputs, port module, flax params → state dict)."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 32).astype(np.float32)
    ctx = rng.randn(2, 5, 24).astype(np.float32)
    mask = rng.rand(2, 5) > 0.3
    cases = {
        "attention_self": (jc.Attention(32, heads=4, dim_head=8), (x,),
                           tc.Attention(32, heads=4, dim_head=8),
                           convert.attention_state_dict_from_flax),
        "attention_cross_masked": (
            jc.Attention(32, heads=4, dim_head=8, cross_attention_dim=24),
            (x, ctx, mask),
            tc.Attention(32, heads=4, dim_head=8, cross_attention_dim=24),
            convert.attention_state_dict_from_flax),
        "geglu": (jc.GEGLU(16), (x,), tc.GEGLU(32, 16),
                  lambda p: convert._join("proj", convert._dense(p["proj"]))),
        "feedforward": (jc.FeedForward(32), (x,), tc.FeedForward(32),
                        convert.feedforward_state_dict_from_flax),
        "basic_block": (jc.BasicTransformerBlock(32, 4, 8,
                                                 cross_attention_dim=24),
                        (x, ctx), tc.BasicTransformerBlock(
                            32, 4, 8, cross_attention_dim=24),
                        convert.basic_block_state_dict_from_flax),
        "transformer1d": (jc.Transformer1D(64, 2, 4, 16,
                                           cross_attention_dim=24),
                          (rng.randn(2, 64, 9).astype(np.float32), ctx),
                          tc.Transformer1D(64, 2, 4, 16,
                                           cross_attention_dim=24),
                          convert.transformer1d_state_dict_from_flax),
        "vit_self_attention": (jc.ViTSelfAttention(32, 4), (x,),
                               tc.ViTSelfAttention(32, 4),
                               convert.vit_self_attention_state_dict_from_flax),
        "vit_block": (jc.ViTBlock(32, 4, 64), (x,), tc.ViTBlock(32, 4, 64),
                      convert.vit_block_state_dict_from_flax),
    }
    return cases[name]


def _params(jmod, *args, method=None, seed=2):
    """Redrawn params of a flax module, its tree built by shape alone."""
    shapes = jax.eval_shape(functools.partial(jmod.init, method=method),
                            jax.random.PRNGKey(0), *args)["params"]
    return _randomize(shapes, seed)


@pytest.mark.parametrize("name", [
    "attention_self", "attention_cross_masked", "geglu", "feedforward"])
def test_common_block_matches_jax(name):
    jmod, args, tmod, to_sd = _block_case(name)
    params = _params(jmod, *map(jnp.asarray, args))
    ref = jax.jit(jmod.apply)({"params": params}, *map(jnp.asarray, args))
    _load(tmod, to_sd(params))
    with torch.no_grad():
        out = tmod(*map(torch.as_tensor, args))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5, rtol=0)


def test_grid_sample_2d_matches_jax():
    rng = np.random.RandomState(5)
    plane = rng.randn(6, 7, 4).astype(np.float32)          # [H, W, C]
    uv = (rng.rand(3, 50, 2) * 2.6 - 1.3).astype(np.float32)
    uv[0, :4] = [[-1, -1], [1, 1], [-1.05, 0.2], [0.3, 1.2]]
    ref = j_grid_sample(jnp.asarray(plane), jnp.asarray(uv))
    out = grid_sample_2d(torch.as_tensor(plane).permute(2, 0, 1),
                         torch.as_tensor(uv))
    assert tuple(out.shape) == (3, 50, 4)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5, rtol=0)
    outside = (np.abs(uv) > 1 + 1.0 / 6).any(-1)            # wholly outside
    assert outside.any() and np.abs(_np(out)[outside]).max() == 0.0
