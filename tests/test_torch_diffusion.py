"""Port parity, the diffusion substrate: `timestep_embedding`, the UNet's
resnet and spatial transformer (MVDream's view fold, both head
conventions), `UNet2DCondition` with a class embedding, the VAE's encode
and decode, DDIM and its loop, and the state dicts in diffusers' layout,
`comfy3d_tpu_torch` against `comfy3d_tpu` on the same numpy inputs and
weights (flax params carried across by `convert.unet_state_dict_from_flax`
and `convert.vae_state_dict_from_flax`)."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.models.convert import convert_with_rules
from comfy3d_tpu.models.diffusion import schedulers as js
from comfy3d_tpu.models.diffusion import unet as ju
from comfy3d_tpu.models.diffusion import vae as jv
from comfy3d_tpu.models.diffusion.convert import unet_rules, vae_rules

from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.models.diffusion import schedulers as ts
from comfy3d_tpu_torch.models.diffusion import unet as tu
from comfy3d_tpu_torch.models.diffusion import vae as tv

from tests.test_diffusion import tiny_unet_cfg, tiny_vae_cfg
from tests.test_torch_common import (QUICK_XLA, _load, _np, _params,
                                     one_torch_thread)  # noqa: F401

# outputs against the JAX package: within this share of their largest value
REL = 1e-4


def _close(out, ref, rel=REL, what=""):
    out, ref = _np(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())


def nchw(a):
    return torch.as_tensor(np.asarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1)


def port_unet_cfg(jcfg):
    return tu.UNetConfig(**dataclasses.asdict(jcfg))


def test_timestep_embedding_and_resnet_match_jax():
    t = np.array([0, 1, 37, 500, 999], np.float32)
    _close(tu.timestep_embedding(torch.as_tensor(t), 32),
           ju.timestep_embedding(jnp.asarray(t), 32), what="temb")

    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 8).astype(np.float32)
    temb = rng.randn(2, 32).astype(np.float32)
    for out_ch in (16, 8):                     # with and without the 1×1
        jmod = ju.ResnetBlock(out_ch, norm_groups=4)
        p = _params(jmod, jnp.asarray(x), jnp.asarray(temb), seed=out_ch)
        ref = jax.jit(jmod.apply, compiler_options=QUICK_XLA)(
            {"params": p}, x, temb)
        port = _load(tu.ResnetBlock(8, out_ch, 32, 4),
                     convert.unet_state_dict_from_flax(p))
        with torch.no_grad():
            out = port(nchw(x), torch.as_tensor(temb))
        _close(nhwc(out), ref, what=f"resnet {out_ch}")


def test_spatial_transformer_matches_jax():
    """MVDream's fold at 1 and 4 views (the fold's context is its first
    view's: every frame gets its own here), under both head conventions
    (64 channels as 16 heads of 4, and as 2 heads of 32)."""
    rng = np.random.RandomState(1)
    x = rng.randn(8, 4, 4, 64).astype(np.float32)
    ctx = rng.randn(8, 5, 12).astype(np.float32)
    cases = [(v, hd) for v in (1, 4) for hd in (4, -2)]

    def heads(hd):
        return (64 // hd, hd) if hd > 0 else (-hd, 64 // -hd)

    def mods(v, hd):
        return ju.SpatialTransformer(64, *heads(hd), 12, norm_groups=4,
                                     mv_views=v)

    # the four cases share one param tree (heads · dim_head = 64 in both)
    p = _params(mods(1, 4), jnp.asarray(x), jnp.asarray(ctx), seed=3)

    @functools.partial(jax.jit, compiler_options=QUICK_XLA)
    def refs(p, x, ctx):
        return [mods(v, hd).apply({"params": p}, x, ctx)[0]
                for v, hd in cases]

    sd = convert.unet_state_dict_from_flax(p)
    for (v, hd), ref in zip(cases, refs(p, x, ctx)):
        port = _load(tu.SpatialTransformer(64, *heads(hd), 12, norm_groups=4),
                     sd)
        with torch.no_grad():
            out = port(nchw(x), torch.as_tensor(ctx), mv_views=v)
        _close(nhwc(out), ref, what=f"views {v}, head dim {hd}")


def test_unet_with_class_emb_matches_jax():
    """The tiny UNet with a class embedding, at its config's one view and
    with `mv_views=2` per call."""
    jcfg = tiny_unet_cfg()
    rng = np.random.RandomState(2)
    sample = rng.randn(4, 16, 16, 4).astype(np.float32)
    t = np.array([999, 500, 10, 0], np.float32)
    ctx = rng.randn(4, 7, 16).astype(np.float32)
    cemb = rng.randn(4, 32).astype(np.float32)
    jmod = ju.UNet2DCondition(jcfg)
    args = tuple(map(jnp.asarray, (sample, t, ctx)))
    p = _params(jmod, *args, seed=4, method=lambda m, *a: m(
        *a, class_emb=jnp.asarray(cemb)))

    @functools.partial(jax.jit, compiler_options=QUICK_XLA)
    def refs(p):
        return [jmod.apply({"params": p}, *args, class_emb=cemb,
                           mv_views=v)[0] for v in (None, 2)]

    port = _load(tu.UNet2DCondition(port_unet_cfg(jcfg)),
                 convert.unet_state_dict_from_flax(p))
    for v, ref in zip((None, 2), refs(p)):
        with torch.no_grad():
            out = port(nchw(sample), torch.as_tensor(t), torch.as_tensor(ctx),
                       class_emb=torch.as_tensor(cemb), mv_views=v)
        _close(nhwc(out), ref, what=f"mv_views {v}")


def test_vae_encode_and_decode_match_jax():
    jcfg = tiny_vae_cfg()
    rng = np.random.RandomState(3)
    images = (rng.rand(2, 16, 16, 3) * 2 - 1).astype(np.float32)
    lat = rng.randn(2, 8, 8, 4).astype(np.float32)
    jmod = jv.AutoencoderKL(jcfg)
    p = _params(jmod, jnp.asarray(images), seed=5)

    @functools.partial(jax.jit, compiler_options=QUICK_XLA)
    def refs(p):
        return (jmod.apply({"params": p}, images, method=jmod.encode),
                jmod.apply({"params": p}, lat, method=jmod.decode))

    enc, dec = refs(p)
    port = _load(tv.AutoencoderKL(tv.VAEConfig(**dataclasses.asdict(jcfg))),
                 convert.vae_state_dict_from_flax(p))
    with torch.no_grad():
        _close(nhwc(port.encode(nchw(images))), enc, what="encode")
        _close(nhwc(port.decode(nchw(lat))), dec, what="decode")


def test_ddim_and_its_loop_match_jax():
    """Timesteps and ᾱ equal element for element (also the linear and
    shifted-SNR schedules); a step and a 5-step loop driven by a fixed
    linear `denoise_fn`, for ε-prediction with leading spacing and
    v-prediction with trailing spacing; `make_scheduler` makes the JAX
    package's class for every name, None and an unknown one included."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 4, 6, 6).astype(np.float32)
    out = rng.randn(2, 4, 6, 6).astype(np.float32)
    for kw in (dict(), dict(prediction_type="v_prediction",
                            timestep_spacing="trailing")):
        jsched = js.DDIM(js.SchedulerConfig(**kw), 5)
        sched = ts.DDIM(ts.SchedulerConfig(**kw), 5)
        np.testing.assert_array_equal(sched.timesteps,
                                      np.asarray(jsched.timesteps))
        np.testing.assert_array_equal(_np(sched.alphas),
                                      np.asarray(jsched.alphas))
        for i in (0, 4):
            _close(sched.step(torch.as_tensor(out), i, torch.as_tensor(x)),
                   jsched.step(jnp.asarray(out), i, jnp.asarray(x)),
                   what=f"{kw} step {i}")

        def denoise(x_in, i, t):
            return 0.1 * x_in + 0.05 * i + 1e-4 * t

        ref = jax.jit(lambda x: js.sample_loop(jsched, denoise, x),
                      compiler_options=QUICK_XLA)(x)
        _close(ts.sample_loop(sched, denoise, torch.as_tensor(x)), ref,
               what=f"{kw} loop")
    shifted = dict(beta_schedule="linear", snr_shift_scale=8.0)
    np.testing.assert_array_equal(
        ts.make_alphas(ts.SchedulerConfig(**shifted)),
        js.make_alphas(js.SchedulerConfig(**shifted)))
    assert isinstance(ts.make_scheduler("DDIMScheduler,", num_steps=3),
                      ts.DDIM)
    for name in (None, "", "EulerAncestralDiscreteScheduler",
                 "LCMScheduler", "KDPM2DiscreteScheduler,",
                 "NoSuchScheduler"):
        assert type(ts.make_scheduler(name)).__name__ \
            == type(js.make_scheduler(name)).__name__, name
    assert type(ts.make_scheduler(None)) is ts.EulerAncestral


def test_state_dicts_round_trip_through_the_jax_converters():
    """flax params → the port's state dicts → the JAX package's own
    `unet_rules` and `vae_rules`, which read diffusers' names, → the same
    params leaf for leaf."""
    ujcfg = tiny_unet_cfg()
    unet_p = _params(ju.UNet2DCondition(ujcfg), jnp.zeros((1, 16, 16, 4)),
                     jnp.zeros((1,)), jnp.zeros((1, 7, 16)), seed=6)
    vjcfg = tiny_vae_cfg()
    vae_p = _params(jv.AutoencoderKL(vjcfg), jnp.zeros((1, 16, 16, 3)),
                    seed=7)
    for model, params, to_sd, rules in (
            (tu.UNet2DCondition(port_unet_cfg(ujcfg)), unet_p,
             convert.unet_state_dict_from_flax, unet_rules()),
            (tv.AutoencoderKL(tv.VAEConfig(**dataclasses.asdict(vjcfg))),
             vae_p, convert.vae_state_dict_from_flax, vae_rules())):
        _load(model, to_sd(params))
        tree = convert_with_rules(model.state_dict(), rules)
        flat = jax.tree_util.tree_leaves_with_path(params)
        back = dict(jax.tree_util.tree_leaves_with_path(tree))
        assert len(back) == len(flat)
        for path, leaf in flat:
            np.testing.assert_array_equal(back[path], leaf,
                                          err_msg=jax.tree_util.keystr(path))
    sd = tu.UNet2DCondition(port_unet_cfg(ujcfg)).state_dict()
    assert "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj" \
        ".weight" in sd and "up_blocks.0.upsamplers.0.conv.bias" in sd


def test_other_families_options_raise():
    """Config fields and call arguments of the UNet families the port does
    not carry raise, naming their ROADMAP item; Hunyuan paint's 2.5D
    attentions (`use_ma`, `use_ra`, their scales) and ImageDream's IP
    projections (`ip_dim`) build."""
    base = tiny_unet_cfg()
    for field, val in (("cd_joint", True), ("mv_rowwise", True),
                       ("mv_decoupled", True),
                       ("addition_embed_type", "text_time"),
                       ("transformer_depth", (1, 2))):
        with pytest.raises(NotImplementedError, match="ROADMAP A.6"):
            tu.UNet2DCondition(port_unet_cfg(
                dataclasses.replace(base, **{field: val})))
    tu.UNet2DCondition(port_unet_cfg(dataclasses.replace(
        base, use_ma=True, use_ra=True, mva_scale=0.5, ref_scale=0.5)))
    ip = tu.UNet2DCondition(port_unet_cfg(dataclasses.replace(base,
                                                              ip_dim=4)))
    assert "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k_ip" \
        ".weight" in ip.state_dict()
    model = tu.UNet2DCondition(port_unet_cfg(base))
    args = (torch.zeros(1, 4, 8, 8), torch.zeros(1), torch.zeros(1, 7, 16))
    for kw in (dict(down_residuals=[]), dict(mid_residual=args[0]),
               dict(pose_hook=len)):
        with pytest.raises(NotImplementedError, match="ROADMAP A.6"):
            model(*args, **kw)
