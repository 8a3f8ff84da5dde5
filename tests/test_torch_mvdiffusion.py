"""Port parity, Wonder3D and Era3D: the UNet's cross-domain joint attention
on a multi-view fold, Era3D's row-wise blocks with the pose hook, both
pipelines end to end, both `from_pretrained` on directories the tests
write, and the Wonder3D nodes through `run_workflow`, `comfy3d_tpu_torch`
against `comfy3d_tpu` on the same numpy inputs and weights (flax params
carried across by `convert.{wonder3d,era3d}_state_dict_from_flax`).

Wonder3D's port pairs each normal frame with its colour frame within each
classifier-free-guidance half, as upstream does, where the JAX pipeline
pairs it with its unconditional twin (ROADMAP §C.9): its reference here is
the JAX package's UNet, VAE, CLIP, camera MLP and sampler composed with
upstream's batch, the UNet called on one half at a time, where both
packages agree. The JAX pipelines run with `vae_scaling=1.0` (§C.8). The
JAX params are built by shape (`jax.eval_shape`) and redrawn from numpy;
the references are computed in a few jitted calls (`QUICK_XLA`)."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import diffusers_fixture as fx
from comfy3d_tpu.models import clip as jclip
from comfy3d_tpu.models.diffusion import schedulers as jsched
from comfy3d_tpu.models.diffusion.unet import UNet2DCondition as JUNet
from comfy3d_tpu.models.diffusion.vae import AutoencoderKL as JVAE
from comfy3d_tpu.models.era3d import pipeline as je
from comfy3d_tpu.models.wonder3d import pipeline as jw

from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.models import clip
from comfy3d_tpu_torch.models.diffusion.schedulers import SchedulerConfig
from comfy3d_tpu_torch.models.diffusion.unet import UNetConfig
from comfy3d_tpu_torch.models.diffusion.vae import VAEConfig
from comfy3d_tpu_torch.models.era3d import pipeline as te
from comfy3d_tpu_torch.models.wonder3d import pipeline as tw

from tests.test_diffusion import tiny_unet_cfg, tiny_vae_cfg
from tests.test_torch_clip_text import _assert_state_dict
from tests.test_torch_common import (QUICK_XLA, _load, _np, _randomize,
                                     one_torch_thread)  # noqa: F401

# outputs against the JAX package: within this share of their largest value
REL = 1e-4
V, S, LAT = 6, 16, 8
TINY_CLIP = dict(hidden=8, layers=2, heads=2, mlp_dim=16, image_size=28,
                 patch=14, projection_dim=16, act="gelu")


def _close(out, ref, rel=REL, what=""):
    out, ref = _np(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())


def w3d_cfg():
    """A tiny Wonder3D: six 16² views from 8² latents, an SD-1.5-style
    UNet (a head count, `attention_head_dim` < 0) over the 6-view fold."""
    unet = dataclasses.replace(tiny_unet_cfg(), in_channels=8, mv_views=V,
                               cd_joint=True, attention_head_dim=-2)
    return jw.Wonder3DConfig(image_size=S, num_views=V, prompt_dim=16,
                             unet=unet, vae=tiny_vae_cfg(), vae_scaling=1.0)


def era3d_cfg(**kw):
    """A tiny Era3D: row-wise blocks with joint attention, 7 prompt tokens
    of 16, a 16-wide unCLIP embedding noised at level 50, one residual
    block per pose regressor."""
    unet = dataclasses.replace(tiny_unet_cfg(), in_channels=8, mv_views=V,
                               mv_rowwise=True, cd_joint=True)
    return je.Era3DConfig(**{**dict(
        image_size=S, num_views=V, prompt_tokens=7, prompt_dim=16, unet=unet,
        vae=tiny_vae_cfg(), clip_embed_dim=16, regress_blocks=1,
        noise_level=50), **kw})


def port_cfg(jcfg, cls):
    """The port's config of the JAX one's fields (`vae_scaling` dropped)."""
    sub = {"unet": UNetConfig, "vae": VAEConfig, "scheduler": SchedulerConfig}
    kw = {}
    for f in dataclasses.fields(cls):
        val = getattr(jcfg, f.name)
        kw[f.name] = (sub[f.name](**dataclasses.asdict(val))
                      if f.name in sub else val)
    return cls(**kw)


def _shapes(jcfg, frames, tokens):
    lat = jcfg.image_size // 2 ** (len(jcfg.vae.block_out_channels) - 1)
    td = jcfg.unet.block_out_channels[0] * 4
    z, key = jnp.zeros, jax.random.PRNGKey(0)
    return td, {
        "unet": jax.eval_shape(
            JUNet(jcfg.unet).init, key,
            z((frames, lat, lat, jcfg.unet.in_channels)), z((frames,)),
            z((frames, tokens, jcfg.prompt_dim)),
            class_emb=z((frames, td)))["params"],
        "vae": jax.eval_shape(JVAE(jcfg.vae).init, key,
                              z((1, 64, 64, 3)))["params"]}


def w3d_params(jcfg, seed):
    """The tiny Wonder3D's flax params `{"unet", "vae", "class_mlp"}` by
    shape, every leaf from `seed`."""
    td, shapes = _shapes(jcfg, 2 * jcfg.num_views, 1)
    shapes["class_mlp"] = jax.eval_shape(
        jw._ClassEmbedMLP(td).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 10)))["params"]
    return _randomize(shapes, seed)


def era3d_params(jcfg, seed):
    """The tiny Era3D's flax params (with both regressors) by shape."""
    td, shapes = _shapes(jcfg, 4 * jcfg.num_views, jcfg.prompt_tokens)
    key = jax.random.PRNGKey(0)
    mlp = je.TimestepEmbedMLP(td)
    reg = je.ResidualLiner(1, 1280, jcfg.regress_blocks)
    mid = 2 * jcfg.unet.block_out_channels[-1]
    shapes.update(
        class_mlp=jax.eval_shape(mlp.init, key, jnp.zeros(
            (1, 2 * jcfg.clip_embed_dim)))["params"],
        camera_mlp=jax.eval_shape(mlp.init, key, jnp.zeros((1, 4)))["params"],
        elevation_reg=jax.eval_shape(reg.init, key,
                                     jnp.zeros((1, mid)))["params"],
        focal_reg=jax.eval_shape(reg.init, key, jnp.zeros((1, mid)))["params"])
    return _randomize(shapes, seed)


def clip_params(seed):
    cfg = jclip.CLIPVisionConfig(**TINY_CLIP)
    shapes = jax.eval_shape(jclip.CLIPVisionEncoder(cfg).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 28, 28, 3)))["params"]
    return cfg, _randomize(shapes, seed)


def port_vision(vparams):
    enc = clip.CLIPVisionEncoder(clip.CLIPVisionConfig(**TINY_CLIP))
    return clip.make_vision_conditioner(_load(
        enc, convert.clip_vision_state_dict_from_flax(vparams)))


def port_w3d(jcfg, params, vparams=None):
    pipe = tw.Wonder3DPipeline(_load(
        tw.Wonder3D(port_cfg(jcfg, tw.Wonder3DConfig)),
        convert.wonder3d_state_dict_from_flax(params)))
    if vparams is not None:
        pipe.set_vision_encoder(port_vision(vparams))
    return pipe


def era3d_extras(jcfg, seed):
    """Random per-view prompt embeddings and unCLIP normaliser statistics."""
    rng = np.random.RandomState(seed)
    return dict(
        prompt=rng.randn(2 * jcfg.num_views, jcfg.prompt_tokens,
                         jcfg.prompt_dim).astype(np.float32),
        mean=rng.randn(jcfg.clip_embed_dim).astype(np.float32),
        std=(1.0 + rng.rand(jcfg.clip_embed_dim)).astype(np.float32))


def port_era3d(jcfg, params, vparams, extras):
    pipe = te.Era3DPipeline(_load(te.Era3D(port_cfg(jcfg, te.Era3DConfig)),
                                  convert.era3d_state_dict_from_flax(params)))
    pipe.set_vision_encoder(port_vision(vparams))
    pipe.set_prompt_embeds(extras["prompt"])
    pipe.normalizer_mean = torch.as_tensor(extras["mean"])
    pipe.normalizer_std = torch.as_tensor(extras["std"])
    return pipe


def jax_era3d(jcfg, params, vparams, vcfg, extras):
    pipe = je.Era3DPipeline(params, jcfg)
    pipe.set_vision_encoder(jclip.make_vision_conditioner(vparams, vcfg))
    pipe.set_prompt_embeds(extras["prompt"])
    pipe.normalizer_mean, pipe.normalizer_std = extras["mean"], extras["std"]
    return pipe


def era3d_draws(jcfg, seed, vision=True):
    """The JAX Era3D pipeline's noise for `seed` (`PRNGKey(seed)` split for
    the unCLIP noise, then for the latents), NCHW for the port."""
    key = jax.random.PRNGKey(seed)
    out = {}
    if vision:
        key, k = jax.random.split(key)
        out["image_embeds"] = torch.as_tensor(np.array(jax.random.normal(
            k, (1, jcfg.clip_embed_dim))))
    key, k = jax.random.split(key)
    lat = jcfg.image_size // 2 ** (len(jcfg.vae.block_out_channels) - 1)
    out["latents"] = torch.as_tensor(np.array(jax.random.normal(
        k, (2 * jcfg.num_views, lat, lat, 4)))).permute(0, 3, 1, 2)
    return out


def w3d_reference(jcfg, params, vparams, vcfg, image, noise, steps, g):
    """The Wonder3D sampler of the JAX package's modules with upstream's
    batch, [uncond normals, cond normals, uncond colours, cond colours]
    (the UNet pairs frame j with frame j + 2V: each normal frame with its
    colour frame), g-guided → (colours, normals) [V, S, S, 3]."""
    v, s = jcfg.num_views, jcfg.image_size
    pipe = jw.Wonder3DPipeline(params, jcfg)
    img = jax.image.resize(jnp.asarray(image)[None], (1, s, s, 3), "bilinear")
    emb = jclip.make_vision_conditioner(vparams, vcfg)(img)
    vae = JVAE(jcfg.vae)
    lat = vae.apply({"params": params["vae"]}, img * 2.0 - 1.0,
                    method=JVAE.encode)
    ce = pipe._camera_class_emb(2 * v)
    ce = jnp.concatenate([ce[:v], ce[:v], ce[v:], ce[v:]])
    zl = jnp.zeros((v,) + lat.shape[1:])
    lat4 = jnp.concatenate([zl, zl + lat, zl, zl + lat])
    emb4 = jnp.concatenate([jnp.zeros((v, 1, emb.shape[-1])),
                            jnp.broadcast_to(emb[:, None],
                                             (v, 1, emb.shape[-1]))] * 2)
    sched = jsched.make_scheduler("DDIMScheduler", jcfg.scheduler, steps)

    def fn(x, i, t):
        n, c = jnp.split(x, 2)
        x4 = jnp.concatenate([jnp.concatenate([n, n, c, c]), lat4], -1)
        eps = pipe.unet.apply({"params": params["unet"]}, x4,
                              jnp.broadcast_to(t, (4 * v,)), emb4,
                              class_emb=ce)[0]
        un_n, co_n, un_c, co_c = jnp.split(eps, 4)
        un = jnp.concatenate([un_n, un_c])
        return un + g * (jnp.concatenate([co_n, co_c]) - un)

    out = jsched.sample_loop(sched, fn, noise * sched.init_sigma)
    imgs = jnp.clip(vae.apply({"params": params["vae"]}, out,
                              method=JVAE.decode) * 0.5 + 0.5, 0.0, 1.0)
    return imgs[v:], imgs[:v]


def nchw(a):
    return torch.as_tensor(np.asarray(a)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def case():
    """Both tiny families' params and inputs, and every JAX reference in
    one jitted call: the Wonder3D UNet on the JAX pipeline's batch, Era3D's
    UNet with its pose hook on the [u_n, c_n, u_c,
    c_c] batch and the Wonder3D sampler with upstream's batch (two DDIM
    steps under CFG 2). The Era3D pipeline is held end to end through its
    node in `test_torch_diff_mesh.py`'s graph."""
    rng = np.random.RandomState(0)
    wcfg, ecfg = w3d_cfg(), era3d_cfg()
    wp, ep = w3d_params(wcfg, 1), era3d_params(ecfg, 2)
    vcfg, vparams = clip_params(3)
    extras = era3d_extras(ecfg, 4)
    c = {"image": rng.rand(40, 40, 3).astype(np.float32),
         "xw": rng.randn(4 * V, LAT, LAT, 8).astype(np.float32),
         "xe": rng.randn(4 * V, LAT, LAT, 8).astype(np.float32),
         "ctxw": rng.randn(4 * V, 1, 16).astype(np.float32),
         "ctxe": rng.randn(4 * V, 7, 16).astype(np.float32),
         "clsw": rng.randn(4 * V, 32).astype(np.float32),
         "clse": rng.randn(4 * V, 32).astype(np.float32),
         "t": np.full((4 * V,), 250.0, np.float32)}
    wnoise = jax.random.normal(jax.random.PRNGKey(5), (2 * V, LAT, LAT, 4))

    def refs(wp, ep, vp, c, wnoise):
        unet_w, unet_e = JUNet(wcfg.unet), JUNet(ecfg.unet)
        # the JAX pipeline's batch [uncond (n, c), cond (n, c)]
        out = {"w_full": unet_w.apply({"params": wp["unet"]}, c["xw"],
                                      c["t"], c["ctxw"],
                                      class_emb=c["clsw"])[0]}
        epipe = je.Era3DPipeline(ep, ecfg)
        out["e"], written = unet_e.apply(
            {"params": ep["unet"]}, c["xe"], c["t"], c["ctxe"],
            class_emb=c["clse"], pose_hook=epipe._pose_hook(ep))
        out["e_pose"] = written["pose_aux"]
        out["w3d"] = w3d_reference(wcfg, wp, vp, vcfg, c["image"], wnoise,
                                   2, 2.0)
        return out

    ref = jax.jit(refs, compiler_options=QUICK_XLA)(wp, ep, vparams, c,
                                                    wnoise)
    return dict(c=c, ref=ref, wcfg=wcfg, ecfg=ecfg, wp=wp, ep=ep,
                vcfg=vcfg, vparams=vparams, extras=extras,
                wnoise=nchw(wnoise))


def test_unet_cross_domain_and_rowwise_match_jax(case):
    """Wonder3D's UNet (`cd_joint` over the 6-view fold: the fold's
    self-attention, then each frame of the batch's first half with its
    twin of the second half through `attn_joint_mid`) on 24 frames; Era3D's
    (`mv_rowwise` + `cd_joint`: joint `attn1`, row-wise `attn_mv` across 6
    views) on 24 frames with the pipeline's pose hook re-conditioning the
    up path: the outputs and the regressed (elevation, focal) within 1e-4
    of their largest value."""
    c, ref = case["c"], case["ref"]
    w = port_w3d(case["wcfg"], case["wp"]).model.unet
    e = port_era3d(case["ecfg"], case["ep"], case["vparams"], case["extras"])
    keys = set(w.state_dict()) | set(e.model.unet.state_dict())
    for k in ("attn_joint_mid.to_q.weight", "norm_joint_mid.bias",
              "attn_mv.to_out.0.weight", "norm_mv.weight"):
        assert f"mid_block.attentions.0.transformer_blocks.0.{k}" in keys
    t = torch.as_tensor(c["t"])
    with torch.no_grad():
        full = w(nchw(c["xw"]), t, torch.as_tensor(c["ctxw"]),
                 class_emb=torch.as_tensor(c["clsw"]))
        out, written = e.model.unet(
            nchw(c["xe"]), t, torch.as_tensor(c["ctxe"]),
            class_emb=torch.as_tensor(c["clse"]), pose_hook=e.pose_hook)
    _close(full.permute(0, 2, 3, 1), ref["w_full"], what="wonder3d")
    _close(out.permute(0, 2, 3, 1), ref["e"], what="era3d")
    for got, want, what in zip(written["pose_aux"], ref["e_pose"],
                               ("elevation", "focal")):
        _close(got, want, what=what)


def test_jax_wonder3d_pairs_frames_with_their_uncond_twins(case):
    """ROADMAP §C.9: under the JAX pipeline's batch [uncond (normals,
    colours), cond (normals, colours)] a cond frame's joint attention
    reads its uncond twin, so the cond half's output (all that guidance
    1.0 keeps) moves with the uncond half: the same UNet (the port's,
    held equal to JAX's above) on the cond half alone, which pairs each
    normal frame with its colour frame, differs. The port's guided call at
    guidance 1.0 is the UNet on the cond half alone."""
    c, half = case["c"], 2 * V
    pipe = port_w3d(case["wcfg"], case["wp"])
    x = nchw(c["xw"][half:, ..., :4])
    lat = nchw(c["xw"][half:half + 1, ..., 4:])
    emb = torch.as_tensor(c["ctxw"][half, 0])[None]
    cls = torch.as_tensor(c["clsw"][half:])
    with torch.no_grad():
        alone = pipe.model.unet(
            nchw(c["xw"][half:]), torch.as_tensor(c["t"][half:]),
            torch.as_tensor(c["ctxw"][half:]), class_emb=cls)
        got = pipe.guided_eps(x, 250.0, emb, lat, cls, 1.0)
        want = pipe.model.unet(
            torch.cat([x, lat.expand(half, -1, -1, -1)], 1),
            torch.full((half,), 250.0), emb[:, None].expand(half, -1, -1),
            class_emb=cls)
    in_full = np.asarray(case["ref"]["w_full"])[half:]
    alone = _np(alone.permute(0, 2, 3, 1))
    assert np.abs(in_full - alone).max() > 1e-2 * np.abs(alone).max()
    assert torch.equal(got, want)


def test_wonder3d_pipeline_matches_jax_modules(case):
    """Wonder3D end to end (two DDIM steps under CFG 2 from the same
    initial noise, the image 40² resized to 16², its CLIP embedding as the
    context): the port's colours and normals within 1e-4 of their largest
    value of the JAX modules composed with upstream's batch; at guidance
    1.0 (the cond frames alone, held above) and without a vision encoder
    (a zero context) the views move."""
    ref = case["ref"]
    pipe = port_w3d(case["wcfg"], case["wp"], case["vparams"])
    kw = dict(num_inference_steps=2, draws={"latents": case["wnoise"]})
    colors, normals = pipe(case["c"]["image"], guidance_scale=2.0, **kw)
    assert tuple(colors.shape) == (V, S, S, 3)
    _close(colors, ref["w3d"][0], what="colours")
    _close(normals, ref["w3d"][1], what="normals")
    one, _ = pipe(case["c"]["image"], guidance_scale=1.0, **kw)
    pipe.set_vision_encoder(None)
    plain, _ = pipe(case["c"]["image"], guidance_scale=2.0, **kw)
    for other in (one, plain):
        assert np.abs(_np(other - colors)).max() > 1e-4


def _write(path, config, keys, shapes, rng,
           weights_name="diffusion_pytorch_model.safetensors"):
    """A component directory: `keys` (diffusers' names and kinds, from
    `diffusers_fixture`) filled with seeded values of the shapes the port's
    module holds under those names (a 1×1 convolution's kernel 4-D)."""
    sd = {}
    for name, kind in keys:
        shape = tuple(shapes[name])
        if kind == "conv1x1" and len(shape) == 2:
            shape += (1, 1)
        sd[name] = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    fx.write_component(path, config, sd, weights_name)


def _fabricate(root, model, unet_cfg, vision_cfg, rng, extras=(),
               **unet_kw):
    """unet/ (with the `extras` submodules' keys), vae/ and image_encoder/
    of a diffusers directory at `model`'s widths (built on `meta`)."""
    from tests.test_from_pretrained_wonder3d import VAE_CFG
    unet = {k: v.shape for k, v in model.unet.state_dict().items()}
    keys = fx.enumerate_unet_keys(
        unet_cfg["down_block_types"], unet_cfg["up_block_types"],
        unet_cfg["block_out_channels"], unet_cfg["layers_per_block"],
        **unet_kw)
    keys += [(k, "linear") for k in unet if k.startswith(extras)]
    _write(os.path.join(root, "unet"), unet_cfg, keys, unet, rng)
    _write(os.path.join(root, "vae"), VAE_CFG,
           fx.enumerate_vae_keys(VAE_CFG["block_out_channels"], 1),
           {k: v.shape for k, v in model.vae.state_dict().items()}, rng)
    enc = clip.CLIPVisionEncoder(clip.CLIPVisionConfig(
        hidden=8, layers=2, heads=2, mlp_dim=16, image_size=28, patch=14,
        projection_dim=vision_cfg["projection_dim"],
        act=vision_cfg["hidden_act"]))
    shapes = {("" if k.startswith("visual_projection") else "vision_model.")
              + k: v.shape for k, v in enc.state_dict().items()}
    _write(os.path.join(root, "image_encoder"), vision_cfg,
           fx.enumerate_clip_keys(2, True), shapes, rng,
           weights_name="model.safetensors")


def _same_vision(tpipe, root):
    """The port's vision hook is `make_vision_conditioner` of image_encoder/
    (the CLIP tower's parity with the JAX package is held in
    `test_torch_zero123plus.py`)."""
    from comfy3d_tpu_torch.models.diffusion.config import load_clip_vision_dir
    enc = load_clip_vision_dir(os.path.join(root, "image_encoder"),
                               "cpu")[1].eval()
    img = np.random.RandomState(9).rand(1, 40, 40, 3).astype(np.float32)
    with torch.no_grad():
        assert torch.equal(tpipe.vision_encoder(img),
                           clip.make_vision_conditioner(enc)(img))


def _meta(build):
    with torch.device("meta"):
        return build()


def test_wonder3d_from_pretrained_matches_jax(tmp_path):
    """A fabricated flamehaze1115/wonder3d-v1.0 directory (the JAX test's
    widths: 2 views, SD-1.5 1×1-convolution projections, the projection
    class embedding inside unet/): the port's model holds exactly the JAX
    loader's params under `wonder3d_state_dict_from_flax`, the configs
    agree, and image_encoder/ is the vision hook of both."""
    from comfy3d_tpu_torch.models.diffusion.config import (
        unet_config_from_json, vae_config_from_json)
    from tests.test_from_pretrained_wonder3d import (UNET_CFG, VAE_CFG,
                                                     VISION_CFG)
    model = _meta(lambda: tw.Wonder3D(tw.Wonder3DConfig(
        unet=unet_config_from_json(UNET_CFG),
        vae=vae_config_from_json(VAE_CFG))))
    _fabricate(tmp_path, model, UNET_CFG, VISION_CFG,
               np.random.default_rng(0), ("class_embedding.",),
               use_linear_projection=False, cd_joint=True)
    jpipe = jw.Wonder3DPipeline.from_pretrained(str(tmp_path), image_size=16)
    tpipe = tw.Wonder3DPipeline.from_pretrained(str(tmp_path), device="cpu",
                                                image_size=16)
    assert tpipe.cfg == port_cfg(jpipe.cfg, tw.Wonder3DConfig)
    assert tpipe.cfg.unet.cd_joint and tpipe.cfg.num_views == 2
    _assert_state_dict(tpipe.model,
                       convert.wonder3d_state_dict_from_flax(jpipe.params))
    assert jpipe.vision_encoder is not None
    _same_vision(tpipe, tmp_path)


def test_era3d_from_pretrained_matches_jax(tmp_path):
    """A fabricated pengHTYX/MacLab-Era3D-512-6view directory (the JAX
    test's widths: row-wise blocks, the unCLIP class and camera embeddings
    and two 2-block regressors inside unet/, the normaliser's statistics,
    the noising scheduler, the per-view prompt embeddings): the port's
    model holds exactly the JAX loader's params, and its config, prompt
    embeddings, statistics and noising table are the JAX loader's, and
    image_encoder/ is the vision hook of both."""
    import json
    from safetensors.numpy import save_file
    from comfy3d_tpu_torch.models.diffusion.config import (
        unet_config_from_json, vae_config_from_json)
    from tests.test_from_pretrained_era3d import UNET_CFG, VISION_CFG, V as NV
    from tests.test_from_pretrained_wonder3d import VAE_CFG
    rng = np.random.default_rng(0)
    model = _meta(lambda: te.Era3D(te.Era3DConfig(
        unet=unet_config_from_json(UNET_CFG),
        vae=vae_config_from_json(VAE_CFG), clip_embed_dim=12,
        regress_blocks=2)))
    _fabricate(tmp_path, model, UNET_CFG, VISION_CFG, rng,
               ("class_embedding.", "camera_embedding.",
                "elevation_regressor.", "focal_regressor."), mv_rowwise=True)
    nz = tmp_path / "image_normalizer"
    nz.mkdir()
    (nz / "config.json").write_text(json.dumps({"embedding_dim": 12}))
    save_file({"mean": rng.standard_normal((1, 12)).astype(np.float32),
               "std": (1 + rng.random((1, 12))).astype(np.float32)},
              str(nz / "diffusion_pytorch_model.safetensors"))
    ns = tmp_path / "image_noising_scheduler"
    ns.mkdir()
    (ns / "scheduler_config.json").write_text(json.dumps(
        {"num_train_timesteps": 1000, "beta_schedule": "scaled_linear"}))
    pe = tmp_path / "fixed_prompt_embeds_6view"
    pe.mkdir()
    for name in ("normal", "clr"):
        torch.save(torch.randn(NV, 3, 16), str(pe / f"{name}_embeds.pt"))
    jpipe = je.Era3DPipeline.from_pretrained(str(tmp_path), image_size=16)
    tpipe = te.Era3DPipeline.from_pretrained(str(tmp_path), device="cpu",
                                             image_size=16)
    assert tpipe.cfg == port_cfg(jpipe.cfg, te.Era3DConfig)
    assert (tpipe.cfg.regress_blocks, tpipe.cfg.clip_embed_dim,
            tpipe.cfg.prompt_tokens) == (2, 12, 3)
    _assert_state_dict(tpipe.model,
                       convert.era3d_state_dict_from_flax(jpipe.params))
    for got, want in ((tpipe.prompt_embeds, jpipe.prompt_embeds),
                      (tpipe.normalizer_mean, jpipe.normalizer_mean),
                      (tpipe.normalizer_std, jpipe.normalizer_std)):
        assert np.array_equal(_np(got), want)
    assert np.array_equal(tpipe.noising_alphas, jpipe.noising_alphas)
    assert jpipe.vision_encoder is not None
    _same_vision(tpipe, tmp_path)


def test_wonder3d_nodes_and_factories(tmp_path, monkeypatch, case):
    """`chip_smoke.config_graph("wonder3d")` through `run_workflow` on the
    CPU (LoadImage → Load Wonder3D Pipeline, its random init wrapped to the
    tiny pipeline → Wonder3D MVDiffusion Model at 2 steps): the views and
    normal maps are the pipeline's own on the composited image with the
    node's seed and guidance (held against the JAX modules above), the
    poses the JAX node's; `Load Diffusers Pipeline`'s Wonder3D and Era3D
    factories build the pipelines on the run's device."""
    import chip_smoke
    from comfy3d_tpu.nodes import nodes_mvdiffusion as jnm
    from comfy3d_tpu_torch.core.image import composite_background
    from comfy3d_tpu_torch.nodes import base, graph, nodes_diffusers
    for name, attr in (("in", "INPUT_ROOT_PATH"), ("out", "OUTPUT_ROOT_PATH"),
                       ("ckpt", "CKPT_ROOT_PATH")):
        (tmp_path / name).mkdir()
        monkeypatch.setattr(base, attr, str(tmp_path / name))
    chip_smoke.write_reference_images(str(tmp_path / "in"), 24)
    pipe = port_w3d(case["wcfg"], case["wp"], case["vparams"])
    era = port_era3d(case["ecfg"], case["ep"], case["vparams"],
                     case["extras"])
    built = []
    for cls, p in ((tw.Wonder3DPipeline, pipe), (te.Era3DPipeline, era)):
        monkeypatch.setattr(cls, "init_random", classmethod(
            lambda c, *a, _p=p, **kw: built.append(kw["device"]) or _p))
    res = graph.run_workflow(chip_smoke.config_graph("wonder3d"),
                             {4: {"num_inference_steps": 2}}, device="cpu")
    colors, normals, poses = res[4]
    image = composite_background(res[1][0], res[2][0])[0]
    want = pipe(image, num_inference_steps=2, guidance_scale=1.0, seed=0)
    assert torch.equal(colors, want[0]) and torch.equal(normals, want[1])
    assert poses == [[r, e, a, 0.0, 0.0, 0.0]
                     for r, e, a in jnm.Wonder3D_MVDiffusion_Model._POSES]
    for name, p in (("Wonder3DMVDiffusionPipeline", pipe),
                    ("Era3DPipeline", era)):
        assert nodes_diffusers.DIFFUSERS_PIPE_FACTORIES[name](
            device="cpu") is p
    assert [str(d) for d in built] == ["cpu"] * 3


def test_tables_and_unclip_noising_match_jax():
    """The image-noising scheduler's tables (squaredcos_cap_v2,
    scaled_linear, linear) equal the JAX package's; Era3D's unCLIP noising
    (normalise, noise at level 50 with JAX's draw, unnormalise, the level's
    timestep embedding) within 1e-5 of its largest value; Wonder3D's camera
    table and its sin | cos class embedding input equal JAX's."""
    for sched in ("squaredcos_cap_v2", "scaled_linear", "linear"):
        assert np.array_equal(te.ddpm_alphas_cumprod(schedule=sched),
                              je.ddpm_alphas_cumprod(schedule=sched))
    assert np.array_equal(tw.CAMERA_TABLE, jw.CAMERA_TABLE)
    ecfg = era3d_cfg()
    extras = era3d_extras(ecfg, 11)
    emb = np.random.RandomState(12).randn(1, ecfg.clip_embed_dim).astype(
        np.float32)
    key = jax.random.PRNGKey(13)
    jpipe = je.Era3DPipeline({}, ecfg)
    jpipe.normalizer_mean, jpipe.normalizer_std = extras["mean"], extras["std"]
    ref = jpipe._noise_image_embeddings(jnp.asarray(emb), key)
    pipe = te.Era3DPipeline.init_random(
        cfg=port_cfg(ecfg, te.Era3DConfig), device="cpu")
    pipe.normalizer_mean = torch.as_tensor(extras["mean"])
    pipe.normalizer_std = torch.as_tensor(extras["std"])
    out = pipe.noise_image_embeddings(torch.as_tensor(emb), np.asarray(
        jax.random.normal(key, emb.shape)))
    _close(out, ref, rel=1e-5, what="unCLIP noising")
