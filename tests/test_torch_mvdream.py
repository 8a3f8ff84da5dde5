"""Port parity, MVDream text → four views, and the slice as a whole: the
orbit cameras and their embedding, `MVDreamPipeline.__call__` (CFG over
2·4 frames, DDIM, the VAE decode), its views through LGM to splats and
two views of the GS→mesh supervision orbit, the state dict against the JAX
package's own converters, the full config's parameter counts, and the
options that are not ported, `comfy3d_tpu_torch` against `comfy3d_tpu` on
the same numpy inputs and weights (flax params carried across by
`convert.mvdream_state_dict_from_flax` and
`convert.lgm_state_dict_from_flax`)."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.models.convert import convert_with_rules, set_path
from comfy3d_tpu.models.diffusion.convert import unet_rules, vae_rules
from comfy3d_tpu.models.diffusion.unet import UNet2DCondition as JUNet
from comfy3d_tpu.models.diffusion.vae import AutoencoderKL as JVAE
from comfy3d_tpu.models.mvdream import pipeline as jp
from comfy3d_tpu.models.lgm import model as jlm
from comfy3d_tpu.models.lgm.pipeline import LGMPipeline as JLGMPipeline
from comfy3d_tpu.models.mvdream.convert import mv_unet_rules
from comfy3d_tpu.ops import gs_render as JG

from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.models.diffusion import UNetConfig, VAEConfig
from comfy3d_tpu_torch.models.mvdream import pipeline as tp
from comfy3d_tpu_torch.models.mvdream import MVDreamConfig, MVDreamPipeline
from comfy3d_tpu_torch.ops import gs_render as G

from tests.test_diffusion import tiny_unet_cfg, tiny_vae_cfg
from tests.test_torch_lgm import (SPLAT_FIELDS, TINY, _port_lgm,
                                  _tiny_params)
from tests.test_torch_common import (QUICK_XLA, _load, _np, _randomize,
                                     jax_orbit_camera,
                                     one_torch_thread)  # noqa: F401

# outputs against the JAX package: within this share of their largest value
REL = 1e-4
# the full config's parameters (the JAX package's `jax.eval_shape` counts)
FULL_PARAMS = {"unet": 859_520_964, "camera": 1_661_440, "vae": 83_653_863}


def _close(out, ref, rel=REL, what=""):
    out, ref = _np(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())


def tiny_jax_cfg():
    """`tests/test_workflows.py::_tiny_mvdream`'s shapes: four 32² views
    from 16² latents, 7 prompt tokens of 16."""
    return jp.MVDreamConfig(
        image_size=32, num_views=4,
        unet=dataclasses.replace(tiny_unet_cfg(), mv_views=4,
                                 cross_attention_dim=16),
        vae=tiny_vae_cfg(), prompt_tokens=7, prompt_dim=16)


def port_cfg(jcfg):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["unet"] = UNetConfig(**dataclasses.asdict(jcfg.unet))
    kw["vae"] = VAEConfig(**dataclasses.asdict(jcfg.vae))
    return MVDreamConfig(**kw)


def tiny_params(jcfg, seed):
    """The tiny MVDream's flax params, `{"unet", "vae", "camera"}` as the
    JAX package's `init_random` builds them, by shape alone (traced once a
    config, `_tiny_shapes`), every leaf drawn from `seed`."""
    return _randomize(_tiny_shapes(jcfg), seed)


@functools.lru_cache(maxsize=None)
def _tiny_shapes(jcfg):
    lat = jcfg.image_size // jcfg.vae_factor
    v, emb = jcfg.num_views, jcfg.unet.block_out_channels[0] * 4
    z, key = jnp.zeros, jax.random.PRNGKey(0)
    shapes = {
        "unet": jax.eval_shape(
            JUNet(jcfg.unet).init, key, z((v, lat, lat, 4)), z((v,)),
            z((v, jcfg.prompt_tokens, jcfg.prompt_dim)),
            class_emb=z((v, emb)))["params"],
        "vae": jax.eval_shape(JVAE(jcfg.vae).init, key,
                              z((1, 64, 64, 3)))["params"],
        "camera": jax.eval_shape(jp.CameraEmbed(emb).init, key,
                                 z((1, jcfg.camera_dim)))["params"]}
    return shapes


def tiny_pipelines(seed=0):
    """(JAX pipeline, port pipeline) with the same tiny weights."""
    jcfg = tiny_jax_cfg()
    params = tiny_params(jcfg, seed)
    port = MVDreamPipeline(_load(tp.MVDream(port_cfg(jcfg)),
                                 convert.mvdream_state_dict_from_flax(
                                     params)))
    return jp.MVDreamPipeline(params, jcfg), port


def jax_latents(seed, cfg):
    """The JAX pipeline's initial noise for `seed`, NCHW for the port."""
    lat = cfg.image_size // cfg.vae_factor
    noise = jax.random.normal(jax.random.PRNGKey(seed),
                              (cfg.num_views, lat, lat, 4))
    return torch.as_tensor(np.array(noise)).permute(0, 3, 1, 2)


def test_orbit_cameras_and_their_embedding_match_jax():
    for elev in (0.0, 15.0):
        _close(tp.orbit_c2w_flat(4, elev, 1.5, device="cpu"),
               jp.orbit_c2w_flat(4, elev, 1.5), what=f"c2w {elev}")
    jpipe, pipe = tiny_pipelines(1)
    ref = jpipe.cam_embed.apply({"params": jpipe.params["camera"]},
                                jp.orbit_c2w_flat(4, 10.0, 1.5))
    with torch.no_grad():
        _close(pipe.camera_embedding(10.0), ref, what="embedding")


@pytest.fixture(scope="module")
def views():
    """The tiny pipelines' four views from one call each (the JAX one
    jitted): two DDIM steps under CFG 5 from the JAX pipeline's own noise
    for seed 3, random prompt and negative embeddings, the node's elevation
    0. → (JAX's views, the port's)."""
    jpipe, pipe = tiny_pipelines(2)
    rng = np.random.RandomState(3)
    kw = dict(prompt_embeds=rng.randn(7, 16).astype(np.float32),
              negative_embeds=rng.randn(7, 16).astype(np.float32),
              elevation=0.0, num_inference_steps=2, guidance_scale=5.0)
    ref = jax.jit(lambda p: jp.MVDreamPipeline(p, jpipe.cfg)(seed=3, **kw),
                  compiler_options=QUICK_XLA)(jpipe.params)
    return ref, pipe(latents=jax_latents(3, pipe.cfg), **kw)


def test_pipeline_matches_jax(views):
    """The four views within 1e-4 of their largest value."""
    ref, out = views
    assert tuple(out.shape) == (4, 32, 32, 3)
    assert 0.0 < float(out.mean()) < 1.0
    _close(out, ref)


def test_text_to_views_to_splats_to_orbit_matches_jax(views):
    """The slice as a whole at tiny widths: MVDream's four 32² views (the
    `views` fixture) → LGM → 1,024 splats →
    two views of gs_to_mesh's supervision orbit (elevations −30 and 0,
    azimuths 0 and 15, radius 2, fovy 49.1, 64², white), the port's plain
    coarse-bin path against JAX's "pallas" path in interpret mode: views
    and splat fields within 1e-4 of their largest value, the renders within
    1e-3 (PSNR ≥ 60 dB) and their alpha within 1e-3."""
    jviews, tviews = views
    params = _tiny_params(seed=6)
    jsplat = jax.jit(lambda p, v: JLGMPipeline(
        p, jlm.LGMConfig(**TINY)).forward_gaussians(v),
        compiler_options=QUICK_XLA)(params, jviews)
    splat = _port_lgm(params).forward_gaussians(tviews)
    for f in SPLAT_FIELDS:
        _close(getattr(splat, f), getattr(jsplat, f), what=f)

    elev = np.array([-30.0, 0.0], np.float32)
    azim = np.array([0.0, 15.0], np.float32)
    jc = jax_orbit_camera(elev, azim, 2.0, fovy_deg=49.1, width=64,
                          height=64)
    cams = convert.camera_from_numpy(np.asarray(jc.c2w),
                                     np.asarray(jc.fovy_deg), 64, 64,
                                     jc.near, jc.far, "cpu")
    ref = jax.jit(lambda s, c: JG.render(
        s, c, background=(1.0, 1.0, 1.0), backend="pallas",
        interpret=True), compiler_options=QUICK_XLA)(jsplat, jc)
    out = G.render(splat, cams, background=(1.0, 1.0, 1.0), backend="flat")
    img, jimg = _np(out["image"]), np.asarray(ref["image"])
    assert img.shape == (2, 64, 64, 3)
    assert np.abs(img - jimg).max() <= 1e-3
    mse = float(((img - jimg) ** 2).mean())
    assert 10 * math.log10(1.0 / max(mse, 1e-20)) >= 60.0
    np.testing.assert_allclose(_np(out["alpha"]), np.asarray(ref["alpha"]),
                               atol=1e-3, rtol=0)
    assert 0.05 < float(out["alpha"].mean()) < 0.99


def test_state_dict_round_trip_through_the_jax_converters():
    """flax params → the port's state dict → the JAX package's own
    `unet_rules` (diffusers' names, under `unet.`), `vae_rules` (under
    `vae.`) and `mv_unet_rules` (MVDream's `camera_embed.*`) → the same
    params leaf for leaf; a seed gives the same weights every time."""
    jcfg = tiny_jax_cfg()
    params = tiny_params(jcfg, 4)
    model = _load(tp.MVDream(port_cfg(jcfg)),
                  convert.mvdream_state_dict_from_flax(params))
    sd = model.state_dict()
    assert {k.split(".")[0] for k in sd} == {"unet", "vae", "camera_embed"}

    def part(prefix):
        return {k: v for k, v in sd.items() if k.startswith(prefix)}

    tree = {"unet": convert_with_rules(part("unet."), unet_rules("unet.")),
            "vae": convert_with_rules(part("vae."), vae_rules("vae.")),
            "camera": {}}
    cam_rules = mv_unet_rules()
    for k, v in sd.items():
        if k.startswith("camera_embed."):
            group, path, val = cam_rules(k, v.numpy())
            set_path(tree[group], path, val)
    flat = jax.tree_util.tree_leaves_with_path(params)
    back = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(back) == len(flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(back[path], leaf,
                                      err_msg=jax.tree_util.keystr(path))

    key = "unet.mid_block.attentions.0.transformer_blocks.0.attn1.to_q.weight"
    cfg = port_cfg(jcfg)
    a, b, c = (MVDreamPipeline.init_random(s, cfg, device="cpu")
               .model.state_dict()[key] for s in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_full_config_parameter_counts_match_jax():
    """`MVDreamConfig()` (SD-1.5 widths, four views): the UNet, the camera
    MLP and the VAE each count the JAX package's parameters
    (`jax.eval_shape` of their inits) and the figures of record."""
    jcfg = jp.MVDreamConfig()
    assert dataclasses.asdict(MVDreamConfig()) == dataclasses.asdict(jcfg)
    emb = jcfg.unet.block_out_channels[0] * 4
    z = jnp.zeros
    shapes = {
        "unet": jax.eval_shape(JUNet(jcfg.unet).init, jax.random.PRNGKey(0),
                               z((4, 32, 32, 4)), z((4,)), z((4, 77, 768)),
                               class_emb=z((4, emb))),
        "camera": jax.eval_shape(jp.CameraEmbed(emb).init,
                                 jax.random.PRNGKey(0), z((1, 16))),
        "vae": jax.eval_shape(JVAE(jcfg.vae).init, jax.random.PRNGKey(0),
                              z((1, 64, 64, 3)))}
    with torch.device("meta"):
        model = tp.MVDream(MVDreamConfig())
    parts = {"unet": model.unet, "camera": model.camera_embed,
             "vae": model.vae}
    for name, mod in parts.items():
        n_jax = sum(math.prod(a.shape)
                    for a in jax.tree.leaves(shapes[name]["params"]))
        n_port = sum(p.numel() for p in mod.parameters())
        assert n_port == n_jax == FULL_PARAMS[name], name


def test_unported_conditioning_raises():
    """On the text-only pipeline, as in the JAX package: an image is not
    read (`ip_dim` 0), `pixel_images` warn and are not read (4 input
    channels); a stage-2 UNet (8 input channels) without `pixel_images`
    raises ValueError. The Euler-ancestral sampler runs as the JAX
    pipeline's does (two steps under CFG 5, its initial noise and
    `sample_loop`'s per-step keys `fold_in(PRNGKey(seed), i)` replayed):
    the views within 1e-4 of their largest value."""
    jpipe, pipe = tiny_pipelines()
    x = jax_latents(1, pipe.cfg)
    plain = pipe(num_inference_steps=1, latents=x)
    with_image = pipe(num_inference_steps=1, latents=x,
                      image=np.zeros((32, 32, 3), np.float32))
    with pytest.warns(UserWarning, match="pixel_images"):
        with_pixels = pipe(num_inference_steps=1, latents=x,
                           pixel_images=np.zeros((4, 32, 32, 3), np.float32))
    assert torch.equal(with_image, plain) and torch.equal(with_pixels, plain)
    stage2 = MVDreamPipeline(tp.MVDream(dataclasses.replace(
        pipe.cfg, unet=dataclasses.replace(pipe.cfg.unet, in_channels=8))))
    with pytest.raises(ValueError, match="pixel_images"):
        stage2(num_inference_steps=1)
    name, seed = "EulerAncestralDiscreteScheduler", 5
    kw = dict(num_inference_steps=2, guidance_scale=5.0, elevation=0.0)

    def run(p):
        j = jp.MVDreamPipeline(p, jpipe.cfg)
        j.scheduler_name = name
        lat = pipe.cfg.image_size // pipe.cfg.vae_factor
        noise = [jax.random.normal(jax.random.fold_in(
            jax.random.PRNGKey(seed), i), (4, lat, lat, 4)) for i in range(2)]
        return j(seed=seed, **kw), noise

    ref, noise = jax.jit(run, compiler_options=QUICK_XLA)(jpipe.params)
    pipe.scheduler_name = name
    out = pipe(latents=jax_latents(seed, pipe.cfg), step_noise=lambda i:
               torch.as_tensor(np.array(noise[i])).permute(0, 3, 1, 2), **kw)
    _close(out, ref, what=name)


def test_entry_points_default_to_the_card():
    """Without a `device`, the pipeline and the orbit cameras go to the
    card; there is no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = port_cfg(tiny_jax_cfg())
    with pytest.raises((AssertionError, RuntimeError)):
        MVDreamPipeline.init_random(0, cfg)
    with pytest.raises((AssertionError, RuntimeError)):
        tp.orbit_c2w_flat(4, 0.0, 1.5)
