"""Port parity, ImageDream and CRM's multi-view stages: CLIP vision's
penultimate hidden states, the UNet's IP projections and T2I-Adapter
residuals, the Resampler, the ImageDream pipeline with its pinned frame,
CRM's stage 2 with the pixel views' latents, the single-file LDM loader
(with the OpenCLIP towers' renames) and an imagedream-diffusers directory
through `from_pretrained` and the Load_Diffusers_Pipeline node,
`comfy3d_tpu_torch` against `comfy3d_tpu` on the same numpy inputs and
weights (flax params carried across by `convert.*_from_flax`).

The JAX references are built by shape (`jax.eval_shape`), redrawn from
numpy, and computed in two jitted calls (`QUICK_XLA`)."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import diffusers_fixture as fx
from comfy3d_tpu.models import clip as jclip
from comfy3d_tpu.models.diffusion import ldm_convert as jldm
from comfy3d_tpu.models.diffusion.unet import UNet2DCondition as JUNet
from comfy3d_tpu.models.diffusion.vae import AutoencoderKL as JVAE
from comfy3d_tpu.models.mvdream import pipeline as jp
from comfy3d_tpu.models.mvdream.convert import mv_unet_rules

from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.models import clip
from comfy3d_tpu_torch.models.diffusion import ldm_convert as tldm
from comfy3d_tpu_torch.models.diffusion.unet import (UNet2DCondition,
                                                     UNetConfig)
from comfy3d_tpu_torch.models.diffusion.vae import AutoencoderKL, VAEConfig
from comfy3d_tpu_torch.models.mvdream import pipeline as tp
from comfy3d_tpu_torch.models.mvdream import MVDreamPipeline

from tests.test_diffusion import tiny_unet_cfg, tiny_vae_cfg
from tests.test_torch_clip_text import (_assert_state_dict, _zeros,
                                        ldm_unet_keys, write_clip_text,
                                        write_vae)
from tests.test_torch_common import (QUICK_XLA, _load, _np, _randomize,
                                     one_torch_thread)  # noqa: F401
from tests.test_torch_mvdream import port_cfg

# outputs against the JAX package: within this share of their largest value
REL = 1e-4
TINY_CLIP = dict(hidden=8, layers=3, heads=2, mlp_dim=16, image_size=28,
                 patch=14, projection_dim=8, act="gelu")
IP = 3


def _close(out, ref, rel=REL, what=""):
    out, ref = _np(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())


def tiny_cfg(in_channels=4, num_views=4):
    """A tiny ImageDream: 32² views from 16² latents, 7 prompt tokens of 16
    and 3 IP tokens from a 2-layer Resampler over 8-wide CLIP states."""
    unet = dataclasses.replace(tiny_unet_cfg(), mv_views=num_views,
                               cross_attention_dim=16, ip_dim=IP,
                               ip_weight=0.7, in_channels=in_channels)
    return jp.MVDreamConfig(
        image_size=32, num_views=num_views, unet=unet, vae=tiny_vae_cfg(),
        prompt_tokens=7, prompt_dim=16, ip_dim=IP, ip_weight=0.7,
        ip_embed_dim=TINY_CLIP["hidden"], resampler_depth=2,
        resampler_heads=2, resampler_dim_head=4)


def _resampler(jcfg):
    return jp.Resampler(dim=jcfg.prompt_dim, depth=jcfg.resampler_depth,
                        dim_head=jcfg.resampler_dim_head,
                        heads=jcfg.resampler_heads, num_queries=jcfg.ip_dim,
                        output_dim=jcfg.prompt_dim)


def tiny_shapes(jcfg, vae=True):
    """The tiny pipeline's flax param tree by shape (`vae=False`: without
    the VAE's). The tree depends on neither the view count nor the UNet's
    `mv_views` (its multi-view attention is the self-attention's weights
    over the views' tokens), so one trace at one view serves every count
    (the module's tests share it)."""
    one = dataclasses.replace(jcfg, num_views=1, unet=dataclasses.replace(
        jcfg.unet, mv_views=1), vae=None)
    shapes = dict(_tiny_shapes(one, jcfg.image_size // jcfg.vae_factor))
    if vae:
        shapes["vae"] = _vae_shapes(jcfg.vae)
    return shapes


@functools.lru_cache(maxsize=None)
def _tiny_shapes(jcfg, lat):
    """The UNet's (on `lat`² latents), camera MLP's and Resampler's trees,
    each traced once per config whether the VAE's is asked for or not."""
    v, emb = jcfg.num_views, jcfg.unet.block_out_channels[0] * 4
    z, key = jnp.zeros, jax.random.PRNGKey(0)
    return {
        "unet": jax.eval_shape(
            JUNet(jcfg.unet).init, key,
            z((v, lat, lat, jcfg.unet.in_channels)), z((v,)),
            z((v, jcfg.prompt_tokens + jcfg.ip_dim, jcfg.prompt_dim)),
            class_emb=z((v, emb)))["params"],
        "camera": jax.eval_shape(jp.CameraEmbed(emb).init, key,
                                 z((1, jcfg.camera_dim)))["params"],
        "resampler": jax.eval_shape(_resampler(jcfg).init, key,
                                    z((1, 5, jcfg.ip_embed_dim)))["params"]}


@functools.lru_cache(maxsize=None)
def _vae_shapes(vcfg):
    return jax.eval_shape(JVAE(vcfg).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 3)))["params"]


def tiny_params(jcfg, seed):
    """The tiny pipeline's flax params by shape, every leaf from `seed`."""
    return _randomize(tiny_shapes(jcfg), seed)


@functools.lru_cache(maxsize=None)
def _clip_shapes(cfg):
    return jax.eval_shape(jclip.CLIPVisionEncoder(cfg).init,
                          jax.random.PRNGKey(0),
                          jnp.zeros((1, 28, 28, 3)))["params"]


def clip_params(seed):
    cfg = jclip.CLIPVisionConfig(**TINY_CLIP)
    return cfg, _randomize(_clip_shapes(cfg), seed)


def port_clip(vparams):
    enc = clip.CLIPVisionEncoder(clip.CLIPVisionConfig(**TINY_CLIP))
    return _load(enc, convert.clip_vision_state_dict_from_flax(vparams))


def port_pipe(jcfg, params, vparams):
    pipe = MVDreamPipeline(_load(tp.MVDream(port_cfg(jcfg)),
                                 convert.mvdream_state_dict_from_flax(params)))
    pipe.set_vision_encoder(clip.make_vision_hidden_conditioner(
        port_clip(vparams)))
    return pipe


def jax_noise(seed, frames, lat):
    """The JAX pipeline's initial noise for `seed`, NCHW for the port."""
    noise = jax.random.normal(jax.random.PRNGKey(seed), (frames, lat, lat, 4))
    return torch.as_tensor(np.array(noise)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def small():
    """The block-level cases and their JAX outputs, in one jitted call: the
    CLIP encoder's penultimate states and its conditioner, the UNet with IP
    tokens over a 2-view fold and adapter residuals, the Resampler."""
    rng = np.random.RandomState(0)
    vcfg, vparams = clip_params(1)
    ucfg = dataclasses.replace(tiny_unet_cfg(), ip_dim=IP, ip_weight=0.7,
                               mv_views=2)
    jcfg = tiny_cfg()
    params = tiny_params(jcfg, 2)
    case = {
        "img": rng.rand(2, 40, 40, 3).astype(np.float32),
        "norm": rng.randn(2, 28, 28, 3).astype(np.float32),
        "x": rng.randn(4, 16, 16, 4).astype(np.float32),
        "t": np.array([3.0, 3.0, 500.0, 500.0], np.float32),
        "ctx": rng.randn(4, 7 + IP, 16).astype(np.float32),
        "cls": rng.randn(4, 32).astype(np.float32),
        "res": [rng.randn(4, 16, 16, 8).astype(np.float32),
                rng.randn(4, 8, 8, 16).astype(np.float32)],
        "hidden": rng.randn(2, 5, TINY_CLIP["hidden"]).astype(np.float32)}
    uparams = _randomize(tiny_shapes(dataclasses.replace(
        jcfg, unet=ucfg))["unet"], 3)
    enc = jclip.CLIPVisionEncoder(vcfg)

    def refs(vp, up, rp, c):
        return {
            "penult": enc.apply({"params": vp}, c["norm"],
                                project="penultimate"),
            "hidden_cond": jclip.make_vision_hidden_conditioner(
                vp, vcfg)(c["img"]),
            "unet": JUNet(ucfg).apply(
                {"params": up}, c["x"], c["t"], c["ctx"], class_emb=c["cls"],
                adapter_residuals=c["res"])[0],
            "resampler": _resampler(jcfg).apply({"params": rp},
                                                c["hidden"])}

    out = jax.jit(refs, compiler_options=QUICK_XLA)(
        vparams, uparams, params["resampler"], case)
    return dict(case=case, ref=out, vparams=vparams, uparams=uparams,
                ucfg=ucfg, jcfg=jcfg, rparams=params["resampler"])


def test_clip_penultimate_matches_jax(small):
    """`project="penultimate"`: the tokens entering the last layer, without
    the post-LayerNorm, and their token 0; the conditioner (a 40² image
    resized to 28², normalised) → the same states; within 1e-4 of their
    largest value."""
    c, ref = small["case"], small["ref"]
    enc = port_clip(small["vparams"])
    with torch.no_grad():
        tokens, tok0 = enc(torch.as_tensor(c["norm"]).permute(0, 3, 1, 2),
                           project="penultimate")
        cond = clip.make_vision_hidden_conditioner(enc)(c["img"])
    _close(tokens, ref["penult"][0], what="tokens")
    _close(tok0, ref["penult"][1], what="token 0")
    _close(cond, ref["hidden_cond"], what="conditioner")


def test_unet_ip_tokens_and_adapter_residuals_match_jax(small):
    """The UNet over a 2-view fold with the context's last 3 tokens through
    `to_k_ip` / `to_v_ip` (weight 0.7) and a T2I-Adapter residual after
    each down block's first resnet, within 1e-4 of its largest value; the
    residuals move the output (the UNet without them is held in
    `test_torch_diffusion.py`)."""
    c, ref = small["case"], small["ref"]
    model = _load(UNet2DCondition(UNetConfig(**dataclasses.asdict(
        small["ucfg"]))), convert.unet_state_dict_from_flax(small["uparams"]))
    assert "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_v_ip" \
        ".weight" in model.state_dict()

    def nchw(a):
        return torch.as_tensor(a).permute(0, 3, 1, 2)

    args = (nchw(c["x"]), torch.as_tensor(c["t"]), torch.as_tensor(c["ctx"]))
    with torch.no_grad():
        out = model(*args, class_emb=torch.as_tensor(c["cls"]),
                    adapter_residuals=[nchw(r) for r in c["res"]])
        plain = model(*args, class_emb=torch.as_tensor(c["cls"]))
    _close(out.permute(0, 2, 3, 1), ref["unet"], what="adapter")
    assert np.abs(_np(out - plain)).max() > 1e-2


def test_resampler_matches_jax(small):
    """The Resampler (2 perceiver blocks, LayerNorm eps 1e-6, exact GELU):
    5 CLIP tokens → 3 IP tokens, within 1e-4 of their largest value; its
    state dict is ImageDream's `image_embed.*` layout."""
    jcfg = small["jcfg"]
    rs = _load(tp.Resampler(dim=16, depth=2, dim_head=4, heads=2,
                            num_queries=IP, embedding_dim=8, output_dim=16),
               convert.resampler_state_dict_from_flax(small["rparams"]))
    assert {"latents", "layers.1.0.to_kv.weight", "layers.1.1.3.weight",
            "norm_out.bias"} <= set(rs.state_dict())
    with torch.no_grad():
        out = rs(torch.as_tensor(small["case"]["hidden"]))
    _close(out, small["ref"]["resampler"])
    assert jcfg.ip_dim == out.shape[1]


@pytest.fixture(scope="module")
def pipes():
    """The tiny ImageDream (4 views + the pinned frame) and its stage 2 (8
    input channels) on shared VAE, camera and Resampler weights, and JAX's
    views of both from one jitted call: 2 DDIM steps under CFG 5 with
    random prompt embeddings, the image a 40² composite, stage 2's pixel
    views 24² (both resized as `jax.image.resize` does)."""
    rng = np.random.RandomState(4)
    vcfg, vparams = clip_params(5)
    jcfg, jcfg2 = tiny_cfg(), tiny_cfg(in_channels=8)
    params = tiny_params(jcfg, 6)
    params2 = {**params, "unet": tiny_params(jcfg2, 7)["unet"]}
    kw = dict(prompt_embeds=rng.randn(7, 16).astype(np.float32),
              negative_embeds=rng.randn(7, 16).astype(np.float32),
              num_inference_steps=2, guidance_scale=5.0, elevation=10.0)
    image = rng.rand(40, 40, 3).astype(np.float32)
    pixels = rng.rand(4, 24, 24, 3).astype(np.float32)

    def run(vp, p, p2):
        out = []
        for cfg, prm, extra in ((jcfg, p, {}),
                                (jcfg2, p2, {"pixel_images": pixels})):
            pipe = jp.MVDreamPipeline(prm, cfg)
            pipe.set_vision_encoder(
                jclip.make_vision_hidden_conditioner(vp, vcfg))
            out.append(pipe(image=image, seed=3, **kw, **extra))
        return out

    ref, ref2 = jax.jit(run, compiler_options=QUICK_XLA)(vparams, params,
                                                         params2)
    return dict(kw=kw, image=image, pixels=pixels, ref=ref, ref2=ref2,
                pipe=port_pipe(jcfg, params, vparams),
                pipe2=port_pipe(jcfg2, params2, vparams))


def test_imagedream_pipeline_matches_jax(pipes):
    """`image=`: IP tokens from the penultimate states in every frame's
    context (the uncond half the Resampler's output on zeros), the image's
    latent pinned as a fifth frame with a zero c2w, 5 latents stepped and
    4 decoded: the views within 1e-4 of their largest value from the same
    initial noise; without the image the views differ."""
    pipe, kw = pipes["pipe"], pipes["kw"]
    x = jax_noise(3, 5, 16)
    out = pipe(image=pipes["image"], latents=x, **kw)
    assert tuple(out.shape) == (4, 32, 32, 3)
    _close(out, pipes["ref"], what="views")
    cond = pipe.conditioning(image=pipes["image"])
    assert cond.frames == 5 and cond.states.shape == (10, 7 + IP, 16)
    assert torch.equal(cond.pinned[0], torch.zeros_like(cond.pinned[0]))
    assert np.abs(_np(pipe(latents=x[:4], **kw) - out)).max() > 1e-3


def test_stage2_matches_jax(pipes):
    """CRM's stage 2: the pixel views' latents as 4 more input channels
    (zeros in the uncond half), IP tokens but no pinned frame, within 1e-4
    of their largest value; pixel views on a 4-channel UNet warn and are
    not read, a stage-2 UNet without them raises ValueError."""
    pipe2, kw = pipes["pipe2"], pipes["kw"]
    out = pipe2(image=pipes["image"], pixel_images=pipes["pixels"],
                latents=jax_noise(3, 4, 16), **kw)
    _close(out, pipes["ref2"], what="stage 2")
    cond = pipe2.conditioning(image=pipes["image"],
                              pixel_images=pipes["pixels"])
    assert cond.frames == 4 and cond.pinned is None
    assert tuple(cond.pixels.shape) == (8, 4, 16, 16) and not bool(
        cond.pixels[:4].any())
    with pytest.raises(ValueError, match="pixel_images"):
        pipe2(image=pipes["image"], num_inference_steps=1)
    with pytest.warns(UserWarning, match="pixel_images"):
        c = pipes["pipe"].conditioning(image=pipes["image"],
                                       pixel_images=pipes["pixels"])
    assert c.pixels is None and c.frames == 5


def _ldm_vae_keys(vcfg):
    """An LDM `AutoencoderKL`'s keys at `vcfg`'s widths, (name, kind)."""
    keys, n = [], len(vcfg.block_out_channels)

    def res(base, cin, cout):
        for sub in ("norm1", "norm2"):
            fx._wb(f"{base}.{sub}", "raw", keys)
        for sub in ("conv1", "conv2"):
            fx._wb(f"{base}.{sub}", "conv", keys)
        if cin != cout:
            fx._wb(f"{base}.nin_shortcut", "conv", keys)

    def mid(side, ch):
        res(f"{side}.mid.block_1", ch, ch)
        res(f"{side}.mid.block_2", ch, ch)
        fx._wb(f"{side}.mid.attn_1.norm", "raw", keys)
        for sub in ("q", "k", "v", "proj_out"):
            fx._wb(f"{side}.mid.attn_1.{sub}", "conv1x1", keys)

    ch = vcfg.block_out_channels
    for side in ("encoder", "decoder"):
        for sub, kind in (("conv_in", "conv"), ("conv_out", "conv"),
                          ("norm_out", "raw")):
            fx._wb(f"{side}.{sub}", kind, keys)
        mid(side, ch[-1])
    cur = ch[0]
    for i in range(n):
        for j in range(vcfg.layers_per_block):
            res(f"encoder.down.{i}.block.{j}", cur, ch[i])
            cur = ch[i]
        if i < n - 1:
            fx._wb(f"encoder.down.{i}.downsample.conv", "conv", keys)
    cur = ch[-1]
    for level in reversed(range(n)):
        for j in range(vcfg.layers_per_block + 1):
            res(f"decoder.up.{level}.block.{j}", cur, ch[level])
            cur = ch[level]
        if level > 0:
            fx._wb(f"decoder.up.{level}.upsample.conv", "conv", keys)
    fx._wb("quant_conv", "conv", keys)
    fx._wb("post_quant_conv", "conv", keys)
    return keys


def _ip_unet_keys(raw, depth):
    """`ldm_unet_keys` with ImageDream's IP projections and Resampler."""
    keys = ldm_unet_keys(raw["channel_mult"], raw["num_res_blocks"], {0})
    keys += [(k.replace("attn2.to_k.", f"attn2.to_{p}_ip."), "linear")
             for k, _ in keys if "attn2.to_k.weight" in k for p in "kv"]
    keys += [("image_embed.latents", "raw")]
    for name in ("proj_in", "proj_out"):
        fx._wb(f"image_embed.{name}", "linear", keys)
    fx._wb("image_embed.norm_out", "raw", keys)
    for i in range(depth):
        for n in ("norm1", "norm2"):
            fx._wb(f"image_embed.layers.{i}.0.{n}", "raw", keys)
        keys += [(f"image_embed.layers.{i}.0.{n}.weight", "linear")
                 for n in ("to_q", "to_kv", "to_out")]
        fx._wb(f"image_embed.layers.{i}.1.0", "raw", keys)
        keys += [(f"image_embed.layers.{i}.1.{n}.weight", "linear")
                 for n in (1, 3)]
    return keys


IP_RAW = {"in_channels": 4, "out_channels": 4, "model_channels": 32,
          "channel_mult": [1, 2], "num_res_blocks": 1,
          "attention_resolutions": [1], "num_head_channels": 16,
          "context_dim": 16, "camera_dim": 16, "image_size": 8, "ip_dim": IP}


def _ip_unet_state_dict(jcfg, rng):
    """An ImageDream UNet state dict in the LDM layout for `jcfg` (its keys
    held against `mv_unet_rules` as a bijection)."""
    rules = mv_unet_rules(jcfg.unet.layers_per_block)
    shapes = tiny_shapes(jcfg, vae=False)

    def flat_rules(k, v):
        tree, path, val = rules(k, v)
        return f"{tree}/{path}", val

    return fx.fabricate_state_dict(_ip_unet_keys(IP_RAW,
                                                 jcfg.resampler_depth),
                                   flat_rules, _zeros(shapes), rng)


def test_load_ldm_checkpoint_matches_jax(tmp_path):
    """A tiny single-file LDM checkpoint (an ImageDream UNet under
    `model.diffusion_model.`, an LDM VAE of four levels under
    `first_stage_model.`) loaded by both packages with `unet=` / `vae=`
    overrides: the same weights (the port's module loads strictly); the
    OpenCLIP renames on tiny towers: the text tower's empty-prompt states
    and the visual tower's penultimate states within 1e-4 of the largest
    value, in_proj split into q/k/v."""
    from comfy3d_tpu.models.mvdream.convert import config_from_mv_unet_json
    rng = np.random.default_rng(8)
    ucfg = dataclasses.replace(config_from_mv_unet_json(IP_RAW), mv_views=6)
    vcfg = dataclasses.replace(tiny_vae_cfg(), block_out_channels=(8, 8, 16,
                                                                   16))
    jcfg = dataclasses.replace(tiny_cfg(num_views=6), unet=ucfg, vae=vcfg,
                               resampler_depth=4, resampler_heads=12,
                               resampler_dim_head=64, ip_embed_dim=1280,
                               ip_weight=1.0)
    sd = {f"model.diffusion_model.{k}": v
          for k, v in _ip_unet_state_dict(jcfg, rng).items()}
    vae = AutoencoderKL(VAEConfig(**dataclasses.asdict(vcfg)))
    shapes = dict(vae.state_dict())
    for name, kind in _ldm_vae_keys(vcfg):
        port = tldm.ldm_vae_name(name)
        shape = tuple(shapes.pop(port).shape)
        if kind == "conv1x1":
            shape += (1, 1)
        sd[f"first_stage_model.{name}"] = rng.standard_normal(
            shape).astype(np.float32)
    assert not shapes                                   # a bijection
    path = str(tmp_path / "pixel-diffusion.pth")
    torch.save({"state_dict": {k: torch.as_tensor(v) for k, v in sd.items()}},
               path)
    over = dict(ip_dim=IP, prompt_dim=16)
    ref = jp.MVDreamPipeline.from_ldm_checkpoint(path, unet=ucfg, vae=vcfg,
                                                 **over)
    pcfg = port_cfg(ref.cfg)
    pipe = MVDreamPipeline.from_ldm_checkpoint(
        path, device="cpu", unet=pcfg.unet, vae=pcfg.vae, **over)
    assert (pipe.cfg.num_views, pipe.cfg.image_size) == \
        (ref.cfg.num_views, ref.cfg.image_size) == (6, 256)
    _assert_state_dict(pipe.model,
                       convert.mvdream_state_dict_from_flax(ref.params))
    assert pipe.vision_encoder is None and pipe.default_prompt_embeds is None

    # the OpenCLIP towers, tiny: text (3 blocks, the last dropped) and visual
    oc = {}
    w, pre = 8, "cond_stage_model.model."

    def blocks(prefix, n, width):
        for i in range(n):
            b = f"{prefix}transformer.resblocks.{i}."
            for sub, shape in (("ln_1.weight", (width,)),
                               ("ln_1.bias", (width,)),
                               ("attn.in_proj_weight", (3 * width, width)),
                               ("attn.in_proj_bias", (3 * width,)),
                               ("attn.out_proj.weight", (width, width)),
                               ("attn.out_proj.bias", (width,)),
                               ("ln_2.weight", (width,)),
                               ("ln_2.bias", (width,)),
                               ("mlp.c_fc.weight", (2 * width, width)),
                               ("mlp.c_fc.bias", (2 * width,)),
                               ("mlp.c_proj.weight", (width, 2 * width)),
                               ("mlp.c_proj.bias", (width,))):
                oc[b + sub] = rng.standard_normal(shape) * 0.3

    blocks(pre, 3, w)
    oc.update({pre + "token_embedding.weight": rng.standard_normal(
                   (49408, w)) * 0.3,
               pre + "positional_embedding": rng.standard_normal((77, w)),
               pre + "ln_final.weight": 1 + 0.1 * rng.standard_normal(w),
               pre + "ln_final.bias": rng.standard_normal(w) * 0.1,
               pre + "text_projection": rng.standard_normal((w, w))})
    vpre = pre + "visual."
    blocks(vpre, 3, w)
    oc.update({vpre + "conv1.weight": rng.standard_normal((w, 3, 14, 14))
               * 0.05,
               vpre + "class_embedding": rng.standard_normal(w),
               vpre + "positional_embedding": rng.standard_normal((5, w)),
               vpre + "ln_pre.weight": 1 + 0.1 * rng.standard_normal(w),
               vpre + "ln_pre.bias": rng.standard_normal(w) * 0.1,
               vpre + "ln_post.weight": np.ones(w),
               vpre + "ln_post.bias": np.zeros(w),
               vpre + "proj": rng.standard_normal((w, 6))})
    oc = {k: np.asarray(v, np.float32) for k, v in oc.items()}
    toc = {k: torch.as_tensor(v) for k, v in oc.items()}
    text_kw = dict(hidden=w, heads=2, mlp_dim=2 * w, total_layers=3)
    _close(tldm.encode_empty_prompt_openclip(toc, device="cpu", **text_kw),
           jldm.encode_empty_prompt_openclip(oc, **text_kw), what="text")
    vis_cfg = dict(hidden=w, layers=3, heads=2, mlp_dim=2 * w,
                   image_size=28, patch=14, act="gelu")
    enc = clip.CLIPVisionEncoder(clip.CLIPVisionConfig(**vis_cfg,
                                                       projection_dim=6))
    sd_v = tldm.open_clip_visual_state_dict(toc)
    assert torch.equal(sd_v["encoder.layers.1.self_attn.k_proj.weight"],
                       toc[vpre + "transformer.resblocks.1.attn."
                           "in_proj_weight"][w:2 * w])
    enc = _load(enc, sd_v)
    img = rng.random((1, 30, 30, 3)).astype(np.float32)
    jref = jclip.make_vision_hidden_conditioner(
        jldm.convert_open_clip_visual(oc),
        jclip.CLIPVisionConfig(**vis_cfg))(img)
    with torch.no_grad():
        _close(clip.make_vision_hidden_conditioner(enc)(img), jref,
               what="visual")


def test_imagedream_dir_from_pretrained_matches_jax(tmp_path, monkeypatch):
    """An imagedream-ipmv-diffusers-layout directory (unet/ with the IP
    projections and the Resampler, vae/, a `gelu` text_encoder/, a
    CLIPVisionModel image_encoder/) through `from_pretrained` and through
    the Load_Diffusers_Pipeline node's MVDreamPipeline factory: the weights
    equal the JAX loader's, the empty prompt's embedding and the vision
    hook's penultimate states within 1e-4 of their largest value, and the
    pipeline runs on an image."""
    import comfy3d_tpu_torch.nodes as tnodes
    from comfy3d_tpu.models.clip import clip_rules
    from comfy3d_tpu_torch.nodes import base as tbase
    rng = np.random.default_rng(9)
    root = tmp_path / "Diffusers" / "ashawkey" / "imagedream-ipmv-diffusers"
    from comfy3d_tpu.models.mvdream.convert import config_from_mv_unet_json
    ucfg = dataclasses.replace(config_from_mv_unet_json(IP_RAW), mv_views=4)
    jcfg = dataclasses.replace(tiny_cfg(), unet=ucfg, ip_weight=1.0,
                               resampler_depth=4, resampler_heads=12,
                               resampler_dim_head=64, ip_embed_dim=1280)
    fx.write_component(str(root / "unet"), IP_RAW,
                       _ip_unet_state_dict(jcfg, rng))
    write_vae(str(root / "vae"), rng)
    write_clip_text(str(root / "text_encoder"), "gelu", rng)
    # ViT-H's width (the Resampler's input) at one layer: the penultimate
    # states are the embeddings after the pre-LayerNorm
    vraw = {"hidden_size": 1280, "num_hidden_layers": 1,
            "num_attention_heads": 16, "intermediate_size": 32,
            "image_size": 28, "patch_size": 14, "projection_dim": 8,
            "hidden_act": "gelu"}
    vshapes = jax.eval_shape(
        jclip.CLIPVisionEncoder(jclip.CLIPVisionConfig(
            hidden=1280, layers=1, heads=16, mlp_dim=32, image_size=28,
            patch=14, projection_dim=8, act="gelu")).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3)))["params"]
    vsd = fx.fabricate_state_dict(fx.enumerate_clip_keys(1, True),
                                  clip_rules(), _zeros(vshapes), rng)
    fx.write_component(str(root / "image_encoder"), vraw, vsd,
                       "model.safetensors")

    ref = jp.MVDreamPipeline.from_pretrained(str(root))
    pipe = MVDreamPipeline.from_pretrained(str(root), device="cpu")
    assert pipe.cfg.ip_dim == ref.cfg.ip_dim == IP
    _assert_state_dict(pipe.model,
                       convert.mvdream_state_dict_from_flax(ref.params))
    _close(pipe.default_prompt_embeds, ref.default_prompt_embeds,
           what="prompt")
    img = rng.random((36, 36, 3)).astype(np.float32)
    with torch.no_grad():
        hid = pipe.vision_encoder(img)
    _close(hid, ref.vision_encoder(img), what="vision hook")
    assert tuple(hid.shape) == (1, 5, 1280)

    monkeypatch.setattr(tbase, "CKPT_ROOT_PATH", str(tmp_path))
    loader = tnodes.NODE_CLASS_MAPPINGS["[Comfy3D] Load Diffusers Pipeline"]
    with tbase.run_device("cpu"):
        (node_pipe,) = loader().load_diffusers_pipe(
            "MVDreamPipeline", "ashawkey/imagedream-ipmv-diffusers")
    _assert_state_dict(node_pipe.model, pipe.model.state_dict())
    views = node_pipe(image=img, num_inference_steps=1)
    assert tuple(views.shape) == (4, 16, 16, 3)
    assert bool(torch.isfinite(views).all())
