"""Port parity, CLIP's text encoder and the checkpoint loaders of configs
3 and 4: `CLIPTextEncoder` and `make_text_conditioner` on random token ids
and the empty prompt, `Zero123PlusPipeline.from_pretrained` and
`MVDreamPipeline.from_pretrained` on diffusers directories the tests write
(MVDream's unet/ in the LDM layout) and `LGMPipeline.from_pretrained` on a
checkpoint file, `comfy3d_tpu_torch` against `comfy3d_tpu`. Each loaded
model's state dict must equal what `convert.*_state_dict_from_flax` makes
of the JAX loader's params for the same files: the port reads the native
names, the JAX package converts them with its rule tables
(`clip_rules`, `unet_rules`, `vae_rules`, `mv_unet_rules`,
`convert_lgm`)."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import diffusers_fixture as fx
from comfy3d_tpu.models import clip as jclip
from comfy3d_tpu.models.diffusion import convert as dconv
from comfy3d_tpu.models.diffusion.unet import UNet2DCondition as JUNet
from comfy3d_tpu.models.diffusion.vae import AutoencoderKL as JVAE
from comfy3d_tpu.models.lgm.pipeline import LGMPipeline as JLGMPipeline
from comfy3d_tpu.models.mvdream import pipeline as jmv
from comfy3d_tpu.models.mvdream.convert import (config_from_mv_unet_json,
                                                mv_unet_rules)
from comfy3d_tpu.models.zero123plus import Zero123PlusPipeline as JZ123
from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.models import clip
from comfy3d_tpu_torch.models.lgm import LGMPipeline
from comfy3d_tpu_torch.models.lgm import model as tlm
from comfy3d_tpu_torch.models.mvdream import MVDreamPipeline
from comfy3d_tpu_torch.models.zero123plus import Zero123PlusPipeline

from tests.test_torch_common import (QUICK_XLA, _np, _params,
                                     one_torch_thread)  # noqa: F401
from tests.test_torch_lgm import TINY as LGM_TINY

REL = 1e-5        # outputs against the JAX package, of their largest value


def _close(out, ref, what=""):
    out, ref = _np(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    assert np.abs(out - ref).max() <= REL * np.abs(ref).max(), what


def _assert_state_dict(module, sd):
    """The module's state dict is `sd`, name for name, value for value."""
    got = module.state_dict()
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], torch.as_tensor(np.asarray(v))), k


def _zeros(shapes):
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)


def text_cfg(act, eos=49407):
    return {"architectures": ["CLIPTextModel"], "hidden_size": 16,
            "num_hidden_layers": 2, "num_attention_heads": 2,
            "intermediate_size": 32, "max_position_embeddings": 77,
            "vocab_size": 49408, "hidden_act": act, "eos_token_id": eos}


def write_clip_text(path, act, rng):
    """A CLIPTextModel directory in transformers' layout."""
    raw = text_cfg(act)
    jcfg = jclip.CLIPTextConfig(hidden=16, layers=2, heads=2, mlp_dim=32,
                                act=act)
    shapes = jax.eval_shape(jclip.CLIPTextEncoder(jcfg).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 77), jnp.int32))["params"]
    sd = fx.fabricate_state_dict(fx.enumerate_clip_keys(2, False),
                                 jclip.clip_rules(), _zeros(shapes), rng)
    fx.write_component(path, raw, sd, weights_name="model.safetensors")


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_text_encoder_matches_jax(act):
    """2 layers: the hidden states and the EOS-pooled state of random ids
    and of the empty prompt (padded with EOS, or with "!" for a `gelu`
    encoder), and the conditioner's output, within 1e-5 of the largest
    value; the empty prompt's ids are the JAX package's."""
    jcfg = jclip.CLIPTextConfig(hidden=16, layers=2, heads=2, mlp_dim=32,
                                act=act)
    tcfg = clip.CLIPTextConfig(**dataclasses.asdict(jcfg))
    params = _params(jclip.CLIPTextEncoder(jcfg),
                     jnp.zeros((1, 77), jnp.int32), seed=3)
    model = clip.CLIPTextEncoder(tcfg)
    model.load_state_dict(convert.clip_text_state_dict_from_flax(params),
                          strict=True)
    model.eval()
    pad = 0 if act == "gelu" else 49407
    empty = clip.empty_prompt_ids(77, pad_token_id=pad)
    assert np.array_equal(_np(empty),
                          jclip.empty_prompt_ids(77, pad_token_id=pad))
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 49406, (2, 77))
    ids[0, 9], ids[1, 40] = 49407, 49407
    ids = np.concatenate([ids, _np(empty)])
    ref = jax.jit(jclip.CLIPTextEncoder(jcfg).apply,
                  compiler_options=QUICK_XLA)({"params": params},
                                              jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        out = model(torch.as_tensor(ids))
        cond = clip.make_text_conditioner(model)(torch.as_tensor(ids))
    _close(out[0], ref[0], "hidden")
    _close(out[1], ref[1], "pooled")
    _close(cond, ref[0], "conditioner")


UNET_CFG = {
    "in_channels": 4, "out_channels": 4, "block_out_channels": [8, 16],
    "layers_per_block": 2, "cross_attention_dim": 16,
    "attention_head_dim": 4, "norm_num_groups": 4,
    "use_linear_projection": True,
    "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
    "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"]}
VAE_CFG = {"in_channels": 3, "latent_channels": 4,
           "block_out_channels": [8, 16], "layers_per_block": 1,
           "norm_num_groups": 4, "scaling_factor": 0.18215}
VISION_CFG = {"architectures": ["CLIPVisionModelWithProjection"],
              "hidden_size": 8, "num_hidden_layers": 2,
              "num_attention_heads": 2, "intermediate_size": 16,
              "image_size": 28, "patch_size": 14, "projection_dim": 16,
              "hidden_act": "gelu"}


def write_vae(path, rng):
    shapes = jax.eval_shape(JVAE(dconv.vae_config_from_json(VAE_CFG)).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3)))["params"]
    keys = fx.enumerate_vae_keys(VAE_CFG["block_out_channels"],
                                 VAE_CFG["layers_per_block"])
    fx.write_component(path, VAE_CFG, fx.fabricate_state_dict(
        keys, dconv.vae_rules(), _zeros(shapes), rng))


@pytest.fixture(scope="module")
def zero123plus_dir(tmp_path_factory):
    """A sudo-ai/zero123plus-v1.2-layout directory: model_index.json with
    ramping coefficients; unet/, vae/, text_encoder/ (gelu: padded with
    "!") and vision_encoder/ in diffusers' and transformers' layouts."""
    root = tmp_path_factory.mktemp("zero123plus-v1.2")
    rng = np.random.default_rng(0)
    ucfg = dconv.unet_config_from_json(UNET_CFG)
    shapes = jax.eval_shape(JUNet(ucfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 12, 8, 4)), jnp.zeros((1,)),
                            jnp.zeros((1, 77, 16)))["params"]
    keys = fx.enumerate_unet_keys(
        UNET_CFG["down_block_types"], UNET_CFG["up_block_types"],
        UNET_CFG["block_out_channels"], UNET_CFG["layers_per_block"])
    fx.write_component(str(root / "unet"), UNET_CFG, fx.fabricate_state_dict(
        keys, dconv.unet_rules(), _zeros(shapes), rng))
    write_vae(str(root / "vae"), rng)
    write_clip_text(str(root / "text_encoder"), "gelu", rng)
    vcfg = jclip.CLIPVisionConfig(hidden=8, layers=2, heads=2, mlp_dim=16,
                                  image_size=28, patch=14, projection_dim=16,
                                  act="gelu")
    shapes = jax.eval_shape(jclip.CLIPVisionEncoder(vcfg).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 28, 28, 3)))["params"]
    fx.write_component(
        str(root / "vision_encoder"), VISION_CFG, fx.fabricate_state_dict(
            fx.enumerate_clip_keys(2, True), jclip.clip_rules(),
            _zeros(shapes), rng), weights_name="model.safetensors")
    with open(root / "model_index.json", "w") as f:
        json.dump({"_class_name": "Zero123PlusPipeline",
                   "ramping_coefficients": np.linspace(0.0, 1.2, 77)
                   .tolist()}, f)
    return str(root)


def test_zero123plus_from_pretrained_matches_jax(zero123plus_dir):
    """The UNet and VAE equal the JAX loader's params through
    `convert.zero123plus_state_dict_from_flax`, the CLIP vision encoder
    its `load_clip_vision_dir` params through
    `convert.clip_vision_state_dict_from_flax`; the ramping coefficients
    equal, the empty prompt's embedding and the conditioner's output
    within 1e-5 of the largest value."""
    kw = dict(height=24, width=16, cond_size=16)
    ref = JZ123.from_pretrained(zero123plus_dir, **kw)
    pipe = Zero123PlusPipeline.from_pretrained(zero123plus_dir,
                                               device="cpu", **kw)
    assert pipe.cfg.unet.cross_attention_dim == 16 and \
        pipe.cfg.height == 24 and pipe.cfg.cond_size == 16
    _assert_state_dict(pipe.model,
                       convert.zero123plus_state_dict_from_flax(ref.params))
    assert np.array_equal(_np(pipe.ramping), np.asarray(ref.ramping))
    _close(pipe.prompt_embeds, ref.prompt_embeds, "empty prompt")
    _, vparams, _ = dconv.load_clip_vision_dir(
        os.path.join(zero123plus_dir, "vision_encoder"))
    enc = clip.CLIPVisionEncoder(clip.CLIPVisionConfig(
        hidden=8, layers=2, heads=2, mlp_dim=16, image_size=28, patch=14,
        projection_dim=16, act="gelu"))
    enc.load_state_dict(convert.clip_vision_state_dict_from_flax(vparams))
    img = np.random.RandomState(1).rand(16, 16, 3).astype(np.float32)
    with torch.no_grad():
        emb = pipe.vision_encoder(img)
    _close(emb, ref.vision_encoder(img), "vision conditioner")
    loaded = os.path.join(zero123plus_dir, "vision_encoder")
    from comfy3d_tpu_torch.models.diffusion.config import \
        load_clip_vision_dir
    _assert_state_dict(load_clip_vision_dir(loaded, device="cpu")[1],
                       enc.state_dict())


def ldm_unet_keys(mult, nrb, attn_levels):
    """The key layout of an LDM `MultiViewUNetModel` state dict with the
    camera MLP (`LGM/mvdream/mv_unet.py`): (name, kind) pairs as
    `diffusers_fixture` fabricates them."""
    keys = []

    def wb(name, kind):
        keys.extend([(name + ".weight", kind), (name + ".bias", "raw")])

    def res(base, shortcut):
        for sub, kind in (("in_layers.0", "raw"), ("in_layers.2", "conv"),
                          ("emb_layers.1", "linear"),
                          ("out_layers.0", "raw"), ("out_layers.3", "conv")):
            wb(f"{base}.{sub}", kind)
        if shortcut:
            wb(f"{base}.skip_connection", "conv")

    def attn(base):
        wb(base + ".norm", "raw")
        wb(base + ".proj_in", "linear")
        tb = base + ".transformer_blocks.0"
        for a in ("attn1", "attn2"):
            for p in ("to_q", "to_k", "to_v"):
                keys.append((f"{tb}.{a}.{p}.weight", "linear"))
            wb(f"{tb}.{a}.to_out.0", "linear")
        for n in ("norm1", "norm2", "norm3"):
            wb(f"{tb}.{n}", "raw")
        wb(f"{tb}.ff.net.0.proj", "linear")
        wb(f"{tb}.ff.net.2", "linear")
        wb(base + ".proj_out", "linear")

    wb("time_embed.0", "linear")
    wb("time_embed.2", "linear")
    wb("input_blocks.0.0", "conv")
    i = 1
    for level, m in enumerate(mult):
        for j in range(nrb):
            res(f"input_blocks.{i}.0",
                j == 0 and level > 0 and m != mult[level - 1])
            if level in attn_levels:
                attn(f"input_blocks.{i}.1")
            i += 1
        if level != len(mult) - 1:
            wb(f"input_blocks.{i}.0.op", "conv")
            i += 1
    res("middle_block.0", False)
    attn("middle_block.1")
    res("middle_block.2", False)
    i = 0
    for level in reversed(range(len(mult))):
        for j in range(nrb + 1):
            res(f"output_blocks.{i}.0", True)
            if level in attn_levels:
                attn(f"output_blocks.{i}.1")
            if j == nrb and level != 0:
                wb(f"output_blocks.{i}.{2 if level in attn_levels else 1}"
                   ".conv", "conv")
            i += 1
    wb("out.0", "raw")
    wb("out.2", "conv")
    wb("camera_embed.0", "linear")
    wb("camera_embed.2", "linear")
    return keys


MV_RAW = {"in_channels": 4, "out_channels": 4, "model_channels": 32,
          "channel_mult": [1, 2], "num_res_blocks": 1,
          "attention_resolutions": [1], "num_head_channels": 16,
          "context_dim": 16, "camera_dim": 16, "image_size": 8}


def write_mvdream_dir(root, rng, raw=MV_RAW):
    """An mvdream-sd2.1-diffusers-layout directory: unet/ in the LDM layout
    (its keys held against `mv_unet_rules` as a bijection), vae/ and a
    `quick_gelu` text_encoder/ (padded with EOS)."""
    ucfg = dataclasses.replace(config_from_mv_unet_json(raw), mv_views=4)
    emb = ucfg.block_out_channels[0] * 4
    z, key = jnp.zeros, jax.random.PRNGKey(0)
    shapes = {
        "unet": jax.eval_shape(JUNet(ucfg).init, key, z((4, 8, 8, 4)),
                               z((4,)), z((4, 77, 16)),
                               class_emb=z((4, emb)))["params"],
        "camera": jax.eval_shape(jmv.CameraEmbed(emb).init, key,
                                 z((1, 16)))["params"]}
    rules = mv_unet_rules(raw["num_res_blocks"])

    def flat_rules(k, v):
        tree, path, val = rules(k, v)
        return f"{tree}/{path}", val

    keys = ldm_unet_keys(raw["channel_mult"], raw["num_res_blocks"], {0})
    sd = fx.fabricate_state_dict(keys, flat_rules, _zeros(shapes), rng)
    fx.write_component(os.path.join(root, "unet"), raw, sd)
    write_vae(os.path.join(root, "vae"), rng)
    write_clip_text(os.path.join(root, "text_encoder"), "quick_gelu", rng)


def test_mvdream_from_pretrained_matches_jax(tmp_path):
    """The LDM-layout UNet with the camera MLP, and the VAE, equal the JAX
    loader's params through `convert.mvdream_state_dict_from_flax` (the
    port's renames against `mv_unet_rules`); the default prompt and
    negative embeddings, the empty prompt's, within 1e-5 of the largest
    value."""
    write_mvdream_dir(str(tmp_path), np.random.default_rng(1))
    ref = jmv.MVDreamPipeline.from_pretrained(str(tmp_path))
    pipe = MVDreamPipeline.from_pretrained(str(tmp_path), device="cpu")
    assert pipe.cfg.image_size == ref.cfg.image_size == 16
    assert pipe.cfg.unet.down_block_types == ref.cfg.unet.down_block_types
    _assert_state_dict(pipe.model,
                       convert.mvdream_state_dict_from_flax(ref.params))
    _close(pipe.default_prompt_embeds, ref.default_prompt_embeds, "prompt")
    _close(pipe.default_negative_embeds, ref.default_negative_embeds,
           "negative")
    views = pipe(num_inference_steps=2, guidance_scale=5.0)
    assert tuple(views.shape) == (4, 16, 16, 3)
    assert bool(torch.isfinite(views).all())


def test_imagedream_checkpoint_raises(tmp_path):
    """An ImageDream unet/ (`ip_dim` > 0) raises, naming ROADMAP A.6.4,
    before any weights are read."""
    os.makedirs(tmp_path / "unet")
    with open(tmp_path / "unet" / "config.json", "w") as f:
        json.dump({**MV_RAW, "ip_dim": 16}, f)
    with pytest.raises(NotImplementedError, match="A.6.4"):
        MVDreamPipeline.from_pretrained(str(tmp_path), device="cpu")


def test_lgm_from_pretrained_matches_jax(tmp_path):
    """A checkpoint file in LGM's own names (the port's module's): the port
    loads it as it is, the JAX package's `convert_lgm` into params that
    `convert.lgm_state_dict_from_flax` takes back to the same tensors."""
    from safetensors.torch import save_file
    from comfy3d_tpu.models.lgm import model as jlm
    cfg = tlm.LGMConfig(**LGM_TINY)
    gen = torch.Generator().manual_seed(5)
    sd = {k: torch.randn(v.shape, generator=gen)
          for k, v in tlm.LGMUNet(cfg).state_dict().items()}
    path = str(tmp_path / "model_fp16.safetensors")
    save_file({k: v.half() for k, v in sd.items()}, path)
    sd = {k: v.half().float() for k, v in sd.items()}
    pipe = LGMPipeline.from_pretrained(path, cfg=cfg, device="cpu")
    _assert_state_dict(pipe.model, sd)
    ref = JLGMPipeline.from_pretrained(path, cfg=jlm.LGMConfig(**LGM_TINY))
    back = convert.lgm_state_dict_from_flax(ref.params)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
