"""Port parity, TripoSG image / scribble → mesh: the DiT with its skip
blocks, the VAE (encode, the decoder's kv cache and the SDF query),
`sample_latents` + `latents_to_mesh` with shared draws, `from_pretrained`
on upstream's directory layout against the JAX loader on the same files,
the full config's parameter counts, and the two node graphs,
`comfy3d_tpu_torch` against `comfy3d_tpu` on the same numpy inputs and
weights (flax params carried across by
`convert.triposg_state_dict_from_flax`, which writes upstream's names and
head-major attention packing). The scribble path repairs ROADMAP §C.10 in
the port: it runs the DiT's conditional pass alone, where the JAX package
blends at guidance 0 and so ignores the scribble."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from comfy3d_tpu.models.dinov2 import Dinov2 as JDinov2
from comfy3d_tpu.models.triposg import dit as jd
from comfy3d_tpu.models.triposg import pipeline as jp
from comfy3d_tpu.models.triposg import vae as jv

from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.core.mesh import Mesh
from comfy3d_tpu_torch.models import dinov2 as td
from comfy3d_tpu_torch.models.triposg import dit as tdit
from comfy3d_tpu_torch.models.triposg import pipeline as tp
from comfy3d_tpu_torch.models.triposg import vae as tvae

from tests.test_torch_common import (QUICK_XLA, _load, _np, _params,
                                     one_torch_thread)  # noqa: F401

# single passes against the JAX package: within REL of the largest value;
# sampled latents and decoded grids within REL_STEPS
REL = 1e-5
REL_STEPS = 1e-4


def _close(out, ref, rel=REL, what=""):
    out, ref = _np(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())


def _port_cfg(jcfg) -> tp.TripoSGConfig:
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["dit"] = tdit.TripoSGDiTConfig(**dataclasses.asdict(jcfg.dit))
    kw["vae"] = tvae.TripoSGVAEConfig(**dataclasses.asdict(jcfg.vae))
    kw["cond"] = td.Dinov2Config(**dataclasses.asdict(jcfg.cond))
    return tp.TripoSGConfig(**kw)


def _vae_all(self, lat, pts, x_q, x_kv):
    """Every VAE path, so a param tree by shape holds the encoder too."""
    return self.encode(x_q, x_kv), self.init_all(lat, pts)


def jax_params(cfg, seed):
    """The JAX TripoSG params of `cfg`, by shape and redrawn
    (`_params`), the VAE's encoder included."""
    s, nl, vc = cfg.image_size, cfg.vae.num_latents, cfg.vae
    d = vc.embed_out_dim + 3
    return {
        "cond": _params(JDinov2(cfg.cond), jnp.zeros((1, s, s, 3)),
                        seed=seed),
        "dit": _params(jd.TripoSGDiT(cfg.dit),
                       jnp.zeros((1, nl, cfg.dit.in_channels)),
                       jnp.zeros((1,)),
                       jnp.zeros((1, 5, cfg.dit.cross_attention_dim)),
                       seed=seed + 1),
        "vae": _params(jv.TripoSGVAE(vc), jnp.zeros((1, nl,
                                                     vc.latent_channels)),
                       jnp.zeros((1, 7, 3)), jnp.zeros((1, 4, d)),
                       jnp.zeros((1, 6, d)), method=_vae_all, seed=seed + 2)}


def port_pipe(jcfg, params) -> tp.TripoSGPipeline:
    cfg = _port_cfg(jcfg)
    model = tp.TripoSG(cfg)
    model.load_state_dict(convert.triposg_state_dict_from_flax(
        params, cfg.dit.heads, cfg.vae.heads), strict=True)
    return tp.TripoSGPipeline(model)


def jax_noise(cfg, seed, batch=1):
    return np.asarray(jax.random.normal(
        jax.random.PRNGKey(seed),
        (batch, cfg.vae.num_latents, cfg.vae.latent_channels)))


@pytest.fixture(scope="module")
def tiny():
    """`TripoSGConfig.tiny()` in both packages on one set of weights."""
    jcfg = jp.TripoSGConfig.tiny()
    params = jax_params(jcfg, 40)
    return jcfg, params, jp.TripoSGPipeline(params, jcfg), \
        port_pipe(jcfg, params)


def test_dit_matches_jax():
    """The DiT at `tiny()`'s widths with 3 and 5 blocks (the middle block,
    then the skip blocks popping the stack), bias-free qkv with RMS
    qk-norm: the velocity within 1e-5 of its largest value; the skip
    blocks are the second half's, and `DiTBlock` alone (no self-attention,
    a LayerNorm on the cross-attention's context) matches too."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 10, 8).astype(np.float32)
    t = np.array([100.0, 900.0], np.float32)
    ctx = rng.randn(2, 4, 16).astype(np.float32)
    cases = [jd.TripoSGDiTConfig(width=32, in_channels=8, num_layers=n,
                                 heads=2, cross_attention_dim=16)
             for n in (3, 5)]
    block = jd.DiTBlock(cases[0], self_attn=False, qk_norm=False,
                        cross_norm=True)
    h = rng.randn(2, 6, 32).astype(np.float32)
    params = [_params(jd.TripoSGDiT(c), x, t, ctx, seed=i)
              for i, c in enumerate(cases)]
    bparams = _params(block, h, ctx, seed=9)
    refs, bref = jax.jit(lambda ps, bp: (
        [jd.TripoSGDiT(c).apply({"params": p}, x, t, ctx)
         for c, p in zip(cases, ps)],
        block.apply({"params": bp}, h, ctx)),
        compiler_options=QUICK_XLA)(params, bparams)
    for c, p, ref in zip(cases, params, refs):
        tc = tdit.TripoSGDiTConfig(**dataclasses.asdict(c))
        port = _load(tdit.TripoSGDiT(tc),
                     convert.triposg_dit_state_dict_from_flax(p, c.heads))
        skips = [i for i, b in enumerate(port.blocks)
                 if b.skip_linear is not None]
        assert skips == list(range(c.num_layers // 2 + 1, c.num_layers))
        with torch.no_grad():
            out = port(*map(torch.as_tensor, (x, t, ctx)))
        _close(out, ref, what=f"dit {c.num_layers}")
    tb = tdit.DiTBlock(tdit.TripoSGDiTConfig(
        **dataclasses.asdict(cases[0])), self_attn=False, qk_norm=False,
        cross_norm=True)
    _load(tb, convert._tensors(convert._triposg_block_state_dict(bparams, 2)))
    with torch.no_grad():
        _close(tb(torch.as_tensor(h), torch.as_tensor(ctx)), bref,
               what="block")


def test_vae_matches_jax():
    """The VAE with 2 + 2 blocks: `encode` (one cross-attention block with
    its context LayerNorm, then self-attention), the decoder's kv cache and
    the sign-flipped SDF query of frequency-embedded points within 1e-5 of
    the largest value; `freq_embed` equal to the JAX package's, with and
    without π."""
    rng = np.random.RandomState(1)
    vc = jv.TripoSGVAEConfig(latent_channels=8, num_latents=16, heads=2,
                             width_encoder=16, width_decoder=32,
                             num_layers_encoder=2, num_layers_decoder=2)
    lat = rng.randn(2, 16, 8).astype(np.float32)
    pts = (rng.rand(2, 30, 3) * 2.2 - 1.1).astype(np.float32)
    x_q = rng.randn(2, 5, 54).astype(np.float32)
    x_kv = rng.randn(2, 9, 54).astype(np.float32)
    m = jv.TripoSGVAE(vc)
    p = _params(m, lat, pts, x_q, x_kv, method=_vae_all, seed=3)

    def refs(p):
        dec = m.apply({"params": p}, lat)
        return (m.apply({"params": p}, x_q, x_kv, method=jv.TripoSGVAE.encode),
                dec, m.apply({"params": p}, dec, pts,
                             method=jv.TripoSGVAE.query))

    enc_j, dec_j, q_j = jax.jit(refs, compiler_options=QUICK_XLA)(p)
    port = _load(tvae.TripoSGVAE(tvae.TripoSGVAEConfig(
        **dataclasses.asdict(vc))),
        convert.triposg_vae_state_dict_from_flax(p, vc.heads))
    with torch.no_grad():
        enc = port.encode(torch.as_tensor(x_q), torch.as_tensor(x_kv))
        dec = port(torch.as_tensor(lat))
        q = port.query(dec, torch.as_tensor(pts))
    _close(enc, enc_j, what="encode")
    _close(dec, dec_j, what="decoded")
    _close(q, q_j, what="query")
    for pi in (False, True):
        np.testing.assert_allclose(
            _np(tvae.freq_embed(torch.as_tensor(pts), 8, pi)),
            np.asarray(jv.freq_embed(jnp.asarray(pts), 8, pi)), rtol=0,
            atol=1e-6)


def test_sample_latents_and_mesh_match_jax(tiny):
    """`tiny()`'s pipeline on a 40² image (resized to 28²): the
    conditioning tokens (zeros for the uncond half), `sample_latents` from
    the JAX package's `PRNGKey(seed)` noise over 3 steps at guidance 7 and
    shift 1 and at shift 3, within 1e-4 of the largest value;
    `latents_to_mesh` of JAX's latents at octree 32 (the dense 33³ grid):
    the meshes triangle for triangle; the schedule's σ equals the JAX
    package's float32 values."""
    jcfg, params, jpipe, tpipe = tiny
    img = np.random.RandomState(2).rand(40, 40, 3).astype(np.float32)
    noise = jax_noise(jcfg, 5)
    shifted = dataclasses.replace(jcfg, shift=3.0)
    jshift = jp.TripoSGPipeline(params, shifted)
    cond_j = jpipe.encode_cond(img)
    lat_j = jpipe._sample(params["dit"], cond_j, jnp.asarray(noise), 3,
                          jnp.float32(7.0))
    lat_s = jshift._sample(params["dit"], cond_j, jnp.asarray(noise), 3,
                           jnp.float32(7.0))
    cond = tpipe.encode_cond(img)
    _close(cond, cond_j, what="cond")
    assert not bool(cond[1:].any())
    _close(tpipe.sample_latents(img, draws=noise), lat_j, REL_STEPS,
           "latents")
    tshift = tp.TripoSGPipeline(tpipe.model)
    tshift.cfg = dataclasses.replace(tpipe.cfg, shift=3.0)
    _close(tshift.sample_latents(img, draws=noise), lat_s, REL_STEPS,
           "latents shift 3")
    mesh_j = jpipe.latents_to_mesh(lat_j, octree_resolution=32,
                                   num_chunks=4096)[0]
    mesh = tpipe.latents_to_mesh(np.asarray(lat_j), octree_resolution=32,
                                 num_chunks=4096)[0]
    assert mesh.num_faces > 0
    _close(mesh.v[mesh.f], np.asarray(mesh_j.v)[np.asarray(mesh_j.f)],
           REL_STEPS, "mesh")
    sig = tp.flow_sigmas(3, 3.0)
    s = np.linspace(1.0, 0.0, 4)
    np.testing.assert_array_equal(sig, jnp.asarray(
        3.0 * s / (1.0 + 2.0 * s), jnp.float32))


def _write_dir(root, cfg, sd):
    """Upstream's TripoSG layout under `root`: transformer/, vae/ and
    image_encoder_dinov2/, each a config.json beside safetensors weights."""
    from safetensors.torch import save_file
    parts = {
        "transformer": ("dit", dict(
            width=cfg.dit.width, in_channels=cfg.dit.in_channels,
            num_layers=cfg.dit.num_layers,
            num_attention_heads=cfg.dit.heads,
            cross_attention_dim=cfg.dit.cross_attention_dim),
            "diffusion_pytorch_model.safetensors"),
        "vae": ("vae", dict(
            latent_channels=cfg.vae.latent_channels,
            num_attention_heads=cfg.vae.heads,
            width_encoder=cfg.vae.width_encoder,
            width_decoder=cfg.vae.width_decoder,
            num_layers_encoder=cfg.vae.num_layers_encoder,
            num_layers_decoder=cfg.vae.num_layers_decoder,
            embed_frequency=cfg.vae.num_freqs, embed_include_pi=False,
            in_channels=3), "diffusion_pytorch_model.safetensors"),
        "image_encoder_dinov2": ("cond", dict(
            hidden_size=cfg.cond.hidden, num_hidden_layers=cfg.cond.layers,
            num_attention_heads=cfg.cond.heads, patch_size=cfg.cond.patch,
            image_size=cfg.image_size, layer_norm_eps=1e-6),
            "model.safetensors")}
    for sub, (prefix, conf, fname) in parts.items():
        d = root / sub
        d.mkdir(parents=True)
        (d / "config.json").write_text(json.dumps(conf))
        save_file({k[len(prefix) + 1:]: v.contiguous() for k, v in sd.items()
                   if k.startswith(prefix + ".")}, str(d / fname))


def test_from_pretrained_and_counts_match_jax(tiny, tmp_path):
    """`TripoSGPipeline.from_pretrained` on upstream's layout that the test
    writes from the port's state dict (`convert.triposg_state_dict_from_flax`)
    and the JAX package's `from_pretrained` on the same files: the configs
    agree, and so do the conditioning, a DiT pass and the VAE's decode and
    query (within 1e-5 of the largest value); without image_encoder_dinov2/
    the conditioner is drawn. The full config's parameter counts on `meta`
    equal `chip_smoke.TRIPOSG_PARAMS` and the JAX package's (by shape at
    one to three layers, extended to the full depths; its VAE without the
    encoder, which its `init` never traces, and its DINOv2 without HF's
    `mask_token`)."""
    jcfg, params, _, tpipe = tiny
    _write_dir(tmp_path / "tsg", tpipe.cfg, tpipe.model.state_dict())
    jl = jp.TripoSGPipeline.from_pretrained(str(tmp_path / "tsg"))
    tl = tp.TripoSGPipeline.from_pretrained(str(tmp_path / "tsg"),
                                            device="cpu")
    assert dataclasses.asdict(tl.cfg.dit) == dataclasses.asdict(jl.cfg.dit)
    assert tl.cfg.image_size == jl.cfg.image_size == 28
    rng = np.random.RandomState(4)
    img = rng.rand(28, 28, 3).astype(np.float32)
    x = rng.randn(1, 6, 8).astype(np.float32)
    lat = rng.randn(1, 6, 8).astype(np.float32)
    pts = (rng.rand(1, 20, 3) * 2 - 1).astype(np.float32)
    cond_j = jl.encode_cond(img)

    def refs(p, cond):
        v = jl.dit.apply({"params": p["dit"]}, x, jnp.array([500.0]),
                         cond[:1])
        dec = jl.vae.apply({"params": p["vae"]}, lat)
        return v, jl.vae.apply({"params": p["vae"]}, dec, pts,
                               method=jv.TripoSGVAE.query)

    v_j, q_j = jax.jit(refs, compiler_options=QUICK_XLA)(jl.params, cond_j)
    with torch.no_grad():
        cond = tl.encode_cond(img)
        v = tl.model.dit(torch.as_tensor(x), torch.tensor([500.0]), cond[:1])
        q = tl.model.vae.query(tl.model.vae(torch.as_tensor(lat)),
                               torch.as_tensor(pts))
    _close(cond, cond_j, what="cond")
    _close(v, v_j, what="dit")
    _close(q, q_j, what="query")
    (tmp_path / "bare").mkdir()
    for sub in ("transformer", "vae"):
        (tmp_path / "tsg" / sub).rename(tmp_path / "bare" / sub)
    bare = tp.TripoSGPipeline.from_pretrained(str(tmp_path / "bare"),
                                              device="cpu",
                                              image_size=28, cond=tl.cfg.cond)
    assert not torch.equal(bare.model.cond.embeddings.cls_token,
                           tl.model.cond.embeddings.cls_token)

    with torch.device("meta"):
        full = tp.TripoSG(tp.TripoSGConfig())
    counts = {k: sum(p.numel() for p in getattr(full, k).parameters())
              for k in ("dit", "vae", "cond")}
    assert counts == chip_smoke.TRIPOSG_PARAMS
    enc = sum(p.numel() for m in (full.vae.encoder, full.vae.quant)
              for p in m.parameters())
    fc = jp.TripoSGConfig()
    nl, s = fc.vae.num_latents, fc.image_size

    def n(make, *args, method=None):
        """The parameters of the flax module `make()`, traced by shape."""
        return sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
            jax.eval_shape(lambda: make().init(jax.random.PRNGKey(0), *args,
                                               method=method))))

    # traced at 1-3 layers and extended: the DiT's blocks, its second
    # half's skip layers; the VAE's and DINOv2's layers
    dit = [n(lambda k=k: jd.TripoSGDiT(dataclasses.replace(fc.dit,
                                                           num_layers=k)),
             jnp.zeros((1, nl, fc.dit.in_channels)), jnp.zeros((1,)),
             jnp.zeros((1, 5, fc.dit.cross_attention_dim)))
           for k in (1, 2, 3)]
    block = dit[1] - dit[0]
    skip = dit[2] - dit[1] - block
    depth = fc.dit.num_layers
    vae = [n(lambda k=k: jv.TripoSGVAE(dataclasses.replace(
        fc.vae, num_layers_decoder=k)), jnp.zeros((1, nl,
                                                   fc.vae.latent_channels)),
        jnp.zeros((1, 7, 3)), method=jv.TripoSGVAE.init_all) for k in (1, 2)]
    cond = [n(lambda k=k: JDinov2(dataclasses.replace(fc.cond, layers=k)),
              jnp.zeros((1, s, s, 3))) for k in (1, 2)]
    jcounts = {
        "dit": dit[0] + (depth - 1) * block + (depth - depth // 2 - 1) * skip,
        "vae": vae[0] + (fc.vae.num_layers_decoder - 1) * (vae[1] - vae[0])
        + enc,
        "cond": cond[0] + (fc.cond.layers - 1) * (cond[1] - cond[0])
        + fc.cond.hidden}
    assert jcounts == counts


def _graph_env(tmp_path, monkeypatch, jpipe, model):
    """Both packages' node roots under tmp_path with the reference images;
    each package's TripoSG `init_random` returning the tiny pipelines (the
    port's a new pipeline on the shared model each call, so the scribble
    factory's flag stays its own) and the port's calls given the JAX
    package's noise."""
    from comfy3d_tpu.nodes import base as jbase
    from comfy3d_tpu.nodes import nodes_diffusers as jnd
    from comfy3d_tpu.nodes import nodes_mvdiffusion as jnm
    from comfy3d_tpu_torch.nodes import base as tbase
    for name, attr in (("in", "INPUT_ROOT_PATH"), ("out", "OUTPUT_ROOT_PATH"),
                       ("ckpt", "CKPT_ROOT_PATH")):
        (tmp_path / name).mkdir()
        for b in (jbase, tbase):
            monkeypatch.setattr(b, attr, str(tmp_path / name))
    monkeypatch.setattr(jnd, "CKPT_DIFFUSERS_PATH",
                        str(tmp_path / "ckpt" / "Diffusers"))
    monkeypatch.setattr(jnm, "_local_ckpt", lambda repo_id: None)
    chip_smoke.write_reference_images(str(tmp_path / "in"), 36)
    monkeypatch.setattr(jp.TripoSGPipeline, "init_random",
                        classmethod(lambda c, *a, **kw: jpipe))
    monkeypatch.setattr(tp.TripoSGPipeline, "init_random",
                        classmethod(lambda c, *a, **kw: tp.TripoSGPipeline(
                            model)))
    call = tp.TripoSGPipeline.__call__
    monkeypatch.setattr(tp.TripoSGPipeline, "__call__",
                        lambda self, image, seed=0, **kw: call(
                            self, image, seed,
                            draws=jax_noise(self.cfg, seed), **kw))


def test_i23d_graph_matches_jax(tiny, tmp_path, monkeypatch):
    """`chip_smoke.config_graph("triposg")` through both packages'
    `run_workflow` on the CPU: LoadImage (RGBA) → InvertMask → Load
    TripoSG Pipeline (the tiny pipeline) → TripoSG I23D Model (the image
    composited on white through its mask, 3 steps at guidance 7, dense
    octree depth 5) → Save 3D Mesh: the meshes triangle for triangle
    within 1e-4 of their largest value, the GLB read back."""
    from comfy3d_tpu.nodes import graph as jgraph
    from comfy3d_tpu_torch.nodes import graph as tgraph
    _, _, jpipe, tpipe = tiny
    _graph_env(tmp_path, monkeypatch, jpipe, tpipe.model)
    graph = chip_smoke.config_graph("triposg")
    overrides = {4: {"num_inference_steps": 3, "dense_octree_depth": 5}}
    jres = jgraph.run_workflow(graph, overrides)
    tres = tgraph.run_workflow(graph, overrides, device="cpu")
    mesh, jmesh = tres[4][0], jres[4][0]
    assert mesh.num_faces > 0
    _close(mesh.v[mesh.f], np.asarray(jmesh.v)[np.asarray(jmesh.f)],
           REL_STEPS, "mesh")
    out = tmp_path / "out" / chip_smoke.WF_DIR / "triposg_mesh.glb"
    assert Mesh.load(str(out)).num_faces == mesh.num_faces


def test_scribble_graph_runs_the_conditional_pass(tiny, tmp_path,
                                                  monkeypatch):
    """`chip_smoke.config_graph("triposg_scribble")` (LoadImage → Load
    Diffusers Pipeline "TripoSGScribblePipeline" → TripoSG Scribble Model,
    3 steps, dense octree depth 5 → Save 3D Mesh) through both packages;
    then two scribbles. The JAX package's scribble sampling (its node's
    guidance 0) gives the same latents, so the same mesh, for both
    (ROADMAP §C.10: its blend at guidance 0 is the velocity of the zero
    tokens); the port's differ, and they are the JAX DiT's conditional
    half's Euler loop within 1e-4 of the largest value; the factory marks
    its pipeline `is_scribble` and `Load TripoSG Pipeline`'s is not."""
    from comfy3d_tpu.nodes import graph as jgraph
    from comfy3d_tpu_torch.nodes import NODE_CLASS_MAPPINGS
    from comfy3d_tpu_torch.nodes import graph as tgraph
    jcfg, params, jpipe, tpipe = tiny
    _graph_env(tmp_path, monkeypatch, jpipe, tpipe.model)
    overrides = {3: {"num_inference_steps": 3, "dense_octree_depth": 5}}
    graph = chip_smoke.config_graph("triposg_scribble")
    jres = jgraph.run_workflow(graph, overrides)
    tres = tgraph.run_workflow(graph, overrides, device="cpu")
    assert jres[3][0].num_faces > 0 and tres[3][0].num_faces > 0
    out = tmp_path / "out" / chip_smoke.WF_DIR / "triposg_scribble_mesh.glb"
    assert Mesh.load(str(out)).num_faces == tres[3][0].num_faces

    rng = np.random.RandomState(6)
    a, b = (rng.rand(28, 28, 3).astype(np.float32) for _ in range(2))
    noise = jax_noise(jcfg, 42)
    j_a, j_b = (np.asarray(jpipe.sample_latents(x, seed=42, num_steps=3,
                                                guidance_scale=0.0))
                for x in (a, b))
    np.testing.assert_array_equal(j_a, j_b)
    t_a, t_b = (tpipe.sample_latents(x, draws=noise, distilled=True)
                for x in (a, b))
    assert float((t_a - t_b).abs().max()) > 1e-3
    sig = tp.flow_sigmas(3, 1.0)

    def cond_loop(p, cond, x):
        for i in range(3):
            v = jd.TripoSGDiT(jcfg.dit).apply(
                {"params": p}, x, jnp.full((1,), 1000.0 * sig[i]), cond[:1])
            x = x + (sig[i + 1] - sig[i]) * v
        return x

    ref = jax.jit(cond_loop, compiler_options=QUICK_XLA)(
        params["dit"], jpipe.encode_cond(a), jnp.asarray(noise))
    _close(t_a, ref, REL_STEPS, "conditional pass")
    pipe = NODE_CLASS_MAPPINGS["[Comfy3D] Load Diffusers Pipeline"]() \
        .load_diffusers_pipe("TripoSGScribblePipeline", "x")[0]
    assert pipe.is_scribble
    plain = NODE_CLASS_MAPPINGS["[Comfy3D] Load TripoSG Pipeline"]().load()[0]
    assert not plain.is_scribble
