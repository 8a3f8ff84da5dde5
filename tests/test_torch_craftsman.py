"""Port parity, Craftsman multi-view images → mesh: CLIP's camera ModLN,
the UNet-of-attention denoiser, `sample_latents` (DDIM, CFG) and the mesh
with shared draws, `from_pretrained` on a Lightning checkpoint the test
writes against the JAX loader on the same file, the full config's
parameter counts, and the node graph, `comfy3d_tpu_torch` against
`comfy3d_tpu` on the same numpy inputs and weights (flax params carried
across by `convert.craftsman_state_dict_from_flax`, which writes the
checkpoint's prefixed names)."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from comfy3d_tpu.models import clip as jclip
from comfy3d_tpu.models import vecset as jvecset
from comfy3d_tpu.models.craftsman import pipeline as jp

from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.core.mesh import Mesh
from comfy3d_tpu_torch.models import clip as tclip
from comfy3d_tpu_torch.models.craftsman import convert as tconv
from comfy3d_tpu_torch.models.craftsman import pipeline as tp
from comfy3d_tpu_torch.models.diffusion import schedulers as tsched
from comfy3d_tpu_torch.models.vecset import vae as tvae

from tests.test_torch_common import (QUICK_XLA, _load, _np, _randomize,
                                     one_torch_thread,  # noqa: F401
                                     quick_jax_pipeline)

# single passes against the JAX package: within REL of the largest value;
# sampled latents and decoded grids within REL_STEPS
REL = 1e-5
REL_STEPS = 1e-4
STEPS = 3


def _close(out, ref, rel=REL, what=""):
    out, ref = _np(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())


def _same_mesh(mesh, jmesh, what):
    assert mesh.num_faces > 0, what
    _close(mesh.v[mesh.f], np.asarray(jmesh.v)[np.asarray(jmesh.f)],
           REL_STEPS, what)


def _port_denoiser_cfg(jc) -> tp.DenoiserConfig:
    """The JAX `DenoiserConfig` without the fields the port does not have:
    `n_ctx` (the token count comes from the inputs) and `skip_ln` (the port
    always builds the skip LayerNorm, the JAX default)."""
    assert jc.skip_ln
    kw = dataclasses.asdict(jc)
    del kw["n_ctx"], kw["skip_ln"]
    return tp.DenoiserConfig(**kw)


def _port_cfg(jcfg) -> tp.CraftsmanConfig:
    return tp.CraftsmanConfig(
        denoiser=_port_denoiser_cfg(jcfg.denoiser),
        vae=tvae.ShapeVAEConfig(**dataclasses.asdict(jcfg.vae)),
        cond=tclip.CLIPVisionConfig(**dataclasses.asdict(jcfg.cond)),
        scheduler=tsched.SchedulerConfig(
            **dataclasses.asdict(jcfg.scheduler)),
        num_steps=jcfg.num_steps, guidance_scale=jcfg.guidance_scale)


def _shape_params(jmod, *args, seed, **kw):
    """Redrawn params of a flax module, its tree built by shape alone, with
    keyword arguments (`method=`, `mod_cond=`) to its `init`."""
    shapes = jax.eval_shape(functools.partial(jmod.init, **kw),
                            jax.random.PRNGKey(0), *args)["params"]
    return _randomize(shapes, seed)


def _clip_args(c, views=2):
    return (jnp.zeros((views, c.image_size, c.image_size, 3)),)


def jax_params(cfg, seed):
    """The JAX Craftsman params of `cfg`, by shape and redrawn."""
    c, d, vc = cfg.cond, cfg.denoiser, cfg.vae
    return {
        "cond": _shape_params(jclip.CLIPVisionEncoder(c), *_clip_args(c),
                              mod_cond=jnp.zeros((2, c.modulation_dim)),
                              seed=seed),
        "denoiser": _shape_params(jp.SimpleDenoiser(d),
                                  jnp.zeros((1, 4, d.input_channels)),
                                  jnp.zeros((1,)),
                                  jnp.zeros((1, 3, d.context_dim)),
                                  seed=seed + 1),
        "vae": _shape_params(jvecset.ShapeVAE(vc),
                             jnp.zeros((1, 4, vc.embed_dim)),
                             jnp.zeros((1, 7, 3)),
                             method=jvecset.ShapeVAE.init_all, seed=seed + 2)}


def port_pipe(jcfg, params) -> tp.CraftsmanPipeline:
    model = tp.Craftsman(_port_cfg(jcfg))
    model.load_state_dict(tconv.craftsman_model_state_dict(
        convert.craftsman_state_dict_from_flax(params)), strict=True)
    return tp.CraftsmanPipeline(model)


def jax_noise(cfg, seed):
    return np.asarray(jax.random.normal(
        jax.random.PRNGKey(seed), (1, cfg.vae.num_latents, cfg.vae.embed_dim)))


@pytest.fixture(scope="module")
def tiny():
    """`CraftsmanConfig.tiny()` in both packages on one set of weights."""
    jcfg = jp.CraftsmanConfig.tiny()
    params = jax_params(jcfg, 60)
    return jcfg, params, quick_jax_pipeline(
        jp.CraftsmanPipeline(params, jcfg), (0, 4, 6)), \
        port_pipe(jcfg, params)


def test_clip_modln_matches_jax():
    """CLIP's vision encoder with the camera ModLN (2 layers, modulation 32)
    on three views with three of the orbit's cameras (`np.resize`): the
    tokens, the pooled class token and the projected embedding within 1e-5
    of their largest value; `encode_camera` equal to the JAX package's; the
    dense layers under upstream's `mod_norm{1,2}.mlp.1` names; an encoder
    with ModLN asks for its camera code."""
    c = jclip.CLIPVisionConfig(hidden=32, layers=2, heads=2, mlp_dim=64,
                               image_size=28, patch=14, projection_dim=24,
                               modulation_dim=32)
    rng = np.random.RandomState(0)
    img = rng.randn(3, 28, 28, 3).astype(np.float32)
    cams = np.resize(tp.CRAFTSMAN_CAMERAS, (3, 4, 4))
    mod = _np(tp.encode_camera(cams))
    np.testing.assert_allclose(mod, np.asarray(jp.encode_camera(cams)),
                               rtol=0, atol=1e-6)
    enc = jclip.CLIPVisionEncoder(c)
    p = _shape_params(enc, img, mod_cond=mod, seed=1)
    (tok_j, pooled_j), (_, emb_j) = jax.jit(lambda p: (
        enc.apply({"params": p}, img, project=False, mod_cond=mod),
        enc.apply({"params": p}, img, mod_cond=mod)),
        compiler_options=QUICK_XLA)(p)
    sd = convert.clip_vision_state_dict_from_flax(p)
    assert {f"encoder.layers.1.mod_norm{i}.mlp.1.{w}" for i in (1, 2)
            for w in ("weight", "bias")} <= set(sd)
    port = _load(tclip.CLIPVisionEncoder(tclip.CLIPVisionConfig(
        **dataclasses.asdict(c))), sd)
    x = torch.as_tensor(img).permute(0, 3, 1, 2)
    with torch.no_grad():
        tok, pooled = port(x, project=False, mod_cond=torch.as_tensor(mod))
        emb = port(x, mod_cond=torch.as_tensor(mod))[1]
    _close(tok, tok_j, what="tokens")
    _close(pooled, pooled_j, what="pooled")
    _close(emb, emb_j, what="embedding")
    with pytest.raises(ValueError, match="mod_cond"):
        port(x)


def test_denoiser_matches_jax():
    """`SimpleDenoiser` at `tiny()`'s widths over [t | context | latents]:
    one and two encoder / decoder blocks, each decoder block with its skip
    LayerNorm, at two timesteps: eps within 1e-5 of its largest value."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 8).astype(np.float32)
    t = np.array([981.0, 1.0], np.float32)
    ctx = rng.randn(2, 5, 16).astype(np.float32)
    cases = [jp.DenoiserConfig(input_channels=8, n_ctx=6, width=32,
                               layers=n, heads=2, context_dim=16)
             for n in (1, 2)]
    params = [_shape_params(jp.SimpleDenoiser(c), x, t, ctx, seed=i)
              for i, c in enumerate(cases)]
    refs = jax.jit(lambda ps: [jp.SimpleDenoiser(c).apply(
        {"params": p}, x, t, ctx) for c, p in zip(cases, ps)],
        compiler_options=QUICK_XLA)(params)
    for c, p, ref in zip(cases, params, refs):
        port = _load(tp.SimpleDenoiser(_port_denoiser_cfg(c)),
                     convert.craftsman_denoiser_state_dict_from_flax(p))
        with torch.no_grad():
            out = port(*map(torch.as_tensor, (x, t, ctx)))
        _close(out, ref, what=f"denoiser {c.layers}")


def _jax_meshes(jpipe, latents, octree):
    """The JAX pipeline's decode of `latents` (its `__call__` after the
    sampler): the grids and meshes."""
    vae = jpipe.vae
    decoded = vae.apply({"params": jpipe.params["vae"]}, jnp.asarray(latents))
    grids = jvecset.vae.decode_volume_auto(
        lambda p, d, pts: vae.apply({"params": p}, d, pts,
                                    method=jvecset.ShapeVAE.query),
        jpipe.params["vae"], decoded, octree_resolution=octree,
        num_chunks=4096)
    grids = np.asarray(grids, np.float32)
    return grids, [jvecset.vae.grid_to_mesh(g) for g in grids]


@pytest.fixture(scope="module")
def jax_refs(tiny):
    """The tiny JAX pipeline on three 40² views: the context, the latents
    of 3 DDIM steps at guidance 7.5 from `PRNGKey(5)`'s noise, and the
    octree-32 grid and mesh of those latents (shared by the sampler and
    the loader tests)."""
    jcfg, params, jpipe, _ = tiny
    imgs = np.random.RandomState(2).rand(3, 40, 40, 3).astype(np.float32)
    noise = jax_noise(jcfg, 5)
    cond_j = jpipe.encode_cond(imgs)
    lat_j = np.asarray(jpipe._sample(params["denoiser"], cond_j,
                                     jnp.asarray(noise), STEPS,
                                     jnp.float32(7.5), "DDIMScheduler"))
    grids_j, (mesh_j,) = _jax_meshes(jpipe, lat_j, 32)
    return imgs, noise, np.asarray(cond_j), lat_j, grids_j, mesh_j


def test_sample_latents_and_mesh_match_jax(tiny, jax_refs):
    """`tiny()`'s pipeline on three 40² views (resized bicubic to 28²,
    cameras front, right, back): the context of every view's tokens within
    1e-5, `sample_latents` from the JAX package's `PRNGKey(seed)` noise
    over 3 DDIM steps at guidance 7.5 within 1e-4 of the largest value;
    the octree-32 grid (dense 33³) and mesh from JAX's latents triangle for
    triangle; a stochastic `scheduler_name` moves the latents."""
    tpipe = tiny[3]
    imgs, noise, cond_j, lat_j, grids_j, mesh_j = jax_refs
    cond = tpipe.encode_cond(imgs)
    assert tuple(cond.shape) == (1, 3 * 5, 32)
    _close(cond, cond_j, what="cond")
    lat = tpipe.sample_latents(imgs, draws=noise, num_steps=STEPS)
    _close(lat, lat_j, REL_STEPS, "latents")
    _close(tpipe.decode_grid(lat_j, 32, num_chunks=4096), grids_j,
           REL_STEPS, "grid")
    mesh, = tpipe.latents_to_mesh(lat_j, 32, num_chunks=4096)
    _same_mesh(mesh, mesh_j, "mesh")
    other = tp.CraftsmanPipeline(tpipe.model)
    other.scheduler_name = "EulerAncestralDiscreteScheduler"
    assert float((other.sample_latents(imgs, draws=noise, num_steps=STEPS)
                  - lat).abs().max()) > 1e-3


def _write_ckpt(path, sd):
    """`sd` as a Lightning checkpoint at `path` (`{"state_dict": …}`), with
    the keys upstream's file holds beside it that no loader reads: the
    text tower, `text_projection`, `logit_scale`, the autoencoder's
    encoder, HF's `position_ids`."""
    extra = {"condition.model.text_model.embeddings.token_embedding.weight":
             torch.zeros(7, 4),
             "condition.model.text_projection.weight": torch.zeros(3, 4),
             "condition.model.logit_scale": torch.zeros(()),
             "shape_model.encoder.query": torch.zeros(2, 4),
             "condition.model.vision_model.embeddings.position_ids":
             torch.zeros(1, 5, dtype=torch.long)}
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"state_dict": {**sd, **extra}, "epoch": 3}, str(path))


def test_from_pretrained_and_counts_match_jax(tiny, jax_refs, tmp_path):
    """`CraftsmanPipeline.from_pretrained` on a Lightning `.ckpt` nested as
    upstream's HF layout nests it (written from the JAX params by
    `convert.craftsman_state_dict_from_flax`, with the keys both loaders
    skip) and the JAX package's `from_pretrained` on the same directory:
    the JAX loader reads the written params leaf for leaf, and the port's
    loaded pipeline gives the JAX references of those params (the
    sampler test's context within 1e-5, its latents and octree-32 grid
    within 1e-4 of the largest value); a checkpoint without
    `denoiser_model.` keys raises, as does a directory with no `.ckpt`.
    The full config's parameter counts on `meta` equal
    `chip_smoke.CRAFTSMAN_PARAMS` and the JAX package's (by shape at one
    and two layers of each stack, extended to the full depths)."""
    jcfg, params, _, tpipe = tiny
    imgs, noise, cond_j, lat_j, grids_j, _ = jax_refs
    sd = convert.craftsman_state_dict_from_flax(params)
    root = tmp_path / "Craftsman"
    _write_ckpt(root / "image-to-shape-diffusion" / "v1" / "model.ckpt", sd)
    kw = dict(denoiser=jcfg.denoiser, vae=jcfg.vae, cond=jcfg.cond,
              n_views=jcfg.n_views, num_steps=jcfg.num_steps)
    jl = jp.CraftsmanPipeline.from_pretrained(str(root), **kw)
    loaded = dict(jax.tree_util.tree_leaves_with_path(jl.params))
    written = jax.tree_util.tree_leaves_with_path(params)
    assert len(loaded) == len(written)
    for path, leaf in written:
        np.testing.assert_array_equal(np.asarray(loaded[path]),
                                      np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
    pcfg = _port_cfg(jcfg)
    tl = tp.CraftsmanPipeline.from_pretrained(
        str(root), device="cpu", denoiser=pcfg.denoiser, vae=pcfg.vae,
        cond=pcfg.cond, num_steps=3)
    _close(tl.encode_cond(imgs), cond_j, what="cond")
    _close(tl.sample_latents(imgs, draws=noise, num_steps=STEPS), lat_j,
           REL_STEPS, "latents")
    _close(tl.decode_grid(lat_j, 32, num_chunks=4096), grids_j, REL_STEPS,
           "grid")
    _write_ckpt(tmp_path / "bad" / "model.ckpt",
                {k: v for k, v in sd.items()
                 if not k.startswith("denoiser_model.")})
    with pytest.raises(ValueError, match="denoiser"):
        tp.CraftsmanPipeline.from_pretrained(str(tmp_path / "bad"),
                                             device="cpu")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tp.CraftsmanPipeline.from_pretrained(str(tmp_path / "empty"),
                                             device="cpu")

    with torch.device("meta"):
        full = tp.Craftsman(tp.CraftsmanConfig())
    counts = {k: sum(p.numel() for p in getattr(full, k).parameters())
              for k in ("denoiser", "vae", "cond")}
    assert counts == chip_smoke.CRAFTSMAN_PARAMS
    fc = jp.CraftsmanConfig()

    def n(make, *args, **kw):
        """The parameters of the flax module `make()`, traced by shape."""
        return sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
            jax.eval_shape(lambda: make().init(jax.random.PRNGKey(0), *args,
                                               **kw))))

    def extended(counts, depth):
        return counts[0] + (depth - 1) * (counts[1] - counts[0])

    d, vc, c = fc.denoiser, fc.vae, fc.cond
    den = [n(lambda k=k: jp.SimpleDenoiser(dataclasses.replace(d, layers=k)),
             jnp.zeros((1, 4, d.input_channels)), jnp.zeros((1,)),
             jnp.zeros((1, 3, d.context_dim))) for k in (1, 2)]
    vae = [n(lambda k=k: jvecset.ShapeVAE(dataclasses.replace(
        vc, num_decoder_layers=k)), jnp.zeros((1, 4, vc.embed_dim)),
        jnp.zeros((1, 7, 3)), method=jvecset.ShapeVAE.init_all)
        for k in (1, 2)]
    cond = [n(lambda k=k: jclip.CLIPVisionEncoder(dataclasses.replace(
        c, layers=k)), *_clip_args(c, 1),
        mod_cond=jnp.zeros((1, c.modulation_dim))) for k in (1, 2)]
    assert counts == {"denoiser": extended(den, d.layers),
                      "vae": extended(vae, vc.num_decoder_layers),
                      "cond": extended(cond, c.layers)}


def test_graph_matches_jax(tiny, tmp_path, monkeypatch):
    """`chip_smoke.config_graph("craftsman")` through both packages'
    `run_workflow` on the CPU: LoadImage of a 2 × 2 grid of views → Split
    Image Grid → Load Craftsman Shape Diffusion Model (the tiny pipeline,
    no checkpoint) → Craftsman Shape Diffusion Model (four views, 3 DDIM
    steps at guidance 7.5, octree 32) → Save 3D Mesh: the meshes triangle
    for triangle within 1e-4 of their largest value, the GLB read back;
    the loader reads a checkpoint put under its root."""
    from comfy3d_tpu.nodes import base as jbase
    from comfy3d_tpu.nodes import graph as jgraph
    from comfy3d_tpu_torch.nodes import NODE_CLASS_MAPPINGS
    from comfy3d_tpu_torch.nodes import base as tbase
    from comfy3d_tpu_torch.nodes import graph as tgraph
    jcfg, params, jpipe, tpipe = tiny
    for name, attr in (("in", "INPUT_ROOT_PATH"), ("out", "OUTPUT_ROOT_PATH"),
                       ("ckpt", "CKPT_ROOT_PATH")):
        (tmp_path / name).mkdir()
        for b in (jbase, tbase):
            monkeypatch.setattr(b, attr, str(tmp_path / name))
    chip_smoke.write_view_grid(str(tmp_path / "in"), 28)
    monkeypatch.setattr(jp.CraftsmanPipeline, "init_random",
                        classmethod(lambda c, *a, **kw: jpipe))
    monkeypatch.setattr(tp.CraftsmanPipeline, "init_random",
                        classmethod(lambda c, *a, **kw: tpipe))
    call = tp.CraftsmanPipeline.__call__
    monkeypatch.setattr(tp.CraftsmanPipeline, "__call__",
                        lambda self, images, seed=0, **kw: call(
                            self, images, seed,
                            draws=jax_noise(self.cfg, seed), **kw))
    graph = chip_smoke.config_graph("craftsman")
    overrides = {4: {"num_inference_steps": STEPS, "octree_resolution": 32}}
    jres = jgraph.run_workflow(graph, overrides)
    tres = tgraph.run_workflow(graph, overrides, device="cpu")
    assert tuple(tres[2][0].shape) == (4, 28, 28, 3)
    _same_mesh(tres[4][0], jres[4][0], "mesh")
    out = tmp_path / "out" / chip_smoke.WF_DIR / "craftsman_mesh.glb"
    assert Mesh.load(str(out)).num_faces == tres[4][0].num_faces
    _write_ckpt(tmp_path / "ckpt" / "Craftsman" / "image-to-shape-diffusion"
                / "model.ckpt", convert.craftsman_state_dict_from_flax(params))
    small = _port_cfg(jcfg)
    monkeypatch.setattr(tp, "CraftsmanConfig", lambda **kw: small)
    with tbase.run_device("cpu"):
        loaded = NODE_CLASS_MAPPINGS[
            "[Comfy3D] Load Craftsman Shape Diffusion Model"]().load()[0]
    for k, v in loaded.model.state_dict().items():
        assert torch.equal(v, tpipe.model.state_dict()[k]), k
