"""Port parity, PartCrafter image → part meshes: the part-axis DiT (local
blocks batched over parts, global blocks folding the parts into the
tokens, the part embedding on every token), `sample_latents` and the
per-part meshes with shared draws, `merge_parts`, `from_pretrained` on
upstream's directory layout against the JAX loader on the same files, the
full config's parameter counts, and the node graph, `comfy3d_tpu_torch`
against `comfy3d_tpu` on the same numpy inputs and weights (flax params
carried across by `convert.partcrafter_state_dict_from_flax`, which writes
upstream's names and head-major attention packing)."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import dataclasses
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from comfy3d_tpu.models import vecset as jvecset
from comfy3d_tpu.models.dinov2 import Dinov2 as JDinov2
from comfy3d_tpu.models.partcrafter import pipeline as jp
from comfy3d_tpu.models.triposg import dit as jd
from comfy3d_tpu.models.triposg import vae as jv

from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.core.mesh import Mesh
from comfy3d_tpu_torch.models import dinov2 as td
from comfy3d_tpu_torch.models.partcrafter import pipeline as tp
from comfy3d_tpu_torch.models.triposg import dit as tdit
from comfy3d_tpu_torch.models.triposg import vae as tvae

from tests.test_torch_common import (QUICK_XLA, _load, _np, _params,
                                     one_torch_thread,  # noqa: F401
                                     quick_jax_pipeline)

# single passes against the JAX package: within REL of the largest value;
# sampled latents and decoded grids within REL_STEPS
REL = 1e-5
REL_STEPS = 1e-4
PARTS = 3
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


def _same_colours(mesh, jmesh):
    """The palette's colour at each triangle corner (the weld may split a
    vertex in one package only, so vertex indices need not agree)."""
    np.testing.assert_array_equal(
        mesh.vc[mesh.f], np.asarray(jmesh.vc)[np.asarray(jmesh.f)])


def _port_dit_cfg(jc) -> tp.PartCrafterDiTConfig:
    return tp.PartCrafterDiTConfig(
        base=tdit.TripoSGDiTConfig(**dataclasses.asdict(jc.base)),
        max_num_parts=jc.max_num_parts,
        global_attn_block_ids=tuple(jc.global_attn_block_ids))


def _port_cfg(jcfg) -> tp.PartCrafterConfig:
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["dit"] = _port_dit_cfg(jcfg.dit)
    kw["vae"] = tvae.TripoSGVAEConfig(**dataclasses.asdict(jcfg.vae))
    kw["cond"] = td.Dinov2Config(**dataclasses.asdict(jcfg.cond))
    return tp.PartCrafterConfig(**kw)


def _dit_args(cfg, parts=2):
    c = cfg.base
    return (jnp.zeros((1, parts, 4, c.in_channels)), jnp.zeros((1,)),
            jnp.zeros((1, 5, c.cross_attention_dim)),
            jnp.arange(parts, dtype=jnp.int32))


def jax_params(cfg, seed):
    """The JAX PartCrafter params of `cfg`, by shape and redrawn
    (`_params`)."""
    s, vc = cfg.image_size, cfg.vae
    return {
        "cond": _params(JDinov2(cfg.cond), jnp.zeros((1, s, s, 3)),
                        seed=seed),
        "dit": _params(jp.PartCrafterDiT(cfg.dit), *_dit_args(cfg.dit),
                       seed=seed + 1),
        "vae": _params(jv.TripoSGVAE(vc), jnp.zeros((1, 4,
                                                     vc.latent_channels)),
                       jnp.zeros((1, 7, 3)), method=jv.TripoSGVAE.init_all,
                       seed=seed + 2)}


def port_pipe(jcfg, params) -> tp.PartCrafterPipeline:
    cfg = _port_cfg(jcfg)
    model = tp.PartCrafter(cfg)
    sd = convert.partcrafter_state_dict_from_flax(params, cfg.dit.base.heads,
                                                  cfg.vae.heads)
    # the JAX VAE's init traces no encoder: keep the port's drawn one
    for k, v in model.vae.state_dict().items():
        if k.startswith(("encoder.", "quant.")):
            sd[f"vae.{k}"] = v
    model.load_state_dict(sd, strict=True)
    return tp.PartCrafterPipeline(model)


def jax_noise(cfg, seed, parts=PARTS):
    return np.asarray(jax.random.normal(
        jax.random.PRNGKey(seed),
        (parts, cfg.vae.num_latents, cfg.vae.latent_channels)))


@pytest.fixture(scope="module")
def tiny():
    """`PartCrafterConfig.tiny()` (5 blocks, global blocks 1 and 3) in both
    packages on one set of weights."""
    jcfg = jp.PartCrafterConfig.tiny()
    params = jax_params(jcfg, 50)
    return jcfg, params, quick_jax_pipeline(
        jp.PartCrafterPipeline(params, jcfg), (0, 4, 5)), \
        port_pipe(jcfg, params)


def test_dit_matches_jax():
    """The part-axis DiT at `tiny()`'s widths on two CFG streams of three
    parts: 3 blocks with no global block (parts independent) and 5 blocks
    with global blocks 0 and 3 (a skip block among them, its skip folded
    too) and part ids not in order: the velocity within 1e-5 of its largest
    value; with no global block a part's velocity does not move when
    another part's latents do."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 6, 8).astype(np.float32)
    t = np.array([900.0, 900.0], np.float32)
    ctx = rng.randn(2, 4, 16).astype(np.float32)
    pid = np.array([2, 0, 1], np.int32)
    base = jd.TripoSGDiTConfig(width=32, in_channels=8, num_layers=3,
                               heads=2, cross_attention_dim=16)
    cases = [jp.PartCrafterDiTConfig(base=base, max_num_parts=4,
                                     global_attn_block_ids=()),
             jp.PartCrafterDiTConfig(
                 base=dataclasses.replace(base, num_layers=5),
                 max_num_parts=4, global_attn_block_ids=(0, 3))]
    params = [_params(jp.PartCrafterDiT(c), x, t, ctx, pid, seed=i)
              for i, c in enumerate(cases)]
    refs = jax.jit(lambda ps: [jp.PartCrafterDiT(c).apply(
        {"params": p}, x, t, ctx, pid) for c, p in zip(cases, ps)],
        compiler_options=QUICK_XLA)(params)
    moved = x.copy()
    moved[:, 1] += 1.0
    for c, p, ref in zip(cases, params, refs):
        port = _load(tp.PartCrafterDiT(_port_dit_cfg(c)),
                     {**convert.triposg_dit_state_dict_from_flax(
                         p, c.base.heads),
                      "part_embedding.weight": np.asarray(
                          p["part_embedding"])})
        with torch.no_grad():
            out = port(*map(torch.as_tensor, (x, t, ctx, pid)))
            out_moved = port(*map(torch.as_tensor, (moved, t, ctx, pid)))
        _close(out, ref, what=f"dit {c.global_attn_block_ids}")
        coupled = float((out_moved[:, 0] - out[:, 0]).abs().max())
        assert (coupled > 1e-3) == bool(c.global_attn_block_ids), coupled


def _jax_meshes(jpipe, latents, octree):
    """The JAX pipeline's decode of `latents` (its `__call__` after the
    sampler): the parts' grids and meshes."""
    vae = jpipe.vae
    decoded = vae.apply({"params": jpipe.params["vae"]},
                        jnp.asarray(latents) / jpipe.cfg.vae.scale_factor)
    grids = jvecset.vae.decode_volume_auto(
        lambda p, d, pts: vae.apply({"params": p}, d, pts,
                                    method=jv.TripoSGVAE.query),
        jpipe.params["vae"], decoded, octree_resolution=octree,
        num_chunks=4096)
    grids = np.asarray(grids, np.float32)
    return grids, [jvecset.vae.grid_to_mesh(g) for g in grids]


def test_sample_latents_and_meshes_match_jax(tiny):
    """`tiny()`'s pipeline on a 40² image (resized to 28²): the
    conditioning tokens, `sample_latents` of three parts from the JAX
    package's `PRNGKey(seed)` noise over 3 steps at guidance 7 within 1e-4
    of the largest value; the parts' octree-32 grids (dense 33³) and
    meshes from JAX's latents, part by part, and `merge_parts` of them,
    triangle for triangle with its palette at each corner; the parts'
    latents differ."""
    jcfg, params, jpipe, tpipe = tiny
    img = np.random.RandomState(2).rand(40, 40, 3).astype(np.float32)
    noise = jax_noise(jcfg, 5)
    cond_j = jpipe.encode_cond(img)
    lat_j = np.asarray(jpipe._sample(params["dit"], cond_j,
                                     jnp.asarray(noise), PARTS, STEPS,
                                     jnp.float32(7.0)))
    _close(tpipe.encode_cond(img), cond_j, what="cond")
    lat = tpipe.sample_latents(img, PARTS, draws=noise, num_steps=STEPS)
    _close(lat, lat_j, REL_STEPS, "latents")
    assert float((lat[0] - lat[1]).abs().max()) > 1e-3
    grids_j, meshes_j = _jax_meshes(jpipe, lat_j, 32)
    _close(tpipe.decode_grid(lat_j, 32, num_chunks=4096), grids_j,
           REL_STEPS, "grids")
    meshes = tpipe.latents_to_mesh(lat_j, 32, num_chunks=4096)
    assert len(meshes) == PARTS
    for i, (m, mj) in enumerate(zip(meshes, meshes_j)):
        _same_mesh(m, mj, f"part {i}")
    merged, merged_j = tp.merge_parts(meshes), jp.merge_parts(meshes_j)
    _same_mesh(merged, merged_j, "merged")
    _same_colours(merged, merged_j)


def _write_dir(root, cfg, sd, ids_as_range):
    """Upstream's PartCrafter layout under `root`: transformer/ (its global
    blocks as `global_attn_block_id_range` or as the ids), vae/ and
    image_encoder_dinov2/, each a config.json beside safetensors weights."""
    from safetensors.torch import save_file
    d = cfg.dit
    gids = list(d.global_attn_block_ids)
    tconf = dict(width=d.base.width, in_channels=d.base.in_channels,
                 num_layers=d.base.num_layers,
                 num_attention_heads=d.base.heads,
                 cross_attention_dim=d.base.cross_attention_dim,
                 max_num_parts=d.max_num_parts)
    if ids_as_range:
        tconf["global_attn_block_id_range"] = [gids[0], gids[-1]]
    else:
        tconf["global_attn_block_ids"] = gids
    parts = {
        "transformer": ("dit", tconf, "diffusion_pytorch_model.safetensors"),
        "vae": ("vae", dict(
            latent_channels=cfg.vae.latent_channels,
            num_attention_heads=cfg.vae.heads,
            width_encoder=cfg.vae.width_encoder,
            width_decoder=cfg.vae.width_decoder,
            num_layers_encoder=cfg.vae.num_layers_encoder,
            num_layers_decoder=cfg.vae.num_layers_decoder,
            embed_frequency=cfg.vae.num_freqs, embed_include_pi=False),
            "diffusion_pytorch_model.safetensors"),
        "image_encoder_dinov2": ("cond", dict(
            hidden_size=cfg.cond.hidden, num_hidden_layers=cfg.cond.layers,
            num_attention_heads=cfg.cond.heads, patch_size=cfg.cond.patch,
            image_size=cfg.image_size), "model.safetensors")}
    for sub, (prefix, conf, fname) in parts.items():
        p = root / sub
        p.mkdir(parents=True)
        (p / "config.json").write_text(json.dumps(conf))
        save_file({k[len(prefix) + 1:]: v.contiguous() for k, v in sd.items()
                   if k.startswith(prefix + ".")}, str(p / fname))


def test_from_pretrained_and_counts_match_jax(tiny, tmp_path):
    """`PartCrafterPipeline.from_pretrained` on upstream's layout, written
    from the port's state dict with the global blocks as ids and as an
    inclusive id range (blocks 1–3), and the JAX package's
    `from_pretrained` on the same files: the configs agree, and, loaded
    from the range, so do the conditioning, a DiT pass of two parts and
    the VAE's query (within 1e-5 of the largest value); without
    image_encoder_dinov2/ the conditioner is drawn. The full config's
    parameter counts on `meta` are TripoSG's
    (`chip_smoke.TRIPOSG_PARAMS`, held against the JAX package by
    `test_torch_triposg.py`) with the DiT's 32 × 2,048 part table more,
    `chip_smoke.PARTCRAFTER_PARAMS`."""
    tpipe = tiny[3]
    rng = np.random.RandomState(4)
    img = rng.rand(28, 28, 3).astype(np.float32)
    x = rng.randn(1, 2, 6, 8).astype(np.float32)
    lat = rng.randn(1, 6, 8).astype(np.float32)
    pts = (rng.rand(1, 20, 3) * 2 - 1).astype(np.float32)
    pid = np.arange(2, dtype=np.int32)
    sd = tpipe.model.state_dict()
    for as_range in (False, True):
        root = tmp_path / f"pc{int(as_range)}"
        _write_dir(root, tpipe.cfg, sd, as_range)
        jl = jp.PartCrafterPipeline.from_pretrained(str(root))
        tl = tp.PartCrafterPipeline.from_pretrained(str(root), device="cpu")
        assert dataclasses.asdict(tl.cfg.dit) == dataclasses.asdict(jl.cfg.dit)
        assert tl.cfg.dit.global_attn_block_ids == (
            (1, 2, 3) if as_range else (1, 3))
        assert tl.cfg.image_size == jl.cfg.image_size == 28
    # the range's blocks 1-3 run through both packages' loaded pipelines
    cond_j = jax.jit(jl.encode_cond, compiler_options=QUICK_XLA)(img)

    def refs(p, cond):
        v = jl.dit.apply({"params": p["dit"]}, x, jnp.array([500.0]),
                         cond, pid)
        dec = jl.vae.apply({"params": p["vae"]}, lat)
        return v, jl.vae.apply({"params": p["vae"]}, dec, pts,
                               method=jv.TripoSGVAE.query)

    v_j, q_j = jax.jit(refs, compiler_options=QUICK_XLA)(jl.params, cond_j)
    with torch.no_grad():
        cond = tl.encode_cond(img)
        v = tl.model.dit(torch.as_tensor(x), torch.tensor([500.0]), cond,
                         torch.as_tensor(pid))
        q = tl.model.vae.query(tl.model.vae(torch.as_tensor(lat)),
                               torch.as_tensor(pts))
    _close(cond, cond_j, what="cond")
    _close(v, v_j, what="dit")
    _close(q, q_j, what="query")
    (tmp_path / "bare").mkdir()
    for sub in ("transformer", "vae"):
        (root / sub).rename(tmp_path / "bare" / sub)
    bare = tp.PartCrafterPipeline.from_pretrained(
        str(tmp_path / "bare"), device="cpu", image_size=28,
        cond=tl.cfg.cond)
    assert not torch.equal(bare.model.cond.embeddings.cls_token,
                           tl.model.cond.embeddings.cls_token)

    with torch.device("meta"):
        full = tp.PartCrafter(tp.PartCrafterConfig())
    counts = {k: sum(p.numel() for p in getattr(full, k).parameters())
              for k in ("dit", "vae", "cond")}
    assert counts == chip_smoke.PARTCRAFTER_PARAMS
    tsg = chip_smoke.TRIPOSG_PARAMS
    assert counts == {**tsg, "dit": tsg["dit"] + 32 * 2048}
    assert full.cfg.dit.global_attn_block_ids == tuple(range(0, 21, 2))


def _graph_env(tmp_path, monkeypatch, jpipe, model):
    """Both packages' node roots under tmp_path with the reference images;
    each package's PartCrafter `init_random` returning the tiny pipelines
    (the port's a new pipeline on the shared model each call, so the scene
    loader's flag stays its own) and the port's calls given the JAX
    package's noise."""
    from comfy3d_tpu.nodes import base as jbase
    from comfy3d_tpu.nodes import nodes_diffusers as jnd
    from comfy3d_tpu.nodes import nodes_partcrafter as jnp_
    from comfy3d_tpu_torch.nodes import base as tbase
    for name, attr in (("in", "INPUT_ROOT_PATH"), ("out", "OUTPUT_ROOT_PATH"),
                       ("ckpt", "CKPT_ROOT_PATH")):
        (tmp_path / name).mkdir()
        for b in (jbase, tbase):
            monkeypatch.setattr(b, attr, str(tmp_path / name))
    # the JAX loader node keeps the tiny pipeline unsharded, so its calls
    # reuse the compiles of the tests before (the port has no mesh)
    monkeypatch.setenv("COMFY3D_NO_SHARD", "1")
    monkeypatch.setattr(jnp_, "OUTPUT_ROOT_PATH", str(tmp_path / "jout"))
    monkeypatch.setattr(jnd, "CKPT_DIFFUSERS_PATH",
                        str(tmp_path / "ckpt" / "Diffusers"))
    chip_smoke.write_reference_images(str(tmp_path / "in"), 36)
    monkeypatch.setattr(jp.PartCrafterPipeline, "init_random",
                        classmethod(lambda c, *a, **kw: jpipe))
    monkeypatch.setattr(tp.PartCrafterPipeline, "init_random",
                        classmethod(lambda c, *a, **kw: tp.PartCrafterPipeline(
                            model)))
    call = tp.PartCrafterPipeline.__call__
    monkeypatch.setattr(
        tp.PartCrafterPipeline, "__call__",
        lambda self, image, num_parts=4, seed=0, **kw: call(
            self, image, num_parts, seed,
            draws=jax_noise(self.cfg, seed, num_parts), **kw))


def test_graph_matches_jax(tiny, tmp_path, monkeypatch):
    """`chip_smoke.config_graph("partcrafter")` through both packages'
    `run_workflow` on the CPU: LoadImage → Load PartCrafter Pipeline (the
    tiny pipeline) → PartCrafter Generate (three parts, 3 steps at
    guidance 7, octree 32, explode 0.3): the merged, exploded scene
    triangle for triangle within 1e-4 of its largest value with its
    palette, the zip's three part GLBs each the JAX package's part, the
    scene GLB read back, the paths and the image; then the scene graph's
    loader marks its pipeline `is_scene` and the object loader's is
    not."""
    from comfy3d_tpu.nodes import graph as jgraph
    from comfy3d_tpu_torch.nodes import graph as tgraph
    _, _, jpipe, tpipe = tiny
    _graph_env(tmp_path, monkeypatch, jpipe, tpipe.model)
    graph = chip_smoke.config_graph("partcrafter")
    overrides = {3: {"num_parts": PARTS, "num_inference_steps": STEPS,
                     "octree_resolution": 32}}
    jres = jgraph.run_workflow(graph, overrides)
    tres = tgraph.run_workflow(graph, overrides, device="cpu")
    (zpath, glb, image, merged), jout = tres[3], jres[3]
    _same_mesh(merged, jout[3], "merged")
    _same_colours(merged, jout[3])
    assert glb == jout[1] == "partcrafter_scenes/scene.glb"
    _close(image, jout[2], what="image")
    out = tmp_path / "out"
    assert zpath == str(out / "partcrafter_parts" / "parts.zip")
    assert Mesh.load(str(out / glb)).num_faces == merged.num_faces
    with zipfile.ZipFile(zpath) as zt, zipfile.ZipFile(jout[0]) as zj:
        names = [f"part_{i:02d}.glb" for i in range(PARTS)]
        assert zt.namelist() == zj.namelist() == names
        for name in names:
            for z, d in ((zt, "t"), (zj, "j")):
                z.extract(name, tmp_path / d)
            _same_mesh(Mesh.load(str(tmp_path / "t" / name)),
                       Mesh.load(str(tmp_path / "j" / name)), name)
    assert not tres[2][0].is_scene
    scene = tgraph.run_workflow(chip_smoke.config_graph("partcrafter_scene"),
                                {3: {**overrides[3], "num_inference_steps": 1,
                                     "num_parts": 1}}, device="cpu")
    assert scene[2][0].is_scene and scene[3][3].num_faces > 0
