"""Port parity, CRM: the triplane refiner's `UNet2DModel`, the strip's
rollout, noise and plane sampling, the reconstruction pipeline on a
`CRM.pth` both packages load (planes, the SDF grid, the mesh, its
colours), the T2I-Adapter and an adapter-conditioned sampler, the T2I V3
LoRA / DoRA fold, the CRM graphs through `run_workflow(device="cpu")` and
the clipped weld's faces (ROADMAP C.6, where the port departs from JAX),
`comfy3d_tpu_torch` against `comfy3d_tpu` on the same numpy inputs and
weights (flax params carried across by `convert.*_from_flax`)."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import dataclasses
import functools
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from comfy3d_tpu.models.crm import pipeline as jcrm
from comfy3d_tpu.models.crm import t2i_adapter as jt2i
from comfy3d_tpu.models.crm import t2i_convert as jt2ic
from comfy3d_tpu.models.crm.unet2d import UNet2DModel as JUNet2D
from comfy3d_tpu.models.crm.unet2d import UNet2DModelConfig as JUNet2DConfig
from comfy3d_tpu.models.mvdream import pipeline as jp
from comfy3d_tpu.models.mvdream.convert import \
    fold_lora_checkpoint as j_fold
from comfy3d_tpu.ops import tetra as jtet

from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.models.crm import pipeline as tcrm
from comfy3d_tpu_torch.models.crm.t2i_adapter import T2IAdapterConfig
from comfy3d_tpu_torch.models.crm.t2i_convert import load_adapter_dir
from comfy3d_tpu_torch.models.crm.unet2d import (UNet2DModel,
                                                 UNet2DModelConfig)
from comfy3d_tpu_torch.models.mvdream import MVDream, MVDreamPipeline
from comfy3d_tpu_torch.models.mvdream.convert import fold_lora_checkpoint
from comfy3d_tpu_torch.nodes import graph as tgraph
from comfy3d_tpu_torch.ops import tetra

from tests.test_torch_common import (QUICK_XLA, _load, _np, _randomize,
                                     one_torch_thread)  # noqa: F401
from tests.test_torch_imagedream import (jax_noise, port_cfg, tiny_cfg,
                                         tiny_params)
from tests.test_torch_nodes import roots  # noqa: F401

# outputs against the JAX package: within this share of their largest value
REL = 1e-4


def _close(out, ref, rel=REL, what=""):
    out, ref = _np(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())


def test_unet2d_matches_jax():
    """The tiny `UNet2DModel` (two blocks, self-attention on down block 1
    and up block 0) at two timesteps, within 1e-4 of its largest value; its
    state dict is diffusers' layout."""
    cfg = JUNet2DConfig.tiny()
    x = np.random.RandomState(0).randn(2, 16, 16, 8).astype(np.float32)
    params = _randomize(jax.eval_shape(
        JUNet2D(cfg).init, jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 8)),
        jnp.zeros(()))["params"], 1)
    ref = jax.jit(lambda p, t: JUNet2D(cfg).apply({"params": p}, x, t),
                  compiler_options=QUICK_XLA)
    model = _load(UNet2DModel(UNet2DModelConfig.tiny()),
                  convert.unet2d_state_dict_from_flax(params))
    assert {"down_blocks.1.attentions.0.group_norm.weight",
            "down_blocks.0.downsamplers.0.conv.weight",
            "up_blocks.0.upsamplers.0.conv.bias",
            "time_embedding.linear_2.bias"} <= set(model.state_dict())
    for t in (20.0, 700.0):
        with torch.no_grad():
            out = model(torch.as_tensor(x).permute(0, 3, 1, 2), t)
        _close(out.permute(0, 2, 3, 1), ref(params, t), what=f"t={t}")


def test_strip_noise_and_plane_sampling_match_jax():
    """`rollout_strip` (the RGB and the fixed CCM tiles) and
    `ddim_add_noise` equal JAX's element for element (both numpy, ᾱ in
    float64); `grid_sample_border_ac` within 1e-5 of the largest value,
    points outside [-1, 1] clamped to the border."""
    rng = np.random.RandomState(2)
    views = rng.rand(6, 5, 5, 3).astype(np.float32)
    for fix in (False, True):
        a, b = tcrm.rollout_strip(views, fix), jcrm.rollout_strip(views, fix)
        assert a.shape == (5, 15, 6)
        np.testing.assert_array_equal(a, b)
    x = rng.rand(4, 6, 12).astype(np.float32)
    noise = rng.randn(4, 6, 12).astype(np.float32)
    for t in (0, 20, 999):
        np.testing.assert_array_equal(tcrm.ddim_add_noise(x, noise, t),
                                      jcrm.ddim_add_noise(x, noise, t))
    plane = rng.randn(6, 9, 4).astype(np.float32)
    uv = (rng.rand(200, 2) * 2.4 - 1.2).astype(np.float32)
    uv[:3] = [[-1, -1], [1, 1], [1.2, -1.1]]
    out = tcrm.grid_sample_border_ac(torch.as_tensor(plane).permute(2, 0, 1),
                                     torch.as_tensor(uv))
    ref = jcrm.grid_sample_border_ac(jnp.asarray(plane), jnp.asarray(uv))
    _close(out, ref, rel=1e-5)


def test_crm_checkpoint_and_pipeline_match_jax(tmp_path, monkeypatch):
    """A tiny `CRM.pth` in its own names (a renderer buffer, one attention
    in the deprecated `query` / `proj_attn` spelling as 1×1 convs) loaded
    by both packages: the same weights. Six 40² views and CCMs through
    both pipelines: the noised strip and, from JAX's strip, the planes and
    the 13³ SDF grid within 1e-4 of their largest value; the mesh the
    port extracts from JAX's grid equal to JAX's element for element, its
    vertex colours from the port's planes within 1e-4; the port's own call
    gives a coloured mesh."""
    jcfg = jcrm.CRMConfig.tiny()
    p = jcfg.plane_resolution
    params = _randomize(jax.eval_shape(functools.partial(
        jcrm.CRMModel(jcfg).init, method=jcrm.CRMModel.init_all),
        jax.random.PRNGKey(0), jnp.zeros((1, p, 3 * p, 12)),
        jnp.zeros((5, 3)))["params"], 3)
    # the SDF head's bias off the lattice values, so no grid value is 0
    params["sdf_2"]["bias"] = params["sdf_2"]["bias"] * 0.1 + 0.013
    sd = dict(convert.crm_state_dict_from_flax(params))
    att = "unet2.unet.down_blocks.1.attentions.0."
    sd[att + "query.weight"] = sd.pop(att + "to_q.weight")[:, :, None, None]
    sd[att + "query.bias"] = sd.pop(att + "to_q.bias")
    sd[att + "proj_attn.weight"] = sd.pop(att + "to_out.0.weight")
    sd[att + "proj_attn.bias"] = sd.pop(att + "to_out.0.bias")
    sd["renderer.tet_grid"] = torch.zeros(3, 4)
    path = str(tmp_path / "CRM.pth")
    torch.save(sd, path)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jpipe = jcrm.CRMReconPipeline.from_pretrained(path, jcfg)
    assert not [w for w in caught if "unconverted" in str(w.message)]
    pipe = tcrm.CRMReconPipeline.from_pretrained(path, tcrm.CRMConfig.tiny(),
                                                 device="cpu")
    ref_sd = convert.crm_state_dict_from_flax(jpipe.params)
    got = pipe.model.state_dict()
    assert set(got) == set(ref_sd)
    for k, v in ref_sd.items():
        assert torch.equal(got[k], v), k

    rng = np.random.RandomState(4)
    images = rng.rand(6, 40, 40, 3).astype(np.float32)
    ccms = rng.rand(6, 40, 40, 3).astype(np.float32)
    seen = {}
    fwd = jpipe._forward

    def forward(prm, x, t):
        seen["strip"], seen["planes"] = np.asarray(x), fwd(prm, x, t)
        return seen["planes"]

    extract = jtet.extract_isosurface

    def grab(grid, **kw):
        seen["grid"] = np.asarray(grid)
        return extract(grid, **kw)

    jpipe._forward = forward
    monkeypatch.setattr(jtet, "extract_isosurface", grab)
    jmesh = jpipe(images, ccms)
    _close(pipe.make_strip(images, ccms), seen["strip"][0], what="strip")
    planes = pipe.planes(seen["strip"][0])
    _close(planes.permute(1, 2, 0), seen["planes"][0], what="planes")
    grid = pipe.sdf_grid(planes)
    _close(grid, seen["grid"], what="sdf grid")
    assert (seen["grid"] > 0).any() and (seen["grid"] < 0).any()
    mesh = tetra.extract_isosurface(torch.as_tensor(seen["grid"]), iso=0.0,
                                    bounds=(-1.0, 1.0))
    assert mesh.num_faces > 0
    np.testing.assert_array_equal(mesh.v, np.asarray(jmesh.v))
    np.testing.assert_array_equal(mesh.f, np.asarray(jmesh.f))
    np.testing.assert_allclose(pipe.vertex_colors(planes, mesh.v),
                               np.asarray(jmesh.vc), atol=REL, rtol=0)
    own = pipe(torch.as_tensor(images), torch.as_tensor(ccms))
    assert own.num_faces > 0 and own.vc.shape == own.v.shape
    assert np.isfinite(own.vc).all()
    assert 0 <= own.vc.min() and own.vc.max() <= 1


def _adapter_case():
    cfg = jt2i.T2IAdapterConfig.tiny()
    params = _randomize(jax.eval_shape(
        jt2i.T2IAdapter(cfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 32, 32, 3)))["params"], 5)
    return cfg, params


def test_t2i_adapter_and_conditioned_sampler_match_jax(tmp_path):
    """The tiny T2I-Adapter on six 32² normal maps (its two maps within
    1e-4 of their largest value), loaded from a diffusers directory the
    test writes as JAX loads it; the six-view ImageDream sampler (no image)
    conditioned by those maps in both CFG halves, 2 DDIM steps: the views
    within 1e-4 of their largest value, and moved by the maps."""
    cfg, params = _adapter_case()
    nm = np.random.RandomState(6).rand(6, 32, 32, 3).astype(np.float32)
    jcfg = tiny_cfg(num_views=6)
    mv_params = tiny_params(jcfg, 7)
    kw = dict(num_inference_steps=2, guidance_scale=5.5)

    def run(ap, mp):
        feats = jt2i.T2IAdapter(cfg).apply({"params": ap}, nm)
        views = jp.MVDreamPipeline(mp, jcfg)(seed=2,
                                             adapter_residuals=feats, **kw)
        return feats, views

    feats, views = jax.jit(run, compiler_options=QUICK_XLA)(params,
                                                            mv_params)
    sd = convert.t2i_adapter_state_dict_from_flax(params)
    adir = tmp_path / "T2I_V2"
    os.makedirs(adir)
    with open(adir / "config.json", "w") as f:
        json.dump({"in_channels": 3, "channels": list(cfg.channels),
                   "num_res_blocks": cfg.num_res_blocks,
                   "conditioning_embedding_out_channels":
                       list(cfg.cond_channels)}, f)
    from safetensors.torch import save_file
    save_file(sd, str(adir / "diffusion_pytorch_model.safetensors"))
    tcfg, adapter = load_adapter_dir(str(adir), device="cpu")
    assert tcfg == T2IAdapterConfig.tiny()
    jloaded = jt2ic.load_adapter_dir(str(adir))[1]
    for k, v in convert.t2i_adapter_state_dict_from_flax(jloaded).items():
        assert torch.equal(adapter.state_dict()[k], v), k
    with torch.no_grad():
        maps = adapter(torch.as_tensor(nm).permute(0, 3, 1, 2))
    for m, r in zip(maps, feats):
        _close(m.permute(0, 2, 3, 1), r, what="adapter")
    pipe = MVDreamPipeline(_load(MVDream(port_cfg(jcfg)),
                                 convert.mvdream_state_dict_from_flax(
                                     mv_params)))
    x = jax_noise(2, 6, 16)
    out = pipe(latents=x, adapter_residuals=maps, **kw)
    _close(out, views, what="views")
    assert np.abs(_np(pipe(latents=x, **kw) - out)).max() > 1e-3


def test_lora_fold_matches_jax(tmp_path):
    """A peft LoRA / DoRA file (rank 2; `base_layer` weights on one
    projection, a `base_layer` bias on another, a DoRA magnitude on a
    third, a LoRA on an IP projection, the `model.diffusion_model.`
    prefix) folded into both packages' tiny ImageDream: the same weights
    within 1e-5 of their largest value, and the same count."""
    jcfg = tiny_cfg()
    params = tiny_params(jcfg, 8)
    pipe = MVDreamPipeline(_load(MVDream(port_cfg(jcfg)),
                                 convert.mvdream_state_dict_from_flax(params)))
    jpipe = jp.MVDreamPipeline(jax.tree_util.tree_map(np.array, params),
                               jcfg)
    g = torch.Generator().manual_seed(9)
    pre = "model.diffusion_model."
    sd = {}
    for mod, (dout, din) in {
            "input_blocks.1.1.transformer_blocks.0.attn1.to_q": (8, 8),
            "input_blocks.1.1.transformer_blocks.0.attn2.to_v": (8, 16),
            "output_blocks.2.1.transformer_blocks.0.attn2.to_k_ip": (8, 16),
            "middle_block.1.transformer_blocks.0.attn1.to_out.0":
                (16, 16)}.items():
        sd[f"{pre}{mod}.lora_A.default.weight"] = torch.randn(2, din,
                                                              generator=g)
        sd[f"{pre}{mod}.lora_B.default.weight"] = torch.randn(dout, 2,
                                                              generator=g)
    q = pre + "input_blocks.1.1.transformer_blocks.0.attn1.to_q"
    sd[q + ".base_layer.weight"] = torch.randn(8, 8, generator=g)
    o = pre + "middle_block.1.transformer_blocks.0.attn1.to_out.0"
    sd[o + ".base_layer.bias"] = torch.randn(16, generator=g)
    v = pre + "input_blocks.1.1.transformer_blocks.0.attn2.to_v"
    sd[v + ".lora_magnitude_vector.default.weight"] = torch.rand(
        8, generator=g) + 0.5
    path = str(tmp_path / "pixel-diffusion_dora_rank_2.pth")
    torch.save(sd, path)
    before = {k: t.clone() for k, t in pipe.model.state_dict().items()}
    n = fold_lora_checkpoint(pipe, path)
    assert n == j_fold(jpipe, path, verbose=False) == 4
    ref = convert.mvdream_state_dict_from_flax(jpipe.params)
    changed = 0
    for k, t in pipe.model.state_dict().items():
        _close(t, ref[k], rel=1e-5, what=k)
        changed += not torch.equal(t, before[k])
    assert changed == 5                 # four weights and one bias


def _crm_tiny(monkeypatch):
    """The CRM loaders' `init_random` at tiny widths: the six-view samplers
    (the CCM stage's 8 input channels kept) and the reconstructor."""
    from comfy3d_tpu_torch.models.crm import CRMConfig, CRMReconPipeline
    mv = port_cfg(tiny_cfg(num_views=6))
    orig_mv = MVDreamPipeline.init_random.__func__
    orig_crm = CRMReconPipeline.init_random.__func__

    def mv_init(c, seed=0, cfg=None, device=None):
        unet = dataclasses.replace(mv.unet, in_channels=cfg.unet.in_channels)
        return orig_mv(c, seed, dataclasses.replace(mv, unet=unet), device)

    def crm_init(c, seed=0, cfg=None, device=None):
        return orig_crm(c, seed, CRMConfig.tiny(), device)

    monkeypatch.setattr(MVDreamPipeline, "init_random", classmethod(mv_init))
    monkeypatch.setattr(CRMReconPipeline, "init_random",
                        classmethod(crm_init))


def test_crm_graphs_run(roots, monkeypatch):
    """The CRM graph (`chip_smoke.config_graph("crm")`: an RGBA image →
    six views (2 steps) → six CCMs (2 steps) → mesh → GLB) and the T2I V2
    graph (1 step) through `run_workflow(device="cpu")` at tiny widths:
    every node ran; six finite views in [0, 1] equal to the sampler's own
    call with the node's seed and the composited image; a saved mesh."""
    _crm_tiny(monkeypatch)
    chip_smoke.write_reference_images(str(roots / "in"), 32)
    g = chip_smoke.config_graph("crm")
    res = tgraph.run_workflow(g, {4: {"num_inference_steps": 2},
                                  5: {"num_inference_steps": 2}},
                              device="cpu")
    assert sorted(res) == sorted(n["id"] for n in g["nodes"])
    views, ccms = res[4][0], res[5][0]
    assert tuple(views.shape) == tuple(ccms.shape) == (6, 32, 32, 3)
    assert len(res[4][1]) == 6 and res[4][1][0][0] == 1.63634
    for x in (views, ccms):
        assert bool(torch.isfinite(x).all()) and 0 <= float(x.min()) \
            and float(x.max()) <= 1
    mesh = res[7][0]
    assert mesh.num_faces > 0 and int(mesh.f.max()) < mesh.num_vertices
    assert os.path.exists(res[8][0])
    from comfy3d_tpu_torch.nodes.nodes_crm import _masked_ref
    img, mask = res[1][0], res[2][0]
    direct = res[3][0](image=_masked_ref(img, mask), num_inference_steps=2,
                       guidance_scale=5.5,
                       generator=torch.Generator().manual_seed(1234))
    assert torch.equal(direct.cpu(), views)

    g = chip_smoke.config_graph("crm_t2i")
    res = tgraph.run_workflow(g, {4: {"num_inference_steps": 1}},
                              device="cpu")
    assert tuple(res[4][0].shape) == (6, 32, 32, 3)
    assert bool(torch.isfinite(res[4][0]).all())


def test_clipped_weld_drops_faces_past_its_vertices():
    """ROADMAP C.6: a random 9³ field at a capacity of 100 triangles and
    vertices clips the soup and then the weld (300 points, 100 rows).
    `extract_isosurface_device(on_overflow="warn")` keeps only the faces
    whose three vertices it kept, the last vertex renumbered to its row,
    and says how many it dropped; those faces index the same points as
    JAX's (which keeps the others, indexing past its rows)."""
    g = np.random.RandomState(0).randn(9, 9, 9).astype(np.float32)
    with pytest.warns(UserWarning, match=r"faces dropped"):
        v, f, nv, nf = tetra.extract_isosurface_device(
            torch.as_tensor(g), max_tris=100, on_overflow="warn")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jv, jf, jnv, jnf = jtet.extract_isosurface_device(
            jnp.asarray(g), max_tris=100, on_overflow="warn")
    jv, jf = np.asarray(jv), np.asarray(jf)[:int(jnf)]
    assert nv == int(jnv) == 100 and 0 < nf < int(jnf)
    np.testing.assert_array_equal(_np(v), jv)
    f = _np(f)
    assert (f[:nf] < nv).all() and not f[nf:].any()
    soup, count, _ = tetra.marching_tets_grid(torch.as_tensor(g), max_tris=100)
    _, full, nv_all, nfull, _ = tetra.weld_device(soup, count,
                                                  max_verts=3 * 100)
    full, last = _np(full)[:nfull], nv_all - 1
    keep = ~(((full >= 99) & (full != last)).any(1))
    np.testing.assert_array_equal(f[:nf], np.where(full[keep] == last, 99,
                                                   full[keep]))
    assert (jf >= 100).any()            # JAX's faces past its vertices
