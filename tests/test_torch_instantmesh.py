"""Port parity, InstantMesh posed views → triplanes → field: the adaLN ViT
block and encoder, the transformer block and triplane transformer, the four
decoder heads, `forward_planes` with the geometry and colour queries, and
the state dict in the upstream checkpoint's layout, `comfy3d_tpu_torch`
against `comfy3d_tpu` on the same numpy inputs and weights (flax params
carried across by `convert.instantmesh_state_dict_from_flax`)."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.models.instantmesh import model as jm
from comfy3d_tpu.models.instantmesh.convert import convert_instantmesh
from comfy3d_tpu.models.instantmesh.pipeline import \
    InstantMeshPipeline as JPipeline

from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.models.instantmesh import model as tm
from comfy3d_tpu_torch.models.instantmesh import (InstantMeshConfig,
                                                  InstantMeshPipeline)

from tests.test_torch_common import (QUICK_XLA, _load, _np, _params,
                                     one_torch_thread)  # noqa: F401

# tiny: 64² views with patch 16 (a 4² grid) against a checkpoint grid of 3²,
# so the position grid is resized; the encoder's width (24) differs from
# the transformer's (32), so the cross-attention keeps separate q/k/v
TINY = dict(encoder_feat_dim=24, transformer_dim=32, transformer_layers=2,
            transformer_heads=4, triplane_low_res=4, triplane_high_res=8,
            triplane_dim=8, grid_res=16, decoder_hidden=16, decoder_layers=4,
            vit_layers=2, vit_heads=2, vit_mlp=48, patch=16,
            vit_pretrain_grid=3)
IMG = 64
# outputs against the JAX package: within this share of their largest value
REL = 1e-4


def _close(out, ref, rel=REL, what=""):
    out, ref = _np(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())


def init_all(mdl, images, cameras, pts, wfeats):
    """Every parameter of the flax InstantMesh, the weight head's too."""
    planes = mdl(images, cameras)
    sdf, deform = mdl.query_geometry(planes[0], pts)
    return (sdf, deform, mdl.query_color(planes[0], pts),
            mdl.decoder(wfeats, "weight"))


def _inputs(seed=0, views=2):
    rng = np.random.RandomState(seed)
    imgs = rng.rand(1, views, IMG, IMG, 3).astype(np.float32)
    cams = rng.randn(1, views, 16).astype(np.float32)
    # a few points outside the grid_scale box, where the planes read zero
    pts = ((rng.rand(300, 3) * 2 - 1) * 1.05 * 1.1).astype(np.float32)
    wfeats = rng.randn(9, 24 * TINY["triplane_dim"]).astype(np.float32)
    return imgs, cams, pts, wfeats


@pytest.fixture(scope="module")
def params():
    """Every flax leaf redrawn from a seed: the adaLN heads, which flax
    starts at zero, the cls token and the position grids included."""
    return _params(jm.InstantMesh(jm.InstantMeshConfig(**TINY)),
                   *map(jnp.asarray, _inputs()), method=init_all, seed=4)


def _block_case(name):
    """(flax module, numpy inputs, port module, flax params → state dict,
    numpy inputs → port inputs, port output → the JAX layout)."""
    rng = np.random.RandomState(1)
    x24 = rng.randn(2, 7, 24).astype(np.float32)
    x32 = rng.randn(2, 9, 32).astype(np.float32)
    same = (lambda *a: a, lambda y: y)
    if name == "vit_block_adaln":
        return (jm.ViTBlockAdaLN(24, 2, 48),
                (x24, rng.randn(2, 24).astype(np.float32)),
                tm.ViTBlockAdaLN(24, 2, 48),
                convert.vit_adaln_block_state_dict_from_flax, *same)
    if name == "dino_adaln":
        imgs = rng.rand(2, IMG, IMG, 3).astype(np.float32)
        return (jm.DinoAdaLN(24, 2, 2, 48, 16, 3),
                (imgs, rng.randn(2, 16).astype(np.float32)),
                tm.DinoAdaLN(24, 2, 2, 48, 16, 3),
                convert.dino_adaln_state_dict_from_flax,
                lambda i, c: (i.permute(0, 3, 1, 2), c), lambda y: y)
    if name == "lrm_block":
        return (jm.LRMBlock(32, 4), (x32, x24), tm.LRMBlock(32, 4, 24),
                convert.lrm_block_state_dict_from_flax, *same)
    assert name == "triplane_transformer"
    return (jm.TriplaneTransformer(jm.InstantMeshConfig(**TINY)), (x24,),
            tm.TriplaneTransformer(InstantMeshConfig(**TINY)),
            convert.triplane_transformer_state_dict_from_flax,
            lambda a: (a,), lambda y: y.permute(0, 1, 3, 4, 2))


@pytest.mark.parametrize("name", ["vit_block_adaln", "dino_adaln",
                                  "lrm_block", "triplane_transformer"])
def test_block_matches_jax(name):
    """Each module with all its weights redrawn (≤ 1e-4 of the max)."""
    jmod, args, tmod, to_sd, to_torch, to_jax_layout = _block_case(name)
    p = _params(jmod, *map(jnp.asarray, args), seed=5)
    ref = jax.jit(jmod.apply, compiler_options=QUICK_XLA)(
        {"params": p}, *map(jnp.asarray, args))
    _load(tmod, to_sd(p))
    with torch.no_grad():
        out = tmod(*to_torch(*map(torch.as_tensor, args)))
    _close(to_jax_layout(out), ref, what=name)


def test_decoder_heads_match_jax():
    """sdf, deformation, rgb (sigmoid·1.002 − 0.001) and the cube weights
    (×0.1, over 8·3C features), ≤ 1e-4 of the max."""
    rng = np.random.RandomState(2)
    c = TINY["triplane_dim"]
    feats = rng.randn(40, 3 * c).astype(np.float32)
    wfeats = rng.randn(40, 24 * c).astype(np.float32)

    def all_modes(mdl, f, wf):
        return [mdl(f, m) for m in ("sdf", "deformation", "rgb")] \
            + [mdl(wf, "weight")]

    jdec = jm.OSGDecoder(c, 16, 4)
    p = _params(jdec, jnp.asarray(feats), jnp.asarray(wfeats),
                method=all_modes, seed=6)
    refs = jax.jit(functools.partial(jdec.apply, method=all_modes),
                   compiler_options=QUICK_XLA)({"params": p}, feats, wfeats)
    dec = _load(tm.OSGDecoder(c, 16, 4),
                convert.osg_decoder_state_dict_from_flax(p))
    with torch.no_grad():
        outs = [dec(torch.as_tensor(f), m) for f, m in (
            (feats, "sdf"), (feats, "deformation"), (feats, "rgb"),
            (wfeats, "weight"))]
    for out, ref, m in zip(outs, refs, ("sdf", "deformation", "rgb",
                                        "weight")):
        _close(out, ref, what=m)
    with pytest.raises(ValueError):
        dec(torch.as_tensor(feats), "density")


def test_forward_planes_and_queries_match_jax(params):
    """Two posed 64² views → triplanes, then SDF, deformation and colour at
    points inside and outside the box, both pipelines (≤ 1e-4 of the
    max)."""
    imgs, cams, pts, _ = _inputs(seed=3)
    jpipe = JPipeline(jax.tree.map(jnp.asarray, params),
                      jm.InstantMeshConfig(**TINY))
    pipe = InstantMeshPipeline(_load(
        tm.InstantMesh(InstantMeshConfig(**TINY)),
        convert.instantmesh_state_dict_from_flax(params)))
    ref = np.asarray(jpipe.forward_planes(imgs, cams))
    planes = pipe.forward_planes(imgs, cams)
    assert tuple(planes.shape) == (1, 3, 8, 8, 8)
    _close(planes.permute(0, 1, 3, 4, 2), ref, what="planes")

    def queries(mdl, planes, p):
        return mdl.query_geometry(planes, p) + (mdl.query_color(planes, p),)

    # both queries from one compile
    sdf, deform, rgb = jax.jit(functools.partial(
        jm.InstantMesh(jm.InstantMeshConfig(**TINY)).apply,
        method=queries), compiler_options=QUICK_XLA)(
        {"params": params}, ref[0], pts)
    shared = torch.tensor(ref[0]).permute(0, 3, 1, 2)
    with torch.no_grad():
        t_sdf, t_deform = pipe.model.query_geometry(shared,
                                                    torch.as_tensor(pts))
        t_rgb = pipe.model.query_color(shared, torch.as_tensor(pts))
    for out, r, what in ((t_sdf, sdf, "sdf"), (t_deform, deform, "deform"),
                         (t_rgb, rgb, "rgb")):
        _close(out, r, what=what)
    # the deformation is bounded to a quarter of a grid_res cell
    assert np.abs(_np(t_deform)).max() <= 2.1 / (16 * 4.0) + 1e-7


def test_state_dict_round_trip_through_the_jax_converter(params, tmp_path):
    """flax params → the port's state dict → the JAX package's
    `convert_instantmesh`, which reads the upstream checkpoint's key names,
    → the same params leaf for leaf; a saved state dict loads strictly with
    `from_pretrained`; a seed gives the same weights every time."""
    cfg = InstantMeshConfig(**TINY)
    model = _load(tm.InstantMesh(cfg),
                  convert.instantmesh_state_dict_from_flax(params))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert "transformer.layers.0.self_attn.in_proj_weight" in sd
    assert "transformer.layers.1.cross_attn.k_proj_weight" in sd
    assert "encoder.model.encoder.layer.1.adaLN_modulation.1.bias" in sd
    tree = convert_instantmesh(sd, hidden=16, layers=4)
    flat = jax.tree_util.tree_leaves_with_path(params)
    back = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(back) == len(flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(back[path], leaf,
                                      err_msg=jax.tree_util.keystr(path))

    path = tmp_path / "instant_mesh.ckpt"
    torch.save({"state_dict": model.state_dict()}, path)
    loaded = InstantMeshPipeline.from_pretrained(str(path), cfg, device="cpu")
    for k, v in loaded.model.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    torch.save({k: v for k, v in model.state_dict().items()
                if "adaLN" not in k}, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        InstantMeshPipeline.from_pretrained(str(path), cfg, device="cpu")

    key = "encoder.model.encoder.layer.0.adaLN_modulation.1.weight"
    a = InstantMeshPipeline.init_random(3, cfg, device="cpu").model
    b = InstantMeshPipeline.init_random(3, cfg, device="cpu").model
    c = InstantMeshPipeline.init_random(4, cfg, device="cpu").model
    assert torch.equal(a.state_dict()[key], b.state_dict()[key])
    assert not torch.equal(a.state_dict()[key], c.state_dict()[key])
    assert a.state_dict()[key].abs().max() > 0       # not flax's zero init
