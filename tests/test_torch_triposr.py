"""Port parity, TripoSR image → mesh: the scene codes and field query,
the pipeline end to end, its renders, and the state dict in the public
checkpoint's layout, `comfy3d_tpu_torch` against `comfy3d_tpu` on the same
numpy inputs and weights (flax params carried across by
`convert.triposr_state_dict_from_flax`)."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = pytest.mark.heavy

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.models.triposr import TripoSR as JTripoSR
from comfy3d_tpu.models.triposr import TripoSRConfig as JConfig
from comfy3d_tpu.models.triposr import TripoSRPipeline as JPipeline
from comfy3d_tpu.models.triposr.pipeline import _convert_triposr
from comfy3d_tpu.ops import volume as jvol

from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.models.triposr import (TripoSR, TripoSRConfig,
                                              TripoSRPipeline)
from comfy3d_tpu_torch.ops import volume

from tests.test_torch_common import _load, _np, _params

# tiny, with the ViT's grid (48 / 8 = 6²) unlike its checkpoint grid (4²)
TINY = dict(cond_image_size=48, plane_size=8, token_channels=64,
            num_layers=2, heads=4, dim_head=16, cross_attention_dim=48,
            triplane_channels=8, mlp_neurons=16, mlp_hidden_layers=2,
            vit_hidden=48, vit_layers=2, vit_heads=2, vit_mlp_dim=96,
            vit_patch=8, vit_pretrain_grid=4)


# ------------------------------------------------------------ TripoSR
@pytest.fixture(scope="module")
def pair():
    """The JAX pipeline with drawn weights, the port's pipeline with the
    same weights, and both packages' scene codes of one 2-image batch
    (60² images, resized to the model's 48²)."""
    cfg = JConfig(**TINY)
    s = cfg.cond_image_size
    params = _params(JTripoSR(cfg), jnp.zeros((1, s, s, 3)),
                     jnp.zeros((4, 3)), method=JTripoSR.init_all, seed=6)
    jpipe = JPipeline(jax.tree.map(jnp.asarray, params), cfg)
    pipe = TripoSRPipeline(_load(TripoSR(TripoSRConfig(**TINY)),
                                 convert.triposr_state_dict_from_flax(params)))
    img = np.random.RandomState(7).rand(2, 60, 60, 3).astype(np.float32)
    return jpipe, pipe, np.asarray(jpipe.scene_codes(img)), \
        pipe.scene_codes(img)


def test_scene_codes_and_query_match_jax(pair):
    jpipe, pipe, ref, out = pair
    assert tuple(out.shape) == (2, 3, 8, 16, 16)
    np.testing.assert_allclose(_np(out).transpose(0, 1, 3, 4, 2), ref,
                               atol=1e-4, rtol=0)
    pos = ((np.random.RandomState(8).rand(300, 3) * 2 - 1) * 0.87
           * 1.1).astype(np.float32)                  # some outside the box
    sig, rgb = jpipe.model.apply({"params": jpipe.params},
                                 jnp.asarray(ref[1]), jnp.asarray(pos),
                                 method=JTripoSR.query)
    with torch.no_grad():
        t_sig, t_rgb = pipe.model.query(
            torch.as_tensor(ref[1]).permute(0, 3, 1, 2), torch.as_tensor(pos))
    np.testing.assert_allclose(_np(t_sig), np.asarray(sig), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(_np(t_rgb), np.asarray(rgb), atol=1e-4,
                               rtol=0)


def _separated_threshold(grid, lo_q=0.8, hi_q=0.98):
    """An iso value between the lo_q and hi_q quantiles of the grid, in the
    middle of the widest gap between neighbouring values there, so that no
    vertex lies near it (a sign decided by rounding would make the two
    packages' meshes differ in topology)."""
    v = np.sort(grid.reshape(-1))
    lo, hi = int(lo_q * (v.size - 1)), int(hi_q * (v.size - 1))
    j = lo + int(np.argmax(np.diff(v[lo:hi + 1])))
    return float(0.5 * (v[j] + v[j + 1]))


def _corners(mesh):
    """Each face's three corner positions, in face order: the triangles,
    whatever the vertex numbering."""
    return mesh.v[mesh.f]


@pytest.fixture(scope="module")
def jax_grid(pair):
    """The JAX package's 33³ density grid of image 1 (the lattice
    `extract_mesh` reads at resolution 32, bumped to 33) and an iso value
    with no grid value near it."""
    jpipe, _, jcodes, _ = pair
    jgrid = np.asarray(jvol.decode_grid(
        jpipe._sigma_query, (jpipe.params, jnp.asarray(jcodes[1])), 33,
        jpipe.cfg.radius))
    return jgrid, _separated_threshold(jgrid)


def test_pipeline_image_to_mesh_matches_jax(pair, jax_grid):
    """Each package from its own scene codes of the same image: the same
    triangles in the same order, each corner within the error that the
    two decoded grids' difference allows."""
    jpipe, pipe, jcodes, codes = pair
    jgrid, thr = jax_grid
    radius = jpipe.cfg.radius
    grid = _np(volume.decode_grid(
        lambda pts: pipe.model.query(codes[1], pts)[0], 33, radius,
        device="cpu"))
    gap = np.abs(jgrid - thr).min()
    dgrid = np.abs(grid - jgrid).max()
    assert gap >= 1e-4 and dgrid <= 1e-5 * np.abs(jgrid).max()
    ref = jpipe.extract_mesh(jnp.asarray(jcodes[1]), resolution=32,
                             threshold=thr, max_tris=20_000)
    mesh = pipe.extract_mesh(codes[1], resolution=32, threshold=thr,
                             max_tris=20_000)
    assert ref.num_faces > 100 and mesh.num_faces == ref.num_faces
    # a crossing point moves by ≤ 3δ/|va − vb| ≤ 1.5δ/gap of a cell; that
    # bound is held under 1e-3 (2 % of a 33³ cell), so a decode that puts
    # corners off their edges' crossings cannot pass
    tol = 1e-6 + 1.5 * (2 * radius / 32) * dgrid / gap
    assert tol <= 1e-3, (tol, dgrid, gap)
    np.testing.assert_allclose(_corners(mesh), _corners(ref), atol=tol,
                               rtol=0)
    # the weld merges points that round to one 1e-6 lattice point; two
    # copies of a point (computed along an edge from either end) can
    # straddle a rounding boundary in one package and not the other
    assert abs(mesh.num_vertices - ref.num_vertices) <= \
        max(2, ref.num_vertices // 1000)
    # colours are uint8-quantized: equal, or one step apart where the two
    # packages' rgb straddle a rounding boundary
    assert np.abs(mesh.vc[mesh.f] - ref.vc[ref.f]).max() <= 1 / 255 + 1e-7


def test_pipeline_extracts_jaxs_mesh_from_one_grid(pair, jax_grid,
                                                   monkeypatch):
    """Both packages' `extract_mesh` on one decoded grid: the bump to 33,
    the bounds, the iso value and the capacity reach the extraction alike,
    and the meshes are equal element for element (colours within one
    uint8 step). The clip under overflow is held in
    tests/test_torch_tetra.py."""
    jpipe, pipe, jcodes, codes = pair
    jgrid, thr = jax_grid
    asked = []

    def fixed(lib):
        def decode(query_fn, *args, **kw):
            asked.append(args[-2] if lib is jnp else args[0])
            return lib.asarray(jgrid)
        return decode

    monkeypatch.setattr(jvol, "decode_grid", fixed(jnp))
    monkeypatch.setattr(volume, "decode_grid", fixed(torch))
    kw = dict(resolution=32, threshold=thr, max_tris=20_000)
    ref = jpipe.extract_mesh(jnp.asarray(jcodes[1]), **kw)
    mesh = pipe.extract_mesh(codes[1], **kw)
    assert asked == [33, 33] and ref.num_faces > 100
    for name in ("v", "f", "vn"):
        np.testing.assert_array_equal(getattr(mesh, name), getattr(ref, name),
                                      err_msg=name)
    assert np.abs(mesh.vc - ref.vc).max() <= 1 / 255 + 1e-7


def test_render_matches_jax(pair):
    from comfy3d_tpu.core.camera import Camera as JCamera

    from comfy3d_tpu_torch.core.camera import Camera
    jpipe, pipe, jcodes, _ = pair
    codes = jcodes[0]
    jcam = JCamera.from_orbit(15.0, 30.0, 2.0, width=12, height=10)
    ref = jpipe.render(jnp.asarray(codes), jcam, num_steps=24)
    cam = Camera.from_orbit(15.0, 30.0, 2.0, width=12, height=10,
                            device="cpu")
    out = pipe.render(torch.as_tensor(codes).permute(0, 3, 1, 2), cam,
                      num_steps=24, chunk_rays=50)
    for k in ("rgb", "alpha", "depth"):
        assert tuple(out[k].shape) == ref[k].shape, k
        np.testing.assert_allclose(_np(out[k]), np.asarray(ref[k]),
                                   atol=1e-4, rtol=0, err_msg=k)


def test_state_dict_round_trip_through_the_jax_converter(tmp_path):
    """The port's seeded weights, in the checkpoint layout, go through the
    JAX package's `_convert_triposr` (which reads the upstream key names)
    and back unchanged, and both packages then compute the same codes; a
    saved state dict loads strictly with `from_pretrained`."""
    cfg = TripoSRConfig(**TINY)
    pipe = TripoSRPipeline.init_random(3, cfg, device="cpu")
    sd = {k: v.numpy() for k, v in pipe.model.state_dict().items()}
    s = cfg.cond_image_size
    template = jax.tree.map(np.zeros_like, _params(
        JTripoSR(JConfig(**TINY)), jnp.zeros((1, s, s, 3)),
        jnp.zeros((4, 3)), method=JTripoSR.init_all))
    params = _convert_triposr(dict(sd), template)
    back = convert.triposr_state_dict_from_flax(params)
    assert sorted(back) == sorted(sd)
    for k, v in back.items():
        if k.startswith("image_tokenizer.model.pooler."):
            continue                  # the JAX model has no pooler
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    img = np.random.RandomState(11).rand(1, 48, 48, 3).astype(np.float32)
    ref = jax.jit(JTripoSR(JConfig(**TINY)).apply)({"params": params},
                                                   jnp.asarray(img))
    np.testing.assert_allclose(_np(pipe.scene_codes(img)).transpose(
        0, 1, 3, 4, 2), np.asarray(ref), atol=1e-4, rtol=0)
    path = tmp_path / "model.ckpt"
    torch.save(pipe.model.state_dict(), path)
    loaded = TripoSRPipeline.from_pretrained(str(path), cfg, device="cpu")
    for k, v in loaded.model.state_dict().items():
        assert torch.equal(v, pipe.model.state_dict()[k]), k
    # the same seed gives the same weights; another seed other weights
    again = TripoSRPipeline.init_random(3, cfg, device="cpu").model
    other = TripoSRPipeline.init_random(4, cfg, device="cpu").model
    key = "backbone.transformer_blocks.0.attn1.to_q.weight"
    assert torch.equal(again.state_dict()[key], sd_t := torch.as_tensor(
        sd[key]))
    assert not torch.equal(other.state_dict()[key], sd_t)
    with pytest.raises(RuntimeError, match="Missing key"):
        torch.save({k: v for k, v in pipe.model.state_dict().items()
                    if "pooler" not in k}, path)
        TripoSRPipeline.from_pretrained(str(path), cfg, device="cpu")


def test_config_matches_jax():
    assert dataclasses.asdict(TripoSRConfig()) == \
        dataclasses.asdict(JConfig())


def test_entry_points_default_to_the_card():
    """Without a `device`, the slice's entry points place their tensors on
    the card; there is no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError)):
        TripoSRPipeline.init_random(0, TripoSRConfig(**TINY))
    with pytest.raises((AssertionError, RuntimeError)):
        volume.grid_points(3, 1.0)
