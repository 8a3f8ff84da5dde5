"""Port parity, the node layer (`comfy3d_tpu_torch/nodes/`): the registry
and each class's protocol against the JAX package's, the workflow executor
against JAX's on graphs of model-free nodes, and configs 1 and 2 as graphs
(`chip_smoke.config_graph`) at tiny sizes, `comfy3d_tpu_torch` against
`comfy3d_tpu` on the same files and weights (TripoSR's flax params carried
across by `convert.triposr_state_dict_from_flax`). IMAGE and MASK edges
are CPU torch tensors in the port and numpy arrays in the JAX package."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import os
import re

import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
import comfy3d_tpu.nodes as jnodes
import comfy3d_tpu_torch.nodes as tnodes
from comfy3d_tpu.models.triposr import TripoSR as JTripoSR
from comfy3d_tpu.models.triposr import TripoSRConfig as JConfig
from comfy3d_tpu.models.triposr import TripoSRPipeline as JPipeline
from comfy3d_tpu.nodes import base as jbase
from comfy3d_tpu.nodes import graph as jgraph
from comfy3d_tpu.ops import volume as jvol
from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.core.io.ply import save_gs_ply
from comfy3d_tpu_torch.models.triposr import (TripoSR, TripoSRConfig,
                                              TripoSRPipeline)
from comfy3d_tpu_torch.nodes import base as tbase
from comfy3d_tpu_torch.nodes import graph as tgraph
from comfy3d_tpu_torch.ops import volume

from tests.test_torch_common import (_load, _np, _params,  # noqa: F401
                                     one_torch_thread, quick_jax_renderers)
from tests.test_torch_triposr import TINY, _separated_threshold

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def roots(tmp_path, monkeypatch):
    """Both packages' input, output and checkpoint roots under tmp_path."""
    for name in ("in", "out", "ckpt"):
        os.makedirs(tmp_path / name)
    for b in (jbase, tbase):
        monkeypatch.setattr(b, "INPUT_ROOT_PATH", str(tmp_path / "in"))
        monkeypatch.setattr(b, "OUTPUT_ROOT_PATH", str(tmp_path / "out"))
        monkeypatch.setattr(b, "CKPT_ROOT_PATH", str(tmp_path / "ckpt"))
    return tmp_path


def _host(x):
    """An edge's value as numpy (tensors, arrays, lists and tuples of
    them), to compare the packages' results."""
    if torch.is_tensor(x):
        return _np(x)
    if isinstance(x, np.ndarray) or type(x).__module__.startswith("jax"):
        return np.asarray(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


def _assert_same(a, b, atol, what):
    if isinstance(a, np.ndarray):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=what)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, atol, f"{what}[{i}]")
    else:
        assert a == b, what


def test_registry_and_protocol_match_jax(roots):
    """Every key the port registers is the JAX package's, with an equal
    protocol under one checkpoint root (a file there lists in the loaders'
    combos); the keys left out are `UNPORTED`'s, each named in ROADMAP.md
    with its item."""
    os.makedirs(roots / "ckpt" / "TripoSR")
    (roots / "ckpt" / "TripoSR" / "other.ckpt").write_bytes(b"")
    jk, tk = set(jnodes.NODE_CLASS_MAPPINGS), set(tnodes.NODE_CLASS_MAPPINGS)
    assert tk <= jk and len(tk) == 88
    assert jk - tk == set(tnodes.UNPORTED)
    for key in sorted(tk):
        j, t = jnodes.NODE_CLASS_MAPPINGS[key], tnodes.NODE_CLASS_MAPPINGS[key]
        assert t.__module__.startswith("comfy3d_tpu_torch."), key
        assert t.__name__ == j.__name__, key
        assert t.INPUT_TYPES() == j.INPUT_TYPES(), key
        for attr in ("RETURN_TYPES", "RETURN_NAMES", "FUNCTION", "CATEGORY",
                     "OUTPUT_NODE"):
            assert getattr(t, attr, None) == getattr(j, attr, None), \
                (key, attr)
    assert "other.ckpt" in tnodes.NODE_CLASS_MAPPINGS[
        "[Comfy3D] Load TripoSR Model"].INPUT_TYPES()["required"][
        "model_name"][0]
    # two modules register this key; the later import answers, as in JAX
    assert tnodes.NODE_CLASS_MAPPINGS[
        "[Comfy3D] Convert Vertex Color To Texture"].__module__.endswith(
        "nodes_texture")
    # the list's names, whatever the line breaks in them
    roadmap = " ".join(open(os.path.join(ROOT, "ROADMAP.md")).read().split())
    for key, item in tnodes.UNPORTED.items():
        assert f"`{key.replace('[Comfy3D] ', '')}`" in roadmap, key
        assert re.match(r"A\.10 \w", item), (key, item)


class _Probe:
    """A model-free node with a seed, a combo and optional widgets: its
    result names the arguments it was called with."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"image": ("IMAGE",),
                             "seed": ("INT", {"default": 0}),
                             "scale": ("FLOAT", {"default": 1.0}),
                             "label": (["a", "b"],)},
                "optional": {"note": ("STRING", {"default": ""}),
                             "extra": ("FLOAT", {"default": 2.0})}}

    RETURN_TYPES = ("IMAGE", "STRING")
    FUNCTION = "run"
    CATEGORY = "test"

    def run(self, image, seed=0, scale=1.0, label="a", note="", extra=2.0):
        return image * scale, f"{seed}|{scale}|{label}|{note}|{extra}"


def _image_file(path, size=32):
    chip_smoke.write_reference_images(str(path), size)


def test_executor_matches_jax(roots, monkeypatch):
    """The same graph dicts through both executors: widgets converted to
    inputs (their placeholders popped, a linked seed's trailing string
    too), a seed widget's `control_after_generate`, optional widgets that
    run out, a muted node, an output node's dict result, a Reroute; then a
    cycle and unknown and unported types raise `WorkflowError`."""
    for m in (jnodes.NODE_CLASS_MAPPINGS, tnodes.NODE_CLASS_MAPPINGS):
        monkeypatch.setitem(m, "Probe", _Probe)
    _image_file(roots / "in")
    g = chip_smoke.workflow(
        (1, "LoadImage", ["reference_rgba.png"], {}),
        (2, "INTConstant", [7], {}),
        (3, "Probe", [123, "randomize", 0.5, "b", "hello"],
         {"image": (1, 0), "seed": (2, 0)}),
        (4, "Probe", [5, "fixed", 2.0, "a"], {"image": (1, 0)}),
        (5, "ImageScale", ["bilinear", 24, 20, "disabled"], {"image": (3, 0)}),
        (6, "Morphology", ["dilate", 3], {"image": (5, 0)}),
        (7, "ImageToMask", ["green"], {"image": (6, 0)}),
        (8, "MaskToImage", [], {"mask": (7, 0)}),
        (9, chip_smoke.C3D + "Make Image Grid", [2, True], {"images": (4, 0)}),
        (10, "SaveImage", ["muted"], {"images": (9, 0)}),
        chip_smoke._orbit(11, 2.0, views=4),
        (12, chip_smoke.C3D + "Get Camposes From List Indexed", ["0, 2"],
         {"original_orbit_camera_poses": (11, 0)}),
        (13, "Note", [], {}),
        (14, "Reroute", [], {"": (8, 0)}),
        (15, "PrimitiveString", ["abc"], {}),
        (16, "SaveImage", ["parity"], {"images": (14, 0)}),
        (17, chip_smoke.C3D + "Image Add Pure Color Background",
         [255, 0, 128], {"images": (1, 0), "masks": (1, 1)}),
        (18, "InvertMask", [], {"mask": (1, 1)}))
    g["nodes"][9]["mode"] = 2
    overrides = {5: {"width": 28}}
    jres = jgraph.run_workflow(g, overrides)
    tres = tgraph.run_workflow(g, overrides, device="cpu")
    assert sorted(tres) == sorted(jres) and 10 not in tres
    assert tres[3][1] == "7|0.5|b|hello|2.0" and tres[4][1] == "5|2.0|a||2.0"
    assert tuple(tres[5][0].shape) == (1, 20, 28, 3) and tres[16] == ()
    for nid in jres:
        _assert_same(_host(jres[nid]), _host(tres[nid]), 1e-6, f"node {nid}")
    for bad, match in (
            ({"nodes": [{"id": 1, "type": "InvertMask",
                         "inputs": [{"name": "mask", "link": 1}]},
                        {"id": 2, "type": "InvertMask",
                         "inputs": [{"name": "mask", "link": 2}]}],
              "links": [[1, 2, 0, 1, 0, "MASK"], [2, 1, 0, 2, 0, "MASK"]]},
             "cycle"),
            (chip_smoke.workflow((1, "NoSuchNode", [], {})), "NoSuchNode"),
            (chip_smoke.workflow((1, "[Comfy3D] StableFast3D", [], {})),
             "StableFast3D")):
        with pytest.raises(tgraph.WorkflowError, match=match):
            tgraph.run_workflow(bad, device="cpu")
        if match != "StableFast3D":
            with pytest.raises(jgraph.WorkflowError, match=match):
                jgraph.run_workflow(bad)


def test_config1_graph_matches_jax(roots, monkeypatch):
    """Config 1 at 64² (phase 13's UV cube through the mesh renderer, a
    300-splat GS-PLY through the GS renderer, 8 views): each node's images
    and masks within 1e-4 of the JAX package's (its renderers jitted with
    `QUICK_XLA`), depths within 1e-3. The
    cube's albedo is 64² and linear in the texel position: the packages'
    UVs differ in their last bits, and a sharper texture (phase 13's
    1024² noise, stored as 8 bits) turns that into visible differences."""
    cube = chip_smoke.uv_cube()
    u = np.linspace(0.0, 1.0, 64, dtype=np.float32)
    uu, vv = np.broadcast_arrays(u[:, None], u[None, :])
    cube.albedo = np.stack([uu, vv, 0.5 * (uu + vv)], -1)
    cube.write(str(roots / "in" / "uv_cube.glb"))
    save_gs_ply(str(roots / "in" / "splat_100k.ply"),
                chip_smoke.make_splat(300, 0.05, 0, "cpu"))
    g = chip_smoke.config_graph(1, gs_size=64)
    overrides = {3: {"render_image_size": 64}}
    quick_jax_renderers(monkeypatch)
    jres = jgraph.run_workflow(g, overrides)
    tres = tgraph.run_workflow(g, overrides, device="cpu")
    assert tres[2] == tuple(jres[2]) or list(tres[2]) == list(jres[2])
    for nid, atols in ((3, (1e-4, 1e-4, 1e-3, 1e-4, 1e-4)),
                       (6, (1e-4, 1e-4, 1e-3))):
        assert len(tres[nid]) == len(atols)
        for k, atol in enumerate(atols):
            assert tuple(tres[nid][k].shape) == np.asarray(jres[nid][k]).shape
            np.testing.assert_allclose(_np(tres[nid][k]),
                                       np.asarray(jres[nid][k]), atol=atol,
                                       rtol=0, err_msg=f"node {nid} out {k}")
    assert 0.0 < float(tres[6][1].mean()) < 1.0
    assert sorted(os.listdir(roots / "out" / "workflows")) == sorted(
        [f"config1_{w}_{i:05d}.png" for w in ("gs", "mesh")
         for i in range(8)])


def test_config2_graph_matches_jax(roots, monkeypatch):
    """Config 2 with a tiny TripoSR (the JAX params carried across): the
    saved meshes' triangles equal within what the two decoded grids'
    difference allows (`test_torch_triposr`'s bound), at an iso value
    with no grid value near it."""
    _image_file(roots / "in", 60)
    cfg = JConfig(**TINY)
    s = cfg.cond_image_size
    params = _params(JTripoSR(cfg), jnp.zeros((1, s, s, 3)),
                     jnp.zeros((4, 3)), method=JTripoSR.init_all, seed=6)
    jpipe = JPipeline(params, cfg)
    tpipe = TripoSRPipeline(_load(TripoSR(TripoSRConfig(**TINY)),
                                  convert.triposr_state_dict_from_flax(
                                      params)))
    from comfy3d_tpu.nodes import nodes_models as jnm
    from comfy3d_tpu_torch.nodes import nodes_models as tnm
    monkeypatch.setattr(jnm.Load_TripoSR_Model, "load_TSR",
                        lambda self, *a, **k: (jpipe,))
    monkeypatch.setattr(tnm.Load_TripoSR_Model, "load_TSR",
                        lambda self, *a, **k: (tpipe,))
    # the iso value from the JAX package's grid of the node's input
    img, mask = jnodes.NODE_CLASS_MAPPINGS["LoadImage"]().load_image(
        "reference_rgba.png")
    m = 1.0 - mask[0][..., None]
    x = img[0] * m + 0.5 * (1.0 - m)
    codes = np.asarray(jpipe.scene_codes(x[None]))[0]
    grid = np.asarray(jvol.decode_grid(
        jpipe._sigma_query, (jpipe.params, jnp.asarray(codes)), 33,
        cfg.radius))
    thr = _separated_threshold(grid)
    gap = np.abs(grid - thr).min()
    tcodes = tpipe.scene_codes(torch.as_tensor(x[None]))[0]
    dgrid = np.abs(_np(volume.decode_grid(
        lambda pts: tpipe.model.query(tcodes, pts)[0], 33, cfg.radius,
        device="cpu")) - grid).max()
    g = chip_smoke.config_graph(2)
    overrides = {4: {"geometry_extract_resolution": 32,
                     "marching_cude_threshold": thr}}
    # the JAX extraction's soup sized for this mesh, not for 2 M
    # triangles (an overflow would double it: the result is the same)
    import types
    from comfy3d_tpu.models.triposr import pipeline as jpipeline
    from comfy3d_tpu.ops import tetra as jtetra
    monkeypatch.setattr(jpipeline, "tetra", types.SimpleNamespace(
        extract_isosurface_device=lambda *a, **kw: (
            jtetra.extract_isosurface_device(*a, **{**kw,
                                                    "max_tris": 65536}))))
    jres = jgraph.run_workflow(g, overrides)
    tres = tgraph.run_workflow(g, overrides, device="cpu")
    from comfy3d_tpu.core.mesh import Mesh as JMesh
    from comfy3d_tpu_torch.core.mesh import Mesh
    ref, out = JMesh.load(jres[6][0]), Mesh.load(tres[6][0])
    assert ref.num_faces > 100 and out.num_faces == ref.num_faces
    # a crossing point moves by ≤ 1.5δ/gap of a cell (test_torch_triposr)
    tol = 1e-6 + 1.5 * (2 * cfg.radius / 32) * dgrid / gap
    assert tol <= 1e-3, (tol, dgrid, gap)
    np.testing.assert_allclose(out.v[out.f], ref.v[ref.f], atol=tol, rtol=0)


def test_nodes_default_to_the_card(roots):
    """`node_device()` is the card outside `run_workflow` and the run's
    device inside; a loader called outside a run builds on the card, which
    this machine lacks."""
    assert tbase.node_device() == torch.device("cuda")
    with tbase.run_device("cpu"):
        assert tbase.node_device() == torch.device("cpu")
    assert tbase.node_device() == torch.device("cuda")
    save_gs_ply(str(roots / "in" / "s.ply"),
                chip_smoke.make_splat(10, 0.05, 0, "cpu"))
    g = chip_smoke.workflow((1, chip_smoke.C3D + "Load 3DGS", ["s.ply"], {}))
    assert tgraph.run_workflow(g, device="cpu")[1][0].device.type == "cpu"
    with pytest.raises((RuntimeError, AssertionError)):
        tgraph.run_workflow(g)
    with pytest.raises((RuntimeError, AssertionError)):
        tnodes.NODE_CLASS_MAPPINGS[
            "[Comfy3D] Load Large Multiview Gaussian Model"]().load_LGM()
