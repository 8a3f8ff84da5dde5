"""Port parity and runs, the node layer's glue and model nodes: the
preprocessing, vendor and Hunyuan3D glue nodes against the JAX package's
on numpy inputs from a seed, then configs 3, 4 and 5 (the ShapeGen and
TexGen halves linked through the saved file) as graphs
(`chip_smoke.config_graph`) at tiny sizes on the CPU, port only (each
package draws its noise from its own generator), and `Load_Diffusers_
Pipeline` reading a Zero123Plus directory under the checkpoint root."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import dataclasses
import json
import os

import numpy as np
import torch

import chip_smoke
import comfy3d_tpu.nodes as jnodes
import comfy3d_tpu_torch.nodes as tnodes
from comfy3d_tpu.core.gaussian import GaussianSplat as JSplat
from comfy3d_tpu.core.mesh import Mesh as JMesh
from comfy3d_tpu.nodes import nodes_hunyuan3d as jhy
from comfy3d_tpu_torch.algorithms import gs_to_mesh as tgm
from comfy3d_tpu_torch.algorithms import ngp as tngp
from comfy3d_tpu_torch.core.gaussian import GaussianSplat
from comfy3d_tpu_torch.core.mesh import Mesh
from comfy3d_tpu_torch.models.diffusion import UNetConfig, VAEConfig
from comfy3d_tpu_torch.models.hunyuan3d import (Hunyuan3DPaintPipeline,
                                                Hunyuan3DShapeConfig,
                                                Hunyuan3DShapePipeline,
                                                PaintConfig)
from comfy3d_tpu_torch.models.instantmesh import (InstantMeshConfig,
                                                  InstantMeshPipeline)
from comfy3d_tpu_torch.models.lgm import LGMConfig, LGMPipeline
from comfy3d_tpu_torch.models.mvdream import MVDreamConfig, MVDreamPipeline
from comfy3d_tpu_torch.models.zero123plus import (Zero123PlusConfig,
                                                  Zero123PlusPipeline)
from comfy3d_tpu_torch.nodes import graph as tgraph
from comfy3d_tpu_torch.nodes import nodes_hunyuan3d as thy
from comfy3d_tpu_torch.nodes import nodes_texture as ttex
from comfy3d_tpu_torch.ops import hashgrid

from tests.test_torch_common import _np, one_torch_thread  # noqa: F401
from tests.test_torch_instantmesh import TINY as IM_TINY
from tests.test_torch_lgm import TINY as LGM_TINY
from tests.test_torch_nodes import _assert_same, _host, roots  # noqa: F401

C3D = chip_smoke.C3D
UNET = UNetConfig(block_out_channels=(8, 16), layers_per_block=1,
                  cross_attention_dim=16, attention_head_dim=4,
                  norm_groups=4,
                  down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                  up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))
VAE = VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                norm_groups=4)


def _mesh(pkg_mesh, seed=0, n=12):
    """A lumpy UV sphere with vertex colours, as `pkg_mesh`."""
    rng = np.random.RandomState(seed)
    th, ph = np.meshgrid(np.linspace(0.1, np.pi - 0.1, n),
                         np.linspace(0, 2 * np.pi, 2 * n, endpoint=False),
                         indexing="ij")
    r = 0.5 + 0.05 * rng.rand(*th.shape)
    v = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                  r * np.cos(th)], -1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(v.shape[0]).reshape(n, 2 * n)
    a, b = idx[:-1], np.roll(idx, -1, 1)[:-1]
    c, d = idx[1:], np.roll(idx, -1, 1)[1:]
    f = np.concatenate([np.stack([a, c, b], -1).reshape(-1, 3),
                        np.stack([b, c, d], -1).reshape(-1, 3)])
    f = np.concatenate([f, f[:3]])                # duplicate faces to clean
    return pkg_mesh(v=v, f=f.astype(np.int32),
                    vc=rng.rand(*v.shape).astype(np.float32)).auto_normal()


def _mesh_host(m):
    return [np.asarray(m.v), np.asarray(m.f)] + (
        [np.asarray(m.vn)] if m.vn is not None else [])


def _both(key, args, kwargs=None, atol=1e-6):
    """One node of each package on the same inputs: numpy (and the JAX
    package's meshes and splats) there, CPU tensors (and the port's) here;
    the results compared as numpy."""
    kwargs = kwargs or {}

    def conv(x, port):
        if isinstance(x, np.ndarray):
            return torch.as_tensor(x) if port else x
        if isinstance(x, tuple) and x and x[0] == "mesh":
            return _mesh(Mesh if port else JMesh, *x[1:])
        if isinstance(x, tuple) and x and x[0] == "splat":
            pts = np.random.RandomState(x[1]).rand(50, 3).astype(np.float32)
            cols = np.random.RandomState(x[1] + 1).rand(50, 3)
            return (GaussianSplat.from_points(pts, cols, capacity=64,
                                              device="cpu") if port
                    else JSplat.from_points(pts, cols, capacity=64))
        return x

    outs = []
    for m, port in ((jnodes.NODE_CLASS_MAPPINGS, False),
                    (tnodes.NODE_CLASS_MAPPINGS, True)):
        cls = m[key]
        out = getattr(cls(), cls.FUNCTION)(
            *[conv(a, port) for a in args],
            **{k: conv(v, port) for k, v in kwargs.items()})
        if isinstance(out, dict):
            out = out["result"]
        outs.append(out)

    def norm(o):
        if isinstance(o, (Mesh, JMesh)):
            return _mesh_host(o)
        if isinstance(o, (GaussianSplat, JSplat)):
            return [_host(getattr(o, k)) for k in ("xyz", "sh", "opacity_raw",
                                                     "scale_raw", "rot_raw",
                                                     "alive")]
        if isinstance(o, dict):
            return [_host(o[k]) for k in sorted(o)]
        if isinstance(o, (list, tuple)):
            return [norm(x) for x in o]
        return _host(o)

    _assert_same(norm(outs[0]), norm(outs[1]), atol, key)
    return outs[1]


def _images(seed, n=2, h=20, w=24, c=3):
    rng = np.random.RandomState(seed)
    return rng.rand(n, h, w, c).astype(np.float32)


def _disc(seed, n=2, h=20, w=24):
    yy, xx = np.mgrid[:h, :w] + 0.5
    m = ((yy - h / 2) ** 2 + (xx - w / 2.5) ** 2) < (0.3 * h) ** 2
    return np.repeat(m[None], n, 0).astype(np.float32)


def test_preprocess_nodes_match_jax():
    imgs, masks = _images(1), _disc(1)
    _both(C3D + "Image Add Pure Color Background", (imgs, masks, 10, 200, 30))
    _both(C3D + "Resize Image Foreground", (imgs, masks, 0.7), atol=1e-5)
    for n, side, rows in ((5, 2, True), (6, 3, False), (4, 1, True)):
        grid = _both(C3D + "Make Image Grid", (_images(2, n), side, rows))[0]
        _both(C3D + "Split Image Grid", (_np(grid), side, rows))
    normals = _images(3)
    normals[:, :4] = (0.5, 0.5, 1.0)
    _both(C3D + "Get Masks From Normal Maps", (normals,))
    _both(C3D + "Rotate Normal Maps Horizontally", (normals, masks, 37.0))
    _both(C3D + "Switch Mesh Axis", (("mesh",), "-z", "+x", "-y", True))
    _both(C3D + "Switch 3DGS Axis", (("splat", 4), "+y", "-z", "+x"))
    _both(C3D + "Convert Mesh To Pointcloud", (("mesh",),))
    _both(C3D + "Convert 3DGS To Pointcloud", (("splat", 5),))
    poses = _both(C3D + "Stack Orbit Camera Poses",
                  (1.5, 2.5, 0.5, -10.0, 20.0, 15.0, 30.0, 300.0, 90.0))[0]
    _both(C3D + "Get Camposes From List Indexed", (poses, "0, 3,5"))
    _both(C3D + "Fast Clean Mesh", (("mesh",), 1e-4, 0.05))
    _both(C3D + "Decimate Mesh", (("mesh",), 200, True, True), atol=1e-5)


def test_vendor_nodes_match_jax(roots, monkeypatch):
    # the JAX module binds the input root at import
    monkeypatch.setattr(jnodes.nodes_vendor, "INPUT_ROOT_PATH",
                        str(roots / "in"))
    imgs, masks = _images(4, c=4), _disc(4)
    for method in ("nearest-exact", "bilinear", "area", "bicubic",
                   "lanczos"):
        for w, h in ((13, 9), (40, 31)):
            _both("ImageScale", (imgs[..., :3], method, w, h, "disabled"),
                  atol=2e-6)
    _both("ImageToMask", (imgs, "alpha"))
    _both("MaskToImage", (masks,))
    _both("ConvertToGrayscale", (imgs[..., :3],))
    _both("MergeImageChannels", (imgs[:1], imgs[1:], imgs[:1]),
          {"mask": masks[:1]})
    _both("GetImagesFromBatchIndexed", (imgs, "1, 0,5"))
    _both("ImageListToImageBatch", (imgs,))
    for kw in ({}, {"only_mask": True}, {"transparency": False,
                                         "background_color": "white"}):
        _both("Image Rembg (Remove Background)", (imgs[..., :3],), kw)
    for op in ("erode", "dilate", "open", "close", "gradient", "top_hat",
               "bottom_hat"):
        _both("Morphology", (imgs[..., :3], op, 5))
    _both("ResizeMask", (masks, 13, 17, False), atol=2e-6)
    _both("RemapImageRange", (imgs, 0.2, 1.3, True))
    _both("Eden_IMG_padder", (imgs, 0.25))
    _both("VHS_MergeImages", (imgs[..., :3], _images(5, 3, 8, 8),
                              "match B", "bilinear", "none"), atol=2e-6)
    import cv2
    for i, im in enumerate(_images(6, 3, 10, 12, 4)):
        q = np.round(im * 255).astype(np.uint8)
        cv2.imwrite(str(roots / "in" / f"v{i}.png"),
                    cv2.cvtColor(q, cv2.COLOR_RGBA2BGRA))
    _both("VHS_LoadImagesPath", ("", 2, 1, 1))
    _both("LoadImagesFromDir //Inspire", (str(roots / "in"), 2, 1))
    _both("INTConstant", (3,))
    _both("ImpactFloat", (0.5,))
    _both("PrimitiveString", ("s",))


def test_hunyuan_glue_matches_jax():
    """The background estimate, the cleanup, Multi_Background_Remover, and
    TexGen's remesh and RGBA composite and ShapeGen's input, each against
    the JAX package's code for them."""
    imgs = _images(7)
    imgs[:, 6:14, 8:16] = 0.1
    for img in imgs:
        np.testing.assert_array_equal(thy._estimate_alpha(img),
                                      jhy._estimate_alpha(img))
    _assert_same(_mesh_host(thy._cleanup(_mesh(Mesh))),
                 _mesh_host(jhy._cleanup(_mesh(JMesh))), 1e-6, "cleanup")
    _both(C3D + "Multi Background Remover", (imgs[:1],),
          {"image_back": imgs[1:], "image_left": _images(8, 1, c=4)})
    for bg in (True, False):
        x = imgs[:1]
        ref = x[0] * jhy._estimate_alpha(x[0])[..., None] \
            + (1.0 - jhy._estimate_alpha(x[0])[..., None]) if bg else x[0]
        np.testing.assert_allclose(thy.shapegen_image(torch.as_tensor(x), bg),
                                   ref, atol=0, rtol=0)
    # TexGen's remesh (to its 40,000 faces) and RGBA composite: both nodes
    # with a paint pipeline that returns what it is given
    from comfy3d_tpu.models.hunyuan3d import (
        Hunyuan3DPaintPipeline as JPaintPipeline)

    def echo(cls):
        class Echo(cls):
            def __init__(self):
                pass

            def __call__(self, mesh, img, num_steps):
                return mesh, np.asarray(img), num_steps
        return Echo()

    rgba = _images(9, 1, c=4)
    key = C3D + "Hunyuan3D 21 TexGen"
    outs = [
        nodes.NODE_CLASS_MAPPINGS[key]().generate(
            echo(pipe), image=img, create_pbr=True, use_remesh=True,
            mesh=_mesh(mesh_cls, 1, 110))[0]
        for nodes, pipe, mesh_cls, img in (
            (tnodes, Hunyuan3DPaintPipeline, Mesh, torch.as_tensor(rgba)),
            (jnodes, JPaintPipeline, JMesh, rgba))]
    (t_mesh, t_img, t_steps), (j_mesh, j_img, j_steps) = outs
    assert _mesh(Mesh, 1, 110).num_faces > ttex.REMESH_FACES
    assert t_mesh.vc is None and t_mesh.num_faces <= ttex.REMESH_FACES
    _assert_same(_mesh_host(t_mesh), _mesh_host(j_mesh), 1e-6, "remesh")
    np.testing.assert_array_equal(t_img, j_img)
    assert t_steps == j_steps


def _tiny(monkeypatch, cls, cfg):
    """`cls.init_random` building `cfg`, whatever config its caller
    passes: the loader nodes build the full default config."""
    orig = cls.init_random.__func__

    def init_random(c, seed=0, cfg_=None, **kw):
        kw.pop("cfg", None)
        return orig(c, seed, cfg, **kw)
    monkeypatch.setattr(cls, "init_random", classmethod(init_random))


def _well_formed(res, graph):
    """Every node ran, none returned None; meshes have faces within their
    vertices, images are finite."""
    assert sorted(res) == sorted(n["id"] for n in graph["nodes"])
    for nid, out in res.items():
        cls = tnodes.NODE_CLASS_MAPPINGS[
            next(n["type"] for n in graph["nodes"] if n["id"] == nid)]
        assert len(out) == len(cls.RETURN_TYPES), nid
        for o in out:
            assert o is not None, nid
            if isinstance(o, Mesh):
                assert o.num_faces > 0 and int(o.f.max()) < o.num_vertices
                assert np.isfinite(o.v).all()
            if torch.is_tensor(o):
                assert bool(torch.isfinite(o).all()), nid


def _tiny_z123():
    return Zero123PlusConfig(height=24, width=16, cond_size=16, unet=UNET,
                             vae=VAE, prompt_dim=16)


def test_config3_graph_runs(roots, monkeypatch):
    """Zero123Plus (2 steps) → six views → InstantMesh → mesh."""
    _tiny(monkeypatch, Zero123PlusPipeline, _tiny_z123())
    _tiny(monkeypatch, InstantMeshPipeline, InstantMeshConfig(**IM_TINY))
    chip_smoke.write_reference_images(str(roots / "in"), 32)
    g = chip_smoke.config_graph(3)
    res = tgraph.run_workflow(g, {4: {"num_inference_steps": 2}},
                              device="cpu")
    _well_formed(res, g)
    assert tuple(res[4][0].shape) == (6, 8, 8, 3) and len(res[4][1]) == 6
    assert os.path.exists(res[7][0])


def test_config4_graph_runs(roots, monkeypatch):
    """MVDream (2 steps) → LGM → 3DGS, and the GS→mesh converter at small
    widths (6 views, its NeRF's `NGPConfig` cut) → mesh; the same views
    and splats as the pipelines' own calls."""
    mv = MVDreamConfig(image_size=32, num_views=4,
                       unet=dataclasses.replace(UNET, mv_views=4),
                       vae=VAE, prompt_tokens=7, prompt_dim=16)
    _tiny(monkeypatch, MVDreamPipeline, mv)
    _tiny(monkeypatch, LGMPipeline, LGMConfig(**LGM_TINY))
    small = hashgrid.HashGridConfig(num_levels=4, log2_table_size=10)
    ngp_cfg, g2m_cfg = tngp.NGPConfig, tgm.GSToMeshConfig
    monkeypatch.setattr(tngp, "NGPConfig", lambda iterations: ngp_cfg(
        grid=small, hidden=16, ray_batch=256, num_steps=16, occ_res=16,
        iterations=iterations))
    monkeypatch.setattr(tgm, "GSToMeshConfig",
                        lambda **kw: g2m_cfg(n_views=6, **kw))
    chip_smoke.write_reference_images(str(roots / "in"), 32)
    g = chip_smoke.config_graph(4)
    res = tgraph.run_workflow(
        g, {4: {"num_inference_steps": 2},
            8: {"gs_config": "Small", "training_nerf_iterations": 32,
                "marching_cube_grids_resolution": 16,
                "marching_cube_threshold": 0.5, "texture_resolution": 64}},
        device="cpu")
    _well_formed(res, g)
    mvp = MVDreamPipeline.init_random(device="cpu")
    views = mvp(num_inference_steps=2, guidance_scale=5.0,
                generator=torch.Generator().manual_seed(0), elevation=0.0)
    assert torch.equal(res[4][0], views)
    splat = LGMPipeline.init_random(device="cpu").forward_gaussians(views)
    assert torch.equal(res[6][0].xyz, splat.xyz)
    assert res[8][0].albedo.shape == (64, 64, 3)


def test_config5_linked_graph_runs(roots, monkeypatch):
    """ShapeGen (2 steps, a dense 17³ decode) → Save 3D Mesh → its path into
    TexGen (`use_remesh`, PBR, 2 steps) → Save 3D Mesh: the textured mesh
    with both textures, through GLB; the TexGen loader refuses a
    RealESRGAN checkpoint (ESRGAN is not ported)."""
    _tiny(monkeypatch, Hunyuan3DShapePipeline, Hunyuan3DShapeConfig.tiny())
    # the remesh's target cut, as the tiny widths' surface is a small one
    monkeypatch.setattr(ttex, "REMESH_FACES", 2000)
    # the paint UNet: 12 input channels (latent, normal and position
    # latents), 6 views, two heads per attention
    _tiny(monkeypatch, Hunyuan3DPaintPipeline, PaintConfig(
        render_size=32, texture_size=64, unet=dataclasses.replace(
            UNET, in_channels=12, mv_views=6, attention_head_dim=-2),
        vae=VAE,
        prompt_tokens=3, prompt_dim=16, pbr_settings=("albedo", "mr")))
    chip_smoke.write_reference_images(str(roots / "in"), 32)
    g = chip_smoke.config_graph("5_full")
    res = tgraph.run_workflow(
        g, {3: {"steps": 2, "octree_resolution": 16},
            5: {"model_variant": "Standard"}},
        device="cpu")
    _well_formed(res, g)
    assert res[6][0].metallic_roughness.shape == (64, 64, 3)
    assert res[6][0].num_faces <= 2000
    back = Mesh.load(res[7][0])
    assert back.albedo.shape == back.metallic_roughness.shape == (64, 64, 3)
    os.makedirs(roots / "ckpt" / "RealESRGAN")
    (roots / "ckpt" / "RealESRGAN" / "RealESRGAN_x4plus.pth").write_bytes(
        b"")
    with pytest.raises(NotImplementedError, match="A.10"):
        tnodes.NODE_CLASS_MAPPINGS[
            C3D + "Load Hunyuan3D 21 TexGen Pipeline"]().load()


def test_load_diffusers_pipeline_reads_a_checkpoint(roots):
    """A Zero123Plus directory under `<checkpoint root>/Diffusers/<repo>`,
    written from a tiny model's state dicts in diffusers' names, loads
    through the node with its ramping coefficients; an unported family
    raises, naming its ROADMAP A.10 family."""
    from safetensors.torch import save_file
    cfg = _tiny_z123()
    model = Zero123PlusPipeline.init_random(3, cfg, device="cpu").model
    root = roots / "ckpt" / "Diffusers" / "sudo-ai" / "zero123plus-v1.2"
    unet_json = {"block_out_channels": list(UNET.block_out_channels),
                 "layers_per_block": 1, "cross_attention_dim": 16,
                 "attention_head_dim": 4, "norm_num_groups": 4,
                 "down_block_types": list(UNET.down_block_types),
                 "up_block_types": list(UNET.up_block_types)}
    vae_json = {"block_out_channels": [8, 16], "layers_per_block": 1,
                "norm_num_groups": 4}
    for name, sub, raw in (("unet", model.unet, unet_json),
                           ("vae", model.vae, vae_json)):
        os.makedirs(root / name)
        with open(root / name / "config.json", "w") as f:
            json.dump(raw, f)
        save_file({k: v.contiguous() for k, v in sub.state_dict().items()},
                  str(root / name / "diffusion_pytorch_model.safetensors"))
    with open(root / "model_index.json", "w") as f:
        json.dump({"ramping_coefficients": [0.5] * 77}, f)
    node = tnodes.NODE_CLASS_MAPPINGS[C3D + "Load Diffusers Pipeline"]()
    with tnodes.base.run_device("cpu"):
        (pipe,) = node.load_diffusers_pipe("Zero123PlusPipeline",
                                           "sudo-ai/zero123plus-v1.2")
        with pytest.raises(NotImplementedError, match="A.10: triposg"):
            node.load_diffusers_pipe("TripoSGPipeline", "VAST-AI/TripoSG")
    assert pipe.repo_id == "sudo-ai/zero123plus-v1.2"
    assert float(pipe.ramping[-1]) == 0.5 and pipe.vision_encoder is None
    assert sorted(pipe.model.state_dict()) == sorted(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(pipe.model.state_dict()[k], v), k
