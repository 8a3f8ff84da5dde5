"""Port parity, Zero123Plus → InstantMesh (config 3): the UNet's reference
attention (written states exchanged both ways), CLIP's vision encoder,
`encode_condition`, `Zero123PlusPipeline.__call__` with and without CFG
(a vision encoder attached, non-zero ramping, the JAX package's keys
replayed), the image utilities, the two nodes' chain image → grid → six
views → InstantMesh → mesh, and the state dicts against the JAX package's
own converters, `comfy3d_tpu_torch` against `comfy3d_tpu` on the same
numpy inputs and weights (flax params carried across by
`convert.zero123plus_state_dict_from_flax`,
`convert.clip_vision_state_dict_from_flax` and
`convert.instantmesh_state_dict_from_flax`)."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import concurrent.futures
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.core import image as jimage
from comfy3d_tpu.models import clip as jclip
from comfy3d_tpu.models.convert import convert_with_rules
from comfy3d_tpu.models.diffusion.convert import unet_rules, vae_rules
from comfy3d_tpu.models.diffusion.unet import UNet2DCondition as JUNet
from comfy3d_tpu.models.diffusion.vae import AutoencoderKL as JVAE
from comfy3d_tpu.models.instantmesh import model as jm
from comfy3d_tpu.models.instantmesh.pipeline import \
    InstantMeshPipeline as JIMPipeline
from comfy3d_tpu.models.zero123plus import pipeline as jz
from comfy3d_tpu.nodes import nodes_models
from comfy3d_tpu.ops import volume as jvol

from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.core import image as timage
from comfy3d_tpu_torch.core.camera import ORBITPOSE_PRESETS
from comfy3d_tpu_torch.models import clip as tclip
from comfy3d_tpu_torch.models.diffusion import UNetConfig, VAEConfig
from comfy3d_tpu_torch.models.diffusion import unet as tu
from comfy3d_tpu_torch.models.instantmesh import model as tm
from comfy3d_tpu_torch.models.instantmesh import (
    InstantMeshConfig, InstantMeshPipeline, orbit_poses_to_input_cameras)
from comfy3d_tpu_torch.models.zero123plus import (Zero123Plus,
                                                  Zero123PlusConfig,
                                                  Zero123PlusPipeline)
from comfy3d_tpu_torch.ops import tetra

from tests.test_diffusion import tiny_unet_cfg, tiny_vae_cfg
from tests.test_torch_common import (QUICK_XLA, _load, _np, _params,
                                     one_torch_thread)  # noqa: F401
from tests.test_torch_instantmesh import TINY as TINY_IM
from tests.test_torch_instantmesh import _inputs as im_inputs
from tests.test_torch_instantmesh import init_all as im_init_all

# outputs against the JAX package: within this share of their largest value
REL = 1e-4
# `tests/test_workflows.py::_tiny_zero123plus`'s shapes: a 48×32 canvas of
# six 16×16 views from 24×16 latents, a 32² condition image, 3 × 16 tokens
TINY = dict(height=48, width=32, cond_size=32, prompt_tokens=3,
            prompt_dim=16)
TINY_CLIP = dict(hidden=32, layers=2, heads=2, mlp_dim=64, image_size=28,
                 patch=14, projection_dim=16)
STEPS = 2
SEED = 1234                       # the Zero123Plus node's default
# the full config's parameters (the JAX package's `jax.eval_shape` counts;
# CLIP at `CLIPVisionConfig()` widths with projection_dim 1024)
FULL_PARAMS = {"unet": 865_910_724, "vae": 83_653_863, "clip": 304_228_352}


def _close(out, ref, rel=REL, what=""):
    out, ref = _np(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())


def nchw(a):
    return torch.as_tensor(np.array(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1)


def jax_cfg():
    return jz.Zero123PlusConfig(unet=tiny_unet_cfg(), vae=tiny_vae_cfg(),
                                **TINY)


def port_cfg(jcfg):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["unet"] = UNetConfig(**dataclasses.asdict(jcfg.unet))
    kw["vae"] = VAEConfig(**dataclasses.asdict(jcfg.vae))
    return Zero123PlusConfig(**kw)


@functools.partial(jax.jit, static_argnums=(1, 2, 3),
                   compiler_options=QUICK_XLA)
def _jax_noise(seed, n_loop, cond_batch, sizes):
    """`jax_draws`'s arrays, NHWC, in one compiled call per shape."""
    lh, lw, cs = sizes
    key = jax.random.PRNGKey(seed)
    key, k_init = jax.random.split(key)
    cond, step = [], []
    for _ in range(n_loop):
        key, k_cond, k_step = jax.random.split(key, 3)
        cond.append(jax.random.normal(k_cond, (cond_batch, cs, cs, 4)))
        step.append(jax.random.normal(k_step, (1, lh, lw, 4)))
    return jax.random.normal(k_init, (1, lh, lw, 4)), cond, step


def jax_draws(seed, n_loop, cond_batch, jcfg):
    """The JAX pipeline's noise for `seed`, NCHW: `split(PRNGKey(seed))`
    gives the initial latents' key, then each loop step
    `split(key, 3)` its condition-latent and sampler keys."""
    f = jcfg.vae_factor
    latents, cond, step = _jax_noise(
        seed, n_loop, cond_batch,
        (jcfg.height // f, jcfg.width // f, jcfg.cond_size // f))
    return {"latents": nchw(latents), "cond": [nchw(c) for c in cond],
            "step": [nchw(s) for s in step]}


@pytest.fixture(scope="module")
def pipes():
    """Both tiny pipelines with the same redrawn weights, prompt embedding
    and ramping coefficients in [0, 1], each with a tiny CLIP vision
    encoder attached; the JAX pipeline's call jitted once per
    (steps, guidance) and shared with the node. The JAX pipeline's grids
    and keys for `test_pipeline_matches_jax` (its two compiles, with and
    without CFG; the chain test's node reuses the CFG one) are computed on
    two more threads beside the tests before it (`jax_refs`, futures by
    guidance scale)."""
    jcfg = jax_cfg()
    f = jcfg.vae_factor
    lat = jnp.zeros((1, jcfg.height // f, jcfg.width // f, 4))
    params = {
        "unet": _params(JUNet(jcfg.unet), lat, jnp.zeros((1,)),
                        jnp.zeros((1, 3, 16)), seed=11),
        "vae": _params(JVAE(jcfg.vae), jnp.zeros((1, 64, 64, 3)), seed=12)}
    ccfg = jclip.CLIPVisionConfig(**TINY_CLIP)
    clip_p = _params(jclip.CLIPVisionEncoder(ccfg),
                     jnp.zeros((1, 28, 28, 3)), seed=13)
    rng = np.random.RandomState(14)
    prompt = (0.5 * rng.randn(3, 16)).astype(np.float32)
    ramping = rng.rand(3).astype(np.float32)
    jpipe = jz.Zero123PlusPipeline(params, jcfg, prompt_embeds=prompt,
                                   ramping=ramping)
    jpipe.set_vision_encoder(jclip.make_vision_conditioner(clip_p, ccfg))
    pipe = Zero123PlusPipeline(
        _load(Zero123Plus(port_cfg(jcfg)),
              convert.zero123plus_state_dict_from_flax(params)),
        prompt_embeds=torch.as_tensor(prompt),
        ramping=torch.as_tensor(ramping))
    clip = _load(tclip.CLIPVisionEncoder(tclip.CLIPVisionConfig(
        **TINY_CLIP)), convert.clip_vision_state_dict_from_flax(clip_p))
    pipe.set_vision_encoder(tclip.make_vision_conditioner(clip))
    jcall = jax.jit(jpipe.__call__, compiler_options=QUICK_XLA,
                    static_argnames=("num_inference_steps", "guidance_scale",
                                     "output_type"))
    image = np.random.RandomState(3).rand(32, 32, 3).astype(np.float32)

    def jax_ref(g):
        return (np.asarray(jcall(image, num_inference_steps=STEPS,
                                 guidance_scale=g, seed=SEED)),
                jax_draws(SEED, STEPS, 2 if g > 1 else 1, jcfg))

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        yield dict(jcfg=jcfg, params=params, clip_p=clip_p, jpipe=jpipe,
                   pipe=pipe, clip=clip, jcall=jcall, image=image,
                   jax_refs={g: pool.submit(jax_ref, g) for g in (4.0, 1.0)})


def test_unet_reference_write_and_read_match_jax(pipes):
    """A write pass on a CFG pair of condition latents and a read pass on
    the canvas's: the outputs and every written tensor within 1e-4 of
    their largest value, under the keys sa_0 … sa_3 in call order (down,
    mid, up); the JAX package's read pass fed the port's written states,
    and the port's fed each package's."""
    jcfg, params, pipe = pipes["jcfg"], pipes["params"], pipes["pipe"]
    rng = np.random.RandomState(0)
    cond = rng.randn(2, 16, 16, 4).astype(np.float32)
    lat = rng.randn(2, 24, 16, 4).astype(np.float32)
    t = np.array([999.0, 999.0], np.float32)
    ctx = rng.randn(2, 3, 16).astype(np.float32)
    unet = JUNet(jcfg.unet)

    def refs(p, port_written):
        out_w, written = unet.apply({"params": p}, cond, t, ctx,
                                    ref_mode="write")
        out_x, _ = unet.apply({"params": p}, lat, t, ctx, ref_mode="read",
                              ref_hidden=port_written)
        return out_w, written, out_x

    port = pipe.model.unet
    args = (torch.as_tensor(t), torch.as_tensor(ctx))
    with torch.no_grad():
        out_w, written = port(nchw(cond), *args, ref_mode="write")
    keys = [f"sa_{k}" for k in range(4)]
    assert list(written) == keys and all(len(w) == 1
                                         for w in written.values())
    assert tuple(written["sa_1"][0].shape) == (2, 64, 16)     # mid, 8×8
    port_written = {k: [_np(w) for w in ws] for k, ws in written.items()}
    j_out_w, j_written, j_out_x = jax.jit(
        refs, compiler_options=QUICK_XLA)(params["unet"], port_written)
    assert sorted(j_written) == keys
    _close(nhwc(out_w), j_out_w, what="write pass")
    for k in keys:
        _close(written[k][0], j_written[k][0], what=k)
    with torch.no_grad():
        out_r = port(nchw(lat), *args, ref_mode="read", ref_hidden=written)
        out_x = port(nchw(lat), *args, ref_mode="read", ref_hidden={
            k: [torch.as_tensor(np.array(w)) for w in ws]
            for k, ws in j_written.items()})
        plain = port(nchw(lat), *args)
    _close(nhwc(out_r), j_out_x, what="read pass")
    _close(nhwc(out_x), j_out_x, what="the port reading JAX's states")
    # reading the states moves the output
    assert np.abs(_np(out_r - plain)).max() > 1e-3
    with pytest.raises(NotImplementedError, match="A.6.6"):
        port(nchw(lat), *args, ref_mode="write", mv_views=2)


def test_clip_vision_matches_jax(pipes):
    """The conditioner (a 32² image resized to 28², CLIP-normalised,
    encoded, projected) and the encoder with `project=False` (tokens and
    the pooled class token), within 1e-4 of their largest value; an
    encoder with the camera-modulated blocks (Craftsman's, held in
    `test_torch_craftsman.py`) asks for its camera code."""
    ccfg = jclip.CLIPVisionConfig(**TINY_CLIP)
    rng = np.random.RandomState(1)
    img = rng.rand(2, 32, 32, 3).astype(np.float32)
    norm = ((rng.rand(2, 28, 28, 3) - jclip.CLIP_IMAGE_MEAN)
            / jclip.CLIP_IMAGE_STD).astype(np.float32)
    enc = jclip.CLIPVisionEncoder(ccfg)

    def refs(p):
        return (jclip.make_vision_conditioner(p, ccfg)(img),
                enc.apply({"params": p}, norm, project=False))

    emb, (tokens, pooled) = jax.jit(refs, compiler_options=QUICK_XLA)(
        pipes["clip_p"])
    clip = pipes["clip"]
    with torch.no_grad():
        _close(tclip.make_vision_conditioner(clip)(img), emb,
               what="embedding")
        t_tokens, t_pooled = clip(nchw(norm), project=False)
    _close(t_tokens, tokens, what="tokens")
    _close(t_pooled, pooled, what="pooled")
    with pytest.raises(ValueError, match="mod_cond"):
        tclip.CLIPVisionEncoder(tclip.CLIPVisionConfig(
            **TINY_CLIP, modulation_dim=4))(nchw(norm))


def test_encode_condition_and_states_match_jax(pipes):
    """`encode_condition` (the VAE posterior's mean of the affine-scaled
    image) of a CFG pair and `_encoder_states` (the prompt embedding plus
    the ramped CLIP embedding), within 1e-4 of their largest value."""
    jpipe, pipe = pipes["jpipe"], pipes["pipe"]
    img = np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32)
    ref_lat, ref_states = jax.jit(
        lambda x: (jpipe.encode_condition(x), jpipe._encoder_states(x[:1])),
        compiler_options=QUICK_XLA)(img)
    with torch.no_grad():
        lat = pipe.encode_condition(img)
        states = pipe._encoder_states(img[:1])
    assert tuple(lat.shape) == (2, 4, 16, 16)
    _close(nhwc(lat), ref_lat, what="condition latent")
    _close(states, ref_states, what="encoder states")
    # the ramped global term is not zero
    assert np.abs(_np(states[0]) - _np(pipe.prompt_embeds)).max() > 1e-3


def test_pipeline_matches_jax(pipes):
    """Two Euler-ancestral steps from the JAX pipeline's own keys for the
    node's seed, with CFG 4 (the negative condition latent first) and
    without: the grids within 1e-4 of their largest value, in [0, 1];
    without `draws`, the noise comes from a generator seeded with `seed`."""
    pipe, img = pipes["pipe"], pipes["image"]
    for guidance in (4.0, 1.0):
        ref, draws = pipes["jax_refs"][guidance].result()
        out = pipe(img, num_inference_steps=STEPS, guidance_scale=guidance,
                   draws=draws)
        assert tuple(out.shape) == (48, 32, 3)
        assert 0.0 <= float(out.min()) and float(out.max()) <= 1.0
        _close(out, ref, what=f"guidance {guidance}")
    a, b, c = (pipe(img, num_inference_steps=1, seed=s) for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_image_utilities_match_jax():
    """`composite_background`, `resize_images` (bilinear and bicubic,
    shrinking and growing) within 1e-5; `make_image_grid` and
    `split_image_grid` equal, element for element."""
    rng = np.random.RandomState(4)
    imgs = rng.rand(6, 16, 12, 3).astype(np.float32)
    masks = rng.rand(6, 16, 12).astype(np.float32)
    t_imgs, t_masks = torch.as_tensor(imgs), torch.as_tensor(masks)
    for color in ((1.0, 1.0, 1.0), (0.2, 0.5, 0.0)):
        np.testing.assert_allclose(
            _np(timage.composite_background(t_imgs, t_masks, color)),
            np.asarray(jimage.composite_background(imgs, masks, color)),
            atol=1e-6, rtol=0)
    for h, w, method in ((7, 5, "bilinear"), (40, 36, "bilinear"),
                         (9, 7, "bicubic")):
        np.testing.assert_allclose(
            _np(timage.resize_images(t_imgs, h, w, method)),
            np.asarray(jimage.resize_images(jnp.asarray(imgs), h, w,
                                            method)),
            atol=1e-5, rtol=0, err_msg=f"{h}x{w} {method}")
    grid = timage.make_image_grid(t_imgs, 3, 2)
    np.testing.assert_array_equal(_np(grid),
                                  jimage.make_image_grid(imgs, 3, 2))
    np.testing.assert_array_equal(_np(timage.split_image_grid(grid, 3, 2)),
                                  imgs)
    np.testing.assert_array_equal(
        _np(timage.split_image_grid(grid[:47], 3, 2)),
        jimage.split_image_grid(_np(grid)[:47], 3, 2))


def _gap_bias(planes, model, res):
    """The shift of the SDF head's bias that puts the surface in the widest
    gap between neighbouring lattice values near the median, so that no
    lattice value lies so near 0 that the two packages could differ in
    its sign."""
    verts = torch.as_tensor(tetra.grid_vertices(res)
                            * (model.cfg.grid_scale * 0.5))
    with torch.no_grad():
        sdf = np.sort(_np(model.query_geometry(planes, verts)[0]))
    lo, hi = int(0.3 * sdf.size), int(0.7 * sdf.size)
    j = lo + int(np.argmax(np.diff(sdf[lo:hi + 1])))
    return np.float32(0.5 * (sdf[j] + sdf[j + 1]))


def test_config3_chain_matches_jax_nodes(pipes, monkeypatch):
    """The two nodes of config 3 at tiny widths: the JAX package's
    `Zero123Plus_Diffusion_Model.run_model` (its pipeline set as the node's
    `_cached`) → `InstantMesh_Reconstruction_Model.run_LRM`, against the
    port's chain (`composite_background` → `Zero123PlusPipeline` →
    `split_image_grid(grid, 3, 2)` → the "Zero123Plus(6)" poses → the
    bilinear resize to 320² → `orbit_poses_to_input_cameras` →
    `forward_planes` → `extract_mesh`). The six views within 1e-4 of their
    largest value, the poses equal, the mesh's triangles the same in the
    same order with their corners within 1e-4 (colours within one uint8
    step); the SDF head's bias moved so that no lattice value lies near
    0."""
    pipe, jcfg = pipes["pipe"], pipes["jcfg"]
    rng = np.random.RandomState(5)
    image = rng.rand(1, 32, 32, 3).astype(np.float32)
    yy, xx = np.mgrid[:32, :32]
    mask = (((yy - 15.5) ** 2 + (xx - 15.5) ** 2) < 12.0 ** 2)[None] \
        .astype(np.float32)

    monkeypatch.setattr(nodes_models.Zero123Plus_Diffusion_Model, "_cached",
                        pipes["jcall"])
    jviews, jposes = nodes_models.Zero123Plus_Diffusion_Model().run_model(
        reference_image=image, reference_mask=mask, seed=SEED,
        guidance_scale=4.0, num_inference_steps=STEPS)

    img = timage.composite_background(torch.as_tensor(image),
                                      torch.as_tensor(mask))[0]
    grid = pipe(img, num_inference_steps=STEPS, guidance_scale=4.0,
                seed=SEED % 2 ** 31,
                draws=jax_draws(SEED % 2 ** 31, STEPS, 2, jcfg))
    views = timage.split_image_grid(grid, 3, 2)
    poses = [[1.2, e, a, 0.0, 0.0, 0.0]
             for e, a in ORBITPOSE_PRESETS["Zero123Plus(6)"]]
    _close(views, jviews, what="six views")
    assert poses == jposes

    im_cfg = jm.InstantMeshConfig(**TINY_IM)
    im_params = _params(jm.InstantMesh(im_cfg),
                        *map(jnp.asarray, im_inputs()), method=im_init_all,
                        seed=4)
    im = InstantMeshPipeline(_load(tm.InstantMesh(InstantMeshConfig(
        **TINY_IM)), convert.instantmesh_state_dict_from_flax(im_params)))
    p = np.asarray(poses, np.float32)
    cams = orbit_poses_to_input_cameras(p[:, 2], p[:, 1], radius=4.0,
                                        fov_deg=30.0)
    views320 = timage.resize_images(views, 320, 320)
    planes = im.forward_planes(views320[None], cams[None])[0]
    res = TINY_IM["grid_res"] + 1
    shift = _gap_bias(planes, im.model, res)
    im_params["decoder"]["sdf_out"]["bias"] = \
        im_params["decoder"]["sdf_out"]["bias"] - shift
    im = InstantMeshPipeline(_load(tm.InstantMesh(InstantMeshConfig(
        **TINY_IM)), convert.instantmesh_state_dict_from_flax(im_params)))
    jim = JIMPipeline(im_params, im_cfg)
    # the JAX package's network and field queries jitted with QUICK_XLA
    # (one compile each, not one per eager op of the field queries)
    jim._planes = jax.jit(
        lambda p, imgs, cams: jim.model.apply({"params": p}, imgs, cams),
        compiler_options=QUICK_XLA)
    monkeypatch.setattr(jvol, "query_chunked", functools.partial(
        lambda real, fn, *a, **kw: real(
            jax.jit(fn, compiler_options=QUICK_XLA), *a, **kw),
        jvol.query_chunked))
    # both capacity ladders start at 32,768 triangles (ample for the tiny
    # model's ~24,000), as after an earlier call at this resolution: one
    # compile of the JAX package's sweep, shared with
    # `test_torch_instantmesh_extract.py`
    im._cap_memo = {res: 32768}
    jim._cap_memo = {res: 32768}
    mesh = im.extract_mesh(planes)

    jmesh, = nodes_models.InstantMesh_Reconstruction_Model().run_LRM(
        lrm_model=jim, multiview_images=jviews, orbit_camera_poses=jposes,
        orbit_camera_fovy=30.0)
    # the same triangles in the same order, corner by corner (the weld's
    # 1e-6 rounding can split a point in one package only, so the vertex
    # lists, and the indices into them, may differ by a few points)
    assert mesh.num_faces == jmesh.num_faces > 100
    np.testing.assert_allclose(mesh.v[mesh.f], jmesh.v[jmesh.f], atol=1e-4,
                               rtol=0)
    assert abs(mesh.num_vertices - jmesh.num_vertices) <= \
        max(2, jmesh.num_vertices // 1000)
    assert np.abs(mesh.vc[mesh.f] - jmesh.vc[jmesh.f]).max() \
        <= 1 / 255 + 1e-7


def test_state_dicts_round_trip_and_full_config_counts(pipes):
    """flax params (the tiny pipelines') → the port's state dicts → the JAX
    package's own
    `unet_rules` (under `unet.`), `vae_rules` (under `vae.`) and
    `clip_rules` → the same params leaf for leaf; `Zero123PlusConfig()`
    and `CLIPVisionConfig(projection_dim=1024)` count the JAX package's
    parameters (`jax.eval_shape`; CLIP's from one and two of its alike
    layers) and the figures of record; `from_pretrained` wants a
    directory, and the entry points default to the card."""
    params, clip_p = pipes["params"], pipes["clip_p"]
    sd = pipes["pipe"].model.state_dict()
    assert {k.split(".")[0] for k in sd} == {"unet", "vae"}

    def part(prefix):
        return {k: v for k, v in sd.items() if k.startswith(prefix)}

    csd = pipes["clip"].state_dict()
    for tree, ref in (
            ({"unet": convert_with_rules(part("unet."), unet_rules("unet.")),
              "vae": convert_with_rules(part("vae."), vae_rules("vae."))},
             params),
            (jclip.convert_clip(csd), clip_p)):
        flat = jax.tree_util.tree_leaves_with_path(ref)
        back = dict(jax.tree_util.tree_leaves_with_path(tree))
        assert len(back) == len(flat)
        for path, leaf in flat:
            np.testing.assert_array_equal(back[path], leaf,
                                          err_msg=jax.tree_util.keystr(path))

    full = jz.Zero123PlusConfig()
    assert dataclasses.asdict(Zero123PlusConfig()) == dataclasses.asdict(full)
    z, key = jnp.zeros, jax.random.PRNGKey(0)

    def count(module, *args):
        shapes = jax.eval_shape(module.init, key, *args)["params"]
        return sum(math.prod(a.shape) for a in jax.tree.leaves(shapes))

    def clip_count(layers):
        return count(jclip.CLIPVisionEncoder(jclip.CLIPVisionConfig(
            projection_dim=1024, layers=layers)), z((1, 224, 224, 3)))

    # CLIP's 24 layers are alike, so its count is affine in their number:
    # traced with one and two layers, extended to 24
    clip1 = clip_count(1)
    n_jax = {"unet": count(JUNet(full.unet), z((1, 120, 80, 4)), z((1,)),
                           z((1, 77, 1024))),
             "vae": count(JVAE(full.vae), z((1, 64, 64, 3))),
             "clip": clip1 + (jclip.CLIPVisionConfig().layers - 1)
             * (clip_count(2) - clip1)}
    with torch.device("meta"):
        model = Zero123Plus(Zero123PlusConfig())
        clip = tclip.CLIPVisionEncoder(tclip.CLIPVisionConfig(
            projection_dim=1024))
    for name, mod in (("unet", model.unet), ("vae", model.vae),
                      ("clip", clip)):
        n_port = sum(p.numel() for p in mod.parameters())
        assert n_port == n_jax[name] == FULL_PARAMS[name], name
    assert isinstance(model.unet, tu.UNet2DCondition)

    # a directory without model_index.json (`from_pretrained` itself is
    # held by tests/test_torch_clip_text.py)
    with pytest.raises(FileNotFoundError, match="model_index.json"):
        Zero123PlusPipeline.from_pretrained("zero123plus-v1.2",
                                            device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            Zero123PlusPipeline.init_random(0, port_cfg(pipes["jcfg"]))
