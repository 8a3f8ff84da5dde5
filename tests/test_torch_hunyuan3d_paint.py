"""Port parity, Hunyuan3D paint (config 5's second half): the 2.5D
multi-view UNet (the dual stream's write pass, the generation stream's
uncond and cond passes with `attn_multiview` and `attn_refview`), the
colour projection and bake (`algorithms/color_project.py`, the native
vertex inpaint), the pipeline's geometry maps, views and textures in the V2
and PBR configs, `from_pretrained` on a directory the test writes in
upstream's layout, and the full configs' parameter counts,
`comfy3d_tpu_torch` against `comfy3d_tpu` on the same numpy inputs and
weights (flax params carried across by
`convert.hunyuan3d_paint_state_dict_from_flax`).

The JAX pipeline runs with `PaintConfig(vae_scaling=1.0)`: it scales its
latents by the VAE's factor a second time, the port once (as upstream).
Its params are built by shape (`jax.eval_shape`) and redrawn from numpy,
never by a flax init (a minute at these widths), and its stages run in a
few jitted calls (`QUICK_XLA`) on threads beside the tests: the pipeline's
own eager calls rasterize and encode op by op."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import concurrent.futures
import dataclasses
import functools
import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu import native as jnative
from comfy3d_tpu.algorithms import color_project as jcp
from comfy3d_tpu.core.camera import Camera as JCamera
from comfy3d_tpu.core.mesh import Mesh as JMesh
from comfy3d_tpu.models.hunyuan3d import paint as jp
from comfy3d_tpu.models.hunyuan3d import paint_convert as jpc
from comfy3d_tpu.ops import texture as jtex

from comfy3d_tpu_torch import convert, native
from comfy3d_tpu_torch.algorithms import color_project as tcp
from comfy3d_tpu_torch.core.mesh import Mesh
from comfy3d_tpu_torch.models.diffusion.schedulers import SchedulerConfig
from comfy3d_tpu_torch.models.diffusion.unet import (UNet2DCondition,
                                                     UNetConfig)
from comfy3d_tpu_torch.models.diffusion.vae import VAEConfig
from comfy3d_tpu_torch.models.hunyuan3d import (Hunyuan3DPaint,
                                                Hunyuan3DPaintPipeline,
                                                PaintConfig)

from tests.test_diffusion import tiny_unet_cfg, tiny_vae_cfg
from tests.test_torch_common import (QUICK_XLA, _np, _randomize,
                                     one_torch_thread)  # noqa: F401

# single passes against the JAX package: within this share of the largest
# value; after the guided steps and the bakes, within REL_STEPS
REL = 1e-5
REL_STEPS = 1e-4
SEED, STEPS, GUIDANCE = 3, 2, 3.0
# the full PBR config's parameters (the JAX package's `jax.eval_shape`
# counts); the learned tokens are gen, ref, albedo and mr
FULL_PARAMS = {"unet": 965_081_924, "unet_multiview_refview": 99_148_160,
               "unet_dual": 865_910_724, "vae": 83_653_863,
               "class_embedding": 62_720, "tokens": 315_392,
               "tokens_v2": 157_696}


def _close(out, ref, rel=REL, what=""):
    out, ref = _np(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())


def nchw(a):
    return torch.as_tensor(np.array(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1)


def jax_cfg(pbr: bool, **kw):
    # two heads per attention: a diffusers config.json's scalar says so
    unet = dataclasses.replace(tiny_unet_cfg(), in_channels=12, mv_views=6,
                               attention_head_dim=-2)
    return jp.PaintConfig(render_size=32, texture_size=64, unet=unet,
                          vae=tiny_vae_cfg(), prompt_tokens=3, prompt_dim=16,
                          pbr_settings=("albedo", "mr") if pbr else (),
                          vae_scaling=1.0, **kw)


def port_cfg(jcfg) -> PaintConfig:
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
          if f.name != "vae_scaling"}
    kw["unet"] = UNetConfig(**dataclasses.asdict(jcfg.unet))
    kw["vae"] = VAEConfig(**dataclasses.asdict(jcfg.vae))
    kw["scheduler"] = SchedulerConfig(**dataclasses.asdict(jcfg.scheduler))
    return PaintConfig(**kw)


def _shapes(module, *args, **kwargs):
    return jax.eval_shape(functools.partial(module.init, **kwargs),
                          jax.random.PRNGKey(0), *args)["params"]


def _stream_shapes(jpipe, lat=8):
    """The flax trees of the two UNet streams, the VAE and the camera table
    by shape, with `init_random`'s probes."""
    c = jpipe.cfg
    v, d, z = len(c.camera_azims), c.unet.block_out_channels[0] * 4, jnp.zeros
    ctx = z((v, c.prompt_tokens, c.prompt_dim))
    return {
        "unet": _shapes(jpipe.unet, z((v, lat, lat, c.unet.in_channels)),
                        z((v,)), ctx, class_emb=z((v, d))),
        "unet_dual": _shapes(jpipe.unet_dual, z((1, lat, lat, 4)), z((1,)),
                             ctx[:1], class_emb=z((1, d))),
        "vae": _shapes(jpipe.vae, z((1, 64, 64, 3))),
        "cls": _shapes(jpipe.cls_embed, z((v,), jnp.int32))}


def _mesh(with_uv=False):
    """A lumpy sphere of 8 rings × 12 segments (radius 0.42–0.58, no
    symmetry the candidate views share, so no pixel centre falls on an
    edge), with per-vertex lat-long UVs when asked."""
    rings, segs = 8, 12
    th = np.linspace(0, np.pi, rings + 1)[1:-1]
    ph = np.linspace(0, 2 * np.pi, segs, endpoint=False) + 0.3
    t, p = np.meshgrid(th, ph, indexing="ij")
    r = 0.5 + 0.06 * np.sin(3 * p + 0.4) * np.cos(2 * t) + 0.02 * np.cos(t)
    pts = np.stack([r * np.sin(t) * np.cos(p), r * np.cos(t),
                    r * np.sin(t) * np.sin(p)], -1).reshape(-1, 3)
    v = np.concatenate([[[0.0, 0.55, 0.0]], pts, [[0.0, -0.5, 0.0]]])
    faces = []
    for j in range(segs):
        k = (j + 1) % segs
        faces.append([0, 1 + k, 1 + j])
        for i in range(rings - 2):
            a, b = 1 + i * segs + j, 1 + i * segs + k
            faces += [[a, b, b + segs], [a, b + segs, a + segs]]
        last = 1 + (rings - 2) * segs
        faces.append([len(v) - 1, last + j, last + k])
    f = np.asarray(faces, np.int32)
    vt = None
    if with_uv:
        lat = np.arccos(np.clip(v[:, 1] / np.linalg.norm(v, axis=1), -1, 1))
        lon = np.mod(np.arctan2(v[:, 2], v[:, 0]), 2 * np.pi)
        vt = np.stack([lon / (2 * np.pi), 1 - lat / np.pi], -1)
    mesh = Mesh(v=v, f=f, vt=vt, ft=None if vt is None else f)
    jmesh = JMesh(v=v, f=f, vt=vt, ft=None if vt is None else f)
    return mesh.auto_normal(), jmesh.auto_normal()


@functools.partial(jax.jit, static_argnums=(1, 2),
                   compiler_options=QUICK_XLA)
def _jax_noise(seed, shape, steps):
    """`paint_views`' initial noise, `normal(PRNGKey(seed))`, and
    `_denoise`'s sampler noise, `PRNGKey(0)` split at every loop step."""
    key, step = jax.random.PRNGKey(0), []
    for _ in range(steps):
        key, k = jax.random.split(key)
        step.append(jax.random.normal(k, shape))
    return jax.random.normal(jax.random.PRNGKey(seed), shape), step


def jax_draws(jcfg, seed=SEED, steps=STEPS):
    """The JAX pipeline's noise for `seed` and `steps`, NCHW."""
    rows = max(1, len(jcfg.pbr_settings)) * len(jcfg.camera_azims)
    lat = jcfg.render_size // 2 ** (len(jcfg.vae.block_out_channels) - 1)
    init, step = _jax_noise(seed, (rows, lat, lat, 4), steps)
    return {"latents": nchw(init), "step": [nchw(s) for s in step]}


def _unet_passes(jpipe):
    """A jitted function (params, x [rows, h, w, 12], t, the reference
    latent [1, h, w, 4]) → the JAX pipeline's dual write pass and its
    generation stream's uncond and cond passes, as `_denoise` runs them."""
    c = jpipe.cfg
    labels = jnp.asarray(jp._camera_info(c.camera_azims, c.camera_elevs))
    n_attr = max(1, len(c.pbr_settings))

    def passes(params, x, t, img_lat):
        cls = jpipe.cls_embed.apply({"params": params["cls"]},
                                    labels + c.num_ref_cls)
        cls = jnp.tile(cls, (n_attr, 1))
        cls_ref = jpipe.cls_embed.apply({"params": params["cls"]},
                                        jnp.zeros((1,), jnp.int32))
        out_w, ref = jpipe.unet_dual.apply(
            {"params": params["unet_dual"]}, img_lat, jnp.zeros((1,)),
            params["text_ref"][None], ref_mode="write", class_emb=cls_ref)
        if c.pbr_settings:
            ctx = jnp.repeat(params["attr_embeds"], len(labels), axis=0)
        else:
            ctx = jnp.tile(params["text_gen"][None], (len(labels), 1, 1))
        e_u, _ = jpipe.unet.apply({"params": params["unet"]}, x, t,
                                  jnp.zeros_like(ctx), class_emb=cls)
        e_c, _ = jpipe.unet.apply({"params": params["unet"]}, x, t, ctx,
                                  class_emb=cls, ref_mode="read",
                                  ref_hidden=ref)
        return out_w, ref, e_u, e_c

    return jax.jit(passes, compiler_options=QUICK_XLA)


def _unet_inputs(jcfg):
    rng = np.random.RandomState(8)
    rows = max(1, len(jcfg.pbr_settings)) * 6
    x = rng.randn(rows, 16, 16, 12).astype(np.float32)
    return (x, np.full((rows,), 601.0, np.float32),
            rng.randn(1, 16, 16, 4).astype(np.float32))


def _jax_geometry(jpipe, jmesh, image):
    """The first half of the JAX pipeline's `paint_views` in one jitted
    call: its `render_geometry` and `_encode` of the normal and position
    maps and of the resized image (one VAE call: the encoder works on each
    image alone) → normals, positions, geometry latents, image latent."""
    c = jpipe.cfg

    def geometry(params, image):
        normals, positions = jpipe.render_geometry(jmesh)
        img = jax.image.resize(image[None], (1, c.render_size,
                                             c.render_size, 3), "bilinear")
        lat = jpipe.vae.apply(
            {"params": params["vae"]},
            jnp.concatenate([normals, positions, img]) * 2.0 - 1.0,
            method=jp.AutoencoderKL.encode)
        return (normals, positions,
                jnp.concatenate([lat[:6], lat[6:12]], -1), lat[12:])

    return jax.jit(geometry, compiler_options=QUICK_XLA)(jpipe.params,
                                                         image)


def _jax_views(jpipe, geometry, noise):
    """The rest of `paint_views` in one jitted call: `_denoise` from
    `noise`, then the decode → views [rows, S, S, 3]."""
    c = jpipe.cfg
    labels = jnp.asarray(jp._camera_info(c.camera_azims, c.camera_elevs))

    def views(params, geom, img_lat, noise):
        lat = jp.Hunyuan3DPaintPipeline._denoise.__wrapped__(
            jpipe, params, geom, img_lat, labels, STEPS,
            jnp.float32(GUIDANCE), "EulerAncestralDiscreteScheduler", noise)
        out = jpipe.vae.apply({"params": params["vae"]}, lat,
                              method=jp.AutoencoderKL.decode)
        return jnp.clip(out * 0.5 + 0.5, 0.0, 1.0)

    _, _, geom, img_lat = geometry.result()
    return np.asarray(jax.jit(views, compiler_options=QUICK_XLA)(
        jpipe.params, geom, img_lat, noise))


def _jit_project_colors():
    """JAX's `project_colors`, jitted whole (its eager form rasterizes op
    by op): the mesh's v, f and vn and the cameras as arguments."""
    orig = jcp.project_colors

    @functools.partial(jax.jit, static_argnums=(5, 6),
                       compiler_options=QUICK_XLA)
    def run(v, f, vn, images, cameras, cos_power, weights):
        mesh = types.SimpleNamespace(v=v, f=f, vn=vn)
        return orig(mesh, images, cameras, cos_power, view_weights=weights)

    def project_colors(mesh, images, cameras, cos_power=4.0,
                       view_weights=None):
        vn = (mesh.vn if mesh.vn is not None else mesh.auto_normal().vn)
        return run(mesh.v, mesh.f, vn, jnp.asarray(images), cameras,
                   float(cos_power), None if view_weights is None
                   else tuple(map(float, view_weights)))

    return project_colors


def _candidate_cameras(jcfg):
    return JCamera.from_orbit(np.asarray(jcfg.camera_elevs, np.float32),
                              np.asarray(jcfg.camera_azims, np.float32),
                              jcfg.camera_distance, width=jcfg.render_size,
                              height=jcfg.render_size)


def _color_project_refs(jcfg, views):
    """JAX's `project_colors`, `project_and_inpaint` and `bake_projection`
    (with the mesh's UVs) of `views` on the candidate cameras."""
    _, jmesh = _mesh(with_uv=True)
    cams, w = _candidate_cameras(jcfg), jcfg.view_weights
    colors, conf = jcp.project_colors(jmesh, views, cams, view_weights=w)
    painted = jcp.project_and_inpaint(
        JMesh(v=jmesh.v, f=jmesh.f, vn=jmesh.vn), views, cams,
        view_weights=w)
    baked = jcp.bake_projection(jmesh, views, cams, texture_size=64,
                                view_weights=w)
    return (np.asarray(colors), np.asarray(conf), painted.vc, baked.albedo,
            np.asarray(cams.view_proj))


def _call_refs(jpipe, jmesh, image, chain):
    """The JAX pipeline's `__call__`, its `paint_views` replaced by the
    chain's views (`_jax_chain`), and again with a 2× superres callable:
    (albedo, metallicRoughness, vt, ft) each, and the callable's calls."""
    views = chain.result()[0]
    jpipe.paint_views = lambda *a, **k: {"albedo": views[:6],
                                         "mr": views[6:]}
    calls, out = [], []

    def superres(v):
        calls.append(np.asarray(v).shape)
        return np.repeat(np.repeat(np.asarray(v), 2, 1), 2, 2)

    for sr in (None, superres):
        jpipe.set_superres(sr)
        m = jpipe(JMesh(v=jmesh.v, f=jmesh.f, vn=jmesh.vn), image)
        out.append((m.albedo, m.metallic_roughness, m.vt, m.ft))
    return out, calls


def _jax_count(tree):
    return sum(math.prod(a.shape) for a in jax.tree.leaves(tree))


def _full_counts():
    """The full PBR config's parameters by `jax.eval_shape`, per part; the
    dual stream's from the generation stream's tree: less its 2.5D
    attentions and the 8 extra input channels of `conv_in`."""
    jpipe = jp.Hunyuan3DPaintPipeline({}, jp.PaintConfig(
        pbr_settings=("albedo", "mr")))
    c, z = jpipe.cfg, jnp.zeros
    ctx = z((6, c.prompt_tokens, c.prompt_dim))
    gen = _shapes(jpipe.unet, z((6, 8, 8, 12)), z((6,)), ctx,
                  class_emb=z((6, 1280)))
    extra = sum(math.prod(a.shape) for path, a in
                jax.tree_util.tree_leaves_with_path(gen)
                if any(getattr(k, "key", "") in ("attn_multiview",
                                                 "attn_refview")
                       for k in path))
    k = gen["conv_in"]["kernel"].shape
    n = {"unet": _jax_count(gen), "multiview_refview": extra,
         "vae": _jax_count(_shapes(jpipe.vae, z((1, 64, 64, 3)))),
         "cls": _jax_count(_shapes(jpipe.cls_embed, z((6,), jnp.int32)))}
    n["unet_dual"] = n["unet"] - extra - k[0] * k[1] * 8 * k[3]
    return n


@pytest.fixture(scope="module")
def pipes():
    """The tiny V2 and PBR pipelines of both packages with the same redrawn
    weights, a lumpy sphere and a 40² image. The JAX references of every
    test are computed on threads beside the tests (futures), with JAX's
    `project_colors` and `bake_vertex_colors` jitted for its colour
    projection and bake to call."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jcp, "project_colors", _jit_project_colors())
    mp.setattr(jtex, "bake_vertex_colors", jax.jit(
        jtex.bake_vertex_colors, compiler_options=QUICK_XLA,
        static_argnames=("texture_size", "dilate_iters", "method")))
    rng = np.random.RandomState(4)
    jcfgs = {"v2": jax_cfg(False), "pbr": jax_cfg(True)}
    shapes = _stream_shapes(jp.Hunyuan3DPaintPipeline({}, jcfgs["pbr"]))
    params = {k: _randomize(s, 10 + i) for i, (k, s) in
              enumerate(shapes.items())}
    params.update(text_gen=(0.5 * rng.randn(3, 16)).astype(np.float32),
                  text_ref=(0.5 * rng.randn(3, 16)).astype(np.float32),
                  attr_embeds=(0.5 * rng.randn(2, 3, 16)).astype(np.float32))
    mesh, jmesh = _mesh()
    image = rng.rand(40, 40, 3).astype(np.float32)
    views = np.random.RandomState(6).rand(6, 32, 32, 3).astype(np.float32)
    out = dict(mesh=mesh, jmesh=jmesh, image=image, views=views,
               jcfgs=jcfgs, shapes=shapes, params=params, jpipes={},
               pipes={})
    for name, jcfg in jcfgs.items():
        p = dict(params)
        if not jcfg.pbr_settings:
            del p["attr_embeds"]
        out["jpipes"][name] = jp.Hunyuan3DPaintPipeline(p, jcfg)
        model = Hunyuan3DPaint(port_cfg(jcfg))
        model.load_state_dict(convert.hunyuan3d_paint_state_dict_from_flax(
            p, jcfg.pbr_settings), strict=True)
        out["pipes"][name] = Hunyuan3DPaintPipeline(model)
    out["unet_passes"] = _unet_passes(out["jpipes"]["pbr"])

    def paint_views(name, geometry):
        draws = jax_draws(jcfgs[name])
        noise = np.asarray(draws["latents"].permute(0, 2, 3, 1))
        return _jax_views(out["jpipes"][name], geometry, noise), draws

    pool = concurrent.futures.ThreadPoolExecutor(4)
    try:
        geometry = pool.submit(_jax_geometry, out["jpipes"]["pbr"], jmesh,
                               image)
        jax_views = {n: pool.submit(paint_views, n, geometry)
                     for n in ("pbr", "v2")}
        out.update(
            jax_geometry=geometry, jax_views=jax_views,
            jax_unet=pool.submit(out["unet_passes"], params,
                                 *_unet_inputs(jcfgs["pbr"])),
            jax_color=pool.submit(_color_project_refs, jcfgs["pbr"], views),
            jax_counts=pool.submit(_full_counts),
            jax_call=pool.submit(
                _call_refs, jp.Hunyuan3DPaintPipeline(params, jcfgs["pbr"]),
                jmesh, image, jax_views["pbr"]))
        yield out
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        mp.undo()


def test_unet_2p5d_matches_jax(pipes):
    """The dual stream's write pass (its output and the norm1 tokens each
    block wrote) and the generation stream's uncond and cond passes on 12
    rows (2 attributes × 6 views), within 1e-5 of their largest value;
    `attn_refview` moves the cond pass, `attn_multiview` mixes the views
    of an attribute group and no others. The other families' options
    still raise, naming their ROADMAP item."""
    pipe = pipes["pipes"]["pbr"]
    x, t, img_lat = _unet_inputs(pipes["jcfgs"]["pbr"])
    j_out_w, j_ref, j_eu, j_ec = pipes["jax_unet"].result()
    unet = pipe.model.unet
    with torch.no_grad():
        out_w, ref = pipe.model.unet_dual(
            nchw(img_lat), torch.zeros(1), unet.tokens("ref")[None],
            class_emb=unet.class_embedding(torch.zeros(1, dtype=torch.long)),
            ref_mode="write")
        assert ref.keys() == pipe.write_reference(nchw(img_lat)).keys()
        cls, ctx_u, ctx_c = pipe.conditioning()
        args = (nchw(x), torch.as_tensor(t))
        e_u = unet(*args, ctx_u, class_emb=cls)
        e_c = unet(*args, ctx_c, class_emb=cls, ref_mode="read",
                   ref_hidden=ref)
        no_ref = unet(*args, ctx_c, class_emb=cls)
        # a change in one view moves its group's other views only
        x2 = nchw(x).clone()
        x2[1] += 1.0
        moved = (unet(x2, args[1], ctx_u, class_emb=cls) - e_u).abs()
    assert sorted(ref) == sorted(j_ref) == [f"sa_{k}" for k in range(4)]
    _close(nhwc(out_w), j_out_w, what="write pass")
    for k in ref:
        _close(ref[k][0], j_ref[k][0], what=k)
    _close(nhwc(e_u), j_eu, what="uncond pass")
    _close(nhwc(e_c), j_ec, what="cond pass")
    assert (e_c - no_ref).abs().max() > 1e-3
    per_row = moved.flatten(1).max(1).values
    assert (per_row[:6] > 1e-4).all() and (per_row[6:] == 0).all()

    small = dict(block_out_channels=(8, 16), norm_groups=4,
                 cross_attention_dim=16, attention_head_dim=4,
                 down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                 up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))
    UNet2DCondition(UNetConfig(**small, use_ma=True, use_ra=True))
    UNet2DCondition(UNetConfig(**small, use_ma=True, use_ra=True, ip_dim=4))
    for field, val, item in (("mv_decoupled", True, "A.6.6"),
                             ("addition_embed_type", "text_time", "A.6.6")):
        with pytest.raises(NotImplementedError, match=item):
            UNet2DCondition(UNetConfig(**small, **{field: val}))


def test_color_project_matches_jax(pipes):
    """On the six candidate cameras (their `view_proj` within 1e-6 of
    JAX's, the ±90° views included): `project_colors` (colours and
    confidence within 1e-5 of their largest value, the same vertices
    seen), `project_and_inpaint` (the vertices no view saw at 32²
    inpainted: the native inpaint of the same colours and mask equal, the
    vertex colours within 1e-5) and `bake_projection` with the mesh's own
    UVs (the albedo within 1e-5)."""
    jcfg = pipes["jcfgs"]["pbr"]
    mesh, _ = _mesh(with_uv=True)
    cams = pipes["pipes"]["pbr"].cameras()
    views, w = pipes["views"], jcfg.view_weights
    j_colors, j_conf, j_vc, j_albedo, j_view_proj = \
        pipes["jax_color"].result()
    np.testing.assert_allclose(_np(cams.view_proj), j_view_proj, atol=1e-6,
                               rtol=0)
    assert np.abs(j_view_proj[4:, 0, 0]).min() > 0.5      # ±90°: right axis

    colors, conf = tcp.project_colors(mesh, views, cams, view_weights=w,
                                      device="cpu")
    _close(colors, j_colors, what="colours")
    _close(conf, j_conf, what="confidence")
    # at 32² the depth test misses some vertices: the inpaint fills them
    seen = _np(conf) > 1e-3
    assert np.array_equal(seen, j_conf > 1e-3)
    assert 0.5 < seen.mean() < 0.98
    a = native.inpaint_vertex_colors(j_colors, seen, mesh.f)
    b = jnative.inpaint_vertex_colors(j_colors, seen.astype(np.uint8),
                                      mesh.f)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    painted = tcp.project_and_inpaint(mesh, views, cams, view_weights=w,
                                      device="cpu")
    _close(painted.vc, j_vc, what="inpainted colours")
    assert mesh.vc is None

    info = {}
    baked = tcp.bake_projection(mesh, views, cams, texture_size=64,
                                view_weights=w, device="cpu", info=info)
    assert info == {"unwrap": "given"}
    np.testing.assert_array_equal(baked.vt, mesh.vt)
    _close(baked.albedo, j_albedo, what="albedo")


@pytest.mark.parametrize("name", ["v2", "pbr"])
def test_render_geometry_and_paint_views_match_jax(pipes, name):
    """The six geometry maps (normals and positions) within 1e-5 of their
    largest value, and the views after 2 guided steps from JAX's draws
    within 1e-4: V2 → [6, 32, 32, 3], PBR → {albedo, mr}, the two groups
    apart; without draws, a seed's CPU draw decides the views."""
    pipe = pipes["pipes"][name]
    j_normals, j_positions = map(np.asarray,
                                 pipes["jax_geometry"].result()[:2])
    j_views, draws = pipes["jax_views"][name].result()
    normals, positions = pipe.render_geometry(pipes["mesh"])
    _close(normals, j_normals, what="normals")
    _close(positions, j_positions, what="positions")
    assert 0.2 < float((normals > 0).any(-1).float().mean()) < 0.9
    views = pipe.paint_views(pipes["mesh"], pipes["image"], num_steps=STEPS,
                             guidance_scale=GUIDANCE, seed=SEED, draws=draws)
    if name == "pbr":
        assert list(views) == ["albedo", "mr"]
        _close(views["albedo"], j_views[:6], rel=REL_STEPS, what="albedo")
        _close(views["mr"], j_views[6:], rel=REL_STEPS, what="mr")
        assert (views["albedo"] - views["mr"]).abs().max() > 1e-3
    else:
        _close(views, j_views, rel=REL_STEPS, what="views")
        a, b, c = (pipe.paint_views(pipes["mesh"], pipes["image"],
                                    num_steps=1, seed=s) for s in (5, 5, 6))
        assert torch.equal(a, b) and not torch.equal(a, c)


def test_pipeline_call_matches_jax(pipes):
    """`__call__` end to end in PBR: the albedo and metallicRoughness
    textures (1024² in the node's config, 64² here) within 1e-4 of the JAX
    pipeline's `__call__` fed the same views, on the same atlas; then the
    bake with a 2× superres callable (views resized back to 32²), called
    once per bake in each package."""
    pipe = pipes["pipes"]["pbr"]
    j_views, draws = pipes["jax_views"]["pbr"].result()
    (ref, ref_sr), j_calls = pipes["jax_call"].result()
    info = {}
    out = pipe(pipes["mesh"], pipes["image"], num_steps=STEPS,
               guidance_scale=GUIDANCE, seed=SEED, draws=draws, info=info)
    assert info["unwrap"] == "atlas"
    np.testing.assert_array_equal(out.ft, ref[3])
    np.testing.assert_allclose(out.vt, ref[2], atol=1e-6, rtol=0)
    assert out.albedo.shape == out.metallic_roughness.shape == (64, 64, 3)
    _close(out.albedo, ref[0], rel=REL_STEPS, what="albedo")
    _close(out.metallic_roughness, ref[1], rel=REL_STEPS,
           what="metallic_roughness")
    assert pipes["mesh"].albedo is None and out.vn is not None

    calls = []

    def superres(views):
        calls.append(tuple(views.shape))
        return views.repeat_interleave(2, 1).repeat_interleave(2, 2)

    pipe.set_superres(superres)
    try:
        sr = pipe.bake(pipes["mesh"], {"albedo": torch.tensor(j_views[:6]),
                                       "mr": torch.tensor(j_views[6:])})
    finally:
        pipe.set_superres(None)
    assert calls == j_calls == [(6, 32, 32, 3)] * 2
    _close(sr.albedo, ref_sr[0], rel=REL_STEPS, what="superres albedo")
    _close(sr.metallic_roughness, ref_sr[1], rel=REL_STEPS,
           what="superres metallic_roughness")


def _upstream_state_dict(sd, tokens_3d=True):
    """The port's `unet.*` / `unet_dual.*` state dict in upstream's
    `UNet2p5DConditionModel` layout: `.transformer.` inside every
    transformer block, the learned tokens [1, T, D]."""
    out = {}
    for k, v in sd.items():
        if not k.startswith(("unet.", "unet_dual.")):
            continue
        k2 = k
        for sub in (".norm1.", ".attn1.", ".norm2.", ".attn2.", ".norm3.",
                    ".ff."):
            k2 = k2.replace(f"transformer_blocks.0{sub}",
                            f"transformer_blocks.0.transformer{sub}")
        if "learned_text_clip" in k and tokens_3d:
            v = v[None]
        out[k2] = v.contiguous()
    return out


def test_from_pretrained_matches_jax(pipes, tmp_path, monkeypatch):
    """A paint directory written in upstream's layout (`unet/` with
    config.json and the `UNet2p5DConditionModel` weights: the wrapped
    blocks' `.transformer.` segment, [1, T, D] tokens and a 2.1-only
    `attn_dino` key, which is dropped, in the directory's only weights
    file under a name of its own; `vae/` in two shards named by an index
    file; `scheduler/`) loads strictly, with no tensor left on `meta`; its
    dual write pass and generation cond pass equal (within 1e-5) those of
    the JAX package's `load_paint_checkpoint` of the same directory; an
    unknown key raises."""
    from safetensors.torch import save_file
    pipe = pipes["pipes"]["pbr"]
    sd = pipe.model.state_dict()
    unet_sd = _upstream_state_dict(sd)
    assert any(".transformer.norm1." in k for k in unet_sd)
    unet_sd["unet.down_blocks.0.attentions.0.transformer_blocks.0."
            "attn_dino.to_q.weight"] = torch.zeros(8, 8)
    unet_cfg = {"in_channels": 4, "out_channels": 4,
                "block_out_channels": [8, 16], "layers_per_block": 1,
                "cross_attention_dim": 16, "attention_head_dim": 2,
                "norm_num_groups": 4,
                "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
                "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"]}
    vae_cfg = {"block_out_channels": [8, 16], "layers_per_block": 1,
               "norm_num_groups": 4, "scaling_factor": 0.18215}
    sched = {"prediction_type": "v_prediction", "beta_end": 0.012}
    vae_sd = {k[4:]: v.contiguous() for k, v in sd.items()
              if k.startswith("vae.")}
    unet_file = str(tmp_path / "unet" / "unet2p5d.safetensors")
    for sub, cfg in (("unet", unet_cfg), ("vae", vae_cfg),
                     ("scheduler", sched)):
        (tmp_path / sub).mkdir()
        name = "scheduler_config.json" if sub == "scheduler" else \
            "config.json"
        (tmp_path / sub / name).write_text(json.dumps(cfg))
    save_file(unet_sd, unet_file)
    weight_map = {k: "diffusion_pytorch_model-0000%d-of-00002.safetensors"
                  % (1 + k.startswith("decoder.")) for k in vae_sd}
    for shard in set(weight_map.values()):
        save_file({k: v for k, v in vae_sd.items()
                   if weight_map[k] == shard}, str(tmp_path / "vae" / shard))
    (tmp_path / "vae" / "diffusion_pytorch_model.safetensors.index.json"
     ).write_text(json.dumps({"weight_map": weight_map}))
    assert len(set(weight_map.values())) == 2

    loaded = Hunyuan3DPaintPipeline.from_pretrained(str(tmp_path), pbr=True,
                                                    device="cpu")
    assert not any(t.is_meta for t in [*loaded.model.parameters(),
                                       *loaded.model.buffers()])
    c = loaded.cfg
    assert c.unet.mv_views == c.num_views == 6
    assert c.unet.in_channels == 12 and c.unet.attention_head_dim == -2
    assert (c.prompt_tokens, c.prompt_dim, c.num_cls) == (3, 16, 49)
    assert c.pbr_settings == ("albedo", "mr")
    assert dataclasses.asdict(c.vae) == dataclasses.asdict(tiny_vae_cfg())
    for k, v in loaded.model.vae.state_dict().items():
        assert torch.equal(v, sd["vae." + k]), k

    # JAX's loader builds its module trees by shape here (its flax init
    # takes a minute at these widths) and replaces every group it loads
    def shape_only_init(cls, key=None, cfg=None):
        self_ = cls({}, cfg)
        assert self_.gen_cfg == pipes["jpipes"]["pbr"].gen_cfg
        self_.params = pipes["shapes"]
        return self_

    monkeypatch.setattr(jp.Hunyuan3DPaintPipeline, "init_random",
                        classmethod(shape_only_init))
    jpipe = jpc.load_paint_checkpoint(str(tmp_path), pbr=True)
    # the same modules as the fixture's JAX pipeline: its compiled passes
    # apply the loaded params
    fixture_jpipe = pipes["jpipes"]["pbr"]
    assert jpipe.gen_cfg == fixture_jpipe.gen_cfg
    assert jpipe.dual_cfg == fixture_jpipe.dual_cfg
    x, t, img_lat = _unet_inputs(jpipe.cfg)
    _, _, _, j_ec = pipes["unet_passes"](jpipe.params, x, t, img_lat)
    with torch.no_grad():
        ref = loaded.write_reference(nchw(img_lat))
        cls, _, ctx_c = loaded.conditioning()
        e_c = loaded.model.unet(nchw(x), torch.as_tensor(t), ctx_c,
                                class_emb=cls, ref_mode="read",
                                ref_hidden=ref)
    _close(nhwc(e_c), j_ec, what="cond pass")

    unet_sd["unet.spare.weight"] = torch.zeros(2)
    save_file(unet_sd, unet_file)
    with pytest.raises(RuntimeError, match="spare.weight"):
        Hunyuan3DPaintPipeline.from_pretrained(str(tmp_path), pbr=True,
                                               device="cpu")


def test_full_config_parameter_counts(pipes):
    """The full V2 and PBR configs (SD-2.1 widths, six views) on `meta`:
    each part counts the JAX package's parameters (`jax.eval_shape`) and
    the figures of record; `hunyuan3d_paint_state_dict_from_flax` carries
    every leaf of the tiny flax tree (as many tensors and elements as the
    port's state dict, which it fills); the entry points default to the
    card."""
    assert dataclasses.asdict(port_cfg(jp.PaintConfig(
        pbr_settings=("albedo", "mr")))) == dataclasses.asdict(
        PaintConfig(pbr_settings=("albedo", "mr")))
    n_jax = pipes["jax_counts"].result()
    for attrs in (("albedo", "mr"), ()):
        with torch.device("meta"):
            model = Hunyuan3DPaint(PaintConfig(pbr_settings=attrs))
        unet = model.unet
        n = {name: sum(p.numel() for p in getattr(model, name).parameters())
             for name in ("unet", "unet_dual", "vae")}
        cls = unet.class_embedding.weight.numel()
        tokens = sum(p.numel() for p in unet.parameters(recurse=False))
        extra = sum(p.numel() for k, p in unet.named_parameters()
                    if ".attn_multiview." in k or ".attn_refview." in k)
        assert n["unet"] - cls - tokens == n_jax["unet"] == \
            FULL_PARAMS["unet"]
        assert extra == n_jax["multiview_refview"] == \
            FULL_PARAMS["unet_multiview_refview"]
        assert n["unet_dual"] == n_jax["unet_dual"] == \
            FULL_PARAMS["unet_dual"]
        assert n["vae"] == n_jax["vae"] == FULL_PARAMS["vae"]
        assert cls == n_jax["cls"] == FULL_PARAMS["class_embedding"]
        assert tokens == FULL_PARAMS["tokens" if attrs else "tokens_v2"]

    params = pipes["jpipes"]["pbr"].params
    sd = convert.hunyuan3d_paint_state_dict_from_flax(params)
    leaves = jax.tree.leaves(params)
    assert len(sd) == len(leaves) + 1       # attr_embeds → two tensors
    assert sum(t.numel() for t in sd.values()) == sum(
        np.size(a) for a in leaves)
    assert sd.keys() == pipes["pipes"]["pbr"].model.state_dict().keys()
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            Hunyuan3DPaintPipeline.init_random(0, port_cfg(
                pipes["jcfgs"]["v2"]))
        with pytest.raises((AssertionError, RuntimeError)):
            tcp.project_colors(pipes["mesh"], np.zeros((6, 8, 8, 3)),
                               pipes["pipes"]["pbr"].cameras())
