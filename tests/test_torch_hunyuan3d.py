"""Port parity, Hunyuan3D-2.1 shape generation (config 5's first half):
DINOv2 (SwiGLU, registers, the pre-norm output, SF3D's modulation, a
resized position grid), the ShapeVAE's latent-set transformer and its
occupancy queries, the flow-matching DiT (with CFG and guidance-
distilled), the dense and octree volume decodes, the pipeline image →
latents → grid → mesh at `tiny()`, the full config's parameter counts and
`from_pretrained` on checkpoint files the test writes, `comfy3d_tpu_torch`
against `comfy3d_tpu` on the same numpy inputs and weights (flax params
carried across by `convert.dinov2_state_dict_from_flax`,
`convert.shape_vae_state_dict_from_flax`,
`convert.hunyuan3d_dit_state_dict_from_flax` and
`convert.hunyuan3d_shape_state_dict_from_flax`)."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.models import dinov2 as jd
from comfy3d_tpu.models.hunyuan3d import pipeline as jh
from comfy3d_tpu.models.vecset import convert as jvc
from comfy3d_tpu.models.vecset import dit as jdit
from comfy3d_tpu.models.vecset import vae as jvae

from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.models import dinov2 as td
from comfy3d_tpu_torch.models.hunyuan3d import (Hunyuan3DShape,
                                                Hunyuan3DShapeConfig,
                                                Hunyuan3DShapePipeline)
from comfy3d_tpu_torch.models.vecset import dit as tdit
from comfy3d_tpu_torch.models.vecset import vae as tvae

from tests.test_torch_common import (QUICK_XLA, _load, _np, _params,
                                     one_torch_thread)  # noqa: F401

# single passes against the JAX package: within this share of the largest
# value; after the guided steps, and for decoded grids, within REL_STEPS
REL = 1e-5
REL_STEPS = 1e-4
# the full config's parameters (the JAX package's `jax.eval_shape` counts)
FULL_PARAMS = {"dit": 1_113_274_432, "vae": 214_260_737,
               "cond": 1_136_479_232}


def _close(out, ref, rel=REL, what=""):
    out, ref = _np(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())


def _port_cfg(jcfg) -> Hunyuan3DShapeConfig:
    """The port's config of the same fields as a JAX `Hunyuan3DShapeConfig`."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["dit"] = tdit.DiTConfig(**dataclasses.asdict(jcfg.dit))
    kw["vae"] = tvae.ShapeVAEConfig(**dataclasses.asdict(jcfg.vae))
    kw["cond"] = td.Dinov2Config(**dataclasses.asdict(jcfg.cond))
    return Hunyuan3DShapeConfig(**kw)


def _vae_params(cfg, seed):
    return _params(jvae.ShapeVAE(cfg), jnp.zeros((1, cfg.num_latents,
                                                  cfg.embed_dim)),
                   jnp.zeros((1, 7, 3)), method=jvae.ShapeVAE.init_all,
                   seed=seed)


def test_dinov2_matches_jax():
    """A 42² image on a 4² checkpoint grid (the antialiased bicubic resize
    to 3²), three configs — SwiGLU; GELU with 2 registers and the pre-norm
    output; SF3D's modulation — the tokens within 1e-5 of their largest
    value; ImageNet's constants equal."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 42, 42, 3).astype(np.float32)
    mod = rng.randn(2, 8).astype(np.float32)
    base = dict(hidden=32, layers=2, heads=2, patch=14,
                pretrain_image_size=56)
    cases = {"swiglu": dict(use_swiglu=True),
             "registers_prenorm": dict(num_registers=2, return_prenorm=True),
             "modulation": dict(modulation_dim=8)}
    mods, params = {}, {}
    for i, (name, kw) in enumerate(cases.items()):
        mods[name] = jd.Dinov2(jd.Dinov2Config(**base, **kw))
        params[name] = _params(mods[name], jnp.asarray(x), jnp.asarray(mod),
                               seed=10 + i)
    refs = jax.jit(lambda p: {
        name: m.apply({"params": p[name]}, x, mod) for name, m in
        mods.items()}, compiler_options=QUICK_XLA)(params)
    for name, kw in cases.items():
        cfg = td.Dinov2Config(**base, **kw)
        port = _load(td.Dinov2(cfg),
                     convert.dinov2_state_dict_from_flax(params[name]))
        with torch.no_grad():
            out = port(torch.as_tensor(x).permute(0, 3, 1, 2),
                       torch.as_tensor(mod) if cfg.modulation_dim else None)
        assert out.shape[1] == 1 + cfg.num_registers + 9, name
        _close(out, refs[name], what=name)
    assert td.Dinov2Config(hidden=1536).swiglu_hidden == 4096
    np.testing.assert_array_equal(np.float32(td.IMAGENET_MEAN),
                                  jd.IMAGENET_MEAN)
    np.testing.assert_array_equal(np.float32(td.IMAGENET_STD), jd.IMAGENET_STD)


def test_shape_vae_matches_jax():
    """The latent-set transformer and the occupancy query, with the qk
    LayerNorms (per-head `c_qkv` and `c_kv` packings), and with the geo
    decoder at half width (`latents_proj`), within 1e-5 of the largest
    value."""
    rng = np.random.RandomState(1)
    base = dict(num_latents=16, embed_dim=8, width=64, heads=4,
                num_decoder_layers=2)
    lat = rng.randn(2, 16, 8).astype(np.float32)
    pts = (rng.rand(2, 50, 3) * 2.2 - 1.1).astype(np.float32)
    cases = (dict(qk_norm=True), dict(geo_decoder_downsample_ratio=2))
    mods = [jvae.ShapeVAE(jvae.ShapeVAEConfig(**base, **kw)) for kw in cases]
    params = [_vae_params(m.cfg, 20 + i) for i, m in enumerate(mods)]

    def refs_fn(params):
        out = []
        for m, p in zip(mods, params):
            dec = m.apply({"params": p}, lat)
            out.append((dec, m.apply({"params": p}, dec, pts,
                                     method=jvae.ShapeVAE.query)))
        return out

    refs = jax.jit(refs_fn, compiler_options=QUICK_XLA)(params)
    for kw, p, (dec_ref, logit_ref) in zip(cases, params, refs):
        port = _load(tvae.ShapeVAE(tvae.ShapeVAEConfig(**base, **kw)),
                     convert.shape_vae_state_dict_from_flax(p))
        with torch.no_grad():
            dec = port(torch.as_tensor(lat))
            logits = port.query(dec, torch.as_tensor(pts))
        _close(dec, dec_ref, what=f"{kw} decoded")
        _close(logits, logit_ref, what=f"{kw} logits")

def test_dit_matches_jax():
    """The DiT on a CFG batch of 2 (K-major qkv, RMS qk norms in f32, the
    modulations, the cond tokens first) and guidance-distilled (the
    `guidance_in` branch, within 1e-4: see below), within 1e-5 of the
    largest value; the distilled model without guidance raises."""
    rng = np.random.RandomState(2)
    base = dict(in_channels=8, context_in_dim=32, hidden_size=64,
                num_heads=4, depth=1, depth_single_blocks=2)
    x = rng.randn(2, 16, 8).astype(np.float32)
    t = np.array([0.25, 0.7], np.float32)
    cond = rng.randn(2, 5, 32).astype(np.float32)
    g = np.array([5.0, 7.5], np.float32)
    mods = [jdit.Hunyuan3DDiT(jdit.DiTConfig(**base, guidance_embed=d))
            for d in (False, True)]
    params = [_params(m, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond),
                      jnp.asarray(g) if m.cfg.guidance_embed else None,
                      seed=30 + i) for i, m in enumerate(mods)]
    refs = jax.jit(lambda ps: [
        m.apply({"params": p}, x, t, cond,
                g if m.cfg.guidance_embed else None)
        for m, p in zip(mods, ps)], compiler_options=QUICK_XLA)(params)
    for distilled, p, ref in zip((False, True), params, refs):
        port = _load(tdit.Hunyuan3DDiT(tdit.DiTConfig(
            **base, guidance_embed=distilled)),
            convert.hunyuan3d_dit_state_dict_from_flax(p))
        with torch.no_grad():
            out = port(*map(torch.as_tensor, (x, t, cond)),
                       guidance=torch.as_tensor(g) if distilled else None)
        # the distilled case within REL_STEPS: its guidance embedding takes
        # cos / sin of g·1000·f, and the packages' float32 exp differ by an
        # ulp on 11 of the 128 frequencies f (XLA:CPU's is off the
        # correctly rounded value on 9, torch's on 2), which moves an
        # argument of 7,500 by up to 1e-3
        _close(out, ref, rel=REL_STEPS if distilled else REL,
               what=f"guidance_embed={distilled}")
    with pytest.raises(ValueError, match="guidance"):
        port(*map(torch.as_tensor, (x, t, cond)))
    np.testing.assert_allclose(
        _np(tdit.timestep_embedding(torch.as_tensor(t), 256,
                                    max_period=1000.0)),
        np.asarray(jdit.timestep_embedding(jnp.asarray(t), 256,
                                           max_period=1000.0)),
        atol=1e-4, rtol=0)      # the exp's ulp, times arguments up to 700


def _octahedron(pts):
    """0.5 − ((|x| + |y|) + |z|), which both packages round alike from the
    same float32 points."""
    a = pts.abs() if torch.is_tensor(pts) else jnp.abs(pts)
    return 0.5 - ((a[..., 0] + a[..., 1]) + a[..., 2])


def _sphere(pts):
    return 0.5 - (torch.linalg.norm(pts, dim=-1) if torch.is_tensor(pts)
                  else jnp.linalg.norm(pts, axis=-1))


def test_decodes_match_jax():
    """`decode_volume`, `decode_volume_hierarchical` and
    `decode_volume_auto` on the tiny VAE's query (grids within 1e-4 of the
    largest value) and on analytic fields: the sphere refined 8 → 32 with
    the default band (within 1e-5), and an octahedron, which both packages
    round alike, refined 8 → 32 with 60 and 200 cells per level, fewer
    than the 512 and 4,096 there are, so the stable top-K (ties broken to
    the lower cell, as `jax.lax.top_k` does) decides which points are
    decoded again: the grids equal at the points the last level decoded
    again, within 1e-6 elsewhere (interpolated)."""
    jcfg = jvae.ShapeVAEConfig(num_latents=16, embed_dim=8, width=64,
                               heads=4, num_decoder_layers=1)
    params = _vae_params(jcfg, 40)
    jm = jvae.ShapeVAE(jcfg)
    lat = np.random.RandomState(3).randn(1, 16, 8).astype(np.float32)
    cases = {"dense": (jvae.decode_volume, tvae.decode_volume,
                       dict(octree_resolution=12, num_chunks=500)),
             "auto": (jvae.decode_volume_auto, tvae.decode_volume_auto,
                      dict(octree_resolution=16, coarse_resolution=4,
                           num_chunks=700))}

    def jax_refs(p, lat):
        def q(p, d, x):
            return jm.apply({"params": p}, d, x, method=jvae.ShapeVAE.query)
        dec = jm.apply({"params": p}, lat)
        return dec, {k: jf(q, p, dec, **kw)
                     for k, (jf, _, kw) in cases.items()}

    decoded, refs = jax.jit(jax_refs, compiler_options=QUICK_XLA)(params,
                                                                   lat)
    port = _load(tvae.ShapeVAE(tvae.ShapeVAEConfig(
        **dataclasses.asdict(jcfg))),
        convert.shape_vae_state_dict_from_flax(params))
    t_dec = torch.as_tensor(np.array(decoded))
    with torch.no_grad():
        for name, (_, tf, kw) in cases.items():
            _close(tf(port.query, t_dec, **kw), refs[name], rel=REL_STEPS,
                   what=name)

    zeros = np.zeros((1, 4, 8), np.float32)
    band = (60, 200)
    kw = dict(octree_resolution=32, coarse_resolution=8, bounds=1.0,
              num_chunks=8192)
    sphere_ref, octa_ref = jax.jit(lambda d: (
        jvae.decode_volume_hierarchical(lambda p, d, x: _sphere(x), None, d,
                                        **kw),
        jvae.decode_volume_hierarchical(lambda p, d, x: _octahedron(x),
                                        None, d, band_cells_per_level=band,
                                        **kw)))(zeros)
    out = tvae.decode_volume_hierarchical(lambda d, x: _sphere(x),
                                          torch.as_tensor(zeros), **kw)
    _close(out, sphere_ref, what="sphere, default band")

    ref = np.asarray(octa_ref)
    queried = []

    def field(d, x):
        queried.append(x)
        return _octahedron(x)

    out = _np(tvae.decode_volume_hierarchical(
        field, torch.as_tensor(zeros), band_cells_per_level=band, **kw))
    assert [q.shape[1] for q in queried] == [9 ** 3, 27 * band[0],
                                             27 * band[1]]
    step = 2.0 / 32
    fine = np.round((_np(queried[2][0]) + 1.0) / step).astype(int)
    refined = np.zeros(out.shape[1:], bool)
    refined[tuple(fine.T)] = True
    assert 0 < refined.sum() < refined.size // 4
    np.testing.assert_array_equal(out[0][refined], ref[0][refined])
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def pipes():
    """Both tiny pipelines with the same redrawn weights."""
    jcfg = jh.Hunyuan3DShapeConfig.tiny()
    s, nl, ed = jcfg.image_size, jcfg.vae.num_latents, jcfg.vae.embed_dim
    params = {
        "cond": _params(jd.Dinov2(jcfg.cond), jnp.zeros((1, s, s, 3)),
                        seed=50),
        "dit": _params(jdit.Hunyuan3DDiT(jcfg.dit), jnp.zeros((1, nl, ed)),
                       jnp.zeros((1,)),
                       jnp.zeros((1, 5, jcfg.dit.context_in_dim)), seed=51),
        "vae": _vae_params(jcfg.vae, 52)}
    jpipe = jh.Hunyuan3DShapePipeline(params, jcfg)
    model = Hunyuan3DShape(_port_cfg(jcfg))
    model.load_state_dict(convert.hunyuan3d_shape_state_dict_from_flax(
        params), strict=True)
    return dict(jcfg=jcfg, params=params, jpipe=jpipe,
                pipe=Hunyuan3DShapePipeline(model))


def test_pipeline_matches_jax(pipes):
    """Image (40², resized to 28²) → `encode_cond` (within 1e-5) → 4
    guided steps from JAX's noise for the node's seed (within 1e-4) →
    the grid at octree 32 (within 1e-4) → meshes: from JAX's grid, the
    port's `grid_to_mesh` gives the JAX package's mesh (equal triangles
    and vertices); from each package's own grid, the triangle counts agree
    within 0.1 %. Without `noise=`, a seed's CPU draw decides the
    latents."""
    jpipe, pipe, jcfg = pipes["jpipe"], pipes["pipe"], pipes["jcfg"]
    img = np.random.RandomState(4).rand(40, 40, 3).astype(np.float32)
    seed, guidance, octree = 1234, 7.5, 32
    noise = jax.random.normal(jax.random.PRNGKey(seed),
                              (1, jcfg.vae.num_latents, jcfg.vae.embed_dim))
    jm = jvae.ShapeVAE(jcfg.vae)

    def jax_chain(dit_p, vae_p, img, noise):
        """`jpipe.encode_cond`, `sample_latents`'s loop (`_sample`) from
        `noise` and `latents_to_mesh`'s grid, in one compiled call."""
        cond = jpipe.encode_cond(img)
        lat = jh.Hunyuan3DShapePipeline._sample.__wrapped__(
            jpipe, dit_p, cond, noise, jnp.float32(guidance),
            jcfg.num_steps)
        dec = jm.apply({"params": vae_p}, lat / jcfg.vae.scale_factor)
        grid = jvae.decode_volume_auto(
            lambda p, d, x: jm.apply({"params": p}, d, x,
                                     method=jvae.ShapeVAE.query),
            vae_p, dec, octree_resolution=octree)
        return cond, lat, grid[0]

    cond_ref, lat_ref, grid_ref = map(np.array, jax.jit(
        jax_chain, compiler_options=QUICK_XLA)(
        pipes["params"]["dit"], pipes["params"]["vae"], img, noise))
    cond = pipe.encode_cond(img)
    _close(cond, cond_ref, what="encode_cond")
    assert not cond[1].any()
    lat = pipe.sample_latents(img, guidance_scale=guidance,
                              noise=np.asarray(noise))
    _close(lat, lat_ref, rel=REL_STEPS, what="latents")
    grid = pipe.decode_grid(lat_ref, octree_resolution=octree)[0]
    _close(grid, grid_ref, rel=REL_STEPS, what="grid")

    # a 2^17-triangle first rung (the node's is 2 M): the JAX package's
    # sweep compiles at that capacity; both ladders retry alike
    jmesh = jvae.grid_to_mesh(grid_ref, max_tris=1 << 17)
    mesh = tvae.grid_to_mesh(torch.as_tensor(grid_ref), max_tris=1 << 17)
    assert mesh.num_faces == len(jmesh.f) > 1000
    np.testing.assert_array_equal(mesh.f, np.asarray(jmesh.f))
    np.testing.assert_array_equal(mesh.v, np.asarray(jmesh.v))
    own = pipe.latents_to_mesh(lat, octree_resolution=octree)[0]
    assert abs(own.num_faces - len(jmesh.f)) <= len(jmesh.f) // 1000

    a, b, c = (pipe.sample_latents(img, seed=s, num_steps=1)
               for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)


def _jax_count(module, *args, method=None):
    shapes = jax.eval_shape(functools.partial(module.init, method=method),
                            jax.random.PRNGKey(0), *args)["params"]
    return sum(math.prod(a.shape) for a in jax.tree.leaves(shapes))


def test_full_config_parameter_counts():
    """`Hunyuan3DShapeConfig()` on `meta`: DINOv2-giant, the DiT and the
    ShapeVAE count the JAX package's parameters and the figures of record.
    The JAX counts come from `jax.eval_shape` of each model at the full
    widths with one and two layers of each stack (the layers of a stack
    are alike, so the count is affine in their number), extended to the
    full depths; the entry points default to the card."""
    jcfg = jh.Hunyuan3DShapeConfig()
    assert dataclasses.asdict(_port_cfg(jcfg)) == dataclasses.asdict(
        Hunyuan3DShapeConfig())
    z = jnp.zeros
    c, d, v = jcfg.cond, jcfg.dit, jcfg.vae

    def cond(n):
        return _jax_count(jd.Dinov2(dataclasses.replace(c, layers=n)),
                          z((1, 224, 224, 3)))

    def dit(n, m):
        return _jax_count(jdit.Hunyuan3DDiT(dataclasses.replace(
            d, depth=n, depth_single_blocks=m)), z((1, 8, v.embed_dim)),
            z((1,)), z((1, 5, d.context_in_dim)))

    def vae(n):
        cfg = dataclasses.replace(v, num_decoder_layers=n)
        return _jax_count(jvae.ShapeVAE(cfg), z((1, 8, v.embed_dim)),
                          z((1, 7, 3)), method=jvae.ShapeVAE.init_all)

    c1, d11, v1 = cond(1), dit(1, 1), vae(1)
    n_jax = {"cond": c1 + (c.layers - 1) * (cond(2) - c1),
             "dit": d11 + (d.depth - 1) * (dit(2, 1) - d11)
             + (d.depth_single_blocks - 1) * (dit(1, 2) - d11),
             "vae": v1 + (v.num_decoder_layers - 1) * (vae(2) - v1)}
    with torch.device("meta"):
        model = Hunyuan3DShape(Hunyuan3DShapeConfig())
    for name in ("cond", "dit", "vae"):
        n_port = sum(p.numel() for p in getattr(model, name).parameters())
        # the port's DINOv2 also holds HF's mask_token [1, 1536]
        extra = c.hidden if name == "cond" else 0
        assert n_port - extra == n_jax[name] == FULL_PARAMS[name], name
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            Hunyuan3DShapePipeline.init_random(0, _port_cfg(
                jh.Hunyuan3DShapeConfig.tiny()))


def test_from_pretrained_loads_native_checkpoints(pipes, tmp_path):
    """Tiny checkpoint files in upstream names (the DiT as fp16
    safetensors, the VAE as float32 safetensors, an HF-named DINOv2 as a
    torch file) load strictly as float32 parameters equal to what the JAX
    package's converters (`convert_dit`, `convert_shape_vae`,
    `convert_dinov2`) make of the same files, mapped through the port's
    `*_from_flax` functions; a file with an extra or a missing key
    raises."""
    from safetensors.numpy import save_file
    sd = pipes["pipe"].model.state_dict()

    def part(prefix):
        return {k[len(prefix):]: v.numpy() for k, v in sd.items()
                if k.startswith(prefix)}

    dit, vae, cond = part("dit."), part("vae."), part("cond.")
    paths = {"dit": str(tmp_path / "dit.fp16.safetensors"),
             "vae": str(tmp_path / "vae.safetensors"),
             "cond": str(tmp_path / "dinov2.bin")}
    save_file({k: v.astype(np.float16) for k, v in dit.items()},
              paths["dit"])
    save_file(vae, paths["vae"])
    torch.save({k: torch.as_tensor(v) for k, v in cond.items()},
               paths["cond"])
    cfg = pipes["pipe"].cfg
    pipe = Hunyuan3DShapePipeline.from_pretrained(
        paths["dit"], paths["vae"], paths["cond"], cfg=cfg, device="cpu")
    got = pipe.model.state_dict()
    assert all(v.dtype == torch.float32 for v in got.values())

    want = {
        **{f"dit.{k}": v for k, v in convert.hunyuan3d_dit_state_dict_from_flax(
            jvc.convert_dit({k: v.astype(np.float16)
                             for k, v in dit.items()})).items()},
        **{f"vae.{k}": v for k, v in convert.shape_vae_state_dict_from_flax(
            jvc.convert_shape_vae(vae)).items()},
        **{f"cond.{k}": v for k, v in convert.dinov2_state_dict_from_flax(
            jd.convert_dinov2(cond)).items()}}
    # mask_token: the JAX converter drops it, the port loads the file's
    want["cond.embeddings.mask_token"] = torch.as_tensor(
        cond["embeddings.mask_token"])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # the fp16 file's DiT is the float32 one rounded to fp16
    assert not torch.equal(got["dit.latent_in.weight"],
                           sd["dit.latent_in.weight"])

    for bad in ({**vae, "extra.weight": np.zeros(3, np.float32)},
                {k: v for k, v in vae.items() if k != "post_kl.bias"}):
        save_file(bad, paths["vae"])
        with pytest.raises(RuntimeError, match="state_dict"):
            Hunyuan3DShapePipeline.from_pretrained(
                paths["dit"], paths["vae"], cfg=cfg, device="cpu")
