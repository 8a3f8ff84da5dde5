"""Port parity, the Instant-NGP NeRF fit: the direction encoding, the field
carried over by `convert.ngp_state_from_flax`, the loss and its gradients
on the JAX package's draws, `fit` replaying the JAX package's key schedule,
`density_grid` and `render_views`, `comfy3d_tpu_torch` against
`comfy3d_tpu` at tiny widths on the same numpy inputs."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.algorithms import ngp as jn
from comfy3d_tpu.core.camera import Camera as JCamera
from comfy3d_tpu.ops import raymarch as jrm

from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.algorithms import ngp as tn
from comfy3d_tpu_torch.ops import hashgrid as th

from tests.test_torch_common import QUICK_XLA, _np, one_torch_thread  # noqa: F401

# tiny widths: 4 levels of 2^10 entries, 256 rays × 16 steps, hidden 16
GRID = dict(num_levels=4, log2_table_size=10, max_resolution=32)
NGP = dict(ray_batch=256, num_steps=16, occ_res=16, hidden=16)
V, S = 3, 16           # views and their size
# field outputs and grids against the JAX package: within this share of
# their largest value
REL = 1e-5


# the config classes, held here: a test may monkeypatch the modules' names
# with these functions
_JAX_NGP_CONFIG, _PORT_NGP_CONFIG = jn.NGPConfig, tn.NGPConfig


def jax_cfg(**kw):
    return _JAX_NGP_CONFIG(grid=jn.hashgrid.HashGridConfig(**GRID),
                           **{**NGP, **kw})


def port_cfg(**kw):
    return _PORT_NGP_CONFIG(grid=th.HashGridConfig(**GRID), **{**NGP, **kw})


def jax_draws(cfg, nrays, seed=0):
    """The draws of the JAX package's `ngp.fit` (`PRNGKey(seed + 1)`, split
    in three per iteration; the step's key split in three again): ray
    indices, march jitter and TV samples from one key, the occupancy
    jitter from the iteration's second key, as the port's `fit` takes
    them."""
    key = jax.random.PRNGKey(seed + 1)
    out = []
    for it in range(cfg.iterations):
        key, k1, k2 = jax.random.split(key, 3)
        k_idx, k_march, _ = jax.random.split(k1, 3)
        d = {"idx": jax.random.randint(k_idx, (cfg.ray_batch,), 0, nrays),
             "jitter": jax.random.uniform(k_march, (cfg.ray_batch,
                                                    cfg.num_steps)),
             "tv": jax.random.uniform(k_march, (tn.TV_SAMPLES, 3))}
        if it < tn.OCC_WARMUP or it % cfg.occ_update_every == 0:
            d["occ"] = jax.random.uniform(k2, (cfg.occ_res ** 3, 3))
        out.append({k: torch.tensor(np.array(v)) for k, v in d.items()})
    for d in out:
        d["idx"] = d["idx"].long()
    return out


def _close(out, ref, rel=REL, what=""):
    out, ref = _np(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())


@pytest.fixture(scope="module")
def scene():
    """Three 16² views of random colours and masks from an orbit, the JAX
    cameras and their port copy, and JAX's init of the field."""
    jc = JCamera.from_orbit(np.array([-30.0, 0.0, 30.0], np.float32),
                            np.array([0.0, 120.0, 240.0], np.float32), 2.0,
                            fovy_deg=49.1, width=S, height=S)
    cams = convert.camera_from_numpy(np.asarray(jc.c2w),
                                     np.asarray(jc.fovy_deg), S, S, jc.near,
                                     jc.far, "cpu")
    rng = np.random.RandomState(0)
    imgs = rng.rand(V, S, S, 3).astype(np.float32)
    masks = (rng.rand(V, S, S) > 0.5).astype(np.float32)
    params = jn.init_params(jax.random.PRNGKey(0), jax_cfg())
    return dict(jc=jc, cams=cams, imgs=imgs, masks=masks, params=params)


def _field(params):
    return tn.make_field(convert.ngp_state_from_flax(params), port_cfg(),
                         device="cpu")


def test_dir_encoding_matches_jax():
    d = np.random.RandomState(1).randn(512, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _close(tn._dir_encoding(torch.as_tensor(d)),
           jn._dir_encoding(jnp.asarray(d)), rel=1e-6)


def test_field_through_the_converter_matches_jax(scene):
    """σ, the geo features and rgb of JAX's init, carried over by
    `convert.ngp_state_from_flax`, within 1e-5 of their largest value; the
    state dict's names and shapes are the module's; `init_params` draws
    the same distribution."""
    params = scene["params"]
    rng = np.random.RandomState(2)
    x = (rng.rand(2048, 3) * 2.2 - 1.1).astype(np.float32)
    d = rng.randn(2048, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    @jax.jit
    def ref_fn(p, x, d):
        field, density = jn.make_field(p, jax_cfg())
        return density(x), field(x, d)

    (jsig, jgeo), (_, jrgb) = ref_fn(params, jnp.asarray(x), jnp.asarray(d))
    f = _field(params)
    sig, geo = f.density(torch.as_tensor(x))
    _, rgb = f.field(torch.as_tensor(x), torch.as_tensor(d))
    for o, r, k in ((sig, jsig, "sigma"), (geo, jgeo, "geo"),
                    (rgb, jrgb, "rgb")):
        _close(o, r, what=k)
    own = tn.init_params(port_cfg(), torch.Generator().manual_seed(0),
                         device="cpu")
    assert {k: tuple(v.shape) for k, v in own.state_dict().items()} == {
        k: v.shape for k, v in convert.ngp_state_from_flax(params).items()}
    assert own.table.detach().abs().max().item() <= 1e-4
    assert own.sig1.bias.detach().abs().max().item() == 0.0
    assert abs(own.sig1.weight.detach().std().item() * np.sqrt(8) - 1.0) < 0.1


def test_loss_and_gradients_from_jax_draws(scene):
    """One step's loss (march + white background + entropy + TV) on JAX's
    first draws, and every parameter's gradient, within 1e-5 of their
    largest value (the table's within 1e-4: scatter-adds in another
    order)."""
    cfg, tcfg = jax_cfg(iterations=1), port_cfg(iterations=1)
    d = jax_draws(cfg, V * S * S)[0]
    run = tn.NGPFit(scene["cams"], scene["imgs"], scene["masks"], tcfg,
                    init=_field(scene["params"]), device="cpu")
    run.occ = run.occ + 1.0                  # every cell occupied
    loss = run.loss(d)
    loss.backward()

    jo, jd = (np.asarray(a).reshape(-1, 3) for a in
              jn.get_rays(scene["jc"]))
    flat_rgb = (scene["imgs"] * scene["masks"][..., None]
                + (1.0 - scene["masks"][..., None])).reshape(-1, 3)
    flat_m = scene["masks"].reshape(-1)
    idx = _np(d["idx"])
    jitter = jnp.asarray(_np(d["jitter"]))
    tv_x = jnp.asarray(_np(d["tv"]))

    def loss_fn(p):
        field, _ = jn.make_field(p, cfg)
        # the march with the given jitter: `sample_along_rays`' stratified
        # samples, as `raymarch.march` takes them from its key
        o, dr = jnp.asarray(jo[idx]), jnp.asarray(jd[idx])
        t_near, t_far = jrm.ray_aabb(o, dr, cfg.bound)
        u = (jnp.arange(cfg.num_steps, dtype=jnp.float32) + 0.5) \
            / cfg.num_steps
        u = u[None, :] + (jitter - 0.5) / cfg.num_steps
        span = jnp.maximum(t_far - t_near, 0.0)
        ts = t_near[:, None] + u * span[:, None]
        xyz = o[:, None, :] + ts[..., None] * dr[:, None, :]
        sigma, rgb = field(xyz.reshape(-1, 3), jnp.broadcast_to(
            dr[:, None, :], xyz.shape).reshape(-1, 3))
        sigma = sigma.reshape(ts.shape)
        sigma = jnp.where(ts < t_far[:, None], sigma, 0.0)
        w = jrm.render_weights(sigma, span[:, None] / cfg.num_steps)
        a = w.sum(1)
        out = (w[..., None] * rgb.reshape(ts.shape + (3,))).sum(1) \
            + (1.0 - a[:, None])
        loss = ((out - flat_rgb[idx]) ** 2).mean()
        loss = loss + cfg.lambda_entropy * ((a - flat_m[idx]) ** 2).mean()
        eps = jnp.eye(3) / cfg.grid.max_resolution
        f0 = jn.hashgrid.encode(p["table"], tv_x, cfg.grid)
        tv = 0.0
        for k in range(3):
            fk = jn.hashgrid.encode(p["table"],
                                    jnp.clip(tv_x + eps[k], 0.0, 1.0),
                                    cfg.grid)
            tv = tv + jnp.mean((fk - f0) ** 2)
        return loss + cfg.lambda_tv * tv

    ref, grads = jax.jit(jax.value_and_grad(loss_fn),
                         compiler_options=QUICK_XLA)(scene["params"])
    assert abs(loss.item() - float(ref)) <= 1e-5 * abs(float(ref))
    sd = convert.ngp_state_from_flax(grads)
    for k, p in run.field.named_parameters():
        _close(p.grad, sd[k], rel=1e-4 if k == "table" else REL, what=k)


def test_fit_replays_the_jax_key_schedule(scene):
    """Six iterations (each updating the occupancy grid) from JAX's init
    and JAX's draws: every parameter within 1e-2 of its largest value (the
    MLPs within 1e-4; float rounding decides the fit's discrete turns, a
    cell on either side of the occupancy threshold, Adam's step on a
    gradient near its ε, so table entries move apart by up to a step of
    lr), the occupancy EMA within 1e-4,
    and a generator-driven fit reproducible from its seed."""
    cfg, tcfg = jax_cfg(iterations=6), port_cfg(iterations=6)
    jparams, jocc = jn.fit(scene["jc"], scene["imgs"], scene["masks"], cfg,
                           seed=0)
    field, occ = tn.fit(scene["cams"], scene["imgs"], scene["masks"], tcfg,
                        draws=jax_draws(cfg, V * S * S),
                        init=_field(scene["params"]), device="cpu")
    sd = convert.ngp_state_from_flax(jparams)
    for k, v in field.state_dict().items():
        _close(v, sd[k], rel=1e-2 if k == "table" else 1e-4, what=k)
    _close(occ, jocc, rel=1e-4, what="occ")
    small = port_cfg(iterations=2)
    a, b = (tn.fit(scene["cams"], scene["imgs"], scene["masks"], small,
                   seed=3, device="cpu")[0].table for _ in range(2))
    assert torch.equal(a, b)


def test_density_grid_matches_jax(scene):
    """σ on a 20³ lattice (two 4,096-point chunks and a short one) within
    1e-5 of its largest value."""
    grid = tn.density_grid(_field(scene["params"]), port_cfg(), res=20,
                           chunk=4096)
    ref = jn.density_grid(scene["params"], jax_cfg(), res=20, chunk=4096)
    assert tuple(grid.shape) == (20, 20, 20)
    _close(grid, ref)


def test_render_views_matches_jax(scene):
    """Full images of JAX's init field from the three cameras (no jitter),
    with an occupancy grid that empties a corner of the box: rgb, alpha and
    depth within 1e-5 of their largest value."""
    occ = np.ones((16, 16, 16), np.float32)
    occ[:8, :8] = 0.0
    ref = jn.render_views(scene["params"], scene["jc"], jax_cfg(),
                          occ_values=jnp.asarray(occ), chunk_rays=300)
    out = tn.render_views(_field(scene["params"]), scene["cams"],
                          port_cfg(), occ_values=torch.as_tensor(occ),
                          chunk_rays=300)
    for k in ("rgb", "alpha", "depth"):
        _close(out[k], ref[k], what=k)
    assert 0.0 < float(out["alpha"].mean()) < 1.0
