"""Port parity, the multi-resolution hash-grid encoding: per-level
resolutions, the dense and hashed corner indices, `encode` and its table
gradient, and the TV regulariser from given samples, `comfy3d_tpu_torch`
against `comfy3d_tpu` on the same numpy inputs."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.ops import hashgrid as jh

from comfy3d_tpu_torch.ops import hashgrid as th

from tests.test_torch_common import QUICK_XLA, _np, one_torch_thread  # noqa: F401

# a table of 2^11 entries: the 5³ and 11³ lattices of levels 4 and 10 fit
# it (dense), those of 25 and 63 do not (hashed)
SMALL = dict(num_levels=4, log2_table_size=11, base_resolution=4,
             max_resolution=64)
# encodings against the JAX package: within this share of their largest
# value (the 8 corners' weighted sum may add in another order)
REL = 1e-6


def _cfgs(**kw):
    return jh.HashGridConfig(**kw), th.HashGridConfig(**kw)


def _points(n, seed):
    """n points in [0, 1]³, the corners and faces of the cube among them
    (a clipped coordinate lands on the lattice's last corner)."""
    x = np.random.RandomState(seed).rand(n, 3).astype(np.float32)
    x[:8] = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                     -1).reshape(8, 3)
    x[8:12, 0] = 1.0
    return x


def _table(jcfg, seed, scale=0.5):
    return np.asarray(jh.init_params(jax.random.PRNGKey(seed), jcfg,
                                     scale=scale))


def test_resolutions_match_jax():
    """Per-level resolutions equal, the full config's among them (16 → 2048
    over 16 levels, the first five dense in 2^19 entries)."""
    for kw in ({}, SMALL, dict(num_levels=1),
               dict(num_levels=8, base_resolution=16, max_resolution=512)):
        jcfg, tcfg = _cfgs(**kw)
        np.testing.assert_array_equal(tcfg.resolutions(),
                                      jcfg.resolutions())
        assert tcfg.output_dim == jcfg.output_dim
        assert tcfg.table_size == jcfg.table_size
        dense = (jcfg.resolutions() + 1) ** 3 <= jcfg.table_size
        np.testing.assert_array_equal(tcfg.dense_levels(), dense)
    assert th.HashGridConfig(**SMALL).dense_levels().tolist() == [
        True, True, False, False]
    full = th.HashGridConfig()
    assert full.resolutions()[[0, 4, 5, -1]].tolist() == [16, 58, 80, 2048]
    assert full.dense_levels().tolist() == [True] * 5 + [False] * 11


def test_corner_indices_match_jax_hash():
    """Dense and spiral-prime hashed indices equal the JAX package's
    `_hash_corner` (uint32 products with wrap-around, then the remainder)
    level by level, on `SMALL` (two dense, two hashed levels), on the
    full config (16 levels, coordinates up to 2048: every hashed product
    wraps) and on resolutions that fall (the dense levels last)."""
    for kw in (SMALL, {}, dict(SMALL, base_resolution=64, max_resolution=4)):
        jcfg, tcfg = _cfgs(**kw)
        x = _points(1024, 1)
        rows, _ = th.corner_indices(torch.as_tensor(x), tcfg)
        rows = _np(rows)
        offs = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                        -1).reshape(8, 3)
        for lvl, res in enumerate(jcfg.resolutions()):
            res = int(res)
            x0 = np.floor(np.clip(x, 0, 1) * np.float32(res)) \
                .astype(np.int32)
            corners = np.clip(x0[:, None] + offs[None], 0, res)
            ref = np.asarray(jh._hash_corner(jnp.asarray(corners), res,
                                             jcfg.table_size))
            np.testing.assert_array_equal(
                rows[:, lvl] - lvl * jcfg.table_size, ref,
                err_msg=f"{kw} level {lvl}")


@pytest.mark.parametrize("kw", [SMALL, dict(num_levels=6,
                                            log2_table_size=12,
                                            max_resolution=128)])
def test_encode_and_table_gradient_match_jax(kw):
    """`encode` within 1e-6 of its largest value, and the table gradient of
    a seeded linear loss against `jax.grad` within 1e-6 of its largest
    value (scatter-adds in another order)."""
    jcfg, tcfg = _cfgs(**kw)
    table = _table(jcfg, 2)
    x = _points(2048, 3)
    cot = np.random.RandomState(4).randn(2048, jcfg.output_dim) \
        .astype(np.float32)

    @jax.jit
    def ref_fn(t, x):
        return jax.value_and_grad(
            lambda t: (jh.encode(t, x, jcfg) * cot).sum())(t), \
            jh.encode(t, x, jcfg)

    (_, jgrad), jenc = ref_fn(jnp.asarray(table), jnp.asarray(x))
    t = torch.tensor(table, requires_grad=True)
    enc = th.encode(t, torch.as_tensor(x), tcfg)
    (enc * torch.as_tensor(cot)).sum().backward()
    jenc, jgrad = np.asarray(jenc), np.asarray(jgrad)
    assert tuple(enc.shape) == jenc.shape == (2048, jcfg.output_dim)
    assert np.abs(_np(enc) - jenc).max() <= REL * np.abs(jenc).max()
    assert np.abs(_np(t.grad) - jgrad).max() <= REL * np.abs(jgrad).max()
    assert np.count_nonzero(jgrad) > 0


def test_total_variation_from_given_samples_matches_jax():
    """The TV regulariser on the JAX package's own 4,096 uniform samples
    (`total_variation_loss` draws them from its key) within 1e-5, and its
    table gradient within 1e-5 of the largest."""
    jcfg, tcfg = _cfgs(**SMALL)
    table = _table(jcfg, 5)
    key = jax.random.PRNGKey(7)
    samples = np.array(jax.random.uniform(key, (4096, 3)))
    ref, jgrad = jax.jit(jax.value_and_grad(
        lambda t: jh.total_variation_loss(t, key, jcfg)),
        compiler_options=QUICK_XLA)(jnp.asarray(table))
    t = torch.tensor(table, requires_grad=True)
    out = th.total_variation_loss(t, tcfg, torch.as_tensor(samples))
    out.backward()
    assert abs(out.item() - float(ref)) <= 1e-5 * abs(float(ref))
    jgrad = np.asarray(jgrad)
    assert np.abs(_np(t.grad) - jgrad).max() <= 1e-5 * np.abs(jgrad).max()


def test_init_params_uniform_in_scale():
    """The port's init: [L, T, F] uniform in ±scale, reproducible from a
    generator seed (the JAX package's distribution; draws differ)."""
    _, tcfg = _cfgs(**SMALL)
    a, b, c = (th.init_params(tcfg, torch.Generator().manual_seed(s),
                              device="cpu") for s in (0, 0, 1))
    assert tuple(a.shape) == (4, 2048, 2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.abs().max()) <= 1e-4
    assert abs(float(a.mean())) < 5e-6 and float(a.std()) > 5e-5
