"""Port parity, per-16-px-tile 3DGS path: `bin_primitives`, `tiles_to_image`,
the tile compositor's plain versions (against the Pallas kernels in
interpret mode), its autograd node, and `render_arrays(backend="tile")`,
`comfy3d_tpu_torch` against `comfy3d_tpu` on the same numpy-built inputs.
The render gradients of the tile backend are held against JAX in
`tests/test_torch_train.py::test_render_gradients_match_jax`."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = pytest.mark.heavy

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.ops import binning as jbin
from comfy3d_tpu.ops import gs_render as JG
from comfy3d_tpu.ops.pallas import gs_tile as jtile

from comfy3d_tpu_torch.ops import binning, gs_tile
from comfy3d_tpu_torch.ops import gs_render as G

from tests.test_torch_gs_render import _np, both_cameras, make_scene
from tests.test_torch_kernels import (TILE_CASES, make_tiles_case,
                                      tile_rows_of)


# ------------------------------------------------------------ binning
def _tile_bin_inputs(seed, W, H, n, max_radius, crowd):
    rng = np.random.RandomState(seed)
    if crowd:                          # every box around one tile
        centers = 20 + rng.rand(n, 2) * 6
    else:
        centers = rng.rand(n, 2) * [W + 30, H + 30] - 15
    radii = np.ceil(rng.rand(n) * max_radius)
    active = rng.rand(n) > 0.1
    return ((centers - radii[:, None]).astype(np.float32),
            (centers + radii[:, None]).astype(np.float32), active)


@pytest.mark.parametrize("case", [
    # (seed, W, H, n, max radius, crowd, max_per_tile, max_tiles_per_prim)
    (0, 56, 40, 48, 8.0, False, 16, 16),      # no overflow
    (1, 64, 64, 40, 40.0, False, 16, 4),      # footprint overflow
    (2, 48, 48, 64, 10.0, True, 8, 16),       # max_per_tile overflow
], ids=["plain", "footprint_overflow", "tile_overflow"])
def test_bin_primitives_matches_jax(case):
    seed, W, H, n, rmax, crowd, m, k = case
    grid_h, grid_w = binning.num_tiles(H, W)
    assert (grid_h, grid_w) == jbin.num_tiles(H, W)
    bmin, bmax, active = _tile_bin_inputs(seed, W, H, n, rmax, crowd)
    ref = jbin.bin_primitives(jnp.asarray(bmin), jnp.asarray(bmax),
                              jnp.asarray(active), grid_h, grid_w,
                              max_per_tile=m, max_tiles_per_prim=k)
    port = binning.bin_primitives(torch.as_tensor(bmin),
                                  torch.as_tensor(bmax),
                                  torch.as_tensor(active), grid_h, grid_w,
                                  max_per_tile=m, max_tiles_per_prim=k)
    for field in ("prim_idx", "valid", "count", "overflow"):
        np.testing.assert_array_equal(_np(getattr(port, field)),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)
    assert bool(port.overflow) == (seed > 0)
    count = _np(port.count)
    if seed == 1:          # the footprint cut, not the per-tile one
        assert count.max() <= m
    if seed == 2:
        assert count.max() > m


def test_tiles_to_image_matches_jax():
    grid_h, grid_w, H, W = 3, 4, 40, 56
    vals = np.random.RandomState(0).rand(grid_h * grid_w, 256, 3).astype(
        np.float32)
    for x in (vals, vals[..., 0]):
        np.testing.assert_array_equal(
            _np(binning.tiles_to_image(torch.as_tensor(x), grid_h, grid_w,
                                       H, W)),
            np.asarray(jbin.tiles_to_image(jnp.asarray(x), grid_h, grid_w,
                                           H, W)))
    np.testing.assert_array_equal(
        _np(binning.tile_pixel_centers(grid_h, grid_w)),
        np.asarray(jbin.tile_pixel_centers(grid_h, grid_w)))


# ---------------------------------------------------------- compositor
@functools.lru_cache(maxsize=None)
def _pallas_case(case):
    """The case's inputs, the Pallas kernels' outputs in interpret mode, and
    seeded cotangents."""
    data, counts, grid_w, nchan, _, bins = make_tiles_case(**TILE_CASES[case])
    d, c = jnp.asarray(data.numpy()), jnp.asarray(counts.numpy())
    acc, trans = jtile.composite_tiles_fwd(d, c, grid_w, nchan,
                                           interpret=True)
    rng = np.random.RandomState(1)
    g_acc = rng.randn(*acc.shape).astype(np.float32)
    g_trans = rng.randn(*trans.shape).astype(np.float32)
    gdata = jtile.composite_tiles_bwd(d, c, grid_w, trans, jnp.asarray(g_acc),
                                      jnp.asarray(g_trans), nchan,
                                      interpret=True)
    return (data, counts, grid_w, nchan, bins, np.array(acc),
            np.array(trans), g_acc, g_trans, np.array(gdata))


def jax_scatter(rows, idx, n, nchan):
    """The JAX package's per-splat scatter of its Pallas backward's rows
    [S, D] (`comfy3d_tpu/ops/gs_render.py:534-537`, `:641-644`), as one
    [n, 6 + C] array."""
    rows, idx = jnp.asarray(rows), jnp.asarray(idx)
    gm = jnp.zeros((n, 2)).at[idx].add(rows[:, 0:2])
    gc = jnp.zeros((n, 3)).at[idx].add(rows[:, 2:5])
    go = jnp.zeros((n,)).at[idx].add(rows[:, 5])
    gcol = jnp.zeros((n, nchan)).at[idx].add(rows[:, 6:6 + nchan])
    return np.concatenate([np.asarray(gm), np.asarray(gc),
                           np.asarray(go)[:, None], np.asarray(gcol)], -1)


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_composite_tiles_fwd_plain_matches_pallas(case):
    data, counts, grid_w, nchan, bins, r_acc, r_tr, *_ = _pallas_case(case)
    # the case exercises what it claims to: several chunks, or a cut at M
    assert int(bins.count.max()) > gs_tile.CHUNK
    assert (case == "over_m") == bool((bins.count > data.shape[2]).any())
    acc, tr = gs_tile.composite_tiles_fwd_plain(data, counts, grid_w, nchan)
    np.testing.assert_allclose(_np(acc), r_acc, atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(tr), r_tr, atol=1e-5, rtol=0)


@pytest.mark.parametrize("keep_block", [True, False])
@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_composite_tiles_fwd_rows_plain_matches_pallas(case, keep_block):
    """The forward that takes splat rows and slot indices (the CPU branch
    of `composite_tiles_fwd_rows`) against the Pallas kernel on the
    gathered block; the block it returns is the JAX path's gather."""
    data, counts, grid_w, nchan, bins, r_acc, r_tr, *_ = _pallas_case(case)
    _, _, _, _, splats, _ = make_tiles_case(**TILE_CASES[case])
    rows = tile_rows_of(splats)
    acc, tr, block = gs_tile.composite_tiles_fwd_rows(
        rows, bins.prim_idx, bins.valid, counts, grid_w, nchan,
        keep_block=keep_block)
    np.testing.assert_allclose(_np(acc), r_acc, atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(tr), r_tr, atol=1e-5, rtol=0)
    if not keep_block:
        assert block is None
        return
    m2d, conic, op, chans, _ = splats
    ref = np.asarray(JG._build_tile_data(
        jnp.asarray(m2d), jnp.asarray(conic), jnp.asarray(op),
        jnp.asarray(chans), jnp.asarray(_np(bins.prim_idx)),
        jnp.asarray(_np(bins.valid))))
    np.testing.assert_array_equal(_np(block)[:, :ref.shape[1]], ref)
    assert not _np(block)[:, ref.shape[1]:].any()


@pytest.mark.parametrize("form", ["slots", "splats"])
@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_composite_tiles_bwd_plain_matches_pallas(case, form):
    """Per-slot columns against the Pallas kernel; per-splat rows (the CPU
    branch of `composite_tiles_bwd_splats`) against the Pallas kernel
    followed by the JAX scatter."""
    (data, counts, grid_w, nchan, bins, _, r_tr, g_acc, g_trans,
     ref) = _pallas_case(case)
    cot = (torch.as_tensor(r_tr), torch.as_tensor(g_acc),
           torch.as_tensor(g_trans), nchan)
    if form == "splats":
        n = int(bins.prim_idx.max()) + 3          # two splats in no tile
        out = _np(gs_tile.composite_tiles_bwd_splats(
            data, counts, bins.prim_idx, bins.valid, n, grid_w, *cot))
        r_g = jax_scatter(ref.transpose(0, 2, 1).reshape(-1, ref.shape[1]),
                          _np(bins.prim_idx).reshape(-1), n, nchan)
        assert out.shape == r_g.shape == (n, 6 + nchan)
        for row in range(6 + nchan):
            scale = np.abs(r_g[:, row]).max()
            assert scale > 0, row
            np.testing.assert_allclose(out[:, row] / scale,
                                       r_g[:, row] / scale, atol=1e-5,
                                       rtol=0, err_msg=f"row {row}")
        assert not out[-2:].any() and not r_g[-2:].any()
        return
    out = _np(gs_tile.composite_tiles_bwd_plain(data, counts, grid_w, *cot))
    assert out.shape == ref.shape == tuple(data.shape)
    for row in range(6 + nchan):
        scale = np.abs(ref[:, row]).max()
        assert scale > 0, row
        np.testing.assert_allclose(out[:, row] / scale, ref[:, row] / scale,
                                   atol=1e-4, rtol=0, err_msg=f"row {row}")
    # padding rows, and the slots past each tile's count: exactly 0
    past = np.arange(data.shape[2])[None, :] >= _np(counts)[:, None]
    for x in (out, ref):
        assert not x[:, 6 + nchan:].any()
        assert not x.transpose(0, 2, 1)[past].any()


def test_composite_tiles_gradients_match_jax():
    """`_CompositeTiles` (binning outside) against `jax.grad` of
    `tile_composite_pallas` (binning inside) on the same splats."""
    cfg = dict(TILE_CASES["two_chunks"], crowd=0, m=128)
    _, _, grid_w, nchan, splats, bins = make_tiles_case(**cfg)
    grid_h = cfg["grid"][0]
    radii = splats[4]
    rng = np.random.RandomState(3)
    g_acc = rng.randn(grid_h * grid_w, 256, nchan).astype(np.float32)
    g_t = rng.randn(grid_h * grid_w, 256).astype(np.float32)

    def jloss(args):
        acc, t_fin, _ = JG.tile_composite_pallas(
            *args, jnp.asarray(radii), grid_h, grid_w, 128, 16, True)
        return (acc * g_acc).sum() + (t_fin * g_t).sum()

    ref = jax.grad(jloss)(tuple(map(jnp.asarray, splats[:4])))
    ts = [torch.tensor(a, requires_grad=True) for a in splats[:4]]
    acc, t_fin = G._CompositeTiles.apply(
        *ts, bins.prim_idx, bins.valid, torch.clamp_max(bins.count, 128),
        grid_w)
    ((acc.transpose(1, 2) * torch.as_tensor(g_acc)).sum()
     + (t_fin[:, 0] * torch.as_tensor(g_t)).sum()).backward()
    for t, r_g, name in zip(ts, ref, ["means2d", "conic", "opacity",
                                      "chans"]):
        r_g = np.asarray(r_g)
        scale = np.abs(r_g).max()
        assert scale > 0, name
        np.testing.assert_allclose(_np(t.grad) / scale, r_g / scale,
                                   atol=1e-4, rtol=0, err_msg=name)


# ------------------------------------------------------ end to end
@pytest.mark.parametrize("seed,max_tiles_per_prim", [(0, 16), (3, 2)])
def test_render_arrays_tile_matches_jax(seed, max_tiles_per_prim):
    W, H = 64, 40
    jc, tc = both_cameras(10.0, 25.0, 3.0, W, H)
    arrs = make_scene(seed, n=40)
    kw = dict(max_per_tile=128, max_tiles_per_prim=max_tiles_per_prim)
    port = G.render_arrays(*map(torch.as_tensor, arrs), tc.w2c,
                           tc.intrinsics, W, H, backend="tile", **kw)
    ref = JG.render_arrays(*map(jnp.asarray, arrs), jc.w2c, jc.intrinsics,
                           W, H, backend="xla", chunk=8, **kw)
    for key, atol in (("image", 1e-4), ("alpha", 1e-4), ("depth", 1e-3)):
        np.testing.assert_allclose(_np(port[key]), np.asarray(ref[key]),
                                   atol=atol, rtol=0, err_msg=key)
    np.testing.assert_allclose(_np(port["radii"]), np.asarray(ref["radii"]))
    assert bool(port["overflow"]) == bool(ref["overflow"]) \
        == (max_tiles_per_prim < 16)
    assert 0.0 < float(port["alpha"].mean()) < 1.0
    # the JAX names select the port's paths
    for name, same in (("xla", "tile"), ("pallas", "flat"), ("auto", "flat")):
        a = G.render_arrays(*map(torch.as_tensor, arrs), tc.w2c,
                            tc.intrinsics, W, H, backend=name, **kw)
        b = G.render_arrays(*map(torch.as_tensor, arrs), tc.w2c,
                            tc.intrinsics, W, H, backend=same, **kw)
        assert torch.equal(a["image"], b["image"]), name


# ------------------------------------------------------------- hygiene
def test_tile_backend_rejects_bad_arguments():
    W, H = 32, 32
    _, tc = both_cameras(0.0, 0.0, 3.0, W, H)
    arrs = [torch.as_tensor(a) for a in make_scene(2, n=12, spread=0.4)]
    with pytest.raises(ValueError, match="backend"):
        G.render_arrays(*arrs, tc.w2c, tc.intrinsics, W, H, backend="mosaic")
    # the JAX package's rule (its `xla` compositor reshapes each list into
    # `chunk`-slot steps, so it cannot run 100 at chunk 16 either)
    with pytest.raises(ValueError, match="chunk"):
        G.render_arrays(*arrs, tc.w2c, tc.intrinsics, W, H, backend="tile",
                        max_per_tile=100, chunk=16)
    # the flat path takes no per-tile cap, so it ignores one
    G.render_arrays(*arrs, tc.w2c, tc.intrinsics, W, H, backend="flat",
                    max_per_tile=100)


def test_tile_wrappers_run_the_plain_version_only_on_the_cpu():
    data, counts, grid_w, nchan, splats, bins = make_tiles_case(
        **TILE_CASES["over_m"])
    n = len(splats[0])
    rows = tile_rows_of(splats)
    slots = (bins.prim_idx, bins.valid, counts)
    acc, tr, _ = gs_tile.composite_tiles_fwd_rows(rows, *slots, grid_w,
                                                  nchan)
    with pytest.raises(ValueError, match="cuda"):
        gs_tile.composite_tiles_fwd_rows(
            rows.to("meta"), *[x.to("meta") for x in slots], grid_w, nchan)
    meta = [x.to("meta") for x in (data, counts, bins.prim_idx, bins.valid,
                                    tr, acc, tr)]
    with pytest.raises(ValueError, match="cuda"):
        gs_tile.composite_tiles_bwd_splats(*meta[:4], n, grid_w, *meta[4:],
                                           nchan)
    with pytest.raises(ValueError, match="counts"):
        gs_tile.composite_tiles_fwd_rows(rows, *slots[:2], counts.long(),
                                         grid_w, nchan)
    with pytest.raises(ValueError, match="rows"):
        gs_tile.composite_tiles_fwd_rows(rows[:, :12], *slots, grid_w, nchan)
    with pytest.raises(ValueError, match="valid"):
        gs_tile.composite_tiles_fwd_rows(rows, bins.prim_idx,
                                         bins.valid.int(), counts, grid_w,
                                         nchan)
    with pytest.raises(ValueError, match="g_acc"):
        gs_tile.composite_tiles_bwd_splats(data, counts, bins.prim_idx,
                                           bins.valid, n, grid_w, tr,
                                           acc[:, :1], tr, nchan)
    with pytest.raises(ValueError, match="valid"):
        gs_tile.composite_tiles_bwd_splats(
            data, counts, bins.prim_idx, bins.valid.int(), n, grid_w, tr,
            acc, tr, nchan)


@pytest.mark.parametrize("backend", ["flat", "tile"])
def test_keep_block_on_and_off_give_the_same_outputs(backend):
    """A render that can be differentiated (the tile node then keeps the
    block for its backward; the flat node saves the rows) and one that
    cannot give the same image, alpha and depth; the gradients reach every
    input and are finite."""
    W, H = 48, 40
    _, tc = both_cameras(10.0, 25.0, 3.0, W, H)
    arrs = [torch.as_tensor(a) for a in make_scene(1, n=40)]
    kw = dict(backend=backend, max_per_tile=128)
    with torch.no_grad():
        ref = G.render_arrays(*arrs, tc.w2c, tc.intrinsics, W, H, **kw)
    ins = [a.clone().requires_grad_(True) for a in arrs[:5]]
    out = G.render_arrays(*ins, arrs[5], tc.w2c, tc.intrinsics, W, H, **kw)
    for key in ("image", "alpha", "depth"):
        assert torch.equal(out[key].detach(), ref[key]), key
    (out["image"].sum() + out["alpha"].sum()).backward()
    for x in ins:
        assert x.grad is not None and bool(torch.isfinite(x.grad).all())
        assert bool(x.grad.any())
