"""The port's bin and tile compositors without the JAX package: their plain
versions against per-pixel sequential compositors on the CPU, the forwards'
per-splat box against the exact visit test, and the CUDA kernels (forward
and backward) against the plain versions on the card.

This file imports no JAX, so on a machine with the card and no JAX it runs
on its own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = pytest.mark.heavy

import numpy as np
import torch

from comfy3d_tpu_torch.ops import binning, gs_flat, gs_tile
from comfy3d_tpu_torch.ops import gs_render as G

PAD = 512   # zero columns after the pairs (the Pallas kernel's BLK)


def _conic_and_radius(sig, th):
    """Conic (a, b, c) and ceil(3σ) radius of 2D gaussians with axis sigmas
    `sig` [n, 2] turned by `th` [n], with the renderer's 0.3 px² dilation."""
    c, s = np.cos(th), np.sin(th)
    sxx = c * c * sig[:, 0] ** 2 + s * s * sig[:, 1] ** 2 + 0.3
    syy = s * s * sig[:, 0] ** 2 + c * c * sig[:, 1] ** 2 + 0.3
    sxy = c * s * (sig[:, 0] ** 2 - sig[:, 1] ** 2)
    det = sxx * syy - sxy * sxy
    conic = np.stack([syy / det, -sxy / det, sxx / det], -1)
    mid = 0.5 * (sxx + syy)
    lam = mid + np.sqrt(np.maximum(mid * mid - det, 0))
    return conic, np.ceil(3 * np.sqrt(lam))


def make_bins_case(seed, W, H, bin_px, nchan, lens, sat_bin):
    """Pair payload [DPAY, P+PAD] and bounds: per bin `lens[t]` random
    anisotropic splats around the bin, the `sat_bin`'s opaque and wide."""
    rng = np.random.RandomState(seed)
    nby, nbx = -(-H // bin_px), -(-W // bin_px)
    nbins = nby * nbx
    lens = (list(lens) + [0] * nbins)[:nbins]
    bounds = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    cols = []
    for t in range(nbins):
        n = lens[t]
        bx, by = (t % nbx) * bin_px, (t // nbx) * bin_px
        mx = bx + rng.uniform(-6, bin_px + 6, n)
        my = by + rng.uniform(-6, bin_px + 6, n)
        sig = rng.uniform(1.2, 4.0, (n, 2)) * (3.0 if t == sat_bin else 1.0)
        conic, rad = _conic_and_radius(sig, rng.uniform(0, np.pi, n))
        rad = np.maximum(rad, 0.5)
        op = (rng.uniform(0.85, 0.99, n) if t == sat_bin
              else rng.uniform(0.05, 0.9, n))
        ch = np.concatenate([rng.rand(n, nchan - 1),
                             rng.uniform(1, 3, (n, 1))], -1)
        cols.append(np.concatenate([mx[:, None], my[:, None], conic,
                                    op[:, None], ch, rad[:, None]], -1))
    pay = np.concatenate(cols, 0).T.astype(np.float32)
    dpay = -(-(7 + nchan) // 8) * 8
    data = np.zeros((dpay, int(bounds[-1]) + PAD), np.float32)
    data[:pay.shape[0], :bounds[-1]] = pay
    return data, bounds, nbx, nby


CASES = {
    # H not a multiple of 32; bin 1 starts mid-chunk (skip 100) and crosses
    # two 128 boundaries; bin 3 saturates before its last chunk
    "32px": dict(W=64, H=40, bin_px=32, nchan=4, lens=(100, 200, 150, 700),
                 sat_bin=3),
    # 48-px bins (3×3 sub-tiles), an empty bin, 3 channels
    "48px": dict(W=96, H=50, bin_px=48, nchan=3, lens=(300, 0, 129, 700),
                 sat_bin=3),
}


TILE_CASES = {
    # 3×3 tiles; the centre tiles hold more than one 128-slot chunk
    "two_chunks": dict(seed=1, grid=(3, 3), n=40, crowd=150, m=256, nchan=4),
    # 4×3 tiles, 3 channels; the crowded tiles' counts exceed M = 128
    "over_m": dict(seed=2, grid=(3, 4), n=24, crowd=150, m=128, nchan=3),
}


def make_tiles_case(seed, grid, n, crowd, m, nchan):
    """A tile compositor's inputs as `render_arrays` builds them: `n` random
    anisotropic splats over a grid of (rows, cols) 16-px tiles and `crowd`
    more around pixel (24, 24), binned by their 3σ boxes with
    `bin_primitives` and gathered by `_build_tile_data`. Returns (tile_data
    [T, D, M], counts [T] i32 (cut at M), grid_w, nchan, splats, bins);
    splats are the float32 arrays (means2d, conic, opacity, chans, 3σ
    radius)."""
    rng = np.random.RandomState(seed)
    gh, gw = grid
    k = n + crowd
    m2d = np.concatenate([rng.rand(n, 2) * [gw * 16 + 8, gh * 16 + 8] - 4,
                          18 + rng.rand(crowd, 2) * 12]).astype(np.float32)
    conic, rad = _conic_and_radius(rng.uniform(1.5, 6.0, (k, 2)),
                                   rng.uniform(0, np.pi, k))
    conic, rad = conic.astype(np.float32), rad.astype(np.float32)
    op = rng.uniform(0.05, 0.95, k).astype(np.float32)
    chans = np.concatenate([rng.rand(k, nchan - 1),
                            rng.uniform(1, 3, (k, 1))], -1).astype(np.float32)
    r = torch.as_tensor(rad)[:, None]
    mt = torch.as_tensor(m2d)
    bins = binning.bin_primitives(mt - r, mt + r, torch.ones(k, dtype=torch.bool),
                                  gh, gw, max_per_tile=m)
    splats = (m2d, conic, op, chans, rad)
    data = G._build_tile_data(*map(torch.as_tensor, splats[:4]),
                              bins.prim_idx, bins.valid)
    counts = torch.clamp_max(bins.count, m)
    return data, counts, gw, nchan, splats, bins


def rows_of_payload(data, seed=7):
    """Splat rows [P, DPAY] and pair indices [P] whose gather
    (`gs_flat.gather_payload`) is the payload `data` [DPAY, P]: its columns
    in a seeded random order, so the pairs read their rows by index."""
    data = torch.as_tensor(data)
    perm = torch.as_tensor(np.random.RandomState(seed).permutation(
        data.shape[1]))
    rows = torch.empty_like(data.t())
    rows[perm] = data.t()
    return rows.contiguous(), perm


def tile_rows_of(splats):
    """The tile compositor's splat rows [N, D] of a case's splats."""
    return G.tile_rows(*map(torch.as_tensor, splats[:4]))


def sequential_tiles(data, counts, grid_w, nchan):
    """Per-pixel, one slot at a time, in float64: the contract of
    `composite_tiles_fwd_plain` written as plainly as it reads."""
    data = np.asarray(data, np.float64)
    t_tiles, _, m = data.shape
    acc = np.zeros((t_tiles, nchan, 256))
    trans = np.ones((t_tiles, 1, 256))
    p = np.arange(256)
    for t in range(t_tiles):
        px = p % 16 + 0.5 + (t % grid_w) * 16
        py = p // 16 + 0.5 + (t // grid_w) * 16
        for g in range(min(int(counts[t]), m)):
            mx, my, a, b, c, op = data[t, :6, g]
            dx, dy = mx - px, my - py
            power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
            raw = op * np.exp(np.minimum(power, 0.0))
            alpha = np.where((power <= 0) & (raw >= gs_tile.ALPHA_MIN),
                             np.minimum(raw, gs_tile.ALPHA_MAX), 0.0)
            acc[t] += data[t, 6:6 + nchan, g][:, None] * alpha * trans[t, 0]
            trans[t, 0] *= 1.0 - alpha
    return acc, trans


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_tile_plain_matches_sequential_compositor(case):
    data, counts, grid_w, nchan, _, bins = make_tiles_case(**TILE_CASES[case])
    m = data.shape[2]
    assert int(bins.count.max()) > 128               # more than one chunk,
    assert (case == "over_m") == bool((bins.count > m).any())   # or cut at M
    acc, tr = gs_tile.composite_tiles_fwd_plain(data, counts, grid_w, nchan)
    r_acc, r_tr = sequential_tiles(data.numpy(), counts.numpy(), grid_w,
                                   nchan)
    np.testing.assert_allclose(acc.numpy(), r_acc, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tr.numpy(), r_tr, atol=1e-5, rtol=0)


def stray_slots_case(seed=4):
    """The "two_chunks" tile case with slots that must add nothing: past
    each tile's count, copies of live splats (opacity 0.9) marked valid and
    held by splat 0; within the count, every fifth slot marked invalid
    while its splat's columns stay. Returns (tile_data, counts, prim_idx,
    valid, n, grid_w, nchan, g_acc, g_trans), the cotangents seeded, on the
    CPU."""
    data, counts, grid_w, nchan, splats, bins = make_tiles_case(
        **TILE_CASES["two_chunks"])
    t, _, m = data.shape
    slot = torch.arange(m)[None, :]
    past = slot >= counts[:, None]
    src = data[:, :, :1].expand(-1, -1, m)       # each tile's first slot
    data = torch.where(past[:, None, :], src, data)
    data[:, 5][past] = 0.9
    prim_idx = torch.where(past, torch.zeros_like(bins.prim_idx),
                           bins.prim_idx)
    valid = past | (bins.valid & (slot % 5 != 3))
    assert past.any() and (bins.valid & ~valid).any()
    acc, tr = gs_tile.composite_tiles_fwd_plain(data, counts, grid_w, nchan)
    rng = np.random.RandomState(seed)
    g_acc = torch.as_tensor(rng.randn(*acc.shape).astype(np.float32))
    g_tr = torch.as_tensor(rng.randn(*tr.shape).astype(np.float32))
    return (data, counts, prim_idx, valid, len(splats[0]), grid_w, nchan,
            tr, g_acc, g_tr)


def test_bwd_splats_add_only_valid_slots_below_the_count():
    """Invalid slots and slots past the count add nothing; splat 0's row is
    the sum of its own valid slots' columns (the rows every invalid slot
    pointed at before the scatter moved into the kernel)."""
    (data, counts, prim_idx, valid, n, grid_w, nchan, tr, g_acc,
     g_tr) = stray_slots_case()
    g = gs_tile.composite_tiles_bwd_splats(data, counts, prim_idx, valid, n,
                                           grid_w, tr, g_acc, g_tr, nchan)
    cols = gs_tile.composite_tiles_bwd_plain(data, counts, grid_w, tr, g_acc,
                                             g_tr, nchan).numpy()
    in_count = torch.arange(data.shape[2])[None, :] < counts[:, None]
    stray = (in_count & ~valid).numpy()
    assert np.abs(cols.transpose(0, 2, 1)[stray]).max() > 0   # they'd add
    ref = np.zeros((n, 6 + nchan))
    held = np.zeros(n, bool)
    for t in range(data.shape[0]):
        for j in range(int(counts[t])):
            if valid[t, j]:
                i = int(prim_idx[t, j])
                ref[i] += cols[t, :6 + nchan, j]
                held[i] = True
    out = g.numpy()
    assert held[0] and not held.all()
    scale = np.abs(ref).max(0)
    np.testing.assert_allclose(out / scale, ref / scale, atol=1e-5, rtol=0)
    assert not out[~held].any()


def deep_bin_case(nchan=4, n=300):
    """One 32-px bin under 300 wide, nearly opaque splats: within its first
    chunk every pixel's T falls below e^-80 and underflows to 0."""
    rng = np.random.RandomState(5)
    sig = rng.uniform(20.0, 30.0, n)
    inv = 1.0 / (sig * sig)
    pay = np.stack([rng.uniform(8, 24, n), rng.uniform(8, 24, n), inv,
                    np.zeros(n), inv, rng.uniform(0.9, 0.99, n)]
                   + list(rng.rand(nchan, n)) + [np.ceil(3 * sig)])
    data = np.zeros((-(-(7 + nchan) // 8) * 8, n + PAD), np.float32)
    data[:pay.shape[0], :n] = pay
    return data, np.array([0, n], np.int32), 1, 1, dict(
        W=32, H=32, bin_px=32, nchan=nchan)


def sequential_composite(data, bounds, nbx, nby, nchan, W, H, bin_px,
                         merged):
    """Per-pixel, one pair at a time, in float64: the contract of
    `composite_bins_fwd_plain` written as plainly as it reads."""
    sub = bin_px // 16
    nsub = sub * sub
    nbins = nbx * nby
    acc = np.zeros((nbins, nsub, nchan, 256))
    trans = np.ones((nbins, nsub, 256))
    stops = np.zeros((nbins, nsub), np.int32)
    lx, ly = np.arange(256) % 16 + 0.5, np.arange(256) // 16 + 0.5
    for t in range(nbins):
        b0, b1 = int(bounds[t]), int(bounds[t + 1])
        b0_al = b0 // 128 * 128
        nch = -(-(b1 - b0_al) // 128) if b1 > b0 else 0
        ox = [((t % nbx) * sub + s % sub) * 16 for s in range(nsub)]
        oy = [((t // nbx) * sub + s // sub) * 16 for s in range(nsub)]
        in_img = [ox[s] < W and oy[s] < H for s in range(nsub)]
        if merged:
            trans[t][~np.array(in_img)] = 0.0
        groups = [list(range(nsub))] if merged else \
            [[s] for s in range(nsub) if in_img[s]]
        for group in groups:
            for q in range(nch):
                if trans[t][group].max() < gs_flat.EPS_T:
                    break
                for g in range(max(b0, b0_al + q * 128),
                               min(b1, b0_al + (q + 1) * 128)):
                    mx, my, a, b, c, op = data[:6, g].astype(np.float64)
                    ch = data[6:6 + nchan, g]
                    r = data[6 + nchan, g]
                    mxl = mx - (t % nbx) * bin_px
                    myl = my - (t // nbx) * bin_px
                    for s in group:
                        sx0, sy0 = (s % sub) * 16, (s // sub) * 16
                        if not (mxl + r > sx0 and mxl - r < sx0 + 16
                                and myl + r > sy0 and myl - r < sy0 + 16):
                            continue
                        dx, dy = lx + sx0 - mxl, ly + sy0 - myl
                        power = -0.5 * (a * dx * dx + c * dy * dy) \
                            - b * dx * dy
                        raw = op * np.exp(np.minimum(power, 0.0))
                        alpha = np.where(raw >= gs_flat.ALPHA_MIN,
                                         np.minimum(raw, gs_flat.ALPHA_MAX),
                                         0.0)
                        acc[t, s] += ch[:, None] * alpha * trans[t, s]
                        trans[t, s] *= 1.0 - alpha
                for s in group:
                    stops[t, s] = q + 1
    return acc, trans[:, :, None, :], stops


def sequential_gradients(data, bounds, nbx, nby, nchan, W, H, bin_px,
                         stops, g_acc, g_trans):
    """Float64 autograd of Σ acc·g_acc + Σ T·g_trans through a per-pixel
    compositor that walks each in-image sub-tile's first `stops` chunks one
    pair at a time: the gradient `composite_bins_bwd_plain` computes. Which
    pair-pixel terms are live is decided in float32 with the plain
    version's operations, so both keep the same terms."""
    d = torch.tensor(data, dtype=torch.float64, requires_grad=True)
    f32 = np.float32
    sub = bin_px // 16
    p = np.arange(256)
    loss = d.new_zeros(())
    for t in range(nbx * nby):
        b0, b1 = int(bounds[t]), int(bounds[t + 1])
        box, boy = f32((t % nbx) * bin_px), f32((t // nbx) * bin_px)
        for s in range(sub * sub):
            sx0, sy0 = (s % sub) * 16, (s // sub) * 16
            if not ((t % nbx) * bin_px + sx0 < W
                    and (t // nbx) * bin_px + sy0 < H):
                continue
            px = (p % 16).astype(f32) + f32(sx0 + 0.5)
            py = (p // 16).astype(f32) + f32(sy0 + 0.5)
            T = d.new_ones(256)
            acc = d.new_zeros((nchan, 256))
            for g in range(b0, min(b1, b0 // 128 * 128 + 128 * stops[t, s])):
                mxl, myl = data[0, g] - box, data[1, g] - boy
                r = data[6 + nchan, g]
                if not (mxl + r > sx0 and mxl - r < sx0 + 16
                        and myl + r > sy0 and myl - r < sy0 + 16):
                    continue
                a, b, c, op = data[2:6, g]
                dx, dy = px - mxl, py - myl
                power = f32(-0.5) * (a * dx * dx + c * dy * dy) - b * dx * dy
                live = torch.as_tensor(
                    op * np.exp(np.minimum(power, f32(0))) >= f32(1 / 255))
                dx = torch.as_tensor(px, dtype=torch.float64) \
                    - (d[0, g] - float(box))
                dy = torch.as_tensor(py, dtype=torch.float64) \
                    - (d[1, g] - float(boy))
                power = -0.5 * (d[2, g] * dx * dx + d[4, g] * dy * dy) \
                    - d[3, g] * dx * dy
                raw = d[5, g] * torch.exp(torch.clamp_max(power, 0.0))
                alpha = torch.where(live, torch.clamp_max(raw, 0.99),
                                    torch.zeros_like(raw))
                acc = acc + d[6:6 + nchan, g][:, None] * alpha * T
                T = T * (1.0 - alpha)
            loss = loss + (acc * torch.as_tensor(g_acc[t, s])).sum() \
                + (T * torch.as_tensor(g_trans[t, s, 0])).sum()
    loss.backward()
    return d.grad.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("merged", [True, False])
def test_bwd_plain_matches_float64_autograd(case, merged):
    """The plain backward is the gradient of the composited prefix (here T
    stays far above the e^-80 floor of the backward's log T)."""
    cfg = CASES[case]
    data, bounds, nbx, nby = make_bins_case(3, **cfg)
    geo = (nbx, nby, cfg["nchan"], cfg["W"], cfg["H"], cfg["bin_px"])
    acc, tr, st = gs_flat.composite_bins_fwd_plain(
        torch.as_tensor(data), torch.as_tensor(bounds), *geo, merged=merged)
    rng = np.random.RandomState(4)
    g_acc = rng.randn(*acc.shape).astype(np.float32)
    g_tr = rng.randn(*tr.shape).astype(np.float32)
    assert float(tr[tr > 0].min()) > 1e-30       # far above the floor
    ref = sequential_gradients(data, bounds, *geo, st.numpy(), g_acc, g_tr)
    out = gs_flat.composite_bins_bwd_plain(
        torch.as_tensor(data), torch.as_tensor(bounds), tr, st,
        torch.as_tensor(g_acc), torch.as_tensor(g_tr), *geo).numpy()
    p = int(bounds[-1])
    for row in range(6 + cfg["nchan"]):
        scale = np.abs(ref[row, :p]).max()
        assert scale > 0, row
        np.testing.assert_allclose(out[row, :p] / scale, ref[row, :p] / scale,
                                   atol=1e-4, rtol=0, err_msg=f"row {row}")


def test_bwd_is_inexact_where_t_underflows():
    """Pins a fault the port shares with the JAX kernel (ROADMAP §C): where
    T underflows inside the last walked chunk, the backward rebuilds T_i
    from log max(T_fin, e^-80), which overstates every T_i of that chunk,
    and its gradient is not the composited prefix's. When the forward keeps
    log T, this test is to become a parity test with the float64 one."""
    data, bounds, nbx, nby, cfg = deep_bin_case()
    geo = (nbx, nby, cfg["nchan"], cfg["W"], cfg["H"], cfg["bin_px"])
    acc, tr, st = gs_flat.composite_bins_fwd_plain(
        torch.as_tensor(data), torch.as_tensor(bounds), *geo, merged=True)
    assert float((tr == 0).float().mean()) > 0.5
    rng = np.random.RandomState(4)
    g_acc = rng.randn(*acc.shape).astype(np.float32)
    g_tr = rng.randn(*tr.shape).astype(np.float32)
    ref = sequential_gradients(data, bounds, *geo, st.numpy(), g_acc, g_tr)
    out = gs_flat.composite_bins_bwd_plain(
        torch.as_tensor(data), torch.as_tensor(bounds), tr, st,
        torch.as_tensor(g_acc), torch.as_tensor(g_tr), *geo).numpy()
    p = int(bounds[-1])
    worst = max(np.abs(out[r, :p] - ref[r, :p]).max()
                / np.abs(ref[r, :p]).max() for r in range(6 + cfg["nchan"]))
    assert np.isfinite(out).all() and worst > 1.0


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("merged", [True, False])
def test_plain_matches_sequential_compositor(case, merged):
    cfg = CASES[case]
    data, bounds, nbx, nby = make_bins_case(2, **cfg)
    args = (nbx, nby, cfg["nchan"], cfg["W"], cfg["H"], cfg["bin_px"])
    acc, tr, st = gs_flat.composite_bins_fwd_plain(
        torch.as_tensor(data), torch.as_tensor(bounds), *args, merged=merged)
    r_acc, r_tr, r_st = sequential_composite(data, bounds, *args, merged)
    np.testing.assert_array_equal(st.numpy(), r_st)
    np.testing.assert_allclose(acc.numpy(), r_acc, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tr.numpy(), r_tr, atol=1e-5, rtol=0)


# ------------------------------------------------- the per-splat box
def _box_case(kind, n=400, seed=0):
    """f32 splats (mu_x, mu_y, a, b, c, op) around a 16-px window, of one
    kind: random; opacity just above 1/255; thin, rotated ellipses;
    near-singular conics; conics that are not positive definite; values
    that are not finite."""
    rng = np.random.RandomState(seed)
    mu = rng.uniform(-4, 20, (n, 2))
    th = rng.uniform(0, np.pi, n)
    sig = np.exp(rng.randn(n, 2))
    op = rng.uniform(0.01, 1.0, n)
    if kind == "op_near_min":
        op = np.float32(gs_tile.ALPHA_MIN) * (1 + rng.uniform(0, 1e-3, n))
        op[::4] = np.nextafter(np.float32(gs_tile.ALPHA_MIN), np.float32(1))
        sig *= 4
    if kind == "thin_rotated":
        sig[:, 0] = rng.uniform(8, 40, n)
        sig[:, 1] = rng.uniform(0.05, 0.3, n)
    c, s_ = np.cos(th), np.sin(th)
    sxx = c * c * sig[:, 0] ** 2 + s_ * s_ * sig[:, 1] ** 2
    syy = s_ * s_ * sig[:, 0] ** 2 + c * c * sig[:, 1] ** 2
    sxy = c * s_ * (sig[:, 0] ** 2 - sig[:, 1] ** 2)
    det = sxx * syy - sxy * sxy
    a, b, cc = syy / det, -sxy / det, sxx / det
    if kind == "near_singular":
        a = rng.uniform(0.05, 2, n)
        cc = rng.uniform(0.05, 2, n)
        b = np.sqrt(a * cc) * (1 - 10.0 ** rng.uniform(-9, -3, n))
        b[::2] *= -1
    if kind == "not_pd":
        b = np.sqrt(np.abs(a * cc)) * rng.uniform(1.0, 3.0, n)
        a[::3] *= -1
    arr = np.stack([mu[:, 0], mu[:, 1], a, b, cc, op], 1).astype(np.float32)
    if kind == "non_finite":
        for i, v in enumerate([np.nan, np.inf, -np.inf] * (n // 3)):
            arr[i, i % 6] = v
    return torch.as_tensor(arr)


@pytest.mark.parametrize("kind", ["random", "op_near_min", "thin_rotated",
                                  "near_singular", "not_pd", "non_finite"])
def test_no_live_visit_falls_outside_the_box(kind):
    """Every pixel centre of a 16 × 16 window that passes either forward's
    exact visit test (K4: power ≤ 0 and op·G ≥ 1/255; K1: op·G ≥ 1/255),
    evaluated in f32 with the kernels' operations, lies in the splat's box;
    and the warp skip (`box_misses`) never skips a warp with such a pixel."""
    sp = _box_case(kind)
    box = gs_tile.splat_box(*sp.unbind(1))
    x0, x1, y0, y1 = (v[:, None, None] for v in box)
    p = torch.arange(16, dtype=torch.float32) + 0.5
    px, py = p[None, None, :], p[None, :, None]
    mu_x, mu_y, a, b, c, op = (v[:, None, None] for v in sp.unbind(1))
    mx, my = mu_x - px, mu_y - py
    power = -0.5 * (a * mx * mx + c * my * my) - b * mx * my
    raw = op * torch.exp(torch.clamp_max(power, 0.0))
    live_k1 = raw >= gs_tile.ALPHA_MIN
    live_k4 = live_k1 & (power <= 0.0)
    inside = (x0 <= px) & (px <= x1) & (y0 <= py) & (py <= y1)
    assert not (live_k1 & ~inside).any()
    assert not (live_k4 & ~inside).any()
    w = torch.arange(8, dtype=torch.float32)
    miss = gs_tile.box_misses([v[:, None] for v in box], 0.5, 15.5,
                              2 * w + 0.5, 2 * w + 1.5)          # [n, 8]
    warp_live = live_k1.reshape(-1, 8, 32).any(-1)
    assert not (miss & warp_live).any()
    # the cases exercise what they claim to
    if kind in ("random", "thin_rotated", "op_near_min"):
        assert live_k4.any() and miss.any()
    if kind == "not_pd":
        assert (live_k1 & (power > 0)).any()          # K1's far live visits
        assert torch.isinf(box[0]).all()
    if kind == "non_finite":
        fin = torch.isfinite(sp).all(1)
        assert (~fin).any() and torch.isinf(box[0][~fin]).all()


def test_box_is_the_ellipse_bounding_box_to_within_its_margin():
    """For an axis-aligned splat the box's half-extents are σ·√τ' with
    τ' = 2 ln(255·op) + the slack, widened by BOX_WIDEN; op below 1/255
    gives an empty box."""
    sx, sy, op = 3.0, 1.5, 0.8
    t = torch.tensor
    box = gs_tile.splat_box(t([5.0]), t([7.0]), t([1 / sx ** 2]), t([0.0]),
                            t([1 / sy ** 2]), t([op]))
    tau = 2 * (np.log(op) - np.log(np.float32(gs_tile.ALPHA_MIN))) \
        + gs_tile.BOX_TAU_SLACK
    hx, hy = float(box[1] - 5.0), float(box[3] - 7.0)
    np.testing.assert_allclose(hx, sx * np.sqrt(tau), rtol=1e-5)
    np.testing.assert_allclose(hy, sy * np.sqrt(tau), rtol=1e-5)
    empty = gs_tile.splat_box(t([5.0]), t([7.0]), t([1.0]), t([0.0]),
                              t([1.0]), t([1 / 256]))
    assert empty[0] == np.inf and empty[1] == -np.inf


# ------------------------------------------------- on the card only
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


CARD_CASES = dict(CASES, **{
    # 64-px bins (4×4 sub-tiles): clusters of 16 CTAs
    "64px": dict(W=128, H=70, bin_px=64, nchan=4, lens=(260, 0, 140, 700),
                 sat_bin=3)})


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
@pytest.mark.parametrize("merged", [True, False])
def test_kernel_matches_plain_on_the_card(case, merged):
    dev = _card()
    cfg = CARD_CASES[case]
    data, bounds, nbx, nby = make_bins_case(0, **cfg)
    rows, sprim = (x.to(dev) for x in rows_of_payload(data))
    d, b = torch.as_tensor(data, device=dev), torch.as_tensor(bounds,
                                                              device=dev)
    args = (nbx, nby, cfg["nchan"], cfg["W"], cfg["H"], cfg["bin_px"])
    before = gs_flat.composite_bins_fwd_rows.launches
    acc, tr, st = gs_flat.composite_bins_fwd_rows(rows, sprim, b, *args,
                                                  merged=merged)
    torch.cuda.synchronize()
    assert gs_flat.composite_bins_fwd_rows.launches == before + 1
    p_acc, p_tr, p_st = gs_flat.composite_bins_fwd_plain(d, b, *args,
                                                         merged=merged)
    assert torch.equal(st, p_st)
    assert float((acc - p_acc).abs().max()) <= 1e-4
    assert float((tr - p_tr).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs_before_launch():
    dev = _card()
    data, bounds, nbx, nby = make_bins_case(0, **CASES["32px"])
    rows, sprim = (x.to(dev) for x in rows_of_payload(data))
    b = torch.as_tensor(bounds, device=dev)
    before = gs_flat.composite_bins_fwd_rows.launches
    for bad in [(rows.double(), sprim, b), (rows.t(), sprim, b),
                (rows[:, :12], sprim, b), (rows, sprim.int(), b),
                (rows, sprim.cpu(), b), (rows, sprim, b.cpu()),
                (rows[:0], sprim, b)]:
        with pytest.raises(ValueError):
            gs_flat.composite_bins_fwd_rows(*bad, nbx, nby, 4, 64, 40)
    assert gs_flat.composite_bins_fwd_rows.launches == before


def _bwd_case(case):
    if case == "deep":
        return deep_bin_case()
    cfg = CASES[case]
    return (*make_bins_case(0, **cfg), cfg)


def pair_splats(data, n=37, seed=5):
    """A splat index (of n) for every payload column: pairs of several bins
    share splats, so the backward's per-splat sums add up across bins."""
    return np.random.RandomState(seed).randint(0, n, data.shape[1]), n


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES) + ["deep"])
@pytest.mark.parametrize("merged", [True, False])
def test_bwd_kernel_matches_plain_on_the_card(case, merged):
    dev = _card()
    data, bounds, nbx, nby, cfg = _bwd_case(case)
    d, b = torch.as_tensor(data, device=dev), torch.as_tensor(bounds,
                                                              device=dev)
    sprim, n = pair_splats(data)
    sprim = torch.as_tensor(sprim, device=dev)
    geo = (nbx, nby, cfg["nchan"], cfg["W"], cfg["H"])
    rows, perm = (x.to(dev) for x in rows_of_payload(data))
    acc, tr, st = gs_flat.composite_bins_fwd_rows(rows, perm, b, *geo,
                                                  cfg["bin_px"],
                                                  merged=merged)
    rng = np.random.RandomState(1)
    g_acc = torch.as_tensor(rng.randn(*acc.shape).astype(np.float32),
                            device=dev)
    g_tr = torch.as_tensor(rng.randn(*tr.shape).astype(np.float32),
                           device=dev)
    args = (d, b, sprim, n, tr, st, g_acc, g_tr, *geo, cfg["bin_px"])
    before = gs_flat.composite_bins_bwd_splats.launches
    out = gs_flat.composite_bins_bwd_splats(*args)
    torch.cuda.synchronize()
    assert gs_flat.composite_bins_bwd_splats.launches == before + 1
    ref = gs_flat.composite_bins_bwd_splats_plain(*args)
    assert out.shape == ref.shape == (n, 6 + cfg["nchan"])
    for row in range(6 + cfg["nchan"]):
        scale = float(ref[:, row].abs().max())
        assert float((out[:, row] - ref[:, row]).abs().max()) <= 1e-3 * scale
    # splats no walked pair holds stay exactly 0
    untouched = ~ref.any(1)
    assert not out[untouched].any()


@pytest.mark.cuda
def test_bwd_kernel_rejects_bad_inputs_before_launch():
    dev = _card()
    data, bounds, nbx, nby, cfg = _bwd_case("32px")
    d, b = torch.as_tensor(data, device=dev), torch.as_tensor(bounds,
                                                              device=dev)
    sprim, n = pair_splats(data)
    sprim = torch.as_tensor(sprim, device=dev)
    acc, tr, st = gs_flat.composite_bins_fwd_plain(d, b, nbx, nby, 4, 64, 40)
    before = gs_flat.composite_bins_bwd_splats.launches
    rest = (nbx, nby, 4, 64, 40)
    for bad in [(sprim, n, tr, st, acc.double(), tr),
                (sprim, n, tr, st, acc.transpose(2, 3), tr),
                (sprim, n, tr.cpu(), st, acc, tr),
                (sprim.int(), n, tr, st, acc, tr),
                (sprim.cpu(), n, tr, st, acc, tr),
                (sprim, -1, tr, st, acc, tr)]:
        with pytest.raises(ValueError):
            gs_flat.composite_bins_bwd_splats(d, b, *bad, *rest)
    assert gs_flat.composite_bins_bwd_splats.launches == before


# ------------------------------------------- tile compositor on the card
def _tile_case_on(case, dev):
    """The case's (tile data, counts, grid_w, nchan, splat rows, prim_idx,
    valid, number of splats) on `dev`."""
    data, counts, grid_w, nchan, splats, bins = make_tiles_case(
        **TILE_CASES[case])
    return (data.to(dev), counts.to(dev), grid_w, nchan,
            tile_rows_of(splats).to(dev), bins.prim_idx.to(dev),
            bins.valid.to(dev), len(splats[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_tile_kernels_match_plain_on_the_card(case):
    dev = _card()
    data, counts, grid_w, nchan, rows, prim_idx, valid, n = _tile_case_on(
        case, dev)
    fwd0 = gs_tile.composite_tiles_fwd_rows.launches
    bwd0 = gs_tile.composite_tiles_bwd_splats.launches
    for keep in (False, True):
        acc, tr, block = gs_tile.composite_tiles_fwd_rows(
            rows, prim_idx, valid, counts, grid_w, nchan, keep_block=keep)
        torch.cuda.synchronize()
        assert (block is not None) == keep
    assert gs_tile.composite_tiles_fwd_rows.launches == fwd0 + 2
    p_acc, p_tr = gs_tile.composite_tiles_fwd_plain(data, counts, grid_w,
                                                    nchan)
    assert float((acc - p_acc).abs().max()) <= 1e-4
    assert float((tr - p_tr).abs().max()) <= 1e-4
    # the block: the gathered tile data on every slot below the count,
    # zeros from the count to the end of the last walked chunk
    m = data.shape[2]
    slot = torch.arange(m, device=dev)[None, :]
    below = slot < counts[:, None]
    tail = ~below & (slot < (counts[:, None] + 127) // 128 * 128)
    assert torch.equal(block.transpose(1, 2)[below],
                       data.transpose(1, 2)[below])
    assert not block.transpose(1, 2)[tail].any()

    rng = np.random.RandomState(1)
    g_acc = torch.as_tensor(rng.randn(*acc.shape).astype(np.float32),
                            device=dev)
    g_tr = torch.as_tensor(rng.randn(*tr.shape).astype(np.float32),
                           device=dev)
    out = gs_tile.composite_tiles_bwd_splats(block, counts, prim_idx, valid,
                                             n, grid_w, tr, g_acc, g_tr,
                                             nchan)
    torch.cuda.synchronize()
    assert gs_tile.composite_tiles_bwd_splats.launches == bwd0 + 1
    ref = gs_tile.composite_tiles_bwd_splats_plain(
        data, counts, prim_idx, valid, n, grid_w, tr, g_acc, g_tr, nchan)
    assert out.shape == ref.shape == (n, 6 + nchan)
    for row in range(6 + nchan):
        scale = float(ref[:, row].abs().max())
        assert float((out[:, row] - ref[:, row]).abs().max()) <= 1e-3 * scale
    # splats no valid slot holds stay exactly 0
    held = torch.zeros(n, dtype=torch.bool, device=dev)
    held[prim_idx[valid]] = True
    assert held.any() and not out[~held].any()


@pytest.mark.cuda
def test_tile_fwd_kernel_reads_invalid_slots_as_transparent_on_the_card():
    """Slots marked invalid within the count composite nothing (their
    opacity is taken times valid), as the gathered block's do."""
    dev = _card()
    data, counts, grid_w, nchan, rows, prim_idx, valid, n = _tile_case_on(
        "two_chunks", dev)
    valid = valid & (torch.arange(valid.shape[1], device=dev) % 5 != 3)
    acc, tr, block = gs_tile.composite_tiles_fwd_rows(
        rows, prim_idx, valid, counts, grid_w, nchan, keep_block=True)
    p_acc, p_tr, p_block = gs_tile.composite_tiles_fwd_rows_plain(
        rows, prim_idx, valid, counts, grid_w, nchan, keep_block=True)
    assert float((acc - p_acc).abs().max()) <= 1e-4
    assert float((tr - p_tr).abs().max()) <= 1e-4
    below = torch.arange(valid.shape[1], device=dev)[None, :] \
        < counts[:, None]
    assert torch.equal(block.transpose(1, 2)[below],
                       p_block.transpose(1, 2)[below])


@pytest.mark.cuda
def test_tile_bwd_kernel_adds_only_valid_slots_on_the_card():
    dev = _card()
    (data, counts, prim_idx, valid, n, grid_w, nchan, tr, g_acc,
     g_tr) = stray_slots_case()
    args = [x.to(dev) if torch.is_tensor(x) else x
            for x in (data, counts, prim_idx, valid, n, grid_w, tr, g_acc,
                      g_tr, nchan)]
    out = gs_tile.composite_tiles_bwd_splats(*args)
    torch.cuda.synchronize()
    ref = gs_tile.composite_tiles_bwd_splats_plain(*args)
    for row in range(6 + nchan):
        scale = float(ref[:, row].abs().max())
        assert float((out[:, row] - ref[:, row]).abs().max()) <= 1e-3 * scale
    assert not out[~ref.any(1)].any()


@pytest.mark.cuda
def test_tile_kernels_reject_bad_inputs_before_launch():
    dev = _card()
    data, counts, grid_w, nchan, rows, prim_idx, valid, n = _tile_case_on(
        "over_m", dev)
    fwd0 = gs_tile.composite_tiles_fwd_rows.launches
    bad_fwd = [(rows.double(), prim_idx, valid, counts),
               (rows.t(), prim_idx, valid, counts),
               (rows[:, :8], prim_idx, valid, counts),
               (rows, prim_idx.int(), valid, counts),
               (rows, prim_idx[:, :100].contiguous(), valid, counts),
               (rows, prim_idx, valid.int(), counts),
               (rows, prim_idx, valid, counts.cpu()),
               (rows, prim_idx, valid, counts.long()),
               (rows[:0], prim_idx, valid, counts)]
    for args in bad_fwd:
        with pytest.raises(ValueError):
            gs_tile.composite_tiles_fwd_rows(*args, grid_w, nchan)
    assert gs_tile.composite_tiles_fwd_rows.launches == fwd0
    acc, tr, _ = gs_tile.composite_tiles_fwd_rows(rows, prim_idx, valid,
                                                  counts, grid_w, nchan)
    bwd0 = gs_tile.composite_tiles_bwd_splats.launches
    for g_acc, g_tr, idx, ok, nrow in [
            (acc.double(), tr, prim_idx, valid, n),
            (acc.transpose(1, 2), tr, prim_idx, valid, n),
            (acc, tr.cpu(), prim_idx, valid, n),
            (acc[:, :1], tr, prim_idx, valid, n),
            (acc, tr, prim_idx.int(), valid, n),
            (acc, tr, prim_idx, valid.cpu(), n),
            (acc, tr, prim_idx[:, :64].contiguous(), valid, n),
            (acc, tr, prim_idx, valid, -1)]:
        with pytest.raises(ValueError):
            gs_tile.composite_tiles_bwd_splats(data, counts, idx, ok, nrow,
                                               grid_w, tr, g_acc, g_tr,
                                               nchan)
    assert gs_tile.composite_tiles_bwd_splats.launches == bwd0
