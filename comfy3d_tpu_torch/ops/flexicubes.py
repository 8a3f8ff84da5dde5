"""FlexiCubes surface extraction, differentiable.

Port of `comfy3d_tpu/ops/flexicubes.py` (upstream's `FlexiCubes.__call__`,
the Dual Marching Cubes variant of "Flexible Isosurface Extraction for
Gradient-Based Mesh Optimization"), with the JAX package's machinery:

* per-cube weights (21): 8 corner weights alpha (tanh·0.99 + 1), 12 edge
  weights beta (the same) and a splitting weight gamma (sigmoid·0.99 +
  0.005), packed [:12] beta, [12:20] alpha, [20] gamma (`normalize_weights`);
* alpha-weighted zero crossings on the 12 cube edges and one beta-weighted
  dual vertex per surface cube;
* the L_dev regularizer: per dual vertex, the mean absolute deviation of its
  crossing points' distances to it;
* a quad over each sign-flipping interior grid edge, through the dual
  vertices of its 4 cubes, split along the diagonal of the larger γ·γ
  product (eval) or fanned around a γ-weighted centre vertex (training: 4
  triangles, differentiable).

The JAX package orders each quad's cubes as a cycle and then permutes them
by upstream's [0, 1, 3, 2] / [2, 3, 1, 0], which upstream applies to cubes
sorted by offset, not to a cycle: its quads cross into bow ties, and the
surface has holes and edges shared by three or four faces (ROADMAP §C.14).
By default the port keeps each quad's cycle, in the sense that winds its
faces toward positive sdf (the cycle runs over the two other axes in
increasing order, left-handed around y, and reverses where the edge's
start is not inside), so a closed surface comes out closed and consistently
wound; `quad_order="jax"` gives the JAX package's faces.

The JAX package keeps every slot dense (dual vertices [R³], quads [3·R·(R−1)²]
masked by validity). Here the work is compacted with order-preserving
`nonzero`s, values and gradients unchanged: the cube terms are computed on
the surface cubes only (a non-surface cube's vertex is 0 and its L_dev term
is masked out in the JAX package too, with zero gradient), and only the
valid quads get faces and centres. The faces are the JAX package's valid
faces in its order (axis 0, 1, 2, each z-minor; training's four fans one
after the other), so a rasterizer's ties resolve alike; the dual vertices
stay dense, [R³, 3] with their validity, and training appends one centre
per valid quad (the JAX package one per quad slot).
"""

from __future__ import annotations

import numpy as np
import torch

# cube corner offsets, lexicographic (z-minor): bit 0↔z, 1↔y, 2↔x
_CORNERS = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                     for z in (0, 1)], np.int64)
# 12 cube edges as corner-index pairs (pairs differing in one axis)
_EDGES = np.array([(a, b) for a in range(8) for b in range(8)
                   if a < b and bin(a ^ b).count("1") == 1], np.int64)
# the 4 cubes around a grid edge in cyclic order over the two other axes
_QUAD_OFFSETS = ((-1, -1), (-1, 0), (0, 0), (0, -1))
# each quad's cube order when its edge's start is inside (sdf > 0) and
# when not: "cycle" keeps the cycle (reversed for the second), "jax" the
# JAX package's permutations, which cross the quad into a bow tie
QUAD_ORDERS = {"cycle": ((0, 1, 2, 3), (3, 2, 1, 0)),
               "jax": ((0, 1, 3, 2), (2, 3, 1, 0))}
_WS = 0.99      # the weights' squashing range


def normalize_weights(weights, n_cubes: int, device=None):
    """raw [N, 21] (or None) → (alpha [N, 8], beta [N, 12], gamma [N]):
    [:12] beta, [12:20] alpha, [20] gamma, each squashed."""
    if weights is None:
        one = torch.ones((), device=device)
        return (one.expand(n_cubes, 8), one.expand(n_cubes, 12),
                one.expand(n_cubes))
    beta = torch.tanh(weights[:, :12]) * _WS + 1.0
    alpha = torch.tanh(weights[:, 12:20]) * _WS + 1.0
    return alpha, beta, _gamma(weights[:, 20])


def _gamma(raw):
    return torch.sigmoid(raw) * _WS + (1 - _WS) / 2


def _surface_cubes(sdf3, res: int):
    """The flat indices of the cubes with corners on both sides of 0, in
    order, and their corner vertex indices [S, 8]."""
    occ = sdf3 < 0
    inside = sum(occ[x:x + res, y:y + res, z:z + res].to(torch.int32)
                 for x, y, z in _CORNERS)
    cube = torch.nonzero(((inside > 0) & (inside < 8)).reshape(-1))[:, 0]
    rv = res + 1
    ci = torch.div(cube, res * res, rounding_mode="floor")
    cj = torch.div(cube, res, rounding_mode="floor") % res
    ck = cube % res
    corners = torch.as_tensor(_CORNERS, device=sdf3.device)
    cidx = ((ci[:, None] + corners[:, 0]) * rv + (cj[:, None] + corners[:, 1])
            ) * rv + (ck[:, None] + corners[:, 2])
    return cube, cidx


def _quads(sdf3, res: int, order: str):
    """The valid quads (one per sign-flipping interior grid edge; axis 0,
    1, 2, each in z-minor order): cube indices [Q, 4] in `QUAD_ORDERS`'s
    `order`."""
    dev = sdf3.device
    quads = []
    for axis in range(3):
        o1, o2 = [a for a in range(3) if a != axis]
        # edge start positions, enumerated (axis, o1, o2)-major: the axis
        # coordinate in [0, res), the others interior, [1, res)
        s = sdf3.permute(axis, o1, o2)
        sA, sB = s[:res, 1:res, 1:res], s[1:, 1:res, 1:res]
        flip_edge = (sA < 0) != (sB < 0)
        idx = torch.nonzero(flip_edge)                       # [Q, 3]
        pos = torch.empty_like(idx)
        pos[:, axis] = idx[:, 0]
        pos[:, o1] = idx[:, 1] + 1
        pos[:, o2] = idx[:, 2] + 1
        flip = sA[flip_edge] > 0
        cyc = []
        for d1, d2 in _QUAD_OFFSETS:
            c = pos.clone()
            c[:, o1] += d1
            c[:, o2] += d2
            cyc.append((c[:, 0] * res + c[:, 1]) * res + c[:, 2])
        q = torch.stack(cyc, -1)
        perm_f, perm_b = (torch.as_tensor(p, device=dev)
                          for p in QUAD_ORDERS[order])
        if order == "cycle" and axis == 1:
            # (x, z) is the left-handed pair around y: the other sense
            perm_f, perm_b = perm_b, perm_f
        quads.append(torch.where(flip[:, None], q[:, perm_f], q[:, perm_b]))
    return torch.cat(quads)


def flexicubes(sdf, verts, res: int, weights=None, training: bool = False,
               quad_order: str = "cycle"):
    """sdf [(res+1)³]; verts [(res+1)³, 3] (grid positions plus any
    deformation, z-minor); weights [res³, 21] or None. `quad_order`
    "cycle" splits each quad around its cycle, so the surface closes;
    "jax" takes the JAX package's order, whose quads cross (ROADMAP
    §C.14).

    → (vd [res³(+Q), 3] dual vertices (training appends one centre per
       valid quad), vd_valid [res³(+Q)] bool, faces [2·Q or 4·Q, 3] int64
       indices into vd, face_valid [F] (all True: only valid faces are
       kept), L_dev scalar). Differentiable in sdf, verts and weights."""
    dev = sdf.device
    n_cubes = res ** 3
    sdf3 = sdf.reshape(res + 1, res + 1, res + 1)
    cube, cidx = _surface_cubes(sdf3.detach(), res)
    surf = torch.zeros(n_cubes, dtype=torch.bool, device=dev)
    surf[cube] = True

    alpha, beta, _ = normalize_weights(
        None if weights is None else weights[cube], cube.shape[0], dev)
    e = torch.as_tensor(_EDGES, device=dev)
    s8 = sdf[cidx]                                          # [S, 8]
    s0, s1 = s8[:, e[:, 0]], s8[:, e[:, 1]]
    a0, a1 = alpha[:, e[:, 0]], alpha[:, e[:, 1]]
    x0, x1 = verts[cidx[:, e[:, 0]]], verts[cidx[:, e[:, 1]]]  # [S, 12, 3]
    crossing = (s0 < 0) != (s1 < 0)                         # [S, 12]
    w0, w1 = a0 * s0, a1 * s1
    denom = w1 - w0
    # non-crossing edges (same-sign sdf) can have denom → 0 and an
    # exploding interpolant whose masked contribution still NaNs the
    # gradient: the midpoint there (masked out of every forward quantity)
    safe_denom = torch.where(crossing, denom,
                             torch.where(denom < 0, denom - 1.0, denom + 1.0))
    ue_raw = (x0 * w1[..., None] - x1 * w0[..., None]) / safe_denom[..., None]
    ue = torch.where(crossing[..., None], ue_raw, (x0 + x1) * 0.5)

    bmask = beta * crossing
    bsum = bmask.sum(-1, keepdim=True).clamp_min(1e-12)
    vd_s = (ue * bmask[..., None]).sum(1) / bsum            # [S, 3]
    vd = torch.zeros((n_cubes, 3), dtype=verts.dtype, device=dev) \
        .index_put((cube,), vd_s)

    # L_dev (Equation 8): per dual vertex the mean |dist − mean dist| over
    # its crossing points (eps inside the sqrt: d‖x‖ at 0 is NaN)
    dist = torch.sqrt(((ue - vd_s[:, None, :]) ** 2).sum(-1) + 1e-12)
    n_cross = crossing.sum(-1).clamp_min(1)
    mean_d = (dist * crossing).sum(-1) / n_cross
    mad = (torch.abs(dist - mean_d[:, None]) * crossing).sum(-1) / n_cross
    L_dev = mad.sum() / max(cube.shape[0], 1)

    quads = _quads(sdf3.detach(), res, quad_order)          # [Q, 4]
    qgamma = (torch.ones(quads.shape, device=dev) if weights is None
              else _gamma(weights[:, 20][quads]))
    g02 = qgamma[:, 0] * qgamma[:, 2]
    g13 = qgamma[:, 1] * qgamma[:, 3]
    nq = quads.shape[0]

    if not training:
        # split along the higher-gamma diagonal
        use02 = (g02 > g13)[:, None]
        q0, q1, q2, q3 = quads.unbind(-1)
        tris_a = torch.where(use02, torch.stack([q0, q1, q2], -1),
                             torch.stack([q0, q1, q3], -1))
        tris_b = torch.where(use02, torch.stack([q0, q2, q3], -1),
                             torch.stack([q3, q1, q2], -1))
        faces = torch.cat([tris_a, tris_b])
        return (vd, surf, faces,
                torch.ones(faces.shape[0], dtype=torch.bool, device=dev),
                L_dev)

    # training: a γ-weighted differentiable centre vertex and a 4-fan
    vq = vd[quads]                                          # [Q, 4, 3]
    c02 = (vq[:, 0] + vq[:, 2]) / 2
    c13 = (vq[:, 1] + vq[:, 3]) / 2
    center = (c02 * g02[:, None] + c13 * g13[:, None]) \
        / (g02 + g13 + 1e-8)[:, None]
    cidx_q = n_cubes + torch.arange(nq, device=dev)
    faces = torch.cat([torch.stack([quads[:, k], quads[:, (k + 1) % 4],
                                    cidx_q], -1) for k in range(4)])
    vd_all = torch.cat([vd, center])
    valid_all = torch.cat([surf, torch.ones(nq, dtype=torch.bool,
                                            device=dev)])
    return (vd_all, valid_all, faces,
            torch.ones(faces.shape[0], dtype=torch.bool, device=dev), L_dev)


def grid_verts(res: int, bounds=(-1.0, 1.0)) -> np.ndarray:
    """[(res+1)³, 3] z-minor lexicographic grid vertex positions (numpy)."""
    lin = np.linspace(bounds[0], bounds[1], res + 1, dtype=np.float32)
    gx, gy, gz = np.meshgrid(lin, lin, lin, indexing="ij")
    return np.stack([gx, gy, gz], -1).reshape(-1, 3)
