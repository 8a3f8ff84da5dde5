"""Charted UV parametrization (the xatlas role).

The port's copy of `comfy3d_tpu/ops/uv_atlas.py` (host code, numpy and
scipy's `lsqr`), so the port does not import the JAX package; the same
charts, the same packing, the same face order. The reference unwraps with
xatlas (`mesh_processer/mesh.py:496` auto_uv). The recipe:

1. chart segmentation — faces are bucketed by dominant normal axis and
   split into edge-connected components (normal-clustered charts);
2. per-chart flattening — LSCM (least-squares conformal map,
   Lévy et al. 2002): each triangle contributes two linear conformality
   equations in its local orthonormal frame; two extremal boundary
   vertices are pinned and the sparse system solved by least squares;
3. packing — charts are rescaled to equalize 3D↔UV area and
   shelf-packed into the unit square with padding.

Charts are face-varying (each chart owns its UV vertices), as in
`ops.texture.box_unwrap`.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _face_buckets(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    axis = np.argmax(np.abs(n), axis=-1)
    sign = (np.take_along_axis(n, axis[:, None], 1)[:, 0] >= 0)
    return (axis * 2 + sign.astype(np.int64)).astype(np.int64)


def _connected_charts(f: np.ndarray, buckets: np.ndarray) -> np.ndarray:
    """Union-find over faces sharing an edge within the same bucket."""
    nf = f.shape[0]
    parent = np.arange(nf)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    edges = {}
    for fi in range(nf):
        a, b, c = f[fi]
        for u, w in ((a, b), (b, c), (c, a)):
            key = (u, w) if u < w else (w, u)
            other = edges.get(key)
            if other is None:
                edges[key] = fi
            elif buckets[other] == buckets[fi]:
                ra, rb = find(other), find(fi)
                if ra != rb:
                    parent[rb] = ra
    roots = np.array([find(i) for i in range(nf)])
    _, chart_ids = np.unique(roots, return_inverse=True)
    return chart_ids


def _lscm_chart(v: np.ndarray, f_local: np.ndarray) -> np.ndarray:
    """LSCM-flatten one chart. v [Nc,3] chart verts; f_local [Fc,3]
    chart-local faces → uv [Nc,2]."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.linalg import lsqr

    nv = v.shape[0]
    nf = f_local.shape[0]
    if nf == 1 or nv < 4:
        return _planar_project(v, f_local)

    # local orthonormal frame per triangle
    p0, p1, p2 = v[f_local[:, 0]], v[f_local[:, 1]], v[f_local[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0
    x_ax = e1 / np.maximum(np.linalg.norm(e1, axis=1, keepdims=True),
                           1e-20)
    nrm = np.cross(e1, e2)
    n_len = np.linalg.norm(nrm, axis=1, keepdims=True)
    y_ax = np.cross(nrm / np.maximum(n_len, 1e-20), x_ax)
    x1 = np.einsum("ij,ij->i", e1, x_ax)
    x2 = np.einsum("ij,ij->i", e2, x_ax)
    y2 = np.einsum("ij,ij->i", e2, y_ax)
    # local 2D coords: (0,0), (x1,0), (x2,y2); gradients of hat funcs
    area2 = np.maximum(np.abs(x1 * y2), 1e-16)
    s = 1.0 / np.sqrt(area2)
    wr = np.stack([x2 - x1, -x2, x1], axis=1) * s[:, None]
    wi = np.stack([y2 - np.zeros_like(y2), -y2,
                   np.zeros_like(y2)], axis=1) * s[:, None]

    # pin the two most separated vertices (approx via bbox diagonal)
    ext = v.max(0) - v.min(0)
    axis = int(np.argmax(ext))
    pin_a = int(np.argmin(v[:, axis]))
    pin_b = int(np.argmax(v[:, axis]))
    if pin_a == pin_b:
        pin_b = (pin_a + 1) % nv
    pins = np.array([pin_a, pin_b])
    pin_uv = np.array([[0.0, 0.0], [1.0, 0.0]])

    # unknown ordering: [u_free | v_free]; map vert → free index
    free = np.setdiff1d(np.arange(nv), pins)
    col_of = np.full(nv, -1)
    col_of[free] = np.arange(free.size)
    nfree = free.size

    rows, cols, vals = [], [], []
    rhs = np.zeros(2 * nf)
    tri_rows = np.repeat(np.arange(nf), 3)
    corners = f_local.reshape(-1)
    wr_f, wi_f = wr.reshape(-1), wi.reshape(-1)
    is_pin = col_of[corners] < 0
    pin_slot = np.where(corners == pins[0], 0, 1)

    # real equations: sum wr·u − wi·v = 0 ; imag: sum wi·u + wr·v = 0
    for eq, (cu, cv) in enumerate(((wr_f, -wi_f), (wi_f, wr_f))):
        r = 2 * tri_rows + eq
        fmask = ~is_pin
        rows += [r[fmask], r[fmask]]
        cols += [col_of[corners[fmask]],
                 col_of[corners[fmask]] + nfree]
        vals += [cu[fmask], cv[fmask]]
        pm = is_pin
        np.add.at(rhs, r[pm], -(cu[pm] * pin_uv[pin_slot[pm], 0]
                                + cv[pm] * pin_uv[pin_slot[pm], 1]))
    A = coo_matrix((np.concatenate(vals),
                    (np.concatenate(rows), np.concatenate(cols))),
                   shape=(2 * nf, 2 * nfree)).tocsr()
    sol = lsqr(A, rhs, atol=1e-8, btol=1e-8, iter_lim=2000)[0]
    uv = np.zeros((nv, 2))
    uv[free, 0] = sol[:nfree]
    uv[free, 1] = sol[nfree:]
    uv[pins] = pin_uv
    if not np.isfinite(uv).all():
        return _planar_project(v, f_local)
    return uv


def _planar_project(v: np.ndarray, f_local: np.ndarray) -> np.ndarray:
    """Fallback: project onto the chart's average-normal plane."""
    e1 = v[f_local[:, 1]] - v[f_local[:, 0]]
    e2 = v[f_local[:, 2]] - v[f_local[:, 0]]
    n = np.cross(e1, e2).sum(0)
    n /= max(np.linalg.norm(n), 1e-20)
    a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 \
        else np.array([0.0, 1.0, 0.0])
    x_ax = np.cross(n, a)
    x_ax /= max(np.linalg.norm(x_ax), 1e-20)
    y_ax = np.cross(n, x_ax)
    return np.stack([v @ x_ax, v @ y_ax], -1)


def _surface_area(v: np.ndarray, f: np.ndarray) -> float:
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    return float(0.5 * np.linalg.norm(np.cross(e1, e2), axis=1).sum())


def _uv_area(uv: np.ndarray, f: np.ndarray) -> float:
    e1 = uv[f[:, 1]] - uv[f[:, 0]]
    e2 = uv[f[:, 2]] - uv[f[:, 0]]
    return float(0.5 * np.abs(e1[:, 0] * e2[:, 1]
                              - e1[:, 1] * e2[:, 0]).sum())


def _pack(charts: List[dict], padding: float) -> Tuple[np.ndarray,
                                                       np.ndarray]:
    """Shelf-pack chart rectangles into [0,1]²; returns (vt, ft)."""
    # equalize texel density: scale every chart so uv area == 3D area
    for c in charts:
        ua = _uv_area(c["uv"], c["f"])
        sc = np.sqrt(c["area3d"] / max(ua, 1e-16))
        c["uv"] = c["uv"] * sc
        lo = c["uv"].min(0)
        c["uv"] -= lo
        c["wh"] = c["uv"].max(0) + 1e-9

    total = sum(float(c["wh"][0] * c["wh"][1]) for c in charts)
    unit = np.sqrt(total)             # target square side pre-padding
    order = sorted(range(len(charts)),
                   key=lambda i: -charts[i]["wh"][1])
    x = y = shelf_h = 0.0
    max_w = 0.0
    pad = padding * unit
    for i in order:
        w, h = charts[i]["wh"]
        if x > 1e-12 and x + w > unit * 1.05:
            y += shelf_h + pad
            x, shelf_h = 0.0, 0.0
        charts[i]["offset"] = np.array([x, y])
        x += w + pad
        shelf_h = max(shelf_h, float(h))
        max_w = max(max_w, x)
    height = y + shelf_h
    scale = 1.0 / max(max_w, height, 1e-16)

    vts, fts = [], []
    base = 0
    for c in charts:
        uv = (c["uv"] + c["offset"]) * scale
        vts.append(uv)
        fts.append(c["f"] + base)
        base += uv.shape[0]
    return (np.concatenate(vts).astype(np.float32),
            np.concatenate(fts).astype(np.int32))


def atlas_unwrap(v: np.ndarray, f: np.ndarray,
                 padding: float = 0.01) -> Tuple[np.ndarray, np.ndarray]:
    """Mesh → (vt [Nuv, 2], ft [F, 3]) charted UV atlas. Face order of
    `ft` matches `f` (the packer concatenates per chart, so a remap
    array restores it)."""
    v = np.asarray(v, np.float64)
    f = np.asarray(f, np.int64)
    if f.size == 0:
        return (np.zeros((0, 2), np.float32), np.zeros((0, 3), np.int32))
    buckets = _face_buckets(v, f)
    chart_ids = _connected_charts(f, buckets)

    charts = []
    face_order = []
    for cid in range(chart_ids.max() + 1):
        fidx = np.nonzero(chart_ids == cid)[0]
        faces = f[fidx]
        verts, local = np.unique(faces.reshape(-1), return_inverse=True)
        f_local = local.reshape(-1, 3)
        vc = v[verts]
        uv = _lscm_chart(vc, f_local)
        charts.append({"uv": uv, "f": f_local,
                       "area3d": max(_surface_area(vc, f_local), 1e-16)})
        face_order.append(fidx)
    vt, ft_cat = _pack(charts, padding)
    # restore original face order
    perm = np.concatenate(face_order)
    ft = np.empty_like(ft_cat)
    ft[perm] = ft_cat
    return vt, ft
