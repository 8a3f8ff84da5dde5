"""PLY reader/writer (ascii + binary_little_endian), meshes and 3DGS splats.

Port of `comfy3d_tpu/core/io/ply.py` (kept as the port's own copy; the files
it writes are byte-identical to the JAX package's). Pure numpy on the host —
file I/O is never device work; `load_gs_ply` moves the arrays to `device`.
"""

from __future__ import annotations

import io
from typing import Dict, List, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}
_INV_DTYPES = {"f4": "float", "f8": "double", "i4": "int", "u4": "uint",
               "u1": "uchar", "i1": "char", "i2": "short", "u2": "ushort"}


class PlyElement:
    def __init__(self, name: str, count: int):
        self.name = name
        self.count = count
        self.properties: List[Tuple[str, str]] = []   # (name, np dtype str)
        self.list_properties: List[Tuple[str, str, str]] = []  # (name, cnt, t)
        self.data: Dict[str, np.ndarray] = {}


def read_ply(path: str) -> Dict[str, PlyElement]:
    """Parse a PLY file into {element_name: PlyElement}."""
    with open(path, "rb") as fh:
        raw = fh.read()
    header_end = raw.find(b"end_header")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header_end = raw.find(b"\n", header_end) + 1
    header = raw[:header_end].decode("ascii", errors="replace")
    body = raw[header_end:]

    fmt = None
    elements: List[PlyElement] = []
    for line in header.splitlines():
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append(PlyElement(parts[1], int(parts[2])))
        elif parts[0] == "property" and elements:
            el = elements[-1]
            if parts[1] == "list":
                el.list_properties.append(
                    (parts[4], _PLY_DTYPES[parts[2]], _PLY_DTYPES[parts[3]]))
            else:
                el.properties.append((parts[2], _PLY_DTYPES[parts[1]]))

    if fmt == "ascii":
        _read_ascii_body(body, elements)
    elif fmt == "binary_little_endian":
        _read_binary_body(body, elements, "<")
    elif fmt == "binary_big_endian":
        _read_binary_body(body, elements, ">")
    else:
        raise ValueError(f"{path}: unsupported PLY format {fmt!r}")
    return {el.name: el for el in elements}


def _read_ascii_body(body: bytes, elements: List[PlyElement]) -> None:
    tokens = body.split()
    pos = 0
    for el in elements:
        if el.list_properties:
            # rows are variable-length; parse row by row
            lists = {name: [] for name, _, _ in el.list_properties}
            scalars = {name: [] for name, _ in el.properties}
            for _ in range(el.count):
                for name, _ in el.properties:
                    scalars[name].append(float(tokens[pos]))
                    pos += 1
                for name, _, _ in el.list_properties:
                    cnt = int(tokens[pos])
                    pos += 1
                    lists[name].append(
                        [float(tokens[pos + k]) for k in range(cnt)])
                    pos += cnt
            for (name, dt) in el.properties:
                el.data[name] = np.asarray(scalars[name], dtype=dt)
            for (name, _, dt) in el.list_properties:
                el.data[name] = np.asarray(lists[name], dtype=dt)
        else:
            width = len(el.properties)
            arr = np.asarray(tokens[pos:pos + el.count * width],
                             dtype=np.float64).reshape(el.count, width)
            pos += el.count * width
            for i, (name, dt) in enumerate(el.properties):
                el.data[name] = arr[:, i].astype(dt)


def _read_binary_body(body: bytes, elements: List[PlyElement],
                      endian: str) -> None:
    offset = 0
    for el in elements:
        if el.list_properties:
            if el.properties:
                raise ValueError("mixed scalar+list PLY elements unsupported")
            name, cnt_dt, val_dt = el.list_properties[0]
            cnt_size = np.dtype(cnt_dt).itemsize
            val_size = np.dtype(val_dt).itemsize
            if el.count == 0:
                el.data[name] = np.zeros((0, 3), val_dt)
                continue
            first_cnt = int(np.frombuffer(
                body, endian + cnt_dt, count=1, offset=offset)[0])
            row_bytes = cnt_size + first_cnt * val_size
            block = np.frombuffer(body, np.uint8, el.count * row_bytes, offset)
            block = block.reshape(el.count, row_bytes)
            counts = block[:, :cnt_size].copy().view(endian + cnt_dt).ravel()
            if not np.all(counts == first_cnt):
                raise ValueError("variable-length PLY face lists unsupported "
                                 "in binary fast path")
            vals = block[:, cnt_size:].copy().view(endian + val_dt)
            el.data[name] = vals.reshape(el.count, first_cnt)
            offset += el.count * row_bytes
        else:
            dt = np.dtype([(n, endian + t) for n, t in el.properties])
            arr = np.frombuffer(body, dt, count=el.count, offset=offset)
            offset += el.count * dt.itemsize
            for name, t in el.properties:
                el.data[name] = np.ascontiguousarray(arr[name])


def write_ply(path: str, vertex_props: Dict[str, np.ndarray],
              faces: np.ndarray | None = None, ascii_fmt: bool = False,
              comments: Tuple[str, ...] = ()) -> None:
    """Write a PLY with a vertex element (column dict) + optional faces.

    Multi-column arrays expand to `name_0, name_1, ...` except the canonical
    xyz/normal/color names which use their PLY conventions.
    """
    cols: List[Tuple[str, np.ndarray]] = []
    for name, arr in vertex_props.items():
        arr = np.asarray(arr)
        if arr.ndim == 1:
            arr = arr[:, None]
        names = _expand_names(name, arr.shape[1])
        for i, n in enumerate(names):
            cols.append((n, np.ascontiguousarray(arr[:, i])))
    count = cols[0][1].shape[0]

    buf = io.BytesIO()
    buf.write(b"ply\n")
    fmt = "ascii" if ascii_fmt else "binary_little_endian"
    buf.write(f"format {fmt} 1.0\n".encode())
    for c in comments:
        buf.write(f"comment {c}\n".encode())
    buf.write(f"element vertex {count}\n".encode())
    for n, a in cols:
        t = _INV_DTYPES[a.dtype.str[1:]]
        buf.write(f"property {t} {n}\n".encode())
    nf = 0 if faces is None else len(faces)
    if faces is not None:
        buf.write(f"element face {nf}\n".encode())
        buf.write(b"property list uchar int vertex_indices\n")
    buf.write(b"end_header\n")

    if ascii_fmt:
        mat = np.stack([a.astype(np.float64) for _, a in cols], axis=1)
        for row in mat:
            buf.write((" ".join(repr(float(x)) for x in row) + "\n").encode())
        if faces is not None:
            for fc in np.asarray(faces, np.int64):
                buf.write((f"{len(fc)} " + " ".join(map(str, fc)) + "\n")
                          .encode())
    else:
        dt = np.dtype([(n, "<" + a.dtype.str[1:]) for n, a in cols])
        rec = np.empty(count, dt)
        for n, a in cols:
            rec[n] = a
        buf.write(rec.tobytes())
        if faces is not None:
            faces = np.asarray(faces, np.int32)
            fdt = np.dtype([("c", "u1"), ("v", "<i4", (faces.shape[1],))])
            frec = np.empty(nf, fdt)
            frec["c"] = faces.shape[1]
            frec["v"] = faces
            buf.write(frec.tobytes())
    with open(path, "wb") as fh:
        fh.write(buf.getvalue())


_CANONICAL = {
    "xyz": ("x", "y", "z"),
    "normals": ("nx", "ny", "nz"),
    "rgb": ("red", "green", "blue"),
}


def _expand_names(name: str, width: int):
    if width == 1:
        return (name,)
    if name in _CANONICAL and len(_CANONICAL[name]) == width:
        return _CANONICAL[name]
    return tuple(f"{name}_{i}" for i in range(width))


# --------------------------------------------------------------------- #
# Mesh-level helpers
# --------------------------------------------------------------------- #

def load_mesh_ply(path: str):
    """PLY → (v, f, vn, vc). Any of f/vn/vc may be None."""
    els = read_ply(path)
    vel = els["vertex"]
    v = np.stack([vel.data["x"], vel.data["y"], vel.data["z"]], -1
                 ).astype(np.float32)
    vn = None
    if "nx" in vel.data:
        vn = np.stack([vel.data["nx"], vel.data["ny"], vel.data["nz"]], -1
                      ).astype(np.float32)
    vc = None
    if "red" in vel.data:
        scale = 255.0 if vel.data["red"].dtype.kind == "u" else 1.0
        vc = np.stack([vel.data["red"], vel.data["green"],
                       vel.data["blue"]], -1).astype(np.float32) / scale
    f = None
    if "face" in els and els["face"].count:
        fel = els["face"]
        key = next(iter(fel.data))
        f = np.asarray(fel.data[key], np.int32)
    return v, f, vn, vc


def save_mesh_ply(path: str, v, f, vn=None, vc=None) -> None:
    props: Dict[str, np.ndarray] = {"xyz": np.asarray(v, np.float32)}
    if vn is not None:
        props["normals"] = np.asarray(vn, np.float32)
    if vc is not None:
        props["rgb"] = np.clip(np.asarray(vc) * 255.0, 0, 255
                               ).astype(np.uint8)
    # same header comment as the JAX package, so the files are identical
    write_ply(path, props, faces=f, comments=("comfy3d_tpu mesh",))


# --------------------------------------------------------------------- #
# 3DGS PLY (the GS-PLY column schema)
# --------------------------------------------------------------------- #

def save_gs_ply(path: str, splat) -> None:
    arrays = splat.to_ply_arrays()
    props = {
        "xyz": arrays["xyz"],
        "normals": arrays["normals"],
        "f_dc": arrays["f_dc"],
    }
    if arrays["f_rest"].shape[1]:
        props["f_rest"] = arrays["f_rest"]
    props["opacity"] = arrays["opacity"]
    props["scale"] = arrays["scale"]
    props["rot"] = arrays["rotation"]
    # exact GS-PLY column names
    renamed = {}
    for key, arr in props.items():
        if key == "f_dc":
            renamed.update({f"f_dc_{i}": arr[:, i] for i in range(3)})
        elif key == "f_rest":
            renamed.update({f"f_rest_{i}": arr[:, i]
                            for i in range(arr.shape[1])})
        elif key == "scale":
            renamed.update({f"scale_{i}": arr[:, i] for i in range(3)})
        elif key == "rot":
            renamed.update({f"rot_{i}": arr[:, i] for i in range(4)})
        else:
            renamed[key] = arr
    # same header comment as the JAX package, so the files are identical
    write_ply(path, renamed, comments=("comfy3d_tpu 3DGS",))


def load_gs_ply(path: str, device=None):
    """GS-PLY → GaussianSplat on `device` (default: the card)."""
    from ..gaussian import GaussianSplat
    els = read_ply(path)
    d = els["vertex"].data
    n = els["vertex"].count
    xyz = np.stack([d["x"], d["y"], d["z"]], -1).astype(np.float32)
    f_dc = np.stack([d[f"f_dc_{i}"] for i in range(3)], -1).astype(np.float32)
    rest_names = sorted((k for k in d if k.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    f_rest = (np.stack([d[k] for k in rest_names], -1).astype(np.float32)
              if rest_names else np.zeros((n, 0), np.float32))
    opacity = d["opacity"].astype(np.float32)
    scale = np.stack([d[f"scale_{i}"] for i in range(3)], -1
                     ).astype(np.float32)
    rot = np.stack([d[f"rot_{i}"] for i in range(4)], -1).astype(np.float32)
    return GaussianSplat.from_ply_arrays(xyz, f_dc, f_rest, opacity, scale,
                                         rot, device=device)
