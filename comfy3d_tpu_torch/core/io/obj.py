"""Wavefront OBJ reader/writer with face-varying UVs and MTL textures.

Port of `comfy3d_tpu/core/io/obj.py` (the port's own copy; the files it
writes are byte-identical to the JAX package's). Face-varying UV indices
(v/vt/vn triplets) survive round trips. Host-side numpy only; `cv2` is
imported only for textures.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def load_obj(path: str):
    """Returns dict(v, f, vt, ft, vn, fn, vc, albedo). Missing → None."""
    v, vt, vn, vc = [], [], [], []
    f, ft, fn = [], [], []
    mtl_path: Optional[str] = None

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                v.append([float(x) for x in parts[1:4]])
                if len(parts) >= 7:          # vertex-color extension
                    vc.append([float(x) for x in parts[4:7]])
            elif tag == "vt":
                vt.append([float(parts[1]), float(parts[2])])
            elif tag == "vn":
                vn.append([float(x) for x in parts[1:4]])
            elif tag == "f":
                idx = [_parse_face_token(t) for t in parts[1:]]
                # fan-triangulate polygons
                for k in range(1, len(idx) - 1):
                    tri = (idx[0], idx[k], idx[k + 1])
                    f.append([t[0] for t in tri])
                    if all(t[1] is not None for t in tri):
                        ft.append([t[1] for t in tri])
                    if all(t[2] is not None for t in tri):
                        fn.append([t[2] for t in tri])
            elif tag == "mtllib":
                mtl_path = os.path.join(os.path.dirname(path),
                                        " ".join(parts[1:]))

    def _idx(arr, n):
        a = np.asarray(arr, np.int64)
        return np.where(a < 0, a + n, a - 1).astype(np.int32)

    nv, nt, nn = len(v), len(vt), len(vn)
    out = {
        "v": np.asarray(v, np.float32),
        "f": _idx(f, nv) if f else np.zeros((0, 3), np.int32),
        "vt": np.asarray(vt, np.float32) if vt else None,
        "ft": _idx(ft, nt) if ft else None,
        "vn": np.asarray(vn, np.float32) if vn else None,
        "fn": _idx(fn, nn) if fn else None,
        "vc": np.asarray(vc, np.float32) if vc else None,
        "albedo": None,
    }
    if mtl_path and os.path.exists(mtl_path):
        out["albedo"] = _load_mtl_albedo(mtl_path)
    return out


def _parse_face_token(tok: str):
    """'v', 'v/vt', 'v//vn', 'v/vt/vn' → (vi, ti|None, ni|None)."""
    bits = tok.split("/")
    vi = int(bits[0])
    ti = int(bits[1]) if len(bits) > 1 and bits[1] else None
    ni = int(bits[2]) if len(bits) > 2 and bits[2] else None
    return vi, ti, ni


def _load_mtl_albedo(mtl_path: str) -> Optional[np.ndarray]:
    tex = None
    with open(mtl_path, "r", errors="replace") as fh:
        for line in fh:
            parts = line.split()
            if parts and parts[0] == "map_Kd":
                tex = os.path.join(os.path.dirname(mtl_path),
                                   " ".join(parts[1:]))
                break
    if tex and os.path.exists(tex):
        return _read_image(tex)
    return None


def _read_image(path: str) -> np.ndarray:
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise IOError(f"cannot read image {path}")
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB if img.shape[2] == 3
                           else cv2.COLOR_BGRA2RGBA)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    elif img.dtype == np.uint16:
        img = img.astype(np.float32) / 65535.0
    # OBJ/glTF UV origin is bottom-left; images load top-left. Flip so that
    # texture lookups with v-up UVs are correct.
    return np.ascontiguousarray(img[::-1, :, :3].astype(np.float32))


def save_obj(path: str, v, f, vt=None, ft=None, vn=None, fn=None,
             vc=None, albedo=None) -> None:
    base = os.path.splitext(path)[0]
    name = os.path.basename(base)
    write_mtl = albedo is not None
    with open(path, "w") as fh:
        if write_mtl:
            fh.write(f"mtllib {name}.mtl\n")
        for i, p in enumerate(np.asarray(v, np.float32)):
            if vc is not None:
                c = np.asarray(vc, np.float32)[i]
                fh.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                         f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")
            else:
                fh.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        if vt is not None:
            for t in np.asarray(vt, np.float32):
                fh.write(f"vt {t[0]:.6f} {t[1]:.6f}\n")
        if vn is not None:
            for nvec in np.asarray(vn, np.float32):
                fh.write(f"vn {nvec[0]:.6f} {nvec[1]:.6f} {nvec[2]:.6f}\n")
        if write_mtl:
            fh.write("usemtl defaultMat\n")
        f = np.asarray(f, np.int64) + 1
        ft_ = None if ft is None else np.asarray(ft, np.int64) + 1
        fn_ = None if fn is None else np.asarray(fn, np.int64) + 1
        for i in range(f.shape[0]):
            toks = []
            for k in range(3):
                s = str(f[i, k])
                if ft_ is not None and fn_ is not None:
                    s = f"{f[i, k]}/{ft_[i, k]}/{fn_[i, k]}"
                elif ft_ is not None:
                    s = f"{f[i, k]}/{ft_[i, k]}"
                elif fn_ is not None:
                    s = f"{f[i, k]}//{fn_[i, k]}"
                toks.append(s)
            fh.write("f " + " ".join(toks) + "\n")
    if write_mtl:
        import cv2
        tex_path = base + "_albedo.png"
        img = np.clip(np.asarray(albedo) * 255.0, 0, 255).astype(np.uint8)
        cv2.imwrite(tex_path, cv2.cvtColor(img[::-1], cv2.COLOR_RGB2BGR))
        with open(base + ".mtl", "w") as fh:
            fh.write("newmtl defaultMat\nKa 1 1 1\nKd 1 1 1\nKs 0 0 0\n"
                     f"Tr 1\nillum 1\nNs 0\nmap_Kd {name}_albedo.png\n")
