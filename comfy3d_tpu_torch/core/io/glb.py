"""Minimal glTF-2.0 binary (.glb) reader/writer.

Port of `comfy3d_tpu/core/io/glb.py` (the port's own copy; the files it
writes are byte-identical to the JAX package's, generator string included).
Pure numpy + struct/json on the host; textures are PNG-encoded with `cv2`,
imported only when there is a texture.

glTF stores per-vertex attributes only (no face-varying UV indices) and uses
a top-left UV origin, so export welds (position,uv) pairs and flips V at the
boundary; the package's internal convention is bottom-left (OBJ-style).
"""

from __future__ import annotations

import json
import struct
from typing import Optional

import numpy as np

_MAGIC = 0x46546C67  # 'glTF'
_JSON_T = 0x4E4F534A
_BIN_T = 0x004E4942

_CTYPE = {5120: "i1", 5121: "u1", 5122: "i2", 5123: "u2", 5125: "u4",
          5126: "f4"}
_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _align(b: bytes, n: int, pad: bytes) -> bytes:
    r = len(b) % n
    return b if r == 0 else b + pad * (n - r)


def save_glb(path: str, v, f, vt=None, ft=None, vn=None,
             albedo: Optional[np.ndarray] = None,
             metallic_roughness: Optional[np.ndarray] = None) -> None:
    v = np.asarray(v, np.float32)
    f = np.asarray(f, np.int64)
    if vt is not None and ft is not None:
        v, f, vt, vn = _align_v_to_vt(v, f, np.asarray(vt, np.float32),
                                      np.asarray(ft, np.int64), vn)
    indices = f.astype(np.uint32).reshape(-1)

    bin_parts = []
    buffer_views = []
    accessors = []

    def add_view(data: np.ndarray, target: int | None):
        raw = _align(data.tobytes(), 4, b"\x00")
        offset = sum(len(p) for p in bin_parts)
        bin_parts.append(raw)
        view = {"buffer": 0, "byteOffset": offset, "byteLength": len(raw)}
        if target:
            view["target"] = target
        buffer_views.append(view)
        return len(buffer_views) - 1

    def add_accessor(data: np.ndarray, ctype: int, atype: str,
                     target: int | None, minmax=False):
        vidx = add_view(data, target)
        acc = {"bufferView": vidx, "componentType": ctype,
               "count": int(data.shape[0]), "type": atype}
        if minmax:
            if data.shape[0]:
                acc["min"] = data.min(axis=0).tolist()
                acc["max"] = data.max(axis=0).tolist()
            else:   # empty mesh: still a valid accessor per spec
                dim = {"VEC3": 3, "VEC2": 2, "SCALAR": 1}[atype]
                acc["min"] = [0.0] * dim
                acc["max"] = [0.0] * dim
        accessors.append(acc)
        return len(accessors) - 1

    idx_acc = add_accessor(indices, 5125, "SCALAR", 34963)
    attrs = {"POSITION": add_accessor(v, 5126, "VEC3", 34962, minmax=True)}
    if vn is not None:
        n = np.array(vn, np.float32)      # a copy: the caller's stay as is
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        attrs["NORMAL"] = add_accessor(n, 5126, "VEC3", 34962)
    if vt is not None:
        uv = np.stack([vt[:, 0], 1.0 - vt[:, 1]], -1).astype(np.float32)
        attrs["TEXCOORD_0"] = add_accessor(uv, 5126, "VEC2", 34962)

    gltf = {
        # the JAX package's generator string: the two write the same bytes
        "asset": {"version": "2.0", "generator": "comfy3d_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": attrs,
                                    "indices": idx_acc, "mode": 4}]}],
        "bufferViews": buffer_views,
        "accessors": accessors,
    }

    images, textures, samplers = [], [], []

    def add_texture(img: np.ndarray) -> int:
        import cv2
        arr = np.clip(np.asarray(img)[::-1] * 255.0, 0, 255).astype(np.uint8)
        ok, png = cv2.imencode(".png", cv2.cvtColor(arr, cv2.COLOR_RGB2BGR))
        assert ok
        vidx = add_view(np.frombuffer(png.tobytes(), np.uint8), None)
        images.append({"bufferView": vidx, "mimeType": "image/png"})
        if not samplers:
            samplers.append({"magFilter": 9729, "minFilter": 9987,
                             "wrapS": 10497, "wrapT": 10497})
        textures.append({"sampler": 0, "source": len(images) - 1})
        return len(textures) - 1

    if albedo is not None and vt is not None:
        pbr = {"baseColorTexture": {"index": add_texture(albedo)},
               "metallicFactor": 0.0 if metallic_roughness is None else 1.0,
               "roughnessFactor": 1.0}
        if metallic_roughness is not None:
            pbr["metallicRoughnessTexture"] = {
                "index": add_texture(metallic_roughness)}
        gltf["materials"] = [{"pbrMetallicRoughness": pbr,
                              "name": "defaultMat"}]
        gltf["meshes"][0]["primitives"][0]["material"] = 0
    if images:
        gltf["images"] = images
        gltf["textures"] = textures
        gltf["samplers"] = samplers

    bin_blob = b"".join(bin_parts)
    gltf["buffers"] = [{"byteLength": len(bin_blob)}]

    json_blob = _align(json.dumps(gltf, separators=(",", ":")).encode(),
                       4, b" ")
    bin_blob = _align(bin_blob, 4, b"\x00")
    total = 12 + 8 + len(json_blob) + 8 + len(bin_blob)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<III", _MAGIC, 2, total))
        fh.write(struct.pack("<II", len(json_blob), _JSON_T))
        fh.write(json_blob)
        fh.write(struct.pack("<II", len(bin_blob), _BIN_T))
        fh.write(bin_blob)


def load_glb(path: str):
    """Returns dict(v, f, vt, ft, vn, albedo, metallic_roughness), from the
    mesh primitive with the most vertices."""
    with open(path, "rb") as fh:
        raw = fh.read()
    magic, version, _ = struct.unpack_from("<III", raw, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not a GLB file")
    offset = 12
    gltf = None
    bin_blob = b""
    while offset < len(raw):
        clen, ctype = struct.unpack_from("<II", raw, offset)
        offset += 8
        chunk = raw[offset:offset + clen]
        offset += clen
        if ctype == _JSON_T:
            gltf = json.loads(chunk.decode())
        elif ctype == _BIN_T:
            bin_blob = chunk

    def read_accessor(idx: int) -> np.ndarray:
        acc = gltf["accessors"][idx]
        view = gltf["bufferViews"][acc["bufferView"]]
        dt = np.dtype("<" + _CTYPE[acc["componentType"]])
        ncomp = _NCOMP[acc["type"]]
        start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = view.get("byteStride") or dt.itemsize * ncomp
        count = acc["count"]
        if stride == dt.itemsize * ncomp:
            arr = np.frombuffer(bin_blob, dt, count * ncomp, start)
        else:  # interleaved
            rows = np.frombuffer(bin_blob, np.uint8, stride * count, start)
            rows = rows.reshape(count, stride)[:, :dt.itemsize * ncomp]
            arr = rows.copy().view(dt)
        return arr.reshape(count, ncomp) if ncomp > 1 else arr.reshape(count)

    # pick the primitive with the most vertices across all meshes
    best, best_count = None, -1
    for mesh in gltf.get("meshes", []):
        for prim in mesh["primitives"]:
            cnt = gltf["accessors"][prim["attributes"]["POSITION"]]["count"]
            if cnt > best_count:
                best, best_count = prim, cnt
    if best is None:
        raise ValueError(f"{path}: no mesh primitives")

    v = read_accessor(best["attributes"]["POSITION"]).astype(np.float32)
    f = read_accessor(best["indices"]).astype(np.int32).reshape(-1, 3) \
        if "indices" in best else \
        np.arange(len(v), dtype=np.int32).reshape(-1, 3)
    vn = (read_accessor(best["attributes"]["NORMAL"]).astype(np.float32)
          if "NORMAL" in best["attributes"] else None)
    vt = None
    if "TEXCOORD_0" in best["attributes"]:
        uv = read_accessor(best["attributes"]["TEXCOORD_0"]).astype(np.float32)
        vt = np.stack([uv[:, 0], 1.0 - uv[:, 1]], -1)

    def read_texture(tex_info):
        if tex_info is None or "images" not in gltf:
            return None
        img_idx = gltf["textures"][tex_info["index"]]["source"]
        img = gltf["images"][img_idx]
        if "bufferView" not in img:
            return None
        view = gltf["bufferViews"][img["bufferView"]]
        start = view.get("byteOffset", 0)
        png = np.frombuffer(bin_blob, np.uint8, view["byteLength"],
                            start)
        import cv2
        dec = cv2.imdecode(png, cv2.IMREAD_COLOR)
        if dec is None:
            return None
        return np.ascontiguousarray(
            cv2.cvtColor(dec, cv2.COLOR_BGR2RGB)[::-1]
        ).astype(np.float32) / 255.0

    albedo = metallic_roughness = None
    if "material" in best:
        pbr = gltf["materials"][best["material"]].get(
            "pbrMetallicRoughness", {})
        albedo = read_texture(pbr.get("baseColorTexture"))
        metallic_roughness = read_texture(
            pbr.get("metallicRoughnessTexture"))
    return {"v": v, "f": f, "vt": vt, "ft": f.copy() if vt is not None
            else None, "vn": vn, "albedo": albedo,
            "metallic_roughness": metallic_roughness}


def _align_v_to_vt(v, f, vt, ft, vn=None):
    """Duplicate vertices so (position, uv) pairs are unique — glTF needs
    per-vertex UVs."""
    key = f.astype(np.int64) * (vt.shape[0] + 1) + ft.astype(np.int64)
    uniq, inv = np.unique(key.reshape(-1), return_inverse=True)
    new_f = inv.reshape(-1, 3).astype(np.int64)
    src_v = (uniq // (vt.shape[0] + 1)).astype(np.int64)
    src_t = (uniq % (vt.shape[0] + 1)).astype(np.int64)
    new_v = v[src_v]
    new_vt = vt[src_t]
    new_vn = vn[src_v] if vn is not None and len(vn) == len(v) else None
    return new_v, new_f, new_vt, new_vn
