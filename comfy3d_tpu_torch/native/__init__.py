"""ctypes bindings of the native host-side mesh ops (`mesh_ops.cpp`).

The port's copy of `comfy3d_tpu/native/`: the same C++ source, bound for
the functions the port's paths call: `clean_mesh` and `decimate_mesh` (the
GS→mesh converter, the Hunyuan3D nodes' cleanup and remesh) and
`inpaint_vertex_colors` (the Hunyuan3D paint bake,
`algorithms/color_project.py`) and `isotropic_remesh` (the Decimate_Mesh
node's remesh).

The library is built with g++ at first use into `comfy3d_tpu_torch/_build/`
(listed in `.gitignore`), named after a hash of the source and the flags,
as `ops/_build.py` does for the CUDA sources; nothing is compiled when the
package is imported. A failed build or load raises with the compiler's or
the loader's message: there is no fallback. The functions are host code
over numpy arrays, whatever device the caller's path runs on.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "mesh_ops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None


def _f32p():
    return ctypes.POINTER(ctypes.c_float)


def _i32p():
    return ctypes.POINTER(ctypes.c_int32)


def library_path() -> str:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libmesh_ops-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile `mesh_ops.cpp` unless its library exists; returns its path.
    Raises RuntimeError with g++'s output if the build fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"g++ could not run: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed on {SOURCE} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)              # atomic: concurrent builds agree
    return path


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed (raises on failure)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.clean_mesh.restype = None
        lib.clean_mesh.argtypes = [
            _f32p(), ctypes.c_int, _i32p(), ctypes.c_int,
            ctypes.c_float, ctypes.c_float,
            _f32p(), _i32p(), _i32p(), _i32p()]
        lib.decimate_mesh.restype = None
        lib.decimate_mesh.argtypes = [
            _f32p(), ctypes.c_int, _i32p(), ctypes.c_int, ctypes.c_int,
            _f32p(), _i32p(), _i32p(), _i32p()]
        lib.isotropic_remesh.restype = ctypes.c_int
        lib.isotropic_remesh.argtypes = [
            _f32p(), ctypes.c_int, _i32p(), ctypes.c_int,
            ctypes.c_float, ctypes.c_int,
            _f32p(), _i32p(), _i32p(), _i32p(), ctypes.c_int, ctypes.c_int]
        lib.inpaint_vertex_colors.restype = ctypes.c_int
        lib.inpaint_vertex_colors.argtypes = [
            _f32p(), ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.c_int, _i32p(), ctypes.c_int, ctypes.c_int]
        _lib = lib
    return _lib


def _mesh_arrays(verts, faces):
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    if verts.ndim != 2 or verts.shape[1] != 3:
        raise ValueError(f"verts of shape {verts.shape}, expected [N, 3]")
    if faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"faces of shape {faces.shape}, expected [M, 3]")
    if faces.size and (faces.min() < 0 or faces.max() >= len(verts)):
        raise ValueError("faces index past the vertices")
    return verts, faces


def _ptr(a, kind):
    return a.ctypes.data_as(kind())


def clean_mesh(verts: np.ndarray, faces: np.ndarray,
               weld_eps: float = 1e-6, min_component_frac: float = 0.0):
    """Weld duplicates, drop degenerate / duplicate faces and the
    components smaller than `min_component_frac` of the largest. Returns
    (verts [N', 3] float32, faces [M', 3] int32)."""
    verts, faces = _mesh_arrays(verts, faces)
    lib = load()
    ov = np.empty_like(verts)
    of = np.empty_like(faces)
    nv, nf = ctypes.c_int32(0), ctypes.c_int32(0)
    lib.clean_mesh(_ptr(verts, _f32p), len(verts), _ptr(faces, _i32p),
                   len(faces), weld_eps, min_component_frac,
                   _ptr(ov, _f32p), _ptr(of, _i32p), ctypes.byref(nv),
                   ctypes.byref(nf))
    return ov[:nv.value].copy(), of[:nf.value].copy()


def decimate_mesh(verts: np.ndarray, faces: np.ndarray, target_faces: int):
    """Quadric-error edge-collapse decimation to ≈ `target_faces`; a mesh
    at or under the target comes back as a copy. Returns (verts, faces)."""
    verts, faces = _mesh_arrays(verts, faces)
    if len(faces) <= target_faces:
        return verts.copy(), faces.copy()
    lib = load()
    ov = np.empty_like(verts)
    of = np.empty_like(faces)
    nv, nf = ctypes.c_int32(0), ctypes.c_int32(0)
    lib.decimate_mesh(_ptr(verts, _f32p), len(verts), _ptr(faces, _i32p),
                      len(faces), int(target_faces), _ptr(ov, _f32p),
                      _ptr(of, _i32p), ctypes.byref(nv), ctypes.byref(nf))
    return ov[:nv.value].copy(), of[:nf.value].copy()


def isotropic_remesh(verts: np.ndarray, faces: np.ndarray,
                     target_len: float | None = None,
                     target_frac: float = 0.01, iterations: int = 3):
    """Botsch–Kobbelt isotropic explicit remeshing (pymeshlab's
    `meshing_isotropic_explicit_remeshing` role, reference
    `mesh_processer/mesh_utils.py:272`). `target_len` is the target edge
    length, by default `target_frac` of the bounding box's diagonal. The
    output capacity is an equilateral tiling of the surface at that length
    with headroom; a result that hits it is truncated, with a notice, as in
    the JAX package. Returns (verts, faces)."""
    verts, faces = _mesh_arrays(verts, faces)
    if len(faces) == 0 or len(verts) == 0:
        return verts.copy(), faces.copy()
    if target_len is None:
        diag = float(np.linalg.norm(verts.max(0) - verts.min(0)))
        target_len = max(target_frac * diag, 1e-8)
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    area = float(0.5 * np.linalg.norm(np.cross(e1, e2), axis=1).sum())
    tri_area = (3 ** 0.5 / 4) * target_len ** 2
    est_f = int(area / max(tri_area, 1e-12) * 2.0) + len(faces) * 4 + 64
    max_f = int(min(max(est_f, 1024), 8_000_000))
    max_v = max_f
    ov = np.empty((max_v, 3), np.float32)
    of = np.empty((max_f, 3), np.int32)
    nv, nf = ctypes.c_int32(0), ctypes.c_int32(0)
    rc = load().isotropic_remesh(
        _ptr(verts, _f32p), len(verts), _ptr(faces, _i32p), len(faces),
        float(target_len), int(iterations), _ptr(ov, _f32p),
        _ptr(of, _i32p), ctypes.byref(nv), ctypes.byref(nf), max_v, max_f)
    if rc:
        print("[native] isotropic_remesh: capacity hit, result truncated "
              "(raise target_len)")
    return ov[:nv.value].copy(), of[:nf.value].copy()


def inpaint_vertex_colors(colors: np.ndarray, mask: np.ndarray,
                          faces: np.ndarray, max_rounds: int = 256):
    """Diffuse painted vertex colours into the unpainted vertices over the
    mesh's edges: each round, every unpainted vertex with a painted
    neighbour takes their mean (the Hunyuan mesh-inpaint processor's
    role). colors [N, C] float32, mask [N] (nonzero = painted), faces [M, 3].
    Returns (colours [N, C], the filled mask [N] bool), both new arrays."""
    colors = np.array(colors, np.float32, order="C", copy=True)
    m = np.array(np.asarray(mask) != 0, np.uint8, order="C")
    faces = np.ascontiguousarray(faces, np.int32)
    if colors.ndim != 2 or m.shape != (colors.shape[0],):
        raise ValueError(f"colors {colors.shape} and mask {m.shape}, "
                         "expected [N, C] and [N]")
    if faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"faces of shape {faces.shape}, expected [M, 3]")
    load().inpaint_vertex_colors(
        _ptr(colors, _f32p), m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        colors.shape[0], colors.shape[1], _ptr(faces, _i32p), len(faces),
        int(max_rounds))
    return colors, m.astype(bool)
