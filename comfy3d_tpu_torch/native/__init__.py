"""ctypes bindings of the native host-side mesh ops (`mesh_ops.cpp`).

The port's copy of `comfy3d_tpu/native/`: the same C++ source, bound for
the two functions the GS→mesh converter calls, `clean_mesh` and
`decimate_mesh`. The source also holds `inpaint_vertex_colors` and
`isotropic_remesh`, unbound until a path of the port calls them.

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
