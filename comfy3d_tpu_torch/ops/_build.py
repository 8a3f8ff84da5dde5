"""Build the port's CUDA sources (`csrc/*.cu`) with nvcc, load them with ctypes.

Each source is compiled on its own into a shared library with a plain C
interface, for `sm_90a` (Hopper); headers (`csrc/*.cuh`) are included by
the sources that need them. Libraries go to `comfy3d_tpu_torch/_build/`
(listed in `.gitignore`), named after a hash of the source, the headers and
the flags, so a changed source or header is rebuilt and an unchanged one is
reused. Nothing is compiled when the package is imported; a kernel's first
call builds it. Where `nvcc` is missing or the build fails, the call raises
with the compiler's message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# -fmad=false: no contraction of a*b+c into one FMA, so the kernels round
# every product and sum as the plain PyTorch versions do (the 1/255 alpha
# cut is a threshold; a one-ulp difference in the exponent flips it).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register / shared-memory report) per source
build_log: Dict[str, str] = {}


def sources() -> list:
    """Names of the kernel sources under csrc/ (without `.cu`)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found: comfy3d_tpu_torch builds its CUDA kernels at first "
        "use and needs the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> str:
    # the source and every header beside it: a changed header rebuilds too
    files = [name + ".cu"] + sorted(f for f in os.listdir(CSRC)
                                    if f.endswith(".cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    digest = h.hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def build(names: Iterable[str] | None = None) -> Dict[str, str]:
    """Compile every named source that has no library yet, all nvcc
    processes at once. Returns {name: library path}; raises RuntimeError
    with the compiler's output if any build fails."""
    names = list(sources() if names is None else names)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if not todo:
        return paths
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for n in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, n + ".cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    errors = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[n] = out.decode(errors="replace")
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on csrc/{n}.cu "
                          f"(exit {proc.returncode}):\n{build_log[n]}")
        else:
            os.replace(tmp, paths[n])      # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build([name])[name])
        _libs[name] = lib
    return lib
