"""Build and load the hand-written CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ctypes. The build runs
at first use, into ``_build_cache/`` beside this file, under a name keyed by
a hash of the sources and flags, so a changed source is rebuilt and an
unchanged one is reused. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "fused_likelihood.cu",)
BUILD_DIR = _HERE / "_build_cache"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
build_log = ""  # nvcc's output (ptxas register and spill report) of the last build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels "
            "of clonealign_torch cannot be built"
        )
    return path


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libclonealign_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.
    Raises RuntimeError with nvcc's output when the build fails."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out


def load() -> ctypes.CDLL:
    """The built library with argument types declared (built on first call)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fl_forward.argtypes = [p] * 9 + [i] * 5 + [p]
    lib.fl_forward.restype = i
    lib.fl_backward_dpsi.argtypes = [p] * 7 + [i] * 4 + [p]
    lib.fl_backward_dpsi.restype = i
    lib.fl_backward_gene.argtypes = [p] * 9 + [i] * 6 + [p]
    lib.fl_backward_gene.restype = i
    lib.fl_backward_gene_scratch.argtypes = [i] * 6
    lib.fl_backward_gene_scratch.restype = ctypes.c_size_t
    _lib = lib
    return lib
