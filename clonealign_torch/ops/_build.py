"""Build and load the hand-written CUDA kernels.

The sources under ``csrc/`` (the float32 kernels and the float64 family,
which share ``split_tiles.cuh``) are compiled with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, loaded with ctypes. Each
source is compiled as several translation units at once (``PARTS``, one
``nvcc`` each, all started together; see each source's "Build" note),
which are then linked. The build runs at first use, into ``_build_cache/``
beside this file, under a name keyed by a hash of the sources, the header
and the flags, so a changed source is rebuilt and an unchanged one is
reused. Nothing here runs when the module is imported.
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
SOURCES = (_HERE / "csrc" / "fused_likelihood.cu", _HERE / "csrc" / "fused_likelihood_f64.cu")
# ... and the header both include (the split kernels' tiles and copies)
HEADERS = (_HERE / "csrc" / "split_tiles.cuh",)
BUILD_DIR = _HERE / "_build_cache"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# FL_PART of each translation unit of each source: -1 the Y-free kernels
# and the C entry points, 0-3 the Y-reading kernels of one Y storage type
# each.
PARTS = (-1, 0, 1, 2, 3)

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
    for src in SOURCES + HEADERS:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + tuple(map(str, PARTS))).encode())
    return BUILD_DIR / f"libclonealign_kernels_{digest.hexdigest()[:16]}.so"


def compile_library(sources, so: str) -> str:
    """Compile ``sources`` into the shared library ``so``: one object per
    source and part (beside ``so``), compiled in parallel, then linked.
    Returns nvcc's output (ptxas's report); raises RuntimeError with it when
    the build fails."""
    nvcc = _nvcc()
    procs, objs = [], []
    for src in sources:
        for part in PARTS:
            obj = f"{so}.{Path(src).stem}_{part + 1}.o"
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, f"-DFL_PART={part}", "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    log = "".join(proc.communicate()[0] for proc in procs)
    if any(proc.returncode for proc in procs):
        raise RuntimeError(f"nvcc failed:\n{log}")
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", so, *objs], capture_output=True, text=True)
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link ({link.returncode}):\n{log}")
    return log


def build() -> Path:
    """Compile the kernels unless a library for these sources exists
    (:func:`compile_library`). Raises RuntimeError with nvcc's output when
    the build fails."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = os.path.join(tmp, out.name)
        try:
            build_log = compile_library(SOURCES, so)
        except RuntimeError as e:
            build_log = str(e)
            raise
        os.replace(so, out)  # atomic: a concurrent loader never sees a partial file
    return out


def load() -> ctypes.CDLL:
    """The built library with argument types declared (built on first call)."""
    global _lib
    if _lib is not None:
        return _lib
    _lib = declare(ctypes.CDLL(str(build())))
    return _lib


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument and result types on ``lib``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fl_forward.argtypes = [p] * 9 + [i] * 6 + [p]
    lib.fl_forward.restype = i
    lib.fl_backward_dpsi.argtypes = [p] * 7 + [i] * 4 + [p]
    lib.fl_backward_dpsi.restype = i
    lib.fl_backward_gene.argtypes = [p] * 9 + [i] * 7 + [p]
    lib.fl_backward_gene.restype = i
    lib.fl_backward_gene_scratch.argtypes = [i] * 6
    lib.fl_backward_gene_scratch.restype = ctypes.c_size_t
    lib.fl_forward_wide.argtypes = [p] * 11 + [i] * 6 + [p]
    lib.fl_forward_wide.restype = i
    lib.fl_wide_resources.argtypes = [p] + [i] * 6 + [p]
    lib.fl_wide_resources.restype = i
    lib.fl_backward_dpsi_wide.argtypes = [p] * 9 + [i] * 4 + [p]
    lib.fl_backward_dpsi_wide.restype = i
    lib.fl_backward_gene_wide.argtypes = [p] * 11 + [i] * 6 + [p]
    lib.fl_backward_gene_wide.restype = i
    lib.fl64_forward.argtypes = [p] * 11 + [i] * 6 + [p]
    lib.fl64_forward.restype = i
    lib.fl64_backward_dpsi.argtypes = [p] * 9 + [i] * 4 + [p]
    lib.fl64_backward_dpsi.restype = i
    lib.fl64_backward_gene.argtypes = [p] * 11 + [i] * 6 + [p]
    lib.fl64_backward_gene.restype = i
    lib.fl64_resources.argtypes = [p] + [i] * 6 + [p]
    lib.fl64_resources.restype = i
    return lib
