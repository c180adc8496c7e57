"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` into a shared
library with a plain C interface, keyed by a hash of the sources, and
loaded with ``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<hash>/libfused.so \
         src/repro_torch/kernels/csrc/fused.cu

The library lands under ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``).  Nothing is compiled when this module is
imported: ``library()`` builds on its first call, and a failed build
raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "fused.cu",)
ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: extern "C" launchers of csrc/fused.cu and their argument types
SIGNATURES = {
    "add_rmsnorm_fwd": (_vp, _vp, _vp, _vp, _vp, _int, _int, _float, _int, _vp),
    "add_rmsnorm_bwd": (_vp, _vp, _vp, _vp, _vp, _vp, _int, _int, _int,
                        _float, _int, _vp),
    "gemm_bias": (_vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _int,
                  _int, _int, _vp),
}


@functools.lru_cache(maxsize=None)
def source_hash() -> str:
    """Hash of every kernel source and the compiler flags: the build key,
    and part of ``ops.backend_signature()``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class BuildInfo:
    path: pathlib.Path
    seconds: float          # 0.0 when the library was already built
    log: str                # nvcc's output (-Xptxas -v: registers, spills)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are compiled on the machine with the card")


def build() -> BuildInfo:
    """Compile the sources into ``build/kernels/<hash>/libfused.so``
    unless that file exists.  The library is written to a temporary name
    and renamed into place, so a concurrent or interrupted build never
    leaves a half-written library behind."""
    out_dir = BUILD_DIR / source_hash()
    lib = out_dir / "libfused.so"
    log_file = out_dir / "nvcc.log"
    if lib.exists():
        log = log_file.read_text() if log_file.exists() else ""
        return BuildInfo(lib, 0.0, log)
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, lib)
    log_file.write_text(log)
    return BuildInfo(lib, seconds, log)


_LIB: Optional[ctypes.CDLL] = None
_INFO: Optional[BuildInfo] = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _LIB, _INFO
    if _LIB is None:
        info = build()
        lib = ctypes.CDLL(str(info.path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIB, _INFO = lib, info
    return _LIB


def build_info() -> BuildInfo:
    """How the loaded library was obtained (after ``library()``)."""
    library()
    return _INFO


def ptxas_summary(log: str) -> str:
    """The register / shared-memory / spill lines of ``-Xptxas -v``."""
    keep = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    return "\n".join(keep)
