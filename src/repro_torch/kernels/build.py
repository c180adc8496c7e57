"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use into one shared library with a
plain C interface, keyed by a hash of the sources, and loaded with
``ctypes``.  Each source gets its own ``nvcc`` process, all started
together, and one more ``nvcc`` links the objects::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu  # each
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/kernels/<hash>/libkernels.so *.o

The library lands under ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``).  Nothing is compiled when this module is
imported: ``library()`` builds on its first call, and a failed build
raises with the compiler's output.

``launch(name, ...)`` calls one ``extern "C"`` launcher, raises if it
returns a CUDA error, and counts the launch in ``LAUNCHES``: one per
launch and nowhere else, so a run can show it went through the kernels.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
#: every source of csrc/, each compiled by its own nvcc (the flash kernels
#: are split over flash.cu and one flash_<kernel>_<dtype>.cu per
#: launcher, so that their instances compile side by side)
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# flash launchers: B, Sq, Sk, H, KV, D, window, scale, then (batch, seq,
# head) strides of q, k and v (and dO); the tile, the dtype code and the
# stream
_FLASH_SHAPE = (_int,) * 7 + (_float,) + (_int,) * 9
#: extern "C" launchers of csrc/*.cu and their argument types
SIGNATURES = {
    "add_rmsnorm_fwd": (_vp, _vp, _vp, _vp, _vp, _int, _int, _float, _int, _vp),
    # add_rmsnorm_bwd: res, w, gres, gh, dres, dw, the fp32 partial rows,
    # M, d, then fused.norm_bwd_config's rows per block, rows per round,
    # warps per row, chunks and copies, eps, the dtype and the stream
    "add_rmsnorm_bwd": (_vp,) * 7 + (_int,) * 7 + (_float, _int, _vp),
    # gemm_bias: A, B, bias, C, the split's fp32 workspace, M, N, K, the
    # strides of A and B, then fused.gemm_config's tile, split and copies
    "gemm_bias": (_vp,) * 5 + (_int,) * 7 + (_int,) * 7 + (_int, _vp),
    # gemm_bias_wgmma: A, B, bias, C, the split's workspace, M, N, K,
    # splits, kchunk, the layouts, the two tensor-map specs (kernels/
    # tma.py) and the stream
    "gemm_bias_wgmma": (_vp,) * 5 + (_int,) * 7 + (_vp, _vp, _vp),
    "flash_fwd": (_vp,) * 5 + _FLASH_SHAPE + (_int, _int, _vp),
    # flash_fwd_wgmma: q, k, v, o, lse, B, Sq, Sk, H, KV, D, window,
    # scale, the three tensor-map specs, the tile and the stream
    "flash_fwd_wgmma": (_vp,) * 5 + (_int,) * 7 + (_float, _vp, _int, _vp),
    "flash_bwd_dq": (_vp,) * 7 + _FLASH_SHAPE + (_int,) * 3 + (_int, _int,
                                                               _vp),
    # flash_bwd_dq_wgmma: q, k, v, dO, lse, delta, dq, B, Sq, Sk, H, KV,
    # D, window, scale, the four tensor-map specs, the tile and the
    # stream; flash_bwd_dkdv_wgmma the same with dk and dv
    "flash_bwd_dq_wgmma": (_vp,) * 7 + (_int,) * 7 + (_float, _vp, _int,
                                                       _vp),
    "flash_bwd_dkdv_wgmma": (_vp,) * 8 + (_int,) * 7 + (_float, _vp, _int,
                                                         _vp),
    "flash_bwd_dkdv": (_vp,) * 8 + _FLASH_SHAPE + (_int,) * 3 + (_int, _int,
                                                                 _vp),
    # ssd launchers: pointers (the backward's last its fp32 scratch), then
    # b, S, H, P, N, the chunk, the (batch, seq, head) strides of x, dt,
    # B, C (and gy), the dtype code and the stream
    "ssd_fwd": (_vp,) * 8 + (_int,) * 6 + (_int,) * 12 + (_int, _vp),
    "ssd_bwd": (_vp,) * 14 + (_int,) * 6 + (_int,) * 15 + (_int, _vp),
    # ssd_fwd_wgmma: x, dt, A, B, C, y, state, cstates, b, S, H, N, dt's
    # strides, bc_head, the tensor-map specs (kernels/tma.py::ssd_maps),
    # the dtype code and the stream; ssd_bwd_wgmma the backward's
    # pointers in ssd_bwd's order, then the same
    "ssd_fwd_wgmma": (_vp,) * 8 + (_int,) * 8 + (_vp, _int, _vp),
    "ssd_bwd_wgmma": (_vp,) * 14 + (_int,) * 8 + (_vp, _int, _vp),
}

#: launches per kernel since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = dict.fromkeys(SIGNATURES, 0)

#: called with ``"library"`` after every compile of the kernel library
#: and with ``"program"`` after every ProgramCache build
#: (``runtime/executor.py``): the port's counterpart of the reference's
#: compile events, read by ``track_compiles`` and ``CompileCounter``
BUILD_LISTENERS: List[Callable[[str], None]] = []


def notify_build(kind: str) -> None:
    for listener in list(BUILD_LISTENERS):
        listener(kind)


def build_inputs() -> Tuple[pathlib.Path, ...]:
    """``SOURCES`` and the ``csrc/`` headers they ``#include "..."``,
    directly or through another header."""
    seen, todo = [], list(SOURCES)
    while todo:
        f = todo.pop(0)
        if f not in seen:
            seen.append(f)
            todo += [CSRC / n for n in
                     re.findall(r'^#include\s+"([^"]+)"', f.read_text(), re.M)]
    return tuple(seen)


@functools.lru_cache(maxsize=None)
def source_hash() -> str:
    """Hash of ``build_inputs()`` and the compiler flags: the build key,
    and part of ``ops.backend_signature()``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(build_inputs()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class BuildInfo:
    path: pathlib.Path
    seconds: float          # 0.0 when the library was already built
    log: str                # nvcc's output (-Xptxas -v: registers, spills)
    #: source name -> seconds until its nvcc ended (empty when prebuilt)
    compile_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are compiled on the machine with the card")


def commands(tmp: str) -> Tuple[List[List[str]], List[str]]:
    """(one ``nvcc -c`` per source, the link) writing into ``tmp``."""
    nvcc = _nvcc()
    objs = [os.path.join(tmp, src.stem + ".o") for src in SOURCES]
    compile_cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                    for src, obj in zip(SOURCES, objs)]
    return compile_cmds, [nvcc, *ARCH_FLAGS, "-shared", "-o",
                          os.path.join(tmp, "libkernels.so"), *objs]


def run_all(cmds, seconds: Optional[List[float]] = None) -> str:
    """Run the commands concurrently; their combined output.  Raises
    with that output if any of them fails.  ``seconds``, where given,
    receives each command's wall time from the common start."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs, done = [""] * len(procs), [0.0] * len(procs)

    def drain(i):            # one thread a pipe, so none fills and blocks
        outs[i] = procs[i].communicate()[0]
        done[i] = time.perf_counter() - t0
    threads = [threading.Thread(target=drain, args=(i,))
               for i in range(len(procs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if seconds is not None:
        seconds[:] = done
    failed = [c for c, p in zip(cmds, procs) if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            " ".join(c) for c in failed) + "\n" + "".join(outs))
    return "".join(outs)


def build() -> BuildInfo:
    """Compile the sources into ``build/kernels/<hash>/libkernels.so``
    unless that file exists: one ``nvcc`` per source, all at once, then
    one link.  Objects and the library are written in a temporary
    directory and the library renamed into place, so a concurrent or
    interrupted build never leaves a half-written library behind."""
    out_dir = BUILD_DIR / source_hash()
    lib = out_dir / "libkernels.so"
    log_file = out_dir / "nvcc.log"
    if lib.exists():
        log = log_file.read_text() if log_file.exists() else ""
        return BuildInfo(lib, 0.0, log)
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        compile_cmds, link_cmd = commands(tmp)
        per_source: List[float] = []
        log = run_all(compile_cmds, per_source) + run_all([link_cmd])
        os.replace(os.path.join(tmp, lib.name), lib)
    log_file.write_text(log)
    notify_build("library")
    return BuildInfo(lib, time.perf_counter() - t0, log,
                     {src.name: sec for src, sec in zip(SOURCES, per_source)})


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


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_tensors(name: str, *tensors: torch.Tensor) -> int:
    """Raise unless the tensors are CUDA tensors of one supported dtype on
    one device; return the kernels' dtype code (0 fp32, 1 bf16)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors required, got {dev}")
    dtype = tensors[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: mixed devices or dtypes "
                             f"({t.device}, {t.dtype} vs {dev}, {dtype})")
    return _DTYPES[dtype]


def current_stream(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device, taken
    raw: going through a ``torch.cuda.Stream`` object adds microseconds
    of host time to every launch (``tools/host_cost.py``)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch(name: str, *args) -> None:
    """Call the launcher ``name``; raise on a refused or failed launch."""
    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


def ptxas_summary(log: str) -> str:
    """The register / shared-memory / spill lines of ``-Xptxas -v``."""
    keep = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    return "\n".join(keep)
