"""The port's counterpart of the JAX package's ``kernels/gridcheck.py``
single-writer rule: no CUDA kernel of ``src/repro_torch/kernels/csrc``
accumulates into memory with atomics.

The reference audits its Pallas BlockSpecs so that no two grid steps
write one output block; the port's kernels keep the same contract by
construction (every output element has one writer, every sum runs in a
fixed order, so two runs are bitwise equal), and the templated tiles and
chunks must keep it.  This test reads every ``csrc/*.cu*`` source, drops
its comments, and fails on an atomic read-modify-write: a CUDA
``atomic*`` call or a PTX ``atom.`` / ``red.`` instruction in inline
assembly.
"""
import pathlib
import re

import pytest

CSRC = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")
SOURCES = sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))

_COMMENTS = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_ATOMIC_CALL = re.compile(r"\batomic[A-Z]\w*\s*\(")
_PTX_ATOMIC = re.compile(r"\b(?:atom|red)(?:\.\w+)*\.(?:add|min|max|exch|cas)"
                         r"(?:\.\w+)*")


def atomics(source: str):
    """The atomic operations in a CUDA source's code (comments dropped)."""
    code = _COMMENTS.sub("", source)
    return _ATOMIC_CALL.findall(code) + _PTX_ATOMIC.findall(code)


def test_every_source_is_read():
    names = {p.name for p in SOURCES}
    assert {"flash.cuh", "flash.cu", "fused.cu", "ssd.cu",
            "tensor_core.cuh", "hopper.cuh", "gemm_wgmma.cu",
            "flash_wgmma.cu", "flash_bwd_wgmma.cu"} <= names
    # six mma.sync instance sources, the wgmma forward and backward
    assert len([n for n in names if n.startswith("flash_")]) == 8


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_kernel_source_uses_atomics(path):
    assert atomics(path.read_text()) == [], path.name


@pytest.mark.parametrize("snippet", [
    "atomicAdd(&dk[i], v);",
    "atomicCAS((int*)p, a, b);",
    'asm volatile("red.global.add.f32 [%0], %1;" :: "l"(p), "f"(v));',
    'asm volatile("atom.global.add.f32 %0, [%1], %2;" : "=f"(r) : "l"(p));',
])
def test_the_rule_catches_atomics_in_code_and_not_in_comments(snippet):
    assert atomics(f"__device__ void f() {{ {snippet} }}")
    assert not atomics(f"// {snippet}\n/* {snippet} */ int x;")
