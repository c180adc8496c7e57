#!/usr/bin/env python3
"""How the card's TF32 tensor-core product rounds its accumulation.

    python3 tools/mma_rounding.py

Builds a one-warp probe (``mma.sync.aligned.m16n8k8`` with .tf32
operands, as ``src/repro_torch/kernels/csrc/tensor_core.cuh`` issues
it) under ``build/mma_rounding/`` and runs it on the card: the
accumulator starts at c = 1 and one product adds x = f * ulp(1), ulp(1)
= 2^-23, for several fractions f.  Round-to-nearest returns
1 + round(f) ulp, round-toward-zero 1 + floor(f) ulp.  Prints one JSON
line with each f, the result in ulps above 1, and the verdict.  This is
why the port's kernels add the mma accumulator into an ordinary fp32
sum at a fixed interval (the promotion).
"""
from __future__ import annotations

import ctypes
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "mma_rounding"

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void probe(const float* xs, float* out, int n) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  for (int i = 0; i < n; ++i) {
    // A[0][0] = x, B[0][0] = 1, C[0][0] = 1, everything else 0
    uint32_t a0 = (g == 0 && t == 0) ? __float_as_uint(xs[i]) : 0u;
    uint32_t b0 = (g == 0 && t == 0) ? __float_as_uint(1.f) : 0u;
    float c0 = lane == 0 ? 1.f : 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
    uint32_t z = 0u;
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
        : "r"(a0), "r"(z), "r"(z), "r"(z), "r"(b0), "r"(z));
    if (lane == 0) out[i] = c0;
  }
}
extern "C" int run_probe(const float* xs, float* out, int n) {
  probe<<<1, 32>>>(xs, out, n);
  return (int)cudaGetLastError();
}
"""

#: fractions of ulp(1); each x = f * 2^-23 is exact in TF32
FRACTIONS = (0.25, 0.5, 0.75, 1.25, 1.75)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mma_rounding: no CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / "probe.cu", OUT / "libprobe.so"
    src.write_text(SOURCE)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                    str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).run_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    xs = torch.tensor([f * 2.0 ** -23 for f in FRACTIONS], device="cuda")
    out = torch.empty_like(xs)
    if fn(xs.data_ptr(), out.data_ptr(), len(FRACTIONS)) != 0:
        raise RuntimeError("probe launch failed")
    torch.cuda.synchronize()
    ulps = [(float(v) - 1.0) / 2.0 ** -23 for v in out.cpu()]
    rz = all(u == int(f) for u, f in zip(ulps, FRACTIONS))
    rn = all(u == round(f) for u, f in zip(ulps, FRACTIONS))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "fractions": FRACTIONS, "ulps_above_1": ulps,
                      "verdict": ("round toward zero" if rz else
                                  "round to nearest" if rn else "other")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
