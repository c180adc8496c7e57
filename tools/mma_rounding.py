#!/usr/bin/env python3
"""How the card's tensor-core products round their accumulation.

    python3 tools/mma_rounding.py

Builds one-warp and one-warpgroup probes under ``build/mma_rounding/``
and runs them on the card, in one process: ``mma.sync.aligned`` m16n8k8
with .tf32 operands and m16n8k16 with .bf16 operands, as
``src/repro_torch/kernels/csrc/tensor_core.cuh`` issues them, and
``wgmma.mma_async`` m64n64k16 with .bf16 operands from shared memory, as
``csrc/hopper.cuh`` issues it (its own wrappers, included from the
checkout), and m64n32k8 with .tf32 operands, A from registers, as
``csrc/ssd_wgmma.cu`` issues it.  Each case starts the accumulator at c = 1 and adds terms
x = f * ulp(1), ulp(1) = 2^-23, placed at chosen k positions of row 0
of A against ones in column 0 of B (every such x is exact in TF32 and
bf16):

  * one term of f = 0.25, 0.5, 0.75, 1.25, 1.75: round-to-nearest
    returns 1 + round(f) ulp, round-toward-zero 1 + floor(f) ulp;
  * two terms of 0.75 in one k step (positions 0 and 1): 1 ulp if the
    step's products are summed exactly and the sum then rounded toward
    zero into c, 0 if each is rounded in on its own;
  * two terms of 0.75 in two k steps (positions 0 and 16, two
    instructions): 0 if each step's sum is rounded into c on its own.

Prints one JSON line: the card, each product's ulps above 1 per case,
and its verdicts.  This is why the port's kernels add the tensor cores'
accumulator into an ordinary fp32 sum at a fixed interval (the
promotion), and what ``tests/test_torch_gemm_tiles.py`` and
``tests/test_torch_flash_tiles.py`` emulate.
"""
from __future__ import annotations

import ctypes
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "mma_rounding"

SOURCE = r"""
#include <cstdint>
#include "hopper.cuh"
#include "tensor_core.cuh"

// Case i: n[i] terms xs[i][0..n) at k positions ks[i][0..n) (< 32) of
// row 0 of A, B[k][0] = 1, C[0][0] = 1.  out[i] = the result's C[0][0].
#define MAXT 2

__global__ void probe_tf32(const float* xs, const int* ks, const int* n,
                           float* out, int cases) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  for (int i = 0; i < cases; ++i) {
    float c[4] = {lane == 0 ? 1.f : 0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < 32; k0 += 8) {
      float a0 = 0.f, a2 = 0.f;
      for (int j = 0; j < n[i]; ++j) {
        const int k = ks[i * MAXT + j] - k0;
        if (g == 0 && k == t) a0 = xs[i * MAXT + j];
        if (g == 0 && k == t + 4) a2 = xs[i * MAXT + j];
      }
      const uint32_t a[4] = {__float_as_uint(a0), 0u, __float_as_uint(a2), 0u};
      const uint32_t one = g == 0 ? __float_as_uint(1.f) : 0u;
      const uint32_t b[2] = {one, one};
      mma_tf32(c, a, b);
    }
    if (lane == 0) out[i] = c[0];
  }
}

__global__ void probe_mma_bf16(const float* xs, const int* ks, const int* n,
                               float* out, int cases) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  for (int i = 0; i < cases; ++i) {
    float c[4] = {lane == 0 ? 1.f : 0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < 32; k0 += 16) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};   // k 2t, 2t+1, 2t+8, 2t+9
      for (int j = 0; j < n[i]; ++j) {
        const int k = ks[i * MAXT + j] - k0;
        for (int s = 0; s < 4; ++s)
          if (g == 0 && k == 2 * t + (s & 1) + 8 * (s >> 1))
            v[s] = xs[i * MAXT + j];
      }
      const uint32_t a[4] = {pack_bf16(v[0], v[1]), 0u, pack_bf16(v[2], v[3]),
                             0u};
      const uint32_t one = g == 0 ? pack_bf16(1.f, 1.f) : 0u;
      const uint32_t b[2] = {one, one};
      mma_bf16(c, a, b);
    }
    if (lane == 0) out[i] = c[0];
  }
}

// One warpgroup; A and B 64 x 64 bf16 K-major tiles in the 128-byte
// swizzle (row 0 is unswizzled: element k at byte 2k).
__global__ void probe_wgmma_bf16(const float* xs, const int* ks, const int* n,
                                 float* out, int cases) {
  __shared__ __align__(1024) __nv_bfloat16 A[64 * 64];
  __shared__ __align__(1024) __nv_bfloat16 B[64 * 64];
  for (int i = 0; i < cases; ++i) {
    for (int e = threadIdx.x; e < 64 * 64; e += 128) {
      A[e] = __float2bfloat16(0.f);
      B[e] = __float2bfloat16(e < 64 ? 1.f : 0.f);   // B[n 0][k] = 1
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int j = 0; j < n[i]; ++j)
        A[ks[i * MAXT + j]] = __float2bfloat16(xs[i * MAXT + j]);
    __syncthreads();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    float d[32];
    for (int r = 0; r < 32; ++r) d[r] = 0.f;
    if (threadIdx.x == 0) d[0] = 1.f;
    wgmma_fence();
    for (int kk = 0; kk < 2; ++kk) {
      wgmma_ss<0, 0>(d, sw128_desc(A + 16 * kk, 16, 1024),
                     sw128_desc(B + 16 * kk, 16, 1024), 1, Wn<64>());
      wgmma_commit();
      wgmma_wait<0>();
    }
    reg_fence(d);
    if (threadIdx.x == 0) out[i] = d[0];
    __syncthreads();
  }
}

// One warpgroup, wgmma m64n32k8 with .tf32 operands as
// csrc/ssd_wgmma.cu issues it: A from registers (row 0's terms in warp
// 0's lanes g = 0: a0 at k t, a2 at k t + 4 of each k8 step), B a 32 x 32
// fp32 K-major tile in the 128-byte swizzle (row n 0 unswizzled: ones).
__global__ void probe_wgmma_tf32(const float* xs, const int* ks, const int* n,
                                 float* out, int cases) {
  __shared__ __align__(1024) float B[32 * 32];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool row0 = threadIdx.x < 32 && g == 0;
  for (int e = threadIdx.x; e < 32 * 32; e += 128) B[e] = e < 32 ? 1.f : 0.f;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  for (int i = 0; i < cases; ++i) {
    float d[16];
    for (int r = 0; r < 16; ++r) d[r] = 0.f;
    if (threadIdx.x == 0) d[0] = 1.f;
    wgmma_fence();
    for (int kk = 0; kk < 4; ++kk) {
      float a0 = 0.f, a2 = 0.f;
      for (int j = 0; j < n[i]; ++j) {
        const int k = ks[i * MAXT + j] - 8 * kk;
        if (row0 && k == t) a0 = xs[i * MAXT + j];
        if (row0 && k == t + 4) a2 = xs[i * MAXT + j];
      }
      const uint32_t a[4] = {__float_as_uint(a0), 0u, __float_as_uint(a2), 0u};
      const uint64_t db = sw128_desc(B + 8 * kk, 16, 1024);
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, "
          "%8, %9, %10, %11, %12, %13, %14, %15}, "
          "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
            "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
            "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
            "+f"(d[15])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
      wgmma_commit();
      wgmma_wait<0>();
    }
    reg_fence(d);
    if (threadIdx.x == 0) out[i] = d[0];
    __syncthreads();
  }
}

extern "C" int run_probe(int kind, const float* xs, const int* ks,
                         const int* n, float* out, int cases) {
  if (kind == 0) probe_tf32<<<1, 32>>>(xs, ks, n, out, cases);
  if (kind == 1) probe_mma_bf16<<<1, 32>>>(xs, ks, n, out, cases);
  if (kind == 2) probe_wgmma_bf16<<<1, 128>>>(xs, ks, n, out, cases);
  if (kind == 3) probe_wgmma_tf32<<<1, 128>>>(xs, ks, n, out, cases);
  return (int)cudaGetLastError();
}
"""

ULP = 2.0 ** -23
#: fractions of ulp(1) of the one-term cases
FRACTIONS = (0.25, 0.5, 0.75, 1.25, 1.75)
#: (label, [(f, k position), ...])
CASES = ([(f"one {f}", [(f, 0)]) for f in FRACTIONS]
         + [("two 0.75 in one k step", [(0.75, 0), (0.75, 1)]),
            ("two 0.75 in two k steps", [(0.75, 0), (0.75, 16)])])
PRODUCTS = {0: "mma.sync m16n8k8 tf32", 1: "mma.sync m16n8k16 bf16",
            2: "wgmma m64n64k16 bf16", 3: "wgmma m64n32k8 tf32"}


def verdicts(ulps):
    """Rounding of one term, and whether a k step's products are summed
    exactly before they are rounded into the accumulator."""
    one = ulps[:len(FRACTIONS)]
    rz = all(u == int(f) for u, f in zip(one, FRACTIONS))
    rn = all(u == round(f) for u, f in zip(one, FRACTIONS))
    same, apart = ulps[len(FRACTIONS):]
    return {"rounding": ("round toward zero" if rz else
                         "round to nearest" if rn else "other"),
            "k_step_summed_exactly": same == 1.0,
            "each_step_rounded_in": apart == 0.0}


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
                    "-std=c++17", "-I", str(CSRC), "-shared", "-Xcompiler",
                    "-fPIC", "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).run_probe
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
    xs = torch.zeros((len(CASES), 2), device="cuda")
    ks = torch.zeros((len(CASES), 2), dtype=torch.int32, device="cuda")
    n = torch.tensor([len(t) for _, t in CASES], dtype=torch.int32,
                     device="cuda")
    for i, (_, terms) in enumerate(CASES):
        for j, (f, k) in enumerate(terms):
            xs[i, j], ks[i, j] = f * ULP, k
    result = {"device": torch.cuda.get_device_name(0),
              "cases": [label for label, _ in CASES]}
    for kind, name in PRODUCTS.items():
        out = torch.empty(len(CASES), device="cuda")
        if fn(kind, xs.data_ptr(), ks.data_ptr(), n.data_ptr(),
              out.data_ptr(), len(CASES)) != 0:
            raise RuntimeError(f"{name} probe launch failed")
        torch.cuda.synchronize()
        ulps = [(float(v) - 1.0) / ULP for v in out.cpu()]
        result[name] = {"ulps_above_1": ulps, **verdicts(ulps)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
