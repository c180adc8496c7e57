#!/usr/bin/env python3
"""Host time of the norm kernels' wrappers on the card, and of their parts.

    python3 tools/host_cost.py [--shape 1024,1024] [--calls 2000]

Microseconds of host time per call, calls back to back with no
synchronize between them, at a shape whose kernels take less device time
than the host spends (the naive path's (1024, 1024) by default), so the
launch queue never fills and the host's own cost is what is timed: the
residual-add + RMSNorm forward and backward wrappers, then the pieces a
wrapper is made of (the tensor checks, the stream handle, as the
launches take it and as a ``torch.cuda.Stream``, one allocation of the
input's size, the backward's configuration); then the bf16 QKV GEMM and
flash forward wrappers at small shapes (``--small``) on their wgmma
instances, and on their mma.sync instances at inputs that reach them
(the GEMM's K one less, rows TMA cannot read; the flash forward at head
dim 80), and the wgmma wrappers' host pieces: the tensor-map
specs (``kernels/tma.py``) and their ctypes arrays (the C entry point
encodes the maps on the host too, inside the launch).  Prints the card
line and one JSON object.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def per_call_us(fn, calls):
    import torch
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="1024,1024", help="M,d")
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--small", default="256,256,256",
                    help="M,K,N of the GEMM; the flash forward runs 128 "
                         "positions of 2 heads of 64")
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as cs
    import ctypes
    from repro_torch.kernels import build, flash, fused, tma
    if not torch.cuda.is_available():
        print("host_cost: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    M, d = (int(v) for v in args.shape.split(","))
    res, w, gres, gh = cs.make_inputs("add_rmsnorm_bwd", (M, d),
                                      torch.float32, dev, seed=2)
    cases = {
        "add_rmsnorm_fwd": lambda: fused.add_rmsnorm_fwd(res, gres, w, 1e-6),
        "add_rmsnorm_bwd": lambda: fused.add_rmsnorm_bwd(res, w, gres, gh,
                                                         1e-6),
        "check_tensors": lambda: build.check_tensors("x", res, w, gres, gh),
        "current_stream": lambda: build.current_stream(res),
        "torch.cuda.current_stream": lambda: torch.cuda.current_stream(
            res.device).cuda_stream,
        "empty_like": lambda: torch.empty_like(res),
        "norm_bwd_config": lambda: fused.norm_bwd_config(
            M, d, 4, [t.data_ptr() for t in (res, w, gres, gh, res)]),
    }
    gm, gk, gn = (int(v) for v in args.small.split(","))
    bf = torch.bfloat16
    x, wt, bias = cs.make_inputs("gemm_bias", (gm, gk, gn), bf, dev, seed=2)
    xu, wu, bu = cs.make_inputs("gemm_bias", (gm, gk - 1, gn), bf, dev,
                                seed=2)
    q, k, v, win = cs.make_inputs("flash_fwd", (1, 128, 2, 2, 64, 0), bf,
                                  dev, seed=2)
    q80, k80, v80, _ = cs.make_inputs("flash_fwd", (1, 128, 2, 2, 80, 0), bf,
                                      dev, seed=2)
    maps = tma.flash_maps(q, k, v, 128)
    if not (cs.takes_wgmma("gemm_bias", (x, wt)) and
            cs.takes_wgmma("flash_fwd", (q, k, v)) and
            not cs.takes_wgmma("gemm_bias", (xu, wu)) and
            not cs.takes_wgmma("flash_fwd", (q80, k80, v80))):
        raise SystemExit("host_cost: an input does not reach its instance")
    cases.update({
        "gemm_bias bf16 wgmma": lambda: fused.gemm_bias(x, wt, bias),
        "gemm_bias bf16 mma.sync (K - 1)": lambda: fused.gemm_bias(xu, wu, bu),
        "flash_fwd bf16 wgmma": lambda: flash.flash_fwd(q, k, v, win),
        "flash_fwd bf16 mma.sync (D 80)": lambda: flash.flash_fwd(
            q80, k80, v80, win),
        "tma.gemm_maps": lambda: tma.gemm_maps(
            gm, gn, gk, x.stride(), wt.stride(), x.data_ptr(), wt.data_ptr()),
        "tma.flash_maps": lambda: tma.flash_maps(q, k, v, 128),
        "ctypes spec array": lambda: (ctypes.c_longlong * len(maps))(*maps),
    })
    out = {"shape": [M, d], "small": [gm, gk, gn], "host_us_per_call": {
        name: per_call_us(fn, args.calls) for name, fn in cases.items()}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
