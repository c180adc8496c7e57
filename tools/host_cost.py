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
input's size, the backward's configuration).  Prints the card line and
one JSON object.
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
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, fused
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
    out = {"shape": [M, d], "host_us_per_call": {
        name: per_call_us(fn, args.calls) for name, fn in cases.items()}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
