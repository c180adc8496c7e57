#!/usr/bin/env python3
"""Device-time breakdown of one steady step of the port's training
entry point (``repro_torch.launch.train``), on the card.

    python3 tools/profile_step.py --step 2 -- --arch mamba2-780m --full \
        --seq-len 2048 --microbatch 1 --ssd-impl kernel --steps 3

Runs ``repro_torch.launch.train.main(<args after -->)`` and records the
``--step``-th call of ``HeteroTrainer.step`` (0-based; pick one after
the first, which warms the allocator) under ``torch.profiler`` with CUDA
activity.  Prints one JSON line: the step's wall seconds (host clock
around the call, ended by a synchronize), the device seconds summed over
its kernels, their ratio (the busy share; 1 minus it is the idle share,
the kernels running on one stream), and the device seconds of each
kernel group and of the ``--top`` kernels by device time.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

#: (group, substrings of the kernel name), first match wins
GROUPS = (
    ("ssd kernels", ("ssd_fwd_", "ssd_bwd_")),     # every phase
    ("flash kernels", ("flash_fwd_kernel", "flash_bwd")),
    ("epilogue kernels", ("add_rmsnorm", "gemm_bias_kernel")),
    ("cuBLAS products", ("gemm", "xmma", "cutlass", "sgemm")),
    ("convolution", ("conv", "cudnn")),
    ("copies", ("copy", "memcpy", "memset", "cat", "Cat")),
    ("reductions", ("reduce", "Reduce", "softmax", "logsumexp")),
    ("elementwise", ("elementwise", "vectorized", "Elementwise")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--step", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    argv = sys.argv[1:] if argv is None else list(argv)
    cut = argv.index("--") if "--" in argv else len(argv)
    args, train_argv = ap.parse_args(argv[:cut]), argv[cut + 1:]
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train
    from repro_torch.runtime import HeteroTrainer

    record = {}
    step_fn, calls = HeteroTrainer.step, [0]

    def traced(self, *a, **k):
        calls[0] += 1
        if calls[0] - 1 != args.step:
            return step_fn(self, *a, **k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = step_fn(self, *a, **k)
            torch.cuda.synchronize()
            record["wall_s"] = time.perf_counter() - t0
        kernels = {}
        for evt in prof.key_averages():
            us = getattr(evt, "device_time_total",
                         getattr(evt, "cuda_time_total", 0.0))
            if us > 0:
                kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e6
        record["device_s"] = sum(kernels.values())
        record["groups"] = {}
        for name, s in kernels.items():
            g = group_of(name)
            record["groups"][g] = record["groups"].get(g, 0.0) + s
        record["top"] = sorted(([s, name[:120]] for name, s in
                                kernels.items()), reverse=True)[:args.top]
        return out

    HeteroTrainer.step = traced
    try:
        train.main(train_argv)
    finally:
        HeteroTrainer.step = step_fn
    if not record:
        raise SystemExit(f"step {args.step} never ran")
    record["busy_share"] = record["device_s"] / record["wall_s"]
    record["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
