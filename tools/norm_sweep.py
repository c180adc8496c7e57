#!/usr/bin/env python3
"""Device time of the backward norm under other row partitions, on the card.

    python3 tools/norm_sweep.py [--variants 8:16,16:16,32:12] \
        [--shapes 4096x1024,1024x1024] [--dtypes float32,bfloat16]

A variant ``E:W`` sets ``kernels/fused.py``'s ``NORM_ELEMS`` (elements of
a row a thread holds: twice it may not pass csrc/fused.cu's
``kNormElems`` where rows are wide, nor it where they are not) and
``NORM_WARPS_PER_SM`` before the configuration is computed, so the same
kernels run under each partition.
Per variant, shape and dtype: chip_smoke.py's comparison with the plain
version, then CUDA events over 50 calls and each CUDA function's
profiler device time.  Prints the card line and one JSON line per case.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="8:16,4:16,8:32")
    ap.add_argument("--shapes", default="4096x1024,1024x1024")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import fused
    from repro_torch.utils.device import strict_fp32_numerics
    if not torch.cuda.is_available():
        print("norm_sweep: no CUDA device", file=sys.stderr)
        return 1
    strict_fp32_numerics()
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    plain = cs.kernel_table(dev)["add_rmsnorm_bwd"][1]
    cases = [(shape, getattr(torch, dt), cs.make_inputs(
                  "add_rmsnorm_bwd", tuple(int(v) for v in shape.split("x")),
                  getattr(torch, dt), dev, seed=2))
             for shape in args.shapes.split(",")
             for dt in args.dtypes.split(",")]
    for variant in args.variants.split(","):
        elems, warps = (int(v) for v in variant.split(":"))
        fused.NORM_ELEMS, fused.NORM_WARPS_PER_SM = elems, warps
        fused._norm_bwd_config.cache_clear()
        for shape, dtype, inputs in cases:
            # the partition of this variant's constants (no backend: the
            # heuristic, never the autotuner's table), passed explicitly
            cfg = fused.norm_bwd_config(*inputs[0].shape,
                                        inputs[0].element_size(),
                                        [t.data_ptr() for t in inputs])

            def kern(*a, n=cfg.rows_per_block):
                return fused.add_rmsnorm_bwd(*a, 1e-6, rows_per_block=n)
            cs.compare("add_rmsnorm_bwd", kern, plain, inputs, dtype)
            dev_ms, per_fn = cs.device_ms(kern, inputs, "add_rmsnorm_bwd",
                                          args.iters)
            print(json.dumps({
                "elems": elems, "warps_per_sm": warps, "shape": shape,
                "dtype": str(dtype)[6:],
                "config": {k: getattr(cfg, k) for k in (
                    "rows_per_block", "rows_per_round", "warps_per_row",
                    "blocks", "chunks", "vec")},
                "ms": cs.time_ms(kern, inputs, dev, args.iters),
                "device_ms": dev_ms, "functions": per_fn}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
