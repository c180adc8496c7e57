#!/usr/bin/env python3
"""What the SPMD update's pieces cost in a bf16 step of a phase 20
scenario of ``chip_smoke.py``, on the card.

    python3 tools/update_cost.py [--scenario 20b] [--rules rows,blocks,whole]
        [--steps 3]

Builds the scenario as phase 20 does (``chip_smoke.bf16_model`` in bf16
at full width and depth, one program on a 1 x 1 mesh, global batch 4;
tokens drawn from ``--seed``) and, for each rule of cutting the leaves
into the dim-0 pieces that ``runtime/spmd.py::apply_sharded`` steps:

  * ``rows``: ``spmd.update_pieces``, ranges of at most the largest row
    of any leaf (what the port runs);
  * ``blocks``: every leaf stacked under ``"blocks"`` one block slice at
    a time, the others in ranges of at most the largest slice;
  * ``whole``: every leaf in one piece;

runs ``--steps`` steps from the same weights and prints one JSON line:
the pieces a step, the steady steps' seconds (host clock, each ended by
a synchronize), and one more step with the update timed alone: its wall
seconds between two synchronizes, the host seconds until
``apply_sharded`` returns, and under ``torch.profiler`` the device
kernels it launched and their device seconds.  The card line comes
first.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def blocks_rule(shapes, stacked):
    """A stacked leaf one block slice at a time, any other in ranges of
    at most the largest slice's elements (whole where nothing is
    stacked)."""
    rows = [max(1, math.prod(s[1:])) for s in shapes]
    cap = max((r for r, st in zip(rows, stacked) if st), default=None)
    out = []
    for s, r, st in zip(shapes, rows, stacked):
        if not s:
            out.append([(0, 0)])
            continue
        step = 1 if st else (s[0] if cap is None else max(1, cap // r))
        out.append([(r0, min(r0 + step, s[0])) for r0 in range(0, s[0], step)]
                   or [(0, 0)])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="20b")
    ap.add_argument("--rules", default="rows,blocks,whole")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import ShardingStrategy, SPMDExecutor, spmd
    from repro_torch.utils.tree import tree_leaves
    if not torch.cuda.is_available():
        print("update_cost: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    arch, seq, F, model = cs.bf16_model(True, args.scenario, "bfloat16")
    gb = cs.BF16["global_batch"]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    data = {k: torch.randint(0, arch.vocab_size, (gb, seq), generator=gen,
                             device=dev, dtype=torch.int32)
            for k in ("tokens", "labels")}
    if F:
        data["frontend_embeds"] = (torch.randn(
            (gb, F, arch.d_model), generator=gen, device=dev) * 0.02
        ).to(torch.bfloat16)
    rules = {"rows": None, "whole": lambda shapes: [
        [(0, s[0] if s else 0)] for s in map(tuple, shapes)]}
    real_pieces, real_apply = spmd.update_pieces, spmd.apply_sharded
    timed = {}

    def apply_timed(*a, **k):
        if not timed.get("on"):
            return real_apply(*a, **k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = real_apply(*a, **k)
            timed["issue_s"] = time.perf_counter() - t0
            torch.cuda.synchronize()
            timed["wall_s"] = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if getattr(e, "device_time_total",
                              getattr(e, "cuda_time_total", 0.0)) > 0]
        timed["kernels"] = sum(e.count for e in kernels)
        timed["device_s"] = sum(getattr(e, "device_time_total",
                                        getattr(e, "cuda_time_total", 0.0))
                                for e in kernels) / 1e6
        return out
    spmd.apply_sharded = apply_timed
    try:
        for rule in args.rules.split(","):
            params = model.init(torch.Generator(device=dev).manual_seed(
                cs.BF16["seed"]))
            stacked = [k == "blocks" for k in sorted(params)
                       for _ in tree_leaves(params[k])]
            if rule == "blocks":
                spmd.update_pieces = lambda shapes, st=stacked: blocks_rule(
                    [tuple(s) for s in shapes], st)
            else:
                spmd.update_pieces = rules[rule] or real_pieces
            pieces = sum(len(p) for p in spmd.update_pieces(
                [t.shape for t in tree_leaves(params)]))
            ex = SPMDExecutor(model, params, adamw.AdamWConfig(
                **cs.SPMD_OPT), mesh=make_mesh((1, 1), ("data", "model")),
                strategy=ShardingStrategy(),
                shape=cs.bf16_shape(args.scenario, seq, F))
            del params
            torch.cuda.reset_peak_memory_stats()
            secs = []
            for _ in range(args.steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ex.step(data)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            timed.clear()
            timed["on"] = True
            ex.step(data)
            torch.cuda.synchronize()
            timed.pop("on")
            print(json.dumps({
                "scenario": args.scenario, "arch": arch.name, "rule": rule,
                "pieces": pieces, "step_s": secs,
                "update_wall_s": timed["wall_s"],
                "update_issue_s": timed["issue_s"],
                "update_kernels": timed["kernels"],
                "update_device_s": timed["device_s"],
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}),
                flush=True)
            del ex
            torch.cuda.empty_cache()
    finally:
        spmd.update_pieces, spmd.apply_sharded = real_pieces, real_apply
    return 0


if __name__ == "__main__":
    sys.exit(main())
