#!/usr/bin/env python3
"""Step time of the port's trainer, compiled programs against the eager
1F1B walker: the PyTorch counterpart of ``benchmarks/step_time.py``.

    PYTHONPATH=src python3 tools/step_time.py --json build/step_time.json
    PYTHONPATH=src python3 tools/step_time.py --full --seq-len 2048 \
        --attn-impl kernel --steps 3 --json build/step_time_full.json
    PYTHONPATH=src python3 tools/step_time.py --device cpu --steps 2

For each mode:

  * ``steady_state_s`` — the median over ``--steps`` steps, each timed on
    the host clock up to a ``torch.cuda.synchronize`` (after one step
    that settles the caches);
  * ``reconfig_s`` — kill the last node of the first pipeline, recover
    from the replicas and run the next step, to its synchronize;
  * ``builds_after_failure`` — program and kernel-library builds during
    that recovery and step (``track_compiles``): 0 for the compiled mode
    after ``warm_templates``, which the script asserts.

Runs on the card by default and prints the card's name and power limit
beside the numbers; ``--device cpu`` times the plain versions on the
CPU, which says nothing about the card.  ``--json`` writes the result.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402

from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.core import EngineConfig, OobleckEngine, build_profile  # noqa: E402
from repro_torch.data import GlobalBatchDispenser, SyntheticLM  # noqa: E402
from repro_torch.launch.train import microbatches  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import HeteroTrainer, track_compiles  # noqa: E402
from repro_torch.utils.device import resolve_device, strict_fp32_numerics  # noqa: E402


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_mode(mode: str, model, profile, params, opt_cfg, args,
               device) -> Dict:
    nodes = [f"n{i}" for i in range(args.nodes)]
    engine = OobleckEngine(profile, nodes, EngineConfig(
        fault_tolerance=args.f, global_batch=args.global_batch,
        microbatch=args.microbatch, gpus_per_node=1, n0_override=args.n0))
    trainer = HeteroTrainer(model, engine, params, opt_cfg, mode=mode)
    t0 = time.perf_counter()
    trainer.warm_templates()
    warm_s = time.perf_counter() - t0
    disp = GlobalBatchDispenser(SyntheticLM(model.arch.vocab_size,
                                            args.seq_len, seed=0))

    def drive() -> float:
        batches = disp.next_step(engine.batch.minibatch_sizes())
        out = trainer.train_step([microbatches(b, args.microbatch)
                                  for b in batches])
        _sync(device)
        return float(out["loss"])

    drive()                                    # settle caches in both modes
    times = []
    for _ in range(args.steps):
        _sync(device)
        t0 = time.perf_counter()
        drive()
        times.append(time.perf_counter() - t0)

    victim = engine.instances[0].nodes[-1]
    _sync(device)
    with track_compiles() as log:
        t0 = time.perf_counter()
        trainer.recover({victim})
        loss = drive()
        reconfig = time.perf_counter() - t0
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device) / 2**30
    else:
        peak = None
    print(f"[{mode}] steady {statistics.median(times):.4f}s "
          f"(steps {[round(t, 4) for t in times]}), reconfig "
          f"{reconfig:.4f}s, builds after failure {log.backend_compiles}, "
          f"loss after recovery {loss:.4f}")
    return {"mode": mode, "steady_state_s": statistics.median(times),
            "step_seconds": times, "reconfig_s": reconfig,
            "warm_seconds": warm_s,
            "builds_after_failure": log.backend_compiles,
            "max_memory_allocated_gib": peak,
            "cache": trainer.cache.stats.as_dict()}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt3_medium")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--full", action="store_true",
                    help="the architecture at full width and depth")
    ap.add_argument("--nodes", type=int, default=5)
    ap.add_argument("--f", type=int, default=1)
    ap.add_argument("--n0", type=int, default=2)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--attn-impl", default="kernel",
                    choices=["naive", "blocked", "kernel"])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    card = None
    if device.type == "cuda":
        strict_fp32_numerics()
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(f"[device] {card}")
    arch = get_arch(args.arch)
    if not args.full:
        arch = reduced(arch, layers=args.layers)
    model = Model(arch, dtype=torch.float32, attn_impl=args.attn_impl)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    profile = build_profile(arch, microbatch=args.microbatch,
                            seq_len=args.seq_len)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, weight_decay=0.0)

    modes = {}
    for mode in ("compiled", "eager"):
        modes[mode] = bench_mode(mode, model, profile, params, opt_cfg, args,
                                 device)
        gc.collect()        # the trainer and its engine refer to each other
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
    result = {"device": card or "cpu", "config": {
        k: getattr(args, k) for k in ("arch", "full", "layers", "nodes",
                                      "global_batch", "microbatch",
                                      "seq_len", "attn_impl", "steps")},
        **modes,
        "eager_over_compiled_steady": (modes["eager"]["steady_state_s"]
                                       / modes["compiled"]["steady_state_s"])}
    if modes["compiled"]["builds_after_failure"]:
        raise RuntimeError("a warmed cache must serve the reconfiguration "
                           "without building")
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=2)
        print(f"wrote {args.json}")
    return result


if __name__ == "__main__":
    main()
