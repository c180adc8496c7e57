#!/usr/bin/env python3
"""Serving-plane throughput of the port (``repro_torch/runtime/
serve_exec.py``): continuous batching against the static-batch baseline,
and recovery through a failure mid-decode.  The PyTorch counterpart of
``benchmarks/serve_throughput.py``.

    PYTHONPATH=src python3 tools/serve_throughput.py --full \
        --json build/serve_throughput.json
    PYTHONPATH=src python3 tools/serve_throughput.py --device cpu

Three legs over the same skewed request trace (mostly short generations
plus a long tail, the regime continuous batching exists for), all
greedy, sharing one set of weights and one program cache:

  static           admit a full batch, drain it completely, refill
  continuous       backfill freed slots every tick (Orca-style)
  continuous+fail  continuous, with a node killed after ``--fail-at``
                   ticks; the decode pipelines replan from the template
                   set

Each leg reports tokens/s (host clock from the first tick to a
synchronize after the last), TTFT p50/p99, ticks, and the builds
during fail -> recover -> drain (``track_compiles``).  The script
asserts that every request completes, that the failed leg builds
nothing and that its streams equal the continuous leg's bitwise; it
reports the continuous/static ratio.  On the card it also times
``--profile-ticks`` pure decode ticks alone, under ``torch.profiler``'s
CUDA activity (device seconds a tick, the device busy share, the kernels
a tick launches) and under its CPU activity (the host ops' self time a
tick); and it prints the card's name and power limit.
Runs on the card by default; ``--device cpu`` times the CPU, which says
nothing about the card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.launch.serve import build_serving_engine, percentile  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.runtime import ProgramCache, track_compiles  # noqa: E402
from repro_torch.runtime.serve_exec import SamplingParams, ServeExecutor  # noqa: E402
from repro_torch.utils import prng  # noqa: E402
from repro_torch.utils.device import resolve_device, strict_fp32_numerics  # noqa: E402


def request_trace(n_req: int, short: int, long: int, period: int,
                  vocab: int, prompt_len: int, seed: int = 0):
    """Skewed lengths: one long generation per ``period`` requests, the
    rest short — the workload static batching wastes slots on."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, prompt_len).astype(np.int32)
               for _ in range(n_req)]
    lengths = [long if i % period == 0 else short for i in range(n_req)]
    return prompts, lengths


def make_executor(model, params, arch, cache, *, mode, slots, prompt_len,
                  max_new):
    engine = build_serving_engine(
        arch, nodes=[f"node{i}" for i in range(6)])
    return ServeExecutor(
        model, params, engine, num_slots=slots,
        max_len=prompt_len + max_new, max_new_cap=max_new,
        sampling=SamplingParams(temperature=0.0),
        prompt_buckets=[prompt_len, prompt_len + max_new],
        sample_key=prng.prng_key(7, params["embed"]["table"].device),
        admission=mode, cache=cache)


def run_leg(model, params, arch, cache, prompts, lengths, *, mode: str,
            slots: int, prompt_len: int, fail_at=None):
    ex = make_executor(model, params, arch, cache, mode=mode, slots=slots,
                       prompt_len=prompt_len, max_new=max(lengths))
    for p, n in zip(prompts, lengths):
        ex.submit(p, max_new=n)
    t0 = time.perf_counter()
    builds = 0
    if fail_at is None:
        ex.drain()
    else:
        for _ in range(fail_at):
            ex.tick()
        with track_compiles() as log:
            victim = ex.engine.instances[0].nodes[0]
            ex.engine.monitor.inject("fail", [victim])
            ex.engine.monitor.poll(time.perf_counter())
            ex.drain()
        builds = log.backend_compiles
    ex.synchronize()
    wall_s = time.perf_counter() - t0
    assert len(ex.completed) == len(prompts), \
        f"{mode}: {len(ex.completed)}/{len(prompts)} requests completed"
    total_tokens = sum(len(r.tokens) for r in ex.completed)
    ttft = [r.first_token_s - r.arrival_s for r in ex.completed]
    return {
        "mode": mode + ("" if fail_at is None else "+fail"),
        "requests": len(prompts),
        "replicas": len(ex.replicas),
        "total_tokens": total_tokens,
        "wall_s": wall_s,
        "tokens_per_s": total_tokens / wall_s,
        "ms_per_token": wall_s / total_tokens * 1e3,
        "ttft_p50_ms": percentile(ttft, 50) * 1e3,
        "ttft_p99_ms": percentile(ttft, 99) * 1e3,
        "ticks": ex.ticks,
        "builds_after_failure": builds,
        "recovery": ex.last_recovery,
        "streams": {r.rid: r.tokens for r in ex.completed},
    }


def profile_decode(model, params, arch, cache, prompts, *, slots,
                   prompt_len, ticks: int):
    """Pure decode ticks (every slot busy, none finishing) in three
    windows of ``ticks``: timed alone (wall ms a tick); under
    torch.profiler's CUDA activity (device ms a tick, busy share =
    device / wall of that window, kernels a tick, the top kernels); and
    under its CPU activity (the host ops' self time a tick, the top
    ones: where a host-bound tick spends its time)."""
    from torch.profiler import ProfilerActivity, profile
    budget = 3 * ticks + 4
    ex = make_executor(model, params, arch, cache, mode="continuous",
                       slots=slots, prompt_len=prompt_len, max_new=budget)
    for p in prompts[:slots * len(ex.replicas)]:
        ex.submit(p, max_new=budget)
    ex.tick()                               # admissions + one decode
    ex.tick()                               # settles the allocator

    def window():
        ex.synchronize()
        t0 = time.perf_counter()
        for _ in range(ticks):
            ex.tick()
        ex.synchronize()
        return time.perf_counter() - t0

    wall_s = window()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prof_wall_s = window()
    device_s, launches, by_kernel = 0.0, 0, {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total",
                     getattr(evt, "cuda_time_total", 0.0))
        if us > 0:
            device_s += us / 1e6
            launches += evt.count
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us / 1e6
    with profile(activities=[ProfilerActivity.CPU]) as host:
        window()
    by_op = sorted(((evt.self_cpu_time_total / 1e3 / ticks, evt.key,
                     evt.count / ticks) for evt in host.key_averages()),
                   reverse=True)[:10]
    ex.drain()
    return {"ticks": ticks, "replicas": len(ex.replicas),
            "wall_ms_per_tick": wall_s / ticks * 1e3,
            "device_ms_per_tick": device_s / ticks * 1e3,
            "busy_share": device_s / prof_wall_s,
            "kernels_per_tick": launches / ticks,
            "top_kernels_ms_per_tick": [
                [s / ticks * 1e3, k[:100]] for s, k in sorted(
                    ((s, k) for k, s in by_kernel.items()),
                    reverse=True)[:8]],
            "top_host_ops_ms_per_tick": [[ms, k, n] for ms, k, n in by_op]}


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--full", action="store_true",
                    help="the architecture at full width and depth")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=4)
    ap.add_argument("--short", type=int, default=4)
    ap.add_argument("--long", type=int, default=40)
    ap.add_argument("--period", type=int, default=4,
                    help="every Nth request generates --long tokens")
    ap.add_argument("--fail-at", type=int, default=6)
    ap.add_argument("--profile-ticks", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    if on_card:
        strict_fp32_numerics()

    arch = get_arch(args.arch)
    if not args.full:
        arch = reduced(arch, layers=args.layers)
    model = Model(arch, dtype=torch.float32, remat=False)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    cache = ProgramCache()           # shared: every leg reuses programs
    prompts, lengths = request_trace(
        args.requests, args.short, args.long, args.period,
        arch.vocab_size, args.prompt_len, args.seed)

    legs = {}
    for mode, fail_at in (("static", None), ("continuous", None),
                          ("continuous", args.fail_at)):
        leg = run_leg(model, params, arch, cache, prompts, lengths,
                      mode=mode, slots=args.slots,
                      prompt_len=args.prompt_len, fail_at=fail_at)
        legs[leg["mode"]] = leg
        rec = leg["recovery"] or {}
        print(f"[serve_throughput] {leg['mode']}: "
              f"{leg['tokens_per_s']:.1f} tok/s, ttft p50 "
              f"{leg['ttft_p50_ms']:.1f} ms p99 {leg['ttft_p99_ms']:.1f} ms, "
              f"{leg['ticks']} ticks, {leg['replicas']} replicas"
              + (f", downtime {rec['downtime_s'] * 1e3:.2f} ms, replayed "
                 f"{rec['replayed']}, migrated {rec['migrated']}, builds "
                 f"{leg['builds_after_failure']}" if rec else ""))

    cont, stat = legs["continuous"], legs["static"]
    failed = legs["continuous+fail"]
    assert failed["builds_after_failure"] == 0, \
        "recovery must reuse the programs built at bootstrap"
    assert failed["recovery"] is not None
    for rid, toks in cont["streams"].items():
        np.testing.assert_array_equal(
            failed["streams"][rid], toks,
            f"stream {rid} diverged through the failure")

    results = {k: {kk: vv for kk, vv in leg.items() if kk != "streams"}
               for k, leg in legs.items()}
    results["summary"] = {
        "continuous_vs_static": cont["tokens_per_s"] / stat["tokens_per_s"],
        "recovery_downtime_ms": failed["recovery"]["downtime_s"] * 1e3,
        "ttft_p99_through_failure_ms": failed["ttft_p99_ms"],
        "bitwise_identical_through_failure": True,
    }
    results["decode_tick"] = (
        profile_decode(model, params, arch, cache, prompts, slots=args.slots,
                       prompt_len=args.prompt_len, ticks=args.profile_ticks)
        if on_card else "not measured (no card)")
    results["device"] = {
        "type": device.type,
        "name": torch.cuda.get_device_name(0) if on_card else "cpu",
        "card": card_line() if on_card else None}
    results["config"] = {"arch": arch.name, "full": args.full,
                         "layers": arch.num_layers, "d_model": arch.d_model,
                         "slots": args.slots, "requests": args.requests,
                         "prompt_len": args.prompt_len, "short": args.short,
                         "long": args.long, "period": args.period,
                         "fail_at": args.fail_at}
    print(f"[serve_throughput] continuous/static "
          f"{results['summary']['continuous_vs_static']:.2f}x, decode tick "
          f"{json.dumps(results['decode_tick'])}")
    if on_card:
        print(results["device"]["card"])
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps(results["summary"]))
    return results


if __name__ == "__main__":
    main()
