"""Resilient serving entry point (``repro/launch/serve.py``): continuous
batching over slot caches with template-based inference fault tolerance
(``runtime/serve_exec.py``, DESIGN.md §14).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --requests 8 --batch 4 --prompt-len 8 --decode-steps 16 \
        --temperature 0.8 --fail-at 4

Builds an OobleckEngine over a synthetic node set, registers a
ServeExecutor as its runtime, streams a request trace through the
continuous-batching scheduler, and (optionally) injects a node failure
mid-traffic through the monitor — the decode pipelines replan from the
precomputed template set and every in-flight request completes.

Runs on the card by default; ``--device cpu`` runs on the CPU.  The
weights come from a ``torch.Generator`` seeded by ``--seed``, the prompts
from numpy with that seed, and the sample key is ``prng_key`` of a seed
derived from it: a stream is a pure function of (weights, prompt,
request key), whatever replica set the planner picks.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core import EngineConfig, OobleckEngine, build_profile
from repro_torch.models import Model
from repro_torch.runtime.serve_exec import SamplingParams, ServeExecutor
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device, strict_fp32_numerics


def build_serving_engine(arch, *, nodes, fault_tolerance: int = 1,
                         n0: int = 2, nodes_per_pod: int = 2,
                         seq_len: int = 32) -> OobleckEngine:
    """Engine wired for serving: the instance set is the decode-replica
    set; templates / reconfigurator / topology work unchanged."""
    profile = build_profile(arch, microbatch=1, seq_len=seq_len)
    cfg = EngineConfig(fault_tolerance=fault_tolerance, global_batch=8,
                       microbatch=1, n0_override=n0,
                       nodes_per_pod=nodes_per_pod)
    return OobleckEngine(profile, list(nodes), cfg)


def percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else 0.0


def make_prompts(vocab_size: int, n: int, prompt_len: int, seed: int):
    """``n`` prompts of ``prompt_len`` tokens from numpy's generator."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab_size, prompt_len).astype(np.int32)
            for _ in range(n)]


def serve_trace(ex: ServeExecutor, prompts, max_new: int,
                fail_at: int = -1) -> float:
    """Submit ``prompts``, tick until every request completed, killing
    the first node of the first replica through the monitor after
    ``fail_at`` ticks.  Returns the wall seconds from the first tick to
    the last (synchronized)."""
    for p in prompts:
        ex.submit(p, max_new=max_new)
    engine = ex.engine
    t0 = time.perf_counter()
    ticks = 0
    while ex.queue or any(r.active_mask().any() for r in ex.replicas):
        if ticks == fail_at:
            victim = engine.instances[0].nodes[0]
            engine.monitor.inject("fail", [victim])
            engine.monitor.poll(time.perf_counter())
            print(f"[serve] killed {victim}: {ex.last_recovery}")
        ex.tick()
        ticks += 1
    ex.synchronize()
    return time.perf_counter() - t0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots per replica")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--decode-steps", type=int, default=16,
                    help="generated tokens per request")
    ap.add_argument("--requests", type=int, default=0,
                    help="request count (default: one per slot)")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--nodes", type=int, default=6)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a node failure after this many ticks")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        strict_fp32_numerics()

    arch = get_arch(args.arch)
    if not args.full:
        arch = reduced(arch, layers=args.layers)
    model = Model(arch, dtype=torch.float32, remat=False)
    # independent streams for weights, prompts and sampling (a shared one
    # would correlate the prompts with the weights)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    sample_key = prng.fold_in(prng.prng_key(args.seed, device), 2)

    n_req = args.requests or args.batch
    prompts = make_prompts(arch.vocab_size, n_req, args.prompt_len,
                           args.seed)

    engine = build_serving_engine(
        arch, nodes=[f"node{i}" for i in range(args.nodes)])
    t0 = time.perf_counter()
    ex = ServeExecutor(
        model, params, engine, num_slots=args.batch,
        max_len=args.prompt_len + args.decode_steps,
        max_new_cap=args.decode_steps,
        sampling=SamplingParams(args.temperature, args.top_k),
        sample_key=sample_key)
    warm_s = time.perf_counter() - t0
    wall_s = serve_trace(ex, prompts, args.decode_steps, args.fail_at)

    total_tokens = sum(r.max_new for r in ex.completed)
    ttft = [r.first_token_s - r.arrival_s for r in ex.completed
            if r.first_token_s is not None]
    ms_per_token = wall_s / max(total_tokens, 1) * 1e3
    print(f"[serve] replicas={len(ex.replicas)} slots={args.batch} "
          f"requests={len(ex.completed)}/{n_req} warm={warm_s:.1f}s "
          f"device={device}")
    print(f"[serve] {total_tokens} tokens in {wall_s * 1e3:.0f}ms "
          f"({total_tokens / wall_s:.1f} tok/s, {ms_per_token:.2f}"
          f"ms/token), ttft p50={percentile(ttft, 50) * 1e3:.1f}ms "
          f"p99={percentile(ttft, 99) * 1e3:.1f}ms")
    r0 = min(ex.completed, key=lambda r: r.rid)
    print(f"[serve] sample continuation (request 0): "
          f"{r0.tokens[:16].tolist()}")
    assert len(ex.completed) == n_req, "not all requests completed"
    toks = np.stack([r.tokens for r in
                     sorted(ex.completed, key=lambda r: r.rid)])
    return {"tokens": toks, "ms_per_token": ms_per_token,
            "tokens_per_s": total_tokens / wall_s,
            "ttft_p50_ms": percentile(ttft, 50) * 1e3,
            "ttft_p99_ms": percentile(ttft, 99) * 1e3,
            "recovery": ex.last_recovery}


if __name__ == "__main__":
    main()
