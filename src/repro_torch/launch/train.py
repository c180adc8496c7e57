"""End-to-end resilient training driver (``repro/launch/train.py``).

Real training through the Oobleck stack on the card: planner ->
templates -> heterogeneous pipeline instances -> per-template stage
programs (fused QKV GEMM and fused residual-add + RMSNorm as CUDA
kernels in every attention block, flash attention with ``--attn-impl
kernel``, the Mamba2 SSD scan with ``--ssd-impl kernel``) ->
layer-bucketed sync -> AdamW, with a node killed mid-run and training
continued from the surviving replicas.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --full --seq-len 2048 --attn-impl kernel --steps 4 --kill-at 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \
        --full --seq-len 2048 --ssd-impl kernel --steps 4 --kill-at 2

``--procs N`` runs the same loop through the multi-process backend
(``runtime/multihost.py``): this process coordinates, N spawned workers
execute (on the card they share it), and ``--kill-at`` SIGKILLs a worker
whose death the heartbeat channel detects::

    PYTHONPATH=src python -m repro_torch.launch.train --procs 3 \
        --steps 4 --kill-at 2 --device cpu

Runs on the card by default; ``--device cpu`` runs the plain versions of
the kernels on the CPU.  Without ``--full`` the architecture is reduced
to a few narrow layers.  ``--eager`` walks the 1F1B schedule stage by
stage instead of the per-template step programs; ``--ckpt-dir`` (with
``--ckpt-every N``) checkpoints through ``HeteroTrainer.snapshot``, and
on a failure that leaves fewer than (f+1)·n0 nodes the engine saves
before it gives up (paper §3.4).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_arch, reduced
from repro_torch.core import EngineConfig, OobleckEngine, build_profile
from repro_torch.data import ByteCorpus, GlobalBatchDispenser
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.runtime import HeteroTrainer
from repro_torch.utils.device import resolve_device, strict_fp32_numerics

_TEXT = (b"Oobleck enables resilient distributed training of large models "
         b"with guaranteed fault tolerance using pipeline templates. "
         b"It instantiates f+1 logically equivalent heterogeneous pipeline "
         b"replicas and recovers from failures by copying model states "
         b"from surviving replicas instead of restarting from checkpoints. ")


def microbatches(batch, mb_size):
    n = batch["tokens"].shape[0] // mb_size
    return [{k: v[i * mb_size:(i + 1) * mb_size] for k, v in batch.items()
             if not k.startswith("_")} for i in range(n)]


def _multiproc_hosting(nodes, procs):
    """node -> worker rank.  The LAST rank hosts exactly one node, so
    killing it (--kill-at) drops one node — the smallest failure a
    process death can model — and leaves the survivors above the
    (f+1)*n0 floor in the default 5-node/f=1 setup."""
    ranks = list(range(procs))
    host = {nodes[-1]: ranks[-1]}
    rest = nodes[:-1]
    per = -(-len(rest) // max(1, procs - 1)) if procs > 1 else len(rest)
    for i, n in enumerate(rest):
        host[n] = min(i // per, procs - 2) if procs > 1 else 0
    return host


def run_multiproc(args) -> dict:
    """--procs N: the same training loop through the multi-process
    backend — coordinator here, N spawned worker processes execute;
    --kill-at SIGKILLs a worker and recovery runs from heartbeat
    detection, not an injected event."""
    from repro_torch.runtime.multihost import MultiHostExecutor, make_job_spec

    nodes = [f"node{i}" for i in range(args.nodes)]
    spec = make_job_spec(
        arch=args.arch, layers=args.layers, seq_len=args.seq_len,
        microbatch=args.microbatch, global_batch=args.global_batch,
        f=args.f, n0=args.n0, nodes=nodes, nodes_per_pod=args.pods,
        hosting=_multiproc_hosting(nodes, args.procs), procs=args.procs,
        seed=args.seed,
        opt={"lr": 3e-3, "warmup_steps": 0, "weight_decay": 0.0},
        device=args.device, attn_impl=args.attn_impl, full=args.full)
    source = ByteCorpus(_TEXT * 50, seq_len=args.seq_len)
    disp = GlobalBatchDispenser(source)
    losses, divergences = [], []
    recovery = None
    with MultiHostExecutor(spec) as mh:
        engine = mh.engine
        print(f"[plan] procs={args.procs} hosting={mh.hosting} "
              f"pipelines={[i.template.num_nodes for i in engine.instances]}")
        t0 = time.perf_counter()
        mh.warm_templates()
        print(f"[warm] all workers warm in {time.perf_counter() - t0:.1f}s")
        for step in range(args.steps):
            if step == args.kill_at:
                victim = max(mh.procs)
                mh.kill_worker(victim)
                dead, ranks = mh.detected_dead(timeout=30.0)
                t0 = time.perf_counter()
                recovery = mh.recover(dead)
                bd = recovery["breakdown"]
                print(f"[fail] SIGKILL rank {victim} -> heartbeat detected "
                      f"{sorted(dead)} dead; recovered in "
                      f"{time.perf_counter() - t0:.2f}s (epoch "
                      f"{recovery['epoch']}, "
                      f"{recovery['fetched_bytes'] / 1e6:.1f}MB pulled "
                      f"cross-process in {recovery['fetches']} fetches, "
                      f"replan {bd['replan'] * 1e3:.0f}ms, commit "
                      f"{bd['commit'] * 1e3:.0f}ms)")
            batches = disp.next_step(engine.batch.minibatch_sizes())
            out = mh.step(
                [microbatches(b, args.microbatch) for b in batches])
            losses.append(float(out["loss"]))
            divergences.append(mh.replica_divergence())
            print(f"[step {step}] loss={losses[-1]:.4f} "
                  f"pipelines={out['num_pipelines']} "
                  f"divergence={divergences[-1]}")
        compiles = mh.compile_counts()
        print(f"[done] loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
              f"worker builds since warm: {compiles}")
    assert losses[-1] < losses[0], "training must reduce the loss"
    return {"losses": losses, "divergences": divergences,
            "recovery": recovery, "compiles": compiles}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt3-medium")
    ap.add_argument("--nodes", type=int, default=5)
    ap.add_argument("--f", type=int, default=1)
    ap.add_argument("--n0", type=int, default=2)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--pods", type=int, default=8,
                    help="nodes per pod for the recovery data plane "
                         "(intra-pod copies ride NVLink, cross-pod the NIC)")
    ap.add_argument("--kill-at", type=int, default=-1,
                    help="inject a node failure before this step")
    ap.add_argument("--join-at", type=int, default=-1)
    ap.add_argument("--recovery-policy", default="replan",
                    choices=["replan", "adapt", "auto"],
                    help="failure response: 'replan' reconfigures from "
                         "templates and copies state from replicas; "
                         "'adapt' re-routes the damaged replica's "
                         "microbatches to surviving peers (zero copy, zero "
                         "builds); 'auto' picks per event by predicted "
                         "downtime")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--codec", default="none",
                    choices=["none", "bf16", "int8"],
                    help="wire codec for cross-replica gradient sync")
    ap.add_argument("--eager", action="store_true",
                    help="walk the 1F1B schedule stage by stage (the "
                         "reference path) instead of the per-template "
                         "step programs")
    ap.add_argument("--no-warm", action="store_true",
                    help="skip building the programs of the template set")
    ap.add_argument("--attn-impl", default="naive",
                    choices=["naive", "blocked", "kernel", "auto"],
                    help="attention path for stage layers: 'naive' "
                         "materialises the [S, S] scores, 'blocked' is an "
                         "online softmax in plain ops, 'kernel' (and "
                         "'auto') the flash-attention kernels (their plain "
                         "versions with --device cpu)")
    ap.add_argument("--ssd-impl", default="chunked",
                    choices=["chunked", "scan", "kernel", "auto"],
                    help="SSD scan of SSM and hybrid blocks: 'chunked' "
                         "and 'scan' in plain ops, 'kernel' (and 'auto') "
                         "the SSD kernels (their plain versions with "
                         "--device cpu)")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--procs", type=int, default=0,
                    help="train through N worker processes (the "
                         "multi-process backend)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    if args.procs > 0:
        return run_multiproc(args)
    if args.eager and args.codec != "none":
        # the eager walker syncs on the per-layer path, which has no wire
        # codec; keep the engine's pricing and the [sync] line truthful
        print(f"[sync] --eager ignores --codec {args.codec}: the per-layer "
              f"reference path syncs uncompressed")
        args.codec = "none"
    device = resolve_device(args.device)
    if device.type == "cuda":
        strict_fp32_numerics()

    arch = get_arch(args.arch)
    if not args.full:
        arch = reduced(arch, layers=args.layers)
    model = Model(arch, dtype=torch.float32, attn_impl=args.attn_impl,
                  ssd_impl=args.ssd_impl)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = model.init(gen)

    profile = build_profile(arch, microbatch=args.microbatch,
                            seq_len=args.seq_len)
    nodes = [f"node{i}" for i in range(args.nodes)]
    engine = OobleckEngine(profile, nodes, EngineConfig(
        fault_tolerance=args.f, global_batch=args.global_batch,
        microbatch=args.microbatch, gpus_per_node=1, n0_override=args.n0,
        nodes_per_pod=args.pods, codec=args.codec,
        recovery_policy=args.recovery_policy))
    print(f"[plan] templates={list(engine.templates)} "
          f"pipelines={[i.template.num_nodes for i in engine.instances]} "
          f"microbatches={engine.batch.num_microbatches}")
    sched = engine.sync_schedule()
    print(f"[sync] {len(sched)} buckets, codec={args.codec}, "
          f"wire={sum(r.wire_bytes for r in sched) / 1e6:.1f}MB, "
          f"modeled exposed tail {engine._sync_tail_seconds() * 1e3:.2f}ms "
          f"on target hw")

    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=0, weight_decay=0.0)
    trainer = HeteroTrainer(model, engine, params, opt_cfg,
                            mode="eager" if args.eager else "compiled",
                            codec=args.codec)
    if not args.eager and not args.no_warm:
        t0 = time.perf_counter()
        stats = trainer.warm_templates()
        print(f"[warm] {stats['compiles']} programs compiled for "
              f"{len(engine.templates)} templates in "
              f"{time.perf_counter() - t0:.1f}s — any reconfiguration now "
              f"swaps programs by lookup")
    source = ByteCorpus(_TEXT * 50, seq_len=args.seq_len)
    disp = GlobalBatchDispenser(source)
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, num_layers=arch.num_layers)
        # the engine checkpoints through the trainer's snapshot on an
        # unrecoverable shrink (< (f+1)*n0 nodes), paper §3.4
        engine.on_checkpoint = lambda: mgr.save(
            trainer.snapshot(disp.state(), args.seed), block=True)

    losses, divergences, step_seconds, builds = [], [], [], []
    recovery = None
    for step in range(args.steps):
        if step == args.kill_at:
            victim = engine.instances[0].nodes[-1]
            builds_before = trainer.cache.stats.compiles
            t0 = time.perf_counter()
            info = trainer.recover({victim})
            wall = time.perf_counter() - t0
            recovery = {"victim": victim, "seconds": wall,
                        "policy": info["policy"],
                        "builds_before": builds_before,
                        "builds_after": trainer.cache.stats.compiles}
            if info["policy"] == "adapt":
                bd = info["breakdown"]
                print(f"[fail] killed {victim}: adapted schedule in "
                      f"{wall:.2f}s (zero state copied, re-routed "
                      f"microbatches to {info['num_pipelines']} surviving "
                      f"pipelines, parked {info['parked_nodes']} as spares, "
                      f"modeled reroute exposure {bd['reroute'] * 1e3:.1f}ms "
                      f"on target hw, program cache: {info['cache']})")
            else:
                xfer = info["transfer"]
                print(f"[fail] killed {victim}: recovered from replicas in "
                      f"{wall:.2f}s ({info['policy']}; "
                      f"copied {info['copied_bytes'] / 1e6:.0f}MB of state over "
                      f"{xfer['streams']} streams, "
                      f"{xfer['pod_local_fraction']:.0%} pod-local, modeled "
                      f"transfer {xfer['seconds'] * 1e3:.1f}ms on target hw, "
                      f"program cache: {info['cache']}), "
                      f"pipelines={[i.template.num_nodes for i in engine.instances]}")
        if step == args.join_at:
            raise SystemExit("--join-at: a join needs nodes to join; call "
                             "HeteroTrainer.join (repro_torch.runtime) as "
                             "chip_smoke.py's lifecycle phase does")
        batches = disp.next_step(engine.batch.minibatch_sizes())
        _sync(device)
        t0 = time.perf_counter()
        out = trainer.step([microbatches(b, args.microbatch) for b in batches])
        losses.append(float(out["loss"]))        # host sync at step edge
        _sync(device)
        step_seconds.append(time.perf_counter() - t0)
        builds.append(trainer.cache.stats.compiles)
        divergences.append(trainer.replica_divergence())
        print(f"[step {step}] loss={losses[-1]:.4f} "
              f"pipelines={out['num_pipelines']} "
              f"divergence={divergences[-1]:.2e}")
        if mgr and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            mgr.save(trainer.snapshot(disp.state(), args.seed))
    if mgr:
        mgr.wait()
    assert losses[-1] < losses[0], "training must reduce the loss"
    print(f"[done] loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(cache: {trainer.cache.stats.as_dict()})")
    return {"losses": losses, "divergences": divergences,
            "step_seconds": step_seconds, "builds_after_step": builds,
            "recovery": recovery, "cache": trainer.cache.stats.as_dict(),
            "checkpoints": mgr.list_steps() if mgr else []}


if __name__ == "__main__":
    main()
