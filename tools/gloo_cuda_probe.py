#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors, and what gloo moves on the
host between processes that share one card.

    python3 tools/gloo_cuda_probe.py [--ranks 4] [--mib 16 64]

Starts fresh interpreters (``subprocess``, never a fork of a CUDA
process) joined by a gloo process group on ``tcp://localhost``.  For
each collective the port's transport uses (``runtime/collectives.py``)
a world of two ranks tries it on CUDA tensors and checks the values (a
world of its own, since gloo may abort the process on a device
pointer).  Then a world of ``--ranks`` times the same collectives on
host tensors of ``--mib`` MiB per rank (the shapes FSDP's
gather-at-use, its reduce-scatter and the data-axis all-reduce give
them).  The last line is one JSON object: each collective's verdict
(``ok``, ``wrong values``, the exception, or the exit code of a world
gloo aborted) and the host seconds and bus rates.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_main(rank: int, world: int, port: int, mibs, op) -> None:
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    table = {}

    def probe(name, fn):
        try:
            table[name] = "ok" if fn() else "wrong values"
        except Exception as e:      # the probe's purpose: record refusals
            table[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
        dist.barrier()

    if op != "host":
        x = torch.full((8,), float(rank + 1), device=dev)
        total = float(sum(range(1, world + 1)))

        def all_reduce():
            t = x.clone()
            dist.all_reduce(t)
            return bool((t == total).all())

        def all_gather():
            outs = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(outs, x)
            return all(bool((o == r + 1).all()) for r, o in enumerate(outs))

        def all_gather_into_tensor():
            out = torch.empty(8 * world, device=dev)
            dist.all_gather_into_tensor(out, x)
            return bool((out.view(world, 8)[:, 0].cpu()
                         == torch.arange(1, world + 1).float()).all())

        def reduce_scatter_tensor():
            out = torch.empty(2, device=dev)
            dist.reduce_scatter_tensor(out, torch.ones(2 * world, device=dev))
            return bool((out == world).all())

        def broadcast():
            t = x.clone()
            dist.broadcast(t, 0)
            return bool((t == 1).all())

        def send_recv():
            t = x.clone()
            if rank == 0:
                dist.send(t, 1)
                return True
            if rank == 1:
                dist.recv(t, 0)
                return bool((t == 1).all())
            return True

        def gather():
            outs = ([torch.empty_like(x) for _ in range(world)]
                    if rank == 0 else None)
            dist.gather(x, outs, dst=0)
            return rank != 0 or all(bool((o == r + 1).all())
                                    for r, o in enumerate(outs))

        probe(op, locals()[op])
        if rank == 0:
            print(json.dumps(table))
        dist.destroy_process_group()
        return

    host = {}
    for mib in mibs:
        n = mib * 2**20 // 4
        t = torch.randn(n)
        outs = [torch.empty(n) for _ in range(world)]
        big = torch.randn(n * world)
        shard = torch.empty(n)
        row = {}
        for name, fn in (("all_reduce", lambda: dist.all_reduce(t)),
                         ("all_gather", lambda: dist.all_gather(outs, t)),
                         ("reduce_scatter",
                          lambda: dist.reduce_scatter_tensor(shard, big))):
            fn()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            dist.barrier()
            s = (time.perf_counter() - t0) / 3
            # bus bytes a rank moves: ring all-reduce 2(n-1)/n of the
            # buffer, all-gather and reduce-scatter (n-1)/n of the whole
            nbytes = (2 * (world - 1) / world * t.numel() * 4
                      if name == "all_reduce"
                      else (world - 1) * t.numel() * 4)
            row[name] = {"s": s, "bus_GBps": nbytes / s / 1e9}
        host[f"{mib}MiB"] = row
    if rank == 0:
        print(json.dumps(host))
    dist.destroy_process_group()


OPS = ("all_reduce", "all_gather", "all_gather_into_tensor",
       "reduce_scatter_tensor", "broadcast", "send_recv", "gather")


def world(op: str, ranks: int, mibs) -> tuple:
    """(exit code of the worst rank, rank 0's last stdout line)."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--ranks", str(ranks), "--port", str(port), "--op", op, "--mib",
         *map(str, mibs)], stdout=subprocess.PIPE, text=True)
        for r in range(ranks)]
    try:
        out = procs[0].communicate(timeout=600)[0]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and any(p.poll() is None
                                                  for p in procs):
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    lines = out.strip().splitlines()
    return max(codes, key=abs), (lines[-1] if lines else "")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--mib", type=int, nargs="+", default=[16, 64])
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--op", default="host")
    a = ap.parse_args()
    if a.rank is not None:
        rank_main(a.rank, a.ranks, a.port, a.mib, a.op)
        return 0
    import torch
    table = {}
    if torch.cuda.is_available():
        for op in OPS:
            code, line = world(op, 2, a.mib)
            table[op] = (json.loads(line)[op] if code == 0 and line
                         else f"world exited {code}")
            print(f"[probe] {op}: {table[op]}", flush=True)
    code, line = world("host", a.ranks, a.mib)
    if code != 0:
        return code
    print(json.dumps({"torch": torch.__version__, "cuda_tensors": table,
                      "host": json.loads(line), "ranks": a.ranks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
