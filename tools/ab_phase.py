#!/usr/bin/env python3
"""One ``chip_smoke.py`` training phase across source trees, each run in
a fresh process on the card, in the order given: ``parent,change,
change,parent`` compares two commits on one machine.

    python3 tools/ab_phase.py parent=/path/to/parent change=. \
        --order parent,change,change,parent --phase multiprocess

``--phase`` names a phase of the tree's own ``chip_smoke.py``: ``naive``
(6), ``flash`` (7), ``mamba`` (8), ``moe`` (10), ``lifecycle`` (9),
``serving`` (11), ``multiprocess`` (12), ``spmd`` (13), ``tp`` (18, on
phase 13's sequences) or ``bf16`` (20, on phase 13's sequences; each
run also waits for the phase's dry-run trace of four full-size models,
which ``chip_smoke.py`` overlaps with phases 3-19: ≈ 285 s a run on
the H100 machine's host, ≈ 6 min a run in all).  Each run builds the tree's
kernels (once per tree: the library is cached under its ``build/``),
runs the phase with that tree's ``src`` first on the path and prints
the phase's own lines, each prefixed with the run's label.

``--exact`` (phases 6-8 and 10) runs the phase's training command
itself (``repro_torch.launch.train`` with the tree's ``PATHS`` argv) and
prints each run's losses at full precision and its step seconds as one
JSON line, then whether every run's losses are bitwise equal.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SNIPPET = """
import sys
sys.path.insert(0, {src!r}); sys.path.insert(0, {tree!r})
import torch
import chip_smoke as cs
from repro_torch.kernels import build
from repro_torch.utils.device import strict_fp32_numerics
strict_fp32_numerics()
build.library()
dev = torch.device("cuda")
phase = {phase!r}
paths = {{"naive": (6, cs.FUSED), "flash": (7, cs.FUSED + cs.FLASH),
          "mamba": (8, cs.SSD), "moe": (10, cs.FUSED + cs.FLASH)}}
if {exact!r}:
    import gc, json
    from repro_torch.launch import train
    gc.collect()
    out = train.main(cs.PATHS[paths[phase][0]][1])
    print("[exact] " + json.dumps({{"losses": out["losses"],
                                    "step_seconds": out["step_seconds"]}}))
elif phase in paths:
    cs.run_path(dev, *paths[phase])
elif phase in ("tp", "bf16"):
    import numpy as np
    from repro_torch.data import ByteCorpus, GlobalBatchDispenser
    from repro_torch.launch.train import _TEXT
    seq = cs.SPMD["seq_len"]
    engine = cs.spmd_engine(cs.spmd_model(True)[0], seq)
    parts = GlobalBatchDispenser(ByteCorpus(_TEXT * 50, seq_len=seq)
                                 ).next_step(engine.batch.minibatch_sizes())
    getattr(cs, "run_" + phase)(dev, {{k: np.concatenate([b[k] for b in parts])
                                      for k in ("tokens", "labels")}})
else:
    getattr(cs, "run_" + phase)(dev)
"""


def main(args=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="label=path of a checkout")
    ap.add_argument("--order", required=True,
                    help="comma-separated labels")
    ap.add_argument("--phase", required=True,
                    choices=["naive", "flash", "mamba", "moe", "lifecycle",
                             "serving", "multiprocess", "spmd", "tp", "bf16"])
    ap.add_argument("--exact", action="store_true",
                    help="the training command's exact losses and steps")
    ns = ap.parse_args(args)
    trees = dict(t.split("=", 1) for t in ns.trees)
    losses = []
    for label in ns.order.split(","):
        tree = os.path.abspath(trees[label])
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run(
            [sys.executable, "-c", SNIPPET.format(
                src=os.path.join(tree, "src"), tree=tree, phase=ns.phase,
                exact=ns.exact)],
            cwd=tree, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"run in {tree} failed:\n{proc.stdout[-4000:]}"
                             f"\n{proc.stderr[-4000:]}")
        for line in proc.stdout.splitlines():
            if line.startswith("["):
                print(f"{label}: {line}", flush=True)
            if line.startswith("[exact] "):
                losses.append(json.loads(line[8:])["losses"])
    if ns.exact:
        print(f"[exact] losses bitwise equal across all "
              f"{len(losses)} runs: {all(l == losses[0] for l in losses)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
