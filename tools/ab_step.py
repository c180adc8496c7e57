#!/usr/bin/env python3
"""Step time of the port's training driver across source trees, each run
in a fresh process on the card, in the order given: ``parent,change,
change,parent`` compares two commits on one machine.

    python3 tools/ab_step.py parent=/path/to/parent change=. \
        --order parent,change,change,parent -- \
        --full --seq-len 512 --steps 4 --kill-at 2 --device cuda

Each run is ``repro_torch.launch.train.main(<args after -->)`` with
``<tree>/src`` first on the path and the tree as working directory.  A
label written ``<tree>+prof`` first runs one ``torch.profiler`` session
(CUDA activity) in the same process, as chip_smoke.py's timing phase
does before its training phases.  Prints one JSON line per run: the
step seconds (host clock around a step that ends in a synchronize) and
the mean of the steps after the first, and the losses (so that two trees
can be held to the same trajectory).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SNIPPET = """
import json, sys
sys.path.insert(0, {src!r})
import torch
if {prof}:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        (torch.ones(1 << 20, device="cuda") * 2).sum().item()
from repro_torch.launch import train
out = train.main(sys.argv[1:])
print("AB_STEPS " + json.dumps({{"steps": out["step_seconds"],
                                 "losses": out["losses"]}}))
"""


def run_one(tree: str, prof: bool, argv) -> dict:
    src = os.path.join(os.path.abspath(tree), "src")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", SNIPPET.format(src=src, prof=prof), *argv],
        cwd=tree, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"run in {tree} failed:\n{proc.stdout[-4000:]}"
                         f"\n{proc.stderr[-4000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB_STEPS ")]
    return json.loads(line[-1].split(" ", 1)[1])


def main(args=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="label=path of a checkout")
    ap.add_argument("--order", required=True,
                    help="comma-separated labels, each optionally +prof")
    argv = sys.argv[1:] if args is None else list(args)
    cut = argv.index("--") if "--" in argv else len(argv)
    args, train_argv = ap.parse_args(argv[:cut]), argv[cut + 1:]
    trees = dict(t.split("=", 1) for t in args.trees)
    for label in args.order.split(","):
        tree, _, mode = label.partition("+")
        out = run_one(trees[tree], mode == "prof", train_argv)
        steps = out["steps"]
        print(json.dumps({"run": label, "step_seconds": steps,
                          "mean_after_first": sum(steps[1:]) / len(steps[1:]),
                          "losses": out["losses"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
