"""Render the port's dry-run artifact (``launch/dryrun.py``) into the
reference's two tables (``repro/launch/report.py``) and an Errors list.
Every number in them is derived (a FakeTensor trace priced on the H100
``HardwareSpec``); none is a device time.

    PYTHONPATH=src python -m repro_torch.launch.report [artifacts/dryrun_torch.json]
"""
from __future__ import annotations

import json
import sys
from typing import Dict


def _gb(c: Dict) -> float:
    mem = c["memory"]
    return mem["args_gb"] + mem["temps_gb"]


def fmt_cell(c: Dict) -> str:
    r = c["roofline"]
    return (f"| {c['arch']} | {c['shape']} | {c.get('variant') or 'baseline'} "
            f"| {r['compute_s']:.4f} | {r['memory_s']:.4f} "
            f"| {r['collective_s']:.4f} | **{r['bottleneck']}** "
            f"| {r['model_flops_ratio']:.3f} | {_gb(c):.1f} "
            f"| {'yes' if c['fits_hbm'] else 'NO'} |")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "artifacts/dryrun_torch.json"
    with open(path) as f:
        cells = json.load(f)["cells"]
    ok = sorted((c for c in cells if c.get("status") == "ok"),
                key=lambda c: (c["arch"], c["shape"], c.get("variant") or ""))
    errs = [c for c in cells if c.get("status") != "ok"]

    print("### Single-pod (16x16 = 256 H100s) roofline, per step "
          "(derived: FakeTensor trace, H100 HardwareSpec; no device time)\n")
    print("| arch | shape | variant | compute (s) | memory (s) | "
          "collective (s) | bottleneck | useful FLOP frac | GB/card | "
          "fits 80 GB |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for c in ok:
        if c["mesh"] == "single":
            print(fmt_cell(c))

    print("\n### Multi-pod (2x16x16 = 512 H100s) fit (derived)\n")
    print("| arch | shape | variant | trace (s) | GB/card | fits 80 GB | "
          "collective bytes/card |")
    print("|---|---|---|---|---|---|---|")
    for c in ok:
        if c["mesh"] == "multi":
            print(f"| {c['arch']} | {c['shape']} "
                  f"| {c.get('variant') or 'baseline'} | {c['trace_s']} "
                  f"| {_gb(c):.1f} | {'yes' if c['fits_hbm'] else 'NO'} "
                  f"| {c['ops']['collective_bytes_per_dev'] / 1e9:.2f}GB |")
    if errs:
        print("\n### Errors\n")
        for c in errs:
            print(f"- `{c['key']}`: {c['status']}")


if __name__ == "__main__":
    main()
