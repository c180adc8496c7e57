#!/usr/bin/env python3
"""The mamba path's loss trajectory through the SSD kernels against the
same run through the chunked scan in plain PyTorch ops, on the card.

    python3 tools/ssd_parity.py --layers 8 --steps 5 --kill-at 2

Both runs are ``repro_torch.launch.train.main`` for mamba2-780m at full
width (d 1536, SSD heads 48 x 64, state 128, vocab 50280), sequence 2048,
microbatch 1, the same seed and the same node failure; only
``--ssd-impl`` differs (``kernel`` against ``chunked``).  The depth is
cut to ``--layers`` because the chunked scan keeps every chunk's [Q, Q]
terms for its backward.  Prints both trajectories and their largest
relative difference, and exits non-zero above ``--rtol``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--kill-at", type=int, default=2)
    ap.add_argument("--rtol", type=float, default=1e-3)
    args = ap.parse_args(argv)
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    cut = dataclasses.replace(get_arch("mamba2_780m"), num_layers=args.layers)
    train.get_arch = lambda name: cut
    losses = {}
    for impl in ("kernel", "chunked"):
        out = train.main(["--arch", "mamba2-780m", "--full", "--seq-len",
                          "2048", "--microbatch", "1", "--ssd-impl", impl,
                          "--steps", str(args.steps), "--kill-at",
                          str(args.kill_at), "--device", "cuda"])
        losses[impl] = out["losses"]
        torch.cuda.empty_cache()
    worst = max(abs(a - b) / abs(b)
                for a, b in zip(losses["kernel"], losses["chunked"]))
    print(json.dumps({"layers": args.layers, "losses": losses,
                      "max_rel_diff": worst,
                      "device": torch.cuda.get_device_name(0)}))
    return 0 if worst <= args.rtol else 1


if __name__ == "__main__":
    sys.exit(main())
