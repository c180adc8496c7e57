#!/usr/bin/env python3
"""Time the port's CUDA kernel build both ways on a machine with nvcc:
one ``nvcc -c`` per source run one after another, and all started
together (what ``repro_torch.kernels.build`` does), each followed by the
link.  By default runs sequential, parallel, parallel, sequential into
scratch directories under ``build/kernels/`` and prints one JSON line per
build, with each source's compile seconds (in a parallel build: from the
common start until that nvcc ended).

    PYTHONPATH=src python3 tools/build_time.py [--tree DIR] [--order ...]

``--tree`` builds another checkout's ``src/repro_torch/kernels/csrc/*.cu``
(e.g. a ``git archive`` of the parent commit under ``build/``) with this
checkout's compiler flags, so two commits' builds can be compared.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

from repro_torch.kernels import build


def commands(csrc: pathlib.Path, tmp: str):
    """(one nvcc -c per source of ``csrc``, the link), as build.commands."""
    nvcc = build._nvcc()
    sources = sorted(csrc.glob("*.cu"))
    objs = [os.path.join(tmp, src.stem + ".o") for src in sources]
    return sources, [[nvcc, *build.NVCC_FLAGS, "-c", "-o", obj, str(src)]
                     for src, obj in zip(sources, objs)], \
        [nvcc, *build.ARCH_FLAGS, "-shared", "-o",
         os.path.join(tmp, "libkernels.so"), *objs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(build.ROOT),
                    help="checkout whose csrc/ is built (default: this one)")
    ap.add_argument("--order",
                    default="sequential,parallel,parallel,sequential")
    args = ap.parse_args(argv)
    csrc = pathlib.Path(args.tree).resolve() / "src/repro_torch/kernels/csrc"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for mode in args.order.split(","):
        with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
            sources, compile_cmds, link_cmd = commands(csrc, tmp)
            t0 = time.perf_counter()
            per_source = []
            if mode == "parallel":
                build.run_all(compile_cmds, per_source)
            else:
                for cmd in compile_cmds:
                    one = []
                    build.run_all([cmd], one)
                    per_source += one
            build.run_all([link_cmd])
            print(json.dumps({"tree": args.tree, "build": mode,
                              "sources": len(compile_cmds),
                              "seconds": time.perf_counter() - t0,
                              "compile_seconds": {
                                  src.name: round(sec, 1) for src, sec in
                                  zip(sources, per_source)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
