#!/usr/bin/env python3
"""Time the port's CUDA kernel build both ways on a machine with nvcc:
one ``nvcc -c`` per source run one after another, and all started
together (what ``repro_torch.kernels.build`` does), each followed by the
link.  Runs sequential, parallel, parallel, sequential into scratch
directories under ``build/kernels/`` and prints one JSON line per build.

    PYTHONPATH=src python3 tools/build_time.py
"""
from __future__ import annotations

import json
import sys
import tempfile
import time

from repro_torch.kernels import build


def main() -> int:
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for mode in ("sequential", "parallel", "parallel", "sequential"):
        with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
            compile_cmds, link_cmd = build.commands(tmp)
            t0 = time.perf_counter()
            if mode == "parallel":
                build.run_all(compile_cmds)
            else:
                for cmd in compile_cmds:
                    build.run_all([cmd])
            build.run_all([link_cmd])
            print(json.dumps({"build": mode, "sources": len(compile_cmds),
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
