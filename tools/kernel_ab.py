#!/usr/bin/env python3
"""Time the port's CUDA kernels as built from several source trees, in
turns, in one process on one card.

    python3 tools/kernel_ab.py base=. other=/path/to/tree \
        --order base,other,other,base --kernels gemm_bias,flash_bwd_dkdv

Each tree's ``src/repro_torch/kernels/csrc/*.cu`` is compiled (the flags
of ``kernels/build.py``, one nvcc per source of that tree) into
``build/kernel_ab/<label>/libkernels.so`` and swapped in for this
checkout's library, so the trees' ``extern "C"`` launchers must take the
arguments this checkout's wrappers pass (a tree that changes a kernel's
body, not its interface), with one exception: a tree whose ``ssd_bwd``
takes no scratch pointer (before the three-phase SSD kernels) is called
with the wrapper's scratch argument dropped.  Per tree, each
kernel is first held against its plain version in fp32 (chip_smoke.py's
comparison), then timed with CUDA events at the shape of the path the
kernels line reports (the GEMM in its three layouts).  Prints the
card, each build's register / spill lines for the named kernels, and
one JSON line per turn: label, kernel, layout, milliseconds (and, with
``--phases``, each CUDA function's profiler device milliseconds).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def build_tree(label: str, tree: str) -> pathlib.Path:
    from repro_torch.kernels import build
    csrc = pathlib.Path(tree).resolve() / "src/repro_torch/kernels/csrc"
    out = ROOT / "build" / "kernel_ab" / label
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libkernels.so"
    cmds = [[build._nvcc(), *build.NVCC_FLAGS, "-c", "-o",
             str(out / (src.stem + ".o")), str(src)]
            for src in sorted(csrc.glob("*.cu"))]
    seconds = []
    log = build.run_all(cmds, seconds)
    per_source = {pathlib.Path(c[-1]).name: round(t, 1)
                  for c, t in zip(cmds, seconds)}
    print(f"[{label}] nvcc seconds per source: {per_source}", flush=True)
    log += build.run_all([[build._nvcc(), *build.ARCH_FLAGS, "-shared", "-o",
                           str(lib), *(c[-2] for c in cmds)]])
    (out / "nvcc.log").write_text(log)
    return lib


def takes_scratch(tree: str) -> bool:
    """Whether the tree's ssd_bwd launcher takes the scratch pointer."""
    src = (pathlib.Path(tree).resolve()
           / "src/repro_torch/kernels/csrc/ssd.cu").read_text()
    return "void* scratch" in src[src.index("int ssd_bwd("):]


class _NoScratch:
    """A library whose ssd_bwd takes no scratch: the wrapper's 14th
    pointer (the scratch) is dropped from its calls."""

    def __init__(self, cdll):
        self._cdll = cdll

    def __getattr__(self, name):
        fn = getattr(self._cdll, name)
        if name != "ssd_bwd":
            return fn
        return lambda *args: fn(*args[:13], *args[14:])


def load(lib: pathlib.Path, scratch: bool) -> None:
    from repro_torch.kernels import build
    cdll = ctypes.CDLL(str(lib))
    for name, argtypes in build.SIGNATURES.items():
        fn = getattr(cdll, name)
        if name == "ssd_bwd" and not scratch:
            argtypes = argtypes[:13] + argtypes[14:]
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    build._LIB = cdll if scratch else _NoScratch(cdll)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="label=path of a source tree")
    ap.add_argument("--order", required=True, help="comma-separated labels")
    ap.add_argument("--kernels", default="gemm_bias,flash_bwd_dkdv")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--phases", action="store_true",
                    help="also each CUDA function's profiler device time")
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.utils.device import strict_fp32_numerics
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    strict_fp32_numerics()
    print(cs.card_line(), flush=True)
    trees = dict(t.split("=", 1) for t in args.trees)
    kernels = args.kernels.split(",")
    libs = {}
    for label, tree in trees.items():
        libs[label] = build_tree(label, tree)
        summary = build.ptxas_summary((libs[label].parent / "nvcc.log")
                                      .read_text()).splitlines()
        for i, ln in enumerate(summary):
            if "Compiling entry" in ln and any(k in ln for k in kernels):
                name = ln.split("'")[1]
                for info in summary[i + 1:i + 3]:
                    print(f"[{label}] {name[:110]} | {info}")
    dev = torch.device("cuda")
    table = cs.kernel_table(dev)
    cases = []
    for name in kernels:
        shape = dict(cs._shapes(cs.CARD_SHAPES, name))[cs.reported_path(name)]
        for layout in (("fwd", "dx", "dW") if name == "gemm_bias" else ("fwd",)):
            cases.append((name, layout, cs.make_inputs(
                name, shape, torch.float32, dev, seed=2, layout=layout)))
    checked = set()
    for label in args.order.split(","):
        load(libs[label], takes_scratch(trees[label]))
        for name, layout, inputs in cases:
            kern, plain, _ = table[name]
            if label not in checked:
                cs.compare(name, kern, plain, inputs, torch.float32)
            ms = cs.time_ms(kern, inputs, dev, args.iters)
            row = {"run": label, "kernel": name, "layout": layout, "ms": ms}
            if args.phases:
                row["device_ms"] = cs.device_ms(kern, inputs, name,
                                                args.iters)[1]
            print(json.dumps(row), flush=True)
        checked.add(label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
