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
body, not its interface), with two exceptions: a tree whose ``ssd_bwd``
takes no scratch pointer (before the three-phase SSD kernels) is called
with the wrapper's scratch argument dropped, and a tree whose
``add_rmsnorm_bwd`` takes no ``dw`` pointer (before the one-pass norm
backward) runs under that tree's own wrapper: 8 rows a block and the
partial rows summed by ``torch.sum``; and a tree whose flash launchers
take no tile (before the autotuner) is called with the tile argument
dropped, its 64-row tile only; and a tree whose flash launchers take one
sequence length (before Sq <= Sk) is called with the key length dropped,
at Sq == Sk only; and a tree with no wgmma instance of a kernel
(before ``csrc/gemm_wgmma.cu`` and ``csrc/flash_wgmma.cu`` for the bf16
QKV GEMM and flash forward, before ``csrc/flash_bwd_wgmma.cu`` for dq
and dk/dv) has that kernel called in bf16 through ``build.launch`` on
its mma.sync launcher, 16-byte copies at the tiles its own packaged
table names (this checkout's wrappers send such calls to the wgmma
launchers), while a tree that has the instance runs it through the
wrapper (each tree resolves its tiles from its own
``autotune_offline.json``); and a tree without ``csrc/ssd_wgmma.cu``
has its SSD kernels called, in both dtypes, through ``build.launch`` on
ssd.cu's launchers, so ``--kernels ssd_fwd,ssd_bwd --labels mamba,20b
--dtypes float32,bfloat16 --phases`` times the parent's SSD instances
against the instances this checkout's wrappers pick (bf16: the wgmma
ones), each with its per-phase split and the instance it ran.  Per
tree, each kernel is first
held against its plain version (chip_smoke.py's comparison), then timed
with CUDA events, at the shape of the path the kernels line reports
(``--labels`` names others of chip_smoke.py's shapes; the GEMM in its
three layouts) in fp32 (``--dtypes`` adds bfloat16).  Prints the card,
each build's register / spill lines for the named kernels, and one JSON
line per turn: label, kernel, layout, shape label, dtype, milliseconds
(and, with ``--phases``, each CUDA function's profiler device
milliseconds).  ``--bitwise`` also holds every tree's outputs equal, bit
for bit, to the first tree's in ``--order`` on the same inputs.
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


def takes_tile(tree: str) -> bool:
    """Whether the tree's flash launchers take the tile."""
    src = (pathlib.Path(tree).resolve()
           / "src/repro_torch/kernels/csrc/flash.cu").read_text()
    head = src[src.index("int flash_fwd("):]
    return "int tile" in head[:head.index(")")]


def takes_sk(tree: str) -> bool:
    """Whether the tree's flash launchers take the key length Sk."""
    src = (pathlib.Path(tree).resolve()
           / "src/repro_torch/kernels/csrc/flash.cu").read_text()
    head = src[src.index("int flash_fwd("):]
    return "int Sk" in head[:head.index(")")]


_FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")
#: the index of Sk in each flash launcher's arguments: after its
#: pointers, B and Sq
_SK_AT = {"flash_fwd": 7, "flash_bwd_dq": 9, "flash_bwd_dkdv": 10}


class _Compat:
    """An older library under this checkout's wrappers: an ssd_bwd with
    no scratch gets the wrapper's 14th pointer (the scratch) dropped,
    flash launchers with no tile the argument before the dtype (only the
    64-row tile, which they had), flash launchers with one sequence
    length the key length (only Sq == Sk, which they had)."""

    def __init__(self, cdll, scratch: bool, tile: bool, sk: bool = True):
        self._cdll, self._scratch, self._tile = cdll, scratch, tile
        self._sk = sk

    def __getattr__(self, name):
        fn = getattr(self._cdll, name)
        if name == "ssd_bwd" and not self._scratch:
            return lambda *args: fn(*args[:13], *args[14:])
        if name in _FLASH and not (self._tile and self._sk):
            at = _SK_AT[name]

            def call(*args):
                if not self._sk:
                    if args[at] != args[at - 1]:
                        raise ValueError(f"{name}: this tree takes Sq == "
                                         f"Sk only")
                    args = args[:at] + args[at + 1:]
                if not self._tile:
                    if args[-3] != 64:
                        raise ValueError(f"{name}: this tree has only the "
                                         f"64-row tile, not {args[-3]}")
                    args = args[:-3] + args[-2:]
                return fn(*args)
            return call
        return fn


def one_pass_norm(tree: str) -> bool:
    """Whether the tree's add_rmsnorm_bwd launcher takes the dw pointer."""
    src = (pathlib.Path(tree).resolve()
           / "src/repro_torch/kernels/csrc/fused.cu").read_text()
    head = src[src.index("int add_rmsnorm_bwd("):]
    return "void* dw," in head[:head.index(")")]


#: the add_rmsnorm_bwd launcher before the one-pass kernel: res, w, gres,
#: gh, dres, the partial rows, M, d, rows per block, eps, dtype, stream
_TWO_PASS_NORM = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 3
                  + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))


def two_pass_norm_bwd(res, w, gres, gh, eps):
    """The wrapper of a tree whose norm backward writes one partial row
    per 8 rows and leaves their sum to PyTorch."""
    import torch
    from repro_torch.kernels import build
    code = build.check_tensors("add_rmsnorm_bwd", res, w, gres, gh)
    M, d = res.shape
    dres = torch.empty_like(res)
    partials = torch.empty((-(-M // 8), d), dtype=torch.float32,
                           device=res.device)
    build.launch("add_rmsnorm_bwd", res.data_ptr(), w.data_ptr(),
                 gres.data_ptr(), gh.data_ptr(), dres.data_ptr(),
                 partials.data_ptr(), M, d, 8, float(eps), code,
                 build.current_stream(res))
    return dres, partials.sum(0).to(w.dtype)


def load(lib: pathlib.Path, scratch: bool, norm_bwd, tile: bool = True,
         sk: bool = True) -> None:
    """Swap in ``lib``; ``norm_bwd`` becomes ``fused.add_rmsnorm_bwd``
    (this checkout's wrapper, or ``two_pass_norm_bwd``)."""
    from repro_torch.kernels import build, fused
    cdll = ctypes.CDLL(str(lib))
    for name, argtypes in build.SIGNATURES.items():
        if not hasattr(cdll, name):
            continue              # a launcher the tree does not have
        fn = getattr(cdll, name)
        if name == "ssd_bwd" and not scratch:
            argtypes = argtypes[:13] + argtypes[14:]
        if name in _FLASH and not sk:
            argtypes = argtypes[:_SK_AT[name]] + argtypes[_SK_AT[name] + 1:]
        if name in _FLASH and not tile:
            argtypes = argtypes[:-3] + argtypes[-2:]
        if name == "add_rmsnorm_bwd" and norm_bwd is two_pass_norm_bwd:
            argtypes = _TWO_PASS_NORM
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    build._LIB = (cdll if scratch and tile and sk
                  else _Compat(cdll, scratch, tile, sk))
    fused.add_rmsnorm_bwd = norm_bwd


def has_wgmma(tree: str, name: str) -> bool:
    """Whether the tree has the wgmma instance of kernel ``name`` (the
    bf16 QKV GEMM and flash forward: gemm_wgmma.cu; dq and dk/dv:
    flash_bwd_wgmma.cu; the SSD pair: ssd_wgmma.cu)."""
    source = ("flash_bwd_wgmma.cu" if name.startswith("flash_bwd")
              else "ssd_wgmma.cu" if name.startswith("ssd")
              else "gemm_wgmma.cu")
    return (pathlib.Path(tree).resolve()
            / "src/repro_torch/kernels/csrc" / source).exists()


def use_table(tree: str) -> None:
    """Resolve tiles from the tree's packaged autotune table."""
    from repro_torch.kernels import autotune
    path = (pathlib.Path(tree).resolve()
            / "src/repro_torch/kernels/autotune_offline.json")
    autotune._PACKAGED = {k: {a: int(b) for a, b in v.items()}
                          for k, v in json.loads(path.read_text()).items()}


def kernel_of(cs, table, name, dtype, wgmma: bool):
    """The callable that times kernel ``name`` of a tree in ``dtype``:
    the wrapper, except for a bf16 kernel whose wgmma instance the tree
    does not have (``wgmma`` False): its mma.sync launcher called
    directly (``mma_bf16``)."""
    import torch
    if name in cs.SSD and not wgmma:
        return mma_ssd(name)
    if dtype != torch.bfloat16 or name not in cs.WGMMA.values() or wgmma:
        return table[name][0]
    return mma_bf16(name)


def mma_ssd(name: str):
    """``ssd_fwd`` or ``ssd_bwd`` of a tree with no wgmma instance of the
    SSD: ssd.cu's launcher at the call's chunk (the tree's packaged
    table), in either dtype."""
    import torch
    from repro_torch.kernels import build, ssd

    def strides(t):
        return t.stride(0), t.stride(1), t.stride(2)

    def forward(x, dt, A, B, C):
        b, S, H, P = x.shape
        N, chunk = B.shape[-1], ssd.resolve_chunk(x, B)
        nc = -(-S // chunk)
        y = torch.empty_like(x)
        st = torch.empty((b, H, P, N), device=x.device)
        cst = torch.empty((b, H, nc, P, N), device=x.device)
        build.launch("ssd_fwd", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                     B.data_ptr(), C.data_ptr(), y.data_ptr(), st.data_ptr(),
                     cst.data_ptr(), b, S, H, P, N, chunk, *strides(x),
                     *strides(dt), *strides(B), *strides(C),
                     build.check_tensors("ssd_fwd", x, B, C),
                     build.current_stream(x))
        return y, st, cst

    def backward(x, dt, A, B, C, cst, gy, gstate):
        b, S, H, P = x.shape
        N, chunk = B.shape[-1], ssd.resolve_chunk(x, B)
        nc = -(-S // chunk)
        dx = torch.empty_like(x)
        ddt = torch.empty((b, S, H), device=x.device)
        dB, dC = (torch.empty((b, S, H, N), dtype=B.dtype, device=x.device)
                  for _ in range(2))
        dA = torch.empty((b, H, nc), device=x.device)
        scratch = torch.empty((b, H, nc, P, N), device=x.device)
        build.launch("ssd_bwd", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                     B.data_ptr(), C.data_ptr(), cst.data_ptr(),
                     gy.data_ptr(), gstate.data_ptr(), dx.data_ptr(),
                     ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                     dA.data_ptr(), scratch.data_ptr(), b, S, H, P, N, chunk,
                     *strides(x), *strides(dt), *strides(B), *strides(C),
                     *strides(gy), build.check_tensors("ssd_bwd", x, B, C, gy),
                     build.current_stream(x))
        return dx, ddt, dA.sum((0, 2)), dB, dC
    return forward if name == "ssd_fwd" else backward


def mma_bf16(name: str):
    """The bf16 ``gemm_bias`` (a, b, bias), ``flash_fwd`` (q, k, v,
    window), ``flash_bwd_dq`` or ``flash_bwd_dkdv`` (q, k, v, dO, lse,
    delta, window) of a tree with no wgmma instance of it: its launcher
    with 16-byte copies, at the (tile, split) or q / kv tile of the
    tree's packaged table (``use_table``)."""
    import math
    import torch
    from repro_torch.kernels import autotune, build, flash, fused

    def gemm(a, b, bias):
        (M, K), N = a.shape, b.shape[1]
        a_k, b_k = a.stride(1) == 1, b.stride(0) == 1 and b.stride(1) != 1
        cfg = autotune.gemm_config_of(autotune.backend_of(a.device), a.dtype,
                                      M, N, K, autotune.gemm_layout(a_k, b_k))
        splits = cfg["splits"]
        c = torch.empty((M, N), dtype=a.dtype, device=a.device)
        ws = (torch.empty((splits, M, N), dtype=torch.float32,
                          device=a.device) if splits > 1 else None)
        tensors = (a, b) if bias is None else (a, b, bias)
        build.launch("gemm_bias", a.data_ptr(), b.data_ptr(),
                     None if bias is None else bias.data_ptr(), c.data_ptr(),
                     None if ws is None else ws.data_ptr(), M, N, K,
                     *a.stride(), *b.stride(), cfg["block_rows"],
                     cfg["block_cols"], splits, fused.gemm_kchunk(K, splits),
                     int(a_k), int(b_k), 1,
                     build.check_tensors("gemm_bias", *tensors),
                     build.current_stream(a))
        return c

    def forward(q, k, v, window):
        (B, Sq, H, D), (Sk, KV) = q.shape, k.shape[1:3]
        out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        build.launch("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), B, Sq, Sk, H, KV, D,
                     window, 1.0 / math.sqrt(D), *flash._strides(q),
                     *flash._strides(k), *flash._strides(v),
                     flash.resolve_tiles(q)[0],
                     build.check_tensors("flash_fwd", q, k, v),
                     build.current_stream(q))
        return out, lse

    def backward(q, k, v, g, lse, delta, window):
        (B, Sq, H, D), (Sk, KV) = q.shape, k.shape[1:3]
        dq = name == "flash_bwd_dq"
        outs = ([torch.empty_like(q)] if dq
                else [torch.empty_like(k), torch.empty_like(v)])
        build.launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     *(t.data_ptr() for t in outs), B, Sq, Sk, H, KV, D,
                     window, 1.0 / math.sqrt(D), *flash._strides(q),
                     *flash._strides(k), *flash._strides(v),
                     *flash._strides(g), flash.resolve_tiles(q)[0 if dq else 1],
                     build.check_tensors(name, q, k, v, g),
                     build.current_stream(q))
        return outs[0] if dq else tuple(outs)
    return {"gemm_bias": gemm, "flash_fwd": forward}.get(name, backward)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="label=path of a source tree")
    ap.add_argument("--order", required=True, help="comma-separated labels")
    ap.add_argument("--kernels", default="gemm_bias,flash_bwd_dkdv")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--phases", action="store_true",
                    help="also each CUDA function's profiler device time")
    ap.add_argument("--labels", default=None,
                    help="comma-separated shape labels of chip_smoke.py "
                         "(default: the reported path's)")
    ap.add_argument("--dtypes", default="float32",
                    help="comma-separated: float32, bfloat16")
    ap.add_argument("--bitwise", action="store_true",
                    help="hold every tree's outputs bitwise equal to the "
                         "first's")
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, fused
    from repro_torch.utils.device import strict_fp32_numerics
    one_pass_norm_bwd = fused.add_rmsnorm_bwd
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
        shapes = dict(cs._shapes(cs.CARD_SHAPES, name))
        for shape_label in (args.labels.split(",") if args.labels
                            else [cs.reported_path(name)]):
            for dtype in args.dtypes.split(","):
                dt = getattr(torch, dtype)
                for layout in (("fwd", "dx", "dW") if name == "gemm_bias"
                               else ("fwd",)):
                    cases.append((name, layout, shape_label, dt,
                                  cs.make_inputs(name, shapes[shape_label],
                                                 dt, dev, seed=2,
                                                 layout=layout,
                                                 draw_on_device=shape_label
                                                 in cs.P20_LABELS)))
    checked, first = set(), {}
    for label in args.order.split(","):
        load(libs[label], takes_scratch(trees[label]),
             one_pass_norm_bwd if one_pass_norm(trees[label])
             else two_pass_norm_bwd, takes_tile(trees[label]),
             takes_sk(trees[label]))
        use_table(trees[label])
        for i, (name, layout, shape_label, dtype, inputs) in enumerate(cases):
            plain = table[name][1]
            kern = kernel_of(cs, table, name, dtype,
                             has_wgmma(trees[label], name))
            if label not in checked:
                cs.compare(name, kern, plain, inputs, dtype)
            if args.bitwise:
                outs = cs._flat(kern(*inputs))
                first.setdefault(i, (label, outs))
                same = all(torch.equal(a, b)
                           for a, b in zip(outs, first[i][1]))
                print(json.dumps({"run": label, "kernel": name,
                                  "layout": layout, "shape": shape_label,
                                  "dtype": str(dtype)[6:],
                                  "bitwise_as": first[i][0],
                                  "equal": same}), flush=True)
                if not same:
                    raise SystemExit(f"{name} {layout} {shape_label} "
                                     f"{dtype}: {label} differs from "
                                     f"{first[i][0]}")
            ms = cs.time_ms(kern, inputs, dev, args.iters)
            row = {"run": label, "kernel": name, "layout": layout,
                   "shape": shape_label, "dtype": str(dtype)[6:], "ms": ms}
            if args.phases:
                row["device_ms"] = cs.device_ms(kern, inputs, name,
                                                args.iters)[1]
            if name in cs.SSD:
                row["instance"] = (
                    "wgmma" if has_wgmma(trees[label], name)
                    and cs.takes_wgmma(name, inputs) else "mma.sync")
            elif dtype == torch.bfloat16 and name in cs.WGMMA.values():
                row["instance"] = ("wgmma" if has_wgmma(trees[label], name)
                                   else "mma.sync")
            print(json.dumps(row), flush=True)
        checked.add(label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
