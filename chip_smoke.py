#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (time,
     and nvcc's register / spill summary);
  3. every kernel against its plain PyTorch version at the main path's
     shapes and at ragged ones, in fp32 and bf16, the GEMM in all three
     operand layouts, and twice on the same inputs (bitwise equal);
  4. each kernel's time (CUDA events), its bound, its plain version's
     time and the one-call library equivalent where there is one;
  5. a small model with the kernels against the same model on plain
     PyTorch ops (loss and gradients);
  6. the main path: ``repro_torch.launch.train`` at gpt3-medium's full
     width and depth (24 layers, d 1024, vocab 50257), 4 steps with a
     node killed before step 2, asserting finite, decreasing losses,
     zero replica divergence, zero program builds across the failure and
     that every kernel's launch counter grew during the run.
The last lines are the card line, a ``{"kernels": [...]}`` JSON line and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the repository beside it, it exits non-zero and prints no result.

``run(device="cpu")`` rehearses the same control flow on the CPU, with
the plain versions standing in for the kernels (the tests do this).
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of bytes / memory rate and operations / peak.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.float32": 67e12, "torch.bfloat16": 989e12}

MAIN_ARGV = ["--full", "--seq-len", "512", "--steps", "4", "--kill-at", "2",
             "--device", "cuda"]
REHEARSAL_ARGV = ["--steps", "3", "--kill-at", "1", "--device", "cpu"]

KERNELS = {
    "add_rmsnorm_fwd": "src/repro/kernels/fused.py:47",
    "add_rmsnorm_bwd": "src/repro/kernels/fused.py:57",
    "gemm_bias": "src/repro/kernels/fused.py:167",
}
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/fused.cu"


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ----------------------------------------------------------------------
# Kernels, their plain versions, and how each is compared
# ----------------------------------------------------------------------
def kernel_table(device):
    """name -> (kernel, plain, library or None), all on the same inputs.
    On the CPU (rehearsal) the plain versions stand in for the kernels."""
    import torch
    from repro_torch.kernels import ref
    plain = {
        "add_rmsnorm_fwd": lambda x, r, w: ref.add_rmsnorm_ref(x, r, w, eps=1e-6),
        "add_rmsnorm_bwd": lambda res, w, gres, gh: ref.add_rmsnorm_bwd_ref(
            res, w, gres, gh, eps=1e-6),
        "gemm_bias": ref.matmul_bias_ref,
    }
    library = {"gemm_bias": lambda a, b, bias: torch.addmm(bias, a, b)}
    if device.type == "cpu":
        kern = plain
    else:
        from repro_torch.kernels import fused
        kern = {
            "add_rmsnorm_fwd": lambda x, r, w: fused.add_rmsnorm_fwd(x, r, w, 1e-6),
            "add_rmsnorm_bwd": lambda res, w, gres, gh: fused.add_rmsnorm_bwd(
                res, w, gres, gh, 1e-6),
            "gemm_bias": fused.gemm_bias,
        }
    return {k: (kern[k], plain[k], library.get(k)) for k in KERNELS}


def make_inputs(name, shape, dtype, device, seed, layout="fwd"):
    """Inputs for one kernel call.  Norms: shape = (M, d).  GEMM: shape =
    (M, K, N) of the forward x[M,K].W[K,N]; ``layout`` picks the product
    the fused QKV runs: fwd x.W+b, dx g.W^T (W read transposed), dW
    x^T.g (x read transposed)."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)

    def randn(*s, scale=1.0):
        return (torch.randn(s, generator=g) * scale).to(device=device, dtype=dtype)
    if name == "add_rmsnorm_fwd":
        M, d = shape
        return (randn(M, d), randn(M, d), randn(d, scale=0.2) + 1.0)
    if name == "add_rmsnorm_bwd":
        M, d = shape
        return (randn(M, d), randn(d, scale=0.2) + 1.0, randn(M, d), randn(M, d))
    M, K, N = shape
    x, w = randn(M, K), randn(K, N, scale=K ** -0.5)
    if layout == "fwd":
        return (x, w, randn(N))
    if layout == "dx":
        return (randn(M, N), w.t(), None)
    return (x.t(), randn(M, N), None)


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _scales(name, args, want):
    """Per output, the magnitude each element's error is measured
    against.  Elementwise outputs: the value itself.  The norm weight
    gradient is a sum over M rows, so its rounding error scales with the
    sum of the terms' magnitudes, sum_rows |gh * n|, not with the
    (possibly much smaller) result: it gets that condition-aware scale."""
    scales = [b.float().abs() for b in want]
    if name == "add_rmsnorm_bwd":
        res, _, _, gh = (t.float() for t in args)
        n = res * (res.square().mean(-1, keepdim=True) + 1e-6).rsqrt()
        scales[1] = (gh.abs() * n.abs()).sum(0)
    return scales


def compare(name, kern, plain, args, dtype, tol):
    import torch
    got, want = _flat(kern(*args)), _flat(plain(*args))
    err = 0.0
    for i, (a, b, scale) in enumerate(zip(got, want, _scales(name, args, want))):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{name}[{i}]: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        check(torch.isfinite(a.float()).all().item(), f"{name}[{i}]: non-finite")
        diff = (a.float() - b.float()).abs()
        bad = diff > tol["atol"] + tol["rtol"] * scale
        check(not bad.any().item(),
              f"{name}[{i}] {dtype}: {int(bad.sum())} of {bad.numel()} "
              f"elements off, max abs err {float(diff.max()):.3e} (tol {tol})")
        err = max(err, float(diff.max()))
    again = _flat(kern(*args))
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{name} {dtype}: two runs on the same inputs differ")
    return err


def check_kernels(device, table, main_shapes, ragged_shapes):
    """Phase 3.  Returns name -> max abs error at the main path's shape
    in fp32."""
    import torch
    tols = {torch.float32: {"gemm_bias": dict(rtol=1e-4, atol=1e-4),
                            "norm": dict(rtol=1e-5, atol=1e-6)},
            torch.bfloat16: {"gemm_bias": dict(rtol=2e-2, atol=2e-2),
                             "norm": dict(rtol=2e-2, atol=2e-2)}}
    errors = {}
    for name, (kern, plain, _) in table.items():
        layouts = ("fwd", "dx", "dW") if name == "gemm_bias" else ("fwd",)
        for dtype in (torch.float32, torch.bfloat16):
            tol = tols[dtype]["gemm_bias" if name == "gemm_bias" else "norm"]
            for label, shape in (("main", main_shapes[name]),
                                 ("ragged", ragged_shapes[name])):
                for layout in layouts:
                    args = make_inputs(name, shape, dtype, device, seed=1,
                                       layout=layout)
                    err = compare(name, kern, plain, args, dtype, tol)
                    print(f"[check] {name:16s} {layout:3s} {label:6s} "
                          f"{str(dtype)[6:]:8s} shape={shape} "
                          f"max_abs_err={err:.3e} deterministic=yes")
                    if dtype == torch.float32 and label == "main":
                        errors[name] = max(errors.get(name, 0.0), err)
    return errors


# ----------------------------------------------------------------------
# Timing and bounds
# ----------------------------------------------------------------------
def time_ms(fn, args, device, iters):
    """Mean milliseconds per call: CUDA events around ``iters`` calls
    after a warm-up on the card; the host clock on the CPU rehearsal."""
    import torch
    for _ in range(3):
        fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) * 1e3 / iters


def bound(name, shape, dtype):
    """(ms, 'bytes' | 'operations'): each input read once, each output
    written once, over 3.35 TB/s; operations over the type's peak."""
    import torch
    s = torch.tensor([], dtype=dtype).element_size()
    if name == "add_rmsnorm_fwd":
        M, d = shape
        nbytes, ops = (4 * M * d + d) * s, 6 * M * d        # x, r in; res, h out
    elif name == "add_rmsnorm_bwd":
        M, d = shape
        nbytes, ops = (4 * M * d + d) * s + 4 * d, 12 * M * d
    else:
        M, K, N = shape
        nbytes, ops = (M * K + K * N + M * N + N) * s, 2 * M * N * K
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(device, table, main_shapes, iters):
    """Phase 4, fp32 at the main path's shapes (the main path's dtype)."""
    import torch
    rows = {}
    for name, (kern, plain, lib) in table.items():
        shape = main_shapes[name]
        args = make_inputs(name, shape, torch.float32, device, seed=2)
        ms = time_ms(kern, args, device, iters)
        plain_ms = time_ms(plain, args, device, iters)
        lib_ms = time_ms(lib, args, device, iters) if lib is not None else None
        bms, by = bound(name, shape, torch.float32)
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bms, "bound_by": by}
        print(f"[time] {name:16s} fwd shape={shape} fp32: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, library "
              f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
              f"bound {bms:.4f} ms ({by})")
        if name == "gemm_bias":
            for layout in ("dx", "dW"):
                a = make_inputs(name, shape, torch.float32, device, seed=2,
                                layout=layout)
                sh = ((shape[0], shape[2], shape[1]) if layout == "dx"
                      else (shape[1], shape[0], shape[2]))
                kms = time_ms(kern, a, device, iters)
                pms = time_ms(plain, a, device, iters)
                lms = time_ms(torch.matmul, a[:2], device, iters)
                bl, byl = bound(name, sh, torch.float32)
                print(f"[time] {name:16s} {layout:3s} shape={sh} fp32: kernel "
                      f"{kms:.4f} ms, plain {pms:.4f} ms, library {lms:.4f} ms, "
                      f"bound {bl:.4f} ms ({byl})")
    return rows


# ----------------------------------------------------------------------
# End-to-end agreement on a small model, then the main path
# ----------------------------------------------------------------------
def check_small_model(device):
    """Phase 5: the same small model and batch through the fused path
    (the kernels, on the card) and the unfused path (plain ops)."""
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import Model
    from repro_torch.utils.tree import tree_leaves, tree_unflatten_like
    arch = reduced(get_arch("gpt3_medium"), layers=2, d_model=128, vocab=512)
    g = torch.Generator(device="cpu").manual_seed(3)
    tokens = torch.randint(0, arch.vocab_size, (2, 64), generator=g).to(device)
    labels = torch.randint(0, arch.vocab_size, (2, 64), generator=g).to(device)
    batch = {"tokens": tokens, "labels": labels}
    gen = torch.Generator(device=device).manual_seed(0)
    params = Model(arch, dtype=torch.float32).init(gen)
    out = {}
    for fuse in ("fused", "none"):
        m = Model(arch, dtype=torch.float32, attn_impl="naive",
                  fuse=fuse)
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in tree_leaves(params)]
        p = tree_unflatten_like(params, leaves)
        loss, _ = m.loss(p, batch)
        out[fuse] = (loss.detach(), torch.autograd.grad(loss, leaves))
    (lf, gf), (ln, gn) = out["fused"], out["none"]
    check(torch.isfinite(lf).item(), "small model: non-finite loss")
    check(abs(float(lf) - float(ln)) <= 1e-5 * abs(float(ln)) + 1e-6,
          f"small model: loss {float(lf)} vs {float(ln)}")
    worst = max(float((a - b).abs().max()) for a, b in zip(gf, gn))
    check(worst <= 1e-4, f"small model: gradient max abs diff {worst:.3e}")
    print(f"[model] fused vs unfused: loss {float(lf):.6f} vs {float(ln):.6f}, "
          f"gradient max abs diff {worst:.3e}")


def run_main_path(device, argv):
    """Phase 6: returns the per-kernel launch counts of the run."""
    import torch
    from repro_torch.kernels import fused
    from repro_torch.launch import train
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    fused.reset_launches()
    out = train.main(argv)
    launches = dict(fused.LAUNCHES)
    losses = out["losses"]
    check(all(math.isfinite(l) for l in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not decrease: {losses}")
    check(all(d == 0.0 for d in out["divergences"]),
          f"replica divergence {out['divergences']}")
    rec = out["recovery"]
    check(rec is not None, "no failure was injected")
    check(set(out["builds_after_step"]) == {rec["builds_before"]},
          f"program builds changed across fail -> recover -> step: "
          f"{rec['builds_before']} -> {out['builds_after_step']}")
    if device.type == "cuda":
        check(all(n > 0 for n in launches.values()),
              f"a kernel never launched on the main path: {launches}")
        mem = torch.cuda.max_memory_allocated() / 2**30
    else:
        mem = float("nan")
    print(f"[main] step seconds (host clock around synchronize): "
          f"{[round(s, 4) for s in out['step_seconds']]}")
    print(f"[main] recovery {rec['seconds']:.3f}s, builds "
          f"{rec['builds_before']} -> {out['builds_after_step'][-1]}, "
          f"max_memory_allocated {mem:.2f} GiB, launches {launches}")
    return launches


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def run(device="cuda"):
    """All phases; returns the kernels record.  ``device="cpu"`` is the
    rehearsal: small shapes, the plain versions, the reduced model."""
    import torch
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    from repro_torch.utils.device import resolve_device, strict_fp32_numerics
    device = resolve_device(device)
    on_card = device.type == "cuda"
    if on_card:
        strict_fp32_numerics()
        card = card_line()
        print(f"[device] {card} | torch: {torch.cuda.get_device_name(0)} | "
              f"torch {torch.__version__} cuda {torch.version.cuda}")
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        build.library()
        info = build.build_info()
        print(f"[build] {info.path} in "
              f"{time.perf_counter() - t0:.1f}s (nvcc {info.seconds:.1f}s)")
        print(build.ptxas_summary(info.log))
        main_shapes = {"add_rmsnorm_fwd": (1024, 1024),
                       "add_rmsnorm_bwd": (1024, 1024),
                       "gemm_bias": (1024, 1024, 3072)}
        ragged_shapes = {"add_rmsnorm_fwd": (1000, 999),
                         "add_rmsnorm_bwd": (1000, 999),
                         "gemm_bias": (1000, 999, 3000)}
        iters, argv = 50, MAIN_ARGV
    else:
        print("[device] cpu rehearsal: plain versions stand in for kernels")
        main_shapes = {"add_rmsnorm_fwd": (64, 64), "add_rmsnorm_bwd": (64, 64),
                       "gemm_bias": (64, 64, 192)}
        ragged_shapes = {"add_rmsnorm_fwd": (33, 47), "add_rmsnorm_bwd": (33, 47),
                         "gemm_bias": (33, 47, 95)}
        iters, argv = 2, REHEARSAL_ARGV

    table = kernel_table(device)
    errors = check_kernels(device, table, main_shapes, ragged_shapes)
    timing = time_kernels(device, table, main_shapes, iters)
    check_small_model(device)
    launches = run_main_path(device, argv)
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": KERNELS[name], "launches": launches[name],
         "max_abs_err": errors[name], **timing[name]}
        for name in KERNELS]}
    if on_card:
        print(card)
    print(json.dumps(record))
    return record


def main():
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found: run from a checkout "
              f"of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to PyTorch", file=sys.stderr)
        return 1
    run("cuda")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
