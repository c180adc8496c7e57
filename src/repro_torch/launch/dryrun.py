"""Multi-pod dry-run on H100s: price EVERY assigned (arch x shape) cell
on the production meshes (``repro/launch/dryrun.py``), with no device.

The reference lowers and compiles each cell's sharded program for a TPU
and reads XLA's memory and cost analyses.  The port has no partitioner,
so it derives the same terms from the sharding specs and two traces of
its own step functions under FakeTensorMode (``launch/opcount.py``):

  * args / outputs / alias bytes per device: exact, from the specs
    (``runtime/sharding.py``): each leaf's bytes over the sizes of the
    mesh axes its spec shards it on.  Donated params and optimizer state
    alias the train step's outputs; the decode cache aliases its output;
  * FLOPs per device: one trace of the GLOBAL step (``OpCounter``'s
    products, remat recomputation included) divided by the cards;
  * temps (the activation peak per device): one trace at the per-device
    shapes: the local batch from ``batch_spec``, the sequence divided by
    the leftover batch axes where ``act_constrainer`` would shard it,
    FSDP gathering one block at a time (``unshard``; the embedding,
    final norm and head gathered for the whole step), TP on a local
    architecture (``local_arch``): rank 0's query heads (the most a rank
    computes) and the kv heads they read, and its Mamba2 heads where
    ``ArchConfig``'s integer ``expand`` can state them (else whole), with
    d_ff, experts and
    vocabulary divided by the model axis wherever the spec shards them
    (the divisibility guard decides; counts it cannot divide stay
    whole).  Decode runs on a cache at the local batch (under FSDP with
    its whole head_dim: the cache is an argument, its bytes come from the
    specs, and the scores it gives are the same).  The train trace is the loss and its
    backward; the optimizer's update runs in place on the donated state,
    a piece at a time (``spmd.apply_sharded``), and its temporaries,
    ``spmd.UPDATE_COPIES`` fp32 copies of the largest piece of a
    device's leaves (``spmd.update_temp_bytes``: the largest row of any
    leaf, one block slice of the largest stacked leaf), are added to the
    trace's peak;
  * collectives: recorded at the strategy's hooks in the per-device
    trace, plus the gradients' all-reduce over the data axes; priced per
    group on NVLink or the network (``launch/mesh.py``);
  * fits: args + temps + outputs - alias <= ``H100.hbm_capacity``;
    roofline seconds on the ``H100`` ``HardwareSpec``: compute = FLOPs /
    ``peak_flops_bf16``, memory = the products' bytes / ``hbm_bandwidth``,
    collective as above; ``bottleneck`` the largest.

The traces run the plain paths, ``attn_impl="blocked"`` and
``ssd_impl="chunked"`` (the reference's dry-run also lowers ``blocked``):
the CUDA kernels cannot run on fake tensors.  Every number here is
derived arithmetic; nothing runs on a card.

Usage:
  python -m repro_torch.launch.dryrun                    # every cell, both meshes
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  python -m repro_torch.launch.dryrun --mesh single --strategy fsdp
Cells append to artifacts/dryrun_torch.json (resumable; done cells skip).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import SHAPES, all_archs, cells_for, get_arch
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import (data_axes, group_size,
                                     make_production_mesh, mesh_chips)
from repro_torch.launch.opcount import OpCounter
from repro_torch.models import Model
from repro_torch.runtime import spmd
from repro_torch.runtime.sharding import (ShardingStrategy, spec_leaves,
                                         ssm_heads, ssm_heads_fall, tp_heads)
from repro_torch.utils.hw import H100, HardwareSpec
from repro_torch.utils.tree import tree_leaves, tree_map

#: what the traces run (the CUDA kernels cannot run on fake tensors)
TRACED = {"attn_impl": "blocked", "ssd_impl": "chunked"}


def model_flops(arch, shape) -> float:
    n = arch.active_params()
    toks = shape.tokens_per_step()
    mult = 6.0 if shape.is_training else 2.0
    return mult * n * toks


# ----------------------------------------------------------------------
# bytes from the specs
# ----------------------------------------------------------------------
def local_shape(mesh, spec, shape):
    """The per-device shape of a tensor of ``shape`` laid out by
    ``spec``."""
    out = list(shape)
    for i, axis in enumerate(spec):
        out[i] = -(-out[i] // group_size(mesh, axis))
    return tuple(out)


def _bytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def sharded_bytes(mesh, specs, tree) -> int:
    """Σ over ``tree``'s leaves of their per-device bytes under
    ``specs`` (a tree of specs in ``tree``'s structure)."""
    return sum(_bytes(local_shape(mesh, spec, leaf.shape), leaf.dtype)
               for _, spec, leaf in spec_leaves(specs, tree))


def _batch_bytes(mesh, bspec, batch) -> int:
    return sum(_bytes(local_shape(mesh, bspec, t.shape), t.dtype)
               for t in batch.values())


# ----------------------------------------------------------------------
# the per-device layout of the trace
# ----------------------------------------------------------------------
def local_arch(arch: ArchConfig, strategy: ShardingStrategy,
               mesh) -> ArchConfig:
    """The architecture one device computes (module docstring): under TP
    rank 0's heads (``sharding.tp_heads``), the rank that computes the
    most query heads, with the kv heads they read: hymba's 15 / 3 of 25 /
    5 at model 2, 4 / 1 at model 8 (ranks 1-7 compute 3, and ranks 1, 4
    and 6 read 2 kv heads, a second k / v projection of one head that
    this trace leaves out), qwen2.5-32b's 3 / 1 of 40 / 8 at model 16.
    Rank 0's query heads are always one piece (``sharding.tp_pieces``):
    they start a group, and with fewer kv heads than ranks they number
    at most ceil(H / n) <= G.  Mamba2 heads (``sharding.ssm_heads``) where
    the integer ``expand`` can state them: mamba2-780m's and hymba's at
    model 2, neither at 4, where they stay whole; fewer query heads than
    ranks stay whole (``check_layout`` refuses to run them)."""
    k = mesh.shape[strategy.model_axis]
    if k == 1:
        return arch
    if strategy.strategy == "tp":
        rep: Dict[str, Any] = {}
        hd = arch.head_dim or (arch.d_model // arch.num_heads
                               if arch.num_heads else 0)
        if arch.num_heads >= k:
            (q0, q1), (k0, k1) = tp_heads(arch, k, 0)
            rep.update(num_heads=q1 - q0, num_kv_heads=k1 - k0, head_dim=hd)
        c = arch.ssm
        if c is not None and ssm_heads_fall(arch, k):
            h0, h1 = ssm_heads(arch, k, 0)
            inner = (h1 - h0) * c.head_dim
            if inner % arch.d_model == 0:
                rep["ssm"] = dataclasses.replace(
                    c, expand=inner // arch.d_model)
        if arch.d_ff and arch.d_ff % k == 0:
            rep["d_ff"] = arch.d_ff // k
        if arch.vocab_size % k == 0:
            rep["vocab_size"] = arch.vocab_size // k
        if arch.moe is not None and arch.moe.num_experts % k == 0:
            e = arch.moe.num_experts // k
            top = max(1, min(e, round(arch.moe.top_k * e
                                      / arch.moe.num_experts)))
            rep["moe"] = dataclasses.replace(arch.moe, num_experts=e,
                                             top_k=top)
        return dataclasses.replace(arch, **rep)
    return arch


def _fakes(tree, grad: bool = False):
    """Fake tensors (inside the active FakeTensorMode) in ``tree``'s
    shapes and dtypes."""
    def one(t):
        x = torch.empty(tuple(t.shape), dtype=t.dtype)
        return x.requires_grad_(True) if grad and x.is_floating_point() else x
    return tree_map(one, tree)


def _local_tree(mesh, specs, tree):
    leaves = [sp.meta(local_shape(mesh, spec, leaf.shape), leaf.dtype)
              for _, spec, leaf in spec_leaves(specs, tree)]
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _model(arch, strategy, mesh, shape, dtype, remat_policy, moe_impl,
           loss_chunk, recorder=None):
    model = spmd.build_model(arch, strategy, mesh, shape.global_batch,
                             dtype=dtype, moe_impl=moe_impl,
                             recorder=recorder, **TRACED)
    return dataclasses.replace(model, loss_chunk=loss_chunk,
                               remat_policy=remat_policy)


def _run(model, shape, params, batch, cache=None):
    """One step of the cell's kind on fake inputs; returns its output."""
    if shape.kind == "train":
        return spmd.loss_and_grads(model, params, batch)[1]
    if shape.kind == "prefill":
        return spmd.build_mesh_prefill_step(model, None, None)(params,
                                                                batch)
    # the in-place decode: the donated cache is written, not copied.  A
    # scalar position would index the cache through its value, which a
    # fake tensor has not: per-row positions (the serving plane's form)
    # write the same rows
    tokens = batch["tokens"]
    return model.decode_step_(params, tokens, cache,
                              torch.zeros(tokens.shape[0], dtype=torch.int32))


def _batch_for(arch, shape, b: int, s: int) -> Dict[str, Any]:
    if shape.kind == "decode":
        return {"tokens": sp.meta((b, 1), torch.int32)}
    f = arch.frontend_tokens if arch.frontend else 0
    f_local = f * s // shape.seq_len
    out = {"tokens": sp.meta((b, s - f_local), torch.int32),
           "labels": sp.meta((b, s - f_local), torch.int32)}
    if f:
        out["frontend_embeds"] = sp.meta((b, f_local, arch.d_model),
                                         torch.bfloat16)
    if shape.kind == "prefill":
        del out["labels"]
    return out


# ----------------------------------------------------------------------
def spec_bytes(arch: ArchConfig, shape: ShapeConfig, mesh,
               strategy: ShardingStrategy, *, param_dtype=torch.float32,
               model=None) -> Dict[str, int]:
    """Per-device bytes of the step's arguments, outputs and the outputs
    that alias donated arguments, and of the batch, from the specs
    alone (no trace): the args of a train step are params, the AdamW
    state and the batch; of a prefill, params and the batch; of a
    decode, params, the token, the cache and the position."""
    model = model or Model(arch)
    pshape = sp.params_shape(model, param_dtype)
    p = sharded_bytes(mesh, strategy.param_shardings(mesh, pshape), pshape)
    bspec = strategy.batch_spec(mesh, shape.global_batch)
    logits = _bytes(local_shape(mesh, bspec, (shape.global_batch, 1,
                                              arch.vocab_size)),
                    torch.float32)
    if shape.kind == "train":
        oshape = sp.opt_shape(model, pshape)
        o = sharded_bytes(mesh, strategy.opt_shardings(mesh, oshape, pshape),
                          oshape)
        b = _batch_bytes(mesh, bspec, sp.batch_specs(arch, shape))
        # outputs: the new params and state (donated) and the scalars
        return {"args": p + o + b, "outputs": p + o + 4 * len(spmd._STATS),
                "alias": p + o, "batch": b}
    if shape.kind == "prefill":
        b = _batch_bytes(mesh, bspec, sp.prefill_specs(arch, shape))
        return {"args": p + b, "outputs": logits, "alias": 0, "batch": b}
    tok, cache, pos = sp.decode_specs(arch, shape, model)
    c = sharded_bytes(mesh, strategy.cache_shardings(mesh, cache,
                                                     shape.global_batch),
                      cache)
    b = _batch_bytes(mesh, bspec, {"tokens": tok})
    return {"args": p + b + c + _bytes(pos.shape, pos.dtype),
            "outputs": c + logits, "alias": c, "batch": b}


# ----------------------------------------------------------------------
def analyze(arch: ArchConfig, shape: ShapeConfig, mesh,
            strategy: ShardingStrategy, *, dtype=torch.bfloat16,
            param_dtype=torch.float32, remat_policy: str = "full",
            moe_impl: Optional[str] = None, loss_chunk: int = 512,
            hw: HardwareSpec = H100) -> Dict[str, Any]:
    """Every term of one cell on ``mesh`` (module docstring)."""
    chips = mesh_chips(mesh)
    moe_impl = moe_impl or ("capacity" if shape.kind != "decode"
                            else spmd.DECODE_MOE_IMPL)
    t0 = time.time()
    model = _model(arch, strategy, mesh, shape, dtype, remat_policy,
                   moe_impl, loss_chunk)
    nbytes = spec_bytes(arch, shape, mesh, strategy, param_dtype=param_dtype,
                        model=model)
    args, outputs, alias = nbytes["args"], nbytes["outputs"], nbytes["alias"]
    pshape = sp.params_shape(model, param_dtype)
    pspec = strategy.param_shardings(mesh, pshape)
    bspec = strategy.batch_spec(mesh, shape.global_batch)
    cache = None
    if shape.kind == "train":
        batch = sp.batch_specs(arch, shape)
    elif shape.kind == "prefill":
        batch = sp.prefill_specs(arch, shape)
    else:
        tok, cache, _ = sp.decode_specs(arch, shape, model)
        batch = {"tokens": tok}

    # ---- FLOPs: the global step -------------------------------------
    with FakeTensorMode():
        params = _fakes(pshape, grad=shape.kind == "train")
        with OpCounter(track_memory=False, hw=hw) as glob:
            _run(model, shape, params, _fakes(batch),
                 None if cache is None else _fakes(cache))
    gstats = glob.stats()

    # ---- temps and collectives: one device --------------------------
    b_local = local_shape(mesh, bspec, (shape.global_batch,))[0]
    s_local = shape.seq_len if shape.kind != "decode" else 1
    seq_axis = strategy.seq_axis(mesh, shape.global_batch)
    if (shape.kind != "decode" and seq_axis is not None
            and s_local % group_size(mesh, seq_axis) == 0):
        s_local //= group_size(mesh, seq_axis)
    larch = local_arch(arch, strategy, mesh)
    full_shapes = {p: (leaf.shape[1:] if p.startswith("blocks/")
                       else leaf.shape)
                   for p, _, leaf in spec_leaves(pspec, pshape)}
    rec = OpCounter(full_shapes=full_shapes, hw=hw)
    dmodel = _model(larch, strategy, mesh, shape, dtype, remat_policy,
                    moe_impl, loss_chunk, recorder=rec)
    if strategy.strategy == "fsdp":
        lp = _local_tree(mesh, pspec, pshape)
    else:
        lp = sp.params_shape(dmodel, param_dtype)
    dp_axes = tuple(a for a in ((bspec[0],) if isinstance(bspec[0], str)
                                else bspec[0]) if a != strategy.model_axis
                    ) if bspec else ()
    with FakeTensorMode():
        params = _fakes(lp, grad=shape.kind == "train")
        lbatch = _fakes(_batch_for(arch, shape, b_local, s_local))
        lcache = None
        if cache is not None:
            lcache = _fakes(sp.cache_shape(
                dmodel, ShapeConfig(shape.name, shape.seq_len, b_local,
                                    "decode")))
        with rec:
            if strategy.strategy == "fsdp":
                gather = rec.gatherer(strategy, mesh)
                params = {k: (v if k == "blocks" else
                              gather(k, v) if isinstance(v, torch.Tensor)
                              else {n: gather(f"{k}/{n}", t)
                                    for n, t in v.items()})
                          for k, v in params.items()}
            out = _run(dmodel, shape, params, lbatch, lcache)
            if shape.kind == "train":
                for g in tree_leaves(out):
                    rec.record("all-reduce", g.numel() * g.element_size(),
                               mesh, dp_axes, "grad")
            del out
    dstats = rec.stats()
    trace_s = time.time() - t0

    flops_dev = gstats.dot_flops / chips
    terms = {"compute_s": flops_dev / hw.peak_flops_bf16,
             "memory_s": gstats.dot_bytes / chips / hw.hbm_bandwidth,
             "collective_s": dstats.collective_seconds}
    bottleneck = max(terms, key=terms.get).replace("_s", "")
    temps = dstats.peak_bytes
    if shape.kind == "train":
        temps += spmd.update_temp_bytes([t.shape for t in tree_leaves(lp)])
    mf = model_flops(arch, shape)
    return {
        "chips": chips, "trace_s": round(trace_s, 1),
        "bytes": {"args": args, "temps": temps, "outputs": outputs,
                  "alias": alias},
        "memory": {"args_gb": args / 1e9, "temps_gb": temps / 1e9,
                   "output_gb": outputs / 1e9, "alias_gb": alias / 1e9},
        "fits_hbm": bool(args + temps + outputs - alias <= hw.hbm_capacity),
        "ops": {
            "flops_per_dev": flops_dev,
            "dot_bytes_per_dev": gstats.dot_bytes / chips,
            "conv_flops_per_dev": gstats.conv_flops / chips,
            "collective_bytes_per_dev": dstats.collective_bytes,
            "collective_counts": dstats.collective_counts,
            "collective_bytes_by_kind": dstats.collective_bytes_by_kind,
            "collective_bytes_by_site": dstats.collective_bytes_by_site,
            "top_collectives": dstats.top_collectives,
        },
        "roofline": {
            **{k: round(v, 6) for k, v in terms.items()},
            "bottleneck": bottleneck, "model_flops": mf,
            "flops_global": gstats.dot_flops,
            "model_flops_ratio": mf / max(gstats.dot_flops, 1.0),
        },
        "traced": {**TRACED, "moe_impl": moe_impl,
                   "remat_policy": remat_policy, "loss_chunk": loss_chunk,
                   "dtype": str(dtype).replace("torch.", ""),
                   "param_dtype": str(param_dtype).replace("torch.", ""),
                   "local_batch": b_local, "local_seq": s_local},
    }


def run_cell(arch_name: str, shape_name: str, mesh_kind: str,
             strategy_name: str, loss_chunk: int = 512,
             remat_policy: str = "full", moe_impl: Optional[str] = None,
             serve_bf16: bool = False, gather_dtype: Optional[str] = None,
             variant: str = "") -> Dict[str, Any]:
    arch = get_arch(arch_name)
    shape = SHAPES[shape_name]
    multi = mesh_kind == "multi"
    mesh = make_production_mesh(multi_pod=multi)
    strategy = ShardingStrategy(strategy=strategy_name,
                                data_axes=data_axes(multi),
                                gather_dtype=gather_dtype)
    # optimized serving holds bf16 weights (--serve-bf16); the baseline
    # keeps fp32 for strict comparability with training
    pdt = (torch.bfloat16 if serve_bf16 and not shape.is_training
           else torch.float32)
    cell = analyze(arch, shape, mesh, strategy, param_dtype=pdt,
                   remat_policy=remat_policy, moe_impl=moe_impl,
                   loss_chunk=loss_chunk)
    suffix = f"/{variant}" if variant else ""
    return {"key": f"{arch_name}/{shape_name}/{mesh_kind}/"
                   f"{strategy_name}{suffix}",
            "arch": arch_name, "shape": shape_name, "mesh": mesh_kind,
            "strategy": strategy_name, "variant": variant, "status": "ok",
            **cell}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--strategy", default="fsdp", choices=["fsdp", "tp"])
    ap.add_argument("--remat-policy", default="full",
                    choices=["full", "dots"])
    ap.add_argument("--moe-impl", default=None,
                    choices=[None, "dense", "grouped", "capacity",
                             "capacity_vec"])
    ap.add_argument("--loss-chunk", type=int, default=512)
    ap.add_argument("--serve-bf16", action="store_true")
    ap.add_argument("--gather-dtype", default=None,
                    choices=[None, "bfloat16"])
    ap.add_argument("--variant", default="",
                    help="label for perf-iteration runs (artifact key suffix)")
    ap.add_argument("--out", default="artifacts/dryrun_torch.json")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    cells = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            cells = json.load(f).get("cells", [])
    done = {c["key"] for c in cells if c.get("status") == "ok"}

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    want = (args.arch.replace("-", "_").replace(".", "_")
            if args.arch else None)
    work = [(arch.name, shape.name, mesh_kind)
            for arch in all_archs() if want in (None, arch.name)
            for shape in cells_for(arch)
            if args.shape in (None, shape.name)
            for mesh_kind in meshes]

    suffix = f"/{args.variant}" if args.variant else ""
    for arch_name, shape_name, mesh_kind in work:
        key = f"{arch_name}/{shape_name}/{mesh_kind}/{args.strategy}{suffix}"
        if key in done and not args.force:
            print(f"SKIP {key}", flush=True)
            continue
        print(f"RUN  {key}", flush=True)
        try:
            cell = run_cell(arch_name, shape_name, mesh_kind, args.strategy,
                            loss_chunk=args.loss_chunk,
                            remat_policy=args.remat_policy,
                            moe_impl=args.moe_impl,
                            serve_bf16=args.serve_bf16,
                            gather_dtype=args.gather_dtype,
                            variant=args.variant)
            r, mem = cell["roofline"], cell["memory"]
            print(f"  ok: trace {cell['trace_s']}s "
                  f"mem {mem['args_gb']:.1f}+{mem['temps_gb']:.1f}GB "
                  f"fits={cell['fits_hbm']} bottleneck={r['bottleneck']} "
                  f"terms=({r['compute_s']:.4f},{r['memory_s']:.4f},"
                  f"{r['collective_s']:.4f})s "
                  f"useful={r['model_flops_ratio']:.2f}", flush=True)
        except Exception as e:   # one cell's failure is recorded, not fatal
            traceback.print_exc()
            cell = {"key": key, "arch": arch_name, "shape": shape_name,
                    "mesh": mesh_kind, "strategy": args.strategy,
                    "status": f"error: {type(e).__name__}: {e}"}
        cells = [c for c in cells if c["key"] != key] + [cell]
        with open(args.out, "w") as f:
            json.dump({"cells": cells}, f, indent=1)


if __name__ == "__main__":
    main()
