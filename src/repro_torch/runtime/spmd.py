"""SPMD step builders and the homogeneous fast path
(``repro/runtime/spmd.py``).

With zero failures all Oobleck pipelines run the same template, and the
whole job folds into ONE train program over the global batch.  The step
builders give that program and its serving siblings; the bundles pair
each with the sharding specs of its inputs and outputs
(``runtime/sharding.py``), which the dry-run (``launch/dryrun.py``)
prices without running anything.

``SPMDExecutor`` runs the train program behind the ``Executor``
interface: on one card (no mesh, or a mesh whose axes all have size 1),
or over a ``ProcessMesh`` (``launch/mesh.py``) with ``strategy="fsdp"``
or ``"tp"``, with or without ZeRO-1.  On a process mesh each rank holds
only its shards of the params and the moments, takes its rows of the
global batch, sums the gradients over the batch axes a leaf is not
sharded over, clips by the global norm with each element counted once,
and steps AdamW on its shard (then, under ZeRO-1, all-gathers the
updated slice over the data axes): the function the reference's one
GSPMD program computes.  Under FSDP it gathers each weight at use and
reduce-scatters its gradient (``runtime/collectives.py``).  Under TP
(Megatron tensor parallelism and expert parallelism) the batch shards
over the data axes only; the ranks of a model group compute the same
rows, each its heads, MLP columns, experts and vocabulary rows
(``ShardingStrategy.tp_context``, the model's ``tp``), joined by
Megatron's *f* and *g*, and nothing outside the blocks is gathered.  A
global batch too small to cover every batch axis shards the sequence
over the rest (``ShardingStrategy.seq_context``: each rank takes its
rows of the batch whole, and the model keeps its positions of the
sequence), and an MoE sums its router statistics over every batch rank.
Under TP the Mamba2 mixer runs a rank's whole heads (``models/ssm.py``),
and attention heads the model axis does not divide fall as whole kv
groups a rank or, with fewer kv heads than ranks, as evenly as the query
heads fall, in pieces over the kv heads they read (``sharding.tp_heads``,
``tp_pieces``); a layout no such placement fits raises
``NotImplementedError`` (``check_layout``).
``SPMDServer`` runs the prefill and decode bundles the same way: a rank
serves its rows of the global batch with its shards, under the same
contexts, and holds the cache its decode writes.
``recover``/``join`` raise ``ExecutorUnsupported`` by design: one SPMD
program cannot express a heterogeneous survivor set, so the engine keeps
the plan consistent and the caller rebinds a ``HeteroTrainer``
(``runtime/pipeline.py``) from ``snapshot()``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import group_size
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.runtime.collectives import all_reduce_sum, gather_at_use
from repro_torch.runtime.executor import (Executor, ExecutorUnsupported,
                                          ProgramCache)
from repro_torch.runtime.sharding import (ShardingStrategy, batch_rows,
                                          gather_cache, gather_tree,
                                          on_ranks, shard_cache, shard_shape,
                                          shard_tree, sharded_dims, spec_axes,
                                          spec_leaves, ssm_heads, tp_heads)
from repro_torch.utils.tree import (tree_leaves, tree_leaves_with_path,
                                    tree_map, tree_unflatten_like)


def build_model(arch: ArchConfig, strategy: ShardingStrategy, mesh,
                global_batch: int, *, dtype=torch.bfloat16,
                remat: bool = True, attn_impl: str = "blocked",
                moe_impl: str = "dense", recorder=None, **kw) -> Model:
    """The model with the strategy's ``constrain`` and ``unshard``
    hooks (recording collectives when a ``recorder`` is given)."""
    return Model(arch, dtype=dtype, remat=remat, attn_impl=attn_impl,
                 moe_impl=moe_impl,
                 constrain=strategy.act_constrainer(mesh, global_batch,
                                                    recorder),
                 unshard=strategy.unshard_blocks(mesh, recorder), **kw)


def loss_and_grads(model: Model, params, batch) -> Tuple[Any, Any, Dict]:
    """(loss, grads in ``params``' structure, metrics) of one forward
    and backward over ``batch``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = model.loss(tree_unflatten_like(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten_like(params, list(grads)), metrics


def build_train_step(model: Model, opt_cfg: adamw.AdamWConfig) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, stats); params
    and moments are updated in place (``apply_sharded`` with every leaf
    replicated and no mesh)."""
    def train_step(params, opt_state, batch):
        loss, grads, metrics = loss_and_grads(model, params, batch)
        grads = tree_leaves(grads)
        whole = [()] * len(grads)
        opt2, stats = apply_sharded(opt_cfg, None, params, grads, opt_state,
                                    whole, whole)
        return params, opt2, {"loss": loss,
                              **{k: v.detach() for k, v in metrics.items()},
                              **stats}
    return train_step


def _zero1_dim(pspec, ospec):
    """(dimension, axis) ZeRO-1 adds to a moment's spec, or None."""
    pspec = tuple(pspec) + (None,) * (len(ospec) - len(pspec))
    for d, (a, b) in enumerate(zip(pspec, ospec)):
        if a != b:
            return d, b
    return None


#: fp32 temporaries one ``adamw.update`` call holds at its peak, in
#: copies of the piece it steps (the new m and v, m-hat, v-hat, the root,
#: delta, the decay term, the new parameter): what ``launch/dryrun.py``
#: adds to a train step's temps (``update_temp_bytes``)
UPDATE_COPIES = 8


def update_pieces(shapes) -> List[List[Tuple[int, int]]]:
    """Per leaf, the dim-0 row ranges [r0, r1) ``apply_sharded`` steps it
    in: ranges of as many rows as fit ``cap`` elements, the largest row
    (``prod(shape[1:])``) of any leaf, at least one row.  A block leaf
    stacked over the depth with the largest row is stepped one block
    slice at a time, a small one (an [L, d] norm scale) and every leaf
    no larger than ``cap`` whole, the embedding in ranges of its
    vocabulary rows; a scalar whole."""
    shapes = [tuple(s) for s in shapes]
    rows = [max(1, math.prod(s[1:])) for s in shapes]
    cap = max((r for s, r in zip(shapes, rows) if s), default=1)
    out = []
    for s, r in zip(shapes, rows):
        if not s:
            out.append([(0, 0)])
            continue
        step = max(1, cap // r)
        out.append([(r0, min(r0 + step, s[0])) for r0 in range(0, s[0], step)]
                   or [(0, 0)])
    return out


def update_temp_bytes(shapes) -> int:
    """Bytes of the update's temporaries at their peak: ``UPDATE_COPIES``
    fp32 copies of the largest piece ``update_pieces`` steps."""
    largest = max((max(r1 - r0, 1) * math.prod(tuple(s)[1:])
                   for s, ranges in zip(shapes, update_pieces(shapes))
                   for r0, r1 in ranges), default=0)
    return UPDATE_COPIES * 4 * largest


def apply_sharded(cfg: adamw.AdamWConfig, mesh, params, grads: List,
                  state: adamw.AdamWState, pspecs: List, ospecs: List):
    """``adamw.apply`` on this rank's shards, written into ``params``
    and the moments in place, piece by piece, with each gradient dropped
    from ``grads`` (a list in ``tree_leaves(params)`` order) once used.
    A block leaf is stacked over the depth, so a whole leaf's
    temporaries are ``UPDATE_COPIES`` copies of every block's weight:
    each leaf is stepped in the dim-0 pieces of ``update_pieces`` (the
    largest stacked leaves one block slice at a time, smaller leaves in
    as few pieces as fit one such slice), each piece's new m, v and
    parameter written back into their slices, so at most one piece's
    temporaries live at once (``update_temp_bytes``, which the dry-run
    adds to a train step's temps).  Weight decay follows the whole
    leaf's rule (ndim >= 2), not the piece's.  ``pspecs``/``ospecs`` are
    the leaves' param and moment specs; with every leaf replicated
    ``mesh`` may be None (one card).  The arithmetic is elementwise with
    scalar bias corrections, so the result is ``adamw.apply``'s, bit for
    bit.

    The global norm counts each element once: the squares of the leaves
    sharded over the same axes are summed over those axes, a replicated
    leaf's once.  A moment ZeRO-1 shards further is stepped on its slice
    of the parameter, whose update is assembled piece by piece into one
    buffer and then all-gathered over the data axes.  Returns (the new
    state, {"lr", "grad_norm"})."""
    parts: Dict[Tuple[str, ...], torch.Tensor] = {}
    for g, spec in zip(grads, pspecs):
        axes = spec_axes(mesh, spec)
        sq = torch.sum(torch.square(g.float()))
        parts[axes] = parts[axes] + sq if axes in parts else sq
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for axes, sq in parts.items():
        total = total + (mesh.transport.all_reduce(sq, mesh.group(axes)[0])
                         if group_size(mesh, axes) > 1 else sq)
    gnorm = torch.sqrt(total)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                         max=1.0) if cfg.clip_norm else None)
    scalars = adamw.step_scalars(cfg, state.step)
    lr = scalars[0]
    leaves = tree_leaves(params)
    zs = [_zero1_dim(ps, os) for ps, os in zip(pspecs, ospecs)]
    # the pieces are cut from what is stepped: the ZeRO-1 slice where
    # the moment narrows the parameter
    shapes = [m.shape for m in tree_leaves(state.m)]
    pieces = update_pieces(shapes)
    for i, (p, m, v) in enumerate(zip(leaves, tree_leaves(state.m),
                                      tree_leaves(state.v))):
        g_all, grads[i] = grads[i], None
        z, p_sl = zs[i], p
        if z is not None:
            dim, axis = z
            n = p.shape[dim] // group_size(mesh, axis)
            p_sl = p.narrow(dim, mesh.axis_index(axis) * n, n)
            g_all = g_all.narrow(dim, mesh.axis_index(axis) * n, n)
        new = p if z is None else torch.empty_like(p_sl)
        for r0, r1 in pieces[i]:
            cut = ((lambda t: t) if p_sl.ndim == 0 else
                   (lambda t, r0=r0, r1=r1: t.narrow(0, r0, r1 - r0)))
            g = cut(g_all).float()
            if scale is not None:
                g = g * scale.to(g.dtype)
            (p2,), st, _ = adamw.update(
                cfg, [cut(p_sl)], [g],
                adamw.AdamWState(state.step, [cut(m)], [cut(v)]),
                decay=[p.ndim >= 2], scalars=scalars)
            cut(m).copy_(st.m[0])
            cut(v).copy_(st.v[0])
            cut(new).copy_(p2)
        if z is not None:
            dim, axis = z
            p.copy_(mesh.transport.all_gather(
                new, mesh.group(axis)[0], group_size(mesh, axis), dim))
    return (adamw.AdamWState(state.step + 1, state.m, state.v),
            {"lr": lr, "grad_norm": gnorm})


def _at_use(model: Model, mesh, path: str, spec, t: torch.Tensor
            ) -> torch.Tensor:
    """A rank's leaf as the model takes it: a non-block leaf (the
    embedding, the final norm, the head) gathered over the axes its spec
    cuts, except under TP (``model.tp``), where the model takes its
    shards; a block leaf as it is (``model.unshard`` gathers it)."""
    if model.tp is None and not path.startswith("blocks/"):
        for dim, axis in sharded_dims(spec):
            t = gather_at_use(t, mesh, axis, dim)
    return t


def build_mesh_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                          mesh, pspecs: Any, ospecs: Any,
                          batch_axis) -> Callable:
    """The train program on one rank of ``mesh``: (this rank's param
    shards, its AdamW shards, its rows of the batch) -> (params, state,
    stats), updated in place.  ``model``'s ``unshard`` hook gathers the
    block weights (``strategy.unshard_blocks``); the embedding, final
    norm and head are gathered here, except under TP (``model.tp``),
    where the model takes its shards as they are.  The loss is the
    global masked
    mean: each rank's objective is its NLL sum over the global token
    count, and the ranks' objectives sum to the reference's loss, so
    their gradients sum to its gradient.  ``batch_axis`` is every batch
    axis (``model.seq.stat_axis``): the rows cover some, the sequence
    shards over the rest; a rank counts its labelled positions
    (``model.loss_weights``) and the global count sums them all.  Where
    the sequence stays whole on a group, its ranks count the same tokens
    and the global count n times them: each rank's objective is then
    1/n of the same sum, and the ranks still sum to the reference's
    loss.  The MoE aux is the global one on every rank
    (``models/moe.py``), so in that sum it counts once."""
    tr = mesh.transport
    batch_set = set(mesh.axes(batch_axis))

    def train_step(params, opt_state, batch):
        entries = spec_leaves(pspecs, params)
        specs = [spec for _, spec, _ in entries]
        leaves = [t.detach().requires_grad_(True) for _, _, t in entries]
        labels, mask = batch["labels"], batch.get("mask")
        w = model.loss_weights(batch)
        cnt = (w.sum() if w is not None else
               mask[:, :-1].float().sum() if mask is not None else
               torch.tensor(float(labels[:, :-1].numel()),
                            device=labels.device))
        total = all_reduce_sum(cnt, mesh, batch_axis)
        with torch.enable_grad():
            used = [_at_use(model, mesh, path, spec, t)
                    for (path, spec, _), t in zip(entries, leaves)]
            loss, metrics = model.loss(tree_unflatten_like(params, used),
                                       batch)
            obj = loss * (cnt / torch.clamp(total, min=1.0))
            grads = list(torch.autograd.grad(obj, leaves))
        for i, spec in enumerate(specs):
            rest = tuple(a for a in mesh.shape if a in batch_set
                         and a not in spec_axes(mesh, spec))
            if mesh.size(rest) > 1:
                grads[i] = tr.all_reduce(grads[i], mesh.group(rest)[0])
        sums = all_reduce_sum(torch.stack([
            obj.detach(),
            metrics["nll"].detach() * (cnt / torch.clamp(total, min=1.0))]),
            mesh, batch_axis)
        opt2, stats = apply_sharded(
            opt_cfg, mesh, params, grads, opt_state, specs,
            [spec for _, spec, _ in spec_leaves(ospecs.m, params)])
        return params, opt2, {"loss": sums[0], "nll": sums[1],
                              "aux": metrics["aux"].detach(), **stats}
    return train_step


def _mesh_params(model: Model, mesh, pspecs, params):
    """``params`` as the model takes them on a rank (``_at_use``); as
    they are on one card (no ``pspecs``)."""
    if pspecs is None:
        return params
    return tree_unflatten_like(params, [
        _at_use(model, mesh, path, spec, t)
        for path, spec, t in spec_leaves(pspecs, params)])


#: the MoE dispatch of a decode step: the reference's dry-run serves MoE
#: models with the capacity dispatch for prefill and the grouped one for
#: decode (one token a row)
DECODE_MOE_IMPL = "grouped"


def build_mesh_prefill_step(model: Model, mesh, pspecs: Any) -> Callable:
    """``prefill_bundle``'s step on one rank of ``mesh``: (this rank's
    param shards, its rows of the batch) -> its rows of the last
    position's logits [b, 1, V] over the whole vocabulary (the bundle's
    out-spec).  ``model`` carries the strategy's hooks (FSDP's
    ``unshard`` gathers each block's weights at use) and the rank's
    ``seq`` and ``tp``, as the train program's; the embedding, final
    norm and head are gathered here except under TP.  Where the
    sequence shards (a batch too small for the batch axes), the last
    position's hidden state comes from the rank holding it
    (``Model.prefill``).  With no mesh and no ``pspecs``: the one-card
    step, ``Model.prefill`` without gradients."""
    def prefill_step(params, batch):
        with torch.no_grad():
            return model.prefill(_mesh_params(model, mesh, pspecs, params),
                                 batch["tokens"],
                                 batch.get("frontend_embeds"))
    return prefill_step


def build_mesh_decode_step(model: Model, mesh, pspecs: Any) -> Callable:
    """``decode_bundle``'s step on one rank of ``mesh``: (this rank's
    param shards, its rows' tokens [b, 1], its cache, the position) ->
    (its rows of the logits [b, 1, V] over the whole vocabulary, its
    cache, written in place: the torch form of the donated cache).  The
    rank's cache is its rows and, under TP, its heads
    (``Model.init_cache``, ``sharding.shard_cache``).  A decode tick
    shards no sequence (S 1): rows too few for the batch axes stay whole
    on the ranks that share them, the reference's rule.  With no mesh
    and no ``pspecs``: the one-card step."""
    def decode_step(params, token, cache, pos):
        with torch.no_grad():
            return model.decode_step_(
                _mesh_params(model, mesh, pspecs, params), token, cache,
                pos), cache
    return decode_step


# ----------------------------------------------------------------------
# Steps with the specs of their inputs and outputs
# ----------------------------------------------------------------------
@dataclasses.dataclass
class StepBundle:
    """A step function with the specs (``runtime/sharding.py``) of its
    positional inputs and of its outputs.  What the reference's ``.jit``
    does with them the port does on ranks: ``SPMDExecutor`` runs the
    train bundle's function over a ``ProcessMesh``, ``SPMDServer`` the
    prefill and decode bundles'; ``fn`` is the one-card function."""

    fn: Callable
    in_specs: Tuple
    out_specs: Any


_STATS = ("loss", "nll", "aux", "lr", "grad_norm")


def train_bundle(model: Model, opt_cfg: adamw.AdamWConfig,
                 strategy: ShardingStrategy, mesh, params_shape: Any,
                 opt_shape: Any, shape: ShapeConfig) -> StepBundle:
    pspec = strategy.param_shardings(mesh, params_shape)
    ospec = strategy.opt_shardings(mesh, opt_shape, params_shape)
    bspec = strategy.batch_spec(mesh, shape.global_batch)
    batch_spec: Dict[str, Any] = {"tokens": bspec, "labels": bspec}
    if model.arch.frontend:
        batch_spec["frontend_embeds"] = bspec
    return StepBundle(fn=build_train_step(model, opt_cfg),
                      in_specs=(pspec, ospec, batch_spec),
                      out_specs=(pspec, ospec, {k: () for k in _STATS}))


def prefill_bundle(model: Model, strategy: ShardingStrategy, mesh,
                   params_shape: Any, shape: ShapeConfig) -> StepBundle:
    pspec = strategy.param_shardings(mesh, params_shape)
    bspec = strategy.batch_spec(mesh, shape.global_batch)
    batch_spec: Dict[str, Any] = {"tokens": bspec}
    if model.arch.frontend:
        batch_spec["frontend_embeds"] = bspec
    return StepBundle(fn=build_mesh_prefill_step(model, None, None),
                      in_specs=(pspec, batch_spec),
                      out_specs=(bspec[0] if bspec else None,))


def decode_bundle(model: Model, strategy: ShardingStrategy, mesh,
                  params_shape: Any, cache_shape: Any,
                  shape: ShapeConfig) -> StepBundle:
    pspec = strategy.param_shardings(mesh, params_shape)
    cspec = strategy.cache_shardings(mesh, cache_shape, shape.global_batch)
    bspec = strategy.batch_spec(mesh, shape.global_batch)
    return StepBundle(fn=build_mesh_decode_step(model, None, None),
                      in_specs=(pspec, bspec, cspec, ()),
                      out_specs=(bspec, cspec))


# ----------------------------------------------------------------------
# The homogeneous fast path behind the Executor interface
# ----------------------------------------------------------------------
class SPMDExecutor(Executor):
    """Zero-failure homogeneous fast path: the whole job is ONE train
    program over the global batch (DESIGN.md §8), built once into a
    ``ProgramCache`` under ("spmd-train", backend signature, batch
    shapes, mesh shape, strategy, rank), so steady stepping is a cache
    hit and tests assert one build.  The device is the one ``params``
    lie on; the executor keeps its own copy of them: on one card all of
    them, on a ``ProcessMesh`` this rank's shards (module docstring)."""

    def __init__(self, model: Model, params: Dict,
                 opt_cfg: adamw.AdamWConfig, mesh: Optional[Any] = None,
                 strategy: Optional[ShardingStrategy] = None,
                 shape: Optional[ShapeConfig] = None,
                 engine: Optional[Any] = None,
                 cache: Optional[ProgramCache] = None):
        if mesh is not None:
            strategy = strategy or ShardingStrategy()
            check_layout(mesh, strategy, model.arch)
            if not on_ranks(mesh) and \
                    any(n != 1 for n in mesh.shape.values()):
                raise TypeError(
                    f"SPMDExecutor over {dict(mesh.shape)}: an AbstractMesh "
                    f"only describes a layout; run over a ProcessMesh "
                    f"(launch/mesh.py) to place it on ranks")
        self.model = model
        self.opt_cfg = opt_cfg
        self.mesh = mesh
        self.strategy = strategy
        self.shape = shape
        self.engine = engine
        self.cache = cache or ProgramCache()
        self.distributed = on_ranks(mesh)
        if self.distributed:
            self.pspecs = strategy.param_shardings(mesh, params)
            self.ospecs = strategy.opt_shardings(
                mesh, adamw.AdamWState(None, None, None), params)
            self._model = dataclasses.replace(
                model, unshard=strategy.unshard_blocks(mesh, like=params),
                constrain=strategy.act_constrainer(
                    mesh, shape.global_batch if shape is not None else 1))
            self.params = shard_tree(self.pspecs, params, mesh)
            dev = tree_leaves(self.params)[0].device

            def zeros(specs):
                return tree_unflatten_like(params, [
                    torch.zeros(shard_shape(spec, t.shape, mesh),
                                dtype=torch.float32, device=dev)
                    for _, spec, t in spec_leaves(specs, params)])
            self.opt_state = adamw.AdamWState(
                torch.zeros((), dtype=torch.int32, device=dev),
                zeros(self.ospecs.m), zeros(self.ospecs.v))
        else:
            # sole ownership: every step updates these leaves in place
            self.params = tree_map(lambda t: t.detach().clone(), params)
            self.opt_state = adamw.init(self.params)
        self.device = tree_leaves(self.params)[0].device
        if engine is not None and hasattr(engine, "attach_executor"):
            engine.attach_executor(self)
        self.bind()

    # ------------------------------------------------------------------
    def _program(self, batch: Dict) -> Callable:
        """The train program for ``batch``'s (global) shapes.  Without a
        process mesh every spec is the identity layout, so the program
        is ``build_train_step``'s with or without a mesh of size one.  On
        a process mesh the model gets the sequence context of the global
        batch (``ShardingStrategy.seq_context``) and, under TP, its
        tensor-parallel context (``ShardingStrategy.tp_context``)."""
        mesh = self.mesh
        key = ("spmd-train", kops.backend_signature(self.device),
               tuple(sorted((k, tuple(v.shape), str(v.dtype))
                            for k, v in batch.items())),
               tuple(mesh.shape.items()) if mesh is not None else (),
               self.strategy, mesh.rank if self.distributed else 0)
        if not self.distributed:
            return self.cache.get_or_build(
                key, lambda: build_train_step(self.model, self.opt_cfg))
        seq = self.strategy.seq_context(mesh, batch["tokens"].shape[0])
        tp = self.strategy.tp_context(mesh, self.model.arch)
        return self.cache.get_or_build(key, lambda: build_mesh_train_step(
            dataclasses.replace(self._model, seq=seq, tp=tp), self.opt_cfg,
            mesh, self.pspecs, self.ospecs, seq.stat_axis))

    # Executor interface ------------------------------------------------
    def bind(self) -> None:
        """Build the program for the configured global-batch shape when
        known; otherwise the first step() builds (and caches) it."""
        if self.shape is not None:
            from repro_torch.launch import specs as sp
            self._program(sp.batch_specs(self.model.arch, self.shape))

    def _to_device(self, v) -> torch.Tensor:
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        return t.to(self.device)

    def _rows(self, v, gb: int):
        """This rank's rows of a global-batch array (``batch_spec``),
        whole: where the sequence shards, the model keeps this rank's
        positions (``Model.hidden_states``, ``Model.loss_weights``)."""
        bspec = self.strategy.batch_spec(self.mesh, gb)
        if not bspec:
            return v
        axis = bspec[0]
        n = gb // self.mesh.size(axis)
        i = self.mesh.axis_index(axis)
        return v[i * n:(i + 1) * n]

    def step(self, batch: Dict) -> Dict:
        shapes = {k: np.shape(v) for k, v in batch.items()
                  if not k.startswith("_")}
        if self.distributed:
            gb = shapes["tokens"][0]
            batch = {k: self._rows(batch[k], gb) for k in shapes}
        batch = {k: (self._to_device(batch[k]).to(torch.int32)
                     if k in ("tokens", "labels") else
                     self._to_device(batch[k])) for k in shapes}
        # keyed by the global batch's shapes, as bind() builds it
        prog = self._program({k: torch.empty(shapes[k], dtype=v.dtype,
                                             device="meta")
                              for k, v in batch.items()})
        self.params, self.opt_state, stats = prog(self.params,
                                                  self.opt_state, batch)
        return stats

    def recover(self, dead, drained: bool = False) -> Dict:
        raise ExecutorUnsupported(
            "SPMD fast path is single-program: a heterogeneous survivor "
            "set needs a HeteroTrainer rebind (from snapshot())")

    def join(self, nodes) -> Dict:
        raise ExecutorUnsupported(
            "SPMD fast path cannot grow in place; rebind from snapshot()")

    def snapshot(self, data_state: Optional[Dict] = None,
                 rng_seed: int = 0):
        """TrainState of copies: later steps do not change it.  On a
        ``ProcessMesh`` every rank takes part and the full state is
        gathered to global rank 0; the other ranks get None."""
        from repro_torch.ckpt import TrainState
        o = self.opt_state
        if self.distributed:
            mesh = self.mesh
            params = gather_tree(self.pspecs, self.params, mesh, to_root=True)
            m = gather_tree(self.ospecs.m, o.m, mesh, to_root=True)
            v = gather_tree(self.ospecs.v, o.v, mesh, to_root=True)
            if mesh.rank != 0:
                return None
        else:
            params, m, v = (tree_map(torch.clone, t)
                            for t in (self.params, o.m, o.v))
        return TrainState(step=int(o.step), params=params,
                          opt_state=adamw.AdamWState(o.step.clone(), m, v),
                          data_state=data_state or {}, rng_seed=rng_seed)


class SPMDServer:
    """The prefill and decode bundles run over a mesh: the counterpart of
    the reference's ``prefill_bundle(...).jit()`` and
    ``decode_bundle(...).jit()`` on one rank of a ``ProcessMesh`` (or on
    one card, without a mesh or on a mesh whose axes all have size 1).

    On a process mesh the rank holds its shards of the params
    (``param_shardings``) and serves its rows of the global batch
    ``shape.global_batch`` (``batch_spec``; ``rows`` cuts them): the
    prefill and decode steps take and return the rank's rows, as the
    bundles' specs place them (``build_mesh_prefill_step``,
    ``build_mesh_decode_step``).  The model gets the sequence and
    tensor-parallel contexts the train program gets
    (``SPMDExecutor._program``).  A rank's cache is its rows and, under
    TP, its heads (``init_cache``; ``sharding.shard_cache`` for how it
    differs from ``cache_shardings``); ``gather_cache`` and
    ``gather_rows`` put one program's cache and logits together.  Each
    step is built once into a ``ProgramCache`` under ("spmd-prefill" or
    "spmd-decode", backend signature, the rank's input shapes, mesh
    shape, strategy, rank).  The decode steps take the MoE dispatch
    ``DECODE_MOE_IMPL``, the prefill steps the model's."""

    def __init__(self, model: Model, params: Dict, mesh: Optional[Any] = None,
                 strategy: Optional[ShardingStrategy] = None,
                 shape: Optional[ShapeConfig] = None,
                 cache: Optional[ProgramCache] = None):
        if mesh is not None:
            strategy = strategy or ShardingStrategy()
            check_layout(mesh, strategy, model.arch)
            if not on_ranks(mesh) and \
                    any(n != 1 for n in mesh.shape.values()):
                raise TypeError(
                    f"SPMDServer over {dict(mesh.shape)}: an AbstractMesh "
                    f"only describes a layout; run over a ProcessMesh "
                    f"(launch/mesh.py) to place it on ranks")
        self.model = model
        self.mesh = mesh
        self.strategy = strategy
        self.global_batch = shape.global_batch if shape is not None else None
        self.cache = cache or ProgramCache()
        self.distributed = on_ranks(mesh)
        if self.distributed:
            if self.global_batch is None:
                raise ValueError("SPMDServer on a ProcessMesh needs shape=, "
                                 "whose global batch lays out the rows")
            self.pspecs = strategy.param_shardings(mesh, params)
            gb = self.global_batch
            self._model = dataclasses.replace(
                model, unshard=strategy.unshard_blocks(mesh, like=params),
                constrain=strategy.act_constrainer(mesh, gb),
                seq=strategy.seq_context(mesh, gb),
                tp=strategy.tp_context(mesh, model.arch))
            self.params = shard_tree(self.pspecs, params, mesh)
        else:
            self.pspecs, self._model, self.params = None, model, params
        self.device = tree_leaves(self.params)[0].device

    def rows(self, v):
        """This rank's rows of a global-batch array (all of them on one
        card)."""
        if not self.distributed:
            return v
        _, r0, r1 = batch_rows(self.strategy, self.mesh, self.global_batch)
        return v[r0:r1]

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch's rows of ``t`` from every rank's."""
        if not self.distributed:
            return t
        axis, _, _ = batch_rows(self.strategy, self.mesh, self.global_batch)
        if axis is None:
            return t
        return self.mesh.transport.all_gather(
            t, self.mesh.group(axis)[0], self.mesh.size(axis), 0)

    def _program(self, kind: str, shapes) -> Callable:
        mesh = self.mesh
        key = ("spmd-" + kind, kops.backend_signature(self.device), shapes,
               tuple(mesh.shape.items()) if mesh is not None else (),
               self.strategy, mesh.rank if self.distributed else 0)
        model = self._model
        if kind == "decode":
            model = dataclasses.replace(model, moe_impl=DECODE_MOE_IMPL)
        step = (build_mesh_prefill_step if kind == "prefill"
                else build_mesh_decode_step)
        return self.cache.get_or_build(key, lambda: step(model, mesh,
                                                         self.pspecs))

    @staticmethod
    def _shapes(tree) -> Tuple:
        return tuple((p, tuple(t.shape), str(t.dtype))
                     for p, t in tree_leaves_with_path(tree))

    def prefill(self, batch: Dict) -> torch.Tensor:
        """This rank's rows of the batch ({"tokens": [b, S], and the
        frontend's "frontend_embeds"}) -> its rows of the last position's
        logits [b, 1, V]."""
        return self._program("prefill", self._shapes(batch))(self.params,
                                                            batch)

    def init_cache(self, max_len: int) -> Dict:
        """This rank's empty cache for ``max_len`` positions: its rows of
        the global batch and, under TP, its heads."""
        rows = self.global_batch
        if self.distributed:
            _, r0, r1 = batch_rows(self.strategy, self.mesh, rows)
            rows = r1 - r0
        return self._model.init_cache(rows, max_len, self.device)

    def decode(self, token: torch.Tensor, cache: Dict, pos
               ) -> Tuple[torch.Tensor, Dict]:
        """One tick on this rank's rows: (tokens [b, 1], its cache, the
        position: a scalar or [b]) -> (logits [b, 1, V], its cache,
        written in place)."""
        prog = self._program("decode", self._shapes(
            {"token": token, "cache": cache,
             "pos": torch.as_tensor(pos)}))
        return prog(self.params, token, cache, pos)

    def shard_cache(self, cache: Dict) -> Dict:
        """This rank's part of a one-program cache of the global batch."""
        if not self.distributed:
            return cache
        return shard_cache(cache, self.model.arch, self.strategy, self.mesh,
                           self.global_batch)

    def gather_cache(self, cache: Dict) -> Dict:
        """One program's cache from every rank's part, on every rank."""
        if not self.distributed:
            return cache
        return gather_cache(cache, self.model.arch, self.strategy, self.mesh,
                            self.global_batch)


def check_layout(mesh, strategy: ShardingStrategy, arch: ArchConfig
                 ) -> None:
    """Raise ``NotImplementedError`` for a layout this data plane does not
    run: under TP over a model axis larger than 1, fewer query heads than
    ranks (``sharding.tp_heads``: a rank would compute none), fewer
    Mamba2 heads than ranks or several B / C groups
    (``sharding.ssm_heads``); the message names which.  Query heads that
    straddle kv groups run (``TPContext.pieces``)."""
    n = mesh.shape[strategy.model_axis]
    if strategy.strategy != "tp" or n == 1:
        return
    if arch.num_heads:
        tp_heads(arch, n, 0)
    if arch.ssm is not None:
        ssm_heads(arch, n, 0)
