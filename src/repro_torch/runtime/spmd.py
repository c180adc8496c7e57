"""SPMD step builders and the homogeneous fast path
(``repro/runtime/spmd.py``).

With zero failures all Oobleck pipelines run the same template, and the
whole job folds into ONE train program over the global batch.  The step
builders give that program and its serving siblings; the bundles pair
each with the sharding specs of its inputs and outputs
(``runtime/sharding.py``), which the dry-run (``launch/dryrun.py``)
prices without running anything.

``SPMDExecutor`` runs the train program behind the ``Executor``
interface.  This slice runs it on one card: a ``mesh`` is accepted only
when every axis has size 1 (the identity layout); the data plane that
runs the specs over ``torch.distributed`` across cards is ROADMAP item
17b.  Its ``recover``/``join`` raise ``ExecutorUnsupported`` by design:
one SPMD program cannot express a heterogeneous survivor set, so the
engine keeps the plan consistent and the caller rebinds a
``HeteroTrainer`` (``runtime/pipeline.py``) from ``snapshot()``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.runtime.executor import (Executor, ExecutorUnsupported,
                                          ProgramCache)
from repro_torch.runtime.sharding import ShardingStrategy
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like


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


def apply_donated(cfg: adamw.AdamWConfig, params, grads: List,
                  state: adamw.AdamWState):
    """``adamw.apply`` written into ``params`` and the moments in place,
    leaf by leaf, with each gradient dropped from ``grads`` (a list in
    ``tree_leaves(params)`` order) once used: the update holds one
    leaf's temporaries at a time, as the reference's donated program
    does, not a second copy of the state.  The arithmetic is
    ``adamw.apply``'s, element for element.  Returns (the new state,
    {"lr", "grad_norm"})."""
    gnorm = adamw.global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                         max=1.0) if cfg.clip_norm else None)
    lr = adamw.schedule(cfg, state.step + 1)
    for i, (p, m, v) in enumerate(zip(tree_leaves(params),
                                      tree_leaves(state.m),
                                      tree_leaves(state.v))):
        g, grads[i] = grads[i].float(), None
        if scale is not None:
            g = g * scale.to(g.dtype)
        (p2,), st, _ = adamw.update(cfg, [p], [g],
                                    adamw.AdamWState(state.step, [m], [v]))
        p.copy_(p2)
        m.copy_(st.m[0])
        v.copy_(st.v[0])
    return (adamw.AdamWState(state.step + 1, state.m, state.v),
            {"lr": lr, "grad_norm": gnorm})


def build_train_step(model: Model, opt_cfg: adamw.AdamWConfig) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, stats); params
    and moments are updated in place (``apply_donated``)."""
    def train_step(params, opt_state, batch):
        loss, grads, metrics = loss_and_grads(model, params, batch)
        grads = tree_leaves(grads)
        opt2, stats = apply_donated(opt_cfg, params, grads, opt_state)
        return params, opt2, {"loss": loss,
                              **{k: v.detach() for k, v in metrics.items()},
                              **stats}
    return train_step


def build_prefill_step(model: Model) -> Callable:
    def prefill_step(params, batch):
        return model.prefill(params, batch["tokens"],
                             batch.get("frontend_embeds"))
    return prefill_step


def build_decode_step(model: Model) -> Callable:
    def decode_step(params, token, cache, pos):
        return model.decode_step(params, token, cache, pos)
    return decode_step


# ----------------------------------------------------------------------
# Steps with the specs of their inputs and outputs
# ----------------------------------------------------------------------
@dataclasses.dataclass
class StepBundle:
    """A step function with the specs (``runtime/sharding.py``) of its
    positional inputs and of its outputs.  The reference's ``.jit`` has
    no counterpart: the port runs the function as it is."""

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
    return StepBundle(fn=build_prefill_step(model),
                      in_specs=(pspec, batch_spec),
                      out_specs=(bspec[0] if bspec else None,))


def decode_bundle(model: Model, strategy: ShardingStrategy, mesh,
                  params_shape: Any, cache_shape: Any,
                  shape: ShapeConfig) -> StepBundle:
    pspec = strategy.param_shardings(mesh, params_shape)
    cspec = strategy.cache_shardings(mesh, cache_shape, shape.global_batch)
    bspec = strategy.batch_spec(mesh, shape.global_batch)
    return StepBundle(fn=build_decode_step(model),
                      in_specs=(pspec, bspec, cspec, ()),
                      out_specs=(bspec, cspec))


# ----------------------------------------------------------------------
# The homogeneous fast path behind the Executor interface
# ----------------------------------------------------------------------
class SPMDExecutor(Executor):
    """Zero-failure homogeneous fast path: the whole job is ONE train
    program over the global batch (DESIGN.md §8), built once into a
    ``ProgramCache`` under ("spmd-train", backend signature, batch
    shapes), so steady stepping is a cache hit and tests assert one
    build.  The device is the one ``params`` lie on; the executor keeps
    its own copy of them."""

    def __init__(self, model: Model, params: Dict,
                 opt_cfg: adamw.AdamWConfig, mesh: Optional[Any] = None,
                 strategy: Optional[ShardingStrategy] = None,
                 shape: Optional[ShapeConfig] = None,
                 engine: Optional[Any] = None,
                 cache: Optional[ProgramCache] = None):
        if mesh is not None and any(n != 1 for n in mesh.shape.values()):
            raise NotImplementedError(
                f"SPMDExecutor over a mesh of {dict(mesh.shape)}: running "
                f"the sharding specs across cards is ROADMAP item 17b; this "
                f"slice accepts only a mesh whose axes all have size 1")
        self.model = model
        self.opt_cfg = opt_cfg
        self.mesh = mesh
        self.strategy = strategy
        self.shape = shape
        self.engine = engine
        self.cache = cache or ProgramCache()
        # sole ownership: every step updates these leaves in place
        self.params = tree_map(lambda t: t.detach().clone(), params)
        self.opt_state = adamw.init(self.params)
        self.device = tree_leaves(self.params)[0].device
        if engine is not None and hasattr(engine, "attach_executor"):
            engine.attach_executor(self)
        self.bind()

    # ------------------------------------------------------------------
    def _program(self, batch: Dict) -> Callable:
        """The train program for ``batch``'s shapes.  On a mesh whose
        axes all have size 1 every spec is the identity layout, so the
        program is ``build_train_step``'s with or without one."""
        key = ("spmd-train", kops.backend_signature(self.device),
               tuple(sorted((k, tuple(v.shape), str(v.dtype))
                            for k, v in batch.items())))
        return self.cache.get_or_build(
            key, lambda: build_train_step(self.model, self.opt_cfg))

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

    def step(self, batch: Dict) -> Dict:
        batch = {k: (self._to_device(v).to(torch.int32)
                     if k in ("tokens", "labels") else self._to_device(v))
                 for k, v in batch.items() if not k.startswith("_")}
        prog = self._program(batch)
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
        """TrainState of copies: later steps do not change it."""
        from repro_torch.ckpt import TrainState
        o = self.opt_state
        return TrainState(step=int(o.step),
                          params=tree_map(torch.clone, self.params),
                          opt_state=adamw.AdamWState(
                              o.step.clone(), tree_map(torch.clone, o.m),
                              tree_map(torch.clone, o.v)),
                          data_state=data_state or {}, rng_seed=rng_seed)
