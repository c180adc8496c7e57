"""Heterogeneous pipeline execution (paper §6), ``repro/runtime/pipeline.py``
in PyTorch.

Each PipelineInstance from the configuration engine is bound to tensors:
every replica holds its layers' params and Adam moments (layer-indexed,
the paper's unit of state).  A training step:

  1. per pipeline: ONE program per (template signature, microbatch
     count), built once and kept in a ProgramCache, runs the template's
     stage functions over every microbatch, accumulates the per-layer
     gradients and returns them with the per-microbatch NLL as a device
     tensor (no host sync inside the schedule).  ``warm_templates``
     builds the programs of the whole template set up front, so a
     reconfiguration swaps programs by lookup.  ``mode="eager"`` walks
     the explicit 1F1B schedule instead (``_run_eager``), stage by stage
     with per-stage autograd: the readable spec of what the program
     computes, with the same gradients;
  2. cross-pipeline sync at LAYER granularity: the engine's bucket plan
     through the bucketed data plane (``runtime/sync_exec.py``), a
     weighted average whose weights are minibatch sizes;
  3. the same global-norm clip and AdamW update on every replica, so
     replicas stay bitwise identical;
  4. on failure: the engine replans from the templates and emits a copy
     plan; layer states (params AND moments) are copied from the
     scheduled surviving replicas — recovery without a checkpoint — and
     the new pipeline set's programs come straight from the cache.  A
     join takes the same copy path (``handle_join``); ``snapshot``
     reassembles the canonical tree for ``ckpt/checkpoint.py``, and a
     restored ``opt_state`` seeds a new trainer's moments.

Every block of a stage runs the fused QKV GEMM and the fused residual-add
+ RMSNorm (``kernels/ops.py``) in both modes: CUDA kernels when the state
lies on the card, their plain versions on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.ckpt import TrainState
from repro_torch.core.adapt import AdaptationError
from repro_torch.core.engine import OobleckEngine
from repro_torch.core.reconfigure import PipelineInstance
from repro_torch.kernels import ops as kops
from repro_torch.models import Model
from repro_torch.models.layers import cross_entropy, embed, unembed
from repro_torch.optim import adamw
from repro_torch.runtime.executor import (Executor, ProgramCache, avals_of,
                                          template_signature, tree_spec)
from repro_torch.runtime.schedule import flat_schedule
from repro_torch.runtime.sync_exec import (BucketedSync, perlayer_global_sumsq,
                                           perlayer_sync)
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like

LayerState = Dict[str, Any]     # {"p": params, "m": moment1, "v": moment2}


# ----------------------------------------------------------------------
# Canonical layer-indexed parameter view
# ----------------------------------------------------------------------
def split_into_layers(model: Model, params: Dict) -> List[Dict]:
    """Full param tree -> [embed, block_0..block_{L-1}, head] per the
    cost-model layer indexing (embed = layer 0, head = layer L+1).
    A tied embedding is untied: the head stage gets its own copy."""
    L = model.arch.num_layers
    layers: List[Dict] = [{"embed": params["embed"]}]
    for i in range(L):
        layers.append(tree_map(lambda t: t[i], params["blocks"]))
    tail = {"final_norm": params["final_norm"]}
    tail["head"] = params.get("head", tree_map(torch.clone, params["embed"]))
    layers.append(tail)
    return layers


def zeros_like_tree(tree):
    return tree_map(lambda t: torch.zeros_like(t, dtype=torch.float32), tree)


# ----------------------------------------------------------------------
# Stage program
# ----------------------------------------------------------------------
def make_stage_fn(model: Model, kinds: Sequence[str]) -> Callable:
    """Stage function over its layer list:
    fn(layer_params, carry, labels, fe) -> carry' | (loss, nll),
    carry = (x, aux) with x = tokens for the first stage; ``fe``, the
    microbatch's frontend embeddings or None, goes ahead of the first
    stage's token embeddings.  The loss is nll + router_aux_loss_coef *
    aux (the coefficient is 0 outside the MoE family)."""
    arch = model.arch
    coef = arch.moe.router_aux_loss_coef if arch.moe is not None else 0.0

    def fn(layer_params: List[Dict], carry, labels, fe=None):
        x, aux = carry
        for kind, lp in zip(kinds, layer_params):
            if kind == "embed":
                x = embed(lp["embed"], x, model.dtype)
                if fe is not None:
                    x = torch.cat([fe.to(model.dtype), x], dim=1)
            elif kind == "block":
                x, aux = model.block(lp, x, aux)
            else:  # head
                x = model._norm(lp["final_norm"], x)
                logits = unembed(lp["head"], x)
                logits = logits[:, logits.shape[1] - labels.shape[1]:]
                # pre-shifted labels; the final position is excluded
                nll = cross_entropy(logits[:, :-1], labels[:, :-1])
                return nll + coef * aux, nll
        return x, aux
    return fn


# ----------------------------------------------------------------------
# One bound pipeline
# ----------------------------------------------------------------------
@dataclasses.dataclass
class PipelineRun:
    instance: PipelineInstance
    stage_layers: List[List[int]]           # per stage: its layer ids
    states: Dict[int, LayerState]           # layer id -> state (this replica)

    @property
    def num_stages(self) -> int:
        return len(self.stage_layers)

    @property
    def signature(self) -> Tuple[Tuple[int, int], ...]:
        return template_signature(self.instance.template)

    def all_stage_params(self) -> List[List[Dict]]:
        return [[self.states[l]["p"] for l in lids]
                for lids in self.stage_layers]


class HeteroTrainer(Executor):
    """Drives N heterogeneous pipeline replicas through train steps and
    failure recovery, with the engine for all planning and a
    template-keyed ProgramCache for all execution.  The device is the
    one ``params`` lie on.  ``opt_state`` (an ``adamw.AdamWState`` in
    the stacked-block layout, as ``CheckpointManager.restore`` returns
    it) seeds every replica's moments and the step count; without it
    both start at zero."""

    def __init__(self, model: Model, engine: OobleckEngine,
                 params: Dict, opt_cfg: adamw.AdamWConfig,
                 mode: str = "compiled", codec: str = "none",
                 sync_mode: Optional[str] = None,
                 opt_state: Optional[adamw.AdamWState] = None):
        if mode not in ("compiled", "eager"):
            raise ValueError(f"unknown mode {mode!r}")
        # the eager reference syncs on the per-layer path, as the JAX
        # package's does; the bucketed plane adds the same terms, but sums
        # the clip's global norm per bucket first
        sync_mode = sync_mode or ("bucketed" if mode == "compiled"
                                  else "perlayer")
        if sync_mode not in ("bucketed", "perlayer"):
            raise ValueError(f"unknown sync_mode {sync_mode!r}")
        if codec != "none" and sync_mode != "bucketed":
            raise ValueError("wire codecs ride the bucketed data plane only")
        self.model = model
        self.engine = engine
        self.opt_cfg = opt_cfg
        self.mode = mode
        self.cache = ProgramCache()
        self.sync_mode = sync_mode
        self.codec = codec
        layers = split_into_layers(model, params)
        moments = None
        if opt_state is not None:
            moments = (split_into_layers(model, opt_state.m),
                       split_into_layers(model, opt_state.v))
        self.device = tree_leaves(layers[0])[0].device
        self.opt_step = (torch.zeros((), dtype=torch.int32, device=self.device)
                         if opt_state is None else
                         opt_state.step.to(self.device, torch.int32).clone())
        self.num_layers = len(layers)
        self._kind = (["embed"] + ["block"] * model.arch.num_layers
                      + ["head"])
        # shape/dtype skeleton of every layer: programs for templates
        # that are not currently instantiated are built from it
        self._layer_avals = [avals_of(l) for l in layers]
        self._bsync = BucketedSync(self.cache, opt_cfg, self._layer_avals,
                                   codec=codec)
        self._bucket_plan_cache = None
        self.runs: List[PipelineRun] = [
            self._bind_run(inst, layers, moments=moments)
            for inst in self._bound_instances()]
        engine.attach_executor(self)
        self.bind()

    def _bound_instances(self) -> List[PipelineInstance]:
        """Which pipeline instances THIS process binds full state for.
        The single-process trainer binds all of them; the multi-process
        shard trainer (runtime/multihost.py) overrides this to bind only
        the replicas its process leads."""
        return list(self.engine.instances)

    # ------------------------------------------------------------------
    def _bind_run(self, inst: PipelineInstance, layers: Optional[List[Dict]],
                  state_fn: Optional[Callable[[str, int], LayerState]] = None,
                  moments: Optional[Tuple[List[Dict], List[Dict]]] = None
                  ) -> PipelineRun:
        stage_layers = [list(range(st.layer_start, st.layer_end))
                        for st in inst.template.stages]
        states: Dict[int, LayerState] = {}
        for lids in stage_layers:
            for l in lids:
                # ALWAYS copy: replicas never alias layer state
                if state_fn is not None:
                    # the state a layer's owner receives comes from the
                    # replica the transfer plan scheduled as its source
                    src = state_fn(inst.layer_owners(l)[0], l)
                    states[l] = tree_map(torch.clone, src)
                elif moments is not None:
                    states[l] = tree_map(torch.clone, {
                        "p": layers[l], "m": moments[0][l],
                        "v": moments[1][l]})
                else:
                    p = layers[l]
                    states[l] = {"p": tree_map(torch.clone, p),
                                 "m": zeros_like_tree(p),
                                 "v": zeros_like_tree(p)}
        return PipelineRun(inst, stage_layers, states)

    # ------------------------------------------------------------------
    # Program cache plumbing
    # ------------------------------------------------------------------
    def _batch_spec(self, M: int, fe: Optional[torch.Tensor] = None) -> Tuple:
        """Shape and dtype of the stacked tokens (and labels), and of the
        stacked frontend embeddings where the microbatches carry them.
        Without ``fe``, a frontend architecture's default: [M, b,
        frontend_tokens, d_model] fp32."""
        b = self.engine.config.microbatch
        s = self.engine.profile.seq_len
        a = self.model.arch
        if fe is not None:
            fe_spec = (tuple(fe.shape), str(fe.dtype))
        elif a.frontend is not None:
            fe_spec = ((M, b, a.frontend_tokens, a.d_model), str(torch.float32))
        else:
            fe_spec = None
        return ((M, b, s), "int32", fe_spec)

    def _grads_program(self, sig: Tuple[Tuple[int, int], ...], M: int,
                       fe: Optional[torch.Tensor] = None) -> Callable:
        """Per-(template signature, batch spec) step program: every
        microbatch through the stage functions, per-layer gradients
        accumulated, the mean returned with the per-microbatch NLL."""
        key = ("grads", kops.backend_signature(self.device), sig,
               self._batch_spec(M, fe))

        def build() -> Callable:
            kinds = [[self._kind[l] for l in range(u, v)] for (u, v) in sig]
            fns = [make_stage_fn(self.model, k) for k in kinds]

            def grads_fn(stage_params, tokens, labels, fes=None):
                flat = tree_leaves(stage_params)
                leaves = [t.detach().requires_grad_(True) for t in flat]
                params = tree_unflatten_like(stage_params, leaves)
                gsum, nlls = None, []
                zero = torch.zeros((), dtype=torch.float32, device=tokens.device)
                for i in range(M):
                    carry = (tokens[i], zero)
                    fe_i = fes[i] if fes is not None else None
                    for fn, sp in zip(fns, params):
                        carry = fn(sp, carry, labels[i], fe_i)
                    loss, nll = carry
                    g = torch.autograd.grad(loss, leaves)
                    gsum = (list(g) if gsum is None
                            else [a + b for a, b in zip(gsum, g)])
                    nlls.append(nll.detach())
                grads = [a / M for a in gsum]
                return tree_unflatten_like(stage_params, grads), torch.stack(nlls)
            return grads_fn

        return self.cache.get_or_build(key, build)

    def _update_program(self, l: int) -> Callable:
        """Per-layer-structure AdamW update (the perlayer sync path)."""
        key = ("update", tree_spec(self._layer_avals[l]))

        def build() -> Callable:
            layer_cfg = dataclasses.replace(self.opt_cfg, clip_norm=0.0)

            def upd(st, g, scale, step):
                g = tree_map(lambda t: t * scale, g)
                new_p, new_opt, _ = adamw.update(
                    layer_cfg, st["p"], g,
                    adamw.AdamWState(step, st["m"], st["v"]))
                return {"p": new_p, "m": new_opt.m, "v": new_opt.v}
            return upd

        return self.cache.get_or_build(key, build)

    # ------------------------------------------------------------------
    # Warming
    # ------------------------------------------------------------------
    def _bucket_plan(self):
        """The engine's sync plan bound for execution (cached until the
        next bind): per bucket, the replica lead owners' pods drive the
        hierarchical reduction path."""
        if self._bucket_plan_cache is None:
            sync_plan = self.engine.sync_plan()
            topo = self.engine.topology
            pods = [[topo.pod_of(inst.layer_owners(b.layer_start)[0])
                     for inst in self.engine.instances]
                    for b in sync_plan]
            self._bucket_plan_cache = self._bsync.exec_plan(sync_plan, pods)
        return self._bucket_plan_cache

    def bind(self) -> None:
        """Ensure programs for the CURRENT pipeline set + batch plan are
        cached (pure lookups after warm_templates())."""
        self._bucket_plan_cache = None
        if self.mode == "compiled":
            mb_of = {id(inst): M for inst, M in zip(
                self.engine.instances, self.engine.batch.num_microbatches)}
            for run in self.runs:
                self._grads_program(run.signature, mb_of[id(run.instance)])
        if self.sync_mode == "bucketed":
            plan = self._bucket_plan()
            self._bsync.bind_plan(plan)
            # a reconfiguration may have changed the bucket layout or
            # replica count: stale error-feedback residuals go
            self._bsync.retain_residuals(plan, len(self.engine.instances))
        else:
            for l in range(self.num_layers):
                self._update_program(l)

    def warm_templates(self, mb_counts: Optional[Iterable[int]] = None
                       ) -> Dict[str, int]:
        """Build step programs for EVERY template x every reachable
        microbatch count (1..total_mb by default), and the bucket
        programs of every reachable layout, so any reconfiguration swaps
        programs by lookup with zero builds.  The eager walker has no step
        programs to build."""
        if self.mode != "compiled":
            return self.cache.stats.as_dict()
        if mb_counts is None:
            total_mb = (self.engine.config.global_batch
                        // self.engine.config.microbatch)
            mb_counts = range(1, total_mb + 1)
        mb_counts = list(mb_counts)
        for tpl in self.engine.templates.values():
            for M in mb_counts:
                self._grads_program(template_signature(tpl), M)
        if self.sync_mode == "bucketed":
            self._bsync.warm(
                self.engine.templates.values(),
                [l.param_bytes for l in self.engine.profile.layers],
                self.engine.config.bucket_cap_bytes)
        self.bind()
        return self.cache.stats.as_dict()

    # ------------------------------------------------------------------
    # One pipeline's iteration -> per-layer grad means + per-mb NLL
    # ------------------------------------------------------------------
    def _batch(self, microbatches: List[Dict]
               ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """Stacked [M, b, s] int32 tokens and labels on the device, and the
        stacked [M, b, F, d] frontend embeddings where the microbatches
        carry them (else None).  On the card the copy leaves a pinned
        host buffer without blocking the host: no step synchronizes with
        the device."""
        def to_device(host):
            if self.device.type == "cuda":
                return host.pin_memory().to(self.device, non_blocking=True)
            return host

        def stack(key, dtype):
            arr = np.stack([np.asarray(b[key]) for b in microbatches])
            return to_device(torch.from_numpy(arr.astype(dtype)))
        fe = None
        if microbatches[0].get("frontend_embeds") is not None:
            fe = stack("frontend_embeds", np.float32)
        return stack("tokens", np.int32), stack("labels", np.int32), fe

    def _run_compiled(self, run: PipelineRun, microbatches: List[Dict]
                      ) -> Tuple[Dict[int, Any], torch.Tensor]:
        tokens, labels, fe = self._batch(microbatches)
        prog = self._grads_program(run.signature, len(microbatches), fe)
        gstages, nll = prog(run.all_stage_params(), tokens, labels, fe)
        grads: Dict[int, Any] = {}
        for s, lids in enumerate(run.stage_layers):
            for j, l in enumerate(lids):
                grads[l] = gstages[s][j]
        return grads, nll

    def _run_eager(self, run: PipelineRun, microbatches: List[Dict]
                   ) -> Tuple[Dict[int, Any], torch.Tensor]:
        """Reference path: walks the explicit 1F1B schedule, one stage at
        a time with per-stage autograd.  An F op runs stage ``s`` on its
        predecessor's (x, aux), detached into leaves that require grad,
        and keeps the (outputs, inputs) pair; the matching B op takes the
        gradient of those outputs against the stage's parameters and both
        inputs, and hands (dx, daux) to stage ``s - 1`` as the cotangents
        of its (x, aux).  The last stage seeds (1, 0) for (loss, nll).
        Each stage's gradients are summed over microbatches in ascending
        order and divided by M, the step program's order.  Losses stay
        on the device: nothing here reads back to the host."""
        S, M = run.num_stages, len(microbatches)
        tokens, labels, fes = self._batch(microbatches)
        fns = [make_stage_fn(self.model, [self._kind[l] for l in lids])
               for lids in run.stage_layers]
        stage_params = run.all_stage_params()
        leaves = [[t.detach().requires_grad_(True) for t in tree_leaves(sp)]
                  for sp in stage_params]
        params = [tree_unflatten_like(sp, lv)
                  for sp, lv in zip(stage_params, leaves)]
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        saved: Dict[Tuple[int, int], Tuple[Any, List[torch.Tensor]]] = {}
        cots: Dict[Tuple[int, int], List[torch.Tensor]] = {}
        gsum: List[Optional[List[torch.Tensor]]] = [None] * S
        nlls: List[torch.Tensor] = []

        for s, op, mb in flat_schedule(S, M):
            if op == "F":
                if s == 0:
                    inputs, carry = [], (tokens[mb], zero)
                else:
                    inputs = [t.detach().requires_grad_(True)
                              for t in saved[(s - 1, mb)][0]]
                    carry = tuple(inputs)
                fe = fes[mb] if fes is not None and s == 0 else None
                out = fns[s](params[s], carry, labels[mb], fe)
                saved[(s, mb)] = (out, inputs)
                if s == S - 1:
                    nlls.append(out[1].detach())
                    cots[(s, mb)] = [torch.ones_like(out[0]),
                                     torch.zeros_like(out[1])]
                continue
            out, inputs = saved.pop((s, mb))
            pairs = [(o, c) for o, c in zip(out, cots.pop((s, mb)))
                     if o.requires_grad]
            wrt = leaves[s] + inputs
            g = torch.autograd.grad([o for o, _ in pairs], wrt,
                                    grad_outputs=[c for _, c in pairs],
                                    allow_unused=True)
            g = [torch.zeros_like(w) if gi is None else gi
                 for gi, w in zip(g, wrt)]
            if inputs:
                cots[(s - 1, mb)] = g[len(leaves[s]):]
                g = g[:len(leaves[s])]
            gsum[s] = g if gsum[s] is None else [a + b
                                                 for a, b in zip(gsum[s], g)]

        grads: Dict[int, Any] = {}
        for s, lids in enumerate(run.stage_layers):
            gs = tree_unflatten_like(stage_params[s], [a / M for a in gsum[s]])
            for j, l in enumerate(lids):
                grads[l] = gs[j]
        return grads, torch.stack(nlls)

    def _run_pipeline(self, run: PipelineRun, microbatches: List[Dict]
                      ) -> Tuple[Dict[int, Any], torch.Tensor]:
        if self.mode == "compiled":
            return self._run_compiled(run, microbatches)
        return self._run_eager(run, microbatches)

    def train_step(self, per_pipeline_batches: List[List[Dict]]) -> Dict:
        """per_pipeline_batches[i] = list of N_b,i microbatch dicts.
        Metrics come back as device tensors; nothing here reads the
        device back to the host."""
        if len(per_pipeline_batches) != len(self.runs):
            raise ValueError(f"{len(per_pipeline_batches)} batch lists for "
                             f"{len(self.runs)} pipelines")
        all_grads: List[Dict[int, Any]] = []
        nlls, weights = [], []
        for run, mbs in zip(self.runs, per_pipeline_batches):
            g, nll = self._run_pipeline(run, mbs)
            all_grads.append(g)
            nlls.append(nll)
            weights.append(len(mbs))
        g = None    # the list holds the last replica's gradients alone
        grad_norm = self._sync_and_update(all_grads, weights)
        loss = sum(torch.sum(n) for n in nlls) / float(sum(weights))
        return {"loss": loss, "grad_norm": grad_norm,
                "num_pipelines": len(self.runs)}

    def step(self, batches: List[List[Dict]]) -> Dict:
        return self.train_step(batches)

    # ------------------------------------------------------------------
    # The sync tail: cross-replica sync + global-norm clip + AdamW
    # ------------------------------------------------------------------
    def _sync_and_update(self, all_grads: List[Dict[int, Any]],
                         weights: List[int]) -> torch.Tensor:
        if self.sync_mode == "bucketed":
            plan = self._bucket_plan()
            red = self._bsync.reduce(plan, all_grads, weights)
            grad_norm = torch.sqrt(sum(red.sumsqs))
            scale = self._clip_scale(grad_norm)
            # ---- commit phase: the ONLY mutating part of the step ----
            self._bsync.commit_residuals(red)
            step_in = self.opt_step             # adamw.update increments
            self.opt_step = self.opt_step + 1
            for run in self.runs:
                self._bsync.update(plan, red.flats, run.states, scale,
                                   step_in)
            return grad_norm

        # ---- per-layer oracle (paper Figure 9) ----
        synced = perlayer_sync(all_grads, weights, self.num_layers)
        # the replicas' own gradients are spent: free them before the
        # update (a model that fills the card has room for one copy)
        all_grads.clear()
        grad_norm = torch.sqrt(perlayer_global_sumsq(synced, self.num_layers))
        scale = self._clip_scale(grad_norm)
        step_in = self.opt_step
        self.opt_step = self.opt_step + 1
        for run in self.runs:
            for l in sorted(run.states):
                run.states[l] = self._update_program(l)(
                    run.states[l], synced[l], scale, step_in)
        return grad_norm

    def _clip_scale(self, grad_norm: torch.Tensor) -> torch.Tensor:
        if self.opt_cfg.clip_norm:
            return torch.clamp(self.opt_cfg.clip_norm
                               / torch.clamp(grad_norm, min=1e-12), max=1.0)
        return torch.ones((), dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    # Failure recovery: copy layer states from the SCHEDULED survivors
    # ------------------------------------------------------------------
    def _states_by_node(self, exclude: Set[str] = frozenset()
                        ) -> Dict[str, Dict[int, LayerState]]:
        """node -> layer -> state, for every surviving owner."""
        by_node: Dict[str, Dict[int, LayerState]] = {}
        for run in self.runs:
            for l, st in run.states.items():
                for node in run.instance.layer_owners(l):
                    if node not in exclude:
                        by_node.setdefault(node, {})[l] = st
        return by_node

    def _apply_transfer_plan(self, result, by_node: Dict[str, Dict[int, LayerState]],
                             dead: Set[str]) -> Dict:
        """Rebind every pipeline, sourcing each moved layer from the
        replica the transfer scheduler routed it from, then swap programs
        by cache lookup."""
        plan = self.engine.transfer_plan(result, dead=dead)
        fallback: Dict[int, LayerState] = {}
        for node_states in by_node.values():
            for l, st in node_states.items():
                fallback.setdefault(l, st)
        missing = [l for l in range(self.num_layers) if l not in fallback]
        if missing:
            raise RuntimeError(f"layers {missing} lost (>f failures in a stage)")

        def state_for(node: str, layer: int) -> LayerState:
            held = by_node.get(node, {})
            if layer in held:          # the node already owns this layer
                return held[layer]
            src = plan.source_of(node, layer)
            if src is not None and layer in by_node.get(src, {}):
                return by_node[src][layer]
            return fallback[layer]

        self.runs = [self._bind_run(inst, layers=None, state_fn=state_for)
                     for inst in self._bound_instances()]
        self.bind()        # swap programs by lookup (zero builds if warm)
        stats = plan.stats()
        return {"copied_bytes": result.copy_bytes(),
                "num_pipelines": len(self.runs),
                "cache": self.cache.stats.as_dict(),
                "transfer": stats,
                "breakdown": {"replan": result.replan_seconds,
                              "transfer": stats["seconds"],
                              "compile": 0.0}}

    def _apply_adaptation(self, plan, dead: Set[str],
                          drained: bool = False) -> Dict:
        """Commit a ReCycle adaptation: drop the damaged replicas' runs,
        keep the survivors' states untouched, rebind — copy-free and
        build-free."""
        ref_iter = self.engine.adaptation_reference_iteration(dead)
        breakdown = self.engine.adapt_cost_model().breakdown(plan, ref_iter)
        kept = {id(inst) for inst in plan.instances}
        self.engine.apply_adaptation(plan, dead=dead, drained=drained)
        self.runs = [run for run in self.runs if id(run.instance) in kept]
        self.bind()
        return {"policy": "adapt", "copied_bytes": 0,
                "num_pipelines": len(self.runs),
                "parked_nodes": list(plan.parked_nodes),
                "cache": self.cache.stats.as_dict(),
                "breakdown": breakdown}

    def handle_failure(self, dead_nodes: set, drained: bool = False,
                       policy: Optional[str] = None) -> Dict:
        """Route a failure through the recovery policy (the engine
        config's ``recovery_policy`` unless overridden): "auto" picks per
        event from predicted downtime; "adapt" and "spare" fall back to
        the full replan when infeasible."""
        dead = set(dead_nodes)
        policy = policy or self.engine.config.recovery_policy
        decision = None
        if policy == "auto":
            decision = self.engine.select_recovery_policy(dead)
            policy = decision["policy"]
        info = None
        if policy == "adapt":
            try:
                info = self._apply_adaptation(
                    self.engine.plan_adaptation(dead), dead, drained=drained)
            except AdaptationError:
                policy = "replan"
        elif policy == "spare":
            try:
                result = self.engine.plan_spare_promotion(dead)
                by_node = self._states_by_node(exclude=dead)
                self.engine.apply_spare_promotion(result, dead=dead,
                                                  drained=drained)
                info = self._apply_transfer_plan(result, by_node, dead)
                info["policy"] = "spare"
            except AdaptationError:
                policy = "replan"
        if info is None:
            by_node = self._states_by_node(exclude=dead)
            result = self.engine.handle_failure(dead, drained=drained)
            info = self._apply_transfer_plan(result, by_node, dead)
            info["policy"] = "replan"
        if decision is not None:
            info["decision"] = decision["policy"]
        return info

    def recover(self, dead: Set[str], drained: bool = False) -> Dict:
        return self.handle_failure(set(dead), drained=drained)

    def handle_join(self, new_nodes: list) -> Dict:
        """Elastic scale-up: replan over the larger cluster and seed every
        new pipeline's layer states from existing replicas (the same copy
        path as failure recovery: paper §5 applies to joins)."""
        by_node = self._states_by_node()
        result = self.engine.handle_join(list(new_nodes))
        return self._apply_transfer_plan(result, by_node, set())

    def join(self, nodes: List[str]) -> Dict:
        return self.handle_join(list(nodes))

    # ------------------------------------------------------------------
    def replica_divergence(self) -> float:
        """Max abs param difference across replicas (must be 0)."""
        worst = torch.zeros((), dtype=torch.float32, device=self.device)
        for l in range(self.num_layers):
            reps = [r.states[l]["p"] for r in self.runs if l in r.states]
            for other in reps[1:]:
                for a, b in zip(tree_leaves(reps[0]), tree_leaves(other)):
                    worst = torch.maximum(
                        worst, torch.max(torch.abs(a.float() - b.float())))
        return float(worst)

    def _assemble(self, field: str) -> Dict:
        """Canonical full tree of ``field`` ('p', 'm' or 'v'; stacked
        blocks) from the first replica holding each layer.  Leaves are
        copies: later steps must not change what is handed out."""
        states: Dict[int, LayerState] = {}
        for run in self.runs:
            for l, st in run.states.items():
                states.setdefault(l, st)
        blocks = [states[1 + i][field]
                  for i in range(self.model.arch.num_layers)]
        tail = states[self.num_layers - 1][field]
        tree = {"embed": tree_map(torch.clone, states[0][field]["embed"]),
                "blocks": tree_map(lambda *xs: torch.stack(xs), *blocks),
                "final_norm": tree_map(torch.clone, tail["final_norm"])}
        if "head" in tail:
            tree["head"] = tree_map(torch.clone, tail["head"])
        return tree

    def full_params(self) -> Dict:
        """Canonical full param tree (for checkpoints and evaluation)."""
        return self._assemble("p")

    def snapshot(self, data_state: Optional[Dict] = None, rng_seed: int = 0):
        """TrainState (``ckpt/checkpoint.py``) of params and both Adam
        moments in the canonical stacked-block layout, on the device;
        ``CheckpointManager.save`` takes it to the host."""
        opt = adamw.AdamWState(self.opt_step.clone(), self._assemble("m"),
                               self._assemble("v"))
        return TrainState(step=int(self.opt_step), params=self._assemble("p"),
                          opt_state=opt, data_state=data_state or {},
                          rng_seed=rng_seed)
