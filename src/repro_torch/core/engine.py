"""Oobleck ConfigurationEngine: cluster-wide planning (paper §3.3–3.4).

The paper splits responsibilities between one cluster-wide
*ConfigurationEngine* (planning, policy selection, reconfiguration-epoch
assignment) and per-node *ExecutionEngines* (device state, compiled
programs).  This module is the configuration side: it owns NO device
state — instances, batch plans, copy plans and cost models only — so a
coordinator process can run it without touching an accelerator, while
every worker process keeps a deterministic replica of it for agreement
(runtime/multihost.py; fingerprints prove the replicas planned the same
transition).  ``OobleckEngine`` remains as an alias for the historical
single-process name.

Ties the planning artifacts together:

  bootstrap:  n0 (memory floor) -> node spec -> pipeline templates
              -> instantiation plan -> pipeline instances + batch plan
  on event:   failure  -> Reconfigurator (reinstantiate/borrow/merge)
                          -> state-copy plan -> batch redistribution
              join     -> global re-instantiation over the larger cluster
              warning  -> drain flag (finish the in-flight iteration)
  exit:       InsufficientReplicas -> checkpoint + raise (user restarts
              later from the stored progress)

The engine is runtime-agnostic through ONE concrete seam: every runtime
implements the Executor interface (runtime/executor.py — bind / step /
recover / join / snapshot) and registers itself with
``attach_executor``.  Cluster events from the monitor are then routed to
the executor, which replans through the engine and swaps its compiled
programs by cache lookup.  The heterogeneous trainer
(runtime/pipeline.py), the homogeneous SPMD fast path
(runtime/spmd.py) and the discrete-event simulator's Oobleck policy
(sim/policies.py) all plug in this way; they only differ in what
"executing an iteration" means.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Dict, List, Optional, Sequence, Set

from repro_torch.core import adapt as cm_adapt
from repro_torch.core import cost_model as cm
from repro_torch.core.adapt import AdaptationError, AdaptCostModel, AdaptPlan
from repro_torch.core.batch import BatchPlan
from repro_torch.core.instantiator import InstantiationPlan, choose_plan
from repro_torch.core.monitor import ClusterEvent, NodeChangeMonitor
from repro_torch.core.planner import PipelinePlanner, estimate_iteration_time
from repro_torch.core.reconfigure import (CopyTask, InsufficientReplicasError,
                                    PipelineInstance, ReconfigResult,
                                    Reconfigurator, _layer_state_bytes)
from repro_torch.core import sync as cm_sync
from repro_torch.core.sync import SyncBucket, build_sync_plan
from repro_torch.core.templates import (NodeSpec, PipelineTemplate,
                                  generate_node_spec)


@dataclasses.dataclass
class EngineConfig:
    fault_tolerance: int                 # f
    global_batch: int
    microbatch: int
    gpus_per_node: int = 1
    n0_override: Optional[int] = None    # force n0 (tests / experiments)
    planner_mode: str = "fast"
    max_stages: Optional[int] = None
    bucket_cap_bytes: int = 64 * 1024 * 1024
    # pod size for the default recovery-data-plane topology (DESIGN.md
    # §9): consecutive nodes share a pod/ICI; pods talk over DCN
    nodes_per_pod: int = 8
    # wire codec for cross-replica gradient sync (runtime/compression
    # .py): priced by the shared sync cost model AND executed by the
    # bucketed data plane, so modeled and real wire bytes agree
    codec: str = "none"
    # failure response: "replan" (full reconfiguration, the paper's
    # default), "adapt" (ReCycle-style microbatch re-routing to
    # surviving replicas), "spare" (promote parked hot spares into the
    # dead slots), or "auto" (per-event selection by predicted downtime)
    recovery_policy: str = "replan"
    # auto refuses adaptations whose steady-state iteration would exceed
    # this multiple of the predicted post-replan iteration — forces a
    # consolidating replan instead of limping on overloaded survivors
    adapt_max_slowdown: float = 1.5


@dataclasses.dataclass
class EngineMetrics:
    reconfigurations: int = 0
    restarts: int = 0
    total_copy_bytes: int = 0
    lost_iterations: int = 0
    planning_seconds: float = 0.0
    adaptations: int = 0
    spare_promotions: int = 0


class ConfigurationEngine:
    def __init__(self, profile: cm.ModelProfile, nodes: Sequence[str],
                 config: EngineConfig,
                 monitor: Optional[NodeChangeMonitor] = None,
                 on_checkpoint: Optional[Callable[[], None]] = None,
                 topology=None):
        self.profile = profile
        self.config = config
        self._topology = topology      # runtime.transfer.Topology or None
        self._topology_auto = topology is None
        # node placement order for the auto-built topology; joins append
        # here so late arrivals get real pod slots instead of staying
        # singleton/DCN forever
        self._placement_order = list(nodes)
        self.monitor = monitor or NodeChangeMonitor()
        self.monitor.subscribe(self._on_event)
        self.on_checkpoint = on_checkpoint
        self.metrics = EngineMetrics()
        # the runtime bound to this engine (Executor interface); cluster
        # events are routed through it so state rebuild and program
        # swaps happen together with replanning
        self.executor = None
        # nodes with a pending preemption warning: the runtime finishes
        # the in-flight iteration before they leave, so their eventual
        # failure loses no work (truthy iff a drain is pending)
        self.draining: Set[str] = set()
        self.stopped = False
        # reconfiguration epoch: bumped on every APPLIED reconfiguration
        # (failure, join, adaptation, spare promotion).  In multi-process
        # deployments survivors agree on the epoch at which they switch
        # templates (two-phase, runtime/coordination.py); single-process
        # runs just observe it as a counter.
        self.epoch = 0

        t0 = _time.perf_counter()
        n0 = (config.n0_override if config.n0_override is not None
              else profile.min_nodes(config.gpus_per_node))
        self.spec: NodeSpec = generate_node_spec(
            N=len(nodes), f=config.fault_tolerance, n0=n0,
            max_size=profile.num_layers)
        planner = PipelinePlanner(profile, config.gpus_per_node,
                                  mode=config.planner_mode,
                                  max_stages=config.max_stages)
        self.templates: Dict[int, PipelineTemplate] = planner.plan_all(
            self.spec.sizes)
        self.planner = planner
        self.reconf = Reconfigurator(self.templates, self.spec, profile,
                                     config.global_batch, config.microbatch)
        plan = choose_plan(self.templates, self.spec, len(nodes),
                           config.global_batch, config.microbatch)
        self.metrics.planning_seconds = _time.perf_counter() - t0

        self.instances: List[PipelineInstance] = []
        cursor = 0
        node_list = list(nodes)
        for size in plan.pipeline_sizes():
            self.instances.append(self.reconf._instantiate(
                size, node_list[cursor:cursor + size]))
            cursor += size
        self.batch: BatchPlan = plan.batch
        # alive-but-idle nodes no template combination currently covers
        # (capped-gap merges, joins beyond N); folded back into the pool
        # at the next reconfiguration
        self.spare_nodes: List[str] = []
        self.last_reconfig: Optional[ReconfigResult] = None
        self.last_adaptation: Optional[AdaptPlan] = None

    # ------------------------------------------------------------------
    def attach_executor(self, executor):
        """Bind a runtime (Executor) to this engine.  Once attached,
        monitor-driven failure/join events go through the executor so
        array state and compiled programs stay consistent with the
        plan; detach by attaching None."""
        self.executor = executor
        return executor

    @property
    def nodes(self) -> List[str]:
        return [n for inst in self.instances for n in inst.nodes]

    def plan_fingerprint(self, result: Optional[ReconfigResult] = None) -> str:
        """Digest of a plan (instances + batch + copy plan) — what the
        two-phase reconfiguration protocol compares across the
        coordinator's engine and every worker's deterministic replica to
        prove they computed the SAME transition before any state moves.
        With ``result=None`` it fingerprints the CURRENT configuration."""
        import hashlib
        import json
        instances = self.instances if result is None else result.instances
        batch = self.batch if result is None else result.batch
        copy_plan = [] if result is None else result.copy_plan
        doc = {
            "instances": [
                [inst.instance_id, list(inst.nodes),
                 [[st.layer_start, st.layer_end]
                  for st in inst.template.stages]]
                for inst in instances],
            "num_microbatches": list(batch.num_microbatches),
            "microbatch_size": batch.microbatch_size,
            "copies": [[t.layer, t.src_node, t.dst_node, t.nbytes]
                       for t in copy_plan],
        }
        return hashlib.sha256(
            json.dumps(doc, sort_keys=True).encode()).hexdigest()[:16]

    def sync_plan(self) -> List[SyncBucket]:
        layer_bytes = [l.param_bytes for l in self.profile.layers]
        return build_sync_plan(self.instances, layer_bytes,
                               self.config.bucket_cap_bytes)

    def iteration_time(self) -> float:
        """Estimated wall time of one global step for the current config
        (max over pipelines + layer-sync overhead not hidden by overlap)."""
        times = [estimate_iteration_time(inst.template, nb)
                 for inst, nb in zip(self.instances, self.batch.num_microbatches)]
        return max(times) + self._sync_tail_seconds()

    def throughput(self) -> float:
        return self.config.global_batch / self.iteration_time()

    def sync_cost_model(self) -> cm_sync.SyncCostModel:
        """THE pricing of cross-replica gradient sync — shared with the
        simulator policy and the benchmarks (DESIGN.md §10), pricing
        ICI vs DCN legs from the topology and wire bytes from the
        codec, per bucket."""
        return cm_sync.SyncCostModel(hw=self.profile.hw,
                                     codec=self.config.codec,
                                     topology=self.topology)

    def _sync_tail_seconds(self) -> float:
        """Cross-pipeline grad sync NOT hidden behind backward, per the
        shared per-bucket overlap model: buckets issue deepest-first
        and overlap the remaining backward; whatever the last bucket
        spills past the end of backward is exposed."""
        if len(self.instances) <= 1:
            return 0.0
        return self.sync_cost_model().tail_seconds(
            self.sync_plan(), self.profile.layer_bwd_seconds())

    def sync_schedule(self) -> List[cm_sync.BucketCostRow]:
        """Per-bucket overlapped sync schedule for the current instance
        set (benchmark/report surface of the shared model)."""
        return self.sync_cost_model().schedule(
            self.sync_plan(), self.profile.layer_bwd_seconds())

    @property
    def topology(self):
        """Pod placement for the recovery data plane (lazy: core must
        not import runtime at module load)."""
        if self._topology is None:
            from repro_torch.runtime.transfer import Topology
            self._topology = Topology.regular(
                self._placement_order,
                nodes_per_pod=self.config.nodes_per_pod,
                hw=self.profile.hw)
        return self._topology

    def transfer_plan(self, result: ReconfigResult,
                      dead: Set[str] = frozenset()):
        """Schedule ``result``'s copy plan into parallel topology-aware
        streams (runtime/transfer.py, DESIGN.md §9)."""
        from repro_torch.runtime.transfer import schedule_transfers
        return schedule_transfers(result.copy_plan, self.topology, dead=dead)

    def recovery_breakdown(self, result: ReconfigResult,
                           dead: Set[str] = frozenset()) -> Dict[str, float]:
        """Failure -> first-step latency decomposition (seconds):
        replan   — measured reconfigurator wall-clock (a table lookup);
        transfer — state-copy makespan over parallel streams under link
                   contention (MAX over streams, not sum of bytes);
        compile  — zero by the §8 warm-cache contract (programs for every
                   template are precompiled; swap is a lookup);
        barrier  — regroup/collective re-formation allowance."""
        return {"replan": result.replan_seconds,
                "transfer": self.transfer_plan(result, dead=dead).makespan(),
                "compile": 0.0,
                "barrier": 1.0}

    def reconfiguration_seconds(self, result: ReconfigResult) -> float:
        """Wall-clock estimate of a reconfiguration: state copy dominates
        (paper Fig. 11 'copying overhead') and is charged as the
        max-over-streams transfer makespan of the scheduled data plane."""
        return sum(self.recovery_breakdown(result).values())

    # ------------------------------------------------------------------
    # adaptive recovery: schedule adaptation, spare promotion and the
    # per-event policy selector (ReCycle / Chameleon; DESIGN.md §12)
    # ------------------------------------------------------------------
    def adapt_cost_model(self) -> AdaptCostModel:
        """THE pricing of schedule adaptation — shared with the
        simulator policy and benchmarks/recovery_policy, mirror of
        ``sync_cost_model()``."""
        return AdaptCostModel(hw=self.profile.hw)

    def _compute_iteration_seconds(self) -> float:
        """Compute-only iteration time (no sync tail) — the baseline the
        adapt cost model's reroute exposure is measured against."""
        return max((estimate_iteration_time(inst.template, nb)
                    for inst, nb in zip(self.instances,
                                        self.batch.num_microbatches)),
                   default=0.0)

    def _iteration_time_of(self, instances: Sequence[PipelineInstance],
                           batch: BatchPlan) -> float:
        """``iteration_time()`` for a HYPOTHETICAL (instances, batch) —
        used to price candidate recovery outcomes without mutating."""
        times = [estimate_iteration_time(inst.template, nb)
                 for inst, nb in zip(instances, batch.num_microbatches)]
        tail = 0.0
        if len(instances) > 1:
            layer_bytes = [l.param_bytes for l in self.profile.layers]
            plan = build_sync_plan(list(instances), layer_bytes,
                                   self.config.bucket_cap_bytes)
            tail = self.sync_cost_model().tail_seconds(
                plan, self.profile.layer_bwd_seconds())
        return max(times, default=0.0) + tail

    def adaptation_reference_iteration(self, dead: Set[str]) -> float:
        """Compute-only iteration estimate of the REPLAN outcome for
        ``dead`` — the reference an adaptation's reroute exposure is
        measured against (``reconf.on_failure`` is non-mutating, so this
        is a dry run).  Falls back to the pre-failure iteration when
        replan is infeasible."""
        dead_active = {d for d in dead if d in set(self.nodes)}
        spares = [n for n in self.spare_nodes if n not in dead]
        try:
            res = self.reconf.on_failure(self.instances, dead_active,
                                         spares=spares)
            return max((estimate_iteration_time(inst.template, nb)
                        for inst, nb in zip(res.instances,
                                            res.batch.num_microbatches)),
                       default=0.0)
        except InsufficientReplicasError:
            return self._compute_iteration_seconds()

    def plan_adaptation(self, dead: Set[str]) -> AdaptPlan:
        """Count-level ReCycle adaptation for ``dead`` (non-mutating):
        damaged replicas' microbatches re-route to surviving replicas,
        damaged replicas' healthy nodes park as hot spares.  Raises
        ``AdaptationError`` when infeasible (every replica damaged, or
        the batch cannot redistribute over the survivors)."""
        t0 = _time.perf_counter()
        plan = cm_adapt.plan_adaptation(
            self.instances, self.batch.num_microbatches, sorted(dead),
            self.config.global_batch, self.config.microbatch)
        return dataclasses.replace(
            plan, replan_seconds=_time.perf_counter() - t0)

    def apply_adaptation(self, plan: AdaptPlan, dead: Set[str] = frozenset(),
                         drained: bool = False) -> AdaptPlan:
        """Commit an AdaptPlan: swap in the surviving instances and the
        rebalanced batch; no state moves, no template changes."""
        self.instances = list(plan.instances)
        self.batch = plan.batch
        self.metrics.reconfigurations += 1
        self.epoch += 1
        self.metrics.adaptations += 1
        if not drained:
            self.metrics.lost_iterations += 1
        self.spare_nodes = ([n for n in self.spare_nodes if n not in dead]
                            + [n for n in plan.parked_nodes
                               if n not in self.spare_nodes])
        self.draining -= set(dead)
        self.last_adaptation = plan
        return plan

    def plan_spare_promotion(self, dead: Set[str]) -> ReconfigResult:
        """Hot-spare promotion (non-mutating): every dead slot is filled
        by a parked spare under the SAME templates — no batch change, no
        re-instantiation; only the dead slots' layer states are copied
        from surviving replicas.  Raises ``AdaptationError`` when there
        are not enough spares or a dead layer has no surviving owner."""
        t0 = _time.perf_counter()
        dead_active = sorted(d for d in dead if d in set(self.nodes))
        spares = [n for n in self.spare_nodes if n not in dead]
        if len(spares) < len(dead_active):
            raise AdaptationError(
                f"spare promotion infeasible: {len(dead_active)} dead "
                f"slots, {len(spares)} spares")
        replacement = dict(zip(dead_active, spares))
        used = list(replacement.values())
        owners = cm_sync.layer_owner_map(self.instances)
        copy_plan: List[CopyTask] = []
        load: Dict[str, int] = {}
        new_instances: List[PipelineInstance] = []
        for inst in self.instances:
            if not (set(inst.nodes) & set(replacement)):
                new_instances.append(inst)
                continue
            new_nodes = [replacement.get(n, n) for n in inst.nodes]
            for layer in range(inst.template.num_layers):
                for node in inst.layer_owners(layer):
                    if node not in replacement:
                        continue
                    srcs = sorted(owners[layer] - set(dead_active))
                    if not srcs:
                        raise AdaptationError(
                            f"spare promotion infeasible: layer {layer} "
                            "has no surviving owner")
                    src = min(srcs, key=lambda s: (load.get(s, 0), s))
                    nbytes = _layer_state_bytes(self.profile, layer)
                    load[src] = load.get(src, 0) + nbytes
                    copy_plan.append(CopyTask(layer, src, replacement[node],
                                              nbytes, sources=tuple(srcs)))
            new_instances.append(PipelineInstance(
                instance_id=inst.instance_id, template=inst.template,
                nodes=new_nodes))
        return ReconfigResult(
            instances=new_instances, copy_plan=copy_plan, batch=self.batch,
            spare_nodes=[n for n in spares if n not in used],
            replan_seconds=_time.perf_counter() - t0)

    def apply_spare_promotion(self, result: ReconfigResult,
                              dead: Set[str] = frozenset(),
                              drained: bool = False) -> ReconfigResult:
        """Commit a spare-promotion plan (same bookkeeping as
        ``handle_failure``, but templates and batch are untouched)."""
        self.instances = result.instances
        self.batch = result.batch
        self.metrics.reconfigurations += 1
        self.epoch += 1
        self.metrics.spare_promotions += 1
        self.metrics.total_copy_bytes += result.copy_bytes()
        if not drained:
            self.metrics.lost_iterations += 1
        self.last_reconfig = result
        self.spare_nodes = list(result.spare_nodes)
        self.draining -= set(dead)
        return result

    def predict_recovery(self, dead: Set[str]) -> Dict[str, Dict]:
        """Price every recovery policy for a failure event WITHOUT
        mutating engine state (``reconf.on_failure`` and the planners
        above are all non-mutating).  Per policy: ``feasible``,
        predicted ``downtime`` (sum of its breakdown), the ``breakdown``
        itself, and the steady-state ``iteration_s`` afterwards."""
        dead_active = {d for d in dead if d in set(self.nodes)}
        preds: Dict[str, Dict] = {}
        # -- replan: the full reconfiguration path -----------------------
        spares = [n for n in self.spare_nodes if n not in dead]
        try:
            res = self.reconf.on_failure(self.instances, set(dead_active),
                                         spares=spares)
            bd = self.recovery_breakdown(res, dead=dead_active)
            preds["replan"] = {
                "feasible": True, "downtime": sum(bd.values()),
                "breakdown": bd,
                "iteration_s": self._iteration_time_of(res.instances,
                                                       res.batch)}
        except InsufficientReplicasError as e:
            preds["replan"] = {"feasible": False, "reason": str(e)}
        # -- adapt: ReCycle re-routing ----------------------------------
        try:
            plan = self.plan_adaptation(dead_active)
            bd = self.adapt_cost_model().breakdown(
                plan, self.adaptation_reference_iteration(dead_active))
            it = self._iteration_time_of(plan.instances, plan.batch)
            replan_it = preds["replan"].get("iteration_s")
            slowdown_ok = (replan_it is None
                           or it <= self.config.adapt_max_slowdown * replan_it)
            preds["adapt"] = {
                "feasible": True, "downtime": sum(bd.values()),
                "breakdown": bd, "iteration_s": it,
                "slowdown_ok": slowdown_ok, "plan": plan}
        except AdaptationError as e:
            preds["adapt"] = {"feasible": False, "reason": str(e)}
        # -- spare: hot-spare promotion ---------------------------------
        try:
            res = self.plan_spare_promotion(dead_active)
            bd = self.recovery_breakdown(res, dead=dead_active)
            preds["spare"] = {
                "feasible": True, "downtime": sum(bd.values()),
                "breakdown": bd,
                "iteration_s": self._iteration_time_of(res.instances,
                                                       res.batch),
                "plan": res}
        except AdaptationError as e:
            preds["spare"] = {"feasible": False, "reason": str(e)}
        return preds

    def select_recovery_policy(self, dead: Set[str]) -> Dict:
        """Chameleon-style per-event choice: the feasible policy with
        the least predicted downtime; ties break toward the better
        steady-state iteration time.  Adaptations violating the
        ``adapt_max_slowdown`` cap are excluded (a consolidating replan
        also folds parked spares back in)."""
        preds = self.predict_recovery(dead)
        candidates = [p for p, d in preds.items()
                      if d.get("feasible") and d.get("slowdown_ok", True)]
        if not candidates:
            chosen = "replan"      # let handle_failure raise/escalate
        else:
            chosen = min(candidates,
                         key=lambda p: (preds[p]["downtime"],
                                        preds[p]["iteration_s"], p))
        return {"policy": chosen, "predictions": preds}

    # ------------------------------------------------------------------
    def _on_event(self, ev: ClusterEvent) -> None:
        if ev.kind == NodeChangeMonitor.WARN:
            self.draining |= set(ev.nodes)
            return
        # local import: core must not import runtime at module load
        # (runtime.pipeline imports this module)
        from repro_torch.runtime.executor import ExecutorUnsupported
        if ev.kind == NodeChangeMonitor.FAIL:
            # the monitor path cannot say whether the drain finished, so
            # assume it did iff every victim had a pending warning; the
            # simulator/runtime call handle_failure directly with the
            # ground truth instead
            drained = set(ev.nodes) <= self.draining
            if self.executor is not None:
                try:
                    self.executor.recover(set(ev.nodes), drained=drained)
                    return
                except ExecutorUnsupported:
                    # e.g. the SPMD fast path: keep the PLAN consistent
                    # here; the caller rebinds a HeteroTrainer from
                    # snapshot() against the updated plan
                    pass
            self.handle_failure(set(ev.nodes), drained=drained)
        elif ev.kind == NodeChangeMonitor.JOIN:
            if self.executor is not None:
                try:
                    self.executor.join(list(ev.nodes))
                    return
                except ExecutorUnsupported:
                    pass
            self.handle_join(list(ev.nodes))

    def handle_failure(self, dead: Set[str],
                       drained: bool = False) -> ReconfigResult:
        """Remove ``dead`` nodes and reconfigure.  ``drained=True`` marks
        a proactive removal after a preemption warning: the in-flight
        iteration completed before the nodes left, so no work is lost."""
        self.spare_nodes = [n for n in self.spare_nodes if n not in dead]
        dead = {d for d in dead if d in set(self.nodes)}
        if not dead:
            return ReconfigResult(self.instances, [], self.batch)
        try:
            result = self.reconf.on_failure(self.instances, dead,
                                            spares=self.spare_nodes)
        except InsufficientReplicasError:
            self.stopped = True
            self.metrics.restarts += 1
            if self.on_checkpoint:
                self.on_checkpoint()
            raise
        self.instances = result.instances
        self.batch = result.batch
        self.metrics.reconfigurations += 1
        self.epoch += 1
        self.metrics.total_copy_bytes += result.copy_bytes()
        if not drained:
            self.metrics.lost_iterations += 1  # in-flight iteration lost
        self.last_reconfig = result
        self.spare_nodes = list(result.spare_nodes)
        self.draining -= dead              # their warning is resolved
        return result

    def rebalance(self, observed_times: Sequence[float]) -> BatchPlan:
        """Straggler mitigation: re-run batch distribution (Eq. 6) with
        MEASURED per-pipeline per-microbatch times instead of the cost
        model's estimates.  Call with the last iteration's timings when a
        pipeline runs hot (thermal throttling, shared-fabric noise)."""
        from repro_torch.core.batch import distribute_microbatches
        total_mb = self.config.global_batch // self.config.microbatch
        counts = distribute_microbatches(list(observed_times), total_mb)
        self.batch = BatchPlan(num_microbatches=tuple(counts),
                               microbatch_size=self.config.microbatch,
                               global_batch=self.config.global_batch)
        return self.batch

    def handle_join(self, new_nodes: List[str]) -> ReconfigResult:
        pool = list(new_nodes) + [n for n in self.spare_nodes
                                  if n not in set(new_nodes)]
        # give joiners real pod slots: extend the placement order and
        # rebuild the auto topology (a user-provided one is their call)
        seen = set(self._placement_order)
        fresh = [n for n in pool if n not in seen]
        if fresh and self._topology_auto:
            self._placement_order.extend(fresh)
            self._topology = None
        result = self.reconf.on_join(self.instances, pool)
        self.instances = result.instances
        self.batch = result.batch
        self.metrics.reconfigurations += 1
        self.epoch += 1
        self.metrics.total_copy_bytes += result.copy_bytes()
        self.last_reconfig = result
        self.spare_nodes = list(result.spare_nodes)
        self.draining -= set(new_nodes)    # a returning node isn't leaving
        return result


# Historical single-process name: the class that was both halves of the
# engine before the ExecutionEngine split (runtime/multihost.py).
OobleckEngine = ConfigurationEngine
