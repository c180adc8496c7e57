"""Dynamic reconfiguration without restart (paper §5).

On failure, pipelines that lost nodes are replaced by pipelines
instantiated from the precomputed templates, in three escalating steps
(Figure 8):

  1. *simple reinstantiation* — a template for the surviving node count
     exists (sizes are consecutive, so any count in [n0, n_max] works);
  2. *borrow nodes* — steal nodes from pipelines larger than n0 until the
     damaged pipeline reaches n0 (donors reinstantiate too);
  3. *merge pipelines* — absorb another pipeline; Thm B.1 guarantees a
     template exists for the merged size.

After reinstantiation, nodes that now own layers they did not hold before
copy the missing model states (params + optimizer) from surviving
replicas — the copy plan is computed here at layer granularity, the unit
Oobleck syncs and stores state in.  Batch is then redistributed (Eq. 6).

If fewer than (f+1)*n0 nodes survive, recovery is impossible without
violating the fault-tolerance contract: ``InsufficientReplicasError`` is
raised and the engine checkpoints and exits (paper §3.4 lifecycle).
"""
from __future__ import annotations

import dataclasses
import itertools
import time as _time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.batch import BatchPlan, distribute_batch
from repro_torch.core.templates import NodeSpec, PipelineTemplate, PlanningError


class InsufficientReplicasError(RuntimeError):
    """Fewer than (f+1)*n0 nodes remain; training must stop and checkpoint."""


@dataclasses.dataclass
class PipelineInstance:
    """A live pipeline: a template bound to concrete node ids."""

    instance_id: int
    template: PipelineTemplate
    nodes: List[str]           # one entry per template node slot, in order

    def __post_init__(self):
        assert len(self.nodes) == self.template.num_nodes

    def layer_owners(self, layer: int) -> List[str]:
        """Nodes holding model states of ``layer`` (the stage's node)."""
        st = self.template.stage_of_layer(layer)
        span = max(1, st.num_gpus // self.template.gpus_per_node)
        return self.nodes[st.node_offset:st.node_offset + span]

    def all_layer_owners(self) -> Dict[int, List[str]]:
        return {l: self.layer_owners(l)
                for l in range(self.template.num_layers)}


@dataclasses.dataclass(frozen=True)
class CopyTask:
    layer: int
    src_node: str                  # default pick (least-loaded survivor)
    dst_node: str
    nbytes: int
    # every surviving replica holding this layer: the data plane
    # (runtime/transfer.py) re-chooses among these topology-aware —
    # pod-local/ICI sources beat cross-pod/DCN ones
    sources: Tuple[str, ...] = ()


@dataclasses.dataclass
class ReconfigResult:
    instances: List[PipelineInstance]
    copy_plan: List[CopyTask]
    batch: BatchPlan
    # bookkeeping for the simulator / engine metrics
    merged: int = 0
    borrowed: int = 0
    reinstantiated: int = 0
    globally_replanned: bool = False
    # nodes left idle because no template combination covers them: joins
    # pushing the cluster beyond the original N (the §4.1.1 guarantee
    # covers any count <= N), or a burst-merged pool landing in a gap of
    # a capped template set; spares rejoin on the next reconfiguration
    spare_nodes: List[str] = dataclasses.field(default_factory=list)
    # wall-clock the reconfigurator spent computing this result (the
    # "replan" leg of the recovery-latency decomposition; a table
    # lookup, so microseconds — measured, not assumed)
    replan_seconds: float = 0.0

    def copy_bytes(self) -> int:
        return sum(t.nbytes for t in self.copy_plan)


def _layer_state_bytes(profile, layer: int) -> int:
    """Bytes of model state to copy for one layer: bf16 params + fp32
    master + two fp32 Adam moments (what 'model states' means in §5.1)."""
    p = profile.layers[layer].param_bytes // 2  # param count
    return p * 2 + p * 4 * 3


class Reconfigurator:
    """Executes §5.1/§5.2 against a set of live pipeline instances."""

    def __init__(self, templates: Dict[int, PipelineTemplate], spec: NodeSpec,
                 profile, global_batch: int, microbatch: int):
        self.templates = templates
        self.spec = spec
        self.profile = profile
        self.global_batch = global_batch
        self.microbatch = microbatch
        self._next_id = itertools.count(1_000)

    # ------------------------------------------------------------------
    def on_failure(self, instances: Sequence[PipelineInstance],
                   dead_nodes: Set[str],
                   spares: Sequence[str] = ()) -> ReconfigResult:
        """React to ``dead_nodes`` leaving.  ``spares`` are alive idle
        nodes from an earlier reconfiguration; they enter the recovery
        pool like the survivors of a damaged pipeline, so they rejoin
        service whenever a covering combination exists."""
        t0 = _time.perf_counter()
        spec = self.spec
        spares = [n for n in spares if n not in dead_nodes]
        survivors: List[List[str]] = [
            [n for n in inst.nodes if n not in dead_nodes] for inst in instances]
        total = sum(len(s) for s in survivors) + len(spares)
        if total < (spec.f + 1) * spec.n0:
            raise InsufficientReplicasError(
                f"{total} nodes < (f+1)*n0 = {(spec.f + 1) * spec.n0}; "
                "checkpoint and exit")

        old_owners = self._ownership(instances)
        result = ReconfigResult(instances=[], copy_plan=[], batch=None)  # type: ignore

        healthy: List[Tuple[PipelineInstance, List[str]]] = []
        damaged: List[List[str]] = []
        for inst, nodes in zip(instances, survivors):
            if len(nodes) == inst.template.num_nodes:
                healthy.append((inst, nodes))
            elif nodes:
                damaged.append(nodes)
        if spares:
            damaged.append(list(spares))
        # Damaged pipelines with zero survivors simply disappear.

        new_instances: List[PipelineInstance] = [inst for inst, _ in healthy]

        # --- step 1: simple reinstantiation -------------------------------
        still_small: List[List[str]] = []
        for nodes in damaged:
            if len(nodes) >= spec.n0:
                new_instances.append(self._instantiate(len(nodes), nodes))
                result.reinstantiated += 1
            else:
                still_small.append(nodes)

        # --- step 2: borrow nodes -----------------------------------------
        for nodes in list(still_small):
            need = spec.n0 - len(nodes)
            borrowed: List[str] = []
            # donors: largest pipelines first, may only shrink down to n0
            donors = sorted(new_instances,
                            key=lambda i: i.template.num_nodes, reverse=True)
            for donor in donors:
                while need and donor.template.num_nodes - 1 >= spec.n0:
                    node = donor.nodes[-1]
                    shrunk = self._instantiate(
                        donor.template.num_nodes - 1, donor.nodes[:-1])
                    new_instances[new_instances.index(donor)] = shrunk
                    donor = shrunk
                    borrowed.append(node)
                    need -= 1
                if not need:
                    break
            if not need:
                new_instances.append(
                    self._instantiate(spec.n0, nodes + borrowed))
                result.borrowed += len(borrowed)
                still_small.remove(nodes)
            else:
                # return any partial borrow is unnecessary: donors already
                # reinstantiated smaller; just keep the pool for merging.
                nodes.extend(borrowed)

        # --- step 3: merge pipelines ---------------------------------------
        while still_small:
            nodes = still_small.pop()
            pool = list(nodes)
            while len(pool) < spec.n0:
                if still_small:
                    pool.extend(still_small.pop())
                    continue
                if not new_instances:
                    raise InsufficientReplicasError(
                        "no pipeline left to merge with")
                # absorb the smallest healthy pipeline (Thm B.1: a template
                # for the merged size exists)
                victim = min(new_instances, key=lambda i: i.template.num_nodes)
                new_instances.remove(victim)
                pool.extend(victim.nodes)
                result.merged += 1
            size = len(pool)
            if size in self.templates:
                new_instances.append(self._instantiate(size, pool))
            else:
                # Thm B.1 guarantees a template for a merge of TWO pipelines
                # below n_max, but a correlated burst (whole-rack failure,
                # preemption wave) can leave a pool larger than the largest
                # template after several absorptions.  Split the pool back
                # into covered sizes instead of giving up — fewest pipelines
                # first, so the merged capacity stays in deep/fast pipelines.
                # A capped template set (sizes n0..n_max with n_max < 2n0-1)
                # has gaps no decomposition covers; then the largest
                # coverable prefix runs and the remainder waits as hot
                # spares for the next join/reconfiguration.
                parts, use = self._decompose_prefix(size)
                if not parts:
                    raise InsufficientReplicasError(
                        f"merged pool of {size} nodes is below every "
                        f"template size {sorted(self.templates)}")
                cursor = 0
                for part in parts:
                    new_instances.append(
                        self._instantiate(part, pool[cursor:cursor + part]))
                    cursor += part
                result.spare_nodes.extend(pool[use:])

        # --- fault-tolerance floor: keep >= f+1 pipelines -------------------
        if len(new_instances) < spec.f + 1:
            new_instances = self._global_replan(
                [n for inst in new_instances for n in inst.nodes])
            result.globally_replanned = True

        result.instances = new_instances
        result.copy_plan = self._copy_plan(old_owners, new_instances, dead_nodes)
        result.batch = distribute_batch(
            [i.template for i in new_instances], self.global_batch,
            self.microbatch)
        result.replan_seconds = _time.perf_counter() - t0
        return result

    # ------------------------------------------------------------------
    def on_join(self, instances: Sequence[PipelineInstance],
                new_nodes: Sequence[str]) -> ReconfigResult:
        """Node additions (spot instances coming back): re-plan globally to
        use every node — instantiation is a table lookup (§4.2).  Counts
        beyond the original N may not be exactly coverable; the largest
        coverable subset is used and the rest stay as hot spares."""
        t0 = _time.perf_counter()
        all_nodes = [n for inst in instances for n in inst.nodes]
        all_nodes.extend(new_nodes)
        old_owners = self._ownership(instances)
        new_instances, spares = None, []
        for use in range(len(all_nodes), (self.spec.f + 1) * self.spec.n0 - 1,
                         -1):
            try:
                new_instances = self._global_replan(all_nodes[:use])
                spares = all_nodes[use:]
                break
            except PlanningError:
                continue
        if new_instances is None:
            raise PlanningError("join re-plan found no coverable subset")
        batch = distribute_batch([i.template for i in new_instances],
                                 self.global_batch, self.microbatch)
        return ReconfigResult(
            instances=new_instances,
            copy_plan=self._copy_plan(old_owners, new_instances, set()),
            batch=batch, globally_replanned=True, spare_nodes=spares,
            replan_seconds=_time.perf_counter() - t0)

    # ------------------------------------------------------------------
    def _decompose_prefix(self, total: int) -> Tuple[List[int], int]:
        """Largest ``use <= total`` expressible as a sum of template
        sizes, with its fewest-pipelines decomposition (largest-first
        among optimal ones).  One coin-change DP covers every candidate
        amount.  Returns ``([], 0)`` when even the smallest template
        exceeds ``total``."""
        sizes = sorted(self.templates, reverse=True)
        INF = total + 1
        minc = [0] + [INF] * total
        for amount in range(1, total + 1):
            for s in sizes:
                if s <= amount and minc[amount - s] + 1 < minc[amount]:
                    minc[amount] = minc[amount - s] + 1
        use = total
        while use > 0 and minc[use] >= INF:
            use -= 1
        out: List[int] = []
        rem = use
        while rem:
            for s in sizes:
                if s <= rem and minc[rem - s] == minc[rem] - 1:
                    out.append(s)
                    rem -= s
                    break
        return out, use

    def _decompose(self, total: int) -> List[int]:
        """Exact split of ``total`` into template sizes, fewest pipelines."""
        parts, use = self._decompose_prefix(total)
        if use != total:
            raise PlanningError(
                f"no template combination covers a merged pipeline pool of "
                f"{total} nodes (have {sorted(self.templates)})")
        return parts

    def _instantiate(self, size: int, nodes: List[str]) -> PipelineInstance:
        if size not in self.templates:
            raise PlanningError(f"no template with {size} nodes")
        return PipelineInstance(next(self._next_id), self.templates[size],
                                list(nodes))

    def _global_replan(self, nodes: List[str]) -> List[PipelineInstance]:
        from repro_torch.core.instantiator import choose_plan
        plan = choose_plan(self.templates, self.spec, len(nodes),
                           self.global_batch, self.microbatch)
        out: List[PipelineInstance] = []
        cursor = 0
        for size in plan.pipeline_sizes():
            out.append(self._instantiate(size, nodes[cursor:cursor + size]))
            cursor += size
        return out

    @staticmethod
    def _ownership(instances: Sequence[PipelineInstance]) -> Dict[int, Set[str]]:
        owners: Dict[int, Set[str]] = {}
        for inst in instances:
            for layer, nodes in inst.all_layer_owners().items():
                owners.setdefault(layer, set()).update(nodes)
        return owners

    def _copy_plan(self, old_owners: Dict[int, Set[str]],
                   instances: Sequence[PipelineInstance],
                   dead: Set[str]) -> List[CopyTask]:
        plan: List[CopyTask] = []
        load: Dict[str, int] = {}
        for inst in instances:
            for layer, owners in inst.all_layer_owners().items():
                # sorted: old_owners holds SETS, whose iteration order is
                # per-process (hash randomization).  The source pick below
                # breaks load ties by position, and the pick is part of the
                # plan fingerprint every process must agree on.
                alive_srcs = sorted(
                    n for n in old_owners.get(layer, ()) if n not in dead)
                for node in owners:
                    if node in old_owners.get(layer, ()):
                        continue  # already holds this layer
                    if not alive_srcs:
                        raise InsufficientReplicasError(
                            f"layer {layer} has no surviving replica — more "
                            f"than f simultaneous failures hit one stage")
                    src = min(alive_srcs, key=lambda n: load.get(n, 0))
                    nbytes = _layer_state_bytes(self.profile, layer)
                    load[src] = load.get(src, 0) + nbytes
                    plan.append(CopyTask(layer, src, node, nbytes,
                                         sources=tuple(sorted(alive_srcs))))
        return plan
