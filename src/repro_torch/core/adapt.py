"""Schedule-adaptation recovery planning (ReCycle, arXiv:2405.14009).

When a failure damages some pipeline replicas but leaves others whole,
the cheapest *correct* response is often not a replan: every pipeline
replica holds the full model, so the damaged replicas' microbatches can
be re-routed to surviving peers as decoupled-1F1B "guests" that fill
the hosts' pipeline bubbles — zero state transfer, zero recompilation
(the hosts' programs for the new microbatch counts are already warm).

``AdaptCostModel`` prices that choice in the same per-row accounting
style as ``SyncCostModel`` (core/sync.py): one frozen row per surviving
pipeline, a ``rows()``/aggregate-seconds split, and a breakdown dict
with the same keys as ``OobleckEngine.recovery_breakdown`` plus the
adaptation-specific ``reroute`` exposure term.

Core must not import runtime at module load (circular-import rule), so
the op-level adapted schedules live in ``runtime/schedule.py``; this
module only does count-level planning and pricing on top of
``distribute_batch`` and ``estimate_iteration_time``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.batch import BatchPlan, distribute_batch
from repro_torch.core.planner import estimate_iteration_time
from repro_torch.core.reconfigure import PipelineInstance
from repro_torch.core.templates import PlanningError
from repro_torch.utils import hw as hwlib


class AdaptationError(RuntimeError):
    """Schedule adaptation is infeasible for this failure event (no
    surviving whole pipeline, or batch redistribution impossible)."""


@dataclasses.dataclass(frozen=True)
class AdaptCostRow:
    """One surviving pipeline's slot in the adapted schedule (seconds)."""

    pipeline: int           # index into the surviving-instance list
    native_mb: int          # microbatches it ran before the failure
    guest_mb: int           # re-routed microbatches it hosts now
    base_s: float           # 1F1B makespan at native_mb
    adapted_s: float        # 1F1B makespan at native_mb + guest_mb
    serial_guest_s: float   # guests run serially after drain (no filling)
    bubble_fill_s: float    # serial_guest_s - (adapted_s - base_s), >= 0

    @property
    def total_mb(self) -> int:
        return self.native_mb + self.guest_mb


@dataclasses.dataclass(frozen=True)
class AdaptPlan:
    """Count-level adaptation: which instances survive, which nodes are
    parked as hot spares, and the rebalanced batch.

    The rebalanced counts come from the SAME ``distribute_batch`` (Eq. 6)
    a full replan would apply to the surviving instance set — so when a
    failure kills whole pipelines, adaptation and replan produce
    structurally identical (instances, batch) and the training math is
    bitwise identical; adaptation just skips the transfer/compile legs.
    """

    instances: Tuple[PipelineInstance, ...]   # surviving, original order
    batch: BatchPlan
    mb_before: Tuple[int, ...]     # per surviving instance, pre-failure
    mb_after: Tuple[int, ...]      # per surviving instance, rebalanced
    dropped: Tuple[int, ...]       # instance_ids of damaged replicas
    parked_nodes: Tuple[str, ...]  # healthy nodes of damaged replicas
    replan_seconds: float          # measured planning wall-clock

    @property
    def guest_counts(self) -> Tuple[int, ...]:
        return tuple(max(0, a - b)
                     for a, b in zip(self.mb_after, self.mb_before))

    @property
    def total_guests(self) -> int:
        return sum(self.guest_counts)


def plan_adaptation(instances: Sequence[PipelineInstance],
                    mb_before: Sequence[int],
                    dead: Sequence[str],
                    global_batch: int, microbatch_size: int,
                    replan_seconds: float = 0.0) -> AdaptPlan:
    """Build an AdaptPlan for a failure event, or raise AdaptationError.

    ``mb_before[i]`` is instance i's pre-failure microbatch count (used
    only for guest accounting/pricing — the rebalanced counts are
    authoritative).  An instance touching ANY dead node is damaged; its
    healthy nodes are parked as hot spares for a later consolidating
    replan.
    """
    dead_set = set(dead)
    keep: List[PipelineInstance] = []
    keep_mb: List[int] = []
    dropped: List[int] = []
    parked: List[str] = []
    for inst, mb in zip(instances, mb_before):
        if dead_set & set(inst.nodes):
            dropped.append(inst.instance_id)
            parked.extend(n for n in inst.nodes if n not in dead_set)
        else:
            keep.append(inst)
            keep_mb.append(mb)
    if not dropped:
        raise AdaptationError(f"no instance touches dead nodes {sorted(dead_set)}")
    if not keep:
        raise AdaptationError(
            "adaptation infeasible: every pipeline replica is damaged "
            f"(dead={sorted(dead_set)}) — replan is the only option")
    try:
        batch = distribute_batch([i.template for i in keep],
                                 global_batch, microbatch_size)
    except PlanningError as e:
        raise AdaptationError(f"adaptation infeasible: {e}") from e
    return AdaptPlan(
        instances=tuple(keep), batch=batch,
        mb_before=tuple(keep_mb),
        mb_after=tuple(batch.num_microbatches),
        dropped=tuple(dropped), parked_nodes=tuple(parked),
        replan_seconds=float(replan_seconds))


class AdaptCostModel:
    """ONE pricing of schedule adaptation, consumed by the engine's
    policy selector, the simulator policy and benchmarks/recovery_policy
    — mirror of SyncCostModel's per-row accounting (core/sync.py).

    Per surviving pipeline: the 1F1B makespan at its rebalanced
    microbatch count (affine estimate, core/planner.py).  Guests beyond
    the pipeline-fill point cost exactly one slowest-stage slot each;
    guests absorbed before the fill point ride the warmup/drain bubbles
    for free — ``bubble_fill_s`` reports that saving against the naive
    run-guests-serially baseline.
    """

    #: regroup allowance for an adaptation.  A replan's 1.0 s barrier
    #: (engine.recovery_breakdown) covers collective re-formation across
    #: CHANGED pipeline memberships; an adaptation keeps every surviving
    #: pipeline's membership identical — the re-route is one
    #: control-plane round, and the cross-replica sync groups merely
    #: drop the dead replica, which the bucketed data plane rebinds as
    #: explicit device subsets with no communicator re-init.
    ADAPT_BARRIER_SECONDS = 0.25

    def __init__(self, hw: hwlib.HardwareSpec = hwlib.H100,
                 barrier_seconds: float = ADAPT_BARRIER_SECONDS):
        self.hw = hw
        self.barrier_seconds = barrier_seconds

    # -- per-pipeline rows ---------------------------------------------
    def rows(self, plan: AdaptPlan) -> List[AdaptCostRow]:
        out: List[AdaptCostRow] = []
        for i, inst in enumerate(plan.instances):
            tpl = inst.template
            native = plan.mb_before[i]
            total = plan.mb_after[i]
            guests = max(0, total - native)
            base = estimate_iteration_time(tpl, native)
            adapted = estimate_iteration_time(tpl, total)
            t_slow = tpl.stage_times[tpl.slowest_stage]
            serial = guests * t_slow
            out.append(AdaptCostRow(
                pipeline=i, native_mb=native, guest_mb=guests,
                base_s=base, adapted_s=adapted, serial_guest_s=serial,
                bubble_fill_s=max(0.0, serial - (adapted - base))))
        return out

    # -- aggregates ------------------------------------------------------
    def adapted_iteration_seconds(self, plan: AdaptPlan) -> float:
        """Post-adaptation iteration compute time: pipelines run
        concurrently, the iteration is gated by the slowest host."""
        rows = self.rows(plan)
        return max((r.adapted_s for r in rows), default=0.0)

    def reroute_exposure_seconds(self, plan: AdaptPlan,
                                 reference_iteration_s: float) -> float:
        """Extra latency of the adapted iteration over what the REPLAN
        outcome would deliver (``reference_iteration_s``, the engine's
        ``adaptation_reference_iteration``) — the compute-side downtime
        adaptation pays for skipping reconfiguration.  Charged once: the
        steady-state difference is already in the iteration time every
        later step reports, so charging against the pre-failure
        iteration would double-count capacity the failure itself
        removed.  Zero when adaptation and replan land on the same
        (instances, batch) — e.g. whole-pipeline kills."""
        return max(0.0, self.adapted_iteration_seconds(plan)
                   - reference_iteration_s)

    def breakdown(self, plan: AdaptPlan,
                  reference_iteration_s: float) -> Dict[str, float]:
        """Same keys as OobleckEngine.recovery_breakdown, plus
        ``reroute``: transfer and compile are structurally zero (no
        state moves; host programs for every microbatch count are
        already warm via warm_templates())."""
        return {
            "replan": plan.replan_seconds,
            "transfer": 0.0,
            "compile": 0.0,
            "barrier": self.barrier_seconds,
            "reroute": self.reroute_exposure_seconds(
                plan, reference_iteration_s),
        }

    def downtime_seconds(self, plan: AdaptPlan,
                         reference_iteration_s: float) -> float:
        return sum(self.breakdown(plan, reference_iteration_s).values())
