"""Batch distribution across heterogeneous pipelines (paper §4.2.2, Eq. 6).

Given pipelines with per-microbatch steady-state times ``t_i`` (the slowest
stage's F+B — the slope of the 1F1B makespan in N_b), global batch ``B``
and microbatch size ``b``, assign integer microbatch counts ``N_b,i``:

    minimize   sum_i (N_b,i * t_i - mean)^2
    s.t.       sum_i N_b,i * b = B,   N_b,i in N, N_b,i >= 1

The paper uses Pyomo/MindtPy; that solver is unavailable offline, so we
solve exactly with (a) a proportional largest-remainder seed at the
continuous optimum ``N_b,i ∝ 1/t_i`` and (b) greedy single-unit exchange
descent.  The objective is separable and convex in each coordinate, and a
single-unit exchange neighbourhood is optimal for such resource-allocation
programs; tests cross-check against brute force on small instances.

If ``B/b`` cannot give every pipeline at least one microbatch, Oobleck
does not silently change B — it raises with a recommended nearby batch
size (paper: "recommends an adjusted global batch size").
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from repro_torch.core.templates import PipelineTemplate, PlanningError


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    num_microbatches: Tuple[int, ...]   # N_b,i per pipeline
    microbatch_size: int
    global_batch: int

    def minibatch_sizes(self) -> Tuple[int, ...]:
        return tuple(n * self.microbatch_size for n in self.num_microbatches)

    def variance_objective(self, times: Sequence[float]) -> float:
        loads = [n * t for n, t in zip(self.num_microbatches, times)]
        mean = sum(loads) / len(loads)
        return sum((l - mean) ** 2 for l in loads)


def _objective(counts: List[int], times: Sequence[float]) -> float:
    loads = [n * t for n, t in zip(counts, times)]
    mean = sum(loads) / len(loads)
    return sum((l - mean) ** 2 for l in loads)


def _seed_counts(times: Sequence[float], total_mb: int) -> List[int]:
    """Proportional largest-remainder seed at the continuous optimum
    ``N_i ∝ 1/t_i``, fixed up to hit the exact total."""
    x = len(times)
    inv = [1.0 / t for t in times]
    scale = total_mb / sum(inv)
    counts = [max(1, int(w * scale)) for w in inv]
    s = sum(counts)
    while s > total_mb:
        donors = [j for j in range(x) if counts[j] > 1]
        if not donors:
            raise PlanningError("cannot satisfy >=1 microbatch per pipeline")
        i = max(donors, key=lambda j: counts[j] * times[j])
        counts[i] -= 1
        s -= 1
    while s < total_mb:
        i = min(range(x), key=lambda j: (counts[j] + 1) * times[j])
        counts[i] += 1
        s += 1
    return counts


def distribute_microbatches(times: Sequence[float], total_mb: int) -> List[int]:
    """Assign ``total_mb`` microbatches over pipelines with steady-state
    per-microbatch times ``times``; exact for the Eq. 6 objective.

    The 1-exchange descent evaluates each candidate move in O(1) via the
    separable identity  sum_i (l_i - mean)^2 = sum_i l_i^2 - (sum_i l_i)^2/x:
    moving one unit from i to j only touches l_i, l_j and the total, so a
    round over all O(x^2) moves costs O(x^2) instead of the O(x^3) a full
    re-evaluation per candidate costs — the difference between milliseconds
    and minutes at the 100+ pipeline scale the planner targets.

    The identity form rounds differently than the direct form in the last
    ulp, which matters exactly when moves TIE (equal-time pipelines): to
    stay bit-identical to ``_distribute_microbatches_reference`` (the
    retained full-recompute oracle), every candidate within fp noise of
    the round's minimum is re-scored with the direct objective and the
    reference's selection rule decides among them.
    """
    x = len(times)
    if total_mb < x:
        raise PlanningError(
            f"{total_mb} microbatches cannot give {x} pipelines >= 1 each")
    counts = _seed_counts(times, total_mb)

    def deltas():
        """Yield (identity-form candidate value, i, j) in reference
        iteration order, each in O(1)."""
        for i in range(x):
            if counts[i] <= 1:
                continue
            li, ti = loads[i], times[i]
            di = (li - ti) * (li - ti) - li * li       # sumsq delta at i
            for j in range(x):
                if i == j:
                    continue
                lj, tj = loads[j], times[j]
                nt = total + tj - ti
                yield (sumsq + di - lj * lj + (lj + tj) * (lj + tj)
                       - nt * nt / x, i, j)

    improved = True
    while improved:
        improved = False
        loads = [n * t for n, t in zip(counts, times)]
        total = sum(loads)
        sumsq = sum(l * l for l in loads)
        base = _objective(counts, times)
        cand = list(deltas())
        if not cand:
            break
        val_min = min(v for v, _, _ in cand)
        # absolute fp-noise bound of the identity form: the sumsq and
        # (sum)^2/x terms cancel catastrophically near-equal loads, so
        # the error scales with sumsq, not with the objective
        margin = 1e-12 * (sumsq + 1.0)
        best_move: Tuple[float, int, int] | None = None
        for val, i, j in cand:
            if val > val_min + margin:
                continue
            counts[i] -= 1
            counts[j] += 1
            dval = _objective(counts, times)
            counts[i] += 1
            counts[j] -= 1
            if dval < base - 1e-18 and (best_move is None
                                        or dval < best_move[0]):
                best_move = (dval, i, j)
        if best_move is not None:
            _, i, j = best_move
            counts[i] -= 1
            counts[j] += 1
            improved = True
    return counts


def _distribute_microbatches_reference(times: Sequence[float],
                                       total_mb: int) -> List[int]:
    """The pre-optimization descent: full O(x) objective recomputed for
    every candidate move.  Retained as the parity oracle for the
    incremental-delta version above (same seed, same move-selection
    order, same tolerance)."""
    x = len(times)
    if total_mb < x:
        raise PlanningError(
            f"{total_mb} microbatches cannot give {x} pipelines >= 1 each")
    counts = _seed_counts(times, total_mb)
    improved = True
    while improved:
        improved = False
        base = _objective(counts, times)
        best_move: Tuple[float, int, int] | None = None
        for i in range(x):
            if counts[i] <= 1:
                continue
            for j in range(x):
                if i == j:
                    continue
                counts[i] -= 1
                counts[j] += 1
                val = _objective(counts, times)
                counts[i] += 1
                counts[j] -= 1
                if val < base - 1e-18 and (best_move is None or val < best_move[0]):
                    best_move = (val, i, j)
        if best_move is not None:
            _, i, j = best_move
            counts[i] -= 1
            counts[j] += 1
            improved = True
    return counts


def recommend_global_batch(num_pipelines: int, microbatch: int,
                           requested: int) -> int:
    """Nearest feasible global batch (>= one microbatch per pipeline,
    divisible by b)."""
    floor_needed = num_pipelines * microbatch
    candidate = max(floor_needed, (requested // microbatch) * microbatch)
    return candidate


def distribute_batch(pipelines: Sequence[PipelineTemplate], global_batch: int,
                     microbatch: int) -> BatchPlan:
    """Eq. 6 entry point over instantiated pipelines (templates repeated
    per instance)."""
    if global_batch % microbatch != 0:
        raise PlanningError(
            f"global batch {global_batch} not divisible by microbatch "
            f"{microbatch}; recommend "
            f"{recommend_global_batch(len(pipelines), microbatch, global_batch)}")
    total_mb = global_batch // microbatch
    times = [t.stage_times[t.slowest_stage] for t in pipelines]
    if total_mb < len(pipelines):
        raise PlanningError(
            f"global batch {global_batch} too small for {len(pipelines)} "
            f"pipelines at microbatch {microbatch}; recommend "
            f"{recommend_global_batch(len(pipelines), microbatch, global_batch)}")
    counts = distribute_microbatches(times, total_mb)
    return BatchPlan(num_microbatches=tuple(counts),
                     microbatch_size=microbatch, global_batch=global_batch)
