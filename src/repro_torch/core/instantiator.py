"""Pipeline instantiation: enumerate feasible template combinations and
pick the throughput-optimal one (paper §4.2).

``X(p', N')`` is the list of all multisets ``(x_0..x_{p'-1})`` with
``sum x_i * n_i = N'`` — computed with the coin-change dynamic program of
Eq. 5.  Feasible sets additionally need ``sum x_i >= f+1``.  Throughput of
a feasible set is evaluated by running batch distribution (Eq. 6) over the
instantiated pipelines and taking ``B / max_i time_i``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.batch import BatchPlan, distribute_batch
from repro_torch.core.planner import estimate_iteration_time
from repro_torch.core.templates import NodeSpec, PipelineTemplate, PlanningError


@dataclasses.dataclass(frozen=True)
class InstantiationPlan:
    """How many pipelines to instantiate from each template + batching."""

    counts: Tuple[int, ...]            # x_i per template (indexed like sizes)
    sizes: Tuple[int, ...]             # node count per template
    batch: BatchPlan
    throughput: float                  # samples/sec estimate
    num_nodes: int

    @property
    def num_pipelines(self) -> int:
        return sum(self.counts)

    def pipeline_sizes(self) -> List[int]:
        """Node count of every instantiated pipeline, largest first."""
        out: List[int] = []
        for size, cnt in sorted(zip(self.sizes, self.counts), reverse=True):
            out.extend([size] * cnt)
        return out


def enumerate_feasible_sets(sizes: Sequence[int], N: int, min_count: int,
                            limit: int = 200_000) -> List[Tuple[int, ...]]:
    """All (x_0..x_{p-1}) with sum x_i*n_i == N and sum x_i >= min_count.

    Coin-change DP (Eq. 5): X(p', N') = X(p'-1, N') ++ theta(X(p', N'-n_p')).
    ``limit`` bounds the enumeration; if exceeded we fall back to keeping
    the lexicographically-greedy prefix (documented deviation for very
    large clusters — the paper's eval never exceeds 30 nodes).
    """
    p = len(sizes)
    # table[p'][N'] -> list of tuples over the first p' sizes
    prev: List[List[Tuple[int, ...]]] = [[] for _ in range(N + 1)]
    prev[0] = [()]
    truncated = False
    for j in range(p):
        cur: List[List[Tuple[int, ...]]] = [[] for _ in range(N + 1)]
        n_j = sizes[j]
        for amount in range(N + 1):
            # x_j = 0 branch: extend every prefix with a zero
            combos = [x + (0,) for x in prev[amount]]
            # x_j >= 1 branch: theta() on the same-row entry n_j to the left
            if amount >= n_j:
                for x in cur[amount - n_j]:
                    combos.append(x[:-1] + (x[-1] + 1,))
            if len(combos) > limit:
                combos = combos[:limit]
                truncated = True
            cur[amount] = combos
        prev = cur
    out = [x for x in prev[N] if sum(x) >= min_count]
    if truncated and not out:
        raise PlanningError("feasible-set enumeration truncated to nothing; "
                            "raise `limit`")
    return out


def greedy_counts(sizes: Tuple[int, ...], templates: Dict[int, PipelineTemplate],
                  N: int, min_count: int) -> Tuple[int, ...]:
    """Large-cluster fast path (1000+ nodes): exact enumeration of all
    feasible sets is the number of restricted integer partitions of N —
    astronomically large.  The paper's own observation (§7.4) is that at
    scale Oobleck 'simply instantiates more of the smaller pipelines', so
    we fill with the most per-node-efficient template and patch the
    remainder by coin-change DP for a single exact decomposition."""
    def efficiency(n):
        t = templates[n]
        return 1.0 / (t.stage_times[t.slowest_stage] * n)
    best = max(sizes, key=efficiency)
    # one exact decomposition for every reachable remainder
    reach = {0: {}}
    for amount in range(1, N + 1):
        for s in sizes:
            if s <= amount and (amount - s) in reach:
                reach[amount] = dict(reach[amount - s])
                reach[amount][s] = reach[amount].get(s, 0) + 1
                break
    # largest fill of `best` whose remainder decomposes with enough
    # pipelines overall
    for k in range(N // best, -1, -1):
        rem = N - k * best
        if rem not in reach:
            continue
        n_pipes = k + sum(reach[rem].values())
        if n_pipes >= min_count:
            counts = {s: 0 for s in sizes}
            counts[best] = k
            for s, c in reach[rem].items():
                counts[s] += c
            return tuple(counts[s] for s in sizes)
    raise PlanningError(f"greedy decomposition failed for N={N}")


def choose_plan(templates: Dict[int, PipelineTemplate], spec: NodeSpec,
                num_nodes: int, global_batch: int, microbatch: int,
                limit: int = 200_000,
                exact_threshold: int = 32) -> InstantiationPlan:
    """Pick the max-throughput feasible instantiation for ``num_nodes``.

    Above ``exact_threshold`` nodes the number of restricted partitions —
    and with it the cost of evaluating every feasible set — explodes, so
    the greedy decomposition takes over (within 10% of exact on the sizes
    where both are tractable; see tests/test_scale.py)."""
    sizes = tuple(spec.sizes)
    if num_nodes > exact_threshold:
        feasible = [greedy_counts(sizes, templates, num_nodes, spec.f + 1)]
    else:
        feasible = enumerate_feasible_sets(sizes, num_nodes, spec.f + 1,
                                           limit)
    if not feasible:
        raise PlanningError(
            f"no feasible pipeline set for {num_nodes} nodes with sizes "
            f"{sizes} and f={spec.f}")
    best: Optional[InstantiationPlan] = None
    for counts in feasible:
        # largest-first, matching InstantiationPlan.pipeline_sizes() so the
        # batch plan's N_b,i order lines up with instantiated pipelines.
        tpls: List[PipelineTemplate] = []
        for size, cnt in sorted(zip(sizes, counts), reverse=True):
            tpls.extend([templates[size]] * cnt)
        try:
            batch = distribute_batch(tpls, global_batch, microbatch)
        except PlanningError:
            continue
        times = [estimate_iteration_time(t, nb)
                 for t, nb in zip(tpls, batch.num_microbatches)]
        thpt = global_batch / max(times)
        if best is None or thpt > best.throughput:
            best = InstantiationPlan(counts=tuple(counts), sizes=sizes,
                                     batch=batch, throughput=thpt,
                                     num_nodes=num_nodes)
    if best is None:
        raise PlanningError(
            f"no feasible set admits an integral batch distribution for "
            f"B={global_batch}, b={microbatch} over {num_nodes} nodes")
    return best
