"""Pipeline templates and node-specification generation (paper §4.1.1).

A *pipeline template* specifies, for a given number of nodes ``n``:
  - how many stages the pipeline has,
  - which contiguous layer range each stage owns,
  - which node (and how many of its GPUs) each stage runs on.

Node-spec generation chooses the template sizes (n_0 .. n_{p-1}) so that
ANY feasible node count N' with (f+1)*n_0 <= N' <= N is expressible as a
non-negative integer combination of the sizes.  Per Appendix A this holds
when the sizes are consecutive integers and p > n_0 - 1: the Frobenius
number of {n_0, n_0+1, ...} collapses to n_0 - 1, which is below the
feasibility floor.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


class PlanningError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One pipeline stage inside a template."""

    stage_id: int
    layer_start: int          # inclusive
    layer_end: int            # exclusive
    node_offset: int          # first node (template-relative) of this stage
    num_gpus: int             # GPUs assigned (tensor/FSDP parallel degree)
    gpu_offset: int = 0       # first GPU within the node (intra-node splits)

    @property
    def num_layers(self) -> int:
        return self.layer_end - self.layer_start


@dataclasses.dataclass(frozen=True)
class PipelineTemplate:
    """A logically-complete pipeline specification for ``num_nodes`` nodes."""

    num_nodes: int
    gpus_per_node: int
    num_stages: int
    stages: Tuple[StageSpec, ...]
    iteration_time: float       # planner estimate: T1+T2+T3 at N_b=4S
    t1: float
    t2: float
    t3: float
    slowest_stage: int
    stage_times: Tuple[float, ...]  # F+B of each stage (one microbatch)

    @property
    def num_layers(self) -> int:
        return self.stages[-1].layer_end

    def layer_to_stage(self) -> List[int]:
        """layer index -> stage id."""
        out = [0] * self.num_layers
        for st in self.stages:
            for l in range(st.layer_start, st.layer_end):
                out[l] = st.stage_id
        return out

    def stage_of_layer(self, layer: int) -> StageSpec:
        for st in self.stages:
            if st.layer_start <= layer < st.layer_end:
                return st
        raise IndexError(layer)

    def validate(self, num_layers: int) -> None:
        """Structural invariants (also exercised by property tests)."""
        assert self.stages[0].layer_start == 0
        assert self.stages[-1].layer_end == num_layers
        nodes_seen = set()
        for a, b in zip(self.stages, self.stages[1:]):
            assert a.layer_end == b.layer_start, "stages must tile the layers"
        for st in self.stages:
            assert st.num_layers >= 1
            assert 1 <= st.num_gpus <= self.gpus_per_node * self.num_nodes
            # paper constraint: a stage never spans nodes unless it owns
            # them wholly (multi-node stages are whole-node multiples).
            if st.num_gpus < self.gpus_per_node:
                assert st.gpu_offset + st.num_gpus <= self.gpus_per_node
            else:
                assert st.num_gpus % self.gpus_per_node == 0
            nodes_seen.add(st.node_offset)
        used = self.gpu_footprint()
        assert used == self.num_nodes * self.gpus_per_node, (
            f"template must use every GPU: {used} != "
            f"{self.num_nodes * self.gpus_per_node}")

    def gpu_footprint(self) -> int:
        return sum(st.num_gpus for st in self.stages)


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """Output of §4.1.1: the template sizes to pre-plan."""

    n0: int                     # smallest pipeline size (memory floor)
    p: int                      # number of templates
    sizes: Tuple[int, ...]      # consecutive: (n0, n0+1, ..., n0+p-1)
    f: int
    N: int

    def max_size(self) -> int:
        return self.sizes[-1]


def generate_node_spec(N: int, f: int, n0: int,
                       max_size: Optional[int] = None) -> NodeSpec:
    """Choose template sizes per §4.1.1.

    n0 is the memory-driven minimum nodes per pipeline (smallest possible,
    because shallow pipelines are faster).  The largest useful template is
    n_{p-1}^max = N - f*n0 (all other f replicas at minimal size), giving
    the largest p.  Conditions (consecutive sizes, p > n0 - 1) then
    guarantee coverage of every feasible N' >= (f+1)*n0  (Appendix A).

    ``max_size`` additionally caps template sizes (a pipeline cannot have
    more nodes than the model has layers); when the cap binds, coverage
    is re-verified exhaustively rather than by the closed-form theorem.
    """
    if n0 < 1:
        raise PlanningError(f"n0 must be >= 1, got {n0}")
    if f < 0:
        raise PlanningError(f"fault tolerance threshold must be >= 0, got {f}")
    n_max = N - f * n0
    capped = False
    if max_size is not None and n_max > max_size:
        n_max = max_size
        capped = True
    if n_max < n0:
        raise PlanningError(
            f"cluster too small: N={N} cannot hold f+1={f + 1} pipelines "
            f"of n0={n0} nodes (need >= {(f + 1) * n0})")
    p = n_max - n0 + 1
    if capped:
        if not _verify_coverage(range((f + 1) * n0, N + 1),
                                tuple(range(n0, n_max + 1)), f):
            raise PlanningError(
                f"capped node spec (sizes {n0}..{n_max}) cannot cover all "
                f"feasible node counts up to N={N} with f={f}")
    elif p <= n0 - 1:
        # Thm A.1 needs p > n0-1.  With consecutive sizes starting at n0
        # this can only fail when N is barely above (f+1)*n0; the fix used
        # by Oobleck is acceptable here too: coverage is still complete for
        # every N' expressible in range (we verify exhaustively below).
        covered = _verify_coverage(range((f + 1) * n0, N + 1),
                                   tuple(range(n0, n_max + 1)), f)
        if not covered:
            raise PlanningError(
                f"node spec infeasible: p={p} <= n0-1={n0 - 1} and coverage "
                f"check failed for N={N}, f={f}, n0={n0}")
    return NodeSpec(n0=n0, p=p, sizes=tuple(range(n0, n_max + 1)), f=f, N=N)


def _max_count_table(t_max: int, sizes: Tuple[int, ...]) -> List[int]:
    """``table[t]`` = max pipelines in any exact decomposition of ``t``
    into template sizes, or -1 if ``t`` is not expressible.  A combination
    with count >= c exists iff the max count is >= c, so tracking the max
    alone suffices — O(t_max * |sizes|), which is what keeps node-spec
    verification cheap on hundred-node clusters."""
    table = [-1] * (t_max + 1)
    table[0] = 0
    for amount in range(1, t_max + 1):
        best = -1
        for s in sizes:
            if s <= amount and table[amount - s] >= 0:
                cand = table[amount - s] + 1
                if cand > best:
                    best = cand
        table[amount] = best
    return table


def _verify_coverage(targets, sizes: Tuple[int, ...], f: int) -> bool:
    """Exhaustively verify every target is a sum of >= f+1 template sizes."""
    targets = list(targets)
    if not targets:
        return True
    table = _max_count_table(max(targets), sizes)
    return all(table[t] >= f + 1 for t in targets)


def _coverable(t: int, sizes: Tuple[int, ...], min_count: int) -> bool:
    return _max_count_table(t, sizes)[t] >= min_count


def coverable(n_nodes: int, spec: NodeSpec) -> bool:
    """Public check used by tests/engine: can ``n_nodes`` be fully used
    while keeping >= f+1 pipelines?"""
    if n_nodes < (spec.f + 1) * spec.n0:
        return False
    return _coverable(n_nodes, spec.sizes, spec.f + 1)
