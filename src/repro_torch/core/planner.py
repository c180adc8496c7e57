"""GPU–stage mapping via divide-and-conquer DP (paper §4.1.2).

Given a pipeline template's node count ``n`` (each node = ``M`` chips), the
planner simultaneously partitions the model's layers into stages and the
``n*M`` chips onto those stages, minimizing the 1F1B critical-path estimate

    T = T1 + T2 + T3          (Figure 5)

where, for a stage sequence with per-stage one-microbatch times
``ts[0..S-1]`` and slowest stage ``k* = argmax ts``:

    T1 = sum(ts)                          # fill + drain
    T2 = (N_b - S + k* - 1) * ts[k*]      # steady phase on the slowest stage
    T3 = sum(ts[k*:])                     # tail after the slowest stage

with ``N_b = 4*S`` during planning (paper: bubble negligible at N_b >= 4S).
For a homogeneous pipeline this reduces to the exact 1F1B makespan
``(N_b + S - 1)(F + B)``.

Three division strategies (stages must not straddle nodes — the paper's
single-node-stage constraint, mapped to ICI neighborhoods per DESIGN.md §2):

  * ``mode="binary"`` — the paper's literal recursion: iterate all
    (s, k, m) stage/layer/chip splits (Eq. 1–3), memoized on
    ``(S', u, v, d, off)`` where ``off`` is the first chip's intra-node
    offset.  Kept pristine as the reference implementation.
  * ``mode="peel"``   — split off the first stage only (s=1).  Every stage
    sequence reachable by binary splits is reachable by peeling, and
    T1/T2/T3 depend only on the resulting stage sequence, so the optimum
    is the same; peeling visits far fewer split trees.  Since the right
    sub-problem always spans layers ``[k, L)``, the memo key tightens to
    ``(S', u, d, off)`` and leaves bypass the memo entirely.  The split
    scan is dominance-pruned: any combined solution satisfies
    ``T >= (3S+1) * t_max``, and the peeled stage's time grows
    monotonically in the layer cut ``k``, so once the first stage alone
    exceeds the incumbent the whole remaining k-scan is abandoned.
  * ``mode="fast"``   — bottom-up vectorized evaluation of exactly the
    peel recursion (DESIGN.md §3.2).  States collapse to ``(S', d')``
    rows of per-``u`` arrays (``off`` is derived: every template root has
    ``off=0`` and ``d ≡ 0 (mod M)``, so ``off = -d' mod M``), and the
    (k, m) split scan becomes a handful of numpy operations over an
    ``(m, u, k)`` grid.  Stage-boundary leaf times are materialized with
    running sums that reproduce ``sum()``'s left-to-right rounding, the
    combine arithmetic mirrors :func:`_combine` operation-for-operation,
    and ties resolve by C-order argmin (m-major, then k) — the same
    first-strict-improvement order the scalar scan uses — so ``fast``
    returns bit-identical iteration times AND stage sequences.  Default.

The memo/row caches are shared across template sizes: planning the largest
template fills the caches for all smaller ones (paper §4.1.2 memoization
note).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cost_model import ModelProfile
from repro_torch.core.templates import PipelineTemplate, PlanningError, StageSpec

INF = float("inf")

MODES = ("fast", "peel", "binary")


@dataclasses.dataclass(frozen=True)
class _Sol:
    """Memoized sub-solution for (S', u, v, d, off)."""

    total: float              # local objective T1 + T2 + T3  (N_b = 4*S')
    t1: float
    t3: float
    k_star: int               # slowest stage index, local numbering
    t_max: float              # ts[k_star]
    # decision: None for a leaf; peel: (1, k, m); binary: (s, k, m)
    cut: Optional[Tuple[int, int, int]]


def _combine(left: _Sol, right: _Sol, s_left: int, s_total: int) -> Tuple[float, float, float, int, float]:
    """Combine two sub-solutions (Eq. 1–3). Returns (total,t1,t3,k*,t_max)."""
    t1 = left.t1 + right.t1
    if left.t_max >= right.t_max:            # k* == k1*  (Eq. 3, first case)
        k_star, t_max = left.k_star, left.t_max
        t3 = left.t3 + right.t1
    else:                                    # k* in the right sub-problem
        k_star, t_max = s_left + right.k_star, right.t_max
        t3 = right.t3
    n_b = 4 * s_total
    t2 = (n_b - s_total + k_star - 1) * t_max
    return t1 + t2 + t3, t1, t3, k_star, t_max


def _min_segments(d: int, off: int, M: int) -> int:
    """Minimum stages needed so no stage straddles a node boundary."""
    first = min(d, M - off)
    rest = d - first
    return 1 + (rest + M - 1) // M if rest else 1


@dataclasses.dataclass
class _FastRow:
    """Per-(S', d') DP row of the vectorized peel recursion, indexed by the
    first-uncovered-layer ``u``.  ``tot[u] == INF`` marks infeasibility."""

    tot: np.ndarray           # float64[L+1]
    t1: np.ndarray            # float64[L+1]
    t3: np.ndarray            # float64[L+1]
    tm: np.ndarray            # float64[L+1]
    ks: np.ndarray            # int32[L+1]
    cut_k: np.ndarray         # int32[L+1]   (-1 for leaves / infeasible)
    cut_m: np.ndarray         # int16[L+1]


class PipelinePlanner:
    """Plans GPU–stage mappings for every template size of one model."""

    def __init__(self, profile: ModelProfile, gpus_per_node: int,
                 mode: str = "fast", max_stages: Optional[int] = None):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
        self.profile = profile
        self.M = gpus_per_node
        self.mode = mode
        self.max_stages = max_stages
        self.L = profile.num_layers
        self._memo: Dict[Tuple, _Sol] = {}
        self._leaf_cache: Dict[Tuple[int, int, int], float] = {}
        # fast-mode state, shared across template sizes (tighter memo keys)
        self._rows: Dict[Tuple[int, int], Optional[_FastRow]] = {}
        self._leaf_tables: Dict[int, np.ndarray] = {}

    # ------------------------------------------------------------------
    def plan(self, num_nodes: int) -> PipelineTemplate:
        """Best template for ``num_nodes`` nodes: argmin over S of T(S,...)."""
        n, M, L = num_nodes, self.M, self.L
        d = n * M
        if L < n:
            raise PlanningError(
                f"model has {L} layers < {n} nodes; cannot give every node a stage")
        s_lo = n                       # pigeonhole: >= 1 stage per node
        s_hi = min(L, d)
        if self.max_stages is not None:
            s_hi = min(s_hi, max(s_lo, self.max_stages))
        if self.mode == "fast":
            return self._plan_fast(num_nodes, s_lo, s_hi)
        best: Optional[_Sol] = None
        best_s = -1
        for S in range(s_lo, s_hi + 1):
            sol = self._solve(S, 0, L, d, 0)
            if sol.total < (best.total if best else INF):
                best, best_s = sol, S
        if best is None or math.isinf(best.total):
            raise PlanningError(f"no feasible mapping for {n} nodes x {M} GPUs")
        seq = self._stage_sequence(best_s, 0, self.L, d, 0)
        return self._build_template(seq, num_nodes, best_s)

    def plan_all(self, sizes) -> Dict[int, PipelineTemplate]:
        """Plan every template size, largest first to maximize memo reuse."""
        out: Dict[int, PipelineTemplate] = {}
        for n in sorted(sizes, reverse=True):
            out[n] = self.plan(n)
        return dict(sorted(out.items()))

    # ------------------------------------------------------------------
    def _leaf_time(self, u: int, v: int, d: int) -> float:
        key = (u, v, d)
        t = self._leaf_cache.get(key)
        if t is None:
            t = (self.profile.stage_fwd(u, v, d) + self.profile.stage_bwd(u, v, d))
            self._leaf_cache[key] = t
        return t

    def _leaf_sol(self, u: int, v: int, d: int, off: int) -> _Sol:
        """Single-stage conquer step, bypassing the split memo."""
        if off + d > self.M:            # stage must fit within one node
            return self._infeasible()
        t = self._leaf_time(u, v, d)
        # T1 = F+B; T2 = 2(F+B); T3 = F+B  (Eq. 4) -> total = 4(F+B)
        return _Sol(4.0 * t, t, t, 0, t, None)

    def _solve(self, S: int, u: int, v: int, d: int, off: int) -> _Sol:
        if S == 1:
            if v - u < 1 or d < 1:
                return self._infeasible()
            return self._leaf_sol(u, v, d, off)
        # peel sub-problems always span [u, L): drop v from the key so the
        # memo is shared across template sizes at maximal granularity.
        key = ((S, u, d, off) if self.mode == "peel"
               else (S, u, v, d, off))
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        sol = self._compute(S, u, v, d, off)
        self._memo[key] = sol
        return sol

    def _infeasible(self) -> _Sol:
        return _Sol(INF, INF, INF, 0, INF, None)

    def _compute(self, S: int, u: int, v: int, d: int, off: int) -> _Sol:
        M = self.M
        if v - u < S or d < S:          # each stage needs >= 1 layer, 1 GPU
            return self._infeasible()
        if _min_segments(d, off, M) > S:
            return self._infeasible()
        if self.mode == "peel":
            return self._compute_peel(S, u, v, d, off)
        return self._compute_binary(S, u, v, d, off)

    def _compute_peel(self, S: int, u: int, v: int, d: int, off: int) -> _Sol:
        M = self.M
        best: Optional[_Sol] = None
        m_hi = min(d - (S - 1), M - off)
        for m in range(1, m_hi + 1):
            for k in range(u + 1, v - (S - 1) + 1):
                left = self._leaf_sol(u, k, m, off)
                # Dominance bound: any combined solution has
                # T >= (3S+1) * t_max >= (3S+1) * left.t_max, and the
                # peeled stage's time grows with k, so the rest of the
                # k-scan cannot beat the incumbent either.
                if best is not None and (3 * S + 1) * left.t_max >= best.total:
                    break
                right = self._solve(S - 1, k, v, d - m, (off + m) % M)
                if math.isinf(right.total):
                    continue
                total, t1, t3, k_star, t_max = _combine(left, right, 1, S)
                if best is None or total < best.total:
                    best = _Sol(total, t1, t3, k_star, t_max, (1, k, m))
        return best if best is not None else self._infeasible()

    def _compute_binary(self, S: int, u: int, v: int, d: int, off: int) -> _Sol:
        M = self.M
        best: Optional[_Sol] = None
        splits = [(s, k, m)
                  for s in range(1, S)
                  for k in range(u + s, v - (S - s) + 1)
                  for m in range(s, d - (S - s) + 1)]
        for s, k, m in splits:
            left = self._solve(s, u, k, m, off)
            if math.isinf(left.total):
                continue
            right = self._solve(S - s, k, v, d - m, (off + m) % M)
            if math.isinf(right.total):
                continue
            total, t1, t3, k_star, t_max = _combine(left, right, s, S)
            if best is None or total < best.total:
                best = _Sol(total, t1, t3, k_star, t_max, (s, k, m))
        return best if best is not None else self._infeasible()

    # ------------------------------------------------------------------
    # mode="fast": bottom-up vectorized peel DP.
    # ------------------------------------------------------------------
    def _leaf_table(self, d: int) -> np.ndarray:
        """``t[u, v]`` = leaf time of stage [u, v) on ``d`` chips, with the
        exact left-to-right summation of ``stage_fwd`` / ``stage_bwd`` so
        results are bit-identical to :meth:`_leaf_time`."""
        tbl = self._leaf_tables.get(d)
        if tbl is not None:
            return tbl
        L = self.L
        fwd = [self.profile.fwd_time(i, d) for i in range(L)]
        bwd = [self.profile.bwd_time(i, d) for i in range(L)]
        tbl = np.full((L + 1, L + 1), INF)
        for u in range(L + 1):
            facc = 0.0
            bacc = 0.0
            row = tbl[u]
            for v in range(u + 1, L + 1):
                facc = facc + fwd[v - 1]
                bacc = bacc + bwd[v - 1]
                row[v] = facc + bacc
        self._leaf_tables[d] = tbl
        return tbl

    def _ensure_rows(self, S: int, d: int) -> None:
        """Fill every (s', d') row reachable from root (S, d) bottom-up."""
        M = self.M
        for s in range(1, S + 1):
            lo = max(s, d - (S - s) * M)
            hi = min(s * M, d - (S - s))
            for dp in range(lo, hi + 1):
                if (s, dp) not in self._rows:
                    self._rows[(s, dp)] = self._compute_row(s, dp)

    def _compute_row(self, S: int, d: int) -> Optional[_FastRow]:
        L, M = self.L, self.M
        if d < S or L < S:
            return None
        off = (-d) % M
        if S == 1:
            if d > M:                  # stage must fit within one node
                return None
            t = self._leaf_table(d)[:, L].copy()   # t[u] = leaf(u, L, d)
            ks = np.zeros(L + 1, dtype=np.int32)
            cut_k = np.full(L + 1, -1, dtype=np.int32)
            cut_m = np.zeros(L + 1, dtype=np.int16)
            return _FastRow(4.0 * t, t.copy(), t.copy(), t.copy(), ks,
                            cut_k, cut_m)
        m_hi = min(d - (S - 1), M - off)
        if m_hi < 1:
            return None
        # only u <= L-S can host S further stages; cuts live in (u, L-(S-1)]
        u_hi = L - S                       # inclusive
        k_hi = L - (S - 1)                 # inclusive
        nu, nk = u_hi + 1, k_hi + 1
        k_idx = np.arange(nk)
        k_valid = (k_idx[None, :] > np.arange(nu)[:, None])
        grids: List[np.ndarray] = []
        ms: List[int] = []
        children: List[_FastRow] = []
        for m in range(1, m_hi + 1):
            child = self._rows.get((S - 1, d - m))
            if child is None:
                continue
            t = self._leaf_table(m)[:nu, :nk]            # [u, k]
            t1 = t + child.t1[None, :nk]
            # same association order as _combine: (t1 + t2) + t3
            left_tot = (t1 + (3 * S - 1) * t) + t1
            right_tot = ((t1 + (3 * S + child.ks[None, :nk]) * child.tm[None, :nk])
                         + child.t3[None, :nk])
            tot = np.where(t >= child.tm[None, :nk], left_tot, right_tot)
            grids.append(np.where(k_valid, tot, INF))
            ms.append(m)
            children.append(child)
        if not grids:
            return None
        # m-major, then k: identical tie-breaking to the scalar peel scan.
        stack = np.stack(grids)                          # [m, u, k]
        flat = np.moveaxis(stack, 0, 1).reshape(nu, -1)
        idx = np.argmin(flat, axis=1)
        tot = np.full(L + 1, INF)
        tot[:nu] = flat[np.arange(nu), idx]
        m_sel = np.zeros(L + 1, dtype=np.int64)
        m_sel[:nu] = idx // nk
        k_sel = np.zeros(L + 1, dtype=np.int32)
        k_sel[:nu] = (idx % nk).astype(np.int32)
        feasible = np.isfinite(tot)
        if not feasible.any():
            return None
        t1 = np.full(L + 1, INF)
        t3 = np.full(L + 1, INF)
        tm = np.full(L + 1, INF)
        ks = np.zeros(L + 1, dtype=np.int32)
        cut_k = np.full(L + 1, -1, dtype=np.int32)
        cut_m = np.zeros(L + 1, dtype=np.int16)
        for mi, (m, child) in enumerate(zip(ms, children)):
            sel = feasible & (m_sel == mi)
            if not sel.any():
                continue
            u = np.nonzero(sel)[0]
            k = k_sel[sel]
            t = self._leaf_table(m)[u, k]
            r1 = child.t1[k]
            rtm = child.tm[k]
            cond = t >= rtm
            t1v = t + r1
            t1[sel] = t1v
            tm[sel] = np.where(cond, t, rtm)
            ks[sel] = np.where(cond, 0, 1 + child.ks[k])
            t3[sel] = np.where(cond, t1v, child.t3[k])
            cut_k[sel] = k
            cut_m[sel] = m
        return _FastRow(tot, t1, t3, tm, ks, cut_k, cut_m)

    def _plan_fast(self, num_nodes: int, s_lo: int, s_hi: int) -> PipelineTemplate:
        d = num_nodes * self.M
        best_tot, best_s = INF, -1
        for S in range(s_lo, s_hi + 1):
            self._ensure_rows(S, d)
            row = self._rows.get((S, d))
            if row is None:
                continue
            tot = float(row.tot[0])
            if tot < best_tot:
                best_tot, best_s = tot, S
        if best_s < 0:
            raise PlanningError(
                f"no feasible mapping for {num_nodes} nodes x {self.M} GPUs")
        # walk the stored cuts: (S', u, d') -> peel (u, cut_k, cut_m)
        seq: List[Tuple[int, int, int]] = []
        S, u, dp = best_s, 0, d
        while S > 1:
            row = self._rows[(S, dp)]
            k, m = int(row.cut_k[u]), int(row.cut_m[u])
            if k < 0:
                raise PlanningError("reconstruction reached infeasible state")
            seq.append((u, k, m))
            u, dp, S = k, dp - m, S - 1
        seq.append((u, self.L, dp))
        return self._build_template(seq, num_nodes, best_s)

    # ------------------------------------------------------------------
    def _stage_sequence(self, S: int, u: int, v: int, d: int, off: int
                        ) -> List[Tuple[int, int, int]]:
        """Reconstruct [(layer_start, layer_end, num_gpus), ...]."""
        sol = self._solve(S, u, v, d, off)
        if math.isinf(sol.total):
            raise PlanningError("reconstruction reached infeasible state")
        if sol.cut is None:
            return [(u, v, d)]
        s, k, m = sol.cut
        if s == 1:
            left = [(u, k, m)]
        else:
            left = self._stage_sequence(s, u, k, m, off)
        right = self._stage_sequence(S - s, k, v, d - m, (off + m) % self.M)
        return left + right

    def _build_template(self, seq: List[Tuple[int, int, int]],
                        num_nodes: int, S: int) -> PipelineTemplate:
        stages: List[StageSpec] = []
        cursor = 0
        times: List[float] = []
        for sid, (u, v, d) in enumerate(seq):
            stages.append(StageSpec(
                stage_id=sid, layer_start=u, layer_end=v,
                node_offset=cursor // self.M, num_gpus=d,
                gpu_offset=cursor % self.M))
            times.append(self._leaf_time(u, v, d))
            cursor += d
        k_star = max(range(len(times)), key=lambda i: times[i])
        t_max = times[k_star]
        n_b = 4 * S
        t1 = sum(times)
        t2 = (n_b - S + k_star - 1) * t_max
        t3 = sum(times[k_star:])
        tpl = PipelineTemplate(
            num_nodes=num_nodes, gpus_per_node=self.M, num_stages=S,
            stages=tuple(stages), iteration_time=t1 + t2 + t3,
            t1=t1, t2=t2, t3=t3, slowest_stage=k_star,
            stage_times=tuple(times))
        tpl.validate(self.L)
        return tpl


# ----------------------------------------------------------------------
def estimate_iteration_time(tpl: PipelineTemplate, num_microbatches: int) -> float:
    """1F1B makespan estimate for an instantiated pipeline running
    ``num_microbatches`` microbatches (affine in N_b)."""
    n_b = max(num_microbatches, tpl.num_stages)  # cannot go below fill
    t2 = (n_b - tpl.num_stages + tpl.slowest_stage - 1) * tpl.stage_times[tpl.slowest_stage]
    return tpl.t1 + max(t2, 0.0) + tpl.t3
