"""Bucketed gradient-sync data plane (``repro/runtime/sync_exec.py``).

The planner's sync plan (``core/sync.py``) says WHAT synchronises —
layer buckets with identical peer structure, deepest-first.  This module
executes it:

  * each bucket's layer gradients are packed into ONE flat fp32 buffer
    per replica and scaled by the replica's batch weight;
  * buckets reduce deepest-first (the plan's order); when a bucket's
    peers span pods the reduction runs two-level — partial sums within
    each pod, then one sum across pods.  Every replica consumes the SAME
    reduced buffer, so replicas stay bitwise identical;
  * then the per-bucket sum of squares (the global-norm clip input) and
    one AdamW update per bucket per replica;
  * optional wire codec with per-(bucket, replica) error feedback.

Programs are keyed by the bucket's LAYER STRUCTURE only, so ``warm()``
covers every layout a reconfiguration can produce and recovery builds
nothing.  ``perlayer_sync`` keeps the per-layer path as the parity
oracle: with codec ``none`` the bucketed result is bitwise equal to it
(the same multiply and add per element, in the same order).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Hashable, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.sync import SyncBucket, split_span
from repro_torch.optim import adamw
from repro_torch.runtime.compression import (CODEC_WIRE, ErrorFeedback,
                                             decode_flat, encode_flat)
from repro_torch.runtime.executor import ProgramCache, tree_spec
from repro_torch.utils.tree import (tree_leaves, tree_map,
                                    tree_unflatten_like)

LayerState = Dict[str, Any]


# ----------------------------------------------------------------------
# The per-layer oracle
# ----------------------------------------------------------------------
def perlayer_sync(all_grads: Sequence[Dict[int, Any]],
                  weights: Sequence[float], num_layers: int
                  ) -> Dict[int, Any]:
    """Layer-granular cross-replica weighted average (paper Figure 9).
    Weights are minibatch sizes, so the result is the global-batch mean
    gradient."""
    wsum = float(sum(weights))
    synced: Dict[int, Any] = {}
    for l in range(num_layers):
        contribs = [(w / wsum, g[l]) for w, g in zip(weights, all_grads)
                    if l in g]
        acc = tree_map(lambda t: t * contribs[0][0], contribs[0][1])
        for w, g in contribs[1:]:
            acc = tree_map(lambda a, t: a + t * w, acc, g)
        synced[l] = acc
    return synced


def perlayer_global_sumsq(synced: Dict[int, Any], num_layers: int
                          ) -> torch.Tensor:
    """Sum of squared gradient elements across the whole model."""
    sq = None
    for l in range(num_layers):
        for t in tree_leaves(synced[l]):
            s = torch.sum(torch.square(t.float()))
            sq = s if sq is None else sq + s
    return sq


# ----------------------------------------------------------------------
# Bucket execution plan
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BucketExec:
    """One sync bucket bound for execution."""

    lids: Tuple[int, ...]                       # ascending layer ids
    specs: Tuple                                # program identity (structure)
    n: int                                      # flat fp32 element count
    pod_groups: Tuple[Tuple[int, ...], ...]     # replica indices per pod

    @property
    def signature(self) -> Tuple:
        """Residual key component: the layer span and its size."""
        return (self.lids, self.n)

    @property
    def hierarchical(self) -> bool:
        return len(self.pod_groups) > 1


@dataclasses.dataclass
class SyncReduceResult:
    """What the reduce phase produced, with NO state mutated: the
    optimizer commit (and the residual commit with it) happens only
    after the caller's sync-phase fault seam passes."""

    flats: List[torch.Tensor]                   # per bucket, reduced
    sumsqs: List[torch.Tensor]                  # per bucket, scalar
    staged_residuals: Dict[Hashable, torch.Tensor]


class BucketedSync:
    """The bucketed sync / clip / update tail.  Owns no layer state: it
    reads per-replica gradient dicts and replaces ``run.states`` entries
    with the updated ones."""

    def __init__(self, cache: ProgramCache, opt_cfg: adamw.AdamWConfig,
                 layer_avals: Sequence[Any], codec: str = "none"):
        if codec not in CODEC_WIRE:
            raise ValueError(f"unknown codec {codec!r}")
        self.cache = cache
        self.opt_cfg = opt_cfg
        self.layer_avals = list(layer_avals)
        self.codec = codec
        self.ef = ErrorFeedback(codec)

    # ------------------------------------------------------------------
    # Plan construction
    # ------------------------------------------------------------------
    def exec_plan(self, sync_plan: Sequence[SyncBucket],
                  replica_pods: Optional[Sequence[Sequence[Hashable]]] = None
                  ) -> List[BucketExec]:
        """Bind the planner's buckets for execution; ``replica_pods[b]``
        gives, per bucket, the pod of each replica's lead owner (None:
        one pod)."""
        out: List[BucketExec] = []
        for i, b in enumerate(sync_plan):
            lids = tuple(range(b.layer_start, b.layer_end))
            specs = tuple(tree_spec(self.layer_avals[l]) for l in lids)
            n = sum(math.prod(a.shape) for l in lids
                    for a in tree_leaves(self.layer_avals[l]))
            pods = replica_pods[i] if replica_pods is not None else None
            out.append(BucketExec(lids=lids, specs=specs, n=n,
                                  pod_groups=self._group(pods)))
        return out

    @staticmethod
    def _group(pods: Optional[Sequence[Hashable]]
               ) -> Tuple[Tuple[int, ...], ...]:
        if not pods:
            return ((),)        # filled per replica count at reduce
        groups: List[List[int]] = []
        index: Dict[Hashable, int] = {}
        for r, pod in enumerate(pods):
            if pod not in index:
                index[pod] = len(groups)
                groups.append([])
            groups[index[pod]].append(r)
        return tuple(tuple(g) for g in groups)

    # ------------------------------------------------------------------
    # Program family (keys carry structure, never placement)
    # ------------------------------------------------------------------
    def _pack_prog(self, b: BucketExec) -> Callable:
        def build() -> Callable:
            def pack(layers):
                return torch.cat([leaf.reshape(-1).float()
                                  for lt in layers for leaf in tree_leaves(lt)])
            return pack
        return self.cache.get_or_build(("bpack", b.specs), build)

    def _scale_prog(self, n: int) -> Callable:
        return self.cache.get_or_build(("bscale", n),
                                       lambda: lambda x, w: x * w)

    def _add_prog(self, n: int) -> Callable:
        return self.cache.get_or_build(("badd", n),
                                       lambda: lambda acc, x: acc + x)

    def _sumsq_prog(self, n: int) -> Callable:
        return self.cache.get_or_build(
            ("bsumsq", n), lambda: lambda x: torch.sum(torch.square(x)))

    def _ef_prog(self, n: int) -> Callable:
        """codec roundtrip + error feedback for one replica's weighted
        contribution: what goes on the wire, and what the codec lost."""
        codec = self.codec

        def build() -> Callable:
            def ef(c, res):
                c = c + res
                sent = decode_flat(encode_flat(c, codec), codec)
                return sent, c - sent
            return ef
        return self.cache.get_or_build(("bef", codec, n), build)

    def _update_prog(self, b: BucketExec) -> Callable:
        """Per-bucket AdamW: unflatten the reduced buffer into the
        bucket's layers and update each of them."""
        def build() -> Callable:
            layer_cfg = dataclasses.replace(self.opt_cfg, clip_norm=0.0)

            def upd(states, flat, scale, step):
                out, off = [], 0
                for st in states:
                    grads = []
                    for leaf in tree_leaves(st["p"]):
                        sz = leaf.numel()
                        grads.append(flat[off:off + sz].view(leaf.shape)
                                     * scale)
                        off += sz
                    g = tree_unflatten_like(st["p"], grads)
                    new_p, new_opt, _ = adamw.update(
                        layer_cfg, st["p"], g,
                        adamw.AdamWState(step, st["m"], st["v"]))
                    out.append({"p": new_p, "m": new_opt.m, "v": new_opt.v})
                return out
            return upd
        return self.cache.get_or_build(("bupdate", b.specs), build)

    # ------------------------------------------------------------------
    # Warming
    # ------------------------------------------------------------------
    def bind_plan(self, plan: Sequence[BucketExec]) -> None:
        """Ensure every program the CURRENT plan needs is cached."""
        for b in plan:
            self._pack_prog(b)
            self._scale_prog(b.n)
            self._add_prog(b.n)
            self._sumsq_prog(b.n)
            self._update_prog(b)
            if self.codec != "none":
                self._ef_prog(b.n)

    def warm(self, templates: Iterable[Any], layer_bytes: Sequence[int],
             bucket_cap_bytes: int) -> None:
        """Build bucket programs for EVERY layout a reachable instance
        set can produce: cap-splits (``split_span``, shared with the
        planner) of every span between template stage boundaries."""
        num_layers = len(self.layer_avals)
        bounds = {0, num_layers}
        for t in templates:
            for st in t.stages:
                bounds.add(int(st.layer_start))
                bounds.add(int(st.layer_end))
        pts = sorted(p for p in bounds if 0 <= p <= num_layers)
        seen: set = set()
        for i, s in enumerate(pts):
            for e in pts[i + 1:]:
                seen.update(split_span(s, e, layer_bytes, bucket_cap_bytes))
        for (lo, hi) in sorted(seen):
            self.bind_plan(self.exec_plan([SyncBucket(lo, hi, ((),), 0)]))

    # ------------------------------------------------------------------
    # Execution
    # ------------------------------------------------------------------
    def contributions(self, plan: Sequence[BucketExec],
                      grads_by_replica: Dict[int, Dict[int, Any]],
                      weights: Sequence[float]
                      ) -> Tuple[Dict[int, List[torch.Tensor]],
                                 Dict[Hashable, torch.Tensor]]:
        """Per-replica weighted bucket contributions (packed, scaled and,
        with a codec, error-fed).  Returns ({replica: [flat per bucket]},
        staged residuals)."""
        wsum = float(sum(weights))
        out: Dict[int, List[torch.Tensor]] = {r: [] for r in grads_by_replica}
        staged: Dict[Hashable, torch.Tensor] = {}
        for b in plan:
            pack = self._pack_prog(b)
            for r, g in grads_by_replica.items():
                missing = [l for l in b.lids if l not in g]
                if missing:
                    raise ValueError(f"replica {r} lacks grads for layers "
                                     f"{missing}")
                c = self._scale_prog(b.n)(pack([g[l] for l in b.lids]),
                                          weights[r] / wsum)
                if self.codec != "none":
                    res_key = ("ef", b.signature, self.codec, r)
                    res = self.ef.get(res_key)
                    if res is None:
                        res = torch.zeros_like(c)
                    c, staged[res_key] = self._ef_prog(b.n)(c, res)
                out[r].append(c)
        return out, staged

    def combine(self, plan: Sequence[BucketExec],
                contribs_by_replica: Dict[int, Sequence[torch.Tensor]]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Reduce the full contribution set: per bucket, left-to-right
        partial sums within each pod group, then across pods, plus the
        per-bucket sum of squares.  Deterministic chains: the same
        contributions always give the same bits."""
        R = len(contribs_by_replica)
        if sorted(contribs_by_replica) != list(range(R)):
            raise ValueError(f"combine needs contributions from all "
                             f"replicas, got {sorted(contribs_by_replica)}")
        flats: List[torch.Tensor] = []
        sumsqs: List[torch.Tensor] = []
        for i, b in enumerate(plan):
            groups = (b.pod_groups if b.pod_groups != ((),)
                      else (tuple(range(R)),))
            contribs = [contribs_by_replica[r][i] for r in range(R)]
            partials: List[torch.Tensor] = []
            for grp in groups:
                acc = contribs[grp[0]]
                for r in grp[1:]:
                    acc = self._add_prog(b.n)(acc, contribs[r])
                partials.append(acc)
            total = partials[0]
            for p in partials[1:]:
                total = self._add_prog(b.n)(total, p)
            flats.append(total)
            sumsqs.append(self._sumsq_prog(b.n)(total))
        return flats, sumsqs

    def reduce(self, plan: Sequence[BucketExec],
               all_grads: Sequence[Dict[int, Any]],
               weights: Sequence[float]) -> SyncReduceResult:
        """Weighted cross-replica reduction of every bucket.  Pure with
        respect to trainer state: residual updates are staged."""
        contribs, staged = self.contributions(
            plan, {r: g for r, g in enumerate(all_grads)}, weights)
        flats, sumsqs = self.combine(plan, contribs)
        return SyncReduceResult(flats=flats, sumsqs=sumsqs,
                                staged_residuals=staged)

    def commit_residuals(self, result: SyncReduceResult) -> None:
        for k, v in result.staged_residuals.items():
            self.ef.put(k, v)

    def retain_residuals(self, plan: Sequence[BucketExec],
                         num_replicas: int) -> int:
        """Drop residuals the current bucket layout can no longer use."""
        valid = {("ef", b.signature, self.codec, r)
                 for b in plan for r in range(num_replicas)}
        return self.ef.retain(valid)

    def update(self, plan: Sequence[BucketExec],
               flats: Sequence[torch.Tensor], states: Dict[int, LayerState],
               scale: torch.Tensor, step: torch.Tensor) -> None:
        """Apply the per-bucket AdamW to ONE replica's layer states (dict
        entries are replaced)."""
        for b, flat in zip(plan, flats):
            new_states = self._update_prog(b)(
                [states[l] for l in b.lids], flat, scale, step)
            for l, st in zip(b.lids, new_states):
                states[l] = st
