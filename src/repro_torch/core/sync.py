"""Layer-granularity gradient synchronization planning (paper §6.1).

Heterogeneous pipelines place the same layer in different stages on
different node sets, so stage-granular data-parallel all-reduce is
impossible.  Oobleck instead synchronizes per *layer*: for every layer,
the nodes holding that layer across all pipeline replicas form a
communication group (a dedicated NCCL subcommunicator in the original; a
per-bucket collective over an explicit device subset in the port's runtime).

Consecutive layers with identical peer structure are merged into buckets
(PyTorch-style bucketing) so small layers don't issue tiny collectives,
and buckets are emitted in reverse-depth order so the runtime can overlap
each bucket's all-reduce with the backward of earlier layers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.reconfigure import PipelineInstance
from repro_torch.utils import hw as hwlib


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    """Sync participants for one layer: one entry per pipeline replica."""

    layer: int
    # per replica: ordered tuple of nodes holding this layer's shards
    replicas: Tuple[Tuple[str, ...], ...]

    @property
    def uniform_sharding(self) -> bool:
        """True if every replica shards this layer over the same number of
        nodes — the fast path where shard-wise ring all-reduce applies."""
        widths = {len(r) for r in self.replicas}
        return len(widths) == 1

    def peer_groups(self) -> List[Tuple[str, ...]]:
        """Concrete all-reduce groups.

        Fast path (uniform sharding): shard i of every replica forms one
        group.  Slow path (widths differ): the lead node of each replica
        gathers its pipeline's full layer gradient, leads all-reduce, then
        re-scatter — expressed here as a single lead group; the
        gather/scatter legs are intra-replica.
        """
        if self.uniform_sharding:
            width = len(self.replicas[0])
            return [tuple(rep[i] for rep in self.replicas)
                    for i in range(width)]
        return [tuple(rep[0] for rep in self.replicas)]


@dataclasses.dataclass(frozen=True)
class SyncBucket:
    """Consecutive layers sharing identical peer structure."""

    layer_start: int
    layer_end: int
    groups: Tuple[Tuple[str, ...], ...]
    nbytes: int

    @property
    def num_layers(self) -> int:
        return self.layer_end - self.layer_start


def layer_groups(instances: Sequence[PipelineInstance]) -> List[LayerGroup]:
    if not instances:
        return []
    num_layers = instances[0].template.num_layers
    out: List[LayerGroup] = []
    for l in range(num_layers):
        reps = tuple(tuple(inst.layer_owners(l)) for inst in instances)
        out.append(LayerGroup(layer=l, replicas=reps))
    return out


def split_span(layer_start: int, layer_end: int, layer_bytes: Sequence[int],
               bucket_cap_bytes: int) -> List[Tuple[int, int]]:
    """Cap-split one constant-peer-structure run ``[layer_start,
    layer_end)`` into bucket spans, deepest-first — the exact greedy
    descending accumulation ``build_sync_plan`` applies inside a run.

    Shared with the runtime data plane's program warmer
    (runtime/sync_exec.py): any bucket span the planner can emit for any
    reachable instance set is the cap-split of a span between two
    template stage boundaries, so warming over this same function is
    what makes reconfiguration zero-compile for bucket programs too.
    """
    spans: List[Tuple[int, int]] = []
    cur_lo = cur_hi = -1
    cur_bytes = 0
    for l in reversed(range(layer_start, layer_end)):   # deepest first
        nbytes = int(layer_bytes[l])
        if cur_lo < 0 or cur_bytes + nbytes > bucket_cap_bytes:
            if cur_lo >= 0:
                spans.append((cur_lo, cur_hi))
            cur_lo, cur_hi, cur_bytes = l, l + 1, nbytes
        else:
            cur_lo = l
            cur_bytes += nbytes
    if cur_lo >= 0:
        spans.append((cur_lo, cur_hi))
    return spans


def build_sync_plan(instances: Sequence[PipelineInstance],
                    layer_bytes: Sequence[int],
                    bucket_cap_bytes: int = 64 * 1024 * 1024) -> List[SyncBucket]:
    """Bucketed, reverse-depth-ordered sync plan.

    ``layer_bytes[l]`` is the gradient payload of layer ``l`` (bf16).
    Buckets close when the peer structure changes or the cap is reached.
    Returned deepest-first: bucket i can be all-reduced while backward of
    shallower layers still runs (compute/comm overlap, §6.1).
    """
    groups = layer_groups(instances)
    buckets: List[SyncBucket] = []
    # maximal runs of layers with identical peer structure, deepest-first
    run_hi = run_lo = len(groups)
    run_groups: Tuple[Tuple[str, ...], ...] = ()

    def flush_run():
        for (lo, hi) in split_span(run_lo, run_hi, layer_bytes,
                                   bucket_cap_bytes):
            buckets.append(SyncBucket(
                lo, hi, run_groups,
                sum(int(layer_bytes[l]) for l in range(lo, hi))))

    for g in reversed(groups):          # deepest layer first
        pg = tuple(g.peer_groups())
        if run_lo == run_hi or pg != run_groups:
            if run_lo < run_hi:
                flush_run()
            run_lo = run_hi = g.layer + 1
            run_groups = pg
        run_lo = g.layer
    if run_lo < run_hi:
        flush_run()
    return buckets


def layer_owner_map(instances: Sequence[PipelineInstance]
                    ) -> Dict[int, Set[str]]:
    """Layer -> every node holding its state across all replicas: the
    candidate-source set the recovery data plane (runtime/transfer.py)
    draws from, and what the copy plan's ``CopyTask.sources`` records."""
    return {g.layer: {n for rep in g.replicas for n in rep}
            for g in layer_groups(instances)}


def verify_replica_coverage(instances: Sequence[PipelineInstance]) -> bool:
    """Paper §3.2 invariant: every layer has >= 1 owner; recoverability
    needs >= 1 complete set of owners across pipelines."""
    if not instances:
        return False
    return all(len(g.replicas) >= 1 and all(len(r) >= 1 for r in g.replicas)
               for g in layer_groups(instances))


# ----------------------------------------------------------------------
# Wire-format accounting and the shared per-bucket sync cost model
# ----------------------------------------------------------------------
#: codec -> (bytes per element, fixed per-bucket overhead).  The runtime
#: flattens each bucket into ONE contiguous buffer before encoding, so
#: int8 carries exactly one fp32 scale per bucket — not one per leaf.
CODEC_WIRE = {"none": (4, 0), "bf16": (2, 0), "int8": (1, 4)}


def flat_wire_bytes(num_elements: int, codec: str) -> int:
    """Bytes on the wire for one FLATTENED bucket of ``num_elements``
    fp32 gradient elements under ``codec``.  This is the single source
    of truth: runtime/compression.py asserts its encoded output matches,
    and the cost model below prices every leg with it."""
    try:
        per_elem, overhead = CODEC_WIRE[codec]
    except KeyError:
        raise ValueError(f"unknown codec {codec!r}") from None
    return per_elem * int(num_elements) + overhead


@dataclasses.dataclass(frozen=True)
class BucketCostRow:
    """One bucket's slot in the overlapped sync schedule (seconds)."""

    layer_start: int
    layer_end: int
    wire_bytes: int
    comm_s: float       # reduction time of this bucket (hierarchical)
    ready_s: float      # when backward has produced all its gradients
    start_s: float      # when the wire is free for it (deepest-first issue)
    end_s: float
    hierarchical: bool  # True when the peer group spans pods (ICI+DCN legs)


class SyncCostModel:
    """ONE pricing of cross-replica gradient sync, consumed by the
    engine (`iteration_time`), the simulator policy and the benchmarks —
    replacing the old last-bucket-only `_sync_tail_seconds` heuristic.

    Per bucket: the peer groups all-reduce the bucket's wire bytes
    (codec-compressed, one scale per bucket).  A group whose replicas
    sit in one pod rides ICI; a group spanning pods takes the two-level
    path the runtime executes — reduce intra-pod over ICI, all-reduce
    between pod leads over DCN, broadcast back over ICI.  Buckets are
    issued deepest-first and overlap the remaining backward: the tail is
    whatever the last bucket cannot hide (DESIGN.md §10).

    ``topology`` is duck-typed (needs ``pod_of``): core must not import
    runtime at module load, so the engine passes its lazily-built
    runtime.transfer.Topology in.
    """

    def __init__(self, hw: hwlib.HardwareSpec = hwlib.H100,
                 codec: str = "none", topology=None):
        if codec not in CODEC_WIRE:
            raise ValueError(f"unknown codec {codec!r}")
        self.hw = hw
        self.codec = codec
        self.topology = topology

    # -- one bucket -----------------------------------------------------
    def bucket_wire_bytes(self, bucket: SyncBucket) -> int:
        # bucket.nbytes counts bf16 parameter bytes -> element count
        return flat_wire_bytes(bucket.nbytes // 2, self.codec)

    def _group_seconds(self, nodes: Sequence[str], nbytes: float) -> Tuple[float, bool]:
        k = len(nodes)
        if k <= 1:
            return 0.0, False
        if self.topology is None:
            return hwlib.allreduce_time(nbytes, k, hw=self.hw), False
        pods: Dict = {}
        for n in nodes:
            pods.setdefault(self.topology.pod_of(n), []).append(n)
        if len(pods) == 1:
            return hwlib.allreduce_time(nbytes, k, hw=self.hw), False
        # two-level (NCCL-style hierarchical all-reduce): intra-pod
        # reduce-scatter over ICI, cross-pod all-reduce of the per-lead
        # SHARD over DCN, intra-pod all-gather over ICI.  Pods run their
        # local legs concurrently, so ICI legs cost the largest pod;
        # the DCN leg carries the largest shard (smallest pod).
        k_max = max(len(members) for members in pods.values())
        k_min = min(len(members) for members in pods.values())
        rs = hwlib.allgather_time(nbytes, k_max, hw=self.hw)   # (k-1)/k legs
        cross = hwlib.allreduce_time(nbytes / k_min, len(pods),
                                     bandwidth=self.hw.dcn_bandwidth,
                                     hw=self.hw)
        ag = hwlib.allgather_time(nbytes, k_max, hw=self.hw)
        return rs + cross + ag, True

    def bucket_seconds(self, bucket: SyncBucket) -> Tuple[float, bool]:
        """(reduction seconds, crossed-pods?) for one bucket.  Groups
        shard the payload (shard-wise rings run concurrently), so the
        bucket costs its slowest group."""
        wire = self.bucket_wire_bytes(bucket)
        per_group = wire / max(len(bucket.groups), 1)
        worst, hier = 0.0, False
        for g in bucket.groups:
            s, h = self._group_seconds(g, per_group)
            if s > worst:
                worst = s
            hier = hier or h
        return worst, hier

    # -- the overlapped schedule ---------------------------------------
    def schedule(self, plan: Sequence[SyncBucket],
                 bwd_seconds: Sequence[float]) -> List[BucketCostRow]:
        """Deepest-first issue order against the backward pass.

        Backward produces gradients from the deepest layer down; bucket
        [s, e) is ready once backward passed layer s.  Buckets share one
        wire, so bucket i starts at max(ready_i, end_{i-1}) — reduction
        of deep buckets overlaps the backward of shallow layers, and
        only what spills past the end of backward is exposed."""
        L = len(bwd_seconds)
        suffix = [0.0] * (L + 1)        # suffix[s] = time to bwd layers s..L-1
        for l in reversed(range(L)):
            suffix[l] = suffix[l + 1] + float(bwd_seconds[l])
        rows: List[BucketCostRow] = []
        wire_free = 0.0
        for b in plan:
            comm, hier = self.bucket_seconds(b)
            ready = suffix[min(b.layer_start, L)]
            start = max(ready, wire_free)
            wire_free = start + comm
            rows.append(BucketCostRow(
                layer_start=b.layer_start, layer_end=b.layer_end,
                wire_bytes=self.bucket_wire_bytes(b), comm_s=comm,
                ready_s=ready, start_s=start, end_s=wire_free,
                hierarchical=hier))
        return rows

    def tail_seconds(self, plan: Sequence[SyncBucket],
                     bwd_seconds: Sequence[float]) -> float:
        """Sync time NOT hidden behind backward — the only part a step
        actually pays for cross-replica sync (DESIGN.md §5/§10)."""
        rows = self.schedule(plan, bwd_seconds)
        if not rows:
            return 0.0
        total_bwd = sum(float(t) for t in bwd_seconds)
        return max(0.0, rows[-1].end_s - total_bwd)
