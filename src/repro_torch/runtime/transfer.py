"""Recovery data plane: topology-aware state-transfer scheduling (DESIGN.md §9).

The reconfigurator (core/reconfigure.py) emits a layer-granular list of
``CopyTask``s — *what* has to move after a failure.  This module decides
*how* it moves:

  * **source selection** — every task carries the full set of surviving
    replicas that hold the layer; the scheduler picks a source that is
    pod-local to the destination (the ``ici`` link: NVLink on the H100)
    before falling back to a cross-pod replica (``dcn``: the NIC),
    breaking ties by the
    bytes already assigned to each sender (least-loaded);
  * **parallel streams** — tasks sharing a (src, dst) pair coalesce into
    one ordered stream; all streams start together, so recovery time is
    the *makespan over streams under link contention*, not the serial
    sum of bytes the simulator used to charge;
  * **contention** — stream rates come from a progressive-filling model
    against the `utils/hw.py` constants: an ICI stream is capped by one
    ICI link and by its endpoints' NIC aggregate (links x per-link
    bandwidth) shared across that node's active streams; DCN streams
    share each host's single DCN allotment;
  * **chunking** — streams are cut into fixed-size chunks so the runtime
    can interleave copies with the first post-recovery steps (the warm
    program cache means compute is ready before state is, ReCycle's
    observation in arXiv:2405.14009).

Nothing here touches arrays: the plan is pure metadata.  The
heterogeneous runtime (runtime/pipeline.py) executes it against real
layer states; the simulator (sim/policies.py) charges its makespan as
downtime; the benchmark (benchmarks/recovery_latency.py) decomposes it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.reconfigure import CopyTask
from repro_torch.utils.hw import HardwareSpec, H100

ICI = "ici"
DCN = "dcn"


class TransferPlanError(RuntimeError):
    """The scheduled plan violates the data-plane contract (reads a dead
    node, routes inconsistently with pod placement, drops bytes)."""


# ----------------------------------------------------------------------
# Topology
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Topology:
    """Node -> pod placement plus the fabric constants.

    Nodes inside one pod talk over ICI; pods talk over DCN (DESIGN.md
    §5).  Nodes the map has never seen (late joins, hot spares) are
    conservatively placed in their own singleton pod, so every path to
    them is priced as DCN until a replan assigns them properly.
    """

    pods: Mapping[str, int]
    hw: HardwareSpec = H100

    @classmethod
    def regular(cls, nodes: Sequence[str], nodes_per_pod: int = 8,
                hw: HardwareSpec = H100) -> "Topology":
        """Pods of ``nodes_per_pod`` consecutive nodes, in given order —
        mirrors how launch/mesh.py lays pipeline replicas out per pod."""
        per = max(1, nodes_per_pod)
        return cls(pods={n: i // per for i, n in enumerate(nodes)}, hw=hw)

    def pod_of(self, node: str):
        pod = self.pods.get(node)
        return pod if pod is not None else ("solo", node)

    def same_pod(self, a: str, b: str) -> bool:
        return self.pod_of(a) == self.pod_of(b)

    def link_kind(self, src: str, dst: str) -> str:
        return ICI if self.same_pod(src, dst) else DCN

    def link_bandwidth(self, kind: str) -> float:
        return self.hw.ici_bandwidth if kind == ICI else self.hw.dcn_bandwidth

    def nic_capacity(self, node: str) -> float:
        """Aggregate ICI egress/ingress of one node (all links)."""
        return self.hw.ici_bandwidth * self.hw.ici_links_per_chip


# ----------------------------------------------------------------------
# Streams
# ----------------------------------------------------------------------
@dataclasses.dataclass
class TransferStream:
    """All bytes moving src -> dst, sent as one ordered chunked stream."""

    src: str
    dst: str
    link: str                       # ICI | DCN
    tasks: List[CopyTask]

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in self.tasks)

    @property
    def layers(self) -> List[int]:
        return [t.layer for t in self.tasks]

    def chunks(self, chunk_bytes: int) -> List[Tuple[int, int]]:
        """(layer, nbytes) pieces in send order, each <= chunk_bytes.
        Layer boundaries are preserved: a chunk never mixes layers, so
        the receiver can install a layer as soon as its last chunk
        lands (that is what overlap with the first steps needs)."""
        out: List[Tuple[int, int]] = []
        for t in self.tasks:
            n_parts = max(1, math.ceil(t.nbytes / max(chunk_bytes, 1)))
            base, rem = divmod(t.nbytes, n_parts)
            for i in range(n_parts):
                out.append((t.layer, base + (1 if i < rem else 0)))
        return out


@dataclasses.dataclass
class TransferPlan:
    streams: List[TransferStream]
    topology: Topology
    chunk_bytes: int = 64 * 1024 * 1024

    @property
    def total_bytes(self) -> int:
        return sum(s.nbytes for s in self.streams)

    @property
    def pod_local_bytes(self) -> int:
        return sum(s.nbytes for s in self.streams if s.link == ICI)

    def pod_local_fraction(self) -> float:
        total = self.total_bytes
        return self.pod_local_bytes / total if total else 1.0

    def source_of(self, dst: str, layer: int) -> Optional[str]:
        for s in self.streams:
            if s.dst == dst and layer in s.layers:
                return s.src
        return None

    def incoming(self, dst: str) -> List[Tuple[int, str]]:
        """Every (layer, src) this destination receives, in stream then
        task order — what a multi-host worker must actually FETCH over
        the wire for the node it hosts."""
        out: List[Tuple[int, str]] = []
        for s in self.streams:
            if s.dst == dst:
                out.extend((t.layer, s.src) for t in s.tasks)
        return out

    # ------------------------------------------------------------------
    # Timing: progressive filling over shared links
    # ------------------------------------------------------------------
    def _rates(self, active: List[int]) -> Dict[int, float]:
        """Instantaneous per-stream rate with the current active set.

        Each node's NIC aggregate is split evenly over its active
        streams; an ICI stream is additionally capped by one ICI link;
        DCN streams split each endpoint host's DCN allotment.
        """
        topo = self.topology
        at_node: Dict[str, int] = {}
        dcn_at: Dict[str, int] = {}
        for i in active:
            s = self.streams[i]
            at_node[s.src] = at_node.get(s.src, 0) + 1
            at_node[s.dst] = at_node.get(s.dst, 0) + 1
            if s.link == DCN:
                dcn_at[s.src] = dcn_at.get(s.src, 0) + 1
                dcn_at[s.dst] = dcn_at.get(s.dst, 0) + 1
        rates: Dict[int, float] = {}
        for i in active:
            s = self.streams[i]
            rate = min(topo.nic_capacity(s.src) / at_node[s.src],
                       topo.nic_capacity(s.dst) / at_node[s.dst])
            if s.link == ICI:
                rate = min(rate, topo.hw.ici_bandwidth)
            else:
                rate = min(rate,
                           topo.hw.dcn_bandwidth / dcn_at[s.src],
                           topo.hw.dcn_bandwidth / dcn_at[s.dst])
            rates[i] = rate
        return rates

    def finish_times(self) -> List[float]:
        """Per-stream completion time; all streams start at t=0 and
        share links per _rates (streams speed up as peers drain)."""
        remaining = {i: float(s.nbytes) for i, s in enumerate(self.streams)
                     if s.nbytes > 0}
        finish = [0.0] * len(self.streams)
        t = 0.0
        while remaining:
            active = sorted(remaining)
            rates = self._rates(active)
            dt = min(remaining[i] / rates[i] for i in active)
            t += dt
            for i in active:
                remaining[i] -= dt * rates[i]
                if remaining[i] <= 1e-6 * max(self.streams[i].nbytes, 1):
                    finish[i] = t
                    del remaining[i]
        return finish

    def makespan(self) -> float:
        """Recovery transfer time: MAX over parallel streams (the
        acceptance metric), not the serial sum of bytes."""
        times = self.finish_times()
        return max(times) if times else 0.0

    def exposed_seconds(self, overlap_seconds: float = 0.0) -> float:
        """Transfer time not hidden behind post-recovery compute: chunked
        streams overlap with the first steps the warm program cache can
        already run (DESIGN.md §9)."""
        return max(0.0, self.makespan() - max(overlap_seconds, 0.0))

    def serial_seconds(self) -> float:
        """The pre-data-plane accounting (sum of bytes over one link) —
        kept for the benchmark's before/after comparison."""
        return sum(s.nbytes / self.topology.link_bandwidth(s.link)
                   for s in self.streams)

    # ------------------------------------------------------------------
    def validate(self, dead: Iterable[str] = (),
                 expected_bytes: Optional[int] = None) -> None:
        """Raise TransferPlanError unless the plan honours the contract:
        no stream reads a failed node, no stream loops back to its
        source, every route's link matches pod placement, and no bytes
        were dropped relative to the copy plan."""
        dead = set(dead)
        for s in self.streams:
            if s.src in dead:
                raise TransferPlanError(
                    f"stream {s.src}->{s.dst} reads failed node {s.src}")
            if s.src == s.dst:
                raise TransferPlanError(f"self-copy at {s.src}")
            if s.link != self.topology.link_kind(s.src, s.dst):
                raise TransferPlanError(
                    f"stream {s.src}->{s.dst} labelled {s.link} but pods "
                    f"say {self.topology.link_kind(s.src, s.dst)}")
            for t in s.tasks:
                if t.dst_node != s.dst:
                    raise TransferPlanError(
                        f"task for {t.dst_node} routed into stream to {s.dst}")
        if expected_bytes is not None and self.total_bytes != expected_bytes:
            raise TransferPlanError(
                f"plan moves {self.total_bytes} bytes, copy plan asked for "
                f"{expected_bytes}")

    def stats(self) -> Dict[str, float]:
        return {"streams": len(self.streams),
                "bytes": self.total_bytes,
                "pod_local_fraction": self.pod_local_fraction(),
                "seconds": self.makespan(),
                "serial_seconds": self.serial_seconds()}


# ----------------------------------------------------------------------
# Scheduling
# ----------------------------------------------------------------------
def schedule_transfers(copy_plan: Sequence[CopyTask], topology: Topology,
                       dead: Iterable[str] = (),
                       chunk_bytes: int = 64 * 1024 * 1024) -> TransferPlan:
    """Turn the reconfigurator's copy plan into parallel streams.

    For every task the final source is re-chosen among the surviving
    replicas the task carries (``task.sources``; falls back to the
    reconfigurator's pick): pod-local replicas beat cross-pod ones, and
    within a tier the sender with the fewest bytes already assigned
    wins, so no single replica becomes the copy hot-spot.
    """
    dead = set(dead)
    load: Dict[str, int] = {}
    by_pair: Dict[Tuple[str, str], List[CopyTask]] = {}
    for task in copy_plan:
        candidates = [n for n in (task.sources or (task.src_node,))
                      if n not in dead and n != task.dst_node]
        if not candidates:
            raise TransferPlanError(
                f"layer {task.layer}: no surviving source for "
                f"{task.dst_node} (candidates all dead)")
        src = min(candidates, key=lambda n: (
            0 if topology.same_pod(n, task.dst_node) else 1,
            load.get(n, 0), n))
        load[src] = load.get(src, 0) + task.nbytes
        routed = (task if src == task.src_node
                  else dataclasses.replace(task, src_node=src))
        by_pair.setdefault((src, task.dst_node), []).append(routed)
    streams = [TransferStream(src=src, dst=dst,
                              link=topology.link_kind(src, dst),
                              tasks=sorted(tasks, key=lambda t: t.layer))
               for (src, dst), tasks in sorted(by_pair.items())]
    plan = TransferPlan(streams=streams, topology=topology,
                        chunk_bytes=chunk_bytes)
    plan.validate(dead, expected_bytes=sum(t.nbytes for t in copy_plan))
    return plan
