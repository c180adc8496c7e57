"""Node change monitor (paper §3.3/§6.2).

The original launches a CPU agent per node with a TCP connection to a
central coordinator; socket disconnects signal failure instantly (NCCL
alone would hang until timeout).  Here the same role is played by an
event bus: real deployments adapt ``ClusterMembership`` to the
cluster coordination service's health callbacks; tests and the simulator inject
events deterministically.  Preemption *warnings* (spot instances' grace
period) are first-class events, used by the engine to drain the current
iteration before the node disappears.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True, order=True)
class ClusterEvent:
    time: float
    seq: int
    kind: str = dataclasses.field(compare=False)  # fail | join | warn
    nodes: Tuple[str, ...] = dataclasses.field(compare=False)


class NodeChangeMonitor:
    """Deterministic event bus: sources push, the engine subscribes."""

    FAIL, JOIN, WARN = "fail", "join", "warn"

    def __init__(self):
        self._queue: List[ClusterEvent] = []
        self._seq = itertools.count()
        self._subscribers: List[Callable[[ClusterEvent], None]] = []

    def subscribe(self, fn: Callable[[ClusterEvent], None]) -> None:
        self._subscribers.append(fn)

    def inject(self, kind: str, nodes: Sequence[str], time: float = 0.0) -> None:
        ev = ClusterEvent(time=time, seq=next(self._seq), kind=kind,
                          nodes=tuple(nodes))
        heapq.heappush(self._queue, ev)

    def pending(self) -> bool:
        return bool(self._queue)

    def next_event_time(self) -> Optional[float]:
        return self._queue[0].time if self._queue else None

    def poll(self, now: float) -> List[ClusterEvent]:
        """Pop and dispatch every event with time <= now."""
        fired: List[ClusterEvent] = []
        while self._queue and self._queue[0].time <= now:
            ev = heapq.heappop(self._queue)
            fired.append(ev)
            for fn in self._subscribers:
                fn(ev)
        return fired


# ----------------------------------------------------------------------
# Heartbeat-based failure detection (the multi-process monitor source)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HeartbeatConfig:
    """Timing of the out-of-band liveness channel (DESIGN.md §15).

    A member is ALIVE while its silence stays within ``timeout``,
    SUSPECT once the silence exceeds it, and DEAD once the silence
    exceeds ``timeout * (1 + backoff)`` — the backoff window absorbs GC
    pauses and long program builds without declaring a healthy worker
    dead.  Senders beat every ``interval`` (<< timeout)."""

    interval: float = 0.5
    timeout: float = 3.0
    backoff: float = 1.0

    @property
    def dead_after(self) -> float:
        return self.timeout * (1.0 + max(self.backoff, 0.0))


class HeartbeatTracker:
    """alive -> suspect -> dead state machine over member heartbeats.

    Deterministically testable: ``now_fn`` injects the clock.  DEAD is
    sticky (fencing) — beats from a member already declared dead are
    ignored, so a zombie process can never resurrect itself into a plan
    that already reconfigured around it; it must re-JOIN instead.  The
    coordinator additionally calls ``mark_dead`` on a socket disconnect
    (the paper's instant-failure signal) without waiting for the
    timeout."""

    ALIVE, SUSPECT, DEAD = "alive", "suspect", "dead"

    def __init__(self, config: Optional[HeartbeatConfig] = None,
                 now_fn: Callable[[], float] = time.monotonic):
        self.config = config or HeartbeatConfig()
        self._now = now_fn
        self._last: Dict[str, float] = {}
        self._dead: Dict[str, float] = {}      # member -> time of death
        self._reported: set = set()

    def register(self, member: str, now: Optional[float] = None) -> None:
        self._last[member] = self._now() if now is None else now

    def beat(self, member: str, now: Optional[float] = None) -> bool:
        """Record a heartbeat; returns False iff the member is fenced
        (already declared dead) and the beat was discarded."""
        if member in self._dead:
            return False
        self._last[member] = self._now() if now is None else now
        return True

    def mark_dead(self, member: str, now: Optional[float] = None) -> None:
        if member in self._last and member not in self._dead:
            self._dead[member] = self._now() if now is None else now

    def status(self, member: str, now: Optional[float] = None) -> str:
        if member in self._dead:
            return self.DEAD
        if member not in self._last:
            raise KeyError(f"unknown heartbeat member {member!r}")
        now = self._now() if now is None else now
        silence = now - self._last[member]
        if silence <= self.config.timeout:
            return self.ALIVE
        if silence <= self.config.dead_after:
            return self.SUSPECT
        return self.DEAD

    def poll(self, now: Optional[float] = None) -> List[str]:
        """Advance the state machine; returns members NEWLY dead since
        the last poll (each member is reported exactly once)."""
        now = self._now() if now is None else now
        fresh: List[str] = []
        for m in list(self._last):
            if self.status(m, now) == self.DEAD:
                self._dead.setdefault(m, now)
                if m not in self._reported:
                    self._reported.add(m)
                    fresh.append(m)
        return fresh

    def members(self) -> List[str]:
        return sorted(self._last)

    def dead(self) -> List[str]:
        return sorted(self._dead)

    def alive(self, now: Optional[float] = None) -> List[str]:
        now = self._now() if now is None else now
        return [m for m in sorted(self._last)
                if self.status(m, now) != self.DEAD]
