"""Failure/availability traces (paper §7.2 controlled + §7.3 spot, plus
the scenario generators Bamboo/ReCycle evaluate under — DESIGN.md §7);
a copy of ``repro/sim/traces.py``, framework-free.

* ``controlled_failures`` — one failure every ``interval`` seconds,
  monotonically removing nodes (no recovery), exactly the §7.2 protocol
  ("monotonically reduce the number of available nodes ... until less
  than half the nodes remain").
* ``spot_trace`` — preemption/recovery events with exponential
  inter-arrival times calibrated to the paper's EC2 (7.7 min) and GCP
  (10.3 min) preemption rates; node count fluctuates in [lo, hi].
* ``rack_failure_bursts`` — correlated failures: a whole rack (power
  domain / ToR switch) dies at once, emitting one multi-node fail event;
  optionally the rack returns after ``repair_time``.  This is the
  scenario that stresses the reconfigurator's borrow/merge escalation,
  since several pipelines lose nodes simultaneously.
* ``spot_preemption_wave`` — spot-market capacity reclaims arrive in
  waves that take a fraction of the cluster together, each preceded by a
  ``warn`` event ``grace`` seconds ahead (EC2's 2-minute notice).  A
  drain-capable policy finishes the in-flight iteration and removes the
  nodes proactively, losing no work.
* ``scale_cycle`` — deterministic gradual scale-down then scale-up
  between ``lo`` and ``hi`` nodes (elastic quota / batch-job churn),
  optionally with warnings before each planned removal.

All generators are deterministic for a fixed seed and return events
sorted by time.
"""
from __future__ import annotations

import heapq
import random
from typing import List, Optional, Sequence, Tuple

from repro_torch.sim.simulator import TraceEvent


def controlled_failures(nodes: List[str], interval: float,
                        stop_at: int) -> List[TraceEvent]:
    """Kill one node every ``interval`` seconds until ``stop_at`` remain."""
    out: List[TraceEvent] = []
    t = interval
    alive = list(nodes)
    while len(alive) > stop_at:
        victim = alive.pop()          # deterministic: highest index first
        out.append(TraceEvent(time=t, kind="fail", nodes=(victim,)))
        t += interval
    return out


def spot_trace(nodes: List[str], horizon: float, mean_preempt: float,
               mean_recover: float, seed: int = 0,
               min_alive: int = 4) -> List[TraceEvent]:
    """Spot-instance availability: exponential preemptions + recoveries."""
    rng = random.Random(seed)
    alive = set(nodes)
    gone: List[str] = []
    out: List[TraceEvent] = []
    t = 0.0
    while True:
        t += rng.expovariate(1.0 / mean_preempt)
        if t >= horizon:
            break
        # coin flip between preemption and (if any gone) recovery, biased
        # by how many nodes are currently out
        recover = gone and (rng.random() < len(gone) / (len(gone) + 4))
        if recover:
            k = min(len(gone), 1 + int(rng.random() * 2))
            back = [gone.pop() for _ in range(k)]
            alive |= set(back)
            out.append(TraceEvent(t, "join", tuple(back)))
        else:
            if len(alive) <= min_alive:
                continue
            victim = rng.choice(sorted(alive))
            alive.remove(victim)
            gone.append(victim)
            out.append(TraceEvent(t, "fail", (victim,)))
    return out


def rack_failure_bursts(nodes: Sequence[str], rack_size: int, horizon: float,
                        mean_interval: float, seed: int = 0,
                        min_alive: int = 4,
                        repair_time: Optional[float] = None
                        ) -> List[TraceEvent]:
    """Correlated rack failures: every ~``mean_interval`` seconds one rack
    (a contiguous ``rack_size`` slice of ``nodes``) fails atomically.

    The burst is clipped so the cluster never drops below ``min_alive``
    alive nodes.  With ``repair_time`` set, the rack's nodes rejoin that
    many seconds after the failure (power restored / instances replaced).
    """
    if rack_size < 1:
        raise ValueError(f"rack_size must be >= 1, got {rack_size}")
    rng = random.Random(seed)
    racks = [list(nodes[i:i + rack_size])
             for i in range(0, len(nodes), rack_size)]
    alive = set(nodes)
    repairs: List[Tuple[float, Tuple[str, ...]]] = []   # scheduled rejoins
    out: List[TraceEvent] = []
    t = 0.0
    while True:
        t += rng.expovariate(1.0 / mean_interval)
        if t >= horizon:
            break
        # nodes only count as alive again once their repair completes —
        # a rack cannot fail while it is still down
        while repairs and repairs[0][0] <= t:
            alive |= set(heapq.heappop(repairs)[1])
        candidates = [r for r in racks if any(n in alive for n in r)]
        if not candidates:
            break
        rack = candidates[rng.randrange(len(candidates))]
        victims = [n for n in rack if n in alive]
        spare = len(alive) - min_alive
        if spare <= 0:
            continue
        victims = victims[:spare]        # clip: keep min_alive running
        alive -= set(victims)
        out.append(TraceEvent(t, "fail", tuple(victims)))
        if repair_time is not None and t + repair_time < horizon:
            out.append(TraceEvent(t + repair_time, "join", tuple(victims)))
            heapq.heappush(repairs, (t + repair_time, tuple(victims)))
    out.sort(key=lambda e: e.time)
    return out


def spot_preemption_wave(nodes: Sequence[str], horizon: float,
                         mean_wave: float, wave_frac: float, grace: float,
                         seed: int = 0, min_alive: int = 4,
                         mean_recover: Optional[float] = None
                         ) -> List[TraceEvent]:
    """Spot preemption waves with advance warning.

    Waves arrive with exponential inter-arrival time ``mean_wave``; each
    reclaims ``wave_frac`` of the currently-alive nodes (at least one,
    never dropping below ``min_alive``).  A ``warn`` event for the wave's
    victims fires ``grace`` seconds before the ``fail`` event — the spot
    market's termination notice.  With ``mean_recover`` set, capacity
    returns: the wave's nodes rejoin after an exponential delay.
    """
    if not 0.0 < wave_frac <= 1.0:
        raise ValueError(f"wave_frac must be in (0, 1], got {wave_frac}")
    rng = random.Random(seed)
    alive = set(nodes)
    recoveries: List[Tuple[float, Tuple[str, ...]]] = []  # scheduled rejoins
    out: List[TraceEvent] = []
    t = 0.0
    while True:
        t += rng.expovariate(1.0 / mean_wave)
        if t + grace >= horizon:
            break
        # capacity is back only once its join fires — a wave must never
        # warn/fail nodes that are still preempted
        while recoveries and recoveries[0][0] <= t:
            alive |= set(heapq.heappop(recoveries)[1])
        spare = len(alive) - min_alive
        if spare <= 0:
            continue
        k = min(spare, max(1, int(wave_frac * len(alive))))
        victims = rng.sample(sorted(alive), k)
        alive -= set(victims)
        out.append(TraceEvent(t, "warn", tuple(victims)))
        out.append(TraceEvent(t + grace, "fail", tuple(victims)))
        if mean_recover is not None:
            back = t + grace + rng.expovariate(1.0 / mean_recover)
            if back < horizon:
                out.append(TraceEvent(back, "join", tuple(victims)))
                heapq.heappush(recoveries, (back, tuple(victims)))
    out.sort(key=lambda e: e.time)
    return out


def scale_cycle(nodes: Sequence[str], horizon: float, period: float,
                step: int, lo: int, hi: Optional[int] = None,
                grace: float = 0.0) -> List[TraceEvent]:
    """Deterministic gradual scale-down/scale-up cycle.

    Starting from the full node list, remove ``step`` nodes every
    ``period`` seconds until ``lo`` remain, then add them back ``step``
    at a time until ``hi`` (default: all), and repeat until ``horizon``.
    With ``grace`` > 0 every planned removal is announced by a ``warn``
    event ``grace`` seconds earlier, modelling an orderly elastic
    scheduler that lets the job drain first.
    """
    hi = len(nodes) if hi is None else min(hi, len(nodes))
    if not 0 < lo <= hi:
        raise ValueError(f"need 0 < lo <= hi, got lo={lo} hi={hi}")
    if step < 1:
        raise ValueError(f"step must be >= 1, got {step}")
    alive = list(nodes)
    parked: List[str] = []
    joined_at = {n: 0.0 for n in nodes}  # last time each node was added
    out: List[TraceEvent] = []
    shrinking = True
    t = period
    while t < horizon:
        acted = False
        for _ in range(2):               # at most one phase flip per tick
            if shrinking:
                k = min(step, len(alive) - lo)
                if k <= 0:
                    shrinking = False
                    continue
                victims = alive[-k:]
                del alive[-k:]
                parked.extend(victims)
                # a warning can only be issued while the node is a member:
                # if grace reaches back past the node's own join (or t=0),
                # there is no valid warn instant — skip the warning
                warn_t = t - grace
                if grace > 0.0 and warn_t > 0.0 and \
                        warn_t > max(joined_at[v] for v in victims):
                    out.append(TraceEvent(warn_t, "warn", tuple(victims)))
                out.append(TraceEvent(t, "fail", tuple(victims)))
            else:
                k = min(step, hi - len(alive), len(parked))
                if k <= 0:
                    shrinking = True
                    continue
                back = [parked.pop() for _ in range(k)]
                alive.extend(back)
                for n in back:
                    joined_at[n] = t
                out.append(TraceEvent(t, "join", tuple(back)))
            acted = True
            break
        if not acted:
            break                        # lo == hi: nothing to cycle
        t += period
    out.sort(key=lambda e: e.time)
    return out
