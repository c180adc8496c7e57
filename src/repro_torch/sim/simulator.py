"""Discrete-event cluster simulator (paper §7 evaluation harness); a copy
of ``repro/sim/simulator.py``, framework-free.

Replays a trace of failure/join/warning events against a Policy and
accounts wall-clock into the paper's Figure-11 categories:

    compute   — productive iteration time (committed samples)
    fallback  — partial/uncommitted work lost to a failure
    downtime  — reconfiguration or restart (policy-reported)
    ckpt      — synchronous checkpoint saves

Committed-sample semantics implement each system's rollback behavior:
Oobleck/Bamboo lose at most the in-flight iteration; Varuna rolls back
to the last checkpoint.

``warn`` events model spot-instance termination notices (DESIGN.md §7).
A drain-capable policy (``supports_draining``) finishes the in-flight
iteration and then removes the warned nodes proactively — paying the
reconfiguration cost but losing no work.  The later ``fail`` event for
nodes already drained out is a no-op.  If the grace period is shorter
than one iteration the ``fail`` interrupts as usual, so the benefit of
warnings degrades gracefully to nothing.  Policies without draining
support (Varuna/Bamboo) ignore warnings entirely.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.sim.policies import Policy, PolicyStopped


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    time: float
    kind: str                  # fail | join | warn
    nodes: Tuple[str, ...]


@dataclasses.dataclass
class SimResult:
    policy: str
    elapsed: float
    committed_samples: float
    breakdown: Dict[str, float]
    stopped_reason: Optional[str] = None
    events_handled: int = 0
    drained_nodes: int = 0     # nodes removed proactively after a warning

    @property
    def throughput(self) -> float:
        return self.committed_samples / max(self.elapsed, 1e-9)

    def effective_fraction(self) -> float:
        total = sum(self.breakdown.values())
        return self.breakdown.get("compute", 0.0) / max(total, 1e-9)


def run_sim(policy: Policy, events: Sequence[TraceEvent], horizon: float,
            global_batch: int, min_nodes: Optional[int] = None) -> SimResult:
    breakdown = {"compute": 0.0, "fallback": 0.0, "downtime": 0.0,
                 "ckpt": 0.0}
    if not policy.runnable():
        return SimResult(policy.name, horizon, 0.0, breakdown,
                         stopped_reason="OOM")

    t = 0.0
    committed = 0.0
    pending_since_ckpt = 0.0      # samples not yet durable (Varuna rollback)
    iteration = 0
    evq: List[TraceEvent] = sorted(events, key=lambda e: e.time)
    ei = 0
    stopped = None
    warned: Set[str] = set()      # termination notices not yet acted upon
    removed: Set[str] = set()     # drained out before their fail arrived
    drained_total = 0

    while t < horizon:
        if min_nodes is not None and policy.num_nodes() <= min_nodes:
            break
        try:
            it = policy.iteration_time()
        except PolicyStopped as e:
            stopped = str(e)
            break
        # Consume events landing inside this iteration.  Warnings and
        # already-drained failures don't interrupt; the first real
        # failure/join does.
        interrupting: Optional[TraceEvent] = None
        dead: Set[str] = set()
        while ei < len(evq) and evq[ei].time < t + it and evq[ei].time < horizon:
            ev = evq[ei]
            if ev.kind == "warn":
                ei += 1
                warned.update(ev.nodes)
                policy.on_warning(list(ev.nodes))
                continue
            if ev.kind == "fail":
                dead = set(ev.nodes) - removed
                if not dead:
                    ei += 1       # everyone already drained out: no-op
                    continue
            ei += 1
            interrupting = ev
            break
        if interrupting is not None:
            ev = interrupting
            # partial iteration wasted
            breakdown["fallback"] += max(ev.time - t, 0.0)
            t = max(ev.time, t)
            try:
                if ev.kind == "fail":
                    warned -= set(ev.nodes)
                    down = policy.on_failure(dead)
                    # rollback: lose samples since the last durable point
                    lag = policy.commit_lag_iterations()
                    if lag > 1:
                        lost = min(pending_since_ckpt,
                                   (lag - 1) * global_batch)
                        committed -= lost
                        pending_since_ckpt = 0.0
                else:
                    removed -= set(ev.nodes)
                    warned -= set(ev.nodes)
                    down = policy.on_join(list(ev.nodes))
            except PolicyStopped as e:
                stopped = str(e)
                break
            breakdown["downtime"] += down
            t += down
            continue
        # clean iteration
        t += it
        breakdown["compute"] += it
        committed += global_batch
        pending_since_ckpt += global_batch
        iteration += 1
        extra = policy.post_iteration(iteration)
        if extra:
            breakdown["ckpt"] += extra
            t += extra
            pending_since_ckpt = 0.0      # checkpoint makes progress durable
        # drain: act on termination notices at the iteration boundary —
        # the in-flight work is committed, so removal costs only downtime
        if warned and policy.supports_draining:
            to_drain = warned - removed
            warned = set()
            if to_drain:
                try:
                    down = policy.on_drain(set(to_drain))
                except PolicyStopped as e:
                    stopped = str(e)
                    break
                breakdown["downtime"] += down
                t += down
                removed |= to_drain
                drained_total += len(to_drain)
    elapsed = min(t, horizon) if t > 0 else horizon
    return SimResult(policy.name, elapsed, max(committed, 0.0), breakdown,
                     stopped_reason=stopped, events_handled=ei,
                     drained_nodes=drained_total)
