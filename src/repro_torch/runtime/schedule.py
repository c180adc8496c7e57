"""1F1B pipeline schedule (Figure 5): construction + makespan simulation.

``one_f_one_b(S, M)`` produces each stage's op sequence: a warmup of
(S - 1 - s) forwards, then alternating B/F in the steady phase, then a
drain of backwards.  ``simulate_makespan`` runs the dependency-driven
event simulation for arbitrary per-stage F/B times — used (a) to check
the planner's T1+T2+T3 critical-path estimate, (b) by the discrete-event
simulator to time heterogeneous pipelines.

The *adapted* mode (ReCycle, arXiv:2405.14009) re-routes a damaged
pipeline's microbatches to surviving peer data-parallel pipelines:
every pipeline replica holds the full model, so a guest microbatch is
just an extra (F, B) pair filling the host's decoupled-1F1B bubbles.
``adapt_reroute`` picks the hosts, ``adapted_per_stage`` builds the
per-host op sequences over (pipeline, mb) tagged microbatches, and
``adapted_flat_schedule`` serializes them through the same
dependency validator as ``flat_schedule``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

Op = Tuple[str, int]          # ("F"|"B", microbatch index)
# Adapted-mode ops tag each microbatch with its source pipeline so a
# host can interleave native and guest work: ("F"|"B", (src_pipe, mb)).
TaggedOp = Tuple[str, Tuple[int, int]]


class ScheduleError(RuntimeError):
    """The per-stage op sequences deadlocked: no stage's head op has its
    dependencies satisfied.  Raised (never spun on) by flat_schedule."""


def one_f_one_b(num_stages: int, num_microbatches: int) -> List[List[Op]]:
    """Per-stage op sequences implementing 1F1B."""
    S, M = num_stages, num_microbatches
    assert M >= 1
    out: List[List[Op]] = []
    for s in range(S):
        warmup = min(S - 1 - s, M)
        ops: List[Op] = [("F", i) for i in range(warmup)]
        f_next, b_next = warmup, 0
        while b_next < M:
            if f_next < M:
                ops.append(("F", f_next)); f_next += 1
            ops.append(("B", b_next)); b_next += 1
        out.append(ops)
    return out


def flat_schedule(num_stages: int, num_microbatches: int,
                  per_stage: Optional[List[List[Op]]] = None
                  ) -> List[Tuple[int, str, int]]:
    """Dependency-respecting serialization: (stage, op, mb) triples in an
    order a single controller can execute.

    ``per_stage`` overrides the generated 1F1B sequences (used by tests
    and by callers with custom schedules).  A malformed sequence — an op
    whose dependency can never be produced — raises ``ScheduleError``
    naming every stuck (stage, op, mb) head instead of spinning: the
    ``while len(out) < total`` loop would otherwise never terminate once
    ``progressed`` stays False.
    """
    if per_stage is None:
        per_stage = one_f_one_b(num_stages, num_microbatches)
    else:
        num_stages = len(per_stage)     # the sequences define the stages
    ptr = [0] * num_stages
    done_f = [set() for _ in range(num_stages)]
    done_b = [set() for _ in range(num_stages)]
    out: List[Tuple[int, str, int]] = []
    total = sum(len(ops) for ops in per_stage)
    while len(out) < total:
        progressed = False
        # favor deeper stages first (drain backwards early, 1F1B spirit)
        for s in reversed(range(num_stages)):
            if ptr[s] >= len(per_stage[s]):
                continue
            op, mb = per_stage[s][ptr[s]]
            ready = ((op == "F" and (s == 0 or mb in done_f[s - 1])) or
                     (op == "B" and (s == num_stages - 1 or mb in done_b[s + 1])
                      and mb in done_f[s]))
            if ready:
                out.append((s, op, mb))
                (done_f if op == "F" else done_b)[s].add(mb)
                ptr[s] += 1
                progressed = True
        if not progressed:
            stuck = [(s, *per_stage[s][ptr[s]]) for s in range(num_stages)
                     if ptr[s] < len(per_stage[s])]
            raise ScheduleError(
                f"schedule cannot progress after {len(out)}/{total} ops; "
                f"stuck head ops (stage, op, mb): {stuck}")
    return out


def adapt_reroute(mb_counts: Sequence[int],
                  dead_pipelines: Set[int]) -> Dict[int, List[Tuple[int, int]]]:
    """Assign every microbatch of each dead pipeline to a surviving host.

    Returns {host_pipeline: [(src_pipeline, mb), ...]} covering exactly
    the dead pipelines' microbatches.  Assignment is deterministic and
    balanced: each guest microbatch goes to the survivor with the least
    total load (native + already-assigned guests), ties broken by
    pipeline index, so replayed failures re-route identically.
    """
    for p in dead_pipelines:
        if not 0 <= p < len(mb_counts):
            raise ScheduleError(f"dead pipeline {p} out of range "
                                f"(have {len(mb_counts)} pipelines)")
    survivors = [p for p in range(len(mb_counts)) if p not in dead_pipelines]
    if not survivors:
        raise ScheduleError("adaptation infeasible: no surviving pipeline "
                            f"to host re-routed microbatches (dead="
                            f"{sorted(dead_pipelines)})")
    load = {p: mb_counts[p] for p in survivors}
    routes: Dict[int, List[Tuple[int, int]]] = {p: [] for p in survivors}
    for src in sorted(dead_pipelines):
        for mb in range(mb_counts[src]):
            host = min(survivors, key=lambda p: (load[p], p))
            routes[host].append((src, mb))
            load[host] += 1
    return {p: r for p, r in routes.items() if r}


def adapted_per_stage(num_stages: int, mb_counts: Sequence[int],
                      dead_pipelines: Set[int]
                      ) -> Dict[int, List[List[TaggedOp]]]:
    """Per-stage op sequences for every surviving pipeline after
    re-routing dead pipelines' microbatches (decoupled 1F1B
    bubble-filling: guests are appended to the host's microbatch stream,
    so they fill the drain-phase bubbles of the host's own schedule).

    Returns {host_pipeline: per_stage ops} where each op is
    ("F"|"B", (src_pipeline, mb)).  Native microbatches keep their own
    pipeline tag; a host with G guests runs one_f_one_b(S, M_host + G)
    with the tail G slots relabeled to the guests in route order.
    """
    routes = adapt_reroute(mb_counts, dead_pipelines)
    out: Dict[int, List[List[TaggedOp]]] = {}
    for host in range(len(mb_counts)):
        if host in dead_pipelines:
            continue
        guests = routes.get(host, [])
        native = mb_counts[host]
        # slot i < native → native mb i; slot native+j → guest j
        tags = ([(host, i) for i in range(native)] + list(guests))
        base = one_f_one_b(num_stages, native + len(guests))
        out[host] = [[(op, tags[mb]) for op, mb in ops] for ops in base]
    return out


def adapted_flat_schedule(num_stages: int, mb_counts: Sequence[int],
                          dead_pipelines: Set[int]
                          ) -> Dict[int, List[Tuple[int, str, Tuple[int, int]]]]:
    """Serialized adapted schedule per surviving pipeline:
    {host: [(stage, op, (src_pipeline, mb)), ...]}.

    Each host is serialized through ``flat_schedule``'s dependency
    validator (guest microbatches obey the same F-before-B,
    upstream-before-downstream rules as native ones), so a malformed
    adaptation raises ``ScheduleError`` instead of hanging.
    """
    per_host = adapted_per_stage(num_stages, mb_counts, dead_pipelines)
    out: Dict[int, List[Tuple[int, str, Tuple[int, int]]]] = {}
    for host, tagged in per_host.items():
        # flat_schedule validates over dense int mb ids; map tags to ids
        # and back so host-level dependency checking is reused verbatim.
        ids: Dict[Tuple[int, int], int] = {}
        for ops in tagged:
            for _, tag in ops:
                ids.setdefault(tag, len(ids))
        dense = [[(op, ids[tag]) for op, tag in ops] for ops in tagged]
        rev = {i: tag for tag, i in ids.items()}
        flat = flat_schedule(num_stages, len(ids), per_stage=dense)
        out[host] = [(s, op, rev[i]) for s, op, i in flat]
    return out


def simulate_makespan(stage_fwd: Sequence[float], stage_bwd: Sequence[float],
                      num_microbatches: int,
                      hop_time: float = 0.0) -> float:
    """Event-driven makespan of 1F1B with given per-stage F/B times."""
    S = len(stage_fwd)
    per_stage = one_f_one_b(S, num_microbatches)
    ptr = [0] * S
    free_at = [0.0] * S
    f_done: Dict[Tuple[int, int], float] = {}
    b_done: Dict[Tuple[int, int], float] = {}
    finish = 0.0
    remaining = sum(len(o) for o in per_stage)
    while remaining:
        progressed = False
        for s in range(S):
            while ptr[s] < len(per_stage[s]):
                op, mb = per_stage[s][ptr[s]]
                if op == "F":
                    dep = 0.0 if s == 0 else f_done.get((s - 1, mb))
                    if dep is None:
                        break
                    start = max(free_at[s], dep + (hop_time if s else 0.0))
                    end = start + stage_fwd[s]
                    f_done[(s, mb)] = end
                else:
                    if (s, mb) not in f_done:
                        break
                    dep = 0.0 if s == S - 1 else b_done.get((s + 1, mb))
                    if dep is None:
                        break
                    start = max(free_at[s], f_done[(s, mb)],
                                dep + (hop_time if s != S - 1 else 0.0))
                    end = start + stage_bwd[s]
                    b_done[(s, mb)] = end
                free_at[s] = end
                finish = max(finish, end)
                ptr[s] += 1
                remaining -= 1
                progressed = True
        if not progressed:
            raise RuntimeError("deadlock in makespan simulation")
    return finish
