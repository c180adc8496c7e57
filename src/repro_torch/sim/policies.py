"""Fault-tolerance policies for the discrete-event simulator (§7), as in
``repro/sim/policies.py``, on the port's ``core/`` and ``utils/hw.py``.

Three policies reproduce the paper's comparison:

  * ``OobleckPolicy`` — wraps the REAL core engine (templates, planner,
    reconfigurator); downtime on failure = replan + the state-copy
    MAKESPAN of the scheduled transfer streams (runtime/transfer.py:
    max over parallel streams under ICI/DCN contention, not a serial
    sum of bytes) + a regroup barrier; loses at most the in-flight
    iteration.
  * ``VarunaPolicy``  — checkpoint + full-restart + job morphing [1]:
    best homogeneous (pp x dp) grid over remaining nodes (leftover nodes
    idle), synchronous checkpoint every k iterations, failure rolls back
    to the last checkpoint and pays restart (init + checkpoint load).
  * ``BambooPolicy``  — redundant computation [48]: fixed RC overhead on
    every iteration, 2x model-state memory (and no activation
    checkpointing — that conflicts with RC, paper footnote 2), fast
    recovery unless two adjacent nodes fail, OOM for larger models.

All three share ONE analytic cost model (core/cost_model.py + the real
pipeline planner), so differences come from the fault-tolerance designs,
not from inconsistent modeling — mirroring how the paper runs all three
on the same cluster.  Hardware numbers come from the profile's
``HardwareSpec`` (the port's default is the H100); the restart and
redundancy constants below are the paper's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Set

from repro_torch.core import cost_model as cm
from repro_torch.core.adapt import AdaptationError
from repro_torch.core.engine import EngineConfig, OobleckEngine
from repro_torch.core.monitor import NodeChangeMonitor
from repro_torch.core.planner import PipelinePlanner, estimate_iteration_time
from repro_torch.core.reconfigure import InsufficientReplicasError
from repro_torch.core.templates import PlanningError
from repro_torch.runtime.executor import Executor, template_signature
from repro_torch.utils import hw as hwlib


class PolicyStopped(RuntimeError):
    pass


@dataclasses.dataclass
class PolicyStats:
    reconfigurations: int = 0
    restarts: int = 0
    oom: bool = False
    adaptations: int = 0
    spare_promotions: int = 0


class Policy:
    name: str = "base"
    #: whether the policy can act on preemption warnings by draining the
    #: in-flight iteration and removing the node proactively (paper §3.3:
    #: Oobleck treats the spot grace period as a first-class event; the
    #: checkpoint/redundancy baselines have no equivalent mechanism)
    supports_draining: bool = False

    def runnable(self) -> bool:
        return True

    def iteration_time(self) -> float:
        raise NotImplementedError

    def post_iteration(self, iteration: int) -> float:
        """Extra seconds after an iteration (e.g. checkpoint save)."""
        return 0.0

    def on_warning(self, nodes: List[str]) -> None:
        """Advance notice that ``nodes`` will be preempted.  No cost."""

    def on_drain(self, nodes: Set[str]) -> float:
        """Proactive removal of warned nodes at an iteration boundary.
        Defaults to the failure path; drain-aware policies override to
        record that no work was lost."""
        return self.on_failure(nodes)

    def commit_lag_iterations(self) -> int:
        """How many recent iterations are lost on failure (fallback)."""
        return 1

    def on_failure(self, dead: Set[str]) -> float:
        raise NotImplementedError

    def on_join(self, nodes: List[str]) -> float:
        raise NotImplementedError

    def num_nodes(self) -> int:
        raise NotImplementedError


# ----------------------------------------------------------------------
class OobleckPolicy(Policy, Executor):
    """Wraps the REAL core engine — and implements the same Executor
    interface (runtime/executor.py) as the port's runtimes, so the
    engine is runtime-agnostic by construction: the simulator is just
    another executor whose step() reports seconds instead of spending
    them.  The iteration time is kept per (reconfiguration epoch, batch
    plan): the engine recomputes its sync tail on every call, and the
    plan changes only with one of the two."""

    name = "oobleck"
    supports_draining = True

    def __init__(self, profile: cm.ModelProfile, nodes: List[str],
                 f: int, global_batch: int, microbatch: int,
                 n0: Optional[int] = None, max_stages: Optional[int] = None,
                 topology=None, nodes_per_pod: int = 8,
                 codec: str = "none", recovery_policy: str = "replan"):
        self.profile = profile
        self.stats = PolicyStats()
        self.sim_step = 0
        #: recovery-latency decomposition of the last failure/join
        #: (replan / transfer / compile / barrier seconds; adaptations
        #: add a ``reroute`` exposure leg instead of transfer)
        self.last_breakdown: Optional[Dict[str, float]] = None
        #: audit log of per-event policy choices: (sim_step, chosen,
        #: predicted downtimes per feasible policy)
        self.decisions: List[Dict] = []
        n0 = n0 or profile.min_nodes(1)
        self.engine = OobleckEngine(
            profile, nodes,
            EngineConfig(fault_tolerance=f, global_batch=global_batch,
                         microbatch=microbatch, gpus_per_node=1,
                         n0_override=n0, max_stages=max_stages,
                         nodes_per_pod=nodes_per_pod, codec=codec,
                         recovery_policy=recovery_policy),
            topology=topology)
        self.engine.attach_executor(self)
        self._iter_cache: Optional[tuple] = None     # (key, seconds)

    def sync_tail_seconds(self) -> float:
        """Exposed cross-replica sync time per simulated iteration —
        DELEGATED to the engine's shared per-bucket overlap model
        (core/sync.py SyncCostModel), so simulator and runtime cost
        accounting are one implementation by construction.  Tests pin
        this number against an independently-constructed SyncCostModel
        to catch wiring drift."""
        return self.engine._sync_tail_seconds()

    # Executor interface (simulated time) ------------------------------
    def bind(self) -> None:
        """Nothing to compile: the simulator's 'programs' ARE the
        templates' analytic cost entries, precomputed at planning."""

    def step(self, batches=None) -> Dict:
        """One simulated iteration: seconds charged, samples committed."""
        self.sim_step += 1
        return {"sim_seconds": self.iteration_time(),
                "samples": self.engine.config.global_batch,
                "num_pipelines": len(self.engine.instances)}

    def recover(self, dead: Set[str], drained: bool = False) -> Dict:
        seconds = (self.on_drain(set(dead)) if drained
                   else self.on_failure(set(dead)))
        return {"downtime_seconds": seconds,
                "breakdown": self.last_breakdown,
                "num_pipelines": len(self.engine.instances)}

    def join(self, nodes: List[str]) -> Dict:
        return {"downtime_seconds": self.on_join(list(nodes)),
                "num_pipelines": len(self.engine.instances)}

    def snapshot(self, data_state: Optional[Dict] = None,
                 rng_seed: int = 0) -> Dict:
        """Planning-state snapshot (there are no arrays to save)."""
        return {"step": self.sim_step,
                "templates": {n: template_signature(t)
                              for n, t in self.engine.templates.items()},
                "instances": [list(i.nodes) for i in self.engine.instances],
                "num_microbatches": list(self.engine.batch.num_microbatches),
                "data_state": data_state or {}, "rng_seed": rng_seed}

    def iteration_time(self) -> float:
        key = (self.engine.epoch, self.engine.batch)
        if self._iter_cache is None or self._iter_cache[0] != key:
            self._iter_cache = (key, self.engine.iteration_time())
        return self._iter_cache[1]

    def on_warning(self, nodes: List[str]) -> None:
        # drive the real engine event path: WARN sets the drain flag so a
        # runtime would finish the in-flight iteration before vacating
        self.engine.monitor.inject(NodeChangeMonitor.WARN, nodes)
        self.engine.monitor.poll(now=0.0)

    def on_failure(self, dead: Set[str]) -> float:
        return self._remove(dead, drained=False)

    def on_drain(self, nodes: Set[str]) -> float:
        return self._remove(nodes, drained=True)

    def _remove(self, dead: Set[str], drained: bool) -> float:
        active = set(self.engine.nodes)
        dead = dead & (active | set(self.engine.spare_nodes))
        if not dead:                        # e.g. drained nodes already gone
            self.last_breakdown = None      # no recovery happened
            return 0.0
        if not (dead & active):
            self.last_breakdown = None
            # only idle spares died: prune them so they are never folded
            # back into a pipeline, but no reconfiguration happens
            self.engine.handle_failure(dead, drained=drained)
            return 0.0
        policy = getattr(self.engine.config, "recovery_policy", "replan")
        predictions = None
        if policy == "auto":
            sel = self.engine.select_recovery_policy(dead)
            policy, predictions = sel["policy"], sel["predictions"]
        if policy == "adapt":
            try:
                # exposure is priced against the replan alternative
                ref_iter = self.engine.adaptation_reference_iteration(dead)
                plan = self.engine.plan_adaptation(dead)
                self.engine.apply_adaptation(plan, dead=dead,
                                             drained=drained)
                self.stats.reconfigurations += 1
                self.stats.adaptations += 1
                self.last_breakdown = self.engine.adapt_cost_model(
                    ).breakdown(plan, ref_iter)
                self._log_decision("adapt", predictions)
                return sum(self.last_breakdown.values())
            except AdaptationError:
                policy = "replan"
        if policy == "spare":
            try:
                result = self.engine.plan_spare_promotion(dead)
                self.engine.apply_spare_promotion(result, dead=dead,
                                                  drained=drained)
                self.stats.reconfigurations += 1
                self.stats.spare_promotions += 1
                self.last_breakdown = self.engine.recovery_breakdown(
                    result, dead=dead)
                self._log_decision("spare", predictions)
                return sum(self.last_breakdown.values())
            except AdaptationError:
                policy = "replan"
        try:
            result = self.engine.handle_failure(dead, drained=drained)
        except InsufficientReplicasError:
            raise PolicyStopped("below (f+1)*n0")
        except PlanningError as e:          # defensive: stop, don't crash
            raise PolicyStopped(f"oobleck: {e}")
        self.stats.reconfigurations += 1
        self.last_breakdown = self.engine.recovery_breakdown(result,
                                                             dead=dead)
        self._log_decision("replan", predictions)
        return sum(self.last_breakdown.values())

    def _log_decision(self, chosen: str, predictions) -> None:
        if predictions is None:     # fixed policy, nothing was compared
            return
        self.decisions.append({
            "sim_step": self.sim_step, "chosen": chosen,
            "predicted": {p: d["downtime"] for p, d in predictions.items()
                          if d.get("feasible")}})

    def on_join(self, nodes: List[str]) -> float:
        try:
            result = self.engine.handle_join(nodes)
        except PlanningError as e:
            raise PolicyStopped(f"oobleck: {e}")
        self.stats.reconfigurations += 1
        self.last_breakdown = self.engine.recovery_breakdown(result)
        return sum(self.last_breakdown.values())

    def num_nodes(self) -> int:
        return len(self.engine.nodes)


# ----------------------------------------------------------------------
class VarunaPolicy(Policy):
    name = "varuna"

    #: framework re-init on restart: process respawn, collective-group
    #: re-formation, tracer/partitioner re-run, data-loader seek (the
    #: paper's Fig. 11 shows restarting dominating Varuna at high failure
    #: rates; 120 s is the conservative end of their observed restarts).
    def __init__(self, profile: cm.ModelProfile, nodes: List[str],
                 global_batch: int, microbatch: int,
                 ckpt_every: int = 10, ckpt_overhead: bool = True,
                 init_seconds: float = 120.0,
                 n0: Optional[int] = None, max_stages: Optional[int] = None):
        self.profile = profile
        self.global_batch = global_batch
        self.microbatch = microbatch
        self.ckpt_every = ckpt_every
        self.ckpt_overhead = ckpt_overhead
        self.init_seconds = init_seconds
        self.stats = PolicyStats()
        self._nodes = set(nodes)
        self._planner = PipelinePlanner(profile, gpus_per_node=1,
                                        max_stages=max_stages)
        self._pp_depth = n0 or profile.min_nodes(1)
        self._templates: Dict[int, object] = {}
        self._reconfigure()

    # -- grid morphing: best homogeneous (pp, dp) over remaining nodes ----
    def _reconfigure(self) -> None:
        n = len(self._nodes)
        best = None
        for pp in range(self._pp_depth, min(n, 4 * self._pp_depth) + 1):
            dp = n // pp
            if dp < 1:
                continue
            if pp not in self._templates:
                try:
                    self._templates[pp] = self._planner.plan(pp)
                except PlanningError:
                    continue
            tpl = self._templates[pp]
            # ceil: the grid must process the FULL global batch
            nb = -(-self.global_batch // (self.microbatch * dp))
            t = estimate_iteration_time(tpl, nb)
            if best is None or t < best[0]:
                best = (t, pp, dp)
        if best is None:
            raise PolicyStopped("varuna: no feasible grid")
        self._iter_time, self._pp, self._dp = best

    def ckpt_bytes(self) -> int:
        return self.profile.train_state_bytes()

    def ckpt_save_seconds(self) -> float:
        return self.ckpt_bytes() / self.profile.hw.ckpt_write_bandwidth

    def ckpt_load_seconds(self) -> float:
        return self.ckpt_bytes() / self.profile.hw.ckpt_read_bandwidth

    def iteration_time(self) -> float:
        return self._iter_time

    def post_iteration(self, iteration: int) -> float:
        if self.ckpt_overhead and iteration % self.ckpt_every == 0:
            return self.ckpt_save_seconds()
        return 0.0

    def commit_lag_iterations(self) -> int:
        # rolls back to the last checkpoint: on average loses up to
        # ckpt_every iterations (we charge the worst case observed lag
        # in the simulator via this hint)
        return self.ckpt_every

    def on_failure(self, dead: Set[str]) -> float:
        self._nodes -= dead
        if len(self._nodes) < self._pp_depth:
            raise PolicyStopped("varuna: cannot fit model")
        self._reconfigure()
        self.stats.restarts += 1
        return self.init_seconds + self.ckpt_load_seconds()

    def on_join(self, nodes: List[str]) -> float:
        self._nodes |= set(nodes)
        self._reconfigure()
        self.stats.restarts += 1
        # joining also requires a full restart in Varuna
        return self.init_seconds + self.ckpt_load_seconds()

    def num_nodes(self) -> int:
        return len(self._nodes)


# ----------------------------------------------------------------------
class BambooPolicy(Policy):
    name = "bamboo"

    #: RC overhead: forward redundancy + deeper pipelines + imbalanced
    #: stages (paper Fig. 11 attributes >50% to RC all-in).
    RC_FACTOR = 1.6
    #: efficiency penalty of the tiny microbatches Bamboo is forced into
    #: (Table 1: microbatch 4 / 1 vs 32)
    SMALL_MB_EFFICIENCY = 0.75

    def __init__(self, profile: cm.ModelProfile, nodes: List[str],
                 global_batch: int, microbatch: int,
                 init_seconds: float = 60.0,
                 n0: Optional[int] = None, max_stages: Optional[int] = None):
        self.profile = profile
        self.global_batch = global_batch
        self.microbatch = microbatch
        self.init_seconds = init_seconds
        self.stats = PolicyStats()
        self._nodes = set(nodes)
        self._planner = PipelinePlanner(profile, gpus_per_node=1,
                                        max_stages=max_stages)
        self._pp_depth = n0 or profile.min_nodes(1)
        self._oom = not self._fits()
        if not self._oom:
            self._templates: Dict[int, object] = {}
            self._reconfigure()

    def _fits(self) -> bool:
        """2x model states (RC) + NO activation checkpointing (paper
        footnote 2: act-ckpt conflicts with RC's memory-balance design).

        Without remat a layer retains all intermediates: ~6 boundary-size
        tensors (qkv/mlp hidden/residuals) plus the attention score
        matrix b*H*S^2; 1F1B keeps ~pipeline-depth microbatches in
        flight on stage 0.  A 1.3x allocator-fragmentation factor matches
        PyTorch practice."""
        hw = self.profile.hw
        arch = self.profile.arch
        b, s = self.profile.microbatch, self.profile.seq_len
        n = max(len(self._nodes) // 2, self._pp_depth)  # pipeline depth
        L = self.profile.num_layers
        per_stage_layers = max(1, -(-L // max(n, 1)))
        boundary = 2 * b * s * arch.d_model
        scores = 2 * b * max(arch.num_heads, 1) * s * s
        act_per_layer = 6 * boundary + scores
        inflight = n                                  # stage-0 worst case
        state = 2.0 * self.profile.train_state_bytes() / max(n, 1)
        act = act_per_layer * per_stage_layers * inflight
        return 1.3 * (state + act) <= hw.hbm_capacity

    def runnable(self) -> bool:
        return not self._oom

    def _reconfigure(self) -> None:
        n = len(self._nodes)
        pp = max(self._pp_depth * 2, 2)       # RC needs deeper pipelines
        pp = min(pp, n)
        dp = max(1, n // pp)
        if pp not in self._templates:
            self._templates[pp] = self._planner.plan(pp)
        tpl = self._templates[pp]
        nb = -(-self.global_batch // (self.microbatch * dp))
        base = estimate_iteration_time(tpl, nb)
        self._iter_time = base * self.RC_FACTOR / self.SMALL_MB_EFFICIENCY

    def iteration_time(self) -> float:
        if self._oom:
            raise PolicyStopped("bamboo: OOM")
        return self._iter_time

    def on_failure(self, dead: Set[str]) -> float:
        self._nodes -= dead
        if len(self._nodes) < 2 * self._pp_depth:
            raise PolicyStopped("bamboo: cannot hold redundant states")
        # adjacent double-failure forces a full restart (paper §2.2);
        # with k simultaneous failures the chance a pair is adjacent grows.
        adjacent = len(dead) >= 2
        self._reconfigure()
        if adjacent:
            self.stats.restarts += 1
            return self.init_seconds + (self.profile.train_state_bytes()
                                        / self.profile.hw.ckpt_read_bandwidth)
        self.stats.reconfigurations += 1
        # promote backup + re-establish redundancy: copy one stage's states
        stage_bytes = 2 * self.profile.train_state_bytes() / max(
            len(self._nodes), 1)
        return hwlib.p2p_time(stage_bytes, hw=self.profile.hw) + 10.0

    def on_join(self, nodes: List[str]) -> float:
        self._nodes |= set(nodes)
        self._reconfigure()
        self.stats.reconfigurations += 1
        stage_bytes = 2 * self.profile.train_state_bytes() / max(
            len(self._nodes), 1)
        return hwlib.p2p_time(stage_bytes, hw=self.profile.hw) + 10.0

    def num_nodes(self) -> int:
        return len(self._nodes)
