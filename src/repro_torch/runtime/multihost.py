"""Multi-process execution backend (``repro/runtime/multihost.py``;
DESIGN.md §15).

Oobleck's architecture splits cluster-wide *configuration* from
per-node *execution*: one ConfigurationEngine plans (templates,
instantiation, batch distribution, reconfiguration) while an
ExecutionEngine per node runs the step programs (§3).  This module is
that split for real processes:

  * ``MultiHostExecutor`` — the coordinator.  Runs in the launching
    process, owns a pure ``ConfigurationEngine`` (plans only; a skeleton
    of parameter shapes and dtypes decodes snapshots, and no model
    state is held on the card), a ``CoordinatorServer`` control
    channel, and the worker subprocesses.  Implements the same
    ``Executor`` interface as the single-process ``HeteroTrainer``.
  * ``ShardTrainer`` — the per-process ExecutionEngine.  A
    ``HeteroTrainer`` subclass that binds full pipeline state ONLY for
    the replicas its process *leads* (a process leads replica R iff it
    hosts ``R.nodes[0]``), runs the identical per-template step
    programs, and exchanges per-bucket gradient contributions as raw
    fp32 bytes.
  * ``Worker`` + ``worker_main`` — the subprocess shell: control
    channel, heartbeats, RPC handlers, and a ``DataServer`` serving
    layer state to peers during recovery.

Bitwise parity with the single-process trainer is a design invariant:
every process runs the SAME step programs on the SAME inputs with the
same numerics (``strict_fp32_numerics`` on the card, the spawner's
thread count on the CPU), gradient combination is the identical
left-to-right chain on every process (``BucketedSync.combine``), fp32
buffers cross the wire as raw bytes, and the coordinator aggregates
losses in replica order with the exact expression the single-process
step uses, on the same device.

The step protocol (per iteration):

  1. ``step_grads``   coordinator -> each worker: the microbatches of
                      the replicas it leads.  Worker replies per-replica
                      per-bucket weighted contributions + NLL sums.
  2. ``step_commit``  coordinator -> every worker: the FULL contribution
                      set.  Each worker redundantly runs the identical
                      combine + clip + bucket updates on its led
                      replicas; ``opt_step`` advances here and only here.
     ``step_abort``   on any failure before commit: drop everything, no
                      state mutated — the paper's lost-iteration
                      semantics (§3.3).

Reconfiguration is two-phase with an agreed epoch: PREPARE freezes a
serving view of surviving layer state and dry-runs the reconfiguration
to a plan fingerprint; the coordinator verifies every survivor computed
the SAME fingerprint as its own engine; COMMIT applies the plan
deterministically everywhere and moves layer state between processes as
actual socket transfers (the ``runtime/transfer.py`` CopyTask streams);
FINISH drops the serving view once every survivor reports the same new
epoch and post-plan fingerprint.

Workers are fresh interpreters (``subprocess.Popen``), never forks of a
process that may already hold a CUDA context; on one card they share
it, as the reference's workers share a host's CPUs.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import signal
import subprocess
import sys
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.engine import ConfigurationEngine, EngineConfig
from repro_torch.core.monitor import HeartbeatConfig
from repro_torch.core.reconfigure import InsufficientReplicasError, PipelineInstance
from repro_torch.kernels import build as kbuild
from repro_torch.optim import adamw
from repro_torch.runtime.coordination import (CoordinatorServer, DataServer,
                                              EpochMismatch, WorkerChannel,
                                              WorkerLost, data_call, leaf_bytes,
                                              member_of, pack_batches,
                                              pack_tree, unpack_batches,
                                              unpack_tree)
from repro_torch.runtime.executor import CompileCounter, Executor, avals_of
from repro_torch.runtime.pipeline import HeteroTrainer
from repro_torch.utils.device import resolve_device, strict_fp32_numerics
from repro_torch.utils.tree import (tree_leaves, tree_leaves_with_path,
                                    tree_map, tree_unflatten_like)

_RPC_TIMEOUT = float(os.environ.get("REPRO_DRYRUN_TIMEOUT", "600"))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ----------------------------------------------------------------------
# Job spec: everything a worker needs to rebuild the IDENTICAL setup
# ----------------------------------------------------------------------
def make_job_spec(arch: str = "gpt3_medium", layers: int = 4,
                  seq_len: int = 16, microbatch: int = 2,
                  global_batch: int = 16, f: int = 1, n0: int = 2,
                  nodes: Optional[Sequence[str]] = None,
                  nodes_per_pod: int = 8,
                  hosting: Optional[Dict[str, int]] = None,
                  procs: int = 2, seed: int = 11,
                  opt: Optional[Dict[str, float]] = None,
                  device: str = "cuda", attn_impl: str = "naive",
                  full: bool = False, depth: Optional[int] = None,
                  params: Optional[str] = None) -> Dict:
    """JSON-able job description.  ``hosting`` maps node name -> worker
    rank; the default splits the node list into ``procs`` contiguous
    chunks.  Every process (coordinator included) rebuilds model,
    profile and engine from this spec alone — same seed, same
    arithmetic, so all replicas of the configuration agree bit-for-bit.

    Beyond the reference's fields: ``device`` (the workers' device:
    ``"cuda"`` unless the caller asks for ``"cpu"``), ``attn_impl``,
    ``full`` (the configuration as published instead of
    ``reduced(arch, layers)``), ``depth`` (with ``full``, its width at
    ``depth`` blocks) and ``params`` (the path of an ``.npz``
    of parameters keyed by ``keystr``, loaded in place of
    ``Model.init``: how a run takes the JAX package's weights)."""
    nodes = list(nodes) if nodes is not None else [f"n{i}" for i in range(5)]
    if hosting is None:
        per = -(-len(nodes) // procs)
        hosting = {n: min(i // per, procs - 1) for i, n in enumerate(nodes)}
    return {
        "arch": arch, "layers": layers, "seq_len": seq_len,
        "microbatch": microbatch, "global_batch": global_batch,
        "f": f, "n0": n0, "nodes": nodes, "nodes_per_pod": nodes_per_pod,
        "hosting": {n: int(r) for n, r in hosting.items()},
        "seed": seed,
        "opt": opt or {"lr": 1e-3, "warmup_steps": 0, "clip_norm": 1.0,
                       "weight_decay": 0.0},
        "device": device, "attn_impl": attn_impl, "full": bool(full),
        "depth": depth, "params": params,
    }


def param_skeleton(model) -> Dict:
    """The model's parameter tree as ``meta`` tensors (shapes and dtypes
    only): ``Model.init`` traced under FakeTensorMode, so no memory is
    filled and no random number is drawn."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = model.init(torch.Generator())
    return avals_of(fake)


def load_params(path: str, model, device) -> Dict:
    """A job spec's ``params``, an ``.npz`` of leaves keyed by
    ``keystr``, as the model's parameter tree on ``device``."""
    from repro_torch.convert import params_from_numpy
    skeleton = param_skeleton(model)
    with np.load(path) as npz:
        tree = tree_unflatten_like(skeleton, [
            npz[k] for k, _ in tree_leaves_with_path(skeleton)])
    return params_from_numpy(tree, device)


def build_setup(spec: Dict, skeleton: bool = False):
    """Deterministically rebuild (model, params, profile, opt_cfg,
    engine) from a job spec — run by the coordinator AND by every
    worker, so each process's ConfigurationEngine replica starts from
    the identical plan.  Workers get the parameters on the spec's
    device; ``skeleton=True`` (the coordinator) gets ``param_skeleton``
    instead and touches no device."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core import build_profile
    from repro_torch.models import Model

    arch = get_arch(spec["arch"])
    if not spec.get("full"):
        arch = reduced(arch, layers=spec["layers"])
    elif spec.get("depth"):
        arch = dataclasses.replace(arch, num_layers=spec["depth"])
    model = Model(arch, dtype=torch.float32, remat=False,
                  attn_impl=spec.get("attn_impl", "naive"))
    if skeleton:
        params = param_skeleton(model)
    else:
        device = resolve_device(spec.get("device", "cuda"))
        if spec.get("params"):
            params = load_params(spec["params"], model, device)
        else:
            params = model.init(
                torch.Generator(device=device).manual_seed(spec["seed"]))
    profile = build_profile(arch, microbatch=spec["microbatch"],
                            seq_len=spec["seq_len"])
    opt_cfg = adamw.AdamWConfig(**spec["opt"])
    engine = ConfigurationEngine(
        profile, list(spec["nodes"]),
        EngineConfig(fault_tolerance=spec["f"],
                     global_batch=spec["global_batch"],
                     microbatch=spec["microbatch"],
                     gpus_per_node=1, n0_override=spec["n0"],
                     nodes_per_pod=spec["nodes_per_pod"]))
    return model, params, profile, opt_cfg, engine


def layer_state_hash(st: Dict[str, Any]) -> str:
    """Content hash of one layer's {p, m, v} state, leaf order fixed by
    the tree flatten — the cross-process bitwise-equality probe."""
    h = hashlib.sha256()
    for leaf in tree_leaves(st):
        h.update(leaf_bytes(leaf))
    return h.hexdigest()[:16]


# ----------------------------------------------------------------------
# Per-process execution engine
# ----------------------------------------------------------------------
class ShardTrainer(HeteroTrainer):
    """HeteroTrainer bound to the replicas this process LEADS.

    Lead rule: the process hosting a replica's first node holds the
    replica's full layer state (replica-lead execution).  All planning
    state (the engine) is replicated everywhere and mutated by the same
    deterministic calls, so every process always agrees on WHO leads
    WHAT without communicating about it.
    """

    def __init__(self, model, engine: ConfigurationEngine, params,
                 opt_cfg, hosting: Dict[str, int], rank: int):
        self.hosting = {n: int(r) for n, r in hosting.items()}
        self.rank = int(rank)
        # recovery serving state, populated between PREPARE and FINISH
        self._serve_view: Dict[Tuple[str, int], Dict] = {}
        self._old_lead: Dict[str, int] = {}
        self._old_owns: Set[Tuple[str, int]] = set()
        self._old_owners: Dict[int, Set[str]] = {}
        super().__init__(model, engine, params, opt_cfg, mode="compiled",
                         codec="none")

    # -- which replicas are mine ---------------------------------------
    def leads(self, inst: PipelineInstance) -> bool:
        return self.hosting.get(inst.nodes[0]) == self.rank

    def _bound_instances(self) -> List[PipelineInstance]:
        return [inst for inst in self.engine.instances if self.leads(inst)]

    def led_indices(self) -> List[int]:
        return [i for i, inst in enumerate(self.engine.instances)
                if self.leads(inst)]

    def run_of(self, replica_idx: int):
        inst = self.engine.instances[replica_idx]
        for run in self.runs:
            if run.instance is inst:
                return run
        raise KeyError(f"rank {self.rank} does not lead replica "
                       f"{replica_idx}")

    # -- step protocol -------------------------------------------------
    def grads_phase(self, replicas: Sequence[int],
                    batches: Sequence[List[Dict]]
                    ) -> Tuple[Dict[int, List[torch.Tensor]],
                               Dict[int, torch.Tensor]]:
        """Run the led replicas' pipelines and return their per-bucket
        weighted contributions + NLL sums — the bytes that go to the
        coordinator.  No state is mutated here; a failure between this
        and commit loses the iteration, nothing else."""
        weights = [float(m) for m in self.engine.batch.num_microbatches]
        grads_by: Dict[int, Dict[int, Any]] = {}
        nll_sums: Dict[int, torch.Tensor] = {}
        for idx, mbs in zip(replicas, batches):
            run = self.run_of(idx)
            if len(mbs) != self.engine.batch.num_microbatches[idx]:
                raise ValueError(f"replica {idx}: {len(mbs)} microbatches, "
                                 f"plan {self.engine.batch.num_microbatches}")
            g, nll = self._run_pipeline(run, mbs)
            grads_by[idx] = g
            nll_sums[idx] = torch.sum(nll)
        plan = self._bucket_plan()
        contribs, staged = self._bsync.contributions(plan, grads_by, weights)
        assert not staged, "codec residuals unsupported in multihost v1"
        return contribs, nll_sums

    def commit_phase(self, contribs_by_replica: Dict[int, Sequence[torch.Tensor]]
                     ) -> torch.Tensor:
        """Combine the FULL contribution set (identical chain on every
        process -> identical bits), clip, and commit the bucket updates
        on the led replicas.  The ONLY mutating phase."""
        plan = self._bucket_plan()
        flats, sumsqs = self._bsync.combine(plan, contribs_by_replica)
        grad_norm = torch.sqrt(sum(sumsqs))     # the single-process chain
        scale = self._clip_scale(grad_norm)
        step_in = self.opt_step                 # adamw.update increments
        self.opt_step = self.opt_step + 1
        for run in self.runs:
            self._bsync.update(plan, flats, run.states, scale, step_in)
        return grad_norm

    # -- two-phase reconfiguration -------------------------------------
    def prepare_reconfig(self, dead: Set[str],
                         hosting_update: Optional[Dict[str, int]] = None,
                         kind: str = "fail") -> Optional[str]:
        """PREPARE: freeze the serving view (surviving layer state of
        led replicas, addressable by (node, layer)), record the
        pre-failure lead/ownership maps the commit's source resolution
        needs, and dry-run the reconfiguration to its plan fingerprint.
        Nothing is mutated — abort is free until COMMIT."""
        eng = self.engine
        dead = set(dead)
        self._serve_view = {}
        for run in self.runs:
            for l, st in run.states.items():
                for node in run.instance.layer_owners(l):
                    if node not in dead:
                        self._serve_view[(node, l)] = st
        self._old_lead = {}
        self._old_owns = set()
        self._old_owners = {}
        for inst in eng.instances:
            lead = self.hosting[inst.nodes[0]]
            for node in inst.nodes:
                self._old_lead[node] = lead
            for l, nodes in inst.all_layer_owners().items():
                for node in nodes:
                    if node not in dead:
                        self._old_owns.add((node, l))
                        self._old_owners.setdefault(l, set()).add(node)
        if hosting_update:
            self.hosting.update(
                {n: int(r) for n, r in hosting_update.items()})
        if kind != "fail":
            return None
        dead_active = {d for d in dead if d in set(eng.nodes)}
        if not dead_active:
            return eng.plan_fingerprint()
        spares = [n for n in eng.spare_nodes if n not in dead]
        result = eng.reconf.on_failure(eng.instances, dead_active,
                                       spares=spares)
        return eng.plan_fingerprint(result)

    def commit_reconfig(self, dead: Set[str],
                        data_addrs: Dict[int, Sequence],
                        kind: str = "fail",
                        nodes: Sequence[str] = (),
                        drained: bool = False) -> Dict:
        """COMMIT: apply the SAME deterministic replan every process
        computes, then rebind the led replicas — each layer's state
        comes from the node the transfer plan scheduled, resolved to
        the process that physically holds it (the source node's OLD
        replica lead) and pulled over the data plane when remote."""
        eng = self.engine
        dead = set(dead)
        dead_ranks = {self.hosting[n] for n in dead if n in self.hosting}
        if kind == "fail":
            result = eng.handle_failure(dead, drained=drained)
        else:
            result = eng.handle_join(list(nodes))
        plan = eng.transfer_plan(result, dead=dead)
        fetched = {"bytes": 0, "fetches": 0, "seconds": 0.0}

        def avail(node: str, l: int) -> bool:
            # a (node, layer) copy is REACHABLE iff the node survived
            # AND the process that physically held it (the node's old
            # replica lead) survived
            return ((node, l) in self._old_owns
                    and self._old_lead.get(node) is not None
                    and self._old_lead[node] not in dead_ranks)

        def state_for(node: str, l: int) -> Dict:
            if avail(node, l):
                src = node                  # state didn't move
            else:
                src = plan.source_of(node, l)
                if src is None or not avail(src, l):
                    cands = sorted(m for m in self._old_owners.get(l, ())
                                   if avail(m, l))
                    if not cands:
                        raise InsufficientReplicasError(
                            f"layer {l}: every surviving copy lived on "
                            f"a dead process")
                    src = cands[0]
            src_rank = self._old_lead[src]
            if src_rank == self.rank:
                return self._serve_view[(src, l)]
            t0 = time.perf_counter()
            reply, blobs = data_call(
                data_addrs[src_rank],
                {"type": "get_state", "node": src, "layer": l})
            st = unpack_tree(self._state_skeleton(l), reply["spec"], blobs,
                             device=self.device)
            fetched["bytes"] += sum(len(b) for b in blobs)
            fetched["fetches"] += 1
            fetched["seconds"] += time.perf_counter() - t0
            return st

        self.runs = [self._bind_run(inst, layers=None, state_fn=state_for)
                     for inst in self._bound_instances()]
        self.bind()     # program swap by cache lookup (zero builds)
        return {"copied_bytes": result.copy_bytes(),
                "fetched_bytes": fetched["bytes"],
                "fetches": fetched["fetches"],
                "transfer_s": fetched["seconds"]}

    def finish_reconfig(self) -> None:
        """FINISH: every survivor reported the agreed epoch — drop the
        frozen serving view."""
        self._serve_view = {}
        self._old_lead = {}
        self._old_owns = set()
        self._old_owners = {}

    def _state_skeleton(self, l: int) -> Dict:
        p = self._layer_avals[l]
        f32 = lambda t: torch.empty(t.shape, dtype=torch.float32,
                                    device="meta")
        return {"p": p, "m": tree_map(f32, p), "v": tree_map(f32, p)}

    def layer_hashes(self) -> Dict[int, Dict[int, str]]:
        out: Dict[int, Dict[int, str]] = {}
        for run in self.runs:
            idx = next(i for i, inst in enumerate(self.engine.instances)
                       if inst is run.instance)
            out[idx] = {l: layer_state_hash(st)
                        for l, st in run.states.items()}
        return out


# ----------------------------------------------------------------------
# Worker process shell
# ----------------------------------------------------------------------
class Worker:
    """RPC surface of one worker process: owns the ShardTrainer, the
    control channel (heartbeats ride it), the DataServer peers pull
    state from, and a persistent CompileCounter so the coordinator can
    assert the survivors' zero-build property remotely."""

    def __init__(self, coordinator: Tuple[str, int], rank: int,
                 beat_interval: float = 0.2):
        self.rank = rank
        self.counter = CompileCounter()
        self.trainer: Optional[ShardTrainer] = None
        self.data_addrs: Dict[int, Sequence] = {}
        self.server = DataServer(self._serve_data)
        self.channel = WorkerChannel(
            coordinator, rank,
            hello={"data_addr": list(self.server.addr), "pid": os.getpid()},
            beat_interval=beat_interval)

    # -- data plane ----------------------------------------------------
    def _serve_data(self, header, blobs):
        assert header["type"] == "get_state", header
        st = self.trainer._serve_view[(header["node"], header["layer"])]
        spec, out = pack_tree(st)
        return {"spec": spec}, out

    # -- control handlers ----------------------------------------------
    def _h_job(self, header, blobs):
        t0 = time.perf_counter()
        spec = header["spec"]
        strict_fp32_numerics()          # before the first product
        model, params, _, opt_cfg, engine = build_setup(spec)
        # The reference keys its program cache by process topology, since
        # a traced JAX program is tied to a device set; the port's
        # ProgramCache lives in this process and holds Python callables,
        # so the trainer's own cache needs no such key.
        self.trainer = ShardTrainer(model, engine, params, opt_cfg,
                                    spec["hosting"], self.rank)
        del params
        _sync(self.trainer.device)
        return {"fingerprint": engine.plan_fingerprint(),
                "led": self.trainer.led_indices(),
                "seconds": time.perf_counter() - t0}, ()

    def _h_start(self, header, blobs):
        self.data_addrs = {int(r): a for r, a in header["addrs"].items()}
        return {}, ()

    def _h_warm(self, header, blobs):
        t0 = time.perf_counter()
        stats = self.trainer.warm_templates()
        return {"cache": stats, "seconds": time.perf_counter() - t0}, ()

    def _h_mark(self, header, blobs):
        self.counter.mark()
        return {}, ()

    def _h_compiles(self, header, blobs):
        dev = self.trainer.device if self.trainer is not None else None
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev is not None and dev.type == "cuda" else 0)
        return {"since_mark": self.counter.since_mark(),
                "total": self.counter.count,
                "launches": dict(kbuild.LAUNCHES),
                "max_memory_allocated": int(peak)}, ()

    def _h_step_grads(self, header, blobs):
        t0 = time.perf_counter()
        replicas = [int(i) for i in header["replicas"]]
        batches = unpack_batches(header["spec"], blobs)
        contribs, nll_sums = self.trainer.grads_phase(replicas, batches)
        _sync(self.trainer.device)
        t1 = time.perf_counter()
        out: List[bytes] = []
        for idx in replicas:
            out.extend(leaf_bytes(c) for c in contribs[idx])
            out.append(leaf_bytes(nll_sums[idx]))
        nb = len(contribs[replicas[0]]) if replicas else 0
        return {"replicas": replicas, "nbuckets": nb,
                "compute_s": t1 - t0,
                "pack_s": time.perf_counter() - t1}, out

    def _h_step_commit(self, header, blobs):
        t0 = time.perf_counter()
        B = int(header["nbuckets"])
        dev = self.trainer.device
        contribs: Dict[int, List[torch.Tensor]] = {}
        k = 0
        for idx in header["replicas"]:
            contribs[int(idx)] = [
                torch.from_numpy(np.frombuffer(blobs[k + j], np.float32)
                                 ).to(dev)
                for j in range(B)]
            k += B
        gn = self.trainer.commit_phase(contribs)
        del contribs
        raw = leaf_bytes(gn)
        return {"opt_step": int(self.trainer.opt_step),
                "compute_s": time.perf_counter() - t0}, [raw]

    def _h_step_abort(self, header, blobs):
        return {}, ()       # grads phase mutated nothing; nothing to undo

    def _h_prepare(self, header, blobs):
        fp = self.trainer.prepare_reconfig(
            set(header["dead"]),
            hosting_update=header.get("hosting_update"),
            kind=header.get("kind", "fail"))
        return {"fingerprint": fp, "epoch": self.trainer.engine.epoch}, ()

    def _h_commit(self, header, blobs):
        info = self.trainer.commit_reconfig(
            set(header["dead"]), self.data_addrs,
            kind=header.get("kind", "fail"),
            nodes=header.get("nodes", ()),
            drained=bool(header.get("drained", False)))
        _sync(self.trainer.device)
        eng = self.trainer.engine
        return dict(info, epoch=eng.epoch,
                    fingerprint=eng.plan_fingerprint()), ()

    def _h_finish(self, header, blobs):
        self.trainer.finish_reconfig()
        return {}, ()

    def _h_snapshot(self, header, blobs):
        st = self.trainer.snapshot(
            data_state=header.get("data_state") or {},
            rng_seed=int(header.get("rng_seed", 0)))
        spec_p, b_p = pack_tree(st.params)
        spec_m, b_m = pack_tree(st.opt_state.m)
        spec_v, b_v = pack_tree(st.opt_state.v)
        return {"step": st.step, "leaves": len(b_p), "spec_p": spec_p,
                "spec_m": spec_m, "spec_v": spec_v}, b_p + b_m + b_v

    def _h_layer_hashes(self, header, blobs):
        hashes = {str(i): {str(l): h for l, h in per.items()}
                  for i, per in self.trainer.layer_hashes().items()}
        return {"hashes": hashes}, ()

    def _h_save_ckpt(self, header, blobs):
        from repro_torch.ckpt import CheckpointManager
        # the manager counts blocks (the reference passes the trainer's
        # layer count, embed and head included, which JAX's clamped
        # indexing absorbs; torch's indexing would raise)
        mgr = CheckpointManager(
            header["directory"], self.trainer.model.arch.num_layers,
            async_mode=False, keep=int(header.get("keep", 2)),
            process_id=member_of(self.rank),
            manifest_writer=(header["writer"] == member_of(self.rank)))
        mgr.save(self.trainer.snapshot(
            data_state=header.get("data_state") or {}))
        mgr.wait()
        return {"stats": mgr.stats}, ()

    def handlers(self):
        return {
            "job": self._h_job, "start": self._h_start,
            "warm": self._h_warm, "mark_compiles": self._h_mark,
            "compile_counts": self._h_compiles,
            "step_grads": self._h_step_grads,
            "step_commit": self._h_step_commit,
            "step_abort": self._h_step_abort,
            "reconf_prepare": self._h_prepare,
            "reconf_commit": self._h_commit,
            "reconf_finish": self._h_finish,
            "snapshot": self._h_snapshot,
            "layer_hashes": self._h_layer_hashes,
            "save_ckpt": self._h_save_ckpt,
        }

    def run(self) -> None:
        try:
            self.channel.serve(self.handlers())
        finally:
            self.server.close()
            self.channel.close()


def worker_main(coordinator: str, rank: int) -> None:
    host, port = coordinator.rsplit(":", 1)
    Worker((host, int(port)), rank).run()


# ----------------------------------------------------------------------
# The coordinator-side Executor
# ----------------------------------------------------------------------
class MultiHostExecutor(Executor):
    """Executor whose execution lives in N worker subprocesses.

    The coordinator holds NO layer state: it plans (ConfigurationEngine),
    routes microbatches and contributions, arbitrates the two-phase
    reconfiguration, and watches liveness through the heartbeat channel.
    ``recover`` works from detected failures — kill -9 a worker and the
    socket EOF (or heartbeat silence) surfaces its hosted nodes as dead
    without any injected event.  Step metrics come back as tensors on
    the spec's device, computed by the single-process trainer's
    expression; ``last_step_info`` splits the last step's seconds and
    bytes, ``timing`` the workers' start-up.
    """

    def __init__(self, spec: Dict,
                 heartbeat: Optional[HeartbeatConfig] = None,
                 python: Optional[str] = None,
                 rpc_timeout: float = _RPC_TIMEOUT):
        self.spec = dict(spec)
        self.hosting = {n: int(r) for n, r in spec["hosting"].items()}
        self.rpc_timeout = rpc_timeout
        self.device = resolve_device(self.spec.get("device", "cuda"))
        ranks = sorted(set(self.hosting.values()))
        self.server = CoordinatorServer(len(ranks), heartbeat)
        self.procs: Dict[int, subprocess.Popen] = {}
        self.opt_step = 0
        self.last_info: Optional[Dict] = None
        self.last_step_info: Optional[Dict] = None
        try:
            self._start(ranks, python)
        except BaseException:
            self.shutdown()         # never leave a worker behind
            raise

    def _start(self, ranks: List[int], python: Optional[str]) -> None:
        t0 = time.perf_counter()
        self._spawn_workers(ranks, python)
        hellos = self.server.accept_workers(timeout=self.rpc_timeout)
        spawn_s = time.perf_counter() - t0
        self.data_addrs = {r: list(h["data_addr"])
                           for r, h in hellos.items()}
        # the coordinator's CONFIGURATION side: plans only.  The skeleton
        # of parameter shapes decodes snapshot trees.
        (self.model, self._template_params, self.profile,
         self.opt_cfg, self.engine) = build_setup(self.spec, skeleton=True)
        t1 = time.perf_counter()
        replies = self.server.broadcast_call(
            {"type": "job", "spec": self.spec}, timeout=self.rpc_timeout)
        fp0 = self.engine.plan_fingerprint()
        for r, (h, _) in replies.items():
            if h["fingerprint"] != fp0:
                raise EpochMismatch(
                    f"rank {r} bootstrapped fingerprint "
                    f"{h['fingerprint']} != coordinator's {fp0}")
        self.server.broadcast_call(
            {"type": "start",
             "addrs": {str(r): a for r, a in self.data_addrs.items()}},
            timeout=self.rpc_timeout)
        self.timing = {"spawn_s": spawn_s,
                       "job_s": time.perf_counter() - t1,
                       "setup_s": {r: h["seconds"]
                                   for r, (h, _) in replies.items()}}

    # -- process management --------------------------------------------
    def _spawn_workers(self, ranks: List[int],
                       python: Optional[str]) -> None:
        import repro_torch
        from repro_torch.kernels import autotune
        src = os.path.dirname(os.path.dirname(
            os.path.abspath(repro_torch.__file__)))
        host, port = self.server.addr
        for r in ranks:
            # no tuning and this process's table: the workers resolve the
            # coordinator's tiles and splits, so their sums match its run
            env = autotune.child_env()
            env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
            env["REPRO_PROC_COUNT"] = str(len(ranks))
            env["REPRO_PROC_INDEX"] = str(r)
            # CPU reductions depend on the thread count: the workers use
            # this process's, so their sums match a single-process run
            env["REPRO_TORCH_THREADS"] = str(torch.get_num_threads())
            cmd = [python or sys.executable,
                   "-m", "repro_torch.runtime.multihost_worker",
                   "--coordinator", f"{host}:{port}", "--rank", str(r)]
            self.procs[r] = subprocess.Popen(cmd, env=env)

    def kill_worker(self, rank: int) -> None:
        """SIGKILL a worker process — the failure-injection primitive of
        the multi-process acceptance tests.  Detection happens through
        the coordination channel (EOF/heartbeat), NOT through this call."""
        proc = self.procs[rank]
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait()

    def hosted_nodes(self, ranks: Iterable[int]) -> Set[str]:
        ranks = set(ranks)
        return {n for n, r in self.hosting.items() if r in ranks}

    def detected_dead(self, timeout: float = 15.0
                      ) -> Tuple[Set[str], Set[int]]:
        """Wait for the heartbeat channel to declare worker(s) dead;
        returns (their hosted nodes, their ranks).  This is the failure
        signal the recovery path consumes — no injected events."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            ranks = self.server.poll_dead()
            if ranks:
                return self.hosted_nodes(ranks), set(ranks)
            time.sleep(0.05)
        return set(), set()

    # -- Executor interface --------------------------------------------
    def bind(self) -> None:
        pass            # workers bind internally at job/commit time

    def warm_templates(self, mb_counts=None) -> Dict[int, Dict]:
        """Broadcast warm + reset every worker's build counter: the
        zero-build contract is asserted against builds SINCE this
        point."""
        replies = self.server.broadcast_call({"type": "warm"},
                                             timeout=self.rpc_timeout)
        self.server.broadcast_call({"type": "mark_compiles"},
                                   timeout=self.rpc_timeout)
        self.timing["warm_s"] = {r: h["seconds"]
                                 for r, (h, _) in replies.items()}
        return {r: h["cache"] for r, (h, _) in replies.items()}

    def mark_compiles(self) -> None:
        """Reset every worker's build counter.  Call at steady state;
        ``compile_counts`` then measures the recovery path alone."""
        self.server.broadcast_call({"type": "mark_compiles"},
                                   ranks=self.server.alive_ranks(),
                                   timeout=self.rpc_timeout)

    def worker_counts(self) -> Dict[int, Dict]:
        """Each live worker's counters: builds since the mark and in
        all, its kernel launches (``kernels/build.py::LAUNCHES``: the
        coordinator sees no launch in another process any other way)
        and its peak device memory."""
        replies = self.server.broadcast_call(
            {"type": "compile_counts"}, ranks=self.server.alive_ranks(),
            timeout=self.rpc_timeout)
        return {r: h for r, (h, _) in replies.items()}

    def compile_counts(self) -> Dict[int, int]:
        return {r: h["since_mark"] for r, h in self.worker_counts().items()}

    def _scalar(self, raw: bytes) -> torch.Tensor:
        arr = np.frombuffer(raw, np.float32).reshape(()).copy()
        return torch.from_numpy(arr).to(self.device)

    def step(self, batches: List[List[Dict]]) -> Dict:
        eng = self.engine
        assert len(batches) == len(eng.instances), \
            (len(batches), len(eng.instances))
        by_rank: Dict[int, List[int]] = {}
        for i, inst in enumerate(eng.instances):
            by_rank.setdefault(self.hosting[inst.nodes[0]], []).append(i)
        requests = {}
        for r, idxs in by_rank.items():
            spec, blobs = pack_batches([batches[i] for i in idxs])
            requests[r] = ({"type": "step_grads", "replicas": idxs,
                            "spec": spec}, blobs)
        t0 = time.perf_counter()
        try:
            replies = self.server.multi_call(requests,
                                             timeout=self.rpc_timeout)
        except WorkerLost:
            self._abort_step()
            raise
        t1 = time.perf_counter()
        contribs: Dict[int, List[bytes]] = {}
        nll: Dict[int, bytes] = {}
        B = 0
        for r, (h, bl) in replies.items():
            B = h["nbuckets"]
            k = 0
            for idx in h["replicas"]:
                contribs[idx] = bl[k:k + B]
                nll[idx] = bl[k + B]
                k += B + 1
        R = len(eng.instances)
        order = list(range(R))
        blobs = [buf for i in order for buf in contribs[i]]
        header = {"type": "step_commit", "replicas": order, "nbuckets": B}
        # commit is idempotent per-worker; workers that answered have
        # advanced opt_step.  A worker lost HERE leaves survivors
        # uniformly committed — treat the step as done and let the
        # heartbeat surface the death before the next one.
        t2 = time.perf_counter()
        commits = self.server.broadcast_call(
            header, blobs, timeout=self.rpc_timeout, strict=False)
        t3 = time.perf_counter()
        if not commits:
            raise WorkerLost(list(by_rank), "no worker survived commit")
        grad_norm = self._scalar(next(iter(sorted(commits.items())))[1][1][0])
        weights = [len(b) for b in batches]
        scalars = [self._scalar(nll[i]) for i in order]
        # the EXACT single-process expression, replica order preserved
        loss = sum(scalars) / float(sum(weights))
        self.opt_step += 1
        down = sum(len(b) for b in blobs)
        self.last_step_info = {
            "grads_s": t1 - t0,
            "grads_compute_s": max(h["compute_s"] for h, _ in replies.values()),
            "grads_pack_s": max(h["pack_s"] for h, _ in replies.values()),
            "up_bytes": sum(len(b) for _, bl in replies.values() for b in bl),
            "commit_s": t3 - t2,
            "commit_compute_s": max(h["compute_s"]
                                    for h, _ in commits.values()),
            "down_bytes": down * len(commits)}
        return {"loss": loss, "grad_norm": grad_norm,
                "num_pipelines": R}

    def _abort_step(self) -> None:
        alive = self.server.alive_ranks()
        try:
            self.server.broadcast_call({"type": "step_abort"}, ranks=alive,
                                       timeout=self.rpc_timeout,
                                       strict=False)
        except WorkerLost:
            pass

    # -- reconfiguration -----------------------------------------------
    def recover(self, dead: Set[str], drained: bool = False) -> Dict:
        """Two-phase agreed reconfiguration across the survivors."""
        dead = set(dead)
        alive = self.server.alive_ranks()
        # PREPARE: dry-run locally + on every survivor; fingerprints
        # must agree before anything mutates
        t0 = time.perf_counter()
        dead_active = {d for d in dead if d in set(self.engine.nodes)}
        if dead_active:
            spares = [n for n in self.engine.spare_nodes if n not in dead]
            my_fp = self.engine.plan_fingerprint(
                self.engine.reconf.on_failure(self.engine.instances,
                                              dead_active, spares=spares))
        else:
            my_fp = self.engine.plan_fingerprint()
        replies = self.server.broadcast_call(
            {"type": "reconf_prepare", "dead": sorted(dead),
             "kind": "fail"}, ranks=alive, timeout=self.rpc_timeout)
        for r, (h, _) in replies.items():
            if h["fingerprint"] != my_fp:
                raise EpochMismatch(
                    f"PREPARE: rank {r} planned {h['fingerprint']}, "
                    f"coordinator planned {my_fp}")
        replan_s = time.perf_counter() - t0
        # COMMIT: everyone applies the agreed plan; state moves between
        # processes over the data plane
        t1 = time.perf_counter()
        result = self.engine.handle_failure(dead, drained=drained)
        replies = self.server.broadcast_call(
            {"type": "reconf_commit", "dead": sorted(dead), "kind": "fail",
             "drained": drained}, ranks=alive, timeout=self.rpc_timeout)
        info = self._check_commit(replies)
        commit_s = time.perf_counter() - t1
        # FINISH: agreed epoch everywhere — drop serving views
        t2 = time.perf_counter()
        self.server.broadcast_call({"type": "reconf_finish"}, ranks=alive,
                                   timeout=self.rpc_timeout)
        barrier_s = time.perf_counter() - t2
        self.last_info = {
            "policy": "replan", "copied_bytes": result.copy_bytes(),
            "fetched_bytes": info["fetched_bytes"],
            "fetches": info["fetches"],
            "num_pipelines": len(self.engine.instances),
            "epoch": self.engine.epoch,
            "breakdown": {"replan": replan_s,
                          "transfer": info["transfer_s"],
                          "compile": 0.0,
                          "commit": commit_s,
                          "barrier": barrier_s}}
        return self.last_info

    def join(self, nodes: List[str]) -> Dict:
        """Elastic scale-up: new nodes are assigned to surviving worker
        ranks round-robin, then the same two-phase commit as recovery
        (the copy path of §5 applies to joins too)."""
        nodes = sorted(nodes)
        alive = self.server.alive_ranks()
        hosting_update = {n: alive[i % len(alive)]
                          for i, n in enumerate(nodes)}
        self.hosting.update(hosting_update)
        t0 = time.perf_counter()
        self.server.broadcast_call(
            {"type": "reconf_prepare", "dead": [], "kind": "join",
             "hosting_update": hosting_update},
            ranks=alive, timeout=self.rpc_timeout)
        replan_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        result = self.engine.handle_join(list(nodes))
        replies = self.server.broadcast_call(
            {"type": "reconf_commit", "dead": [], "kind": "join",
             "nodes": nodes}, ranks=alive, timeout=self.rpc_timeout)
        info = self._check_commit(replies)
        commit_s = time.perf_counter() - t1
        self.server.broadcast_call({"type": "reconf_finish"}, ranks=alive,
                                   timeout=self.rpc_timeout)
        self.last_info = {
            "policy": "join", "copied_bytes": result.copy_bytes(),
            "fetched_bytes": info["fetched_bytes"],
            "num_pipelines": len(self.engine.instances),
            "epoch": self.engine.epoch,
            "breakdown": {"replan": replan_s,
                          "transfer": info["transfer_s"],
                          "compile": 0.0, "commit": commit_s}}
        return self.last_info

    def _check_commit(self, replies) -> Dict:
        """Every survivor must land on the coordinator's epoch AND its
        post-commit plan fingerprint — the epoch-agreement assertion."""
        fp_after = self.engine.plan_fingerprint()
        fetched, fetches, transfer_s = 0, 0, 0.0
        for r, (h, _) in replies.items():
            if h["epoch"] != self.engine.epoch:
                raise EpochMismatch(
                    f"COMMIT: rank {r} at epoch {h['epoch']}, "
                    f"coordinator at {self.engine.epoch}")
            if h["fingerprint"] != fp_after:
                raise EpochMismatch(
                    f"COMMIT: rank {r} landed on {h['fingerprint']}, "
                    f"coordinator on {fp_after}")
            fetched += h["fetched_bytes"]
            fetches += h["fetches"]
            transfer_s = max(transfer_s, h["transfer_s"])
        return {"fetched_bytes": fetched, "fetches": fetches,
                "transfer_s": transfer_s}

    # -- state access --------------------------------------------------
    def snapshot(self, data_state: Optional[Dict] = None,
                 rng_seed: int = 0):
        """TrainState on the host (CPU tensors), from the lead of the
        first replica."""
        from repro_torch.ckpt import TrainState
        lead = self.hosting[self.engine.instances[0].nodes[0]]
        h, blobs = self.server.call(
            lead, {"type": "snapshot", "data_state": data_state or {},
                   "rng_seed": rng_seed}, timeout=self.rpc_timeout)
        n = h["leaves"]
        tpl = self._template_params
        params = unpack_tree(tpl, h["spec_p"], blobs[:n], device="cpu")
        m = unpack_tree(tpl, h["spec_m"], blobs[n:2 * n], device="cpu")
        v = unpack_tree(tpl, h["spec_v"], blobs[2 * n:3 * n], device="cpu")
        opt = adamw.AdamWState(torch.tensor(h["step"], dtype=torch.int32),
                               m, v)
        return TrainState(step=h["step"], params=params, opt_state=opt,
                          data_state=data_state or {}, rng_seed=rng_seed)

    def full_params(self) -> Dict:
        return self.snapshot().params

    def layer_hashes(self) -> Dict[int, Dict[int, str]]:
        """replica -> layer -> content hash, gathered across workers —
        the bitwise cross-process divergence probe."""
        replies = self.server.broadcast_call(
            {"type": "layer_hashes"}, ranks=self.server.alive_ranks(),
            timeout=self.rpc_timeout)
        out: Dict[int, Dict[int, str]] = {}
        for r, (h, _) in replies.items():
            for idx, per in h["hashes"].items():
                out[int(idx)] = {int(l): hh for l, hh in per.items()}
        return out

    def replica_divergence(self) -> int:
        """Number of (layer, replica-pair) hash mismatches — must be 0."""
        per_layer: Dict[int, Set[str]] = {}
        for per in self.layer_hashes().values():
            for l, h in per.items():
                per_layer.setdefault(l, set()).add(h)
        return sum(len(hs) - 1 for hs in per_layer.values())

    def save_checkpoint(self, directory: str,
                        data_state: Optional[Dict] = None) -> Dict[int, Dict]:
        """Every lead rank writes its shards; the elected writer commits
        the manifest (ckpt/checkpoint.py multi-writer safety)."""
        from repro_torch.ckpt import elect_writer
        alive = set(self.server.alive_ranks())
        lead_ranks = sorted({self.hosting[i.nodes[0]]
                             for i in self.engine.instances} & alive)
        writer = elect_writer([member_of(r) for r in lead_ranks])
        replies = self.server.broadcast_call(
            {"type": "save_ckpt", "directory": directory, "writer": writer,
             "data_state": data_state or {}},
            ranks=lead_ranks, timeout=self.rpc_timeout)
        return {r: h["stats"] for r, (h, _) in replies.items()}

    # -- lifecycle -----------------------------------------------------
    def shutdown(self) -> None:
        for r in self.server.alive_ranks():
            self.server.notify(r, {"type": "shutdown"})
        for r, p in self.procs.items():
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.server.close()

    def __enter__(self) -> "MultiHostExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


def worker_cli(argv: Optional[Sequence[str]] = None) -> None:
    """Entry point of a worker process — ``python -m
    repro_torch.runtime.multihost_worker --coordinator HOST:PORT --rank
    R``."""
    ap = argparse.ArgumentParser(
        description="multi-process training worker (spawned by "
                    "MultiHostExecutor or launched manually against a "
                    "coordinator)")
    ap.add_argument("--coordinator", required=True,
                    help="host:port of the coordinator's control channel")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--procs", type=int, default=None,
                    help="world size (for manual launches; the spawner "
                         "sets REPRO_PROC_COUNT itself)")
    args = ap.parse_args(argv)
    if args.procs is not None:
        os.environ.setdefault("REPRO_PROC_COUNT", str(args.procs))
    os.environ.setdefault("REPRO_PROC_INDEX", str(args.rank))
    threads = os.environ.get("REPRO_TORCH_THREADS")
    if threads:
        torch.set_num_threads(int(threads))
    worker_main(args.coordinator, args.rank)


if __name__ == "__main__":
    worker_cli()
