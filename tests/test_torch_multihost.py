"""The port's multi-process backend (``repro_torch.runtime.multihost``),
REAL processes on the CPU: the four tests of tests/test_multihost.py
against the port, with the port's single-process ``HeteroTrainer`` as
the bitwise oracle, then the port against the JAX package:

  1. LIFECYCLE (3 workers) — bitwise lockstep with the single-process
     trainer; SIGKILL a worker: the death is detected through the
     coordination channel, survivors agree on a reconfiguration epoch,
     layer state moves between processes over sockets, the survivors
     build NOTHING, the post-recovery losses and the snapshot are
     BITWISE equal to the single-process trainer's, and checkpoints
     elect one manifest writer.
  2. CONFORMANCE + JOIN + FAULT INJECTION (2 workers) — the Executor
     interface, elastic join through the same two-phase commit, and a
     mid-step SIGKILL that loses the iteration without mutating state.
  3. THE JAX PACKAGE — for the same spec the port's plan (fingerprint
     and post-failure instances) equals the reference ``build_setup``'s,
     and the port's MultiHostExecutor on the JAX package's weights tracks
     the reference ``HeteroTrainer`` through the same failure trace at
     the fp32 tolerances of tests/test_executor.py.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.runtime import HeteroTrainer as JTrainer
from repro.runtime.multihost import build_setup as jbuild_setup
from repro.runtime.multihost import make_job_spec as jmake_job_spec

from repro_torch.ckpt import CheckpointManager
from repro_torch.data import GlobalBatchDispenser, SyntheticLM
from repro_torch.runtime import Executor, HeteroTrainer, WorkerLost
from repro_torch.runtime.multihost import (MultiHostExecutor, ShardTrainer,
                                           build_setup, make_job_spec)
from repro_torch.utils.tree import tree_leaves

# one thread here and (through the spawner's environment) in every
# worker: CPU reductions depend on the thread count
torch.set_num_threads(1)

GB, MB, SEQ, L = 16, 2, 16, 4
NODES = [f"n{i}" for i in range(5)]
# explicit hosting: rank 1 hosts exactly n2 — a NON-lead member of
# replica (n0, n1, n2) — so SIGKILLing it damages one replica while
# both surviving ranks keep their lead assignments (no survivor builds
# anything new), stays above the (f+1)*n0 floor, and the shrunk
# replica's rebind still moves layer state between processes
HOSTING = {"n0": 0, "n1": 0, "n2": 1, "n3": 2, "n4": 2}
TIMEOUT = 120.0
SPEC = dict(arch="gpt3_medium", layers=L, seq_len=SEQ, microbatch=MB,
            global_batch=GB, f=1, n0=2, nodes=NODES, seed=11)
#: tests/test_executor.py's fp32 tolerance (tree_allclose_ulp)
ATOL, RTOL = 5e-7, 5e-4


def _spec(hosting, procs, **kw):
    return make_job_spec(hosting=hosting, procs=procs, device="cpu",
                         **SPEC, **kw)


def _reference(spec):
    """The port's single-process trainer on the spec's model, weights
    and plan."""
    model, params, _, opt_cfg, engine = build_setup(spec)
    return model.arch, HeteroTrainer(model, engine, params, opt_cfg)


def _microbatches(batch):
    n = batch["tokens"].shape[0] // MB
    return [{k: v[i * MB:(i + 1) * MB] for k, v in batch.items()
             if not k.startswith("_")} for i in range(n)]


def _feed(disp, engine):
    return [_microbatches(b)
            for b in disp.next_step(engine.batch.minibatch_sizes())]


def _bitwise(a, b):
    return a.numpy().tobytes() == b.numpy().tobytes()


def test_multihost_is_an_executor_subclass():
    assert issubclass(MultiHostExecutor, Executor)
    assert issubclass(ShardTrainer, Executor)


def test_replan_fingerprint_is_hash_seed_independent():
    """Every process dry-runs the failure plan independently; the plan
    fingerprint (which includes the copy plan's source picks) must not
    depend on the interpreter's string-hash seed."""
    import repro_torch
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    prog = (
        "import json, sys\n"
        "from repro_torch.runtime.multihost import build_setup\n"
        "spec = json.loads(sys.argv[1])\n"
        "*_, engine = build_setup(spec, skeleton=True)\n"
        "spares = [n for n in engine.spare_nodes if n != 'n2']\n"
        "r = engine.reconf.on_failure(engine.instances, {'n2'},"
        " spares=spares)\n"
        "print(engine.plan_fingerprint(r))\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", prog, json.dumps(_spec(HOSTING, 3))],
        env=dict(os.environ, PYTHONHASHSEED=seed,
                 PYTHONPATH=src + os.pathsep + os.environ.get(
                     "PYTHONPATH", "")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for seed in ("0", "1", "2")]
    fps = set()
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err
            fps.add(out.strip())
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert len(fps) == 1, fps


def test_sigkill_lifecycle_parity_zero_compiles(tmp_path):
    spec = _spec(HOSTING, 3)
    arch, ref = _reference(spec)
    ref.warm_templates()
    src = SyntheticLM(arch.vocab_size, SEQ, seed=5)
    d_ref, d_mh = GlobalBatchDispenser(src), GlobalBatchDispenser(src)

    with MultiHostExecutor(spec, rpc_timeout=TIMEOUT) as mh:
        assert mh.engine.plan_fingerprint() == ref.engine.plan_fingerprint()
        mh.warm_templates()

        # bitwise lockstep with the single-process trainer
        for _ in range(2):
            o_ref = ref.step(_feed(d_ref, ref.engine))
            o_mh = mh.step(_feed(d_mh, mh.engine))
            assert _bitwise(o_ref["loss"], o_mh["loss"])
            assert _bitwise(o_ref["grad_norm"], o_mh["grad_norm"])
        assert mh.replica_divergence() == 0
        mh.mark_compiles()

        # SIGKILL a worker; detection comes from the channel
        # (EOF/heartbeat), NOT from an injected event
        mh.kill_worker(1)
        dead, ranks = mh.detected_dead(timeout=30.0)
        assert dead == {"n2"} and ranks == {1}

        # two-phase agreed reconfiguration; the replacement node's
        # state crosses processes over the data plane
        info = mh.recover(dead)
        ref.recover({"n2"})
        assert info["epoch"] == ref.engine.epoch == 1
        assert info["fetched_bytes"] > 0 and info["fetches"] >= 1
        # same plan as the single-process trainer, structurally (the
        # fingerprint's instance ids differ: the two-phase protocol
        # consumes extra reconfigurator ids for its PREPARE dry-run)
        assert ([i.nodes for i in mh.engine.instances]
                == [i.nodes for i in ref.engine.instances])
        assert (mh.engine.batch.num_microbatches
                == ref.engine.batch.num_microbatches)

        # post-recovery: bitwise lockstep continues, survivors built
        # NOTHING
        for _ in range(2):
            o_ref = ref.step(_feed(d_ref, ref.engine))
            o_mh = mh.step(_feed(d_mh, mh.engine))
            assert _bitwise(o_ref["loss"], o_mh["loss"])
            assert _bitwise(o_ref["grad_norm"], o_mh["grad_norm"])
        compiles = mh.compile_counts()
        assert sorted(compiles) == [0, 2]
        assert all(v == 0 for v in compiles.values()), compiles
        assert mh.replica_divergence() == 0

        # full state: snapshot params and moments bitwise-equal
        snap_mh, snap_ref = mh.snapshot(), ref.snapshot()
        assert snap_mh.step == snap_ref.step == 4
        for tree in ("params", "m", "v"):
            get = ((lambda s: s.params) if tree == "params"
                   else (lambda s, t=tree: getattr(s.opt_state, t)))
            for x, y in zip(tree_leaves(get(snap_mh)),
                            tree_leaves(get(snap_ref))):
                assert _bitwise(x, y), tree

        # multi-writer checkpoint: every lead writes shards, exactly
        # one elected process commits the manifest
        stats = mh.save_checkpoint(str(tmp_path))
        wrote = [r for r, s in stats.items() if s["manifests_skipped"] == 0]
        assert len(wrote) == 1
        mgr = CheckpointManager(str(tmp_path), num_layers=arch.num_layers,
                                async_mode=False)
        assert mgr.list_steps() == [snap_mh.step]
        assert mgr.verify(snap_mh.step)
        assert mgr.hashes(snap_mh) == mgr.hashes(snap_ref)


def test_two_proc_conformance_step_snapshot_join():
    hosting = {"n0": 0, "n1": 0, "n2": 0, "n3": 1, "n4": 1}
    spec = _spec(hosting, 2)
    arch, ref = _reference(spec)
    src = SyntheticLM(arch.vocab_size, SEQ, seed=9)
    d_ref, d_mh = GlobalBatchDispenser(src), GlobalBatchDispenser(src)

    with MultiHostExecutor(spec, rpc_timeout=TIMEOUT) as mh:
        assert isinstance(mh, Executor)
        o_ref = ref.step(_feed(d_ref, ref.engine))
        o_mh = mh.step(_feed(d_mh, mh.engine))
        assert _bitwise(o_ref["loss"], o_mh["loss"])

        # elastic join rides the same two-phase commit
        info = mh.join(["n5"])
        ref.join(["n5"])
        assert info["epoch"] == ref.engine.epoch
        assert mh.engine.plan_fingerprint() == ref.engine.plan_fingerprint()
        assert "n5" in mh.hosting

        o_ref = ref.step(_feed(d_ref, ref.engine))
        o_mh = mh.step(_feed(d_mh, mh.engine))
        assert _bitwise(o_ref["loss"], o_mh["loss"])
        assert mh.replica_divergence() == 0

        snap_mh, snap_ref = mh.snapshot(), ref.snapshot()
        for x, y in zip(tree_leaves(snap_mh.params),
                        tree_leaves(snap_ref.params)):
            assert _bitwise(x, y)

        # fault injection: SIGKILL the rank leading replica(s) while a
        # step is in flight — the iteration is LOST (§3.3), nothing
        # commits anywhere, and both sides drop the batch
        batches = _feed(d_mh, mh.engine)
        _feed(d_ref, ref.engine)
        mh.kill_worker(1)
        with pytest.raises(WorkerLost) as e:
            mh.step(batches)
        assert 1 in e.value.ranks
        dead, ranks = mh.detected_dead(timeout=30.0)
        assert dead == {"n3", "n4"} and ranks == {1}

        info = mh.recover(dead)
        ref.recover({"n3", "n4"})
        assert info["epoch"] == ref.engine.epoch
        assert ([i.nodes for i in mh.engine.instances]
                == [i.nodes for i in ref.engine.instances])

        # the lost iteration left state untouched: the sole survivor
        # continues in bitwise lockstep with the reference trace
        o_ref = ref.step(_feed(d_ref, ref.engine))
        o_mh = mh.step(_feed(d_mh, mh.engine))
        assert _bitwise(o_ref["loss"], o_mh["loss"])


# ----------------------------------------------------------------------
# The port against the JAX package
# ----------------------------------------------------------------------
def _jspec(**kw):
    return jmake_job_spec(hosting=HOSTING, procs=3, **SPEC, **kw)


def test_plan_matches_the_jax_package():
    """The same spec through both packages' build_setup: the same
    bootstrap fingerprint, the same dry-run of the failure, the same
    post-failure instances and batch plan."""
    *_, jengine = jbuild_setup(_jspec())
    *_, engine = build_setup(_spec(HOSTING, 3), skeleton=True)
    assert engine.plan_fingerprint() == jengine.plan_fingerprint()
    for eng in (engine, jengine):
        eng.dry = eng.plan_fingerprint(eng.reconf.on_failure(
            eng.instances, {"n2"},
            spares=[n for n in eng.spare_nodes if n != "n2"]))
    assert engine.dry == jengine.dry
    engine.handle_failure({"n2"})
    jengine.handle_failure({"n2"})
    assert engine.plan_fingerprint() == jengine.plan_fingerprint()
    assert [i.nodes for i in engine.instances] == \
        [i.nodes for i in jengine.instances]
    assert engine.batch.num_microbatches == jengine.batch.num_microbatches


def test_multihost_tracks_the_jax_trainer_through_a_sigkill(tmp_path):
    """The reference HeteroTrainer (JAX, in process, fp32, naive
    attention) and the port's MultiHostExecutor on the reference's
    weights (the spec's ``params``), through the same failure trace:
    losses and grad norms at the fp32 tolerances, the same plans."""
    jmodel, jparams, _, jopt, jengine = jbuild_setup(_jspec())
    jtr = JTrainer(jmodel, jengine, jparams, jopt, mode="compiled")
    path = str(tmp_path / "params.npz")
    np.savez(path, **{jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf
                      in jax.tree_util.tree_flatten_with_path(jparams)[0]})
    from repro.data import GlobalBatchDispenser as JDispenser
    from repro.data import SyntheticLM as JSyntheticLM
    vocab = jmodel.arch.vocab_size
    d_ref = JDispenser(JSyntheticLM(vocab, SEQ, seed=5))
    d_mh = GlobalBatchDispenser(SyntheticLM(vocab, SEQ, seed=5))

    def check(o_ref, o_mh):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(o_mh[key]), float(o_ref[key]),
                                       atol=ATOL, rtol=RTOL)
    with MultiHostExecutor(_spec(HOSTING, 3, params=path),
                           rpc_timeout=TIMEOUT) as mh:
        assert mh.engine.plan_fingerprint() == jengine.plan_fingerprint()
        for step in range(4):
            if step == 2:
                mh.kill_worker(1)
                dead, _ = mh.detected_dead(timeout=30.0)
                assert dead == {"n2"}
                mh.recover(dead)
                jtr.recover({"n2"})
                assert ([i.nodes for i in mh.engine.instances]
                        == [i.nodes for i in jengine.instances])
                assert (mh.engine.batch.num_microbatches
                        == jengine.batch.num_microbatches)
            o_ref = jtr.step(_feed(d_ref, jengine))
            o_mh = mh.step(_feed(d_mh, mh.engine))
            check(o_ref, o_mh)
        assert mh.replica_divergence() == 0
