"""The port's checkpointer (``repro_torch/ckpt/checkpoint.py``): the
JAX package's checkpoint suite (tests/test_ckpt.py) run against it, the
keystr spelling against ``jax.tree_util.keystr``, and the on-disk format
across the packages: the same state saved by either gives the same shard
names and the same MANIFEST.json, and a checkpoint written by one
restores into the other, the next step agreeing at
tests/test_executor.py's tolerances."""
import dataclasses
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.ckpt.checkpoint as ckpt_mod
from repro.ckpt import CheckpointManager as JManager
from repro.ckpt import TrainState as JTrainState
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.core import EngineConfig as JEngineConfig
from repro.core import OobleckEngine as JEngine
from repro.core import build_profile as jbuild_profile
from repro.data import GlobalBatchDispenser as JDispenser
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import Model as JModel
from repro.optim import adamw as jadamw
from repro.runtime import HeteroTrainer as JTrainer
from repro.utils import hw as jhw

from repro_torch.ckpt import (CheckpointError, CheckpointManager, TrainState,
                              elect_writer, record_hash)
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.core import EngineConfig, OobleckEngine, build_profile
from repro_torch.data import GlobalBatchDispenser, SyntheticLM
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.runtime import HeteroTrainer
from repro_torch.utils import hw
from repro_torch.utils.tree import (flatten_with_path, keystr, tree_leaves,
                                    tree_leaves_with_path, tree_map)

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

GB, MB, SEQ, LR = 16, 2, 16, 1e-3
OPT = dict(lr=LR, warmup_steps=0, clip_norm=1.0, weight_decay=0.0)
#: tests/test_executor.py's fp32 tolerance (tree_allclose_ulp)
TOL = dict(atol=5e-7, rtol=5e-4)


@pytest.fixture(scope="module")
def state():
    """Reduced gpt3-medium's initial state: the JAX package's Model.init,
    carried over through numpy."""
    jarch = jreduced(jget_arch("gpt3_medium"), layers=3)
    jparams = JModel(jarch, dtype=jnp.float32, remat=False).init(
        jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jarch, params, adamw.init(params)


def _bump_layer(params, i):
    """A copy of ``params`` with only block ``i`` changed."""
    def bump(t):
        t = t.clone()
        t[i] += 1.0
        return t
    return {**params, "blocks": tree_map(bump, params["blocks"])}


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


# ----------------------------------------------------------------------
# tests/test_ckpt.py against the port's manager
# ----------------------------------------------------------------------
def test_incremental_save_skips_unchanged_shards(tmp_path, state):
    arch, params, opt = state
    mgr = CheckpointManager(str(tmp_path), num_layers=arch.num_layers,
                            async_mode=False, keep=4)
    mgr.save(TrainState(1, params, opt, {}, 0))
    wrote_first = mgr.stats["saved_shards"]
    assert wrote_first == arch.num_layers + 1        # layers + extra
    mgr.save(TrainState(2, params, opt, {}, 0))
    assert mgr.stats["saved_shards"] == wrote_first
    assert mgr.stats["skipped_shards"] == wrote_first
    mgr.save(TrainState(3, _bump_layer(params, 1), opt, {}, 0))
    assert mgr.stats["saved_shards"] == wrote_first + 1
    assert mgr.list_steps() == [1, 2, 3]
    assert all(mgr.verify(s) for s in (1, 2, 3))


def test_gc_keeps_only_last_k_steps_and_referenced_shards(tmp_path, state):
    arch, params, opt = state
    mgr = CheckpointManager(str(tmp_path), num_layers=arch.num_layers,
                            async_mode=False, keep=2)
    for s in (1, 2, 3):
        mgr.save(TrainState(s, _bump_layer(params, 0) if s == 3 else params,
                            opt, {}, 0))
    assert mgr.list_steps() == [2, 3]
    assert mgr.stats["gc_steps"] >= 1
    assert mgr.verify(2) and mgr.verify(3)
    r = mgr.restore(params, opt, step=2, device="cpu")
    _assert_trees_equal(params, r.params)


def test_save_does_not_block_on_inflight_write(tmp_path, state, monkeypatch):
    arch, params, opt = state
    mgr = CheckpointManager(str(tmp_path), num_layers=arch.num_layers,
                            async_mode=True, keep=8)
    release = threading.Event()
    orig = ckpt_mod._save_npz

    def slow(path, rec):
        release.wait(timeout=30)
        orig(path, rec)
    monkeypatch.setattr(ckpt_mod, "_save_npz", slow)
    t0 = time.perf_counter()
    mgr.save(TrainState(1, params, opt, {}, 0))
    mgr.save(TrainState(2, _bump_layer(params, 0), opt, {}, 0))
    enqueue_seconds = time.perf_counter() - t0
    release.set()
    mgr.wait()
    assert enqueue_seconds < 5.0, "save() must not wait for the writer"
    assert mgr.list_steps() == [1, 2]
    assert mgr.verify(1) and mgr.verify(2)


def test_gc_cannot_delete_shards_of_inflight_save(tmp_path, state,
                                                  monkeypatch):
    """The writer has written a new shard but not yet its manifest; a
    concurrent GC must leave the in-flight (pinned) shard alone."""
    arch, params, opt = state
    mgr = CheckpointManager(str(tmp_path), num_layers=arch.num_layers,
                            async_mode=True, keep=1)
    mgr.save(TrainState(1, params, opt, {}, 0))
    mgr.wait()

    written = threading.Event()
    resume = threading.Event()
    orig = ckpt_mod._save_manifest

    def stalling(path, meta):
        written.set()               # every shard is durably on disk...
        resume.wait(timeout=30)     # ...but the manifest is not
        orig(path, meta)
    monkeypatch.setattr(ckpt_mod, "_save_manifest", stalling)

    changed = _bump_layer(params, 2)
    mgr.save(TrainState(2, changed, opt, {}, 0))
    assert written.wait(timeout=30)
    new_hash = ckpt_mod.record_hash(mgr._snapshot(
        TrainState(2, changed, opt, {}, 0))["shards"][2][1])
    assert os.path.exists(mgr._shard_path(new_hash))
    mgr.gc()                        # the racing collector
    assert os.path.exists(mgr._shard_path(new_hash)), \
        "GC deleted a shard the in-flight save references"
    resume.set()
    mgr.wait()
    assert mgr.list_steps() == [2]  # keep=1 dropped step 1 afterwards
    assert mgr.verify(2), "in-flight step ended up corrupt"
    r = mgr.restore(changed, opt, step=2, device="cpu")
    _assert_trees_equal(changed, r.params)


def test_background_failure_surfaces_on_wait(tmp_path, state, monkeypatch):
    arch, params, opt = state
    mgr = CheckpointManager(str(tmp_path), num_layers=arch.num_layers,
                            async_mode=True)

    def boom(path, rec):
        raise OSError("disk full")
    monkeypatch.setattr(ckpt_mod, "_save_npz", boom)
    mgr.save(TrainState(1, params, opt, {}, 0))
    with pytest.raises(CheckpointError):
        mgr.wait()
    assert mgr.list_steps() == []   # no manifest -> the step is invisible


def test_verify_returns_false_on_corrupt_shard(tmp_path, state):
    arch, params, opt = state
    mgr = CheckpointManager(str(tmp_path), num_layers=arch.num_layers,
                            async_mode=False)
    mgr.save(TrainState(1, params, opt, {}, 0))
    assert mgr.verify(1)
    victim = mgr._shard_path(mgr._read_manifest(1)["layers"][0]["hash"])
    with open(victim, "r+b") as f:
        f.truncate(16)                  # not even a valid zip any more
    assert mgr.verify(1) is False


def test_record_hash_is_content_based():
    rec = {"p['w']": np.arange(6, dtype=np.float32).reshape(2, 3)}
    same = {"p['w']": np.arange(6, dtype=np.float32).reshape(2, 3)}
    other = {"p['w']": np.arange(6, dtype=np.float32).reshape(3, 2)}
    assert record_hash(rec) == record_hash(same)
    assert record_hash(rec) != record_hash(other)      # shape matters
    assert record_hash(rec) != record_hash(
        {"p['w']": rec["p['w']"].astype(np.float64)})  # dtype matters


def _port_engine(profile, n):
    return OobleckEngine(profile, [f"n{i}" for i in range(n)],
                         EngineConfig(fault_tolerance=1, global_batch=GB,
                                      microbatch=MB, gpus_per_node=1,
                                      n0_override=2))


def test_restore_maps_onto_a_different_template_layout(tmp_path):
    """Saved under one template set, rebound under another (a different
    node count, so different stage tilings): the manifest indexes
    layers, not templates."""
    arch = reduced(get_arch("gpt3_medium"), layers=4)
    model = Model(arch, dtype=torch.float32, attn_impl="naive")
    params = model.init(torch.Generator().manual_seed(3))
    profile = build_profile(arch, microbatch=MB, seq_len=SEQ)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, weight_decay=0.0)
    saver = HeteroTrainer(model, _port_engine(profile, 5), params, opt_cfg,
                          mode="eager")
    snap = saver.snapshot(data_state={"cursor": 1}, rng_seed=7)
    mgr = CheckpointManager(str(tmp_path), num_layers=arch.num_layers,
                            async_mode=False)
    mgr.save(snap)
    restored = mgr.restore(snap.params, adamw.init(snap.params),
                           device="cpu")
    rebound = HeteroTrainer(model, _port_engine(profile, 4), restored.params,
                            opt_cfg, mode="eager")
    _assert_trees_equal(rebound.full_params(), snap.params)


def test_nonwriter_saves_shards_but_skips_manifest_and_gc(tmp_path, state):
    """Every process writes content-addressed shards; only the elected
    writer commits the per-step MANIFEST and runs gc."""
    arch, params, opt = state
    w = CheckpointManager(str(tmp_path), num_layers=arch.num_layers,
                          async_mode=False, keep=1, process_id="proc0",
                          manifest_writer=True)
    nw = CheckpointManager(str(tmp_path), num_layers=arch.num_layers,
                           async_mode=False, keep=1, process_id="proc1",
                           manifest_writer=False)
    st1 = TrainState(1, params, opt, {}, 0)
    nw.save(st1)
    assert nw.stats["manifests_skipped"] == 1
    assert nw.stats["saved_shards"] == arch.num_layers + 1
    assert nw.list_steps() == []
    w.save(st1)
    assert w.stats["skipped_shards"] == arch.num_layers + 1
    assert w.stats["saved_shards"] == 0
    assert w.list_steps() == [1] and nw.list_steps() == [1]
    assert w.verify(1) and nw.verify(1)
    nw.save(TrainState(2, _bump_layer(params, 0), opt, {}, 0))
    assert nw.stats["gc_steps"] == 0 and nw.stats["gc_shards"] == 0
    assert w.verify(1)
    w.save(TrainState(2, _bump_layer(params, 0), opt, {}, 0))
    assert w.list_steps() == [2] and w.verify(2)


def test_two_concurrent_writers_same_step_tolerate_manifest_race(
        tmp_path, state, monkeypatch):
    """Two processes that both believe they are the writer: the loser of
    the manifest rename counts a race, and the step verifies."""
    arch, params, opt = state
    a = CheckpointManager(str(tmp_path), num_layers=arch.num_layers,
                          async_mode=False, process_id="proc0")
    b = CheckpointManager(str(tmp_path), num_layers=arch.num_layers,
                          async_mode=False, process_id="proc1")
    st = TrainState(5, params, opt, {}, 0)
    real_rename = os.rename
    fired = {"done": False}

    def racing(srcp, dstp):
        if not fired["done"] and dstp == b._step_dir(5):
            fired["done"] = True
            a.save(st)
        return real_rename(srcp, dstp)
    monkeypatch.setattr(ckpt_mod.os, "rename", racing)
    b.save(st)
    assert b.stats["manifest_races"] == 1
    assert a.stats["manifest_races"] == 0
    assert a.list_steps() == [5] and b.list_steps() == [5]
    assert a.verify(5) and b.verify(5)
    restored = b.restore(st.params, st.opt_state, device="cpu")
    _assert_trees_equal(restored.params, st.params)


def test_elect_writer_matches_coordinator_view():
    assert elect_writer({"proc3", "proc1", "proc2"}) == "proc1"
    with pytest.raises(ValueError):
        elect_writer(set())


# ----------------------------------------------------------------------
# The keystr spelling the format depends on
# ----------------------------------------------------------------------
def _trees():
    jarch = jreduced(jget_arch("gpt3_medium"), layers=2)
    jp = JModel(jarch, dtype=jnp.float32, remat=False).init(
        jax.random.PRNGKey(1))
    jm = jreduced(jget_arch("mamba2_780m"), layers=1)
    jmp = JModel(jm, dtype=jnp.float32, remat=False).init(
        jax.random.PRNGKey(1))
    return {"gpt3-params": jp, "mamba2-params": jmp,
            "adamw-state": jadamw.init(jp),
            "root-leaf": np.zeros(3, np.float32),
            "lists-tuples-ints": {"b": [np.ones(1), (np.ones(2), {3: np.ones(1),
                                                                  1: np.ones(1)})],
                                  "a": np.ones(1)}}


@pytest.mark.parametrize("name", ["gpt3-params", "mamba2-params",
                                  "adamw-state", "root-leaf",
                                  "lists-tuples-ints"])
def test_keystr_and_flatten_order_match_jax(name):
    """Each leaf's path prints as jax.tree_util.keystr prints it, in
    jax.tree_util.tree_flatten_with_path's order — on the port's own
    trees (AdamWState's fields as ``.step``, ``.m``, ``.v``)."""
    tree = _trees()[name]
    want = [(jax.tree_util.keystr(p), np.asarray(leaf)) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    port_tree = jax.tree.map(np.asarray, tree)
    if name == "adamw-state":
        s = port_tree
        port_tree = adamw.AdamWState(torch.from_numpy(np.array(s.step)),
                                     params_from_numpy(s.m, "cpu"),
                                     params_from_numpy(s.v, "cpu"))
    got = [(keystr(p), np.asarray(leaf)) for p, leaf in
           flatten_with_path(port_tree)]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert dict(tree_leaves_with_path(port_tree)).keys() == {
        k for k, _ in want}


# ----------------------------------------------------------------------
# Across the packages
# ----------------------------------------------------------------------
def _pair(layers=2):
    """The same reduced gpt3-medium, engine plan and weights in both."""
    jarch = jreduced(jget_arch("gpt3_medium"), layers=layers)
    arch = reduced(get_arch("gpt3_medium"), layers=layers)
    jmodel = JModel(jarch, dtype=jnp.float32, remat=False,
                    attn_impl="naive", scan_layers=False)
    model = Model(arch, dtype=torch.float32, attn_impl="naive")
    jparams = jmodel.init(jax.random.PRNGKey(11))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    cfg = dict(fault_tolerance=1, global_batch=GB, microbatch=MB,
               gpus_per_node=1, n0_override=2)
    nodes = [f"n{i}" for i in range(5)]
    ref_hw = jhw.HardwareSpec(**dataclasses.asdict(hw.H100))

    def engines():
        return (JEngine(jbuild_profile(jarch, microbatch=MB, seq_len=SEQ,
                                       hw=ref_hw), nodes, JEngineConfig(**cfg)),
                OobleckEngine(build_profile(arch, microbatch=MB, seq_len=SEQ),
                              nodes, EngineConfig(**cfg)))
    return jarch, jmodel, jparams, model, params, engines


def _microbatches(batch):
    n = batch["tokens"].shape[0] // MB
    return [{k: v[i * MB:(i + 1) * MB] for k, v in batch.items()
             if not k.startswith("_")} for i in range(n)]


def _step(trainer, disp, engine):
    batches = disp.next_step(engine.batch.minibatch_sizes())
    return float(trainer.train_step([_microbatches(b) for b in batches])
                 ["loss"])


def _listing(directory):
    shards = sorted(os.listdir(os.path.join(directory, "shards")))
    steps = sorted(n for n in os.listdir(directory) if n.startswith("step_"))
    manifests = {s: open(os.path.join(directory, s, "MANIFEST.json"),
                         "rb").read() for s in steps}
    return shards, manifests


@pytest.mark.parametrize("source", ["model-init", "trainer-snapshot"])
def test_same_state_gives_identical_shards_and_manifest(tmp_path, source):
    """The reference's Model.init state (or both trainers' snapshots of
    it, moments included), saved by each package: the same shard names
    and byte-identical MANIFEST.json files."""
    jarch, jmodel, jparams, model, params, engines = _pair()
    if source == "model-init":
        jstate = JTrainState(4, jparams, jadamw.init(jparams),
                             {"next_index": 8}, 3)
        tstate = TrainState(4, params, adamw.init(params), {"next_index": 8}, 3)
    else:
        jeng, eng = engines()
        jtr = JTrainer(jmodel, jeng, jparams, jadamw.AdamWConfig(**OPT))
        tr = HeteroTrainer(model, eng, params, adamw.AdamWConfig(**OPT))
        jstate = jtr.snapshot({"next_index": 8}, 3)
        tstate = tr.snapshot({"next_index": 8}, 3)
    JManager(str(tmp_path / "ref"), num_layers=jarch.num_layers,
             async_mode=False).save(jstate)
    CheckpointManager(str(tmp_path / "port"), num_layers=jarch.num_layers,
                      async_mode=False).save(tstate)
    ref, port = _listing(tmp_path / "ref"), _listing(tmp_path / "port")
    assert len(ref[0]) == jarch.num_layers + 1
    assert port == ref


def test_reference_checkpoint_restores_into_port(tmp_path):
    """A step on the reference, its snapshot saved by the reference's
    manager, restored by the port's bit for bit; then a step from the
    restored weights on each side agrees at the executor tolerances."""
    jarch, jmodel, jparams, model, params, engines = _pair()
    jeng, eng = engines()
    jtr = JTrainer(jmodel, jeng, jparams, jadamw.AdamWConfig(**OPT))
    jdisp = JDispenser(JSyntheticLM(jarch.vocab_size, SEQ, seed=5))
    _step(jtr, jdisp, jeng)
    snap = jtr.snapshot(jdisp.state(), 0)
    JManager(str(tmp_path), num_layers=jarch.num_layers,
             async_mode=False).save(snap)

    mgr = CheckpointManager(str(tmp_path), num_layers=jarch.num_layers)
    got = mgr.restore(params, adamw.init(params), device="cpu")
    assert got.step == 1 and got.data_state == jdisp.state()
    assert int(got.opt_state.step) == 1
    want = dict(tree_leaves_with_path(jax.tree.map(
        np.asarray, (snap.params, snap.opt_state.m, snap.opt_state.v))))
    have = dict(tree_leaves_with_path(to_numpy(
        (got.params, got.opt_state.m, got.opt_state.v))))
    assert want.keys() == have.keys()
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)

    # both sides rebuild a trainer from the restored weights (the
    # reference's HeteroTrainer takes params only) and take a step
    jeng2, eng2 = engines()
    jtr2 = JTrainer(jmodel, jeng2, snap.params, jadamw.AdamWConfig(**OPT))
    tr2 = HeteroTrainer(model, eng2, got.params, adamw.AdamWConfig(**OPT))
    jd, td = (JDispenser(JSyntheticLM(jarch.vocab_size, SEQ, seed=5)),
              GlobalBatchDispenser(SyntheticLM(jarch.vocab_size, SEQ, seed=5)))
    jd.restore(snap.data_state)
    td.restore(got.data_state)
    np.testing.assert_allclose(_step(tr2, td, eng2), _step(jtr2, jd, jeng2),
                               **TOL)
    _assert_params_track(to_numpy(tr2.full_params()),
                         jax.tree.map(np.asarray, jtr2.full_params()))


def test_port_checkpoint_restores_into_reference(tmp_path):
    """A step on the port, saved by the port's manager (asynchronously),
    restored by the reference's CheckpointManager.restore bit for bit;
    the next step agrees across the packages."""
    jarch, jmodel, jparams, model, params, engines = _pair()
    jeng, eng = engines()
    tr = HeteroTrainer(model, eng, params, adamw.AdamWConfig(**OPT))
    disp = GlobalBatchDispenser(SyntheticLM(jarch.vocab_size, SEQ, seed=5))
    _step(tr, disp, eng)
    snap = tr.snapshot(disp.state(), 0)
    mgr = CheckpointManager(str(tmp_path), num_layers=jarch.num_layers)
    mgr.save(snap)
    mgr.wait()

    got = JManager(str(tmp_path), num_layers=jarch.num_layers).restore(
        jparams, jadamw.init(jparams))
    assert got.step == 1 and got.data_state == disp.state()
    assert int(got.opt_state.step) == 1
    want = dict(tree_leaves_with_path(to_numpy(
        (snap.params, snap.opt_state.m, snap.opt_state.v))))
    have = dict(tree_leaves_with_path(jax.tree.map(
        np.asarray, (got.params, got.opt_state.m, got.opt_state.v))))
    assert want.keys() == have.keys()
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)

    jtr = JTrainer(jmodel, jeng, jax.tree.map(jnp.asarray, got.params),
                   jadamw.AdamWConfig(**OPT))
    tr2 = HeteroTrainer(model, engines()[1], snap.params,
                        adamw.AdamWConfig(**OPT))
    jd, td = (JDispenser(JSyntheticLM(jarch.vocab_size, SEQ, seed=5)),
              GlobalBatchDispenser(SyntheticLM(jarch.vocab_size, SEQ, seed=5)))
    jd.restore(got.data_state)
    td.restore(snap.data_state)
    np.testing.assert_allclose(_step(tr2, td, tr2.engine),
                               _step(jtr, jd, jeng), **TOL)


def _assert_params_track(a, b, lr=LR):
    """tests/test_executor.py's rule for parameters after an Adam step."""
    la, lb = dict(tree_leaves_with_path(a)), dict(tree_leaves_with_path(b))
    assert la.keys() == lb.keys()
    for k in la:
        diff = np.abs(la[k] - lb[k])
        assert diff.max() <= 2.5 * lr, (k, diff.max())
        assert (diff > lr / 10).mean() < 1e-3, (k, (diff > lr / 10).mean())


def test_manifest_is_json_the_reference_reads(tmp_path, state):
    """The port's MANIFEST.json carries the reference's keys in its
    order, and opt_step is a 0-d int32."""
    arch, params, opt = state
    mgr = CheckpointManager(str(tmp_path), num_layers=arch.num_layers,
                            async_mode=False)
    mgr.save(TrainState(2, params, opt, {"next_index": 4}, 9))
    meta = json.load(open(os.path.join(mgr._step_dir(2), "MANIFEST.json")))
    assert list(meta) == ["step", "num_layers", "data_state", "rng_seed",
                          "layers", "extra"]
    extra = mgr._load_shard(meta["extra"]["hash"])
    assert extra["opt_step"].dtype == np.int32 and extra["opt_step"].shape == ()
    assert "p/embed['table']" in extra and "v/final_norm" in extra
    assert "p['attn']['wq']" in mgr.layer_record(2, 0)
