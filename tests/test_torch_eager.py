"""The port's eager 1F1B walker (``HeteroTrainer(mode="eager")``) and
the executor trackers.

The walker runs each stage with per-stage autograd over the explicit
1F1B schedule; it must give what the per-template step programs give —
bitwise on the CPU: the same ops per stage, the boundary cotangent
summed as the whole-model backward sums it, microbatch gradients summed
in ascending order and divided by M — and track the JAX package's eager
HeteroTrainer through a failure (losses at rtol 1e-4 as
tests/test_torch_trainer.py, parameters by tests/test_executor.py's
rule).  Like the reference's, the eager mode syncs on the per-layer path
and the compiled mode on the bucketed plane by default; with a clip
norm the two planes sum the global norm's squares in another order
(per bucket, then across buckets), so across those defaults the
trajectories agree to the executor tolerances and are bitwise equal
only where the orders happen to coincide.  ``track_host_transfers``
reads 0 inside a train step in both modes (tests/test_executor.py:
184-207), and ``track_compiles`` reads 0 across recover + step for a
warmed set."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.core import EngineConfig as JEngineConfig
from repro.core import OobleckEngine as JEngine
from repro.core import build_profile as jbuild_profile
from repro.models import Model as JModel
from repro.optim import adamw as jadamw
from repro.runtime import HeteroTrainer as JTrainer
from repro.utils import hw as jhw

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.core import EngineConfig, OobleckEngine, build_profile
from repro_torch.data import GlobalBatchDispenser, SyntheticLM
from repro_torch.kernels import build
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.runtime import (CompileCounter, HeteroTrainer, ProgramCache,
                                 track_compiles, track_host_transfers)
from repro_torch.runtime.schedule import flat_schedule
from repro_torch.utils import hw
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

GB, MB, SEQ, LR = 16, 2, 16, 1e-3
OPT = dict(lr=LR, warmup_steps=0, clip_norm=1.0, weight_decay=0.0)


def _microbatches(batch):
    n = batch["tokens"].shape[0] // MB
    return [{k: v[i * MB:(i + 1) * MB] for k, v in batch.items()
             if not k.startswith("_")} for i in range(n)]


def _setup(arch_name="gpt3_medium", layers=4, attn_impl="naive",
           ssd_impl="chunked", n_nodes=5):
    arch = reduced(get_arch(arch_name), layers=layers)
    model = Model(arch, dtype=torch.float32, attn_impl=attn_impl,
                  ssd_impl=ssd_impl)
    params = model.init(torch.Generator().manual_seed(11))
    profile = build_profile(arch, microbatch=MB, seq_len=SEQ)

    def trainer(mode, sync_mode=None):
        engine = OobleckEngine(
            profile, [f"n{i}" for i in range(n_nodes)],
            EngineConfig(fault_tolerance=1, global_batch=GB, microbatch=MB,
                         gpus_per_node=1, n0_override=2))
        return HeteroTrainer(model, engine, params, adamw.AdamWConfig(**OPT),
                             mode=mode, sync_mode=sync_mode)

    def dispenser():
        return GlobalBatchDispenser(SyntheticLM(arch.vocab_size, SEQ, seed=5))
    return trainer, dispenser


def _batches(tr, disp):
    return [_microbatches(b)
            for b in disp.next_step(tr.engine.batch.minibatch_sizes())]


ARCHS = [
    pytest.param("gpt3_medium", "naive", "chunked", id="naive"),
    pytest.param("gpt3_medium", "kernel", "chunked", id="kernel"),
    pytest.param("mamba2_780m", "naive", "kernel", id="mamba2-ssd-kernel")]


def _arch_setup(arch_name, attn_impl, ssd_impl):
    return _setup(arch_name, 4 if arch_name == "gpt3_medium" else 2,
                  attn_impl, ssd_impl)


@pytest.mark.parametrize("arch_name,attn_impl,ssd_impl", ARCHS)
def test_eager_walker_bitwise_equals_compiled(arch_name, attn_impl, ssd_impl):
    """On the same sync path, per pipeline and microbatch the walker's
    NLL and per-layer gradients are bitwise the step program's; so are
    the losses and the parameters over 3 steps with a node killed before
    the last."""
    trainer, dispenser = _arch_setup(arch_name, attn_impl, ssd_impl)
    tc, te = trainer("compiled", "perlayer"), trainer("eager")
    assert te.sync_mode == "perlayer"
    assert max(r.num_stages for r in te.runs) >= 2
    dc, de = dispenser(), dispenser()
    for step in range(3):
        if step == 2:
            victim = tc.engine.instances[0].nodes[0]
            tc.recover({victim})
            te.recover({victim})
        bc, be = _batches(tc, dc), _batches(te, de)
        for rc, re_, mc, me in zip(tc.runs, te.runs, bc, be):
            gc, nc = tc._run_pipeline(rc, mc)
            ge, ne = te._run_pipeline(re_, me)
            assert torch.equal(nc, ne)
            assert sorted(gc) == sorted(ge)
            for l in gc:
                for a, b in zip(tree_leaves(gc[l]), tree_leaves(ge[l])):
                    assert torch.equal(a, b), l
        assert torch.equal(tc.train_step(bc)["loss"],
                           te.train_step(be)["loss"])
    for a, b in zip(tree_leaves(tc.full_params()),
                    tree_leaves(te.full_params())):
        assert torch.equal(a, b)
    assert tc.replica_divergence() == te.replica_divergence() == 0.0


@pytest.mark.parametrize("arch_name,attn_impl,ssd_impl", ARCHS)
def test_eager_walker_tracks_compiled_on_their_default_sync(
        arch_name, attn_impl, ssd_impl):
    """Each mode on its default sync plane (eager per-layer, compiled
    bucketed), through a failure: losses at the executor's fp32
    tolerance, parameters by its rule, replicas identical."""
    trainer, dispenser = _arch_setup(arch_name, attn_impl, ssd_impl)
    tc, te = trainer("compiled"), trainer("eager")
    assert (tc.sync_mode, te.sync_mode) == ("bucketed", "perlayer")
    dc, de = dispenser(), dispenser()
    for step in range(3):
        if step == 2:
            victim = tc.engine.instances[0].nodes[0]
            tc.recover({victim})
            te.recover({victim})
        np.testing.assert_allclose(
            float(tc.train_step(_batches(tc, dc))["loss"]),
            float(te.train_step(_batches(te, de))["loss"]),
            atol=5e-7, rtol=5e-4)
    for a, b in zip(tree_leaves(to_numpy(tc.full_params())),
                    tree_leaves(to_numpy(te.full_params()))):
        diff = np.abs(a - b)
        assert diff.max() <= 2.5 * LR, diff.max()
        assert (diff > LR / 10).mean() < 1e-3
    assert tc.replica_divergence() == te.replica_divergence() == 0.0


def test_eager_walker_tracks_reference_eager_through_failure():
    """The port's walker against the JAX package's eager HeteroTrainer on
    the same weights, plan and batches, a node killed before step 2."""
    jarch = jreduced(jget_arch("gpt3_medium"), layers=4)
    arch = reduced(get_arch("gpt3_medium"), layers=4)
    jmodel = JModel(jarch, dtype=jnp.float32, remat=False, attn_impl="naive",
                    scan_layers=False)
    model = Model(arch, dtype=torch.float32, attn_impl="naive")
    jparams = jmodel.init(jax.random.PRNGKey(11))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    cfg = dict(fault_tolerance=1, global_batch=GB, microbatch=MB,
               gpus_per_node=1, n0_override=2)
    nodes = [f"n{i}" for i in range(5)]
    ref_hw = jhw.HardwareSpec(**dataclasses.asdict(hw.H100))
    jeng = JEngine(jbuild_profile(jarch, microbatch=MB, seq_len=SEQ,
                                  hw=ref_hw), nodes, JEngineConfig(**cfg))
    eng = OobleckEngine(build_profile(arch, microbatch=MB, seq_len=SEQ),
                        nodes, EngineConfig(**cfg))
    jtr = JTrainer(jmodel, jeng, jparams, jadamw.AdamWConfig(**OPT),
                   mode="eager")
    tr = HeteroTrainer(model, eng, params, adamw.AdamWConfig(**OPT),
                       mode="eager")
    jdisp = GlobalBatchDispenser(SyntheticLM(arch.vocab_size, SEQ, seed=5))
    disp = GlobalBatchDispenser(SyntheticLM(arch.vocab_size, SEQ, seed=5))
    for step in range(3):
        if step == 2:
            victim = eng.instances[0].nodes[0]
            jinfo, info = jtr.recover({victim}), tr.recover({victim})
            assert info["copied_bytes"] == jinfo["copied_bytes"]
            assert eng.plan_fingerprint() == jeng.plan_fingerprint()
        jout = jtr.train_step(_batches(jtr, jdisp))
        out = tr.train_step(_batches(tr, disp))
        np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]),
                                   rtol=1e-4)
        assert tr.replica_divergence() == 0.0
    want = dict(tree_leaves_with_path(jax.tree.map(np.asarray,
                                                   jtr.full_params())))
    got = dict(tree_leaves_with_path(to_numpy(tr.full_params())))
    assert want.keys() == got.keys()
    for k in want:
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 2.5 * LR, (k, diff.max())
        assert (diff > LR / 10).mean() < 1e-3, k


def test_eager_walker_walks_the_1f1b_schedule(monkeypatch):
    """The walker's F and B ops are flat_schedule's, in its order, and
    the last stage's forwards come in ascending microbatch order (the
    NLL vector's order)."""
    from repro_torch.runtime import pipeline
    seen = []
    real = pipeline.flat_schedule

    def spy(S, M):
        out = real(S, M)
        seen.append((S, M, out))
        return out
    monkeypatch.setattr(pipeline, "flat_schedule", spy)
    trainer, dispenser = _setup(layers=4)
    te = trainer("eager")
    te.train_step(_batches(te, dispenser()))
    assert [(S, M) for S, M, _ in seen] == [
        (r.num_stages, M) for r, M in zip(te.runs,
                                          te.engine.batch.num_microbatches)]
    for S, M, sched in seen:
        assert sched == flat_schedule(S, M)
        last = [mb for s, op, mb in sched if s == S - 1 and op == "F"]
        assert last == sorted(last) == list(range(M))


@pytest.mark.parametrize("mode", ["compiled", "eager"])
def test_train_step_issues_no_host_transfers(mode):
    """Neither path reads the device back during a step: losses and
    metrics come back as tensors."""
    trainer, dispenser = _setup()
    tr, disp = trainer(mode), dispenser()
    tr.train_step(_batches(tr, disp))
    # control: the instrumentation catches each kind of read
    x = torch.ones(3)
    with track_host_transfers("cpu") as ctl:
        float(x.sum() + 1)
        x.tolist()
        x.numpy()
        bool(x[0] > 0)
    assert ctl.device_to_host == 4
    assert "item" not in torch.Tensor.__dict__          # spies removed
    batches = _batches(tr, disp)
    with track_host_transfers(tr.device) as log:
        out = tr.train_step(batches)
    assert log.device_to_host == 0, \
        f"{log.device_to_host} device->host reads inside a train step"
    assert float(out["loss"]) > 0       # a read AFTER the step is fine


@pytest.mark.parametrize("mode", ["compiled", "eager"])
def test_recover_step_is_build_free_for_warmed_set(mode):
    trainer, dispenser = _setup()
    tr, disp = trainer(mode), dispenser()
    stats = tr.warm_templates()
    if mode == "compiled":
        assert stats["compiles"] >= len(tr.engine.templates) * (GB // MB)
    tr.train_step(_batches(tr, disp))
    counter = CompileCounter()
    counter.mark()
    with track_compiles() as log:
        tr.recover({tr.engine.instances[0].nodes[-1]})
        tr.train_step(_batches(tr, disp))
    assert log.backend_compiles == 0, f"{log.backend_compiles} builds"
    assert counter.since_mark() == 0


def test_compile_trackers_count_every_cache_and_library_builds():
    """A build in ANY ProgramCache, and a compile of the kernel library
    (announced by kernels/build.py), counts; a hit does not."""
    counter = CompileCounter()
    with track_compiles() as log:
        cache = ProgramCache()
        cache.get_or_build("a", lambda: len)
        cache.get_or_build("a", lambda: len)
        ProgramCache().get_or_build("a", lambda: len)
        build.notify_build("library")
    assert log.backend_compiles == 3
    assert counter.count == 3
    ProgramCache().get_or_build("b", lambda: len)   # outside the block
    assert log.backend_compiles == 3 and counter.since_mark() == 4


def test_eager_walker_carries_the_aux_gradient_across_stages():
    """Reduced granite-moe (4 MoE blocks) on pipelines of 2 or more
    stages: every router's load-balance loss is part of the loss, so a
    router in a stage before the last gets its aux gradient only
    through the (x, aux) cotangent the walker hands back across the
    boundary.  Per pipeline and microbatch set, the walker's gradients
    (routers included) match the step program's at the executor's fp32
    tolerance (tests/test_executor.py: atol 5e-7, rtol 5e-4) and its
    NLL is bitwise the program's."""
    trainer, dispenser = _setup("granite_moe_1b_a400m", layers=4)
    tc, te = trainer("compiled", "perlayer"), trainer("eager")
    assert max(r.num_stages for r in te.runs) >= 2
    early = [l for r in te.runs for lids in r.stage_layers[:-1]
             for l in lids if "moe" in r.states[l]["p"]]
    assert early, "no router sits in a stage before the last"
    dc, de = dispenser(), dispenser()
    for rc, re_, mc, me in zip(tc.runs, te.runs, _batches(tc, dc),
                               _batches(te, de)):
        gc, nc = tc._run_pipeline(rc, mc)
        ge, ne = te._run_pipeline(re_, me)
        assert torch.equal(nc, ne)
        assert sorted(gc) == sorted(ge)
        for l in gc:
            for (path, a), (_, b) in zip(tree_leaves_with_path(gc[l]),
                                         tree_leaves_with_path(ge[l])):
                np.testing.assert_allclose(b.numpy(), a.numpy(), atol=5e-7,
                                           rtol=5e-4, err_msg=f"{l}{path}")
