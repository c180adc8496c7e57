"""The port's single-program fast path (``repro_torch.runtime.spmd``).

First the reference's own contracts, ported
(tests/test_executor.py:214-247, tests/test_fault_injection.py:214-314):
steady state reuses ONE program, ``recover``/``join`` raise
``ExecutorUnsupported``, the snapshot survives later steps, a monitor
FAIL still updates the engine's plan, a kill rebinds a ``HeteroTrainer``
from the snapshot bit-identically, and the executor conforms to the
interface beside the trainer and the simulator policy.  Then the port's
``SPMDExecutor`` against the JAX package's on the same weights and
batches: reduced gpt3-medium (remat and the chunked CE) and reduced
granite-moe, three steps, losses at tests/test_executor.py's fp32
tolerance and parameters by its tracking rule."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import Model as JModel
from repro.optim import adamw as jadamw
from repro.runtime import SPMDExecutor as JSPMDExecutor

from repro_torch.configs import ShapeConfig, get_arch, reduced
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.core import (EngineConfig, OobleckEngine, build_profile,
                              verify_replica_coverage)
from repro_torch.core.monitor import NodeChangeMonitor
from repro_torch.data import GlobalBatchDispenser, SyntheticLM
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.runtime import (Executor, ExecutorUnsupported,
                                 HeteroTrainer, ShardingStrategy,
                                 SPMDExecutor, track_compiles)
from repro_torch.sim import OobleckPolicy
from repro_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

GB, MB, SEQ = 16, 2, 16
#: tests/test_executor.py's fp32 tolerance (tree_allclose_ulp)
ATOL, RTOL = 5e-7, 5e-4


def make_setup(n_nodes=5, f=1, layers=4, lr=1e-3):
    arch = reduced(get_arch("gpt3_medium"), layers=layers)
    model = Model(arch, dtype=torch.float32, remat=False, attn_impl="naive")
    params = model.init(torch.Generator().manual_seed(11))
    profile = build_profile(arch, microbatch=MB, seq_len=SEQ)
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=0, clip_norm=1.0,
                                weight_decay=0.0)

    def mk_engine():
        return OobleckEngine(
            profile, [f"n{i}" for i in range(n_nodes)],
            EngineConfig(fault_tolerance=f, global_batch=GB, microbatch=MB,
                         gpus_per_node=1, n0_override=2))
    return arch, model, params, opt_cfg, mk_engine


def microbatches(batch, mb_size):
    n = batch["tokens"].shape[0] // mb_size
    return [{k: v[i * mb_size:(i + 1) * mb_size] for k, v in batch.items()
             if not k.startswith("_")} for i in range(n)]


def drive(trainer, disp):
    batches = disp.next_step(trainer.engine.batch.minibatch_sizes())
    return trainer.train_step([microbatches(b, MB) for b in batches])


def assert_trees_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def _sim_profile():
    import dataclasses
    arch = dataclasses.replace(get_arch("gpt2"), name="gpt2_L18",
                               num_layers=18)
    return build_profile(arch, microbatch=2, seq_len=256)


# ----------------------------------------------------------------------
# The reference's contracts
# ----------------------------------------------------------------------
def test_spmd_executor_trains_and_refuses_reconfig():
    _, model, params, _, _ = make_setup(layers=2)
    arch = model.arch
    opt_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0, weight_decay=0.0)
    ex = SPMDExecutor(model, params, opt_cfg)
    assert isinstance(ex, Executor)
    src = SyntheticLM(arch.vocab_size, SEQ, seed=2)
    batch = src.batch(np.arange(8))    # fixed batch: loss must overfit
    losses = [float(ex.step(batch)["loss"]) for _ in range(4)]
    assert ex.cache.stats.compiles == 1, "steady state must reuse ONE program"
    assert losses[-1] < losses[0]
    with pytest.raises(ExecutorUnsupported):
        ex.recover({"node0"})
    with pytest.raises(ExecutorUnsupported):
        ex.join(["fresh0"])
    snap = ex.snapshot()
    assert snap.step == 4
    # snapshot leaves survive later (in-place) steps
    emb = snap.params["embed"]["table"].clone()
    m = snap.opt_state.m["embed"]["table"].clone()
    ex.step(src.batch(np.arange(8)))
    assert torch.equal(emb, snap.params["embed"]["table"])
    assert torch.equal(m, snap.opt_state.m["embed"]["table"])
    assert not torch.equal(emb, ex.params["embed"]["table"])
    # the executor owns its state: the caller's params are untouched
    assert not torch.equal(params["embed"]["table"],
                           ex.params["embed"]["table"])


def test_monitor_failure_with_spmd_executor_still_updates_plan():
    """A FAIL routed to an executor that cannot reconfigure must still
    update the engine's PLAN; the caller then rebinds a HeteroTrainer
    from snapshot() against it."""
    _, model, params, opt_cfg, mk_engine = make_setup()
    engine = mk_engine()
    ex = SPMDExecutor(model, params, opt_cfg, engine=engine)
    assert engine.executor is ex
    victim = engine.instances[0].nodes[-1]
    engine.monitor.inject(NodeChangeMonitor.FAIL, [victim])
    engine.monitor.poll(now=0.0)
    assert victim not in set(engine.nodes)
    assert engine.metrics.reconfigurations == 1


def test_spmd_kill_rebinds_hetero_bit_identical():
    _, model, params, opt_cfg, mk_engine = make_setup(layers=2)
    arch = model.arch
    engine = mk_engine()
    ex = SPMDExecutor(model, params, opt_cfg, engine=engine)
    src = SyntheticLM(arch.vocab_size, SEQ, seed=23)
    ex.step(src.batch(np.arange(8)))
    with pytest.raises(ExecutorUnsupported):
        ex.recover({engine.instances[0].nodes[-1]})

    victim = engine.instances[0].nodes[-1]
    engine.monitor.inject(NodeChangeMonitor.FAIL, [victim])
    engine.monitor.poll(now=0.0)
    assert victim not in engine.nodes
    assert verify_replica_coverage(engine.instances)

    snap = ex.snapshot()
    for mode in ("eager", "compiled"):
        rebound = HeteroTrainer(model, engine, snap.params, opt_cfg,
                                mode=mode, opt_state=snap.opt_state)
        assert_trees_equal(rebound.full_params(), snap.params)
        assert rebound.replica_divergence() == 0.0
        out = drive(rebound, GlobalBatchDispenser(src))
        assert np.isfinite(float(out["loss"]))


@pytest.mark.parametrize("kind", ["hetero", "spmd", "sim"])
def test_executor_interface_conformance(kind):
    _, model, params, opt_cfg, mk_engine = make_setup(layers=2)
    if kind == "hetero":
        ex = HeteroTrainer(model, mk_engine(), params, opt_cfg, mode="eager")
    elif kind == "spmd":
        ex = SPMDExecutor(model, params, opt_cfg, engine=mk_engine())
    else:
        ex = OobleckPolicy(_sim_profile(), [f"n{i}" for i in range(10)],
                           f=1, global_batch=256, microbatch=2, n0=4)
    assert isinstance(ex, Executor)
    for method in ("bind", "step", "recover", "join", "snapshot"):
        assert callable(getattr(ex, method))
    victim = ex.engine.instances[0].nodes[-1]
    if kind == "spmd":
        with pytest.raises(ExecutorUnsupported):
            ex.recover({victim})
    else:
        out = ex.recover({victim})
        assert isinstance(out, dict)
        assert victim not in ex.engine.nodes
        assert verify_replica_coverage(ex.engine.instances)


# ----------------------------------------------------------------------
# The port's program cache, mesh boundary and state bytes
# ----------------------------------------------------------------------
def test_bind_builds_the_program_up_front_and_steps_build_nothing():
    _, model, params, opt_cfg, _ = make_setup(layers=2)
    shape = ShapeConfig("t", SEQ, 8, "train")
    ex = SPMDExecutor(model, params, opt_cfg, shape=shape)
    assert ex.cache.stats.compiles == 1
    src = SyntheticLM(model.arch.vocab_size, SEQ, seed=3)
    with track_compiles() as log:
        for i in range(3):
            ex.step(src.batch(np.arange(8 * i, 8 * i + 8)))
    assert log.backend_compiles == 0
    assert ex.cache.stats.as_dict() == {"compiles": 1, "hits": 3}


def test_mesh_of_size_one_is_accepted_and_larger_raises_item_17b():
    _, model, params, opt_cfg, _ = make_setup(layers=2)
    shape = ShapeConfig("t", SEQ, 8, "train")
    one = make_mesh((1, 1), ("data", "model"))
    src = SyntheticLM(model.arch.vocab_size, SEQ, seed=4)
    batch = src.batch(np.arange(8))
    a = SPMDExecutor(model, params, opt_cfg, mesh=one,
                     strategy=ShardingStrategy(), shape=shape)
    b = SPMDExecutor(model, params, opt_cfg)
    assert torch.equal(a.step(batch)["loss"], b.step(batch)["loss"])
    assert_trees_equal(a.params, b.params)
    # a larger mesh runs over a ProcessMesh (tests/test_torch_spmd_mesh.py,
    # tests/test_torch_spmd_seq.py for a batch that leaves a batch axis
    # uncovered, tests/test_torch_spmd_tp.py and
    # tests/test_torch_spmd_tp_ssm.py for TP, the Mamba2 mixer's too)
    with pytest.raises(TypeError, match="ProcessMesh"):
        SPMDExecutor(model, params, opt_cfg,
                     mesh=make_mesh((1, 2), ("data", "model")),
                     strategy=ShardingStrategy(strategy="tp"), shape=shape)
    mamba = Model(reduced(get_arch("mamba2_780m"), layers=2),
                  dtype=torch.float32)
    with pytest.raises(TypeError, match="ProcessMesh"):
        SPMDExecutor(mamba, mamba.init(torch.Generator().manual_seed(0)),
                     opt_cfg, mesh=make_mesh((1, 2), ("data", "model")),
                     strategy=ShardingStrategy(strategy="tp"), shape=shape)
    with pytest.raises(TypeError, match="ProcessMesh"):
        SPMDExecutor(model, params, opt_cfg,
                     mesh=make_mesh((2, 2), ("data", "model")),
                     strategy=ShardingStrategy(),
                     shape=ShapeConfig("t", SEQ, 2, "train"))


def test_state_bytes_equal_the_dry_run_args_less_the_batch():
    """What the card's phase 13 asserts of memory_allocated(): the
    executor's params, moments and step are the dry-run's args on a 1x1
    mesh, less the batch."""
    _, model, params, opt_cfg, _ = make_setup(layers=2)
    shape = ShapeConfig("t", SEQ, 8, "train")
    ex = SPMDExecutor(model, params, opt_cfg, shape=shape)
    held = sum(t.numel() * t.element_size() for t in
               tree_leaves((ex.params, ex.opt_state)))
    b = dryrun.spec_bytes(model.arch, shape, make_mesh((1, 1),
                                                       ("data", "model")),
                          ShardingStrategy(), model=model)
    assert held == b["args"] - b["batch"]
    assert b["batch"] == 2 * 8 * SEQ * 4


# ----------------------------------------------------------------------
# Against the JAX package's SPMDExecutor
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name,remat,loss_chunk", [
    ("gpt3_medium", True, 8), ("granite_moe_1b_a400m", False, 0)])
def test_tracks_the_reference_spmd_executor(name, remat, loss_chunk):
    lr = 1e-3
    jarch = jreduced(jget_arch(name), layers=2)
    jmodel = JModel(jarch, dtype=jnp.float32, remat=remat,
                    attn_impl="naive", loss_chunk=loss_chunk)
    jparams = jmodel.init(jax.random.PRNGKey(7))
    opt = dict(lr=lr, warmup_steps=0, clip_norm=1.0, weight_decay=0.0)
    jex = JSPMDExecutor(jmodel, jparams, jadamw.AdamWConfig(**opt))
    model = Model(reduced(get_arch(name), layers=2), dtype=torch.float32,
                  remat=remat, attn_impl="naive", loss_chunk=loss_chunk)
    ex = SPMDExecutor(model, params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu"), adamw.AdamWConfig(**opt))
    src = JSyntheticLM(jarch.vocab_size, SEQ, seed=9)
    for step in range(3):
        batch = src.batch(np.arange(8 * step, 8 * step + 8))
        jl = float(jex.step(batch)["loss"])
        pl = float(ex.step(batch)["loss"])
        np.testing.assert_allclose(pl, jl, atol=ATOL, rtol=RTOL)
    for x, y in zip(jax.tree.leaves(jax.tree.map(np.asarray, jex.params)),
                    tree_leaves(to_numpy(ex.params))):
        diff = np.abs(x - y)
        # tests/test_executor.py::assert_params_track
        assert diff.max() <= 2.5 * lr, diff.max()
        assert (diff > lr / 10).mean() < 1e-3
    assert ex.cache.stats.compiles == 1
