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
import math

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


# ----------------------------------------------------------------------
# The update a piece at a time (apply_sharded)
# ----------------------------------------------------------------------
from repro_torch.runtime import spmd as tspmd  # noqa: E402

L = 3


def _stacked_tree(gen, dtype=torch.float32):
    """A block leaf [L, 8, 6], a stacked norm scale [L, 8] (ndim 2:
    decayed, where its slice [8] would not be), an embedding [50, 8]
    and a final norm [8]."""
    def rand(*shape):
        return torch.randn(shape, generator=gen).to(dtype)
    return {"blocks": {"w": rand(L, 8, 6), "norm": rand(L, 8)},
            "embed": rand(50, 8), "final": rand(8)}


def _opt_cfg():
    return adamw.AdamWConfig(lr=1e-2, weight_decay=0.1, clip_norm=0.5,
                             warmup_steps=1, total_steps=10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_apply_sharded_is_bitwise_adamw_apply_on_stacked_leaves(dtype):
    gen = torch.Generator().manual_seed(3)
    cfg = _opt_cfg()
    want = _stacked_tree(gen, dtype)
    got = {k: (v.clone() if isinstance(v, torch.Tensor) else
               {n: t.clone() for n, t in v.items()}) for k, v in want.items()}
    ws, gs = adamw.init(want), adamw.init(got)
    whole = [()] * len(tree_leaves(got))
    for _ in range(3):
        grads = _stacked_tree(gen)
        want, ws, wstats = adamw.apply(cfg, want, grads, ws)
        gs, gstats = tspmd.apply_sharded(cfg, None, got,
                                         tree_leaves(grads), gs, whole, whole)
        assert torch.equal(gstats["grad_norm"], wstats["grad_norm"])
    assert int(gs.step) == int(ws.step) == 3
    for tree_w, tree_g in ((want, got), (ws.m, gs.m), (ws.v, gs.v)):
        for x, y in zip(tree_leaves(tree_w), tree_leaves(tree_g)):
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("sliced", [False, True],
                         ids=["norm-whole", "norm-by-slice"])
def test_stacked_norm_scale_keeps_the_whole_leafs_decay(sliced):
    """With no gradient only weight decay moves a parameter: the stacked
    [L, d] norm scale moves (the whole leaf's ndim >= 2 rule), the final
    [d] norm does not; also where the norm is the tree's largest row and
    so is stepped one block slice at a time."""
    gen = torch.Generator().manual_seed(4)
    cfg = adamw.AdamWConfig(lr=1.0, weight_decay=0.5, clip_norm=0.0,
                            warmup_steps=0)
    p = _stacked_tree(gen)
    if sliced:
        p = {"blocks": {"norm": p["blocks"]["norm"]}, "final": p["final"]}
        assert tspmd.update_pieces([t.shape for t in tree_leaves(p)])[0] == [
            (i, i + 1) for i in range(L)]
    before = {"norm": p["blocks"]["norm"].clone(), "final": p["final"].clone()}
    zeros = [torch.zeros_like(t) for t in tree_leaves(p)]
    whole = [()] * len(zeros)
    tspmd.apply_sharded(cfg, None, p, zeros, adamw.init(p), whole, whole)
    assert torch.equal(p["final"], before["final"])
    assert torch.equal(p["blocks"]["norm"], before["norm"] * 0.5)


def test_update_sees_at_most_one_block_slice(monkeypatch):
    """A recording stub of ``adamw.update``: no call sees more elements
    than the largest block slice, the block leaf [L, 8, 6] is stepped
    one slice (dim 0 of 1) at a time, the small stacked norm [L, 8] in
    one piece, and the pieces cover every leaf."""
    gen = torch.Generator().manual_seed(5)
    p = _stacked_tree(gen)
    seen, real = [], adamw.update

    def record(cfg, params, grads, state, decay=None, scalars=None):
        seen.append((tuple(params[0].shape), tuple(decay)))
        return real(cfg, params, grads, state, decay, scalars)
    monkeypatch.setattr(adamw, "update", record)
    grads = _stacked_tree(gen)
    whole = [()] * len(tree_leaves(p))
    tspmd.apply_sharded(_opt_cfg(), None, p, tree_leaves(grads),
                        adamw.init(p), whole, whole)
    cap = 8 * 6                              # the largest block slice
    # leaves in tree order: blocks/norm, blocks/w, embed, final
    assert all(math.prod(s) <= cap for s, _ in seen)
    assert seen[:1 + L] == ([((L, 8), (True,))]
                            + [((1, 8, 6), (True,))] * L)
    rest = seen[1 + L:]
    assert sum(s[0] for s, d in rest if d == (True,)) == 50
    assert rest[-1] == ((8,), (False,))


class _Zero1Mesh:
    """One rank of data 2 whose all_gather records the piece it is
    handed and returns ``whole``, the gathered result."""

    def __init__(self, rank, whole):
        self.shape = {"data": 2}
        self.rank, self.gathered = rank, []
        mesh = self

        class _Transport:
            @staticmethod
            def all_gather(t, group, n, dim):
                mesh.gathered.append(t.clone())
                return whole
        self.transport = _Transport()

    def axis_index(self, axis):
        return self.rank

    def group(self, axes):
        return (None,)


@pytest.mark.parametrize("rank", [0, 1])
def test_zero1_moment_narrowed_on_dim0_is_bitwise(rank):
    """A replicated stacked leaf whose moments ZeRO-1 shards on dim 0
    (the stacked dim itself): the rank steps its block slices of the
    narrowed parameter, assembles them into one buffer before the
    all_gather, and its moments and gathered slice are ``adamw.apply``'s
    bit for bit."""
    gen = torch.Generator().manual_seed(6)
    cfg = _opt_cfg()
    w = torch.randn((4, 8, 6), generator=gen)
    g = torch.randn((4, 8, 6), generator=gen)
    want_p, want_s, _ = adamw.apply(cfg, {"blocks": {"w": w.clone()}},
                                    {"blocks": {"w": g}},
                                    adamw.init({"blocks": {"w": w}}))
    rows = slice(2 * rank, 2 * rank + 2)
    params = {"blocks": {"w": w.clone()}}
    state = adamw.AdamWState(torch.zeros((), dtype=torch.int32),
                             [torch.zeros(2, 8, 6)], [torch.zeros(2, 8, 6)])
    mesh = _Zero1Mesh(rank, want_p["blocks"]["w"])
    tspmd.apply_sharded(cfg, mesh, params, [g.clone()], state, [()],
                        [("data",)])
    (piece,) = mesh.gathered
    assert torch.equal(piece, want_p["blocks"]["w"][rows])
    assert torch.equal(state.m[0], want_s.m["blocks"]["w"][rows])
    assert torch.equal(state.v[0], want_s.v["blocks"]["w"][rows])
    assert torch.equal(params["blocks"]["w"], want_p["blocks"]["w"])


def test_dry_run_counts_the_update_temporaries():
    """``update_temp_bytes``: ``UPDATE_COPIES`` fp32 copies of the
    largest piece, the largest row of any leaf (here one block slice of
    the stacked leaf); every leaf is cut to pieces no larger, a small
    stacked one left whole; with no leaf of more than 2 dims the
    largest row is the embedding's."""
    shapes = [(3, 8, 6), (3, 8), (50, 8), (8,)]
    pieces = tspmd.update_pieces(shapes)
    assert pieces[0] == [(0, 1), (1, 2), (2, 3)]
    assert pieces[1] == [(0, 3)]
    assert pieces[2] == [(r, min(r + 6, 50)) for r in range(0, 50, 6)]
    assert pieces[3] == [(0, 8)]
    assert tspmd.update_temp_bytes(shapes) == tspmd.UPDATE_COPIES * 4 * 48
    assert tspmd.update_temp_bytes([(50, 8), (8,)]) == (
        tspmd.UPDATE_COPIES * 4 * 8)
    assert tspmd.update_pieces([()]) == [[(0, 0)]]
