"""The port's HeteroTrainer against the JAX package's on the same engine
inputs, weights and batches: 3 steps with a node killed before step 2,
with naive attention, with the flash path, for reduced mamba2 with the
SSD kernels (the JAX package's Pallas kernels interpreted, the port's
plain versions of its kernels), for reduced granite-moe (the routers'
aux loss in the loss) and for reduced phi3-vision with frontend
embeddings in every microbatch.
Losses match at rtol 1e-4, parameters track by the reference's own rule
(tests/test_executor.py::assert_params_track), replicas never diverge,
and recovery builds nothing after warm_templates().  Inside the port,
adapt and replan recoveries of a whole-replica kill are bitwise equal."""
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
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.runtime import ExecutorUnsupported, HeteroTrainer
from repro_torch.utils import hw
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

GB, MB, SEQ, LR = 16, 2, 16, 1e-3
OPT = dict(lr=LR, warmup_steps=0, clip_norm=1.0, weight_decay=0.0)


def microbatches(batch, mb_size):
    n = batch["tokens"].shape[0] // mb_size
    return [{k: v[i * mb_size:(i + 1) * mb_size] for k, v in batch.items()
             if not k.startswith("_")} for i in range(n)]


def assert_params_track(a, b, lr=LR):
    """tests/test_executor.py's rule: Adam moves an element whose
    gradient's last-bit noise straddles zero by a full lr, so isolated
    elements may differ by O(lr); a systematic fault moves most."""
    for x, y in zip(a, b):
        diff = np.abs(x - y)
        assert diff.max() <= 2.5 * lr, diff.max()
        assert (diff > lr / 10).mean() < 1e-3, (diff > lr / 10).mean()


def _engine_args(n_nodes, gb, policy="replan"):
    return (dict(fault_tolerance=1, global_batch=gb, microbatch=MB,
                 gpus_per_node=1, n0_override=2, recovery_policy=policy),
            [f"n{i}" for i in range(n_nodes)])


def _with_frontend(arch, mbs, seed):
    """Each microbatch gets frontend embeddings [MB, F, d] (numpy, from
    ``seed`` and its place in the step), as a vision or audio stub
    hands them over; other architectures' microbatches stay as they
    are."""
    if not arch.frontend:
        return mbs
    rng = np.random.default_rng(seed)
    return [[dict(mb, frontend_embeds=(rng.standard_normal(
        (MB, arch.frontend_tokens, arch.d_model)) * 0.02).astype(np.float32))
        for mb in pipe] for pipe in mbs]


@pytest.mark.parametrize("arch_name,attn_impl,ssd_impl", [
    pytest.param("gpt3_medium", "naive", "chunked", id="naive"),
    pytest.param("gpt3_medium", "kernel", "chunked", id="kernel"),
    pytest.param("mamba2_780m", "naive", "kernel", id="mamba2-ssd-kernel"),
    pytest.param("granite_moe_1b_a400m", "kernel", "chunked",
                 id="granite-moe"),
    pytest.param("phi3_vision_4_2b", "kernel", "chunked",
                 id="phi3-vision-frontend")])
def test_trainer_tracks_jax_through_failure(arch_name, attn_impl, ssd_impl):
    """granite-moe: the aux loss is in the last stage's loss and its
    gradient reaches every router.  phi3-vision: each microbatch carries
    frontend embeddings through the stage programs."""
    jarch = jreduced(jget_arch(arch_name), layers=2)
    arch = reduced(get_arch(arch_name), layers=2)
    jmodel = JModel(jarch, dtype=jnp.float32, remat=False,
                    attn_impl=attn_impl, ssd_impl=ssd_impl, scan_layers=False)
    model = Model(arch, dtype=torch.float32, attn_impl=attn_impl,
                  ssd_impl=ssd_impl)
    jparams = jmodel.init(jax.random.PRNGKey(11))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    cfg, nodes = _engine_args(5, GB)
    ref_hw = jhw.HardwareSpec(**dataclasses.asdict(hw.H100))
    jeng = JEngine(jbuild_profile(jarch, microbatch=MB, seq_len=SEQ, hw=ref_hw),
                   nodes, JEngineConfig(**cfg))
    eng = OobleckEngine(build_profile(arch, microbatch=MB, seq_len=SEQ),
                        nodes, EngineConfig(**cfg))
    assert eng.plan_fingerprint() == jeng.plan_fingerprint()
    assert len({i.template.num_nodes for i in eng.instances}) >= 2, \
        "the test needs a heterogeneous pipeline set"
    jtr = JTrainer(jmodel, jeng, jparams, jadamw.AdamWConfig(**OPT))
    tr = HeteroTrainer(model, eng, params, adamw.AdamWConfig(**OPT))
    builds = tr.warm_templates()["compiles"]
    jdisp = GlobalBatchDispenser(SyntheticLM(arch.vocab_size, SEQ, seed=5))
    disp = GlobalBatchDispenser(SyntheticLM(arch.vocab_size, SEQ, seed=5))

    for step in range(3):
        if step == 2:
            victim = eng.instances[0].nodes[0]
            jinfo, info = jtr.recover({victim}), tr.recover({victim})
            assert info["copied_bytes"] == jinfo["copied_bytes"]
            assert eng.plan_fingerprint() == jeng.plan_fingerprint()
        jb = jdisp.next_step(jeng.batch.minibatch_sizes())
        tb = disp.next_step(eng.batch.minibatch_sizes())
        jout = jtr.train_step(_with_frontend(
            arch, [microbatches(b, MB) for b in jb], step))
        out = tr.train_step(_with_frontend(
            arch, [microbatches(b, MB) for b in tb], step))
        np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]),
                                   rtol=1e-4)
        assert tr.replica_divergence() == 0.0
        assert tr.cache.stats.compiles == builds, "a step built a program"
    want = dict(tree_leaves_with_path(jax.tree.map(np.asarray,
                                                   jtr.full_params())))
    got = dict(tree_leaves_with_path(to_numpy(tr.full_params())))
    assert want.keys() == got.keys()
    assert_params_track([got[k] for k in want], [want[k] for k in want])


def _port_trainer(policy):
    arch = reduced(get_arch("gpt3_medium"), layers=2)
    model = Model(arch, dtype=torch.float32, attn_impl="naive")
    params = model.init(torch.Generator().manual_seed(3))
    cfg, nodes = _engine_args(9, 12, policy)
    eng = OobleckEngine(build_profile(arch, microbatch=MB, seq_len=SEQ),
                        nodes, EngineConfig(**cfg))
    return arch, eng, HeteroTrainer(model, eng, params,
                                    adamw.AdamWConfig(**OPT))


def test_adapt_bitwise_equals_replan_and_builds_nothing():
    _, eng_a, tr_a = _port_trainer("replan")
    arch, eng_b, tr_b = _port_trainer("adapt")
    builds = tr_b.warm_templates(mb_counts=[2, 3])["compiles"]
    disp_a = GlobalBatchDispenser(SyntheticLM(arch.vocab_size, SEQ, seed=5))
    disp_b = GlobalBatchDispenser(SyntheticLM(arch.vocab_size, SEQ, seed=5))

    def drive(tr, disp):
        b = disp.next_step(tr.engine.batch.minibatch_sizes())
        return float(tr.train_step([microbatches(x, MB) for x in b])["loss"])

    assert drive(tr_a, disp_a) == drive(tr_b, disp_b)
    victims = set(eng_a.instances[0].nodes)
    info_a, info_b = tr_a.handle_failure(set(victims)), tr_b.handle_failure(
        set(victims))
    assert (info_a["policy"], info_b["policy"]) == ("replan", "adapt")
    assert info_b["copied_bytes"] == 0
    assert [i.nodes for i in eng_a.instances] == [i.nodes for i in eng_b.instances]
    for _ in range(2):
        assert drive(tr_a, disp_a) == drive(tr_b, disp_b)
    assert tr_b.cache.stats.compiles == builds
    for a, b in zip(tree_leaves(tr_a.full_params()),
                    tree_leaves(tr_b.full_params())):
        assert torch.equal(a, b)
    assert tr_b.replica_divergence() == 0.0


def test_monitor_failure_routes_through_the_port_executor():
    from repro_torch.core.monitor import NodeChangeMonitor
    _, eng, tr = _port_trainer("replan")
    victim = eng.instances[0].nodes[-1]
    eng.monitor.inject(NodeChangeMonitor.FAIL, [victim])
    eng.monitor.poll(now=0.0)
    assert victim not in set(eng.nodes)
    assert len(tr.runs) == len(eng.instances)
    assert issubclass(ExecutorUnsupported, RuntimeError)


def _drive(tr, disp):
    b = disp.next_step(tr.engine.batch.minibatch_sizes())
    return tr.train_step([microbatches(x, MB) for x in b])


def test_snapshot_and_join_on_the_trainer():
    """snapshot(): params and both moments in the canonical stacked
    layout, copies that later steps leave alone; join(): the engine
    replans over the larger cluster and the trainer binds every
    instance, its replicas identical."""
    arch, eng, tr = _port_trainer("replan")
    disp = GlobalBatchDispenser(SyntheticLM(arch.vocab_size, SEQ, seed=5))
    _drive(tr, disp)
    snap = tr.snapshot(disp.state(), rng_seed=7)
    assert (snap.step, int(snap.opt_state.step)) == (1, 1)
    assert snap.data_state == disp.state() and snap.rng_seed == 7
    for a, b in zip(tree_leaves(snap.params), tree_leaves(tr.full_params())):
        assert torch.equal(a, b)
    assert snap.params["blocks"]["attn"]["wq"].shape[0] == arch.num_layers
    assert all(float(m.abs().max()) > 0 for m in tree_leaves(snap.opt_state.m))
    state = (snap.params, snap.opt_state)
    kept = [t.clone() for t in tree_leaves(state)]
    _drive(tr, disp)
    assert all(torch.equal(a, b) for a, b in zip(kept, tree_leaves(state)))

    n_before = len(eng.nodes)
    info = tr.join(["n99"])
    assert len(eng.nodes) + len(eng.spare_nodes) == n_before + 1
    assert info["num_pipelines"] == len(tr.runs) == len(eng.instances)
    assert tr.replica_divergence() == 0.0
    _drive(tr, disp)
    assert tr.replica_divergence() == 0.0


def test_trainer_built_from_a_snapshot_continues_bitwise():
    """A trainer built from a snapshot's params and opt_state (moments
    and step count) takes the next step exactly as the original does."""
    arch, _, tr = _port_trainer("replan")
    disp = GlobalBatchDispenser(SyntheticLM(arch.vocab_size, SEQ, seed=5))
    for _ in range(2):
        _drive(tr, disp)
    snap = tr.snapshot(disp.state())
    _, eng2, fresh = _port_trainer("replan")
    tr2 = HeteroTrainer(fresh.model, eng2, snap.params,
                        adamw.AdamWConfig(**OPT), opt_state=snap.opt_state)
    disp2 = GlobalBatchDispenser(SyntheticLM(arch.vocab_size, SEQ, seed=5))
    disp2.restore(snap.data_state)
    assert torch.equal(_drive(tr, disp)["loss"], _drive(tr2, disp2)["loss"])
    s1, s2 = tr.snapshot(), tr2.snapshot()
    for a, b in zip(tree_leaves((s1.params, s1.opt_state)),
                    tree_leaves((s2.params, s2.opt_state))):
        assert torch.equal(a, b)
