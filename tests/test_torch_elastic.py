"""Elastic scale-up in the port (``HeteroTrainer.handle_join``):
tests/test_elastic.py's two tests — joins re-plan globally, new
pipelines copy state from replicas, the trajectory is a plain full-model
step's, and joins beyond the original N keep spares — and the join
against the JAX package's on the same engine inputs, weights and
batches."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
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
from repro_torch.convert import params_from_numpy
from repro_torch.core import EngineConfig, OobleckEngine, build_profile
from repro_torch.data import GlobalBatchDispenser, SyntheticLM
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.runtime import HeteroTrainer, track_compiles
from repro_torch.utils import hw
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

GB, MB, SEQ = 16, 2, 16


def microbatches(batch, mb):
    n = batch["tokens"].shape[0] // mb
    return [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()
             if not k.startswith("_")} for i in range(n)]


def _config():
    return EngineConfig(fault_tolerance=1, global_batch=GB, microbatch=MB,
                        gpus_per_node=1, n0_override=2)


def test_join_preserves_trajectory():
    arch = reduced(get_arch("gpt3_medium"), layers=4)
    model = Model(arch, dtype=torch.float32, attn_impl="naive")
    params = model.init(torch.Generator().manual_seed(4))
    profile = build_profile(arch, microbatch=MB, seq_len=SEQ)
    engine = OobleckEngine(profile, [f"n{i}" for i in range(5)], _config())
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, weight_decay=0.0)
    trainer = HeteroTrainer(model, engine, params, opt_cfg)
    builds = trainer.warm_templates()["compiles"]
    source = SyntheticLM(arch.vocab_size, SEQ, seed=2)
    disp = GlobalBatchDispenser(source)

    # reference on a fixed cluster: a plain full-model step
    ref_params = tree_map(torch.clone, params)
    ref_opt = adamw.init(ref_params)

    def ref_step(indices):
        nonlocal ref_params, ref_opt
        full = source.batch(indices)
        batch = {k: torch.from_numpy(full[k].astype(np.int64))
                 for k in ("tokens", "labels")}
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(ref_params)]
        loss, _ = model.loss(tree_unflatten_like(ref_params, leaves), batch)
        grads = tree_unflatten_like(ref_params,
                                    list(torch.autograd.grad(loss, leaves)))
        ref_params, ref_opt, _ = adamw.apply(opt_cfg, ref_params, grads,
                                             ref_opt)

    def drive():
        batches = disp.next_step(engine.batch.minibatch_sizes())
        idx = np.concatenate([b["_indices"] for b in batches])
        out = trainer.train_step([microbatches(b, MB) for b in batches])
        return out, idx

    out0, idx0 = drive()
    ref_step(idx0)
    n_before = len(engine.nodes)
    with track_compiles() as log:
        info = trainer.handle_join(["fresh0", "fresh1", "fresh2"])
        out1, idx1 = drive()
    ref_step(idx1)
    assert len(engine.nodes) == n_before + 3
    assert info["num_pipelines"] >= 2 and info["copied_bytes"] > 0
    assert log.backend_compiles == 0 and trainer.cache.stats.compiles == builds

    assert trainer.replica_divergence() == 0.0
    got = trainer.full_params()
    np.testing.assert_allclose(got["embed"]["table"].numpy(),
                               ref_params["embed"]["table"].numpy(),
                               rtol=2e-4, atol=2e-4)
    # new nodes actually host state
    hosted = {n for inst in engine.instances for n in inst.nodes}
    assert {"fresh0", "fresh1", "fresh2"} <= hosted


def test_join_beyond_original_n_keeps_spares():
    """Joins beyond the original N may be uncoverable by the fixed
    template set; the engine uses the largest coverable subset, and the
    trainer binds exactly the instances it keeps."""
    arch = reduced(get_arch("gpt3_medium"), layers=4)
    model = Model(arch, dtype=torch.float32, attn_impl="naive")
    profile = build_profile(arch, microbatch=MB, seq_len=SEQ)
    engine = OobleckEngine(profile, [f"n{i}" for i in range(4)], _config())
    assert engine.spec.sizes == (2,)         # N=4, f=1: only 2-node pipes
    trainer = HeteroTrainer(model, engine,
                            model.init(torch.Generator().manual_seed(0)),
                            adamw.AdamWConfig(lr=1e-3, warmup_steps=0))
    info = trainer.join(["j0", "j1", "j2"])  # 7 nodes: 6 usable, 1 spare
    assert len(engine.spare_nodes) == 1
    assert len(engine.nodes) == 6
    assert all(i.template.num_nodes == 2 for i in engine.instances)
    assert info["num_pipelines"] == len(trainer.runs) == 3
    assert trainer.replica_divergence() == 0.0


def test_join_tracks_the_jax_package():
    """The same join on both packages: the same plan and copied bytes,
    and losses at rtol 1e-4 before and after it."""
    jarch = jreduced(jget_arch("gpt3_medium"), layers=4)
    arch = reduced(get_arch("gpt3_medium"), layers=4)
    jmodel = JModel(jarch, dtype=jnp.float32, remat=False, attn_impl="naive",
                    scan_layers=False)
    model = Model(arch, dtype=torch.float32, attn_impl="naive")
    jparams = jmodel.init(jax.random.PRNGKey(4))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    nodes = [f"n{i}" for i in range(5)]
    ref_hw = jhw.HardwareSpec(**dataclasses.asdict(hw.H100))
    jeng = JEngine(jbuild_profile(jarch, microbatch=MB, seq_len=SEQ,
                                  hw=ref_hw), nodes,
                   JEngineConfig(fault_tolerance=1, global_batch=GB,
                                 microbatch=MB, gpus_per_node=1,
                                 n0_override=2))
    eng = OobleckEngine(build_profile(arch, microbatch=MB, seq_len=SEQ),
                        nodes, _config())
    opt = dict(lr=1e-3, warmup_steps=0, clip_norm=1.0, weight_decay=0.0)
    jtr = JTrainer(jmodel, jeng, jparams, jadamw.AdamWConfig(**opt))
    tr = HeteroTrainer(model, eng, params, adamw.AdamWConfig(**opt))
    jdisp = GlobalBatchDispenser(SyntheticLM(arch.vocab_size, SEQ, seed=3))
    disp = GlobalBatchDispenser(SyntheticLM(arch.vocab_size, SEQ, seed=3))
    for step in range(3):
        if step == 1:
            victim = eng.instances[0].nodes[-1]
            jtr.recover({victim})
            tr.recover({victim})
        if step == 2:
            jinfo, info = jtr.join(["fresh0"]), tr.join(["fresh0"])
            assert info["copied_bytes"] == jinfo["copied_bytes"] > 0
            assert eng.plan_fingerprint() == jeng.plan_fingerprint()
        jb = jdisp.next_step(jeng.batch.minibatch_sizes())
        tb = disp.next_step(eng.batch.minibatch_sizes())
        jout = jtr.train_step([microbatches(b, MB) for b in jb])
        out = tr.train_step([microbatches(b, MB) for b in tb])
        np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]),
                                   rtol=1e-4)
        assert tr.replica_divergence() == 0.0
