"""The port's examples on the CPU: ``examples/quickstart_torch.py``
against the JAX package's quickstart lifecycle (examples/quickstart.py,
run inline here since its ``main`` returns nothing) on the same weights,
engine inputs and batches — per-step losses at tests/test_executor.py's
fp32 tolerance — and ``examples/checkpoint_restart_torch.py`` end to
end, its checkpoint restored by the JAX package too."""
import dataclasses
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.ckpt import CheckpointManager as JManager
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.core import EngineConfig as JEngineConfig
from repro.core import OobleckEngine as JEngine
from repro.core import build_profile as jbuild_profile
from repro.data import ByteCorpus as JByteCorpus
from repro.data import GlobalBatchDispenser as JDispenser
from repro.launch.train import _TEXT as JTEXT
from repro.launch.train import microbatches as jmicrobatches
from repro.models import Model as JModel
from repro.optim import adamw as jadamw
from repro.runtime import HeteroTrainer as JTrainer
from repro.utils import hw as jhw

from repro_torch.ckpt import CheckpointManager
from repro_torch.convert import params_from_numpy
from repro_torch.utils import hw
from repro_torch.utils.tree import tree_leaves_with_path

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: tests/test_executor.py's fp32 tolerance (tree_allclose_ulp)
TOL = dict(atol=5e-7, rtol=5e-4)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_quickstart(jparams):
    """examples/quickstart.py's lifecycle, returning its losses; planned
    on the port's hardware spec so that both packages plan the same
    pipelines."""
    arch = jreduced(jget_arch("gpt3_medium"), layers=4)
    profile = jbuild_profile(arch, microbatch=2, seq_len=32,
                             hw=jhw.HardwareSpec(**dataclasses.asdict(hw.H100)))
    engine = JEngine(profile, [f"node{i}" for i in range(5)], JEngineConfig(
        fault_tolerance=1, global_batch=16, microbatch=2,
        gpus_per_node=1, n0_override=2))
    model = JModel(arch, dtype=jnp.float32, remat=False, attn_impl="naive",
                   scan_layers=False)
    trainer = JTrainer(model, engine, jparams,
                       jadamw.AdamWConfig(lr=3e-3, warmup_steps=0,
                                          weight_decay=0.0))
    disp = JDispenser(JByteCorpus(JTEXT * 50, seq_len=32))
    losses = []

    def step():
        batches = disp.next_step(engine.batch.minibatch_sizes())
        out = trainer.train_step([jmicrobatches(b, 2) for b in batches])
        losses.append(float(out["loss"]))

    for _ in range(3):
        step()
    trainer.handle_failure({engine.instances[0].nodes[-1]})
    for _ in range(2):
        step()
    return losses


def test_quickstart_tracks_the_reference_quickstart():
    jarch = jreduced(jget_arch("gpt3_medium"), layers=4)
    jparams = JModel(jarch, dtype=jnp.float32, remat=False,
                     scan_layers=False).init(jax.random.PRNGKey(0))
    want = _reference_quickstart(jparams)
    got = _example("quickstart_torch").main(
        "cpu", params=params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu"))
    assert len(got["losses"]) == len(want) == 5
    np.testing.assert_allclose(got["losses"], want, **TOL)
    assert got["divergences"] == [0.0] * 5
    assert got["losses"][-1] < got["losses"][0]


def test_checkpoint_restart_example_end_to_end(tmp_path):
    """Two failures under (f+1)*n0, a checkpoint, a restore into a fresh
    5-node trainer that holds exactly the saved state, two more steps;
    the checkpoint restores into the JAX package bit for bit."""
    out = _example("checkpoint_restart_torch").main("cpu",
                                                    ckpt_dir=str(tmp_path))
    assert out["restored_step"] == 2
    assert out["data_state"] == {"next_index": 32}
    assert out["exact"]
    assert all(math.isfinite(l) for l in out["run1"] + out["run2"])
    assert len(out["run1"]) == len(out["run2"]) == 2

    jarch = jreduced(jget_arch("gpt3_medium"), layers=3)
    template = JModel(jarch, dtype=jnp.float32, remat=False).init(
        jax.random.PRNGKey(0))
    template["head"] = template.get("head", template["embed"])
    jgot = JManager(str(tmp_path), num_layers=3).restore(
        template, jadamw.init(template))
    tgot = CheckpointManager(str(tmp_path), num_layers=3).restore(
        template, jadamw.init(template), device=None)
    assert jgot.step == tgot.step == 2
    want = dict(tree_leaves_with_path(jax.tree.map(
        np.asarray, (jgot.params, jgot.opt_state.m, jgot.opt_state.v))))
    got = dict(tree_leaves_with_path(
        (tgot.params, tgot.opt_state.m, tgot.opt_state.v)))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.asarray(jgot.opt_state.step) == tgot.opt_state.step == 2
