"""The port's copies of the framework-free planning modules (configs,
core, data, runtime/schedule.py, runtime/transfer.py) give results
identical to ``repro``'s for the same inputs: templates, instantiation
and batch plans, failure reconfiguration, adaptation, sync and transfer
plans.  Both sides price with the same hardware numbers (the port's H100
spec handed to the reference's HardwareSpec)."""
import dataclasses

import pytest

from repro.configs import get_arch as ref_get_arch
from repro.core import EngineConfig as RefEngineConfig
from repro.core import OobleckEngine as RefEngine
from repro.core import build_profile as ref_build_profile
from repro.data import GlobalBatchDispenser as RefDispenser
from repro.data import SyntheticLM as RefSyntheticLM
from repro.runtime import schedule as ref_schedule
from repro.utils import hw as ref_hw

from repro_torch.configs import get_arch
from repro_torch.core import EngineConfig, OobleckEngine, build_profile
from repro_torch.data import GlobalBatchDispenser, SyntheticLM
from repro_torch.runtime import schedule
from repro_torch.utils import hw

REF_H100 = ref_hw.HardwareSpec(**dataclasses.asdict(hw.H100))


def _engines(arch_name, n_nodes, f, n0, gb, mb, seq):
    port = OobleckEngine(
        build_profile(get_arch(arch_name), microbatch=mb, seq_len=seq),
        [f"n{i:02d}" for i in range(n_nodes)],
        EngineConfig(fault_tolerance=f, global_batch=gb, microbatch=mb,
                     gpus_per_node=1, n0_override=n0))
    ref = RefEngine(
        ref_build_profile(ref_get_arch(arch_name), microbatch=mb, seq_len=seq,
                          hw=REF_H100),
        [f"n{i:02d}" for i in range(n_nodes)],
        RefEngineConfig(fault_tolerance=f, global_batch=gb, microbatch=mb,
                        gpus_per_node=1, n0_override=n0))
    return port, ref


def _templates(engine):
    return {n: ([(s.layer_start, s.layer_end, s.num_gpus) for s in t.stages],
                t.iteration_time)
            for n, t in engine.templates.items()}


CLUSTERS = [("gpt3_medium", 5, 1, 2, 16, 2, 512),
            ("gpt3_medium", 9, 1, 2, 64, 2, 1024),
            ("gpt3_2_7b", 13, 2, 3, 256, 4, 2048),
            ("gpt2", 20, 1, 4, 512, 2, 1024)]


@pytest.mark.parametrize("cluster", CLUSTERS, ids=lambda c: f"{c[0]}-{c[1]}n")
def test_planner_copies_match_reference(cluster):
    port, ref = _engines(*cluster)
    assert port.spec.sizes == ref.spec.sizes
    assert _templates(port) == _templates(ref)
    assert port.plan_fingerprint() == ref.plan_fingerprint()
    assert port.batch.num_microbatches == ref.batch.num_microbatches
    assert port.iteration_time() == ref.iteration_time()
    assert ([(b.layer_start, b.layer_end) for b in port.sync_plan()]
            == [(b.layer_start, b.layer_end) for b in ref.sync_plan()])

    # failure: the same reconfiguration, copy plan and transfer schedule
    victim = port.instances[0].nodes[-1]
    res_p, res_r = port.handle_failure({victim}), ref.handle_failure({victim})
    assert port.plan_fingerprint(res_p) == ref.plan_fingerprint(res_r)
    assert (port.transfer_plan(res_p, dead={victim}).stats()
            == ref.transfer_plan(res_r, dead={victim}).stats())
    assert port.recovery_breakdown(res_p, {victim}).keys() \
        == ref.recovery_breakdown(res_r, {victim}).keys()

    # adaptation of a whole-replica kill plans the same instances
    dead = set(port.instances[0].nodes)
    try:
        plan_r = ref.plan_adaptation(set(dead))
    except Exception as e:                               # noqa: BLE001
        with pytest.raises(type(e)):
            port.plan_adaptation(set(dead))
        return
    plan_p = port.plan_adaptation(set(dead))
    assert ([i.nodes for i in plan_p.instances]
            == [i.nodes for i in plan_r.instances])
    assert plan_p.batch.num_microbatches == plan_r.batch.num_microbatches


@pytest.mark.parametrize("stages,mbs", [(1, 1), (2, 5), (3, 3), (4, 8)])
def test_schedule_copy_matches_reference(stages, mbs):
    assert schedule.flat_schedule(stages, mbs) == \
        ref_schedule.flat_schedule(stages, mbs)


def test_data_copy_matches_reference():
    import numpy as np
    port = GlobalBatchDispenser(SyntheticLM(512, 16, seed=3))
    ref = RefDispenser(RefSyntheticLM(512, 16, seed=3))
    for sizes in ([6, 10], [16], [3, 5, 8]):
        for a, b in zip(port.next_step(sizes), ref.next_step(sizes)):
            for k in ("tokens", "labels", "_indices"):
                np.testing.assert_array_equal(a[k], b[k])
