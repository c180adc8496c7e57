"""The port's failure simulator (``repro_torch.sim``): every test of
tests/test_simulator.py (the paper's §7 claims) on the port, and the
port against the JAX package's ``repro.sim``: the same traces, and for
each policy the same ``SimResult`` on the same traces, profiles and
hardware numbers; and examples/spot_trace_replay_torch.py against the
reference's examples/spot_trace_replay.py on its trace."""
import dataclasses
import importlib.util
import os

import pytest

from repro.configs import get_arch as jget_arch
from repro.core import build_profile as jbuild_profile
from repro import sim as jsim
from repro.utils import hw as jhw

from repro_torch.configs import get_arch
from repro_torch.core import build_profile
from repro_torch.sim import (BambooPolicy, OobleckPolicy, PolicyStopped,
                             VarunaPolicy, controlled_failures, run_sim,
                             spot_trace)
from repro_torch import sim
from repro_torch.utils import hw

NODES = [f"n{i}" for i in range(30)]


def prof(model="gpt3_2_7b", mb=2, seq=1024):
    return build_profile(get_arch(model), microbatch=mb, seq_len=seq)


def make_policies(p, gb=1024, mb=2):
    return {
        "oobleck": OobleckPolicy(p, NODES, f=2, global_batch=gb,
                                 microbatch=mb, max_stages=12),
        "varuna": VarunaPolicy(p, NODES, global_batch=gb, microbatch=mb,
                               max_stages=12),
        "bamboo": BambooPolicy(p, NODES, global_batch=gb, microbatch=mb,
                               max_stages=12),
    }


def test_no_failures_all_run_and_oobleck_competitive():
    p = prof()
    pols = make_policies(p)
    res = {k: run_sim(v, [], 3600.0, 1024) for k, v in pols.items()
           if v.runnable()}
    assert res["oobleck"].throughput > 0
    # without failures, Oobleck >= Varuna (same planner, no grid waste)
    assert res["oobleck"].throughput >= 0.95 * res["varuna"].throughput


def test_oobleck_degrades_gracefully_with_failure_rate():
    p = prof()
    outs = []
    for interval in (6 * 3600, 600):
        trace = controlled_failures(NODES, interval, stop_at=15)
        pol = OobleckPolicy(p, NODES, f=2, global_batch=1024, microbatch=2,
                            max_stages=12)
        res = run_sim(pol, trace, interval * 17, 1024, min_nodes=15)
        outs.append(res.throughput)
    # 36x more failures must cost Oobleck < 15% throughput (paper: ~2%)
    assert outs[1] > 0.85 * outs[0]


def test_varuna_hurts_more_at_high_failure_rate():
    p = prof()
    t_low, t_high = {}, {}
    for store, interval in ((t_low, 6 * 3600), (t_high, 600)):
        trace = controlled_failures(NODES, interval, stop_at=15)
        for name, pol in make_policies(p).items():
            if not pol.runnable():
                continue
            store[name] = run_sim(pol, trace, interval * 17, 1024,
                                  min_nodes=15).throughput
    oob_drop = t_high["oobleck"] / t_low["oobleck"]
    var_drop = t_high["varuna"] / t_low["varuna"]
    assert oob_drop > var_drop, (oob_drop, var_drop)


@pytest.mark.parametrize("model,mb", [("gpt3_6_7b", 4), ("qwen2_5_32b", 2)])
def test_bamboo_oom_large_models(model, mb):
    # the reference holds gpt3_6_7b at microbatch 2 against its 16 GiB
    # target; on the port's 80 GB H100 Bamboo's model of that case needs
    # 59.8 GB and fits, so the port's cases need more than 80 GB
    p = prof(model, mb=mb, seq=2048)
    pol = BambooPolicy(p, NODES, global_batch=1024, microbatch=mb,
                       max_stages=12)
    assert not pol.runnable()           # paper Table 1: X for GPT-3 models
    res = run_sim(pol, [], 3600.0, 1024)
    assert res.stopped_reason == "OOM"
    assert res.throughput == 0.0


def test_bamboo_fixed_overhead_without_failures():
    p = prof("bert_large", mb=4, seq=512)
    bam = BambooPolicy(p, NODES, global_batch=8192, microbatch=4,
                       max_stages=12)
    oob = OobleckPolicy(p, NODES, f=2, global_batch=8192, microbatch=32,
                        max_stages=12)
    r_b = run_sim(bam, [], 3600.0, 8192)
    r_o = run_sim(oob, [], 3600.0, 8192)
    # RC overhead: Bamboo clearly slower even with zero failures (§2.3)
    assert r_b.throughput < 0.8 * r_o.throughput


def test_varuna_rollback_loses_progress():
    p = prof()
    interval = 600.0
    trace = controlled_failures(NODES, interval, stop_at=25)
    pol = VarunaPolicy(p, NODES, global_batch=1024, microbatch=2,
                       max_stages=12)
    res = run_sim(pol, trace, interval * 8, 1024, min_nodes=25)
    assert res.breakdown["downtime"] > 0
    assert res.breakdown["ckpt"] > 0
    assert res.effective_fraction() < 1.0


def test_oobleck_stops_below_floor():
    p = prof()
    pol = OobleckPolicy(p, NODES[:10], f=1, global_batch=1024, microbatch=2,
                        n0=4, max_stages=12)
    trace = controlled_failures(NODES[:10], 100.0, stop_at=5)
    res = run_sim(pol, trace, 1e6, 1024)
    assert res.stopped_reason is not None


def test_spot_trace_shapes():
    trace = spot_trace(NODES, horizon=3600.0, mean_preempt=300.0,
                       mean_recover=600.0, seed=3)
    assert trace, "trace should contain events"
    times = [e.time for e in trace]
    assert times == sorted(times)
    assert {e.kind for e in trace} <= {"fail", "join"}


def test_spot_replay_all_policies_survive():
    p = prof("bert_large", mb=32, seq=512)
    trace = spot_trace(NODES, horizon=4 * 3600.0, mean_preempt=7.7 * 60,
                       mean_recover=15 * 60, seed=11, min_alive=10)
    pols = make_policies(p, gb=8192, mb=32)
    # Bamboo runs at ITS Table-1 microbatch (4): RC + no-remat memory
    pols["bamboo"] = BambooPolicy(prof("bert_large", mb=4, seq=512), NODES,
                                  global_batch=8192, microbatch=4,
                                  max_stages=12)
    for name, pol in pols.items():
        res = run_sim(pol, trace, 4 * 3600.0, 8192)
        assert res.throughput > 0, name
        assert res.events_handled > 0, name


# ----------------------------------------------------------------------
# The port against the JAX package
# ----------------------------------------------------------------------
SMALL = [f"n{i}" for i in range(12)]
HORIZON = 2 * 3600.0
GB = 4096
#: the port's hardware numbers, handed to the reference's profile too
REF_HW = jhw.HardwareSpec(**dataclasses.asdict(hw.H100))


def _traces(pkg):
    """Each package's own generators, same arguments: the traces the
    comparison replays."""
    return {
        "controlled": pkg.controlled_failures(SMALL, 900.0, stop_at=6),
        "spot": pkg.spot_trace(SMALL, horizon=HORIZON, mean_preempt=600.0,
                               mean_recover=900.0, seed=7, min_alive=6),
        "rack": pkg.rack_failure_bursts(SMALL, rack_size=3, horizon=HORIZON,
                                        mean_interval=1500.0, seed=2,
                                        min_alive=6, repair_time=1200.0),
        "wave": pkg.spot_preemption_wave(SMALL, horizon=HORIZON,
                                         mean_wave=1200.0, wave_frac=0.2,
                                         grace=120.0, seed=4, min_alive=6,
                                         mean_recover=900.0),
        "cycle": pkg.scale_cycle(SMALL, horizon=HORIZON, period=900.0,
                                 step=2, lo=6, grace=60.0),
    }


def _policies(pkg, profile):
    kw = dict(global_batch=GB, microbatch=2, max_stages=8)
    return {
        "oobleck": pkg.OobleckPolicy(profile, SMALL, f=1, **kw),
        "oobleck-auto": pkg.OobleckPolicy(profile, SMALL, f=1,
                                          recovery_policy="auto", **kw),
        "varuna": pkg.VarunaPolicy(profile, SMALL, **kw),
        "bamboo": pkg.BambooPolicy(profile, SMALL, **kw),
    }


class _FrozenClock:
    """Stands in for the ``time`` module of the planners: their measured
    replan seconds (part of every Oobleck downtime) read 0, so the two
    packages' results depend on their arithmetic alone."""

    @staticmethod
    def perf_counter():
        return 0.0


@pytest.fixture
def frozen_planner_clocks(monkeypatch):
    import repro.core.engine
    import repro.core.reconfigure
    import repro_torch.core.engine
    import repro_torch.core.reconfigure
    for mod in (repro.core.engine, repro.core.reconfigure,
                repro_torch.core.engine, repro_torch.core.reconfigure):
        monkeypatch.setattr(mod, "_time", _FrozenClock)


def test_traces_match_the_jax_package():
    for (name, ours), theirs in zip(_traces(sim).items(),
                                    _traces(jsim).values()):
        assert [dataclasses.astuple(e) for e in ours] == \
            [dataclasses.astuple(e) for e in theirs], name
        assert ours, name


@pytest.mark.parametrize("trace", ["controlled", "spot", "rack", "wave",
                                   "cycle"])
def test_run_sim_matches_the_jax_package(trace, frozen_planner_clocks):
    """Every policy, both packages, one trace: the same SimResult field
    by field (the same arithmetic on the same inputs)."""
    ours = _policies(sim, build_profile(get_arch("gpt3_2_7b"), microbatch=2,
                                        seq_len=1024))
    theirs = _policies(jsim, jbuild_profile(jget_arch("gpt3_2_7b"),
                                            microbatch=2, seq_len=1024,
                                            hw=REF_HW))
    events, jevents = _traces(sim)[trace], _traces(jsim)[trace]
    for name in ours:
        got = run_sim(ours[name], events, HORIZON, GB)
        want = jsim.run_sim(theirs[name], jevents, HORIZON, GB)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert got.committed_samples > 0 and got.events_handled > 0, name


# ----------------------------------------------------------------------
# examples/spot_trace_replay_torch.py against the reference's example
# ----------------------------------------------------------------------
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
POLICIES = ("oobleck", "varuna", "bamboo")


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def spot_replays():
    """Each policy's ``SimResult`` from ``examples/spot_trace_replay.py``
    (loaded by path and run as it is, its ``run_sim`` calls recorded) and
    from the port's example costed on the reference's hardware numbers,
    both packages' planner clocks reading 0."""
    import repro.core.engine
    import repro.core.reconfigure
    import repro_torch.core.engine
    import repro_torch.core.reconfigure
    ref = _load_example("spot_trace_replay")
    port = _load_example("spot_trace_replay_torch")
    recorded, ref_run_sim = {}, ref.run_sim

    def run_sim(policy, *args, **kw):
        recorded[policy.name] = ref_run_sim(policy, *args, **kw)
        return recorded[policy.name]
    with pytest.MonkeyPatch.context() as mp:
        for mod in (repro.core.engine, repro.core.reconfigure,
                    repro_torch.core.engine, repro_torch.core.reconfigure):
            mp.setattr(mod, "_time", _FrozenClock)
        mp.setattr(ref, "run_sim", run_sim)
        ref.main()
        ours = port.main(hw.HardwareSpec(**dataclasses.asdict(jhw.V5E)))
    return ours, recorded


@pytest.mark.parametrize("policy", POLICIES)
def test_spot_replay_matches_the_reference_example(spot_replays, policy):
    """On the example's trace (30 nodes, 6 h, seed 42) each policy's
    ``SimResult`` equals the reference example's field by field."""
    ours, theirs = spot_replays
    assert sorted(ours) == sorted(theirs) == sorted(POLICIES)
    got, want = ours[policy], theirs[policy]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # on the reference's 16 GiB chips Bamboo's redundant layers stop it
    # at the start (the reference example prints "OOM"); the others run
    # through every event
    if policy == "bamboo":
        assert got.stopped_reason == "OOM"
    else:
        assert got.events_handled > 0 and got.committed_samples > 0
