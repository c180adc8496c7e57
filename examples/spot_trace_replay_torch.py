"""Spot-instance trace replay (paper §7.3) on the PyTorch port's
simulator: Oobleck vs Varuna vs Bamboo throughput under preemptions and
node recoveries, on the calibrated discrete-event simulator
(``repro_torch.sim``).  The counterpart of
``examples/spot_trace_replay.py``; the simulator runs on the host alone.

    PYTHONPATH=src python examples/spot_trace_replay_torch.py

``main(hw)`` takes the ``HardwareSpec`` the profile is costed on (the
port's ``H100`` by default) and returns each policy's ``SimResult``.
"""
from repro_torch.configs import get_arch
from repro_torch.core import build_profile
from repro_torch.sim import (BambooPolicy, OobleckPolicy, VarunaPolicy,
                             run_sim, spot_trace)
from repro_torch.utils.hw import H100

HORIZON = 6 * 3600.0


def bar(x, scale):
    return "#" * max(1, int(x / scale))


def main(hw=H100):
    nodes = [f"n{i}" for i in range(30)]
    prof = build_profile(get_arch("gpt3_2_7b"), microbatch=2, seq_len=2048,
                         hw=hw)
    trace = spot_trace(nodes, HORIZON, mean_preempt=7.7 * 60,
                       mean_recover=15 * 60, seed=42, min_alive=10)
    fails = sum(1 for e in trace if e.kind == "fail")
    joins = sum(1 for e in trace if e.kind == "join")
    print(f"EC2-like trace: {fails} preemptions, {joins} recoveries "
          f"over {HORIZON / 3600:.0f}h\n")

    results = {}
    for pol in (
        OobleckPolicy(prof, nodes, f=2, global_batch=1024, microbatch=2,
                      max_stages=12),
        VarunaPolicy(prof, nodes, global_batch=1024, microbatch=2,
                     max_stages=12),
        BambooPolicy(prof, nodes, global_batch=1024, microbatch=2,
                     max_stages=12),
    ):
        res = run_sim(pol, trace, HORIZON, 1024)
        results[pol.name] = res
        thpt = "OOM" if res.stopped_reason == "OOM" else f"{res.throughput:7.2f}"
        print(f"{pol.name:8s} {thpt} samples/s "
              f"effective={res.effective_fraction():.2%} "
              f"events={res.events_handled}")

    print("\nthroughput (samples/s):")
    ok = {k: v for k, v in results.items() if v.throughput > 0}
    scale = max(v.throughput for v in ok.values()) / 40
    for k, v in ok.items():
        print(f"  {k:8s} {bar(v.throughput, scale)} {v.throughput:.1f}")
    print("\nbreakdown (fraction of wall clock):")
    for k, v in ok.items():
        total = max(sum(v.breakdown.values()), 1e-9)
        parts = ", ".join(f"{n}={x / total:.2%}" for n, x in
                          sorted(v.breakdown.items()) if x > 0)
        print(f"  {k:8s} {parts}")
    return results


if __name__ == "__main__":
    main()
