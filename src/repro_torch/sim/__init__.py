"""The failure simulator (paper §7): policies, the discrete-event
simulator and its traces, as in ``repro/sim/``."""
from repro_torch.sim.policies import (BambooPolicy, OobleckPolicy, Policy,
                                      PolicyStopped, VarunaPolicy)
from repro_torch.sim.simulator import SimResult, TraceEvent, run_sim
from repro_torch.sim.traces import (controlled_failures, rack_failure_bursts,
                                    scale_cycle, spot_preemption_wave,
                                    spot_trace)

__all__ = ["BambooPolicy", "OobleckPolicy", "Policy", "PolicyStopped",
           "VarunaPolicy", "SimResult", "TraceEvent", "run_sim",
           "controlled_failures", "rack_failure_bursts", "scale_cycle",
           "spot_preemption_wave", "spot_trace"]
