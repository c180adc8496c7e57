"""Hardware constants for the target platform (NVIDIA H100 SXM).

These drive two things:
  1. the planner's analytical cost model (core/cost_model.py),
  2. the recovery and sync data planes' transfer pricing
     (runtime/transfer.py, core/sync.py).

The published peaks come from NVIDIA's H100 SXM data sheet: 989 TFLOP/s
bf16 dense, 67 TFLOP/s fp32 outside the tensor cores, 3.35 TB/s HBM3,
80 GB, NVLink 900 GB/s total (450 GB/s each way).  The field names are
the copied planner's: ``ici_*`` holds the intra-pod fabric (NVLink here)
and ``dcn_*`` the cross-pod network (InfiniBand here).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """One accelerator chip + its fabric."""

    peak_flops_bf16: float = 989e12     # FLOP/s per card (tensor cores, bf16, dense)
    hbm_bandwidth: float = 3.35e12      # bytes/s per card (HBM3)
    hbm_capacity: int = 80 * 10**9      # bytes per card (80 GB)
    vmem_capacity: int = 50 * 10**6     # bytes of on-chip L2 per card (50 MB)
    ici_bandwidth: float = 450e9        # bytes/s NVLink, one direction, all links
    ici_links_per_chip: int = 1         # the 450 GB/s above is the aggregate
    dcn_bandwidth: float = 50e9         # bytes/s per card: one 400 Gb/s NIC
    mxu_efficiency: float = 0.7         # assumed achievable fraction of peak
    chips_per_node: int = 8             # cards on one NVLink board

    # Storage path used for checkpoints (distributed object store).
    ckpt_write_bandwidth: float = 8e9   # bytes/s aggregate write
    ckpt_read_bandwidth: float = 12e9   # bytes/s aggregate read


#: Default target card. Everything takes a HardwareSpec parameter and
#: defaults to this, so tests can substitute toy hardware.
H100 = HardwareSpec()


def matmul_time(flops: float, chips: int, hw: HardwareSpec = H100) -> float:
    """Seconds to execute ``flops`` of GEMM work on ``chips`` chips."""
    return flops / (chips * hw.peak_flops_bf16 * hw.mxu_efficiency)


def allreduce_time(nbytes: float, participants: int,
                   bandwidth: float | None = None,
                   hw: HardwareSpec = H100) -> float:
    """Ring all-reduce: 2*(k-1)/k * bytes over the slowest link."""
    if participants <= 1:
        return 0.0
    bw = bandwidth if bandwidth is not None else hw.ici_bandwidth
    return 2.0 * (participants - 1) / participants * nbytes / bw


def allgather_time(nbytes: float, participants: int,
                   bandwidth: float | None = None,
                   hw: HardwareSpec = H100) -> float:
    """Ring all-gather of a ``nbytes`` shard from each of ``participants``."""
    if participants <= 1:
        return 0.0
    bw = bandwidth if bandwidth is not None else hw.ici_bandwidth
    return (participants - 1) / participants * nbytes / bw


def p2p_time(nbytes: float, bandwidth: float | None = None,
             hw: HardwareSpec = H100) -> float:
    """Point-to-point transfer (pipeline activation hops, state copy)."""
    bw = bandwidth if bandwidth is not None else hw.ici_bandwidth
    return nbytes / bw
