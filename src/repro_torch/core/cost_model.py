"""Analytical per-layer cost model for Oobleck's planner (paper §4.1.2).

The planner needs, for every model layer ``l`` and every intra-stage device
count ``d``:

    F_{l,d}  — forward time of one microbatch,
    B_{l,d}  — backward time of one microbatch (≈ 2x forward FLOPs + remat),

plus per-layer parameter/activation byte counts for memory-feasibility
(choice of n0) and for the simulator's checkpoint/state-copy timings.

Oobleck profiles these on real GPUs; a CPU container cannot, so we derive
them from first principles over the TARGET hardware (utils/hw.py):
GEMM time at an assumed tensor-core efficiency + TP collective time + an HBM-bandwidth floor
(whichever of compute/memory dominates, plus comm — a per-layer mini
roofline).  The same model feeds the discrete-event simulator, so planner
and simulator are self-consistent.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence

from repro_torch.configs.base import ArchConfig
from repro_torch.utils import hw as hwlib


@dataclasses.dataclass(frozen=True)
class LayerCost:
    """Static per-layer workload description (per ONE microbatch)."""

    name: str
    flops_fwd: float          # forward FLOPs for one microbatch
    param_bytes: int          # bf16 parameter bytes
    act_bytes: int            # boundary activation bytes (pipeline hop size)
    io_bytes_fwd: float       # HBM traffic of the forward pass
    tp_collective_bytes: float  # activation bytes all-reduced per TP step


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """The model as Oobleck sees it: an ordered list of layers.

    Layer 0 is the embedding, layers 1..L are blocks, layer L+1 is the
    final norm + LM head — matching the layer granularity at which
    Oobleck partitions stages, copies state, and syncs gradients.
    """

    arch: ArchConfig
    microbatch: int
    seq_len: int
    layers: Sequence[LayerCost]
    hw: hwlib.HardwareSpec = hwlib.H100
    # Activation-recompute (remat) multiplies backward FLOPs by ~1.5x
    # fwd instead of storing activations; Oobleck (like Varuna) trains
    # with activation checkpointing on (§7.1), so this defaults on.
    remat: bool = True

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def param_bytes_total(self) -> int:
        return sum(l.param_bytes for l in self.layers)

    def train_state_bytes(self) -> int:
        """bf16 params + fp32 master/adam-m/adam-v (ZeRO-unsharded)."""
        p = self.param_bytes_total() // 2  # param count
        return p * 2 + p * 4 * 3

    # ------------------------------------------------------------------
    # F / B per layer on d chips (paper notation F_{l,d}, B_{l,d}).
    # ------------------------------------------------------------------
    def fwd_time(self, layer_idx: int, d: int) -> float:
        l = self.layers[layer_idx]
        compute = l.flops_fwd / (d * self.hw.peak_flops_bf16 * self.hw.mxu_efficiency)
        memory = (l.io_bytes_fwd / d) / self.hw.hbm_bandwidth
        comm = hwlib.allreduce_time(l.tp_collective_bytes, d, hw=self.hw)
        return max(compute, memory) + comm

    def bwd_time(self, layer_idx: int, d: int) -> float:
        # backward ≈ 2x forward FLOPs; +1x recompute under remat.
        factor = 3.0 if self.remat else 2.0
        l = self.layers[layer_idx]
        compute = factor * l.flops_fwd / (d * self.hw.peak_flops_bf16 * self.hw.mxu_efficiency)
        memory = factor * (l.io_bytes_fwd / d) / self.hw.hbm_bandwidth
        comm = 2.0 * hwlib.allreduce_time(l.tp_collective_bytes, d, hw=self.hw)
        return max(compute, memory) + comm

    def layer_bwd_seconds(self, d: int = 1) -> List[float]:
        """Per-layer backward time on ``d`` chips, layer order — the
        hiding budget the shared sync cost model (core/sync.py
        SyncCostModel) overlaps bucket reductions against."""
        return [self.bwd_time(l, d) for l in range(self.num_layers)]

    def stage_fwd(self, u: int, v: int, d: int) -> float:
        return sum(self.fwd_time(i, d) for i in range(u, v))

    def stage_bwd(self, u: int, v: int, d: int) -> float:
        return sum(self.bwd_time(i, d) for i in range(u, v))

    # ------------------------------------------------------------------
    # Memory feasibility (choice of n0; Bamboo OOM reproduction).
    # ------------------------------------------------------------------
    def stage_memory_bytes(self, u: int, v: int, d: int,
                           num_inflight_mb: int = 1,
                           redundancy: float = 1.0) -> int:
        """Resident bytes per chip for stage [u, v) on d chips."""
        p = sum(self.layers[i].param_bytes for i in range(u, v)) // 2
        state = (p * 2 + p * 4 * 3) * redundancy / d
        if self.remat:  # only boundary activations retained per microbatch
            act = sum(self.layers[i].act_bytes for i in range(u, v)) * 0.05
            act += max((self.layers[i].act_bytes for i in range(u, v)), default=0)
        else:
            act = sum(self.layers[i].act_bytes for i in range(u, v))
        return int(state + act * num_inflight_mb / max(d // 1, 1))

    def min_nodes(self, gpus_per_node: int, max_stages_per_node: int = 8) -> int:
        """Smallest node count n0 whose aggregate HBM fits training state
        with headroom for activations — Oobleck's memory-driven floor."""
        need = self.train_state_bytes() * 1.35  # 35% activation/frag headroom
        per_node = self.hw.hbm_capacity * gpus_per_node
        n0 = max(1, -(-int(need) // int(per_node)))
        return n0


# ----------------------------------------------------------------------
# Profile construction from an ArchConfig.
# ----------------------------------------------------------------------
def _attn_flops(arch: ArchConfig, s: int, b: int) -> float:
    """Forward FLOPs of one attention layer (projections + SDPA)."""
    if arch.num_heads == 0:
        return 0.0
    d, H, KV, hd = arch.d_model, arch.num_heads, arch.num_kv_heads, arch.head_dim
    proj = 2.0 * b * s * d * (H * hd + 2 * KV * hd + H * hd)  # q,k,v,o GEMMs
    window = min(s, arch.sliding_window) if arch.sliding_window else s
    sdpa = 2.0 * 2.0 * b * H * s * window * hd  # qk^T and att*v
    return proj + sdpa


def _mlp_flops(arch: ArchConfig, s: int, b: int) -> float:
    if arch.moe is not None:
        m = arch.moe
        routed = 2.0 * b * s * d_ff_mats(arch) * arch.d_model * arch.d_ff * m.top_k
        shared = 2.0 * b * s * 3 * arch.d_model * m.shared_expert_d_ff
        router = 2.0 * b * s * arch.d_model * m.num_experts
        return routed + shared + router
    if arch.d_ff == 0:
        return 0.0
    return 2.0 * b * s * d_ff_mats(arch) * arch.d_model * arch.d_ff


def d_ff_mats(arch: ArchConfig) -> int:
    return 3 if arch.mlp_variant == "swiglu" else 2


def _ssm_flops(arch: ArchConfig, s: int, b: int) -> float:
    if arch.ssm is None:
        return 0.0
    c = arch.ssm
    d_inner = c.expand * arch.d_model
    nheads = d_inner // c.head_dim
    proj = 2.0 * b * s * arch.d_model * (2 * d_inner + 2 * c.n_groups * c.state_size + nheads)
    proj += 2.0 * b * s * d_inner * arch.d_model  # out_proj
    # SSD chunked scan: intra-chunk quadratic + inter-chunk state GEMMs.
    Q = c.chunk_size
    intra = 2.0 * b * (s * Q) * d_inner          # (s/Q chunks) * Q^2 * heads*P
    inter = 2.0 * 3.0 * b * s * c.state_size * d_inner
    conv = 2.0 * b * s * c.conv_width * (d_inner + 2 * c.n_groups * c.state_size)
    return proj + intra + inter + conv


def _block_flops(arch: ArchConfig, s: int, b: int) -> float:
    if arch.family == "ssm":
        return _ssm_flops(arch, s, b)
    if arch.hybrid_parallel_heads:
        return _attn_flops(arch, s, b) + _ssm_flops(arch, s, b) + _mlp_flops(arch, s, b)
    return _attn_flops(arch, s, b) + _mlp_flops(arch, s, b)


def build_profile(arch: ArchConfig, *, microbatch: int, seq_len: int,
                  hw: hwlib.HardwareSpec = hwlib.H100,
                  remat: bool = True) -> ModelProfile:
    """Build the planner's layer-cost profile for one (arch, mb, seq)."""
    b, s, d = microbatch, seq_len, arch.d_model
    act = 2 * b * s * d  # bf16 boundary activation

    emb_p = arch.vocab_size * d * 2
    head_p = 0 if arch.tie_embeddings else arch.vocab_size * d * 2
    block_p = arch.params_per_layer() * 2

    layers: List[LayerCost] = []
    layers.append(LayerCost(
        name="embed", flops_fwd=0.0, param_bytes=emb_p, act_bytes=act,
        io_bytes_fwd=float(act + b * s * 4), tp_collective_bytes=0.0))
    bf = _block_flops(arch, s, b)
    # TP all-reduces: 2 per block fwd (attention out + mlp out), Megatron.
    tp_bytes = 2.0 * act
    io = float(3 * act + block_p)
    for i in range(arch.num_layers):
        layers.append(LayerCost(
            name=f"block{i}", flops_fwd=bf, param_bytes=block_p,
            act_bytes=act, io_bytes_fwd=io, tp_collective_bytes=tp_bytes))
    head_flops = 2.0 * b * s * d * arch.vocab_size
    layers.append(LayerCost(
        name="lm_head", flops_fwd=head_flops,
        param_bytes=head_p + 2 * d, act_bytes=act,
        io_bytes_fwd=float(act + head_p + 2 * b * s * arch.vocab_size),
        tp_collective_bytes=float(act)))
    return ModelProfile(arch=arch, microbatch=b, seq_len=s, layers=layers,
                        hw=hw, remat=remat)


@functools.lru_cache(maxsize=64)
def cached_profile(arch_name: str, microbatch: int, seq_len: int) -> ModelProfile:
    from repro_torch.configs import get_arch
    return build_profile(get_arch(arch_name), microbatch=microbatch, seq_len=seq_len)
