"""Architecture + input-shape configuration system.

Every assigned architecture is a single ``ArchConfig`` in its own module
(``src/repro_torch/configs/<id>.py``) registered here via :func:`register`.
``ShapeConfig`` describes one assigned input-shape cell (train / prefill /
decode / long-decode).  The (arch x shape) grid drives smoke tests, the
multi-pod dry-run, and the roofline table.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    shared_expert_d_ff: int = 0  # d_ff of the (merged) shared expert, if any
    router_aux_loss_coef: float = 0.001


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block hyperparameters."""

    state_size: int = 128       # N: SSM state dimension
    head_dim: int = 64          # P: channels per SSD head
    expand: int = 2             # d_inner = expand * d_model
    conv_width: int = 4
    chunk_size: int = 256       # SSD chunked-scan block length
    n_groups: int = 1           # B/C groups (GVA-style)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """A complete decoder-family architecture description."""

    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int              # 0 for attention-free (ssm)
    num_kv_heads: int
    d_ff: int                   # dense MLP width; for MoE: per-expert width
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    mlp_variant: str = "swiglu"  # swiglu (3 mats) | gelu (2 mats)
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (Hymba): each block runs attention heads and SSM heads in
    # parallel and mixes their outputs (mean of the two branch outputs).
    hybrid_parallel_heads: bool = False
    # Sliding-window size used by attention branches at long context; 0 means
    # full (quadratic) attention only.
    sliding_window: int = 0
    # Modality frontend stub: None | "vision" | "audio".  When set,
    # input_specs() provides precomputed frame/patch embeddings and the
    # backbone consumes them directly (task spec: frontend is a STUB).
    frontend: Optional[str] = None
    frontend_tokens: int = 0    # number of prefix embedding tokens (vlm/audio)
    source: str = ""            # provenance note

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ------------------------------------------------------------------
    # Parameter accounting (used by 6ND, memory planning, and n0 choice).
    # ------------------------------------------------------------------
    def attn_params_per_layer(self) -> int:
        if self.num_heads == 0:
            return 0
        q = self.d_model * self.num_heads * self.head_dim
        kv = 2 * self.d_model * self.num_kv_heads * self.head_dim
        o = self.num_heads * self.head_dim * self.d_model
        bias = (self.num_heads + 2 * self.num_kv_heads) * self.head_dim if self.qkv_bias else 0
        qknorm = 2 * self.head_dim if self.qk_norm else 0
        return q + kv + o + bias + qknorm

    def mlp_params_per_layer(self) -> int:
        if self.moe is not None:
            routed = self.moe.num_experts * 3 * self.d_model * self.d_ff
            shared = 3 * self.d_model * self.moe.shared_expert_d_ff
            router = self.d_model * self.moe.num_experts
            return routed + shared + router
        if self.d_ff == 0:
            return 0
        mats = 3 if self.mlp_variant == "swiglu" else 2
        return mats * self.d_model * self.d_ff

    def ssm_params_per_layer(self) -> int:
        if self.ssm is None:
            return 0
        c = self.ssm
        d_inner = c.expand * self.d_model
        n_heads = d_inner // c.head_dim
        in_proj = self.d_model * (2 * d_inner + 2 * c.n_groups * c.state_size + n_heads)
        conv = c.conv_width * (d_inner + 2 * c.n_groups * c.state_size)
        out_proj = d_inner * self.d_model
        extras = 3 * n_heads + d_inner  # A_log, dt_bias, D, gated-norm weight
        return in_proj + conv + out_proj + extras

    def params_per_layer(self) -> int:
        norms = 2 * self.d_model
        body = self.mlp_params_per_layer() + norms
        if self.hybrid_parallel_heads:
            body += self.attn_params_per_layer() + self.ssm_params_per_layer()
        elif self.family == "ssm":
            body += self.ssm_params_per_layer()
        else:
            body += self.attn_params_per_layer()
        return body

    def embedding_params(self) -> int:
        emb = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        return emb + head + self.d_model  # + final norm

    def total_params(self) -> int:
        return self.num_layers * self.params_per_layer() + self.embedding_params()

    def active_params(self) -> int:
        """Per-token active parameters (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.total_params()
        m = self.moe
        active_mlp = (m.top_k * 3 * self.d_model * self.d_ff
                      + 3 * self.d_model * m.shared_expert_d_ff
                      + self.d_model * m.num_experts)
        per_layer = (self.attn_params_per_layer() + active_mlp + 2 * self.d_model)
        return self.num_layers * per_layer + self.embedding_params()

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch serve 500k-token contexts? (SSM / hybrid w/ SWA)."""
        return self.family == "ssm" or (self.hybrid_parallel_heads and self.sliding_window > 0)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_training(self) -> bool:
        return self.kind == "train"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"

    def tokens_per_step(self) -> int:
        if self.is_decode:
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


#: Assigned LM shape set (identical for all 10 archs; applicability filtered
#: by ``cells_for``).
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode"),
}

_REGISTRY: Dict[str, ArchConfig] = {}

#: Assigned architecture module names, in task order.
ARCH_IDS: List[str] = [
    "mamba2_780m", "hymba_1_5b", "phi3_vision_4_2b", "musicgen_large",
    "qwen2_5_32b", "qwen3_1_7b", "qwen2_5_3b", "glm4_9b",
    "qwen2_moe_a2_7b", "granite_moe_1b_a400m",
]

#: Paper-evaluation models (Table 1), used by the simulator benchmarks.
PAPER_IDS: List[str] = [
    "bert_large", "gpt2", "gpt3_medium", "gpt3_2_7b", "gpt3_6_7b",
]


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    """Look up an architecture by id (dashes and underscores equivalent)."""
    key = name.replace("-", "_").replace(".", "_")
    if key not in _REGISTRY:
        for mod in ARCH_IDS + PAPER_IDS:
            if mod not in _REGISTRY:
                importlib.import_module(f"repro_torch.configs.{mod}")
        if key not in _REGISTRY:
            raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def all_archs() -> List[ArchConfig]:
    return [get_arch(a) for a in ARCH_IDS]


def cells_for(arch: ArchConfig) -> List[ShapeConfig]:
    """The assigned (arch x shape) cells, applying the task's skip rules:
    - ``long_500k`` needs sub-quadratic attention -> SSM/hybrid only;
    - decode shapes skipped for encoder-only archs (none assigned).
    """
    cells = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if arch.subquadratic:
        cells.append(SHAPES["long_500k"])
    return cells


def all_cells() -> List[Tuple[ArchConfig, ShapeConfig]]:
    return [(a, s) for a in all_archs() for s in cells_for(a)]


def reduced(cfg: ArchConfig, *, layers: int = 2, d_model: int = 64,
            vocab: int = 512) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    heads = min(cfg.num_heads, 4) if cfg.num_heads else 0
    kv = max(1, min(cfg.num_kv_heads, heads)) if heads else 0
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(num_experts=4, top_k=min(2, cfg.moe.top_k),
                        num_shared_experts=min(1, cfg.moe.num_shared_experts),
                        shared_expert_d_ff=32 if cfg.moe.shared_expert_d_ff else 0)
    ssm = None
    if cfg.ssm is not None:
        ssm = SSMConfig(state_size=16, head_dim=16, expand=2, conv_width=4,
                        chunk_size=16, n_groups=1)
    return dataclasses.replace(
        cfg, name=cfg.name + "_smoke", num_layers=layers, d_model=d_model,
        num_heads=heads, num_kv_heads=kv, head_dim=(d_model // heads if heads else 0),
        d_ff=(0 if cfg.d_ff == 0 else d_model * 2), vocab_size=vocab,
        moe=moe, ssm=ssm, frontend_tokens=min(cfg.frontend_tokens, 16),
    )
