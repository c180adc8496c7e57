"""qwen2-moe-a2.7b — MoE: 60 routed experts top-4 + 4 shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B] 24L d_model=2048 16H (kv=16) expert
d_ff=1408 vocab=151936.  The 4 shared experts are merged into one
shared FFN of width 4*1408=5632 (matching the HF implementation).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

QWEN2_MOE_A2_7B = register(ArchConfig(
    name="qwen2_moe_a2_7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    qkv_bias=True,
    moe=MoEConfig(num_experts=60, top_k=4, num_shared_experts=4,
                  shared_expert_d_ff=5632),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
))
