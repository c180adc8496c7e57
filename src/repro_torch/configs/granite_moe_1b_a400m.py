"""granite-moe-1b-a400m — MoE: 32 experts top-8, no shared experts.

[hf:ibm-granite/granite-3.0-1b-a400m-base] 24L d_model=1024 16H (kv=8)
expert d_ff=512 vocab=49155.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

GRANITE_MOE_1B_A400M = register(ArchConfig(
    name="granite_moe_1b_a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    tie_embeddings=True,
    moe=MoEConfig(num_experts=32, top_k=8),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
