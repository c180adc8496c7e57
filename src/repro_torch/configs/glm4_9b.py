"""glm4-9b — dense, RoPE, GQA kv=2.

[hf:THUDM/glm-4-9b] 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552.
"""
from repro_torch.configs.base import ArchConfig, register

GLM4_9B = register(ArchConfig(
    name="glm4_9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    rope_theta=10000.0,
    source="hf:THUDM/glm-4-9b",
))
