"""qwen3-1.7b — dense, GQA, qk_norm.

[hf:Qwen/Qwen3 family] 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936.
"""
from repro_torch.configs.base import ArchConfig, register

QWEN3_1_7B = register(ArchConfig(
    name="qwen3_1_7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B config family; hf",
))
