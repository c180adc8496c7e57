"""qwen2.5-3b — dense, GQA kv=2, QKV bias.

[hf:Qwen/Qwen2.5 family] 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936.
"""
from repro_torch.configs.base import ArchConfig, register

QWEN2_5_3B = register(ArchConfig(
    name="qwen2_5_3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen2.5-0.5B config family; hf",
))
