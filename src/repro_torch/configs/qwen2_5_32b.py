"""qwen2.5-32b — dense, GQA, QKV bias.

[hf:Qwen/Qwen2.5 family] 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064.
"""
from repro_torch.configs.base import ArchConfig, register

QWEN2_5_32B = register(ArchConfig(
    name="qwen2_5_32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5-0.5B config family; hf",
))
