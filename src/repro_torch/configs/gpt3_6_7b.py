"""GPT-3 6.7B (paper Table 1 row 5) — the paper's largest evaluated model."""
from repro_torch.configs.base import ArchConfig, register

GPT3_6_7B = register(ArchConfig(
    name="gpt3_6_7b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=32, d_ff=16384, vocab_size=50257, mlp_variant="gelu",
    source="paper Table 1 [5]",
))
