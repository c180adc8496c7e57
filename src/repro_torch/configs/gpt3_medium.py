"""GPT-3 Medium 350M (paper Table 1 row 3)."""
from repro_torch.configs.base import ArchConfig, register

GPT3_MEDIUM = register(ArchConfig(
    name="gpt3_medium", family="dense", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=16, d_ff=4096, vocab_size=50257, mlp_variant="gelu",
    source="paper Table 1 [5]",
))
