"""GPT-3 2.7B (paper Table 1 row 4)."""
from repro_torch.configs.base import ArchConfig, register

GPT3_2_7B = register(ArchConfig(
    name="gpt3_2_7b", family="dense", num_layers=32, d_model=2560,
    num_heads=32, num_kv_heads=32, d_ff=10240, vocab_size=50257, mlp_variant="gelu",
    source="paper Table 1 [5]",
))
