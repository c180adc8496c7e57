"""GPT-2 345M (paper Table 1 row 2) — used by the simulator benchmarks."""
from repro_torch.configs.base import ArchConfig, register

GPT2 = register(ArchConfig(
    name="gpt2", family="dense", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=16, d_ff=4096, vocab_size=50257, mlp_variant="gelu",
    tie_embeddings=True, source="paper Table 1 [36] (medium)",
))
