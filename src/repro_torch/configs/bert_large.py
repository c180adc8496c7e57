"""BERT-Large (paper Table 1 row 1) — used by the simulator benchmarks."""
from repro_torch.configs.base import ArchConfig, register

BERT_LARGE = register(ArchConfig(
    name="bert_large", family="dense", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=16, d_ff=4096, vocab_size=30522, mlp_variant="gelu",
    source="paper Table 1 [9]",
))
