"""musicgen-large — decoder-only over EnCodec tokens.

[arXiv:2306.05284; hf] 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.
The EnCodec audio frontend is a STUB: ``input_specs()`` provides
precomputed frame embeddings; the backbone trains/serves over codec
token ids in the 2048-entry codebook.
"""
from repro_torch.configs.base import ArchConfig, register

MUSICGEN_LARGE = register(ArchConfig(
    name="musicgen_large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    frontend="audio",
    frontend_tokens=256,       # conditioning frame embeddings
    source="arXiv:2306.05284; hf",
))
