"""phi-3-vision-4.2b — phi3-mini backbone + CLIP frontend (stub).

[hf:microsoft/Phi-3-vision-128k-instruct] 32L d_model=3072 32H (kv=32)
d_ff=8192 vocab=32064.  The vision tower is a STUB per the task spec:
``input_specs()`` supplies precomputed patch embeddings (576 tokens of
d_model) prepended to the text stream.
"""
from repro_torch.configs.base import ArchConfig, register

PHI3_VISION_4_2B = register(ArchConfig(
    name="phi3_vision_4_2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    frontend="vision",
    frontend_tokens=576,       # 24x24 CLIP patch grid
    source="hf:microsoft/Phi-3-vision-128k-instruct",
))
