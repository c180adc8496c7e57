"""mamba2-780m — SSD (state-space duality), attention-free.

[arXiv:2405.21060] 48L d_model=1536 d_ff=0 vocab=50280, ssm_state=128.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

MAMBA2_780M = register(ArchConfig(
    name="mamba2_780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,                    # attention-free, MLP-free Mamba2 stack
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(state_size=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256, n_groups=1),
    source="arXiv:2405.21060 (SSD); unverified",
))
