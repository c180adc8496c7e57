"""hymba-1.5b — hybrid: parallel attention + mamba heads per block.

[arXiv:2411.13676; hf] 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16.  The attention branch uses sliding-window
attention (SWA) in most layers, which is what makes long_500k feasible.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

HYMBA_1_5B = register(ArchConfig(
    name="hymba_1_5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    hybrid_parallel_heads=True,
    sliding_window=2048,
    ssm=SSMConfig(state_size=16, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256, n_groups=1),
    source="arXiv:2411.13676; hf",
))
