"""Device selection for the port's entry points.

Entry points run on the card: they take ``device="cuda"`` by default and
only run on the CPU when the caller asks for it explicitly (the tests
do).  Asking for CUDA where there is none raises — nothing here ever
switches device on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but PyTorch sees no CUDA device; "
                "pass device='cpu' to run the plain versions on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def strict_fp32_numerics() -> None:
    """Full-fp32 products on the card: no TF32 in cuBLAS or cuDNN, so the
    port's fp32 path computes what the reference's fp32 path computes;
    and bf16 products summed in fp32 (no reduced-precision reduction in
    cuBLAS), as the reference's XLA products accumulate."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
