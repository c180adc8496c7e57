"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``csrc/*.cu`` hold the kernels, ``build.py`` compiles, loads and
launches them (launch counters), ``fused.py`` and ``flash.py`` wrap them
(autograd Functions), ``autotune.py`` resolves their tiles, ``ref.py``
holds the plain versions and ``ops.py`` routes by device.
Importing this package compiles nothing.
"""
from repro_torch.kernels import autotune, ops, ref

__all__ = ["autotune", "ops", "ref"]
