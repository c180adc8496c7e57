"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``csrc/fused.cu`` holds the kernels, ``build.py`` compiles and loads
them, ``fused.py`` wraps them (launch counters, autograd Functions),
``ref.py`` holds the plain versions and ``ops.py`` routes by device.
Importing this package compiles nothing.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
