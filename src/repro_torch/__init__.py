"""Oobleck's resilient training path in PyTorch, for NVIDIA Hopper.

A port of the JAX package ``repro`` (which stays the reference): plan
pipeline templates, instantiate heterogeneous pipeline replicas, train
them with per-template stage programs whose blocks run hand-written CUDA
kernels (``kernels/csrc``), sync gradients per layer bucket, and recover
from node failures by copying layer state from surviving replicas.  The
layout mirrors ``repro``'s, so each module's counterpart sits at the same
path.  Nothing here imports JAX or the ``repro`` package.
"""
