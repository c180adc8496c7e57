"""Carry parameter trees across the two packages through numpy.

The port keeps the JAX package's tree structure and stacked-block layout,
so a parameter tree converts leaf by leaf: ``params_from_numpy`` takes
the JAX package's parameters handed over as numpy arrays (the caller
runs ``jax.tree.map(np.asarray, params)``) and ``to_numpy`` goes back.
Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_map


def params_from_numpy(tree: Any, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> Any:
    """numpy tree -> tensor tree on ``device`` (copies every leaf)."""
    dev = resolve_device(device)

    def leaf(a):
        t = torch.from_numpy(np.array(a, copy=True)).to(dev)
        return t.to(dtype) if dtype is not None else t
    return tree_map(leaf, tree)


def to_numpy(tree: Any) -> Any:
    """tensor tree -> numpy tree (on the host)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
