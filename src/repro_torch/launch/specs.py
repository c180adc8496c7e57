"""Shape-and-dtype stand-ins for every model input and state
(``repro/launch/specs.py``): the dry-run traces against these, and
nothing is ever allocated.

Stand-ins are ``meta`` tensors (shape and dtype, no storage), the
skeleton convention of ``runtime/executor.py::avals_of``.  The model's
trees come from ``Model.init`` / ``Model.init_cache`` traced under
FakeTensorMode on CPU fakes: the kernels' router and ``resolve_device``
refuse the ``meta`` device itself.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.optim import adamw
from repro_torch.runtime.executor import avals_of
from repro_torch.utils.tree import tree_map


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def params_shape(model, param_dtype: torch.dtype = torch.float32) -> Any:
    """The model's parameter tree; floating leaves in ``param_dtype``."""
    with FakeTensorMode():
        fake = model.init(torch.Generator())
    return tree_map(lambda t: meta(t.shape, param_dtype
                                   if t.is_floating_point() else t.dtype),
                    fake)


def opt_shape(model, pshape: Any) -> adamw.AdamWState:
    return adamw.init(pshape)


def batch_specs(arch: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """tokens and labels [B, S_text] int32; a frontend's embeddings [B,
    F, d] bf16 are carved out of the sequence."""
    B = shape.global_batch
    S_text = shape.seq_len - (arch.frontend_tokens if arch.frontend else 0)
    out = {"tokens": meta((B, S_text), torch.int32),
           "labels": meta((B, S_text), torch.int32)}
    if arch.frontend:
        out["frontend_embeds"] = meta((B, arch.frontend_tokens, arch.d_model),
                                      torch.bfloat16)
    return out


def prefill_specs(arch: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    out = batch_specs(arch, shape)
    del out["labels"]
    return out


def cache_shape(model, shape: ShapeConfig) -> Any:
    with FakeTensorMode():
        fake = model.init_cache(shape.global_batch, shape.seq_len,
                                device="cpu")
    return avals_of(fake)


def decode_specs(arch: ArchConfig, shape: ShapeConfig, model
                 ) -> Tuple[Any, Any, Any]:
    token = meta((shape.global_batch, 1), torch.int32)
    return token, cache_shape(model, shape), meta((), torch.int32)
