"""AdamW with global-norm clipping and warmup-cosine schedule, on trees
of tensors (``repro/optim/adamw.py``).

Weight decay applies to tensors with ndim >= 2 only; the moments and the
bias correction are fp32; ``step`` is an int32 tensor on the device, so
no step reads anything back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def init(params) -> AdamWState:
    leaf = tree_leaves(params)[0]
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=leaf.device),
                      m=zeros, v=tree_map(torch.clone, zeros))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    sq = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        sq = sq + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(sq)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def step_scalars(cfg: AdamWConfig, step: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lr, bc1, bc2) of the step after ``step``: the schedule's rate and
    the two bias corrections."""
    step = step + 1
    return (schedule(cfg, step), 1 - cfg.beta1 ** step.float(),
            1 - cfg.beta2 ** step.float())


def update(cfg: AdamWConfig, params, grads, state: AdamWState,
           decay: Optional[Sequence[bool]] = None,
           scalars: Optional[Tuple[torch.Tensor, ...]] = None
           ) -> Tuple[Any, AdamWState, torch.Tensor]:
    """One AdamW step on already-clipped fp32 grads (no norm computed):
    returns (new params, new state, lr).  Out of place: the caller
    replaces its tensors with the returned ones.  ``decay``, one flag a
    leaf in ``tree_leaves`` order, says which leaves take weight decay;
    by default those with ndim >= 2 (a caller stepping a piece of a leaf
    passes the whole leaf's rule).  ``scalars``: ``step_scalars(cfg,
    state.step)``, where a caller stepping many pieces computed them
    once."""
    step = state.step + 1
    lr, bc1, bc2 = scalars or step_scalars(cfg, state.step)
    b1, b2 = cfg.beta1, cfg.beta2
    m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.m, grads)
    v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.v, grads)

    flags = iter(decay if decay is not None else
                 [p.ndim >= 2 for p in tree_leaves(params)])

    def upd(p, m, v):
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        p32 = p.float()
        if next(flags):
            delta = delta + cfg.weight_decay * p32
        return (p32 - lr * delta).to(p.dtype)

    return tree_map(upd, params, m, v), AdamWState(step, m, v), lr


def apply(cfg: AdamWConfig, params, grads, state: AdamWState
          ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    grads = tree_map(lambda g: g.float(), grads)
    if cfg.clip_norm:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
    new_params, new_state, lr = update(cfg, params, grads, state)
    return new_params, new_state, {"lr": lr, "grad_norm": gnorm}
