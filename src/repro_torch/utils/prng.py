"""JAX's default PRNG (threefry-2x32, partitionable bit layout) in torch.

The serving plane samples token ``n`` of a request with
``categorical(fold_in(request key, position), logits / T)``
(``runtime/serve_exec.py``); the reference does that with
``jax.random``.  These functions compute the same keys and the same
random bits bitwise, and the same Gumbel noise up to the last bit of
``log``, so the port samples the reference's streams at any temperature
(away from ties between the two largest perturbed logits).

Every value is a uint32 held in an int64 tensor and masked to 32 bits
after each operation that can carry out of them, so the arithmetic runs
alike on the card and on the CPU.  A key is a ``[..., 2]`` int64 tensor
(``jax.random.PRNGKey``'s two words); functions broadcast over its
leading axes, so ``B`` keys and ``B`` positions give ``[B, n]`` bits in
one pass.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
#: threefry's key-schedule parity constant
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: float32 ``finfo.tiny``, the reference's lower bound of a Gumbel uniform
_TINY = 2.0 ** -126

Word = Union[torch.Tensor, int]


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words ``[0, seed]`` for a 32-bit
    seed (a negative one as its two's complement)."""
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0: Word, k1: Word, x0: Word, x1: Word
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds on broadcastable words: the block
    cipher ``jax.random`` hashes (key, counter) pairs with."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def fold_in(key: torch.Tensor, data: Word) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed with the counter
    ``(0, data)``.  key: [..., 2]; data: an int or a tensor broadcasting
    against ``key[..., 0]`` (taken as uint32)."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64)
    x0, x1 = threefry2x32(key[..., 0], key[..., 1], 0, data & _MASK)
    return torch.stack([x0, x1], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` in the partitionable layout: the two
    output words of threefry over the counters ``(0, i)``, xored.
    key: [..., 2] -> [..., n]."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    x0, x1 = threefry2x32(key[..., 0:1], key[..., 1:2], 0, i)
    return x0 ^ x1


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``: 23 random
    mantissa bits under the exponent of 1.0, minus 1, scaled into
    [minval, maxval), floored at minval."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # the bounds rounded to float32 and their float32 difference, as
    # Python floats (exact): scalars, so nothing is uploaded to the card
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(floats * span + lo, min=lo)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (its default "low" mode):
    ``-log(-log(u))`` with u uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, n, minval=_TINY)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    Gumbel-max trick, the first index on ties.  key: [..., 2]; logits:
    [..., V] float32 -> [...] int64."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)
