"""Gradient compression for the cross-replica sync path
(``repro/runtime/compression.py``).

The bucketed sync plane (``runtime/sync_exec.py``) flattens each bucket
into ONE fp32 buffer before encoding, so the wire format is
``encode_flat`` / ``decode_flat``:

  * ``none`` — the buffer as is;
  * ``bf16`` — cast to bf16 (2x smaller);
  * ``int8`` — symmetric quantisation with ONE fp32 scale per bucket
    (4x smaller), so the encoded size is exactly
    ``core.sync.flat_wire_bytes``.

The tree codecs ``compress`` / ``decompress`` encode a tree leaf by leaf
(int8: one scale per leaf) for unbucketed use; ``wire_bytes`` counts
their bytes and ``encoded_nbytes`` what an encoding really holds.

Lossy codecs run with error feedback: the residual (what the codec lost)
is carried into the next step's contribution, keyed per (bucket
signature, replica) and dropped on reconfiguration.
"""
from __future__ import annotations

from typing import Any, Dict, Hashable, Iterable, Optional

import torch

from repro_torch.core.sync import CODEC_WIRE, flat_wire_bytes  # noqa: F401 (re-export)
from repro_torch.utils.tree import tree_leaves, tree_map


def _is_int8(x: Any) -> bool:
    return isinstance(x, dict) and "q" in x


def _int8_leaves(enc: Any) -> list:
    """The {"q", "scale"} encodings of an int8 tree, in leaf order."""
    if _is_int8(enc):
        return [enc]
    if isinstance(enc, dict):
        return [d for k in sorted(enc) for d in _int8_leaves(enc[k])]
    if isinstance(enc, (list, tuple)):
        return [d for e in enc for d in _int8_leaves(e)]
    return []


def compress(tree: Any, codec: str) -> Any:
    """Encode every leaf of ``tree`` (int8: one scale per leaf)."""
    if codec not in ("none", "bf16", "int8"):
        raise ValueError(f"unknown codec {codec!r}")
    return tree if codec == "none" else tree_map(
        lambda g: encode_flat(g, codec), tree)


def decompress(tree: Any, codec: str) -> Any:
    """Decode what ``compress`` gave, back to fp32 leaves."""
    if isinstance(tree, dict) and not _is_int8(tree):
        return {k: decompress(tree[k], codec) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(decompress(t, codec) for t in tree)
    return decode_flat(tree, codec)


def roundtrip(tree: Any, codec: str) -> Any:
    return decompress(compress(tree, codec), codec)


def encode_flat(flat: torch.Tensor, codec: str) -> Any:
    if codec == "none":
        return flat
    if codec == "bf16":
        return flat.to(torch.bfloat16)
    if codec == "int8":
        scale = torch.clamp(flat.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
        return {"q": q, "scale": scale.float()}
    raise ValueError(f"unknown codec {codec!r}")


def decode_flat(enc: Any, codec: str) -> torch.Tensor:
    if codec == "none":
        return enc
    if codec == "bf16":
        return enc.float()
    if codec == "int8":
        return enc["q"].float() * enc["scale"]
    raise ValueError(f"unknown codec {codec!r}")


def roundtrip_flat(flat: torch.Tensor, codec: str) -> torch.Tensor:
    return decode_flat(encode_flat(flat, codec), codec)


def encoded_nbytes(enc: Any, codec: str) -> int:
    """Bytes an encoded bucket or tree really holds (int8: each leaf's
    int8 values and its fp32 scale)."""
    if codec == "int8":
        return sum(d["q"].numel() * d["q"].element_size()
                   + d["scale"].element_size() for d in _int8_leaves(enc))
    return sum(t.numel() * t.element_size() for t in tree_leaves(enc))


def wire_bytes(tree: Any, codec: str) -> int:
    """Bytes on the wire for a TREE-shaped payload (one scale per leaf
    under int8); a flattened bucket counts ``flat_wire_bytes``."""
    leaves = tree_leaves(tree)
    n = sum(t.numel() for t in leaves)
    return {"none": 4 * n, "bf16": 2 * n, "int8": n + 4 * len(leaves)}[codec]


class ErrorFeedback:
    """Keyed store of compression residuals: ``get``/``put`` per key,
    ``retain`` drops the keys a new bucket layout can no longer use."""

    def __init__(self, codec: str):
        self.codec = codec
        self.residuals: Dict[Hashable, torch.Tensor] = {}

    def get(self, key: Hashable) -> Optional[torch.Tensor]:
        return self.residuals.get(key)

    def put(self, key: Hashable, res: torch.Tensor) -> None:
        self.residuals[key] = res

    def retain(self, keys: Iterable[Hashable]) -> int:
        """Keep only ``keys``; returns how many stale residuals went."""
        keep = set(keys)
        stale = [k for k in self.residuals if k not in keep]
        for k in stale:
            del self.residuals[k]
        return len(stale)
