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

Lossy codecs run with error feedback: the residual (what the codec lost)
is carried into the next step's contribution, keyed per (bucket
signature, replica) and dropped on reconfiguration.
"""
from __future__ import annotations

from typing import Any, Dict, Hashable, Iterable, Optional

import torch

from repro_torch.core.sync import CODEC_WIRE, flat_wire_bytes  # noqa: F401 (re-export)


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
