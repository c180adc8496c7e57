"""Deterministic data pipeline with heterogeneous per-pipeline minibatches
and exactly-once sample accounting across reconfigurations.

Oobleck redistributes the (fixed) global batch over heterogeneous
pipelines (Eq. 6), and the pipeline set changes on every failure/join.
The invariant the data layer must keep is: the multiset of sample indices
consumed per optimizer step equals [cursor, cursor + global_batch), no
matter how the batch is split — so training after a reconfiguration
continues the same sample stream (checkpoint/restore carries ``cursor``).

Sources:
  * ``SyntheticLM``  — stateless hash-based token sampler (sample i is a
    pure function of (seed, i)); lets tests assert exactly-once delivery.
  * ``ByteCorpus``   — byte-level tokenizer over a text file, windowed.

Each sample draws ``seq_len + 1`` tokens; ``batch()`` returns
``tokens = arr[:, :-1]`` and the PRE-SHIFTED next-token targets
``labels = arr[:, 1:]`` (``labels[:, t]`` is the target for position
``t``).  Losses consume labels as-is — no internal shift anywhere.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


class SyntheticLM:
    """sample(i) -> (tokens[seq+1]) deterministic in (seed, i)."""

    def __init__(self, vocab_size: int, seq_len: int, seed: int = 0):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.seed = seed

    def sample(self, index: int) -> np.ndarray:
        rng = np.random.Generator(np.random.Philox(key=self.seed,
                                                   counter=[0, 0, 0, index]))
        return rng.integers(0, self.vocab_size, size=self.seq_len + 1,
                            dtype=np.int32)

    def batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        arr = np.stack([self.sample(i) for i in indices])
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:],
                "_indices": np.asarray(indices, np.int64)}


class ByteCorpus:
    """Byte-level LM over a text blob; window i starts at a deterministic
    offset derived from i (wrap-around)."""

    def __init__(self, text: bytes, seq_len: int, vocab_size: int = 256):
        if len(text) < seq_len + 2:
            text = text * (2 + (seq_len + 2) // max(len(text), 1))
        self.data = np.frombuffer(text, dtype=np.uint8).astype(np.int32)
        self.seq_len = seq_len
        self.vocab_size = vocab_size

    def sample(self, index: int) -> np.ndarray:
        n = len(self.data) - self.seq_len - 1
        start = (index * 2654435761) % n          # Knuth multiplicative hash
        return self.data[start:start + self.seq_len + 1]

    def batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        arr = np.stack([self.sample(i) for i in indices])
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:],
                "_indices": np.asarray(indices, np.int64)}


@dataclasses.dataclass
class DataCursor:
    """Checkpointable position in the global sample stream."""

    next_index: int = 0

    def advance(self, n: int) -> range:
        r = range(self.next_index, self.next_index + n)
        self.next_index += n
        return r


class GlobalBatchDispenser:
    """Splits each global step's sample range across pipelines according
    to the current batch plan; re-splitting after reconfiguration keeps
    the stream exactly-once."""

    def __init__(self, source, cursor: Optional[DataCursor] = None):
        self.source = source
        self.cursor = cursor or DataCursor()

    def next_step(self, minibatch_sizes: Sequence[int]
                  ) -> List[Dict[str, np.ndarray]]:
        total = sum(minibatch_sizes)
        idx = list(self.cursor.advance(total))
        out = []
        ofs = 0
        for mb in minibatch_sizes:
            out.append(self.source.batch(idx[ofs:ofs + mb]))
            ofs += mb
        return out

    def rewind(self, n: int) -> None:
        """Give back the last ``n`` samples (iteration lost to a failure —
        paper: Oobleck loses at most one in-flight iteration, which is
        retried with the same data)."""
        self.cursor.next_index = max(0, self.cursor.next_index - n)

    def state(self) -> Dict:
        return {"next_index": self.cursor.next_index}

    def restore(self, state: Dict) -> None:
        self.cursor.next_index = int(state["next_index"])
