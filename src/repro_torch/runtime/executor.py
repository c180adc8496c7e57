"""Executor interface + template-keyed program cache
(``repro/runtime/executor.py``).

Every runtime sits behind one ``Executor`` interface — bind / step /
recover / join / snapshot — driven by the copied configuration engine
(``core/engine.py``).  ``ProgramCache`` holds the callables a runtime
builds, keyed by (kind, template signature, microbatch count, shapes,
backend signature), and counts builds and hits, so tests and the chip
run assert that a failure -> recover -> step cycle builds nothing.

A "program" in this slice is a Python callable built once per key;
CUDA graphs of those callables come later.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, Dict, Hashable, List, Optional, Set, Tuple

import torch

from repro_torch.utils.tree import tree_leaves_with_path, tree_map


def avals_of(tree):
    """Tree of tensors -> tree of ``meta`` tensors (shape and dtype, no
    storage): the skeleton programs are built and keyed from."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def tree_spec(tree) -> Tuple:
    """Hashable (path, shape, dtype) spec of a tree of tensors — the
    shape component of every ProgramCache key."""
    return tuple((path, tuple(leaf.shape), str(leaf.dtype))
                 for path, leaf in tree_leaves_with_path(tree))


def template_signature(template) -> Tuple[Tuple[int, int], ...]:
    """A PipelineTemplate's computational identity: the stage->layer
    tiling.  Templates with the same tiling run the SAME program
    regardless of which nodes host the stages."""
    return tuple((st.layer_start, st.layer_end) for st in template.stages)


@dataclasses.dataclass
class CacheStats:
    compiles: int = 0           # program builds
    hits: int = 0

    def as_dict(self) -> Dict[str, int]:
        return {"compiles": self.compiles, "hits": self.hits}


class ProgramCache:
    """Built programs keyed by (kind, signature, shapes).

    ``get_or_build`` is the only entry point: a miss runs ``builder`` and
    counts one build (``stats.compiles``, the reference's name); a hit
    returns the stored callable untouched."""

    def __init__(self) -> None:
        self._programs: Dict[Hashable, Callable] = {}
        self.stats = CacheStats()

    def get_or_build(self, key: Hashable, builder: Callable[[], Callable]
                     ) -> Callable:
        prog = self._programs.get(key)
        if prog is not None:
            self.stats.hits += 1
            return prog
        prog = builder()
        self._programs[key] = prog
        self.stats.compiles += 1
        return prog


class ExecutorUnsupported(RuntimeError):
    """The executor cannot express the requested transition; the
    engine's monitor path then keeps the PLAN consistent itself."""


class Executor(abc.ABC):
    """Uniform runtime contract driven by core/engine.py."""

    @abc.abstractmethod
    def bind(self) -> None:
        """(Re)bind state to the current pipeline set and ensure every
        program the set needs is present in the cache."""

    @abc.abstractmethod
    def step(self, batches: Any) -> Dict[str, Any]:
        """Run one training iteration; metrics come back as device
        tensors (no host sync inside the schedule)."""

    @abc.abstractmethod
    def recover(self, dead: Set[str], drained: bool = False) -> Dict[str, Any]:
        """Handle node failures: replan, rebuild state from surviving
        replicas, swap to the new pipeline set's cached programs."""

    @abc.abstractmethod
    def join(self, nodes: List[str]) -> Dict[str, Any]:
        """Elastic scale-up (same copy-plan path as recover)."""

    @abc.abstractmethod
    def snapshot(self, data_state: Optional[Dict] = None,
                 rng_seed: int = 0) -> Any:
        """Host-side train state for checkpointing."""
