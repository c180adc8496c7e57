"""Executor interface + template-keyed program cache
(``repro/runtime/executor.py``).

Every runtime sits behind one ``Executor`` interface — bind / step /
recover / join / snapshot — driven by the copied configuration engine
(``core/engine.py``).  ``ProgramCache`` holds the callables a runtime
builds, keyed by (kind, template signature, microbatch count, shapes,
backend signature), and counts builds and hits, so tests and the chip
run assert that a failure -> recover -> step cycle builds nothing.

A "program" in this slice is a Python callable built once per key;
CUDA graphs of those callables come later.  ``track_compiles`` and
``CompileCounter`` count every build process-wide — ProgramCache builds
and compiles of the kernel library — and ``track_host_transfers`` counts
the device->host reads inside a block (on the card it also runs the
block under ``torch.cuda.set_sync_debug_mode("error")``), so the
no-build and no-host-sync contracts are asserted, not trusted.
"""
from __future__ import annotations

import abc
import contextlib
import dataclasses
from typing import Any, Callable, Dict, Hashable, Iterator, List, Optional, Set, Tuple

import torch

from repro_torch.kernels import build as _build
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
        _build.notify_build("program")
        return prog


# ----------------------------------------------------------------------
# Build-count instrumentation (tests + benchmarks)
# ----------------------------------------------------------------------
@dataclasses.dataclass
class CompileLog:
    backend_compiles: int = 0       # builds of any kind inside the block
    _active: bool = True


@contextlib.contextmanager
def track_compiles() -> Iterator[CompileLog]:
    """Count builds inside the block — in ANY ProgramCache and of the
    kernel library — not just the ones of one trainer's cache::

        with track_compiles() as log:
            trainer.recover({victim}); trainer.train_step(batches)
        assert log.backend_compiles == 0
    """
    log = CompileLog()

    def listener(kind: str) -> None:
        if log._active:
            log.backend_compiles += 1

    _build.BUILD_LISTENERS.append(listener)
    try:
        yield log
    finally:
        log._active = False
        _build.BUILD_LISTENERS.remove(listener)


class CompileCounter:
    """Persistent build counter (the long-lived sibling of
    ``track_compiles``): registered once, never unregistered, so a
    process can report builds-since-mark at any point of its life."""

    def __init__(self) -> None:
        self.count = 0
        self._mark = 0

        def listener(kind: str) -> None:
            self.count += 1

        _build.BUILD_LISTENERS.append(listener)

    def mark(self) -> None:
        self._mark = self.count

    def since_mark(self) -> int:
        return self.count - self._mark


# ----------------------------------------------------------------------
# Host-transfer instrumentation (tests)
# ----------------------------------------------------------------------
@dataclasses.dataclass
class TransferLog:
    device_to_host: int = 0


#: Tensor methods that read a tensor's values back to the host
_READS = ("item", "tolist", "numpy", "__float__", "__int__", "__bool__")


def _to_cpu(args, kwargs) -> bool:
    """Whether ``Tensor.to(*args, **kwargs)`` targets the CPU."""
    for a in (*args, kwargs.get("device")):
        if isinstance(a, (str, torch.device)) and torch.device(a).type == "cpu":
            return True
        if isinstance(a, torch.Tensor) and a.device.type == "cpu":
            return True
    return False


@contextlib.contextmanager
def track_host_transfers(device=None) -> Iterator[TransferLog]:
    """Count device->host reads inside the block: ``item``, ``tolist``,
    ``numpy``, ``float()``/``int()``/``bool()`` of a tensor, and
    ``.cpu()``/``.to("cpu")`` of a CUDA tensor.  The methods are patched
    on ``torch.Tensor`` for the block's duration, so calls from every
    thread count.  Where ``device`` is a CUDA device the block also runs
    under ``torch.cuda.set_sync_debug_mode("error")``: any synchronizing
    CUDA call raises, a read these spies cannot see included; the
    previous mode is restored on exit."""
    log = TransferLog()
    saved = {name: torch.Tensor.__dict__.get(name)
             for name in (*_READS, "cpu", "to")}

    def spy(orig, counts):
        def read(self, *args, **kwargs):
            if counts(self, args, kwargs):
                log.device_to_host += 1
            return orig(self, *args, **kwargs)
        return read

    for name in _READS:
        setattr(torch.Tensor, name, spy(getattr(torch.Tensor, name),
                                        lambda t, a, kw: True))
    torch.Tensor.cpu = spy(torch.Tensor.cpu, lambda t, a, kw: t.is_cuda)
    torch.Tensor.to = spy(torch.Tensor.to,
                          lambda t, a, kw: t.is_cuda and _to_cpu(a, kw))
    on_card = device is not None and torch.device(device).type == "cuda"
    previous = torch.cuda.get_sync_debug_mode() if on_card else None
    try:
        if on_card:
            torch.cuda.set_sync_debug_mode("error")
        yield log
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode(previous)
        for name, orig in saved.items():
            if orig is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, orig)


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
