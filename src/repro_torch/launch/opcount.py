"""Operation, memory and collective counts of a traced step: the
counterpart of ``repro/launch/hloparse.py``.

The reference parses XLA's optimized HLO of the per-device program.
PyTorch has no such module, so the port runs the step under
FakeTensorMode (no storage, no device) inside ``OpCounter``, a
``TorchDispatchMode`` that sees every ATen operator the step dispatches,
backward and remat recomputation included:

  * products (``mm``, ``addmm``, ``bmm``, ``baddbmm``: the reference's
    ``dot``) count 2 * prod(result dims) * prod(contracting dims)
    FLOPs and lhs + rhs + result bytes, hloparse's ``_dot_flops`` and
    ``_dot_bytes`` arithmetic;
  * convolutions (Mamba's depthwise conv, forward and backward) are
    counted apart, as the reference counts only ``dot``;
  * the peak of live tensor bytes: a storage born in the trace counts
    from the operator that returns it until the last tensor viewing it
    dies (a weakref finalizer on the storage), so the count does not
    depend on torch's own memory tools;
  * collectives are recorded by the sharding strategy's hooks
    (``runtime/sharding.py``): ``gatherer`` wraps an FSDP all-gather at
    use (its backward, the gradient's reduce-scatter) in an
    ``autograd.Function``, so a remat recompute repeats it;
    ``constrainer`` records Megatron TP's all-reduce at each residual
    site (forward: the row-parallel product's output; backward: the next
    column-parallel product's input gradient); ``record`` takes the
    rest (the gradients' data-parallel reduction).  Each is priced with
    hloparse's ring formulas (``collective_bytes``) and the bandwidth of
    its group (``launch/mesh.py::group_bandwidth``).

``ProgramStats`` keeps ``HloStats``'s fields; ``num_whiles`` is dropped
(a trace unrolls every loop, so there is none to count).
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import group_bandwidth, group_size
from repro_torch.utils.hw import H100, HardwareSpec

aten = torch.ops.aten
_MM = (aten.mm.default, aten.addmm.default)
_BMM = (aten.bmm.default, aten.baddbmm.default)
_CONV = (aten.convolution.default, aten.convolution_backward.default)

def collective_bytes(kind: str, k: int, result_bytes: float) -> float:
    """Ring traffic per device of one collective over ``k`` devices
    (hloparse's ``_collective_bytes``; result = gathered for an
    all-gather, scattered for a reduce-scatter)."""
    b = float(result_bytes)
    if kind == "all-reduce":
        return 2.0 * (k - 1) / k * b
    if kind == "all-gather":
        return (k - 1) / k * b
    if kind == "reduce-scatter":
        return (k - 1) * b
    if kind == "all-to-all":
        return (k - 1) / k * b
    return b   # collective-permute


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


@dataclasses.dataclass
class ProgramStats:
    dot_flops: float            # whole traced program
    collective_bytes: float     # per device, ring-adjusted
    collective_counts: Dict[str, int]
    collective_bytes_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    top_collectives: List[Tuple[float, str]] = dataclasses.field(
        default_factory=list)
    #: Σ (lhs + rhs + result bytes) over the products
    dot_bytes: float = 0.0
    conv_flops: float = 0.0
    #: most bytes live at once among storages born in the trace
    peak_bytes: int = 0
    #: Σ collective bytes / the bandwidth of each one's group
    collective_seconds: float = 0.0
    #: "kind site" (e.g. "all-reduce act-grad") -> bytes per device
    collective_bytes_by_site: Dict[str, float] = dataclasses.field(
        default_factory=dict)


class OpCounter(TorchDispatchMode):
    """Counts what a step dispatches (module docstring).  Use inside a
    FakeTensorMode: ``with FakeTensorMode(), OpCounter() as c: ...``."""

    def __init__(self, track_memory: bool = True,
                 full_shapes: Optional[Dict[str, Tuple[int, ...]]] = None,
                 hw: HardwareSpec = H100):
        super().__init__()
        #: each parameter path's full shape (stacked blocks without their
        #: [L] dimension): what an FSDP gather produces
        self.full_shapes = full_shapes or {}
        self.track_memory = track_memory
        self.hw = hw
        self.dot_flops = 0.0
        self.dot_bytes = 0.0
        self.conv_flops = 0.0
        self.live: Dict[int, int] = {}
        self.cur = 0
        self.peak = 0
        self.coll_bytes: Dict[str, float] = defaultdict(float)
        self.coll_counts: Dict[str, int] = defaultdict(int)
        self.coll_seconds = 0.0
        self._sites: Dict[Tuple[str, str, int], List[float]] = {}

    # ------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _MM:
            a, b = args[-2], args[-1]
            m, k = a.shape
            n = b.shape[1]
            self.dot_flops += 2.0 * m * n * k
            self.dot_bytes += _nbytes(a) + _nbytes(b) + m * n * a.element_size()
        elif func in _BMM:
            a, b = args[-2], args[-1]
            bs, m, k = a.shape
            n = b.shape[2]
            self.dot_flops += 2.0 * bs * m * n * k
            self.dot_bytes += (_nbytes(a) + _nbytes(b)
                               + bs * m * n * a.element_size())
        elif func in _CONV:
            self.conv_flops += self._conv_flops(func, args, out)
        if self.track_memory:
            seen = {t.untyped_storage()._cdata
                    for t in _tensors((*args, *(kwargs or {}).values()))}
            for t in _tensors(out):
                # a view or an in-place result shares an input's storage
                if t.untyped_storage()._cdata not in seen:
                    self._born(t)
        return out

    @staticmethod
    def _conv_flops(func, args, out) -> float:
        """2 x output elements x (input channels per group x kernel)
        forward; the backward's input and weight gradients twice that."""
        w = args[1] if func is aten.convolution.default else args[2]
        grad_out = out if func is aten.convolution.default else args[0]
        n = 2.0 * _prod(grad_out.shape) * _prod(w.shape[1:])
        return n if func is aten.convolution.default else 2.0 * n

    def _born(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.cur += n
        self.peak = max(self.peak, self.cur)
        weakref.finalize(st, self._died, key, n)

    def _died(self, key: int, n: int) -> None:
        if self.live.pop(key, None) is not None:
            self.cur -= n

    # ------------------------------------------------------------------
    # collectives
    # ------------------------------------------------------------------
    def record(self, kind: str, result_bytes: float, mesh, axis,
               site: str = "") -> None:
        """One collective of ``kind`` over ``axis`` whose result holds
        ``result_bytes`` on each device."""
        k = group_size(mesh, axis)
        if k <= 1:
            return
        b = collective_bytes(kind, k, result_bytes)
        self.coll_bytes[kind] += b
        self.coll_counts[kind] += 1
        self.coll_seconds += b / group_bandwidth(mesh, axis, self.hw)
        key = (kind, site, int(result_bytes))
        entry = self._sites.setdefault(key, [0.0, 0])
        entry[0] += b
        entry[1] += 1

    def gatherer(self, strategy, mesh):
        """FSDP's ``gather(path, local) -> full``: an all-gather over the
        model axis to the parameter's full shape (``full_shapes[path]``),
        whose backward reduce-scatters the gradient to the local shard."""
        rec = self

        def gather(path: str, t: torch.Tensor) -> torch.Tensor:
            full = tuple(rec.full_shapes[path])
            if tuple(t.shape) == full:
                return t
            return _Gather.apply(t, full, rec, mesh, strategy.model_axis,
                                 path)
        return gather

    def constrainer(self, strategy, mesh):
        """TP's ``constrain(x, name)``: at each residual site ("act") an
        all-reduce of x in the forward and of its gradient in the
        backward, over the model axis.  Identity otherwise."""
        rec = self
        if strategy.strategy != "tp":
            return lambda x, name: x

        def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
            if name != "act":
                return x
            return _ActAllReduce.apply(x, rec, mesh, strategy.model_axis)
        return constrain

    # ------------------------------------------------------------------
    def stats(self) -> ProgramStats:
        top = sorted(((b, f"{kind} x{n} {nb}B {site}")
                      for (kind, site, nb), (b, n) in self._sites.items()),
                     reverse=True)[:12]
        by_site: Dict[str, float] = {}
        for (kind, site, _), (b, _) in self._sites.items():
            by_site[f"{kind} {site}"] = by_site.get(f"{kind} {site}", 0.0) + b
        return ProgramStats(
            dot_flops=self.dot_flops,
            collective_bytes=float(sum(self.coll_bytes.values())),
            collective_counts=dict(self.coll_counts),
            collective_bytes_by_kind=dict(self.coll_bytes),
            top_collectives=top, dot_bytes=self.dot_bytes,
            conv_flops=self.conv_flops, peak_bytes=self.peak,
            collective_seconds=self.coll_seconds,
            collective_bytes_by_site=by_site)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (list, tuple)):
        for o in out:
            if isinstance(o, torch.Tensor):
                yield o


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, full, rec, mesh, axis, path):
        ctx.local = tuple(t.shape)
        ctx.rec, ctx.mesh, ctx.axis, ctx.path = rec, mesh, axis, path
        out = t.new_empty(full)
        rec.record("all-gather", _nbytes(out), mesh, axis, path)
        return out

    @staticmethod
    def backward(ctx, g):
        shard = g.new_empty(ctx.local)
        ctx.rec.record("reduce-scatter", _nbytes(shard), ctx.mesh, ctx.axis,
                       ctx.path)
        return shard, None, None, None, None, None


class _ActAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rec, mesh, axis):
        ctx.rec, ctx.mesh, ctx.axis = rec, mesh, axis
        rec.record("all-reduce", _nbytes(x), mesh, axis, "act")
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.rec.record("all-reduce", _nbytes(g), ctx.mesh, ctx.axis,
                       "act-grad")
        return g, None, None, None
