"""Collectives over a ``ProcessMesh`` (``launch/mesh.py``), written as
``torch.autograd.Function``s so the step's backward runs their
transposes (the reference's GSPMD program writes them implicitly):

* ``gather_at_use``: FSDP's all-gather of a sharded weight along one
  dimension (and sequence parallelism's of an activation along the
  sequence); its backward is the gradient's reduce-scatter (sum).
* ``all_reduce_sum``: the sum over a group; its backward sums the
  cotangents over the same group (the global objective is the sum of the
  ranks' local objectives).
* ``copy_to_model`` and ``reduce_from_model``: Megatron's *f* and *g*
  over the tensor-parallel (``model``) group, whose ranks compute the
  same tokens and count the objective once between them.  *f* is the
  identity forward and sums the cotangent over the group backward (a
  replicated tensor entering a region where each rank computes its own
  heads, columns, experts or vocabulary rows); *g* sums the ranks'
  partial results forward and passes the cotangent on unchanged
  backward (leaving that region).  ``all_max``: the elementwise maximum
  over a group, with no gradient (the vocab-parallel log-sum-exp's
  shift).
* ``send_hop`` / ``recv_hop``: the pipeline hop.  ``send_hop`` sends an
  activation to the next stage and returns a zero scalar to add to the
  stage's loss; its backward receives the activation's cotangent from
  that stage.  ``recv_hop`` receives the activation; its backward sends
  the cotangent back.

``Transport`` moves the bytes.  Under NCCL every tensor goes as it is.
Under gloo (ranks sharing one card, or the CPU) a CUDA tensor goes as it
is to the collectives gloo takes CUDA tensors for (``GLOO_CUDA_OPS``,
from ``tools/gloo_cuda_probe.py`` on an H100 host's torch) and is
staged through a host copy for the others, on every call: a path chosen
by backend and operation, never by catching an error.

Order.  Every rank issues the same collectives in the same order: the
step is one program, the same on every rank, and its backward visits the
graph in the same order everywhere (the autograd engine runs the ready
node created last first, and the graphs are equal).  Point-to-point
hops are blocking sends and receives along a chain (stage s only ever
sends to s + 1 forward and to s - 1 backward, and each receives in the
order the other sends), so no cycle can wait on itself.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

#: gloo collectives that take CUDA tensors (tools/gloo_cuda_probe.py on
#: torch 2.11+cu128 on an H100 host: all_reduce, all_gather and
#: all_gather_into_tensor, reduce_scatter_tensor, broadcast and gather
#: do; send and recv abort the process on a device pointer); every other
#: op stages through host buffers
GLOO_CUDA_OPS = frozenset({"all_reduce", "all_gather", "reduce_scatter",
                           "broadcast", "gather"})

_KINDS = ("gathered", "reduced", "scattered", "p2p")


class Transport:
    """The bytes' path for one backend.  Since ``reset`` it counts, on
    this rank, the bytes of each call by kind (``gathered``: an
    all-gather's full output or a gather's shard; ``reduced``: an
    all-reduce's or a broadcast's buffer; ``scattered``: a
    reduce-scatter's full input; ``p2p``: a tensor sent or received)
    and the host seconds spent inside the calls, which include waiting
    for the other ranks and, for a CUDA tensor, for the work queued
    before it.  A call given a ``tag`` (what it moves: "kv", "mixer",
    "router"; under TP "tp" for the attention's and the MLP's
    activations, "vocab" for the embedding's and the loss's, "experts"
    for the MoE's) adds its bytes to ``tagged[tag][kind]`` too."""

    def __init__(self, backend: str):
        self.backend = backend
        self.reset()

    def reset(self) -> None:
        self.bytes: Dict[str, int] = dict.fromkeys(_KINDS, 0)
        self.tagged: Dict[str, Dict[str, int]] = {}
        self.seconds = 0.0

    def _count(self, kind: str, t: torch.Tensor, t0: float,
               tag: Optional[str] = None) -> None:
        n = t.numel() * t.element_size()
        self.bytes[kind] += n
        if tag is not None:
            per = self.tagged.setdefault(tag, dict.fromkeys(_KINDS, 0))
            per[kind] += n
        self.seconds += time.perf_counter() - t0

    def _staged(self, op: str, t: torch.Tensor) -> bool:
        return (self.backend == "gloo" and t.is_cuda
                and op not in GLOO_CUDA_OPS)

    def _out(self, op: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the collective takes it: contiguous, on the host
        when the op stages."""
        t = t.contiguous()
        return t.cpu() if self._staged(op, t) else t

    def all_reduce(self, t: torch.Tensor, pg, tag: Optional[str] = None
                   ) -> torch.Tensor:
        """The sum over ``pg``, a new tensor on ``t``'s device."""
        t0 = time.perf_counter()
        buf = self._out("all_reduce", t)
        buf = buf.clone() if buf.data_ptr() == t.data_ptr() else buf
        dist.all_reduce(buf, group=pg)
        self._count("reduced", t, t0, tag)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor, pg, n: int, dim: int,
                   tag: Optional[str] = None) -> torch.Tensor:
        """The members' ``t`` concatenated along ``dim``, in group order
        (``all_gather_into_tensor`` into one buffer over ``dim`` moved to
        the front)."""
        t0 = time.perf_counter()
        buf = self._out("all_gather", t.movedim(dim, 0))
        full = torch.empty((n * buf.shape[0], *buf.shape[1:]),
                           dtype=buf.dtype, device=buf.device)
        dist.all_gather_into_tensor(full, buf, group=pg)
        self._count("gathered", full, t0, tag)
        return full.movedim(0, dim).to(t.device)

    def reduce_scatter(self, t: torch.Tensor, pg, n: int, dim: int,
                       tag: Optional[str] = None) -> torch.Tensor:
        """This member's chunk along ``dim`` of the sum of the members'
        ``t`` (``reduce_scatter_tensor`` over ``dim`` moved to the
        front)."""
        t0 = time.perf_counter()
        buf = self._out("reduce_scatter", t.movedim(dim, 0))
        out = torch.empty((buf.shape[0] // n, *buf.shape[1:]),
                          dtype=buf.dtype, device=buf.device)
        dist.reduce_scatter_tensor(out, buf, group=pg)
        self._count("scattered", t, t0, tag)
        return out.movedim(0, dim).to(t.device)

    def gather(self, t: torch.Tensor, pg, n: int, dst: int
               ) -> Optional[List[torch.Tensor]]:
        """The members' ``t`` on global rank ``dst`` (group order), None
        on the others."""
        t0 = time.perf_counter()
        buf = self._out("gather", t)
        outs = ([torch.empty_like(buf) for _ in range(n)]
                if dist.get_rank() == dst else None)
        dist.gather(buf, outs, dst=dst, group=pg)
        self._count("gathered", t, t0)
        if outs is None:
            return None
        return [o.to(t.device) for o in outs]

    def broadcast(self, t: torch.Tensor, pg, src: int,
                  tag: Optional[str] = None) -> torch.Tensor:
        """Global rank ``src``'s ``t`` on every member."""
        t0 = time.perf_counter()
        buf = self._out("broadcast", t)
        buf = buf.clone() if buf.data_ptr() == t.data_ptr() else buf
        dist.broadcast(buf, src=src, group=pg)
        self._count("reduced", t, t0, tag)
        return buf.to(t.device)

    def send(self, t: torch.Tensor, dst: int) -> None:
        t0 = time.perf_counter()
        dist.send(self._out("send", t), dst=dst)
        self._count("p2p", t, t0)

    def recv(self, shape: Sequence[int], dtype, device, src: int
             ) -> torch.Tensor:
        t0 = time.perf_counter()
        probe = torch.empty(0, dtype=dtype, device=device)
        buf = torch.empty(tuple(shape), dtype=dtype,
                          device="cpu" if self._staged("recv", probe)
                          else device)
        dist.recv(buf, src=src)
        self._count("p2p", buf, t0)
        return buf.to(device)


# ----------------------------------------------------------------------
# Differentiable collectives
# ----------------------------------------------------------------------
class _GatherAtUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim, tag):
        pg, _ = mesh.group(axis)
        ctx.mesh, ctx.axis, ctx.dim, ctx.tag = mesh, axis, dim, tag
        return mesh.transport.all_gather(t, pg, mesh.size(axis), dim, tag)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        pg, _ = mesh.group(ctx.axis)
        return (mesh.transport.reduce_scatter(g, pg, mesh.size(ctx.axis),
                                              ctx.dim, ctx.tag),
                None, None, None, None)


def gather_at_use(t: torch.Tensor, mesh, axis, dim: int,
                  tag: Optional[str] = None) -> torch.Tensor:
    """``t``'s shards over ``axis`` concatenated along ``dim``; the
    gradient reduce-scatters back to this rank's shard."""
    if mesh.size(axis) == 1:
        return t
    return _GatherAtUse.apply(t, mesh, axis, dim, tag)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, tag):
        ctx.mesh, ctx.axis, ctx.tag = mesh, axis, tag
        return mesh.transport.all_reduce(t, mesh.group(axis)[0], tag)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.transport.all_reduce(g, ctx.mesh.group(ctx.axis)[0],
                                              ctx.tag), None, None, None)


def all_reduce_sum(t: torch.Tensor, mesh, axis, tag: Optional[str] = None
                   ) -> torch.Tensor:
    """The sum of ``t`` over ``axis``, on every member."""
    if mesh.size(axis) == 1:
        return t
    return _AllReduceSum.apply(t, mesh, axis, tag)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, tag):
        ctx.mesh, ctx.axis, ctx.tag = mesh, axis, tag
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.transport.all_reduce(g, ctx.mesh.group(ctx.axis)[0],
                                              ctx.tag), None, None, None)


def copy_to_model(t: torch.Tensor, mesh, axis, tag: Optional[str] = None
                  ) -> torch.Tensor:
    """Megatron's *f*: ``t`` as it is; its cotangent summed over
    ``axis``."""
    if mesh.size(axis) == 1:
        return t
    return _CopyToModel.apply(t, mesh, axis, tag)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, tag):
        return mesh.transport.all_reduce(t, mesh.group(axis)[0], tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def reduce_from_model(t: torch.Tensor, mesh, axis, tag: Optional[str] = None
                      ) -> torch.Tensor:
    """Megatron's *g*: the sum of ``t`` over ``axis``; its cotangent
    passed on as it is."""
    if mesh.size(axis) == 1:
        return t
    return _ReduceFromModel.apply(t, mesh, axis, tag)


def all_max(t: torch.Tensor, mesh, axis, tag: Optional[str] = None
            ) -> torch.Tensor:
    """The elementwise maximum of ``t`` over ``axis`` (no gradient): the
    members' ``t`` all-gathered and reduced here, so every member takes
    the same value."""
    t = t.detach()
    n = mesh.size(axis)
    if n == 1:
        return t
    parts = mesh.transport.all_gather(t[None], mesh.group(axis)[0], n, 0, tag)
    return parts.amax(0)


class _SendHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dst):
        mesh.transport.send(x, dst)
        ctx.mesh, ctx.dst = mesh, dst
        ctx.meta = (tuple(x.shape), x.dtype, x.device)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device = ctx.meta
        dy = ctx.mesh.transport.recv(shape, dtype, device, ctx.dst)
        return dy, None, None


def send_hop(x: torch.Tensor, mesh, dst: int) -> torch.Tensor:
    """Send ``x`` to global rank ``dst``; returns a zero scalar whose
    backward receives ``x``'s cotangent from ``dst``."""
    return _SendHop.apply(x, mesh, dst)


class _RecvHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, mesh, src, shape, dtype):
        ctx.mesh, ctx.src = mesh, src
        return mesh.transport.recv(shape, dtype, anchor.device, src)

    @staticmethod
    def backward(ctx, g):
        ctx.mesh.transport.send(g, ctx.src)
        return torch.zeros((), device=g.device), None, None, None, None


def recv_hop(mesh, src: int, shape, dtype, device) -> torch.Tensor:
    """Receive an activation from global rank ``src``; its cotangent is
    sent back to ``src`` in backward (when grad mode is on)."""
    anchor = torch.zeros((), device=device,
                         requires_grad=torch.is_grad_enabled())
    return _RecvHop.apply(anchor, mesh, src, tuple(shape), dtype)
