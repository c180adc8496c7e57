"""Sharding strategies: parameter, optimizer, batch and cache specs
(``repro/runtime/sharding.py``).

FSDP shards every >= 2-D parameter's largest dimension over the
``model`` axis and gathers it at use (ZeRO-3); ``tp`` is Megatron-style
tensor parallelism (column/row-parallel projections, expert parallelism
over the MoE's experts, a vocab-sharded embedding); either adds ZeRO-1
sharding of the Adam moments over the data axes.  A dimension is only
sharded where the mesh axis divides it.

Specs are plain tuples, one entry per tensor dimension: an axis name, a
tuple of axis names or ``None`` (replicated), entry for entry what the
reference's ``PartitionSpec`` holds on the same tree paths
(``blocks/attn/wq``, ``embed/table``, ...).  A mesh is anything with a
``.shape`` dict of axis sizes (``launch/mesh.py``'s ``AbstractMesh`` or
``ProcessMesh``); the specs need no process group and no device.

``act_constrainer`` and ``unshard_blocks`` are the model's ``constrain``
and ``unshard`` hooks.  On one card, or on an ``AbstractMesh``, they are
the identity (FSDP's ``gather_dtype`` cast aside).  On a ``ProcessMesh``
(``launch/mesh.py``) ``unshard_blocks`` is FSDP's real gather at use
over ``torch.distributed`` (``runtime/collectives.py``);
``act_constrainer`` stays the identity, since each rank already holds
its rows of the batch, and ``seq_context`` gives the model its
``SeqContext`` (the model's ``seq``): the batch axes a small batch
leaves uncovered, over which the sequence shards as the reference's
``P(batch, seq)`` constraint shards it, and every batch axis, over which
the MoE router's statistics are summed.  Under ``tp`` ``tp_context``
gives the model its ``TPContext`` (the model's ``tp``): this rank's
whole heads (attention and Mamba2; attention heads in pieces of one GQA
shape where a rank's query heads straddle kv groups), MLP columns,
experts and vocabulary rows, and Megatron's *f* and *g* over the model
axis, which the model places where the reference's GSPMD program would
put its collectives.
Handed a ``recorder`` (``launch/opcount.py``), they record the
collectives the strategy's layout implies where the reference's GSPMD
program would run them: the dry-run's trace.
``shard_tree`` / ``gather_tree`` cut a full tree into this rank's
shards and put it back together; ``shard_cache`` / ``gather_cache`` do
the same for a serving cache, laid out as a rank's decode writes it
(its rows and, under TP, its heads: ``shard_cache`` says where that
differs from ``cache_shardings``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.runtime.collectives import (all_max, all_reduce_sum,
                                            copy_to_model, gather_at_use,
                                            reduce_from_model)
from repro_torch.utils.tree import flatten_with_path, tree_unflatten_like

Spec = Tuple[Any, ...]


def _identity_constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    return x


def _identity_tree(tree):
    return tree


@dataclasses.dataclass(frozen=True)
class ShardingStrategy:
    """How to lay a model out on a ("pod",)? + ("data", "model") mesh."""

    strategy: str = "fsdp"        # fsdp | tp
    zero1: bool = True            # shard optimizer moments over data axes
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    #: gather FSDP weights in this dtype (None keeps the storage dtype):
    #: bf16 halves the all-gather bytes and the gathered buffers
    gather_dtype: Optional[str] = None

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """Axes the batch shards over: every axis under FSDP (compute is
        data-parallel on every card; ``model`` only shards storage), the
        data axes under TP."""
        if self.strategy == "fsdp":
            return self.data_axes + (self.model_axis,)
        return self.data_axes

    # ------------------------------------------------------------------
    def _axis_size(self, mesh, axis) -> int:
        if isinstance(axis, tuple):
            out = 1
            for a in axis:
                out *= mesh.shape[a]
            return out
        return mesh.shape[axis]

    def _maybe(self, mesh, dim_size: int, axis):
        """``axis`` if it divides ``dim_size``, else None (replicate)."""
        return axis if dim_size % self._axis_size(mesh, axis) == 0 else None

    # ------------------------------------------------------------------
    def param_spec(self, mesh, path: str, shape: Tuple[int, ...]) -> Spec:
        """Spec of one parameter.  ``path`` like 'blocks/attn/wq' (a
        leading 'blocks' means a stacked [L, ...] dimension)."""
        m = self.model_axis
        stacked = path.startswith("blocks/")
        lead = (None,) if stacked else ()
        body = tuple(shape[1:] if stacked else shape)

        def col(i):  # shard dimension i of the body
            specs = [None] * len(body)
            specs[i] = self._maybe(mesh, body[i], m)
            return (*lead, *specs)

        name = path.split("/")[-1]
        parent = path.split("/")[-2] if "/" in path else ""

        if self.strategy == "fsdp":
            if len(body) >= 2:
                # the largest dimension (the first of equals)
                return col(max(range(len(body)), key=lambda i: (body[i], -i)))
            return (*lead, *([None] * len(body)))

        # ---- Megatron TP ------------------------------------------------
        if parent == "moe" and name in ("gate", "up", "down"):
            return col(0)                       # expert parallelism over E
        if name in ("wq", "wk", "wv", "gate", "up", "in_proj"):
            return col(len(body) - 1)           # column parallel
        if name in ("wo", "down", "out_proj"):
            return col(len(body) - 2) if len(body) >= 2 else col(0)
        if name in ("bq", "bk", "bv"):
            return col(0)
        if name == "table":
            return col(0)                       # vocab-sharded embedding
        if name == "router":
            return (*lead, None, None)
        if name in ("conv_w", "conv_b"):
            return col(len(body) - 1)
        if name in ("A_log", "dt_bias", "D", "norm_w"):
            return col(0)
        return (*lead, *([None] * len(body)))

    def param_shardings(self, mesh, params: Any) -> Any:
        """Tree of specs, one per parameter leaf."""
        return _map_with_path(
            lambda p, leaf: self.param_spec(mesh, p, tuple(leaf.shape)),
            params)

    def _zero1(self, mesh, spec: Spec, shape) -> Spec:
        """ZeRO-1: additionally shard the first unsharded dimension the
        data axes divide (and that holds at least two shards)."""
        if not self.zero1:
            return spec
        spec = list(spec) + [None] * (len(shape) - len(spec))
        daxis = (self.data_axes if len(self.data_axes) > 1
                 else self.data_axes[0])
        n = self._axis_size(mesh, daxis)
        for i, (s, dim) in enumerate(zip(spec, shape)):
            if s is None and dim % n == 0 and dim >= 2 * n:
                spec[i] = daxis
                return tuple(spec)
        return tuple(spec)

    def opt_shardings(self, mesh, opt_state: Any, params: Any) -> Any:
        """Specs of an ``adamw.AdamWState``: the moments like the params,
        plus ZeRO-1; the step replicated."""
        def moment(p, leaf):
            return self._zero1(mesh, self.param_spec(mesh, p, leaf.shape),
                               tuple(leaf.shape))
        return type(opt_state)(step=(), m=_map_with_path(moment, params),
                               v=_map_with_path(moment, params))

    # ------------------------------------------------------------------
    def batch_spec(self, mesh, global_batch: int) -> Spec:
        """Shard the batch over the longest prefix of ``batch_axes`` that
        divides it (small serving batches drop the model axis first,
        then pods; batch 1 replicates)."""
        axes = list(self.batch_axes)
        while axes:
            axis = tuple(axes) if len(axes) > 1 else axes[0]
            if global_batch % self._axis_size(mesh, axis) == 0:
                return (axis,)
            axes.pop()
        return ()

    def seq_axis(self, mesh, global_batch: int):
        """The axes activations' sequence dimension shards over: the
        batch axes the (small) batch could not cover, or None."""
        bspec = self.batch_spec(mesh, global_batch)
        used = set()
        if bspec:
            used = set(bspec[0]) if isinstance(bspec[0], tuple) else {bspec[0]}
        leftover = tuple(a for a in self.batch_axes if a not in used)
        if not leftover:
            return None
        return leftover if len(leftover) > 1 else leftover[0]

    def seq_context(self, mesh, global_batch: int) -> Optional["SeqContext"]:
        """The model's ``seq`` on a ``ProcessMesh``: the sequence over
        ``seq_axis`` and the router statistics over every batch axis (a
        batch that covers them all shards no sequence); None elsewhere."""
        if not on_ranks(mesh):
            return None
        return SeqContext(mesh, self.seq_axis(mesh, global_batch),
                          tuple(a for a in mesh.shape
                                if a in self.batch_axes))

    def tp_context(self, mesh, arch) -> Optional["TPContext"]:
        """The model's ``tp`` under ``tp`` on a ``ProcessMesh`` whose
        model axis is larger than 1; None elsewhere (one card, FSDP, an
        ``AbstractMesh``)."""
        if (self.strategy != "tp" or not on_ranks(mesh)
                or mesh.size(self.model_axis) == 1):
            return None
        return TPContext.of(mesh, self.model_axis, arch)

    def act_constrainer(self, mesh, global_batch: int, recorder=None):
        """The model's ``constrain(x, name)`` hook: the identity, or with
        a ``recorder`` the TP collectives at each residual-stream site
        (``launch/opcount.py``)."""
        if recorder is None:
            return _identity_constrain
        return recorder.constrainer(self, mesh)

    def unshard_blocks(self, mesh, recorder=None, like=None):
        """The model's ``unshard(block_params)`` hook.  FSDP with a
        ``gather_dtype`` casts fp32 weights to it (what the gathered
        buffers hold); on a ``ProcessMesh`` it then gathers each weight's
        shards at use (``collectives.gather_at_use``, whose backward is
        the gradient's reduce-scatter), reading each block weight's spec
        from ``like``, the full parameter tree (a shard's shape does not
        name the dimension it was cut along); with a ``recorder`` FSDP's
        all-gather at use and its gradient reduce-scatter are recorded.
        TP: the identity (a block weight cut inside a head is gathered
        where the attention takes its heads, ``TPContext.take``)."""
        if self.strategy != "fsdp":
            return _identity_tree
        cast = getattr(torch, self.gather_dtype) if self.gather_dtype else None
        gather = (recorder.gatherer(self, mesh) if recorder is not None
                  else None)
        if on_ranks(mesh):
            if like is None:
                raise ValueError("unshard_blocks on a ProcessMesh needs "
                                 "like=, the full parameter tree")
            body = {p[len("blocks/"):]: spec[1:] for p, spec, _ in
                    spec_leaves(self.param_shardings(mesh, like), like)
                    if p.startswith("blocks/")}

            def gather(path, t):
                for dim, axis in sharded_dims(body[path[len("blocks/"):]]):
                    t = gather_at_use(t, mesh, axis, dim)
                return t
        if cast is None and gather is None:
            return _identity_tree

        def one(path, t):
            if cast is not None and t.dtype == torch.float32:
                t = t.to(cast)
            return gather("blocks/" + path, t) if gather is not None else t
        return lambda tree: _map_with_path(one, tree)

    def cache_shardings(self, mesh, cache: Any, batch: int) -> Any:
        """KV/SSM caches: the batch dimension over the batch axes where
        they divide it, else head_dim (attention) or heads (SSM) over
        ``model``.  Layouts: attn k/v [L, B, S, KV, D]; mamba conv
        [L, B, W, dim]; mamba ssm [L, B, H, P, N]."""
        bspec = self.batch_spec(mesh, batch)
        batch_axis = bspec[0] if bspec else None
        used = (set(batch_axis) if isinstance(batch_axis, tuple)
                else {batch_axis} if batch_axis else set())
        model_free = self.model_axis not in used

        def spec_for(pstr, leaf):
            shape = tuple(leaf.shape)
            dims = [None] * len(shape)
            if len(shape) >= 2:
                dims[1] = batch_axis
            if model_free:
                if "attn" in pstr and len(shape) == 5:
                    dims[4] = self._maybe(mesh, shape[4], self.model_axis)
                    if dims[4] is None:
                        dims[3] = self._maybe(mesh, shape[3], self.model_axis)
                elif "ssm" in pstr and len(shape) == 5:
                    dims[2] = self._maybe(mesh, shape[2], self.model_axis)
                    if dims[2] is None:
                        dims[3] = self._maybe(mesh, shape[3], self.model_axis)
                elif "conv" in pstr and len(shape) == 4:
                    dims[3] = self._maybe(mesh, shape[3], self.model_axis)
            return tuple(dims)
        return _map_with_path(spec_for, cache)


@dataclasses.dataclass(frozen=True, eq=False)
class SeqContext:
    """A rank's view of the sequence layout on a ``ProcessMesh``.
    ``axis``: the batch axes the global batch leaves uncovered (None when
    it covers all), over which a sequence of length S shards into n
    contiguous parts, this rank taking [r S/n, (r+1) S/n) for its index r
    along ``axis``; where n does not divide S, or S is 1, the sequence
    stays whole on every rank of the group (the reference's rule).
    ``stat_axis``: every batch axis, the ranks that hold other tokens,
    over which the MoE router's statistics are summed.  A model gets one
    from ``ShardingStrategy.seq_context``; it is None on one card."""

    mesh: Any
    axis: Any
    stat_axis: Tuple[str, ...]

    def shard(self, length: int) -> "SeqShard":
        """This rank's positions of a sequence of ``length``."""
        n = self.mesh.size(self.axis) if self.axis is not None else 1
        if n == 1 or length == 1 or length % n:
            return SeqShard(self, 0, length, length)
        r = self.mesh.axis_index(self.axis)
        return SeqShard(self, r * (length // n), (r + 1) * (length // n),
                        length)


@dataclasses.dataclass(frozen=True, eq=False)
class SeqShard:
    """Positions [start, stop) of a sequence of ``length`` on this rank
    (``SeqContext.shard``): the whole sequence unless ``sliced``."""

    ctx: SeqContext
    start: int
    stop: int
    length: int

    @property
    def sliced(self) -> bool:
        return self.stop - self.start < self.length

    def gather(self, t: torch.Tensor, tag: str) -> torch.Tensor:
        """The whole sequence of ``t`` ([b, stop - start, ...]) from every
        rank of the sequence group; its backward reduce-scatters."""
        return gather_at_use(t, self.ctx.mesh, self.ctx.axis, 1, tag)

    def all_reduce(self, t: torch.Tensor, tag: str) -> torch.Tensor:
        """The sum of ``t`` over every batch axis (the context's
        ``stat_axis``); its backward sums the cotangents over them."""
        return all_reduce_sum(t, self.ctx.mesh, self.ctx.stat_axis, tag)

    def from_last(self, t: torch.Tensor, tag: str) -> torch.Tensor:
        """``t`` as the rank holding the sequence's last position has it
        (the last of the sequence group), on every rank of the group; no
        gradient."""
        mesh = self.ctx.mesh
        pg, ranks = mesh.group(self.ctx.axis)
        return mesh.transport.broadcast(t.detach(), pg, ranks[-1], tag)


def _part(total: int, n: int, r: int) -> Optional[Tuple[int, int]]:
    """Rank r's [lo, hi) of a dimension of ``total`` cut into n equal
    parts, or None where n does not divide it (the spec keeps it whole:
    ``ShardingStrategy._maybe``)."""
    if total % n:
        return None
    k = total // n
    return r * k, (r + 1) * k


def _even(total: int, n: int, r: int) -> Tuple[int, int]:
    """Rank r's [lo, hi) of ``total`` whole units over n ranks, as evenly
    as they fall: the first ``total % n`` ranks take one unit more."""
    k, extra = divmod(total, n)
    lo = r * k + min(r, extra)
    return lo, lo + k + (1 if r < extra else 0)


def heads_fall(arch, n: int) -> bool:
    """Whether ``arch``'s heads fall on n ranks as whole kv groups or
    even parts of one (``tp_heads``' first two rules): at least n kv
    heads, or n dividing the query heads and a multiple of the kv heads.
    Elsewhere a rank's query heads may straddle two kv groups."""
    H, KV = arch.num_heads, arch.num_kv_heads
    return KV >= n or (H % n == 0 and n % KV == 0)


def _ssm_head_count(arch) -> int:
    c = arch.ssm
    return c.expand * arch.d_model // c.head_dim


def ssm_heads_fall(arch, n: int) -> bool:
    """Whether ``ssm_heads`` places ``arch``'s Mamba2 heads on n ranks:
    at least n heads, all reading one B / C group (every config's)."""
    return arch.ssm.n_groups == 1 and _ssm_head_count(arch) >= n


def tp_heads(arch, n: int, r: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Rank r's query heads and kv heads of ``arch`` over a model axis of
    n.  Where n divides the query heads and divides or is divided by the
    kv heads: H / n query heads each, and the kv heads they read, KV / n
    of them where n divides KV, else the one kv head a rank's query heads
    share.  Otherwise, with at least n kv heads, whole kv groups as
    evenly as they fall (``_even``), each with its G = H / KV query heads,
    so every rank keeps the group size.  Otherwise (fewer kv heads than
    ranks, not dividing them: hymba's 5 over 8) the query heads as evenly
    as they fall, and the kv heads they read, [q0 // G, ceil(q1 / G)): a
    kv head whose group two ranks split is computed on both (its columns
    gathered at use, ``TPContext.take``) and stored by the spec alone, and
    a rank's query heads run as pieces of one GQA shape each
    (``tp_pieces``).  Raises ``NotImplementedError`` where there are fewer
    query heads than ranks: a rank would compute none."""
    H, KV = arch.num_heads, arch.num_kv_heads
    if H % n == 0 and (KV % n == 0 or n % KV == 0):
        q0, q1 = _part(H, n, r)
        if KV % n == 0:
            return (q0, q1), _part(KV, n, r)
        k0 = q0 // (H // KV)
        return (q0, q1), (k0, k0 + 1)
    G = H // KV
    if KV >= n:
        k0, k1 = _even(KV, n, r)
        return (k0 * G, k1 * G), (k0, k1)
    if H < n:
        raise NotImplementedError(
            f"tp over a model axis of {n}: {H} query heads leave a rank "
            f"with no query head")
    q0, q1 = _even(H, n, r)
    return (q0, q1), (q0 // G, -(-q1 // G))


def tp_pieces(arch, heads: Tuple[int, int]
              ) -> Tuple[Tuple[Tuple[int, int], Tuple[int, int]], ...]:
    """The query heads ``heads`` = [q0, q1) of ``arch`` cut at multiples of
    the group size G = H / KV into pieces, each ((query lo, hi), (kv lo,
    hi)) of one GQA shape: a run of whole groups (G query heads a kv
    head) or part of one group (over one kv head).  The query heads of
    ``tp_heads`` where ``heads_fall`` holds are one piece."""
    G = arch.num_heads // arch.num_kv_heads
    a, q1 = heads
    out = []
    while a < q1:
        if a % G:                   # the rest of a group begun before a
            b = min(q1, a - a % G + G)
        else:                       # whole groups, else part of one
            b = q1 - q1 % G if q1 - q1 % G > a else q1
        out.append(((a, b), (a // G, -(-b // G))))
        a = b
    return tuple(out)


def ssm_heads(arch, n: int, r: int) -> Tuple[int, int]:
    """Rank r's Mamba2 heads of ``arch`` over a model axis of n, as evenly
    as they fall (hymba's 50 over 4: 13 / 13 / 12 / 12).  Raises
    ``NotImplementedError`` where there are fewer heads than ranks, or
    more than one B / C group (``ssm_heads_fall``)."""
    h = _ssm_head_count(arch)
    if not ssm_heads_fall(arch, n):
        raise NotImplementedError(
            f"tp over a model axis of {n}: {h} Mamba2 heads in "
            f"{arch.ssm.n_groups} B / C group(s) do not fall on whole heads "
            f"a rank")
    return _even(h, n, r)


@dataclasses.dataclass(frozen=True, eq=False)
class TPContext:
    """A rank's view of Megatron tensor and expert parallelism on a
    ``ProcessMesh`` (``ShardingStrategy.tp_context``).  The ranks along
    ``axis`` (the model axis) hold the same rows of the batch and the
    replicated residual stream; each computes its query heads ``heads``
    and their kv heads ``kv_heads``, its columns ``ff`` of the MLP (and
    ``shared_ff`` of the MoE's shared expert), its experts ``experts`` and
    its rows ``vocab`` of the embedding table: each a [lo, hi) range, or
    None where the spec keeps that dimension whole (the model axis does
    not divide it), and the computation there runs as on one card, the
    same on every rank.  ``ssm_heads`` are its Mamba2 heads.  Heads are
    placed whole (``tp_heads``, ``ssm_heads``) wherever the spec's cut
    falls, inside a head too: they decide what a rank computes, never
    what it stores.  ``pieces``: its query heads cut into pieces of one
    GQA shape each (``tp_pieces``), as ((query lo, hi), (kv lo, hi))
    relative to ``heads`` and ``kv_heads``; one piece wherever
    ``heads_fall`` holds, two or three where a rank's query heads
    straddle kv groups, whose kv head two ranks then both compute.
    ``f`` and ``g`` are Megatron's operators over
    ``axis`` (``runtime/collectives.py``): a replicated tensor enters a
    rank's part through ``f``, and the parts leave through ``g``.  The
    objective is counted once a model group: a gradient is never taken
    for the whole from one rank's part, and never summed twice."""

    mesh: Any
    axis: str
    heads: Optional[Tuple[int, int]]
    kv_heads: Optional[Tuple[int, int]]
    ff: Optional[Tuple[int, int]]
    shared_ff: Optional[Tuple[int, int]]
    experts: Optional[Tuple[int, int]]
    vocab: Optional[Tuple[int, int]]
    ssm_heads: Optional[Tuple[int, int]] = None
    pieces: Optional[Tuple] = None

    @classmethod
    def of(cls, mesh, axis: str, arch) -> "TPContext":
        n, r = mesh.size(axis), mesh.axis_index(axis)
        heads = kv = pieces = None
        if arch.num_heads:
            heads, kv = tp_heads(arch, n, r)
            pieces = tuple(((a - heads[0], b - heads[0]),
                            (c - kv[0], d - kv[0]))
                           for (a, b), (c, d) in tp_pieces(arch, heads))
        moe = arch.moe
        return cls(mesh, axis, heads, kv,
                   _part(arch.d_ff, n, r) if arch.d_ff else None,
                   (_part(moe.shared_expert_d_ff, n, r)
                    if moe is not None and moe.shared_expert_d_ff else None),
                   _part(moe.num_experts, n, r) if moe is not None else None,
                   _part(arch.vocab_size, n, r),
                   ssm_heads(arch, n, r) if arch.ssm is not None else None,
                   pieces)

    def f(self, t: torch.Tensor, tag: str = "tp") -> torch.Tensor:
        """Megatron's *f*: the identity; the cotangent summed over the
        model group."""
        return copy_to_model(t, self.mesh, self.axis, tag)

    def g(self, t: torch.Tensor, tag: str = "tp") -> torch.Tensor:
        """Megatron's *g*: the ranks' parts summed; the cotangent passed
        on."""
        return reduce_from_model(t, self.mesh, self.axis, tag)

    def gather(self, t: torch.Tensor, dim: int, tag: str) -> torch.Tensor:
        """The model group's ``t`` concatenated along ``dim`` in rank
        order (each rank's equal part, as the vocabulary rows); its
        backward reduce-scatters."""
        return gather_at_use(t, self.mesh, self.axis, dim, tag)

    def max(self, t: torch.Tensor, tag: str = "vocab") -> torch.Tensor:
        """The elementwise maximum over the model group, no gradient."""
        return all_max(t, self.mesh, self.axis, tag)

    def sum(self, t: torch.Tensor, tag: str) -> torch.Tensor:
        """The sum over the model group of a statistic each rank takes of
        its own part; its backward sums the cotangents (each rank's
        covers only its part's use), unlike *g*'s."""
        return all_reduce_sum(t, self.mesh, self.axis, tag)

    def whole(self, w: torch.Tensor, dim: int, full: int, tag: str = "tp"
              ) -> torch.Tensor:
        """A weight whose full extent along ``dim`` is ``full``, from what
        this rank holds of it: gathered at use where the spec cuts it
        there (the gather's backward reduce-scatters the sum of the ranks'
        gradients), else through ``f`` (its gradient summed over the
        group)."""
        if w.shape[dim] != full:
            return gather_at_use(w, self.mesh, self.axis, dim, tag)
        return self.f(w, tag)

    def take(self, w: torch.Tensor, dim: int, lo: int, hi: int, full: int,
             tag: str = "tp") -> torch.Tensor:
        """Columns [lo, hi) along ``dim`` of a weight whose full extent
        there is ``full``, from what this rank holds of it: its shard as
        it is where the shard is exactly those columns; else the weight
        gathered at use (a cut inside a head: the gather's backward
        reduce-scatters the sum of the ranks' gradients) or, held whole,
        through ``f`` (its gradient summed over the group), and then
        sliced (``whole``)."""
        have = w.shape[dim]
        r = self.mesh.axis_index(self.axis)
        if have != full and (lo, hi) == (r * have, (r + 1) * have):
            return w
        return self.whole(w, dim, full, tag).narrow(dim, lo, hi - lo)


def _key_name(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def path_str(path) -> str:
    """A key path as the reference's specs see it: 'blocks/attn/wq'."""
    return "/".join(_key_name(k) for k in path)


def _map_with_path(fn, tree):
    """``fn(path string, leaf)`` over ``tree``'s leaves, in its structure.
    A spec tree's leaves are tuples, which the tree utilities would walk
    into: read one with ``spec_leaves``."""
    pairs = list(flatten_with_path(tree))
    return tree_unflatten_like(tree, [fn(path_str(p), leaf)
                                      for p, leaf in pairs])


def spec_leaves(specs: Any, like: Any):
    """(path string, spec, leaf of ``like``) for every leaf of ``like``,
    the tree ``specs`` was built from."""
    out = []
    for path, leaf in flatten_with_path(like):
        node = specs
        for k in path:
            node = (node[k.key] if hasattr(k, "key") else
                    node[k.idx] if hasattr(k, "idx") else getattr(node, k.name))
        out.append((path_str(path), node, leaf))
    return out


# ----------------------------------------------------------------------
# A tree's shards on a ProcessMesh
# ----------------------------------------------------------------------
def on_ranks(mesh) -> bool:
    """Whether ``mesh`` places its axes on ranks (a ``ProcessMesh``,
    which carries the ``transport`` its collectives move bytes with)
    rather than only describing a layout."""
    return getattr(mesh, "transport", None) is not None


def sharded_dims(spec: Spec):
    """(dimension, axis) for every sharded dimension of ``spec``."""
    return [(d, a) for d, a in enumerate(spec) if a is not None]


def spec_axes(mesh, spec: Spec) -> Tuple[str, ...]:
    """Every axis ``spec`` shards over, in mesh order (none for a
    replicated spec, whatever ``mesh`` is)."""
    used = set()
    for _, a in sharded_dims(spec):
        used.update(a if isinstance(a, tuple) else (a,))
    return tuple(a for a in mesh.shape if a in used) if used else ()


def shard_shape(spec: Spec, shape, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` tensor."""
    out = list(shape)
    for dim, axis in sharded_dims(spec):
        out[dim] //= mesh.size(axis)
    return tuple(out)


def shard_leaf(spec: Spec, t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's slice of the full tensor ``t`` under ``spec`` (a
    contiguous copy)."""
    for dim, axis in sharded_dims(spec):
        n = mesh.size(axis)
        t = t.narrow(dim, mesh.axis_index(axis) * (t.shape[dim] // n),
                     t.shape[dim] // n)
    return t.contiguous().clone()


def gather_leaf(spec: Spec, t: torch.Tensor, mesh, to_root: bool = False
                ) -> Optional[torch.Tensor]:
    """The full tensor from every rank's shard ``t`` under ``spec``: on
    every rank, or with ``to_root`` on global rank 0 alone (None
    elsewhere).  The shards come over the group of every axis the spec
    names and are placed by each member's coordinates."""
    axes = spec_axes(mesh, spec)
    if not axes:
        return (t.clone() if not to_root or mesh.rank == 0 else None)
    pg, ranks = mesh.group(axes)
    tr = mesh.transport
    if to_root:
        parts = tr.gather(t, pg, len(ranks), ranks[0])
        if parts is None or mesh.rank != 0:
            return None
    else:
        parts = tr.all_gather(t, pg, len(ranks), 0).chunk(len(ranks), 0)
    full_shape = list(t.shape)
    for dim, axis in sharded_dims(spec):
        full_shape[dim] *= mesh.size(axis)
    full = torch.empty(full_shape, dtype=t.dtype, device=t.device)
    for member, part in zip(ranks, parts):
        view = full
        for dim, axis in sharded_dims(spec):
            n = t.shape[dim]
            view = view.narrow(dim, mesh.index_of(member, axis) * n, n)
        view.copy_(part)
    return full


def shard_tree(specs: Any, tree: Any, mesh) -> Any:
    """This rank's slices of the full ``tree`` under ``specs``."""
    leaves = [shard_leaf(spec, t, mesh)
              for _, spec, t in spec_leaves(specs, tree)]
    return tree_unflatten_like(tree, leaves)


def gather_tree(specs: Any, tree: Any, mesh, to_root: bool = False) -> Any:
    """The inverse of ``shard_tree``: the full tree from every rank's
    shards, on every rank or (``to_root``) on global rank 0 alone."""
    leaves = [gather_leaf(spec, t, mesh, to_root)
              for _, spec, t in spec_leaves(specs, tree)]
    if to_root and mesh.rank != 0:
        return None
    return tree_unflatten_like(tree, leaves)


# ----------------------------------------------------------------------
# A rank's serving cache on a ProcessMesh
# ----------------------------------------------------------------------
def batch_rows(strategy: ShardingStrategy, mesh, global_batch: int
               ) -> Tuple[Any, int, int]:
    """(the axes the batch's rows shard over or None, this rank's first
    row, its row past the last) under ``batch_spec``: every row where the
    batch is too small to cut (the ranks of those axes then hold the same
    rows)."""
    bspec = strategy.batch_spec(mesh, global_batch)
    if not bspec:
        return None, 0, global_batch
    n = global_batch // mesh.size(bspec[0])
    i = mesh.axis_index(bspec[0])
    return bspec[0], i * n, (i + 1) * n


def _cache_cuts(arch, strategy: ShardingStrategy, mesh):
    """{cache leaf: (dimension, [(lo, hi)] of each model rank, the
    dimension's whole tail every rank holds)} of the head cut under TP
    (empty elsewhere): the attention's kv heads (two ranks' ranges share
    a kv head whose group they split), the Mamba2 heads' SSM states and
    their x channels of the conv state (B and C, the conv channels after
    ``d_inner``, whole on every rank)."""
    if strategy.tp_context(mesh, arch) is None:
        return {}
    n = mesh.size(strategy.model_axis)
    cuts = {}
    if arch.num_heads:
        kv = [tp_heads(arch, n, r)[1] for r in range(n)]
        cuts["attn/k"] = cuts["attn/v"] = (3, kv, None)
    if arch.ssm is not None:
        heads = [ssm_heads(arch, n, r) for r in range(n)]
        P = arch.ssm.head_dim
        cuts["mamba/ssm"] = (2, heads, None)
        cuts["mamba/conv"] = (3, [(lo * P, hi * P) for lo, hi in heads],
                              _ssm_head_count(arch) * P)
    return cuts


def shard_cache(cache: Any, arch, strategy: ShardingStrategy, mesh,
                global_batch: int) -> Any:
    """This rank's part of a one-program serving cache (``Model.init_cache``
    of the global batch, [L, B, ...] leaves): its rows (``batch_rows``)
    and, under TP, its heads (``_cache_cuts``).  That is the cache a
    rank's decode writes, and it differs from ``cache_shardings``'s spec,
    which cuts the attention cache's head_dim (or, where that does not
    divide, its kv heads) and the conv channels over ``model`` wherever
    the rows leave the model axis free: a rank under TP computes whole
    heads, so it holds whole heads (the same bytes as the spec's shard
    where the model axis divides the kv heads; more on the ranks with
    one kv group more where it does not, and less on the others; a kv
    head two ranks compute is held, and written alike, by both), and
    the conv's B and C channels, which every rank computes, whole on
    every rank; under FSDP with rows too few to cover the model axis
    the model group computes the same rows and each holds them whole."""
    _, r0, r1 = batch_rows(strategy, mesh, global_batch)
    cuts = _cache_cuts(arch, strategy, mesh)
    r = mesh.axis_index(strategy.model_axis)

    def one(path, t):
        t = t[:, r0:r1]
        if path in cuts:
            dim, parts, tail = cuts[path]
            lo, hi = parts[r]
            mine = t.narrow(dim, lo, hi - lo)
            if tail is not None:
                mine = torch.cat([mine, t.narrow(dim, tail,
                                                 t.shape[dim] - tail)], dim)
            t = mine
        return t.contiguous().clone()
    return _map_with_path(one, cache)


def _gather_parts(t: torch.Tensor, mesh, axis, dim: int, sizes
                  ) -> torch.Tensor:
    """The group's parts of ``t`` along ``dim``, of ``sizes`` in rank
    order, concatenated: each padded to the largest for the gather."""
    most = max(sizes)
    if t.shape[dim] < most:
        pad = list(t.shape)
        pad[dim] = most - t.shape[dim]
        t = torch.cat([t, t.new_zeros(pad)], dim)
    pg, _ = mesh.group(axis)
    full = mesh.transport.all_gather(t, pg, len(sizes), dim)
    return torch.cat([full.narrow(dim, i * most, k)
                      for i, k in enumerate(sizes)], dim)


def _first_owned(parts):
    """Each rank's range of ``parts`` (ascending [lo, hi) ranges, a rank's
    first unit possibly its predecessor's last) less what an earlier rank
    holds: every unit from its first owner."""
    out, end = [], parts[0][0]
    for lo, hi in parts:
        start = min(max(lo, end), hi)
        out.append((start, hi))
        end = max(end, hi)
    return out


def gather_cache(cache: Any, arch, strategy: ShardingStrategy, mesh,
                 global_batch: int) -> Any:
    """One program's serving cache from every rank's part (the inverse
    of ``shard_cache``), on every rank: a kv head two ranks hold comes
    from the first."""
    axis, _, _ = batch_rows(strategy, mesh, global_batch)
    cuts = _cache_cuts(arch, strategy, mesh)
    r = mesh.axis_index(strategy.model_axis) if cuts else 0

    def one(path, t):
        if path in cuts:
            dim, parts, tail = cuts[path]
            k = parts[r][1] - parts[r][0]
            owned = _first_owned(parts)
            lo, hi = owned[r]
            whole = _gather_parts(t.narrow(dim, lo - parts[r][0], hi - lo),
                                  mesh, strategy.model_axis, dim,
                                  [b - a for a, b in owned])
            if tail is not None:
                whole = torch.cat([whole, t.narrow(dim, k, t.shape[dim] - k)],
                                  dim)
            t = whole
        if axis is None:
            return t.clone()
        return mesh.transport.all_gather(t, mesh.group(axis)[0],
                                         mesh.size(axis), 1)
    return _map_with_path(one, cache)


def strategy_for(arch, name: str = "fsdp",
                 data_axes: Tuple[str, ...] = ("data",)) -> ShardingStrategy:
    return ShardingStrategy(strategy=name, data_axes=data_axes)
