"""Decoder LM covering every assigned family (dense, MoE, SSM, hybrid,
vision and audio frontends) with the layer-granular API of
``repro/models/transformer.py``.

Parameters are plain dicts with blocks STACKED on a leading [L, ...]
axis (the JAX package's layout, so weights map 1:1 through
``repro_torch.convert``); the pipeline runtime slices ``blocks[i]`` per
layer, the paper's unit of planning, state copy and sync.

``fuse="fused"`` (what ``"auto"`` resolves to) routes the QKV projection
and the residual-add + RMSNorm block epilogue through
``kernels/ops.py``, ``attn_impl="kernel"`` (what ``"auto"`` resolves
to) routes attention through ``ops.flash_attention``, and
``ssd_impl="kernel"`` (what ``"auto"`` resolves to) the Mamba2 SSD scan
through ``ops.ssd``: the CUDA kernels on a CUDA tensor, the plain
versions on a CPU tensor, so none needs a probe.  ``moe_impl`` picks the
MoE dispatch (``models/moe.py``).

``seq`` (``runtime/sharding.py::SeqContext``, None on one card) is the
layout of a rank on a process mesh: ``hidden_states`` keeps this rank's
positions of the sequence after the embedding (where the reference's
first "act" constraint shards it), the blocks attend and scan over the
sequence group (``models/attention.py``, ``models/ssm.py``), the MoE
sums its router statistics over every batch rank (``models/moe.py``)
and ``loss`` averages over this rank's labelled positions.

``tp`` (``runtime/sharding.py::TPContext``, None on one card) is a
rank's part of Megatron tensor and expert parallelism: the attention
runs its heads (``models/attention.py``), the Mamba2 mixer its heads
(``models/ssm.py``), the MLP its columns between *f* and *g*, the MoE
its experts (``models/moe.py``), and a table cut over the vocabulary
embeds and scores vocab-parallel (``models/layers.py``).  hymba's two
branches share one *f* on the normed input and one *g* on their mean,
one all-reduce a direction for the pair.  The residual stream, the
norms and the fused residual-add + RMSNorm stay whole and the same on
every rank of the model group.  Serving runs the same parts: the decode
tick's mixers write a cache held at the rank's heads (``init_cache``),
and ``prefill`` and ``decode_step_`` gather the vocab-parallel logits
over the model group.  Without either context the model is the one-card
model.

The vision and audio frontends are stubs, as in the JAX package:
``frontend_embeds`` [b, F, d] are concatenated ahead of the token
embeddings and the loss drops their F positions.  ``remat`` recomputes
each block's activations in backward (``remat_policy="dots"`` keeps the
matrix products' outputs); ``loss_chunk > 0`` computes the loss with
the chunked CE, never building the [b, S, V] logits.  ``init_cache``,
``decode_step`` (``decode_step_`` in place) and ``prefill`` are the
serving path's model half.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (cross_entropy, embed,
                                       fused_cross_entropy, init_embedding,
                                       init_mlp, init_rms_norm, mlp, rms_norm,
                                       unembed, vocab_embed)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves, tree_map

#: the products whose outputs ``remat_policy="dots"`` keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _identity_constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    return x


def _identity_unshard(tree: Dict) -> Dict:
    return tree


@dataclasses.dataclass
class Model:
    arch: ArchConfig
    dtype: torch.dtype = torch.bfloat16  # activations; parameters are fp32
    attn_impl: str = "blocked"          # blocked | naive | kernel | auto
    ssd_impl: str = "chunked"           # chunked | scan | kernel | auto
    fuse: str = "auto"                  # auto | fused | none
    moe_impl: str = "dense"             # dense | grouped | capacity | capacity_vec
    remat: bool = True                  # recompute blocks in backward
    remat_policy: str = "full"          # full | dots
    loss_chunk: int = 0                 # > 0: the chunked CE
    #: sharding hooks (``runtime/sharding.py``): ``constrain(x, name)``
    #: on the residual stream ("act") and the logits, ``unshard`` on a
    #: block's params at entry; the identity unless a strategy sets them
    constrain: Callable[[torch.Tensor, str], torch.Tensor] = _identity_constrain
    unshard: Callable[[Dict], Dict] = _identity_unshard
    #: a rank's sequence layout on a process mesh (module docstring)
    seq: Optional[object] = None
    #: a rank's part of tensor and expert parallelism (module docstring)
    tp: Optional[object] = None

    def __post_init__(self):
        if self.attn_impl == "auto":
            self.attn_impl = "kernel"
        if self.attn_impl not in ("naive", "blocked", "kernel"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        if self.ssd_impl == "auto":
            self.ssd_impl = "kernel"
        if self.ssd_impl not in ("chunked", "scan", "kernel"):
            raise ValueError(f"unknown ssd_impl {self.ssd_impl!r}")
        if self.fuse == "auto":
            self.fuse = "fused"
        if self.fuse not in ("fused", "none"):
            raise ValueError(f"unknown fuse {self.fuse!r}")
        if self.moe_impl not in moe_lib.IMPLS:
            raise ValueError(f"unknown moe_impl {self.moe_impl!r}")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")

    # ------------------------------------------------------------------
    # Init
    # ------------------------------------------------------------------
    def init(self, gen: torch.Generator) -> Dict:
        """Same shapes and scales as the JAX package, drawn from ``gen``
        on its device (the numbers differ: use ``repro_torch.convert``
        to run on the JAX package's weights)."""
        a, pd = self.arch, torch.float32
        params = {"embed": init_embedding(gen, a.vocab_size, a.d_model, pd)}
        blocks = [self._init_block(gen) for _ in range(a.num_layers)]
        params["blocks"] = tree_map(lambda *xs: torch.stack(xs), *blocks)
        params["final_norm"] = init_rms_norm(a.d_model, pd, gen.device)
        if not a.tie_embeddings:
            params["head"] = init_embedding(gen, a.vocab_size, a.d_model, pd)
        return params

    def _init_block(self, gen: torch.Generator) -> Dict:
        a, pd = self.arch, torch.float32
        p: Dict = {"ln1": init_rms_norm(a.d_model, pd, gen.device)}
        if a.family == "ssm":
            p["mamba"] = ssm_lib.init_mamba(gen, a, pd)
            return p
        p["attn"] = attn_lib.init_attention(gen, a, pd)
        if a.hybrid_parallel_heads:
            p["mamba"] = ssm_lib.init_mamba(gen, a, pd)
        p["ln2"] = init_rms_norm(a.d_model, pd, gen.device)
        if a.moe is not None:
            p["moe"] = moe_lib.init_moe(gen, a, pd)
        elif a.d_ff:
            p["mlp"] = init_mlp(gen, a.d_model, a.d_ff, a.mlp_variant, pd)
        return p

    # ------------------------------------------------------------------
    # Single block (the pipeline runtime's unit)
    # ------------------------------------------------------------------
    def block(self, bp: Dict, x: torch.Tensor, aux: torch.Tensor, seq=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One block; ``seq`` is this rank's ``SeqShard`` of the sequence
        (None: the whole sequence, on one card)."""
        a = self.arch
        bp = self.unshard(bp)
        h = self._norm(bp["ln1"], x)
        if a.family == "ssm":
            x = x + ssm_lib.mamba(bp["mamba"], a, h, evaluator=self.ssd_impl,
                                  seq=seq, tp=self.tp)
            return self.constrain(x, "act"), aux
        fused = self.fuse == "fused"
        if a.hybrid_parallel_heads:
            branch = self._hybrid(bp, h, seq)
        else:
            branch = attn_lib.attention(bp["attn"], a, h, impl=self.attn_impl,
                                        fused=fused, seq=seq, tp=self.tp)
        if fused:
            # one pass over the residual: (x + branch) and its RMSNorm
            x, h = kops.fused_add_rmsnorm(x, branch, bp["ln2"].to(x.dtype),
                                          eps=a.rms_norm_eps)
            x = self.constrain(x, "act")
        else:
            x = self.constrain(x + branch, "act")
            h = self._norm(bp["ln2"], x)
        x, aux = self._ffn(bp, x, h, aux, seq)
        return self.constrain(x, "act"), aux

    def _hybrid(self, bp: Dict, h, seq=None):
        """hymba's mean of its attention and Mamba2 branches on h; under
        ``tp`` one *f* on h and one *g* on the mean of the rank's parts."""
        a, tp = self.arch, self.tp
        if tp is not None:
            h = tp.f(h)
        kw = dict(seq=seq, tp=tp, part=tp is not None)
        y = 0.5 * (attn_lib.attention(bp["attn"], a, h, impl=self.attn_impl,
                                      fused=self.fuse == "fused", **kw)
                   + ssm_lib.mamba(bp["mamba"], a, h,
                                   evaluator=self.ssd_impl, **kw))
        return tp.g(y) if tp is not None else y

    def _ffn(self, bp: Dict, x, h, aux, seq=None):
        """The block's MLP or MoE on h, added to the residual x; the MoE's
        load-balance loss is added to aux."""
        a, tp = self.arch, self.tp
        if a.moe is not None:
            y, a_loss = moe_lib.IMPLS[self.moe_impl](bp["moe"], a, h, seq,
                                                     tp=tp)
            return x + y, aux + a_loss
        if a.d_ff and tp is not None and tp.ff is not None:
            # column-parallel up / gate, row-parallel down
            x = x + tp.g(mlp(bp["mlp"], tp.f(h), a.mlp_variant))
        elif a.d_ff:
            x = x + mlp(bp["mlp"], h, a.mlp_variant)
        return x, aux

    def _norm(self, w, x):
        return rms_norm(w.to(x.dtype), x, self.arch.rms_norm_eps)

    def run_blocks(self, blocks: Dict, x: torch.Tensor, aux: torch.Tensor,
                   seq=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Apply a stacked slice of blocks (the full model), each under a
        checkpoint when ``remat``; ``seq`` as ``block``'s."""
        kw = {}
        if self.remat_policy == "dots":
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _save_dots)
        n = tree_leaves(blocks)[0].shape[0]
        for i in range(n):
            bp = tree_map(lambda t: t[i], blocks)
            if self.remat:
                x, aux = checkpoint(self.block, bp, x, aux, seq,
                                    use_reentrant=False, **kw)
            else:
                x, aux = self.block(bp, x, aux, seq)
        return x, aux

    # ------------------------------------------------------------------
    # Full forward / loss
    # ------------------------------------------------------------------
    def hidden_states(self, params: Dict, tokens: torch.Tensor,
                      frontend_embeds: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward up to (and including) the final norm; no head.  Under
        ``seq``, of this rank's positions only."""
        x = self._embed(params, tokens)
        if frontend_embeds is not None:
            x = torch.cat([frontend_embeds.to(self.dtype), x], dim=1)
        shard = self.seq.shard(x.shape[1]) if self.seq is not None else None
        if shard is not None and shard.sliced:
            x = x[:, shard.start:shard.stop]
        x = self.constrain(x, "act")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        x, aux = self.run_blocks(params["blocks"], x, aux, shard)
        return self._norm(params["final_norm"], x), aux

    def _embed(self, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
        if self._vocab_tp is not None:
            return vocab_embed(params["embed"], tokens, self.dtype, self.tp)
        return embed(params["embed"], tokens, self.dtype)

    @property
    def _vocab_tp(self):
        """``tp`` where it cuts the table over the vocabulary, else None
        (the table whole: the one-card embedding and loss)."""
        return self.tp if self.tp is not None and self.tp.vocab else None

    def _logits(self, head: Dict, x: torch.Tensor) -> torch.Tensor:
        """The head's logits of x: under a vocab-parallel ``tp`` this
        rank's vocabulary rows' of *f*(x)."""
        if self._vocab_tp is not None:
            return unembed(head, self.tp.f(x, "vocab"))
        return self.constrain(unembed(head, x), "logits")

    def _whole_logits(self, head: Dict, x: torch.Tensor) -> torch.Tensor:
        """The serving logits of x over the whole vocabulary: under a
        vocab-parallel ``tp`` this rank's rows gathered over the model
        group, as the reference's serving out-specs replicate V."""
        if self._vocab_tp is None:
            return self.constrain(unembed(head, x), "logits")
        return self.tp.gather(self._logits(head, x), x.dim() - 1, "vocab")

    def forward(self, params: Dict, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: [b, S] -> logits [b, F + S, V], aux loss."""
        x, aux = self.hidden_states(params, tokens, frontend_embeds)
        head = params.get("head", params["embed"])
        return self.constrain(unembed(head, x), "logits"), aux

    def loss(self, params: Dict, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """nll + router_aux_loss_coef * aux, with {"nll", "aux"}.  Labels
        are PRE-SHIFTED next-token targets; the final position is
        excluded from the mean (the reference's S-1 reduction), and so
        are the frontend positions; a 0/1 ``mask`` excludes more."""
        labels, mask = batch["labels"], batch.get("mask")
        coef = (self.arch.moe.router_aux_loss_coef
                if self.arch.moe is not None else 0.0)
        fe = batch.get("frontend_embeds")
        span = self._label_span(batch)
        if span is not None:
            return self._shard_loss(params, batch, span, coef)
        if self.loss_chunk:
            x, aux = self.hidden_states(params, batch["tokens"], fe)
            x = x[:, x.shape[1] - labels.shape[1]:]
            head = params.get("head", params["embed"])
            nll = fused_cross_entropy(x, head["table"], labels,
                                      self.loss_chunk, mask,
                                      tp=self._vocab_tp)
        elif self._vocab_tp is not None:
            x, aux = self.hidden_states(params, batch["tokens"], fe)
            logits = self._logits(params.get("head", params["embed"]),
                                  x[:, x.shape[1] - labels.shape[1]:])
            nll = cross_entropy(logits[:, :-1], labels[:, :-1],
                                mask[:, :-1] if mask is not None else None,
                                tp=self.tp)
        else:
            logits, aux = self.forward(params, batch["tokens"], fe)
            logits = logits[:, logits.shape[1] - labels.shape[1]:]
            nll = cross_entropy(logits[:, :-1], labels[:, :-1],
                                mask[:, :-1] if mask is not None else None)
        return nll + coef * aux, {"nll": nll, "aux": aux}

    def _label_span(self, batch: Dict):
        """Under a sliced sequence shard: (this rank's shard, its first
        labelled row, the labels' first index); None otherwise.  Labels
        cover the positions after the frontend's F."""
        if self.seq is None:
            return None
        fe = batch.get("frontend_embeds")
        F_ = fe.shape[1] if fe is not None else 0
        shard = self.seq.shard(F_ + batch["labels"].shape[1])
        if not shard.sliced:
            return None
        lo = max(shard.start, F_)
        return shard, lo - shard.start, lo - F_

    def loss_weights(self, batch: Dict) -> Optional[torch.Tensor]:
        """Under a sliced sequence shard, the 0/1 weight of each labelled
        position this rank holds ([b, n] fp32): the mask's, and 0 at the
        sequence's final position (the reference's S-1 reduction), which
        the last shard holds; None otherwise (``loss`` then averages as
        on one card)."""
        span = self._label_span(batch)
        if span is None:
            return None
        shard, _, l0 = span
        labels, mask = batch["labels"], batch.get("mask")
        l1 = max(labels.shape[1] - (shard.length - shard.stop), l0)
        w = (mask[:, l0:l1].float() if mask is not None else
             torch.ones((labels.shape[0], l1 - l0), dtype=torch.float32,
                        device=labels.device))
        if shard.stop == shard.length and w.shape[1]:
            w = torch.cat([w[:, :-1], torch.zeros_like(w[:, -1:])], 1)
        return w

    def _shard_loss(self, params: Dict, batch: Dict, span, coef
                    ) -> Tuple[torch.Tensor, Dict]:
        """``loss`` on this rank's positions: the weighted mean NLL over
        ``loss_weights``."""
        _, r0, l0 = span
        w = self.loss_weights(batch)
        labels = batch["labels"][:, l0:l0 + w.shape[1]]
        x, aux = self.hidden_states(params, batch["tokens"],
                                    batch.get("frontend_embeds"))
        x = x[:, r0:]
        head = params.get("head", params["embed"])
        if not w.shape[1]:
            # no labelled position here: a zero that keeps the graph, so
            # this rank's backward runs the group's collectives too
            nll = x.float().sum() * 0.0
        elif self.loss_chunk:
            nll = fused_cross_entropy(x, head["table"], labels,
                                      self.loss_chunk, w, drop_last=False,
                                      tp=self._vocab_tp)
        else:
            nll = cross_entropy(self._logits(head, x), labels, w,
                                tp=self._vocab_tp)
        return nll + coef * aux, {"nll": nll, "aux": aux}

    # ------------------------------------------------------------------
    # Serving: prefill + one-token decode against per-layer caches
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device="cuda") -> Dict:
        """Per-layer caches stacked on a leading [L] axis: the attention
        KV cache (a ring buffer of the window's length with a sliding
        window) and the Mamba conv and SSM states, of ``batch`` rows (a
        rank's rows on a process mesh); under ``tp`` at the rank's kv
        heads and Mamba2 heads, the cache its decode writes."""
        a, dev, tp = self.arch, resolve_device(device), self.tp
        c: Dict = {}
        if a.family == "ssm" or a.hybrid_parallel_heads:
            c["mamba"] = ssm_lib.init_mamba_cache(
                a, batch, self.dtype, dev,
                heads=tp.ssm_heads if tp is not None else None)
        if a.num_heads:
            c["attn"] = attn_lib.init_kv_cache(
                a, batch, max_len, self.dtype, dev,
                kv_heads=tp.kv_heads if tp is not None else None)
        return tree_map(lambda t: t.expand(a.num_layers, *t.shape).clone(), c)

    def decode_block_(self, bp: Dict, cache: Dict, x: torch.Tensor,
                      pos: torch.Tensor, write=None) -> torch.Tensor:
        """One block's decode, writing its new K/V rows and Mamba states
        into ``cache`` (this layer's views) in place; ``write`` ([b] bool)
        keeps the cache of the rows where it is False.  Under ``tp`` the
        mixers, the MLP and the MoE run the rank's part, hymba's two
        branches under one *f* and one *g* as in ``_hybrid``."""
        a, tp = self.arch, self.tp
        bp = self.unshard(bp)
        h = self._norm(bp["ln1"], x)
        if a.family == "ssm":
            return x + ssm_lib.mamba_decode_(bp["mamba"], a, h,
                                             cache["mamba"], write, tp=tp)
        if a.hybrid_parallel_heads:
            hp = tp.f(h) if tp is not None else h
            kw = dict(tp=tp, part=tp is not None)
            y = attn_lib.decode_attention_(bp["attn"], a, hp, cache["attn"],
                                           pos, write, **kw)
            ym = ssm_lib.mamba_decode_(bp["mamba"], a, hp, cache["mamba"],
                                       write, **kw)
            y = 0.5 * (y + ym)
            if tp is not None:
                y = tp.g(y)
        else:
            y = attn_lib.decode_attention_(bp["attn"], a, h, cache["attn"],
                                           pos, write, tp=tp)
        x = x + y
        x, _ = self._ffn(bp, x, self._norm(bp["ln2"], x), 0.0)
        return self.constrain(x, "act")

    def decode_step_(self, params: Dict, token: torch.Tensor, cache: Dict,
                     pos, write=None) -> torch.Tensor:
        """``decode_step`` writing the new cache entries into the stacked
        ``cache`` in place, the serving plane's decode tick (the torch
        form of the reference's donated cache).  ``write`` ([b] bool)
        keeps the cache of the rows where it is False.  Returns logits
        [b, 1, V] (over the whole vocabulary under ``tp`` too)."""
        x = self.constrain(self._embed(params, token), "act")
        pos = torch.as_tensor(pos, device=x.device)
        for i in range(self.arch.num_layers):
            x = self.decode_block_(tree_map(lambda t: t[i], params["blocks"]),
                                   tree_map(lambda t: t[i], cache), x, pos,
                                   write)
        x = self._norm(params["final_norm"], x)
        return self._whole_logits(params.get("head", params["embed"]), x)

    def decode_step(self, params: Dict, token: torch.Tensor, cache: Dict,
                    pos) -> Tuple[torch.Tensor, Dict]:
        """token: [b, 1]; pos: the scalar current position, or [b] per-row
        positions.  Returns (logits [b, 1, V], the new stacked cache); the
        cache passed in is not changed."""
        new = tree_map(torch.clone, cache)
        return self.decode_step_(params, token, new, pos), new

    def prefill(self, params: Dict, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Last-position logits [b, 1, V] only: the hidden states are
        sliced before the head, so the [b, S, V] logits are never built.
        Under a sliced ``seq`` the last position's hidden state comes from
        the rank that holds it, so every rank of the sequence group
        returns the same logits; under ``tp`` they cover the whole
        vocabulary."""
        x, _ = self.hidden_states(params, tokens, frontend_embeds)
        last = x[:, -1:]
        if self.seq is not None:
            F_ = frontend_embeds.shape[1] if frontend_embeds is not None else 0
            shard = self.seq.shard(F_ + tokens.shape[1])
            if shard.sliced:
                last = shard.from_last(last, "seq")
        return self._whole_logits(params.get("head", params["embed"]), last)
