"""Mixture-of-Experts MLP: top-k routed experts + optional shared expert,
as ``repro/models/moe.py``.

Three dispatch formulations with the same routing and the same
switch-transformer load-balance aux loss:

  * ``moe_mlp`` — dense dispatch: every expert computes on every token
    and a [b, S, E] routing weight matrix selects the top-k
    contributions (exact, dropless; FLOPs scale with E);
  * ``moe_mlp_capacity`` — GShard/Switch capacity dispatch over token
    groups, each expert taking at most C tokens a group (overflow
    dropped); ``scan_groups=False`` folds the groups into the batch;
  * ``moe_mlp_grouped`` — gathers the k selected experts' weights per
    token (FLOPs scale with k).

The products are ``torch.einsum`` over the stacked [E, ...] expert
weights, as the JAX package computes them outside any kernel.

The load-balance loss is a product of means over the global batch.  On
a process mesh (``seq``, ``runtime/sharding.py::SeqShard``) a rank holds
only its tokens: it sums its routing counts, router probabilities and
token count, all-reduces the sums over every batch axis (the backward
sums the cotangents, so the global importance's gradient reaches every
rank's probabilities) and divides, so each rank computes the
reference's global loss.  Where a sequence stays whole on a group its
ranks hold the same tokens; they are counted once per rank in both the
sums and the count, which leaves the means unchanged.

Expert parallelism (``tp``, ``runtime/sharding.py::TPContext``): where
the model axis divides the experts, each rank holds the experts
``tp.experts`` of every stacked weight.  The router, its top-k and the
load-balance loss run on every rank of the model group alike, from the
full routing; each rank computes its experts' contributions alone (the
dense dispatch's routing weights, the capacity dispatch's queue places
and combine weights sliced to its experts after the full routing, the
grouped dispatch's one-hot over its experts), and the parts are summed
through *g*.  The tokens enter the experts through *f*, and so do the
combine weights, whose gradient each rank gives for its experts only.
The shared expert is column / row parallel as an MLP, its part summed
with the experts'.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import init_mlp, mlp


def init_moe(gen: torch.Generator, arch: ArchConfig,
             dtype=torch.float32) -> Dict:
    """Same shapes and scales as ``repro/models/moe.py::init_moe``, drawn
    from ``gen`` on its device; the shared experts are one merged SwiGLU
    MLP of width ``shared_expert_d_ff``."""
    m = arch.moe
    d, ff, E, dev = arch.d_model, arch.d_ff, m.num_experts, gen.device
    s_in, s_out = d ** -0.5, ff ** -0.5

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale
    p = {"router": normal((d, E), s_in),
         "gate": normal((E, d, ff), s_in).to(dtype),
         "up": normal((E, d, ff), s_in).to(dtype),
         "down": normal((E, ff, d), s_out).to(dtype)}
    if m.shared_expert_d_ff:
        p["shared"] = init_mlp(gen, d, m.shared_expert_d_ff, "swiglu", dtype)
    return p


def _route(router: torch.Tensor, x: torch.Tensor, top_k: int):
    """fp32 router softmax and its renormalised top-k: (probs, top_w,
    top_i).  The gradient reaches the router through probs and top_w."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    top_w, top_i = torch.topk(probs, top_k, dim=-1)
    return probs, top_w / top_w.sum(-1, keepdim=True), top_i


def _load_balance(probs: torch.Tensor, chosen: torch.Tensor, m,
                  seq=None) -> torch.Tensor:
    """E * sum_e (fraction of top-k slots routed to e) * (mean prob of
    e); ``chosen`` is the 0/1 [..., E] count of each token's picks.
    With ``seq`` the means are over every batch rank's tokens."""
    lead = tuple(range(probs.dim() - 1))
    if seq is None:
        frac = chosen.mean(lead) / m.top_k
        return m.num_experts * torch.sum(frac * probs.mean(lead))
    return _balance_of(seq.all_reduce(_stat_sums(probs, chosen), "router"),
                       m)


def _stat_sums(probs: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """[2E + 1]: the routing counts and the router probabilities summed
    over the tokens, and the token count."""
    lead = tuple(range(probs.dim() - 1))
    count = torch.full((1,), float(chosen[..., 0].numel()),
                       dtype=probs.dtype, device=probs.device)
    return torch.cat([chosen.sum(lead), probs.sum(lead), count])


def _balance_of(sums: torch.Tensor, m) -> torch.Tensor:
    """The load-balance loss of ``_stat_sums`` summed over every token."""
    E = m.num_experts
    frac = sums[:E] / sums[2 * E] / m.top_k
    return E * torch.sum(frac * (sums[E:2 * E] / sums[2 * E]))


def _shared(params, x, y):
    return y + mlp(params["shared"], x, "swiglu") if "shared" in params else y


def _parallel(tp) -> bool:
    """Whether this rank holds a part of the experts (module
    docstring)."""
    return tp is not None and tp.experts is not None


def _expert_input(x: torch.Tensor, tp) -> torch.Tensor:
    """x as the experts take it: through *f* where they are cut."""
    return tp.f(x, "experts") if _parallel(tp) else x


def _local(t: torch.Tensor, tp, dim: int) -> torch.Tensor:
    """Routing weights over E along ``dim``, cut to this rank's experts
    through *f* where they are cut; as they are otherwise."""
    if not _parallel(tp):
        return t
    lo, hi = tp.experts
    return tp.f(t, "experts").narrow(dim, lo, hi - lo)


def _finish(params, x: torch.Tensor, xe: torch.Tensor, y: torch.Tensor, tp
            ) -> torch.Tensor:
    """The experts' output ``y`` plus the shared expert's: on one card
    ``_shared``; under ``tp`` the parts of the ones cut over the model
    axis summed through *g*, the whole ones added after (``xe``: the
    tokens through *f*, or ``x`` where the experts are whole)."""
    sp = tp is not None and tp.shared_ff is not None and "shared" in params
    if not _parallel(tp) and not sp:
        return _shared(params, x, y)
    part, whole = (y, None) if _parallel(tp) else (None, y)
    if "shared" in params:
        if sp:
            s = mlp(params["shared"], xe if _parallel(tp)
                    else tp.f(x, "experts"), "swiglu")
            part = s if part is None else part + s
        else:
            s = mlp(params["shared"], x, "swiglu")
            whole = s if whole is None else whole + s
    out = tp.g(part, "experts")
    return out if whole is None else whole + out


def moe_mlp(params, arch: ArchConfig, x: torch.Tensor, seq=None, tp=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense dispatch.  x: [b, S, d] -> (y, aux loss)."""
    m = arch.moe
    probs, top_w, top_i = _route(params["router"], x, m.top_k)
    # the scatter's gradient reaches top_w only
    route = _local(torch.zeros_like(probs).scatter(-1, top_i, top_w)
                   .to(x.dtype), tp, -1)
    xe = _expert_input(x, tp)
    h = F.silu(torch.einsum("bsd,edf->bsef", xe, params["gate"].to(x.dtype)))
    h = h * torch.einsum("bsd,edf->bsef", xe, params["up"].to(x.dtype))
    y = torch.einsum("bsef,efd->bsed", h, params["down"].to(x.dtype))
    y = torch.einsum("bsed,bse->bsd", y, route)
    chosen = torch.zeros_like(probs).scatter(-1, top_i, 1.0).detach()
    return _finish(params, x, xe, y, tp), _load_balance(probs, chosen, m, seq)


def moe_mlp_capacity(params, arch: ArchConfig, x: torch.Tensor, seq=None,
                     tp=None, *, capacity_factor: float = 1.25,
                     group_size: int = 1024, scan_groups: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity dispatch over groups of ``group_size`` positions per
    batch row: an expert takes at most C = ceil(top_k * G / E *
    capacity_factor) tokens a group, in token order; the rest of its
    picks are dropped.  ``scan_groups`` runs the groups one after the
    other and averages their aux losses; ``False`` runs them as one
    batch, with one aux loss over all of them (the reference's
    vectorized form).  Over a sliced sequence shard the groups must lie
    inside the shard (its length a multiple of the group size); each
    group's statistics are summed over the batch ranks, so group g's
    loss is the reference's wherever g lies."""
    m = arch.moe
    b, S, d = x.shape
    full = seq.length if seq is not None else S
    gs = min(group_size, full)
    if seq is not None and seq.sliced and S % gs:
        raise ValueError(
            f"moe_mlp_capacity: groups of {gs} positions straddle the "
            f"sequence shards of {S} of {full} positions; a shard must "
            f"hold whole groups")
    pad = (-S) % gs
    x_in = F.pad(x, (0, 0, 0, pad)) if pad else x
    xe_in = _expert_input(x_in, tp)
    ng = (S + pad) // gs
    C = max(1, int(math.ceil(m.top_k * gs / m.num_experts * capacity_factor)))
    wg, wu, wd = (params[k].to(x.dtype) for k in ("gate", "up", "down"))
    slots = torch.arange(C, device=x.device, dtype=torch.float32)

    def group(xg, xeg):                             # [B, gs, d] each
        probs, top_w, top_i = _route(params["router"], xg, m.top_k)
        onehot = F.one_hot(top_i, m.num_experts).float()     # [B, gs, k, E]
        flat = onehot.reshape(-1, gs * m.top_k, m.num_experts)
        # each pick's place in its expert's queue; -1 where not picked
        pos = (torch.cumsum(flat, 1) * flat - 1.0).reshape(
            -1, gs, m.top_k, m.num_experts)
        # one-hot over C of a place outside [0, C) is all zeros (a drop)
        pos_c = (pos[..., None] == slots).to(x.dtype)        # [B,gs,k,E,C]
        dispatch = pos_c.sum(2)
        combine = torch.einsum("bgkec,bgk->bgec", pos_c, top_w.to(x.dtype))
        if _parallel(tp):
            # this rank's experts' queues, placed by the full routing
            dispatch = dispatch[:, :, tp.experts[0]:tp.experts[1]]
            combine = _local(combine, tp, 2)
        xe = torch.einsum("bgd,bgec->becd", xeg, dispatch)   # [B, E, C, d]
        h = F.silu(torch.einsum("becd,edf->becf", xe, wg))
        h = h * torch.einsum("becd,edf->becf", xe, wu)
        ye = torch.einsum("becf,efd->becd", h, wd)
        yg = torch.einsum("becd,bgec->bgd", ye, combine)
        if seq is not None:
            return yg, _stat_sums(probs, onehot.sum(2))
        return yg, _load_balance(probs, onehot.sum(2), m)

    if scan_groups:
        # per group its aux loss, or with ``seq`` its statistics' sums
        ys, parts = [], []
        for i in range(ng):
            yg, part = group(x_in[:, i * gs:(i + 1) * gs],
                             xe_in[:, i * gs:(i + 1) * gs])
            ys.append(yg)
            parts.append(part)
        y = torch.cat(ys, 1)[:, :S]
        if seq is not None:
            # every group's sums at its global index, summed over ranks
            first, ng = seq.start // gs, -(-full // gs)
            stats = torch.zeros((ng, parts[0].shape[0]), dtype=torch.float32,
                                device=x.device).index_add(
                0, torch.arange(first, first + len(parts), device=x.device),
                torch.stack(parts))
            parts = [_balance_of(p, m)
                     for p in seq.all_reduce(stats, "router")]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for part in parts:
            aux = aux + part
        aux = aux / ng
    else:
        y, aux = group(x_in.reshape(b * ng, gs, d),
                       xe_in.reshape(b * ng, gs, d))
        y = y.reshape(b, S + pad, d)[:, :S]
        if seq is not None:
            aux = _balance_of(seq.all_reduce(aux, "router"), m)
    return _finish(params, x, xe_in[:, :S] if pad else xe_in, y, tp), aux


def moe_mlp_grouped(params, arch: ArchConfig, x: torch.Tensor, seq=None,
                    tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k gather: each token's k experts' weights gathered by a
    one-hot product, so the FLOPs scale with k, not E (under ``tp`` a
    one-hot over this rank's experts: a pick of another rank's expert
    gathers zeros and adds nothing)."""
    m = arch.moe
    probs, top_w, top_i = _route(params["router"], x, m.top_k)
    onehot = F.one_hot(top_i, m.num_experts).to(x.dtype)   # [b, S, k, E]
    xe, w = x, top_w
    if _parallel(tp):
        onehot = onehot[..., tp.experts[0]:tp.experts[1]]
        xe, w = _expert_input(x, tp), tp.f(top_w, "experts")
    wg = torch.einsum("bske,edf->bskdf", onehot, params["gate"].to(x.dtype))
    wu = torch.einsum("bske,edf->bskdf", onehot, params["up"].to(x.dtype))
    wd = torch.einsum("bske,efd->bskfd", onehot, params["down"].to(x.dtype))
    h = F.silu(torch.einsum("bsd,bskdf->bskf", xe, wg))
    h = h * torch.einsum("bsd,bskdf->bskf", xe, wu)
    y = torch.einsum("bskf,bskfd->bskd", h, wd)
    y = torch.einsum("bskd,bsk->bsd", y, w.to(x.dtype))
    chosen = F.one_hot(top_i, m.num_experts).float().sum(2)
    return _finish(params, x, xe, y, tp), _load_balance(probs, chosen, m, seq)


IMPLS = {"dense": moe_mlp, "grouped": moe_mlp_grouped,
         "capacity": moe_mlp_capacity,
         "capacity_vec": lambda p, a, x, seq=None, tp=None: moe_mlp_capacity(
             p, a, x, seq, tp, scan_groups=False)}
