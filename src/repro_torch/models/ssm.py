"""Mamba2 block built on SSD (state-space duality, arXiv:2405.21060): the
training half of ``repro/models/ssm.py``.

Three numerically equivalent SSD evaluators for ``mamba``:
  * ``ssd_scan``    — the per-timestep recurrence; the oracle.
  * ``ssd_chunked`` — the chunked algorithm in plain ops (intra-chunk
    quadratic + inter-chunk state recurrence).
  * ``"kernel"``    — ``kernels/ops.ssd``: the CUDA kernels on a CUDA
    tensor, their plain versions on a CPU tensor.

``ssd_step``, ``conv_step`` and ``mamba_decode`` are the one-token
decode against carried conv and SSM states (``init_mamba_cache``);
``mamba_decode_`` writes the new states into the cache in place.

State layout is [batch, heads, head_dim (P), state (N)] throughout.

Over a sequence shard (``seq``, ``runtime/sharding.py::SeqShard``) the
projections stay token-local: a rank all-gathers the mixer's input (the
conv input and dt) over the sequence group, runs the conv and the SSD
scan over the whole sequence, keeps its own rows and gates them with
its own z.  Every rank of the group so computes the whole mixer (the
SSD state is not passed between ranks).

Under tensor parallelism (``tp``, ``runtime/sharding.py::TPContext``) a
rank computes its whole Mamba2 heads (``TPContext.ssm_heads``), wherever
the spec's cut of each weight falls: the input enters through *f*;
``in_proj`` is taken whole once a call (gathered at use, or through *f*
where the spec keeps it whole) and narrowed to the rank's z, x and dt
columns and to B and C, which every head reads and every rank computes;
``conv_w`` / ``conv_b`` to its x channels and B and C (the conv is
depthwise, so a channel cut is exact); ``dt_bias``, ``A_log``, ``D``,
``norm_w`` and ``out_proj``'s rows to its heads (``TPContext.take``).
The SSD runs on the rank's heads; the gated RMSNorm's sum of squares is
summed over the model group (``TPContext.sum``, tag "ssm_norm") and
divided by the whole ``d_inner``; the row-parallel ``out_proj`` product
leaves through *g*.  B's and C's gradients are each rank's share, summed
by the gather's reduce-scatter (or *f*) and by the input's *f*.  With
``part=True`` the caller owns *f* and *g* (hymba's block joins its two
branches under one of each).  The decode takes the same weights and
carries the rank's conv channels (its x channels and the whole B and C)
and its heads' SSM states.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import rms_norm


# ----------------------------------------------------------------------
# SSD evaluators
# ----------------------------------------------------------------------
def ssd_scan(x, dt, A, B, C, state: Optional[torch.Tensor] = None):
    """Oracle recurrence.

    x: [b,S,H,P] dt: [b,S,H] (post-softplus) A: [H] (negative)
    B, C: [b,S,H,N] (already expanded per head)
    returns y: [b,S,H,P], final state [b,H,P,N] fp32.
    """
    b, S, H, P = x.shape
    N = B.shape[-1]
    if state is None:
        state = torch.zeros((b, H, P, N), dtype=torch.float32,
                            device=x.device)
    ys = []
    for t in range(S):
        xt, dtt, Bt, Ct = x[:, t], dt[:, t], B[:, t], C[:, t]
        upd = torch.einsum("bh,bhp,bhn->bhpn", dtt.float(), xt.float(),
                           Bt.float())
        state = state * torch.exp(dtt * A)[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state.to(xt.dtype), Ct))
    return torch.stack(ys, 1), state


def ssd_chunked(x, dt, A, B, C, chunk: int,
                state: Optional[torch.Tensor] = None):
    """Chunked SSD (same signature and returns as ``ssd_scan``), a loop
    over chunks as in the reference (one chunk's [Q, Q] buffers live at
    a time).  The one departure: the decay is masked before its exp, so
    its gradient stays finite where the reference's would be NaN."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // chunk
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]    # [1,i,j,1]
    if state is None:
        state = torch.zeros((b, H, P, N), dtype=torch.float32,
                            device=x.device)
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xq, dtq, Bq, Cq = x[:, sl], dt[:, sl], B[:, sl], C[:, sl]
        cum = torch.cumsum((dtq * A).float(), 1)                  # [b,Q,H]
        # masked BEFORE the exp: above the diagonal exp(cum_i - cum_j)
        # overflows at real widths, and autograd through a mask applied
        # after it gives 0 * inf = NaN
        M = torch.exp((cum[:, :, None, :] - cum[:, None, :, :])
                      .masked_fill(~causal, float("-inf")))
        CB = torch.einsum("bihn,bjhn->bijh", Cq, Bq).float()
        W = CB * M * dtq[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", W.to(xq.dtype), xq)
        # contribution of the incoming state
        y = y + torch.einsum("bihn,bhpn->bihp",
                             (Cq.float() * torch.exp(cum)[..., None]
                              ).to(xq.dtype), state.to(xq.dtype))
        # state update
        w_last = torch.exp(cum[:, -1:, :] - cum) * dtq
        cs = torch.einsum("bjh,bjhn,bjhp->bhpn", w_last.to(xq.dtype), Bq,
                          xq).float()
        state = state * torch.exp(cum[:, -1, :])[..., None, None] + cs
        ys.append(y)
    return torch.cat(ys, 1)[:, :S], state


def ssd_step(xt, dtt, A, Bt, Ct, state):
    """One decode step. xt: [b,H,P], dtt: [b,H], Bt/Ct: [b,H,N]; state
    [b,H,P,N] fp32.  Returns (yt [b,H,P], the new state)."""
    upd = torch.einsum("bh,bhp,bhn->bhpn", dtt.float(), xt.float(),
                       Bt.float())
    state = state * torch.exp(dtt * A)[..., None, None] + upd
    return torch.einsum("bhpn,bhn->bhp", state.to(xt.dtype), Ct), state


# ----------------------------------------------------------------------
# Causal depthwise conv1d
# ----------------------------------------------------------------------
def causal_conv1d(x, weight, bias):
    """x: [b,S,dim]; weight: [width, dim]; bias: [dim].  A plain
    depthwise convolution (the reference leaves it to XLA too); the
    result is laid out [b, S, dim] row-major, so the SSD kernels read x,
    B and C with a dense last dim."""
    width = weight.shape[0]
    xp = F.pad(x.transpose(1, 2), (width - 1, 0))
    out = F.conv1d(xp, weight.t()[:, None, :].to(x.dtype),
                   groups=x.shape[-1]).transpose(1, 2).contiguous()
    return F.silu(out + bias.to(x.dtype))


def conv_step(xt, conv_state, weight, bias):
    """xt: [b,dim]; conv_state: [b,width-1,dim] (the previous inputs).
    Returns (out [b,dim], the new conv state)."""
    window = torch.cat([conv_state, xt[:, None, :]], dim=1)
    out = torch.einsum("bwd,wd->bd", window.float(),
                       weight.float()).to(xt.dtype)
    return F.silu(out + bias.to(xt.dtype)), window[:, 1:]


# ----------------------------------------------------------------------
# Mamba2 block
# ----------------------------------------------------------------------
def _dims(arch: ArchConfig):
    c = arch.ssm
    d_inner = c.expand * arch.d_model
    n_heads = d_inner // c.head_dim
    conv_dim = d_inner + 2 * c.n_groups * c.state_size
    return c, d_inner, n_heads, conv_dim


def init_mamba(gen: torch.Generator, arch: ArchConfig,
               dtype=torch.float32) -> Dict:
    """Same shapes and scales as ``repro/models/ssm.py::init_mamba``,
    drawn from ``gen`` on its device."""
    c, d_inner, n_heads, conv_dim = _dims(arch)
    d, dev = arch.d_model, gen.device
    in_dim = 2 * d_inner + 2 * c.n_groups * c.state_size + n_heads

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def uniform(n, lo, hi):
        return torch.rand((n,), generator=gen, device=dev) * (hi - lo) + lo
    dt = torch.exp(uniform(n_heads, math.log(1e-3), math.log(1e-1)))
    return {
        "in_proj": normal((d, in_dim), d ** -0.5).to(dtype),
        "conv_w": normal((c.conv_width, conv_dim), 0.2).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "dt_bias": torch.log(torch.expm1(dt)).to(dtype),      # inv-softplus
        "A_log": torch.log(uniform(n_heads, 1.0, 16.0)).to(dtype),
        "D": torch.ones((n_heads,), dtype=dtype, device=dev),
        "norm_w": torch.ones((d_inner,), dtype=dtype, device=dev),
        "out_proj": normal((d_inner, d), d_inner ** -0.5).to(dtype),
    }


def _expand_groups(t, n_heads: int, n_groups: int):
    """[..., G, N] -> [..., H, N] by repeating each group: a stride-0
    view when n_groups = 1 (a copy otherwise)."""
    *lead, G, N = t.shape
    reps = n_heads // n_groups
    return t.unsqueeze(-2).expand(*lead, G, reps, N).reshape(*lead, n_heads, N)


def _tp_params(params, arch: ArchConfig, tp) -> Dict:
    """The mixer weights a rank of ``tp`` computes its heads with (module
    docstring): ``in_proj`` [d, 2 di + 2 gn + nh] and ``conv_w`` /
    ``conv_b`` over di + 2 gn channels, the rest at its nh heads of P
    channels (di = nh P)."""
    c, d_inner, n_heads, conv_dim = _dims(arch)
    P, gn = c.head_dim, c.n_groups * c.state_size
    h0, h1 = tp.ssm_heads
    lo, hi = h0 * P, h1 * P
    w = tp.whole(params["in_proj"], 1, 2 * d_inner + 2 * gn + n_heads)
    bc = 2 * d_inner
    z_x_bc_dt = [(lo, hi), (d_inner + lo, d_inner + hi), (bc, bc + 2 * gn),
                 (bc + 2 * gn + h0, bc + 2 * gn + h1)]
    p = {"in_proj": torch.cat([w[:, a:b] for a, b in z_x_bc_dt], 1)}
    x_bc = [(lo, hi), (d_inner, d_inner + 2 * gn)]
    for name in ("conv_w", "conv_b"):
        t = tp.whole(params[name], params[name].dim() - 1, conv_dim)
        p[name] = torch.cat([t[..., a:b] for a, b in x_bc], -1)
    for name in ("dt_bias", "A_log", "D"):
        p[name] = tp.take(params[name], 0, h0, h1, n_heads)
    p["norm_w"] = tp.take(params["norm_w"], 0, lo, hi, d_inner)
    p["out_proj"] = tp.take(params["out_proj"], 0, lo, hi, d_inner)
    return p


def _gated_norm(w, y, z, eps: float, d_inner: int, tp=None):
    """``rms_norm(w, y * silu(z))`` over the whole ``d_inner``: under
    ``tp`` y and z hold a rank's columns, and the sum of squares is
    summed over the model group before the division by ``d_inner``."""
    g = y * F.silu(z)
    if tp is None:
        return rms_norm(w, g, eps)
    g32 = g.float()
    var = tp.sum((g32 * g32).sum(-1, keepdim=True), "ssm_norm") / d_inner
    return (g32 * torch.rsqrt(var + eps)).to(g.dtype) * w


def mamba(params, arch: ArchConfig, x: torch.Tensor, *,
          evaluator: str = "chunked", seq=None, tp=None,
          part: bool = False) -> torch.Tensor:
    """Full-sequence Mamba2 block. x: [b,S,d_model], or this rank's
    positions of the sequence when ``seq`` is a sliced ``SeqShard``;
    under ``tp`` this rank's heads, summed over the model group, or with
    ``part`` this rank's unsummed part of x already through *f* (module
    docstring)."""
    c, d_inner, n_heads, _ = _dims(arch)
    if tp is not None:
        params = _tp_params(params, arch, tp)
        n_heads = tp.ssm_heads[1] - tp.ssm_heads[0]
        if not part:
            x = tp.f(x)
    di = n_heads * c.head_dim      # this rank's d_inner
    gn = c.n_groups * c.state_size
    proj = x @ params["in_proj"].to(x.dtype)
    sliced = seq is not None and seq.sliced
    if sliced:
        # the conv and scan inputs of every position, in one gather
        z, rest = proj[..., :di], proj[..., di:]
        xbc, dt_raw = torch.split(seq.gather(rest, "mixer"),
                                  [rest.shape[-1] - n_heads, n_heads], dim=-1)
    else:
        z, xbc, dt_raw = torch.split(proj, [di, di + 2 * gn, n_heads], dim=-1)
    b, S = xbc.shape[:2]
    xbc = causal_conv1d(xbc, params["conv_w"], params["conv_b"])
    xin, B, C = torch.split(xbc, [di, gn, gn], dim=-1)
    xh = xin.reshape(b, S, n_heads, c.head_dim)
    Bh = _expand_groups(B.reshape(b, S, c.n_groups, c.state_size), n_heads,
                        c.n_groups)
    Ch = _expand_groups(C.reshape(b, S, c.n_groups, c.state_size), n_heads,
                        c.n_groups)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    if evaluator == "chunked":
        y, _ = ssd_chunked(xh, dt, A, Bh, Ch, chunk=c.chunk_size)
    elif evaluator == "kernel":
        y, _ = kops.ssd(xh, dt, A, Bh, Ch)
    elif evaluator == "scan":
        y, _ = ssd_scan(xh, dt, A, Bh, Ch)
    else:
        raise ValueError(f"unknown SSD evaluator {evaluator!r}")
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(b, S, di)
    if sliced:
        y = y[:, seq.start:seq.stop]
    y = _gated_norm(params["norm_w"].to(x.dtype), y, z, arch.rms_norm_eps,
                    d_inner, tp)
    out = y @ params["out_proj"].to(x.dtype)
    return tp.g(out) if tp is not None and not part else out


def init_mamba_cache(arch: ArchConfig, batch: int, dtype, device="cpu",
                     heads: Optional[Tuple[int, int]] = None):
    """The conv state [batch, width - 1, conv channels] and the SSM state
    [batch, heads, P, N] fp32.  ``heads``: a rank's [lo, hi) of the
    Mamba2 heads under TP (``TPContext.ssm_heads``): its x channels
    beside the whole B and C, and its heads' states."""
    c, d_inner, n_heads, conv_dim = _dims(arch)
    if heads is not None:
        n_heads = heads[1] - heads[0]
        conv_dim = n_heads * c.head_dim + 2 * c.n_groups * c.state_size
    return {"conv": torch.zeros((batch, c.conv_width - 1, conv_dim),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, n_heads, c.head_dim, c.state_size),
                               dtype=torch.float32, device=device)}


def mamba_decode(params, arch: ArchConfig, x: torch.Tensor, cache: Dict, *,
                 tp=None, part: bool = False):
    """One-token decode. x: [b,1,d_model] -> (out [b,1,d_model], the new
    cache).  Under ``tp`` the rank's whole heads, with the weights
    ``mamba`` takes, against ``cache`` at its heads
    (``init_mamba_cache(..., heads=)``); ``part`` as ``mamba``'s."""
    c, d_inner, n_heads, _ = _dims(arch)
    if tp is not None:
        params = _tp_params(params, arch, tp)
        n_heads = tp.ssm_heads[1] - tp.ssm_heads[0]
        if not part:
            x = tp.f(x)
    di = n_heads * c.head_dim      # this rank's d_inner
    gn = c.n_groups * c.state_size
    b = x.shape[0]
    proj = x[:, 0] @ params["in_proj"].to(x.dtype)
    z, xbc, dt_raw = torch.split(proj, [di, di + 2 * gn, n_heads], dim=-1)
    xbc, conv_state = conv_step(xbc, cache["conv"], params["conv_w"],
                                params["conv_b"])
    xin, B, C = torch.split(xbc, [di, gn, gn], dim=-1)
    xh = xin.reshape(b, n_heads, c.head_dim)
    Bh = _expand_groups(B.reshape(b, c.n_groups, c.state_size), n_heads,
                        c.n_groups)
    Ch = _expand_groups(C.reshape(b, c.n_groups, c.state_size), n_heads,
                        c.n_groups)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    y, ssm_state = ssd_step(xh, dt, A, Bh, Ch, cache["ssm"])
    y = y + params["D"].to(y.dtype)[None, :, None] * xh
    y = _gated_norm(params["norm_w"].to(x.dtype), y.reshape(b, di), z,
                    arch.rms_norm_eps, d_inner, tp)
    out = (y @ params["out_proj"].to(x.dtype))[:, None, :]
    if tp is not None and not part:
        out = tp.g(out)
    return out, {"conv": conv_state, "ssm": ssm_state}


def mamba_decode_(params, arch: ArchConfig, x: torch.Tensor, cache: Dict,
                  write=None, *, tp=None, part: bool = False) -> torch.Tensor:
    """``mamba_decode`` writing the new conv and SSM states into ``cache``
    in place; ``write`` ([B] bool) keeps the states of the rows where it
    is False.  Returns out [b, 1, d_model]."""
    out, new = mamba_decode(params, arch, x, cache, tp=tp, part=part)
    for name, t in new.items():
        if write is not None:
            t = torch.where(write.reshape(-1, *(1,) * (t.dim() - 1)), t,
                            cache[name])
        cache[name].copy_(t)
    return out
