"""Plain PyTorch versions of the port's kernels.

Each is the same function as a CUDA kernel in ``csrc/``, written in the
most obvious way.  The CPU path runs them (``kernels/ops.py``
routes a CPU tensor here), and ``chip_smoke.py`` holds each kernel
against them on the card.  They keep the JAX package's rounding points
so the CPU tests can compare the two packages tightly.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def add_rmsnorm_ref(x: torch.Tensor, r: torch.Tensor, w: torch.Tensor, *,
                    eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(res, h) = (x + r, rms_norm(w, x + r)); the normalised value is
    rounded to the input dtype before the weight multiply, as in
    ``repro/kernels/fused.py::add_rmsnorm_ref``."""
    res = x + r
    res32 = res.float()
    var = (res32 * res32).mean(-1, keepdim=True)
    h = (res32 * torch.rsqrt(var + eps)).to(res.dtype) * w
    return res, h


def add_rmsnorm_bwd_ref(res: torch.Tensor, w: torch.Tensor,
                        gres: torch.Tensor, gh: torch.Tensor, *,
                        eps: float = 1e-6
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward the CUDA kernel computes, written out: (dres, dw).

    ``dres`` is the cotangent of both addends of ``res = x + r``; ``dw``
    is summed over rows in fp32 and cast to ``w``'s dtype."""
    res32 = res.float()
    var = (res32 * res32).mean(-1, keepdim=True)
    rs = torch.rsqrt(var + eps)
    n = (res32 * rs).to(res.dtype)
    gh32 = gh.float()
    dw = (gh32 * n.float()).sum(0).to(w.dtype)
    dn = gh32 * w.float()
    d = res.shape[-1]
    proj = (dn * res32).sum(-1, keepdim=True) / (d * (var + eps))
    dres = (rs * (dn - res32 * proj) + gres.float()).to(res.dtype)
    return dres, dw


def matmul_bias_ref(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w (+ b) accumulated in fp32 and cast to x's dtype: what the
    tiled GEMM kernel computes, for any operand strides."""
    acc = x.float() @ w.float()
    if b is not None:
        acc = acc + b.float()
    return acc.to(x.dtype)


def qkv_ref(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
            wv: torch.Tensor, bq: Optional[torch.Tensor] = None,
            bk: Optional[torch.Tensor] = None,
            bv: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Three projections with their bias epilogues, as
    ``repro/kernels/fused.py::qkv_ref``."""
    outs = []
    for w, b in ((wq, bq), (wk, bk), (wv, bv)):
        y = x @ w.to(x.dtype)
        if b is not None:
            y = y + b.to(x.dtype)
        outs.append(y)
    return tuple(outs)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 0) -> torch.Tensor:
    """Causal GQA attention.  q: [B,Sq,H,D]; k/v: [B,Sk,KV,D], Sq <= Sk,
    the queries the last Sq of the Sk positions."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(D)
    mask = _visible(Sq, Sk, window, q.device)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


#: the flash kernels' mask value (``repro/kernels/flash_attention.py``)
NEG_INF = -1e30


def _visible(Sq: int, Sk: int, window: int, device) -> torch.Tensor:
    """[Sq, Sk] mask of the (q, k) pairs that take part, the queries the
    last Sq of the Sk positions: causal, and inside the sliding window
    when window > 0."""
    qpos = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """fp32 scaled scores [B, KV, G, Sq, Sk] of q [B,Sq,H,D] against
    k [B,Sk,KV,D]."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, Sq, KV, H // KV, D)
    return torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (1.0 / math.sqrt(D))


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the flash forward kernel computes: (out [B,Sq,H,D] in q's
    dtype, lse [B,H,Sq] fp32), in fp32 with the reference's masked value
    and ``l >= 1e-20`` clamp.  k/v are [B,Sk,KV,D], Sq <= Sk: the queries
    are the last Sq of the Sk positions (a sequence shard's queries
    against the keys up to its end)."""
    B, Sq, H, D = q.shape
    mask = _visible(Sq, k.shape[1], window, q.device)
    s = _scores(q, k).masked_fill(~mask, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-20)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float()) / l
    out = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
    lse = (m + torch.log(l)).reshape(B, H, Sq)
    return out, lse


def flash_delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, [B,H,S]: the backward's
    preprocess, a plain reduction on both routes."""
    return (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_bwd_terms(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lse: torch.Tensor, g: torch.Tensor, delta: torch.Tensor,
                    *, window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The terms the flash backward sums, fp32 [B, KV, G, Sq, Sk]:
    p = exp(s - lse), rebuilt from the saved lse and masked, and
    ds = p * (dp - delta) / sqrt(D) with dp = dO.V^T."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    mask = _visible(Sq, Sk, window, q.device)
    p = torch.exp(_scores(q, k) - lse.reshape(B, KV, G, Sq, 1))
    p = p.masked_fill(~mask, 0.0)
    gg = g.float().reshape(B, Sq, KV, G, D)
    dp = torch.einsum("bqkgd,bskd->bkgqs", gg, v.float())
    ds = p * (dp - delta.reshape(B, KV, G, Sq, 1)) * (1.0 / math.sqrt(D))
    return p, ds


def flash_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: Optional[torch.Tensor], lse: torch.Tensor,
                  g: torch.Tensor, *, window: int = 0,
                  delta: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the two flash backward kernels compute: (dq, dk, dv) =
    (sum ds.k, sum ds^T.q, sum p^T.dO), dk and dv at KV-head resolution,
    summed over the group in fp32 before one cast; dk and dv have k's
    Sk rows (zero where no query sees a key).  ``delta`` is
    ``flash_delta(out, g)`` unless given."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    if delta is None:
        delta = flash_delta(out, g)
    p, ds = flash_bwd_terms(q, k, v, lse, g, delta, window=window)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()).reshape(B, Sq, H, D)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.float().reshape(B, Sq, KV, G, D))
    dv = torch.einsum("bkgqs,bqkgd->bskd", p,
                      g.float().reshape(B, Sq, KV, G, D))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------------
# Mamba2 SSD chunked scan
# ----------------------------------------------------------------------
#: the port's SSD chunk: the CUDA kernels' Q (SSD is chunk-invariant)
SSD_CHUNK = 64


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor,
            state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-timestep recurrence, in fp32 (the oracle,
    ``repro/kernels/ref.py::ssd_ref``).  x: [b,S,H,P]; dt: [b,S,H]
    (post-softplus); A: [H] (negative); B/C: [b,S,H,N].  Returns
    (y [b,S,H,P] in x's dtype, final state [b,H,P,N] fp32)."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    if state is None:
        state = torch.zeros((b, H, P, N), dtype=torch.float32,
                            device=x.device)
    ys = []
    for t in range(S):
        dtt = dt[:, t].float()
        upd = torch.einsum("bh,bhp,bhn->bhpn", dtt, x[:, t].float(),
                           B[:, t].float())
        state = state * torch.exp(dtt * A)[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, C[:, t].float()))
    return torch.stack(ys, 1).to(x.dtype), state


def _ssd_chunks(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """[b, S, H, ...] -> fp32 [b, H, nc, Q, ...], the sequence zero-padded
    to whole chunks (zero dt, x, B and C rows leave the state unchanged
    and add nothing)."""
    b, S, H = t.shape[:3]
    nc = -(-S // chunk)
    t = t.float()
    pad = torch.zeros((b, nc * chunk - S, *t.shape[2:]), dtype=t.dtype,
                      device=t.device)
    t = torch.cat([t, pad], 1).reshape(b, nc, chunk, *t.shape[2:])
    return t.movedim(3, 1)


def _ssd_chunk_terms(dtq: torch.Tensor, A: torch.Tensor):
    """One chunk (dtq [b,H,Q]): cum = cumsum(dt.A), the [Q, Q] decays
    exp(cum_i - cum_j) (overflowing above the diagonal: mask AFTER
    multiplying), the causal mask, and cum's last entry."""
    Q = dtq.shape[-1]
    cum = torch.cumsum(dtq * A[:, None], -1)                    # [b,H,Q]
    decay = torch.exp(cum[..., :, None] - cum[..., None, :])
    idx = torch.arange(Q, device=dtq.device)
    tri = idx[:, None] >= idx[None, :]
    return cum, decay, tri, cum[..., -1:]


def ssd_fwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, *, chunk: int = SSD_CHUNK
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the forward kernel computes (``repro/kernels/ssd.py::
    _ssd_kernel``): per chunk of Q rows, in fp32,

        cum     = cumsum(dt.A)
        y       = (tri(C.B^T * e^(cum_i - cum_j)) * dt_j).x
                  + (C * e^cum).state^T
        state  <- state * e^cum_Q + (x * e^(cum_Q - cum) * dt)^T.B

    Returns (y [b,S,H,P] in x's dtype, final state [b,H,P,N] fp32,
    cstates [b,H,nc,P,N] fp32: the state ENTERING each chunk, the
    backward's only residual)."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    xc, Bc, Cc = (_ssd_chunks(t, chunk) for t in (x, B, C))
    dtc = _ssd_chunks(dt, chunk)                               # [b,H,nc,Q]
    A = A.float()
    nc = xc.shape[2]
    state = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    cstates, ys = [], []
    for c in range(nc):
        xq, dtq, Bq, Cq = xc[:, :, c], dtc[:, :, c], Bc[:, :, c], Cc[:, :, c]
        cum, decay, tri, cum_last = _ssd_chunk_terms(dtq, A)
        w = torch.where(tri, (Cq @ Bq.transpose(-1, -2)) * decay, 0.0)
        w = w * dtq[..., None, :]
        cstates.append(state)
        ys.append(w @ xq + (Cq * torch.exp(cum)[..., None])
                  @ state.transpose(-1, -2))
        w_last = torch.exp(cum_last - cum) * dtq
        state = (state * torch.exp(cum_last)[..., None]
                 + (xq * w_last[..., None]).transpose(-1, -2) @ Bq)
    y = torch.stack(ys, 2).movedim(1, 3).reshape(b, nc * chunk, H, P)
    return y[:, :S].to(x.dtype), state, torch.stack(cstates, 2)


def ssd_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, cstates: torch.Tensor,
                gy: torch.Tensor, gstate: torch.Tensor, *,
                chunk: int = SSD_CHUNK, magnitudes: bool = False
                ) -> Tuple[torch.Tensor, ...]:
    """What the backward kernel computes (``repro/kernels/ssd.py::
    _ssd_bwd_kernel``), written out: the chunks in reverse, carrying the
    state cotangent dS (from ``gstate``), each chunk rebuilt from its
    entering state in ``cstates``; fp32 throughout.  Decay products are
    masked after the multiply.  One dA partial per (b, h, chunk), summed
    over batch and chunks at the end.

    Returns (dx, ddt, dA, dB, dC) in the primals' dtypes.  With
    ``magnitudes=True`` and |x|, |B|, |C|, |gy|, |gstate| and the cstates
    of the forward on |x|, |B|, |C| as inputs, every term enters with its
    magnitude: each output is then the sum of its terms' magnitudes, the
    condition-aware scale a kernel's rounding is held to."""
    b, S, H, P = x.shape
    xc, Bc, Cc, Gc = (_ssd_chunks(t, chunk) for t in (x, B, C, gy))
    dtc = _ssd_chunks(dt, chunk)
    Af = A.float()
    sign, A_term = (1.0, Af.abs()) if magnitudes else (-1.0, Af)
    nc = xc.shape[2]
    dS1 = gstate.float()
    dxs, ddts, dBs, dCs, dA_part = [], [], [], [], []
    for c in reversed(range(nc)):
        xq, dtq, Bq, Cq, G = (t[:, :, c] for t in (xc, dtc, Bc, Cc, Gc))
        S0 = cstates[:, :, c].float()
        cum, decay, tri, cum_last = _ssd_chunk_terms(dtq, Af)
        dt_row = dtq[..., None, :]
        cb = Cq @ Bq.transpose(-1, -2)
        W = torch.where(tri, cb * decay, 0.0) * dt_row
        ecum = torch.exp(cum)[..., None]                       # [b,H,Q,1]
        eQ = torch.exp(cum_last)                               # [b,H,1]
        e_last = torch.exp(cum_last - cum)
        w_last = (e_last * dtq)[..., None]
        dW = G @ xq.transpose(-1, -2)
        dxs.append(W.transpose(-1, -2) @ G
                   + (Bq @ dS1.transpose(-1, -2)) * w_last)
        dW_decay = torch.where(tri, dW * decay, 0.0)
        dcb = dW_decay * dt_row
        GS0 = G @ S0
        xdS1 = xq @ dS1
        dCs.append(dcb @ Bq + GS0 * ecum)
        dBs.append(dcb.transpose(-1, -2) @ Cq + xdS1 * w_last)
        TW = dW * W
        dcum = TW.sum(-1) + sign * TW.sum(-2) + (GS0 * Cq * ecum).sum(-1)
        dw = (xdS1 * Bq).sum(-1)
        V = dw * w_last[..., 0]
        dcum = dcum + sign * V
        last = (dS1 * S0).sum((-1, -2))[..., None] * eQ + V.sum(-1, True)
        dcum = torch.cat([dcum[..., :-1], dcum[..., -1:] + last], -1)
        ddt = (dW_decay * cb).sum(-2) + dw * e_last
        da = dcum.sum(-1, True) - torch.cumsum(dcum, -1) + dcum
        ddts.append(ddt + da * A_term[:, None])
        dA_part.append((da * dtq).sum(-1))
        dS1 = eQ[..., None] * dS1 + G.transpose(-1, -2) @ (Cq * ecum)

    def unchunk(parts, like):
        t = torch.stack(parts[::-1], 2).movedim(1, 3)
        return t.reshape(b, -1, *t.shape[3:])[:, :S].to(like.dtype)
    dA = torch.stack(dA_part[::-1], -1).sum((0, 2)).to(A.dtype)
    return (unchunk(dxs, x), unchunk(ddts, dt), dA, unchunk(dBs, B),
            unchunk(dCs, C))
