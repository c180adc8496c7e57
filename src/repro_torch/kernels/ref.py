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
    """Causal GQA attention.  q: [B,S,H,D]; k/v: [B,S,KV,D]."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, D).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(D)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


#: the flash kernels' mask value (``repro/kernels/flash_attention.py``)
NEG_INF = -1e30


def _visible(S: int, window: int, device) -> torch.Tensor:
    """[S, S] mask of the (q, k) pairs that take part: causal, and inside
    the sliding window when window > 0."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """fp32 scaled scores [B, KV, G, Sq, Sk] of q [B,S,H,D] against
    k [B,S,KV,D]."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, S, KV, H // KV, D)
    return torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (1.0 / math.sqrt(D))


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the flash forward kernel computes: (out [B,S,H,D] in q's
    dtype, lse [B,H,S] fp32), in fp32 with the reference's masked value
    and ``l >= 1e-20`` clamp."""
    B, S, H, D = q.shape
    mask = _visible(S, window, q.device)
    s = _scores(q, k).masked_fill(~mask, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-20)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float()) / l
    out = o.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)
    lse = (m + torch.log(l)).reshape(B, H, S)
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
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    mask = _visible(S, window, q.device)
    p = torch.exp(_scores(q, k) - lse.reshape(B, KV, G, S, 1))
    p = p.masked_fill(~mask, 0.0)
    gg = g.float().reshape(B, S, KV, G, D)
    dp = torch.einsum("bqkgd,bskd->bkgqs", gg, v.float())
    ds = p * (dp - delta.reshape(B, KV, G, S, 1)) * (1.0 / math.sqrt(D))
    return p, ds


def flash_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: Optional[torch.Tensor], lse: torch.Tensor,
                  g: torch.Tensor, *, window: int = 0,
                  delta: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the two flash backward kernels compute: (dq, dk, dv) =
    (sum ds.k, sum ds^T.q, sum p^T.dO), dk and dv at KV-head resolution,
    summed over the group in fp32 before one cast.  ``delta`` is
    ``flash_delta(out, g)`` unless given."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    if delta is None:
        delta = flash_delta(out, g)
    p, ds = flash_bwd_terms(q, k, v, lse, g, delta, window=window)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()).reshape(B, S, H, D)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.float().reshape(B, S, KV, G, D))
    dv = torch.einsum("bkgqs,bqkgd->bskd", p,
                      g.float().reshape(B, S, KV, G, D))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
