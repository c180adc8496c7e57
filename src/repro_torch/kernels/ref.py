"""Plain PyTorch versions of the port's kernels.

Each is the same function as a CUDA kernel in ``csrc/fused.cu``, written
in the most obvious way.  The CPU path runs them (``kernels/ops.py``
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
