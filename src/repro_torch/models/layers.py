"""Shared layers: RMSNorm, RoPE, MLPs, embeddings, cross-entropy (whole
and chunked).

Plain functions on tensors; parameters are plain dicts with the JAX
package's keys (``repro/models/layers.py``), so weights map 1:1.

Vocab-parallel forms, for a table whose rows are cut over the model
axis (``tp``, ``runtime/sharding.py::TPContext``; each rank holds rows
[v0, v1)): ``vocab_embed`` looks up the tokens this rank's rows hold and
sums the ranks' rows through *g*; the CEs take this rank's logits of
*f*(x) and join the global maximum, the sum of exponentials and the gold
logit (from the rank that holds it) over the model group.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """fp32 second moment; the normalised value is cast back to x's
    dtype before the weight multiply."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def init_rms_norm(d: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


# ----------------------------------------------------------------------
# Rotary position embeddings (split-half)
# ----------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # [hd/2]
    ang = positions[..., :, None].float() * freqs               # [..., s, hd/2]
    cos = torch.cos(ang)[..., :, None, :]                       # [..., s, 1, hd/2]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------
def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, variant: str,
             dtype=torch.float32):
    dev = gen.device
    scale_in, scale_out = d_model ** -0.5, d_ff ** -0.5

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype) * scale
    if variant == "swiglu":
        return {"gate": normal((d_model, d_ff), scale_in),
                "up": normal((d_model, d_ff), scale_in),
                "down": normal((d_ff, d_model), scale_out)}
    return {"up": normal((d_model, d_ff), scale_in),
            "down": normal((d_ff, d_model), scale_out)}


def mlp(params, x: torch.Tensor, variant: str) -> torch.Tensor:
    if variant == "swiglu":
        h = F.silu(x @ params["gate"].to(x.dtype))
        h = h * (x @ params["up"].to(x.dtype))
    else:
        # jax.nn.gelu is the tanh approximation by default
        h = F.gelu(x @ params["up"].to(x.dtype), approximate="tanh")
    return h @ params["down"].to(x.dtype)


# ----------------------------------------------------------------------
# Embedding / head
# ----------------------------------------------------------------------
def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype=torch.float32):
    table = torch.randn((vocab, d_model), generator=gen, device=gen.device,
                        dtype=torch.float32).to(dtype) * 0.02
    return {"table": table}


def embed(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    # F.embedding: its CUDA backward sums the rows of a repeated token
    # without float atomics
    return F.embedding(tokens.long(), params["table"].to(dtype))


def vocab_embed(params, tokens: torch.Tensor, dtype, tp) -> torch.Tensor:
    """``embed`` of a vocab-parallel table: the tokens outside this
    rank's rows look up row 0 and are zeroed before the sum, so their
    cotangent never reaches row 0 (module docstring)."""
    v0, v1 = tp.vocab
    t = tokens.long()
    inside = (t >= v0) & (t < v1)
    rows = F.embedding(torch.where(inside, t - v0, 0),
                       params["table"].to(dtype))
    return tp.g(rows * inside[..., None].to(dtype), "vocab")


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Project to vocab logits in fp32 (stable loss)."""
    return x.float() @ params["table"].float().t()


def vocab_nll(logits: torch.Tensor, labels: torch.Tensor, tp
              ) -> torch.Tensor:
    """Per-position NLL from this rank's logits [..., v1 - v0] of its
    vocabulary rows: log-sum-exp shifted by the global maximum, the sum
    of exponentials and the gold logit summed over the model group
    through *g* in one call."""
    v0, v1 = tp.vocab
    logits = logits.float()
    m = tp.max(logits.amax(-1))
    lab = labels.long() - v0
    inside = (lab >= 0) & (lab < v1 - v0)
    gold = torch.gather(logits, -1, lab.clamp(0, v1 - v0 - 1)[..., None])
    se, gold = tp.g(torch.stack([
        torch.exp(logits - m[..., None]).sum(-1),
        torch.where(inside, gold[..., 0], 0.0)]), "vocab").unbind(0)
    return torch.log(se) + m - gold


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, tp=None
                  ) -> torch.Tensor:
    """Mean token NLL.  ``labels`` are pre-shifted next-token targets
    aligned with ``logits`` (labels[..., t] is the target for position
    t); ``mask`` (0/1) excludes positions.  With ``tp`` the logits are
    this rank's vocabulary rows' (``vocab_nll``)."""
    if tp is not None:
        nll = vocab_nll(logits, labels, tp)
    else:
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def fused_cross_entropy(x: torch.Tensor, table: torch.Tensor,
                        labels: torch.Tensor, chunk: int,
                        mask: Optional[torch.Tensor] = None,
                        drop_last: bool = True, tp=None) -> torch.Tensor:
    """Next-token CE from the hidden states without the [B, S, V] logits:
    ``chunk`` positions at a time, each chunk's [B, c, V] logits built
    for its sums and built again in backward (a checkpoint per chunk).
    x: [B, S, d] after the final norm; labels: [B, S] pre-shifted; the
    final position is excluded, as in the whole CE (``drop_last=False``
    keeps every position: a sequence shard's mask already weighs it).
    With ``tp`` ``table`` is this rank's vocabulary rows: x enters
    through *f* and each chunk's NLL is ``vocab_nll``'s."""
    if tp is not None:
        x = tp.f(x, "vocab")
    B, S, d = x.shape
    cut = S - 1 if drop_last else S
    xs, ls = x[:, :cut], labels[:, :cut].long()
    ms = (mask[:, :cut].float() if mask is not None
          else torch.ones(ls.shape, dtype=torch.float32, device=x.device))
    n = cut
    c = min(chunk, n)
    w = table.float()

    def body(xc, lc, mc, w):
        logits = xc.float() @ w.t()
        if tp is not None:
            return (vocab_nll(logits, lc, tp) * mc).sum(), mc.sum()
        gold = torch.gather(logits, -1, lc[..., None])[..., 0]
        nll = (torch.logsumexp(logits, -1) - gold) * mc
        return nll.sum(), mc.sum()

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, n, c):
        t, k = checkpoint(body, xs[:, i:i + c], ls[:, i:i + c],
                          ms[:, i:i + c], w, use_reentrant=False)
        tot, cnt = tot + t, cnt + k
    return tot / torch.clamp(cnt, min=1.0)
