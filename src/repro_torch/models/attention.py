"""GQA attention, as ``repro/models/attention.py``: the training and
prefill path — ``naive`` (materialised [S, S] scores), ``blocked``
(online softmax over KV blocks) and ``kernel`` (flash attention through
``ops.flash_attention``: the CUDA kernels on a CUDA tensor, their plain
versions on a CPU tensor) — and one-token decode against a KV cache,
written in place.

``fused=True`` routes the QKV projection through ``ops.fused_qkv`` —
one GEMM against the concatenated weight with the bias in its epilogue —
for S > 1; decode projects with three plain products.

Over a sequence shard (``seq``, ``runtime/sharding.py::SeqShard``) a
rank projects its own positions, with RoPE at their global positions,
all-gathers K and V over the sequence group and attends its queries
against the keys up to its shard's end: the queries are the last Sq of
Sk positions, which every implementation takes (``Sq <= Sk``).

Under tensor parallelism (``tp``, ``runtime/sharding.py::TPContext``) a
rank computes its query heads and their kv heads: the normed input
enters through *f*, the projection runs on the rank's column shards of
``wq``/``wk``/``wv`` (and the biases), RoPE and the q/k norms per head
(their replicated weights through *f*, since each rank's gradient of
them covers its own heads only), attention over the local heads, and the
row-parallel ``wo`` product leaves through *g*.  A weight cut inside a
head (fewer kv heads than ranks) is gathered at use and sliced to the
heads the rank reads (``TPContext.take``).  Where the heads do not
divide the model axis a rank takes whole kv groups with their query
heads, or, with fewer kv heads than ranks, its query heads as evenly as
they fall and every kv head they read (``sharding.tp_heads``), and every
weight is gathered at use.  Query heads that straddle kv groups run as
pieces (``TPContext.pieces``), each an ordinary GQA call over its own kv
heads (whole groups, or part of one group over one kv head), and the
pieces' outputs are concatenated in head order before ``wo``'s rows; a
kv head two ranks split is computed by both from the same inputs, and
the gather's backward sums its weights' gradient.  With ``part=True``
the caller owns *f* and *g* (hymba's block joins the attention and the
Mamba2 mixer under one of each).  The decode takes the same heads and
pieces and writes them into a cache held at the rank's kv heads.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, rms_norm


def init_attention(gen: torch.Generator, arch: ArchConfig,
                   dtype=torch.float32):
    d, H, KV, hd = arch.d_model, arch.num_heads, arch.num_kv_heads, arch.head_dim
    dev = gen.device

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype) * scale
    s = d ** -0.5
    p = {"wq": normal((d, H * hd), s), "wk": normal((d, KV * hd), s),
         "wv": normal((d, KV * hd), s),
         "wo": normal((H * hd, d), (H * hd) ** -0.5)}
    if arch.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((KV * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((KV * hd,), dtype=dtype, device=dev)
    if arch.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
    return p


def _project_qkv(params, arch: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor, *, fused: bool = False,
                 heads: Optional[Tuple[int, int]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q [B, S, H, hd], k and v [B, S, KV, hd]; ``heads`` (H, KV)
    overrides the architecture's counts (a rank's heads under TP)."""
    B, S, _ = x.shape
    H, KV = heads or (arch.num_heads, arch.num_kv_heads)
    hd = arch.head_dim
    if fused and S > 1:
        bias = ((params["bq"], params["bk"], params["bv"])
                if arch.qkv_bias else (None, None, None))
        q, k, v = kops.fused_qkv(x, params["wq"], params["wk"],
                                 params["wv"], *bias)
    else:
        q = x @ params["wq"].to(x.dtype)
        k = x @ params["wk"].to(x.dtype)
        v = x @ params["wv"].to(x.dtype)
        if arch.qkv_bias:
            q = q + params["bq"].to(x.dtype)
            k = k + params["bk"].to(x.dtype)
            v = v + params["bv"].to(x.dtype)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if arch.qk_norm:
        q = rms_norm(params["q_norm"].to(x.dtype), q, arch.rms_norm_eps)
        k = rms_norm(params["k_norm"].to(x.dtype), k, arch.rms_norm_eps)
    q = apply_rope(q, positions, arch.rope_theta)
    k = apply_rope(k, positions, arch.rope_theta)
    return q, k, v


def _sdpa_naive(q, k, v, *, causal: bool, window: int):
    """q: [B,Sq,H,D], k/v: [B,Sk,KV,D] -> [B,Sq,H,D]; Sq <= Sk, the
    queries the last Sq of the Sk positions."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k) / math.sqrt(D)
    qpos = torch.arange(Sq, device=q.device) + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = scores.float().masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, D)


def _sdpa_blocked(q, k, v, *, causal: bool, window: int,
                  block_kv: int = 512):
    """Online softmax over KV blocks: O(S) memory.  Shapes as naive."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    nblk = -(-Sk // block_kv)
    pad = nblk * block_kv - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qg = q.reshape(B, Sq, KV, G, D)
    scale = 1.0 / math.sqrt(D)
    qpos = torch.arange(Sq, device=q.device) + (Sk - Sq)
    acc = torch.zeros((B, KV, G, Sq, D), dtype=q.dtype, device=q.device)
    m = torch.full((B, KV, G, Sq), float("-inf"), device=q.device)
    l = torch.zeros((B, KV, G, Sq), device=q.device)
    for j in range(nblk):
        kj = k[:, j * block_kv:(j + 1) * block_kv]
        vj = v[:, j * block_kv:(j + 1) * block_kv]
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kj).float() * scale
        kpos = j * block_kv + torch.arange(block_kv, device=q.device)
        mask = (kpos[None, :] < Sk).expand(Sq, block_kv)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        s = s.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        # guard fully-masked rows (m_new = -inf): contribute nothing
        safe_m = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        p = torch.exp(s - safe_m[..., None]).masked_fill(~mask, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m),
                           torch.zeros_like(m))
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(q.dtype), vj)
        acc = acc * corr[..., None].to(acc.dtype) + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None].to(acc.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


def _by_piece(attend, q, k, v, pieces):
    """``attend(q, k, v)`` over each piece ((query lo, hi), (kv lo, hi))
    of q's and k / v's heads (dimension 2), concatenated along the query
    heads; one piece (or none: one card) attends the whole."""
    if pieces is None or len(pieces) == 1:
        return attend(q, k, v)
    return torch.cat([attend(q[:, :, a:b], k[:, :, c:d], v[:, :, c:d])
                      for (a, b), (c, d) in pieces], dim=2)


def _tp_params(params, arch: ArchConfig, tp) -> Tuple[dict, Tuple[int, int]]:
    """The attention weights a rank of ``tp`` computes its heads with, and
    its (query heads, kv heads) counts (module docstring)."""
    hd, H, KV = arch.head_dim, arch.num_heads, arch.num_kv_heads
    (q0, q1), (k0, k1) = tp.heads, tp.kv_heads
    cols = {"q": (q0 * hd, q1 * hd, H * hd), "k": (k0 * hd, k1 * hd, KV * hd),
            "v": (k0 * hd, k1 * hd, KV * hd)}
    p = dict(params)
    for c, (lo, hi, full) in cols.items():
        p["w" + c] = tp.take(params["w" + c], 1, lo, hi, full)
        if arch.qkv_bias:
            p["b" + c] = tp.take(params["b" + c], 0, lo, hi, full)
    p["wo"] = tp.take(params["wo"], 0, *cols["q"])
    if arch.qk_norm:
        p["q_norm"], p["k_norm"] = tp.f(params["q_norm"]), tp.f(params["k_norm"])
    return p, (q1 - q0, k1 - k0)


def attention(params, arch: ArchConfig, x: torch.Tensor, *,
              impl: str = "blocked", block_kv: int = 512,
              fused: bool = False, seq=None, tp=None,
              part: bool = False) -> torch.Tensor:
    """Training attention.  x: [B, S, d_model], or this rank's positions
    of the sequence when ``seq`` is a sliced ``SeqShard``; under ``tp``
    this rank's heads, summed over the model group, or with ``part``
    this rank's unsummed part of x already through *f* (module
    docstring)."""
    if impl not in ("naive", "blocked", "kernel"):
        raise ValueError(f"unknown attention impl {impl!r}")
    B, S, _ = x.shape
    sliced = seq is not None and seq.sliced
    start = seq.start if sliced else 0
    positions = torch.arange(start, start + S, device=x.device).expand(B, S)
    heads = None
    if tp is not None:
        params, heads = _tp_params(params, arch, tp)
        if not part:
            x = tp.f(x)
    q, k, v = _project_qkv(params, arch, x, positions, fused=fused,
                           heads=heads)
    if sliced:
        # K and V of every position up to this shard's end, in one gather
        KV = k.shape[2]
        kv = seq.gather(torch.cat([k, v], dim=2), "kv")[:, :seq.stop]
        k, v = kv[:, :, :KV], kv[:, :, KV:]
    Sk = k.shape[1]
    window = arch.sliding_window

    def attend(q, k, v):
        if impl == "kernel" and Sk > 1:
            return kops.flash_attention(q, k, v, window=window)
        if impl == "blocked" and Sk > 1:
            return _sdpa_blocked(q, k, v, causal=True, window=window,
                                 block_kv=min(block_kv, Sk))
        return _sdpa_naive(q, k, v, causal=True, window=window)
    o = _by_piece(attend, q, k, v, tp.pieces if tp is not None else None)
    o = o.reshape(B, S, -1) @ params["wo"].to(x.dtype)
    return tp.g(o) if tp is not None and not part else o


# ----------------------------------------------------------------------
# Decode path (KV cache)
# ----------------------------------------------------------------------
def init_kv_cache(arch: ArchConfig, batch: int, max_len: int, dtype,
                  device="cpu", kv_heads: Optional[Tuple[int, int]] = None):
    """[batch, L, KV, hd] k and v; with a sliding window L is the window
    (a ring buffer), else ``max_len``.  ``kv_heads``: a rank's [lo, hi)
    of the kv heads under TP (``TPContext.kv_heads``), the heads its
    decode writes."""
    KV, hd = arch.num_kv_heads, arch.head_dim
    if kv_heads is not None:
        KV = kv_heads[1] - kv_heads[0]
    L = min(max_len, arch.sliding_window) if arch.sliding_window else max_len
    return {"k": torch.zeros((batch, L, KV, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, L, KV, hd), dtype=dtype, device=device)}


def decode_attention_(params, arch: ArchConfig, x: torch.Tensor, cache: dict,
                      pos: torch.Tensor, write=None, *, tp=None,
                      part: bool = False) -> torch.Tensor:
    """One-token decode, writing the new K/V rows into ``cache`` in place
    (the reference's ``decode_attention`` returns a new cache, donated
    under jit; this is its torch form).  x: [B, 1, d]; pos: a scalar
    position, or [B] per-row positions (each row writes its own cache
    slot and masks its own length).  ``write`` ([B] bool) keeps the cache
    of the rows where it is False; those rows' outputs are then
    meaningless.  A position at or past a full-length cache writes its
    last slot (the reference drops such a write; only rows whose output
    is discarded reach one).  Under ``tp`` the rank's heads, as
    ``attention`` takes them, against ``cache`` at its kv heads
    (``init_kv_cache(..., kv_heads=)``); ``part`` as ``attention``'s.
    Returns out [B, 1, d]."""
    B = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device)
    vec = pos.dim() == 1
    positions = pos[:, None] if vec else pos.expand(B, 1)
    heads = None
    if tp is not None:
        params, heads = _tp_params(params, arch, tp)
        if not part:
            x = tp.f(x)
    H = heads[0] if heads else arch.num_heads
    q, k, v = _project_qkv(params, arch, x, positions, heads=heads)
    ck, cv = cache["k"], cache["v"]
    L = ck.shape[1]
    slot = pos % L if arch.sliding_window else pos
    rows = torch.arange(B, device=x.device)
    at = (rows, slot.clamp(max=L - 1))
    if write is None:
        ck[at] = k[:, 0]
        cv[at] = v[:, 0]
    else:
        keep = ~write[:, None, None]
        ck[at] = torch.where(keep, ck[at], k[:, 0])
        cv[at] = torch.where(keep, cv[at], v[:, 0])
    hd = arch.head_dim
    idx = torch.arange(L, device=x.device)
    p = pos[:, None] if vec else pos
    s = slot[:, None] if vec else slot
    # a filled ring buffer holds the window's positions in every slot
    valid = ((idx <= s) | (p >= L)) if arch.sliding_window else idx <= p
    valid = valid.reshape(-1, 1, 1, L)

    def attend(q, ck, cv):
        kv = ck.shape[2]
        qg = q.reshape(B, kv, q.shape[2] // kv, hd)
        scores = (torch.einsum("bkgd,bskd->bkgs", qg, ck).float()
                  / math.sqrt(hd))
        scores = scores.masked_fill(~valid, float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        return torch.einsum("bkgs,bskd->bkgd", probs, cv).reshape(
            B, 1, q.shape[2], hd)
    o = _by_piece(attend, q.reshape(B, 1, H, hd), ck, cv,
                  tp.pieces if tp is not None else None)
    o = o.reshape(B, 1, H * hd) @ params["wo"].to(x.dtype)
    return tp.g(o) if tp is not None and not part else o
