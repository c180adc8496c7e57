"""Public kernel entry points, routed by the device of their inputs.

  * a CPU tensor runs the plain PyTorch version (``kernels/ref.py``);
  * a CUDA tensor launches the hand-written CUDA kernel
    (``kernels/fused.py``, ``kernels/flash.py``, ``kernels/ssd.py``), or
    raises;
  * anything else raises.

There is no capability probe and no fallback: a CUDA tensor never runs
a plain version, nor another tile than the one resolved.  Tiles and
chunks default to the autotuner's (``kernels/autotune.py``), resolved
once per call; on a CPU tensor flash's are resolved and unused (the
plain version has no tiles) and the SSD chunk is the plain version's.
``backend_signature(device)`` is part of every program-cache key over
stage programs (``runtime/pipeline.py``), so a program built for one
device, card or kernel build is never served to another.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import flash as _flash
from repro_torch.kernels import fused as _fused
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd as _ssd


def _route(name: str, x: torch.Tensor) -> str:
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel or plain version for device "
                         f"{x.device}")
    return kind


@functools.lru_cache(maxsize=None)
def _device_identity(device: torch.device) -> Tuple:
    if device.type == "cuda":
        return (torch.cuda.get_device_name(device),
                torch.cuda.get_device_capability(device))
    return (device.type, None)


def backend_signature(device="cuda") -> Tuple:
    """(device type, device name, capability, torch version, hash of the
    kernel sources)."""
    dev = torch.device(device)
    name, capability = _device_identity(dev)
    return (dev.type, name, capability, torch.__version__,
            _build.source_hash())


def fused_add_rmsnorm(x: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                      eps: float = 1e-6
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused (res, h) = (x + r, rms_norm(w, x + r)).  x/r: [..., d];
    ``w`` must already be in x's dtype."""
    if _route("fused_add_rmsnorm", x) == "cpu":
        return _ref.add_rmsnorm_ref(x, r, w, eps=eps)
    d = x.shape[-1]
    res, h = _fused.AddRMSNorm.apply(x.reshape(-1, d), r.reshape(-1, d), w,
                                     float(eps))
    return res.reshape(x.shape), h.reshape(x.shape)


def fused_qkv(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
              wv: torch.Tensor, bq: Optional[torch.Tensor] = None,
              bk: Optional[torch.Tensor] = None,
              bv: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused QKV projection: one GEMM against the concatenated weight
    with the bias in its epilogue.  x: [..., d]; w*: [d, cols_*].
    Returns the three flat projections [..., cols_*]."""
    if _route("fused_qkv", x) == "cpu":
        return _ref.qkv_ref(x, wq, wk, wv, bq, bk, bv)
    d = x.shape[-1]
    cq, ck = wq.shape[1], wk.shape[1]
    wcat = torch.cat([wq, wk, wv], dim=1).to(x.dtype)
    bcat = (torch.cat([bq, bk, bv]).to(x.dtype) if bq is not None else None)
    y2 = _fused.MatmulBias.apply(x.reshape(-1, d), wcat, bcat)
    y = y2.reshape(*x.shape[:-1], y2.shape[-1])
    return tuple(torch.split(y, [cq, ck, y.shape[-1] - cq - ck], dim=-1))


class FlashAttention(torch.autograd.Function):
    """Causal GQA attention whose backward rebuilds p from the saved lse:
    the three CUDA kernels of ``kernels/flash.py`` on a CUDA tensor (the
    forward's and dq's q tile ``block_q``, dk/dv's kv tile ``block_k``,
    checked built before the forward runs), their plain versions on a CPU
    tensor (one structure, so the CPU tests run the custom backward's
    math and a CPU tensor never reaches ``kernels/flash.py``)."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, block_q: int, block_k: int):
        if q.device.type == "cpu":
            out, lse = _ref.flash_fwd_ref(q, k, v, window=window)
        else:
            D = q.shape[-1]
            for name, kernel, tile in (("flash_bwd_dq", "dq", block_q),
                                       ("flash_bwd_dkdv", "dkdv", block_k)):
                _flash.check_tile(name, kernel, D, q.dtype, tile)
            out, lse = _flash.flash_fwd(q, k, v, window, block_q)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.block_q, ctx.block_k = window, block_q, block_k
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.contiguous()
        delta = _ref.flash_delta(out, g)
        if q.device.type == "cpu":
            dq, dk, dv = _ref.flash_bwd_ref(q, k, v, out, lse, g,
                                            window=ctx.window, delta=delta)
        else:
            dq = _flash.flash_bwd_dq(q, k, v, g, lse, delta, ctx.window,
                                     ctx.block_q)
            dk, dv = _flash.flash_bwd_dkdv(q, k, v, g, lse, delta, ctx.window,
                                           ctx.block_k)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int = 0, block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Causal GQA attention with the flash backward.  q: [B, Sq, H, D];
    k/v: [B, Sk, KV, D] with Sq <= Sk, the queries the last Sq of the Sk
    positions (query i sees keys <= i + Sk - Sq: a sequence shard's
    queries against the keys up to its end); ``window > 0`` adds a
    sliding window.  Returns [B, Sq, H, D] in q's dtype.  ``block_q`` /
    ``block_k`` default to the autotuner's choice for (backend, dtype, Sq
    bucket, D), one resolution that the forward and the backward
    share."""
    _route("flash_attention", q)
    if k.shape[1] < q.shape[1]:
        raise ValueError(f"flash_attention: {q.shape[1]} queries against "
                         f"{k.shape[1]} keys; Sq <= Sk")
    block_q, block_k = _flash.resolve_tiles(q, block_q, block_k)
    return FlashAttention.apply(q, k, v, int(window), block_q, block_k)


class SSD(torch.autograd.Function):
    """The Mamba2 SSD chunked scan with the reverse-chunk backward: the
    two CUDA kernels of ``kernels/ssd.py`` on a CUDA tensor, their plain
    versions on a CPU tensor (one structure, so the CPU tests run the
    custom backward's math and a CPU tensor never reaches
    ``kernels/ssd.py``), both at the chunk of the call.  The forward saves
    only the chunk-boundary states, ceil(S / chunk) of them, and its
    chunk for the backward."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int):
        if x.device.type == "cpu":
            y, state, cstates = _ref.ssd_fwd_ref(x, dt, A, B, C, chunk=chunk)
        else:
            y, state, cstates = _ssd.ssd_fwd(x, dt, A, B, C, chunk)
        ctx.save_for_backward(x, dt, A, B, C, cstates)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, gy, gstate):
        # an unused output's cotangent arrives as zeros of its dtype (fp32
        # for the state, as the reference's custom VJP casts it); a
        # broadcast cotangent (of a sum) is made dense for the kernel
        x, dt, A, B, C, cstates = ctx.saved_tensors
        gstate = gstate.contiguous()
        if gy.stride(-1) != 1:
            gy = gy.contiguous()
        if x.device.type == "cpu":
            grads = _ref.ssd_bwd_ref(x, dt, A, B, C, cstates, gy, gstate,
                                     chunk=ctx.chunk)
        else:
            grads = _ssd.ssd_bwd(x, dt, A, B, C, cstates, gy, gstate,
                                 ctx.chunk)
        return (*grads, None)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        B: torch.Tensor, C: torch.Tensor, chunk: Optional[int] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD with the kernels' forward AND backward.  x: [b,S,H,P];
    dt: [b,S,H] fp32 (post-softplus); A: [H] fp32; B/C: [b,S,H,N] (may be
    stride-0 views over the heads).  Returns (y in x's dtype, final state
    [b,H,P,N] fp32).  ``chunk`` defaults to the autotuner's choice for
    (backend, dtype, S bucket, P, N); on a CUDA tensor a chunk the
    kernels are not built for (``ssd.CHUNKS``) raises.  SSD is
    chunk-invariant up to the order of its sums."""
    kind = _route("ssd", x)
    chunk = _ssd.resolve_chunk(x, B, chunk)
    if kind == "cuda":
        _ssd.check_chunk("ssd", chunk)
    return SSD.apply(x, dt, A, B, C, chunk)
