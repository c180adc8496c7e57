"""Causal GQA flash attention on the card: wrappers around the CUDA
kernels of ``csrc/flash.cuh`` (entry points in ``csrc/flash.cu``;
``ops.FlashAttention`` is their ``torch.autograd.Function``).

  * ``flash_fwd``: (out, lse) in one kernel; the [S, S] scores never
    reach device memory.  In bf16 at head dims 64 and 128, wherever TMA
    can read q, k and v in place (``tma.flash_maps``), it runs the
    warp-specialised wgmma instance (``csrc/flash_wgmma.cu``, launched as
    ``flash_fwd_wgmma``); elsewhere flash.cuh's mma.sync instance.
  * ``flash_bwd_dq`` and ``flash_bwd_dkdv``: the two-pass backward, p
    rebuilt from the saved lse.  dk and dv come from ONE kernel that
    loops the G query heads of each kv head itself, so they are written
    once, at kv-head resolution, with no atomics.  In bf16 at head dims
    64 and 128, wherever TMA can read q, k, v and dO in place
    (``tma.flash_bwd_maps``), both run the warp-specialised wgmma
    instances (``csrc/flash_bwd_wgmma.cu``, launched as
    ``flash_bwd_dq_wgmma`` and ``flash_bwd_dkdv_wgmma``); elsewhere
    flash.cuh's mma.sync instances.
  * ``delta = rowsum(dO * O)`` is an input of both backward kernels:
    one plain PyTorch reduction (``ref.flash_delta``), as the JAX
    package computes it in plain jnp outside its kernels.

q and out are [B, Sq, H, D]; k and v [B, Sk, KV, D] with Sq <= Sk,
the queries the last Sq of the Sk positions (a sequence shard's queries
against the keys up to the shard's end: causal means k <= q + Sk - Sq);
lse and delta [B, H, Sq] fp32; dk and dv [B, Sk, KV, D], zero on the
rows no query sees.  q, k, v and dO are read through their strides (the
head dim must be dense); outputs are new contiguous tensors.  Every
wrapper takes CUDA tensors only and raises on anything else, including
a head dim or tile the kernels are not built for; the CPU path never
reaches this module (``kernels/ops.py`` routes a CPU tensor to the plain
versions in ``kernels/ref.py``).  Launches are counted in
``build.LAUNCHES``.

Tiles: the forward and dq take ``block_q``, the rows of their q blocks
(kv blocks are 64 rows), dk/dv ``block_k``, the rows of its kv blocks
(q blocks are 64 rows); each defaults to the autotuner's
(``autotune.flash_config``).  Every tile gives bitwise-equal outputs.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import autotune, tma
from repro_torch.kernels.build import check_tensors, current_stream, launch

#: head dims with a template instance in csrc/flash.cuh: the reduced
#: configs at d_model 64 (16), 32, gpt3-medium (64), GPT-3 2.7B (80),
#: phi3-vision (96), qwen2.5-3b (128)
HEAD_DIMS = (16, 32, 64, 80, 96, 128)
#: the kernels of csrc/flash.cuh, by their launchers' names
KERNELS = ("fwd", "dq", "dkdv")
_DTYPES = (torch.float32, torch.bfloat16)


#: head dims of the bf16 wgmma instances (csrc/flash_wgmma.cu,
#: csrc/flash_bwd_wgmma.cu), whose tiles are 64 and 128 rows (one or two
#: consumer warpgroups)
WGMMA_HEAD_DIMS = tuple(tma.FLASH_KV_ROWS)


def built(kernel: str, D: int, dtype: torch.dtype, tile: int) -> bool:
    """Whether ``kernel`` ("fwd", "dq", "dkdv") has an instance at head
    dim D, dtype and tile rows (csrc/flash.cuh's ``wide_built``): the
    64-row tile at every ``HEAD_DIMS``; the 128-row one at D 64, and at
    D 128 for the forward and in bf16 (fp32 dq and dk/dv would need
    270,336 bytes of shared memory, past the 232,448 a block may take).
    The bf16 wgmma instances of all three kernels build the same two
    tiles at ``WGMMA_HEAD_DIMS`` (``WGMMA_INSTANCES``)."""
    if tile == 64:
        return D in HEAD_DIMS
    return tile == 128 and (D == 64 or (D == 128 and (
        kernel == "fwd" or dtype == torch.bfloat16)))


def tiles(kernel: str, D: int, dtype: torch.dtype) -> List[int]:
    """The built tiles of one kernel at (D, dtype)."""
    return [t for t in (64, 128) if built(kernel, D, dtype, t)]


#: every built (kernel, head dim, dtype, tile): the autotuner's candidates
INSTANCES = tuple((k, D, dt, t) for k in KERNELS for D in HEAD_DIMS
                  for dt in _DTYPES for t in tiles(k, D, dt))
#: the (kernel, head dim, dtype, tile) of the wgmma instances: a call
#: takes one where its operands allow it (``forward_instance``,
#: ``backward_instance``), else flash.cuh's of the same tile
WGMMA_INSTANCES = tuple((k, D, torch.bfloat16, t) for k in KERNELS
                        for D in WGMMA_HEAD_DIMS for t in (64, 128))


def _strides(t: torch.Tensor) -> Tuple[int, int, int]:
    return t.stride(0), t.stride(1), t.stride(2)


def _check(name: str, q, k, v, *more, window: int) -> Tuple:
    """Validate the attention operands (``more``: tensors shaped like q);
    return (code, B, Sq, Sk, H, KV, D)."""
    code = check_tensors(name, q, k, v, *more)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q [B,Sq,H,D] and k/v [B,Sk,KV,D] "
                         f"expected, got {tuple(q.shape)} {tuple(k.shape)}")
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if (k.shape != (B, Sk, KV, D) or v.shape != k.shape or KV == 0
            or H % KV != 0 or Sq == 0 or Sk < Sq
            or any(t.shape != q.shape for t in more)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} "
                         f"{[tuple(t.shape) for t in more]}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not built (one of {HEAD_DIMS})")
    if window < 0:
        raise ValueError(f"{name}: window {window} < 0")
    for t in (q, k, v, *more):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be dense "
                             f"(strides {t.stride()})")
    return code, B, Sq, Sk, H, KV, D


def _check_rows(name: str, lse: torch.Tensor, delta: torch.Tensor,
                B: int, H: int, S: int) -> None:
    for t in (lse, delta):
        if (t.shape != (B, H, S) or t.dtype != torch.float32
                or t.device != lse.device or not t.is_contiguous()):
            raise ValueError(f"{name}: lse and delta must be contiguous "
                             f"[B,H,Sq] fp32 on the card, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device}")


def resolve_tiles(q: torch.Tensor, block_q: Optional[int] = None,
                  block_k: Optional[int] = None) -> Tuple[int, int]:
    """(block_q, block_k) for attention over q [B, Sq, H, D]: the given
    ones, the autotuner's for the rest (keyed by the queries' Sq)."""
    if block_q is None or block_k is None:
        cfg = autotune.flash_config(autotune.backend_of(q.device), q.dtype,
                                    q.shape[1], q.shape[-1])
        block_q = cfg["block_q"] if block_q is None else block_q
        block_k = cfg["block_k"] if block_k is None else block_k
    return int(block_q), int(block_k)


def check_tile(name: str, kernel: str, D: int, dtype: torch.dtype,
               tile: int) -> None:
    if not built(kernel, D, dtype, tile):
        raise ValueError(f"{name}: tile {tile} is not built at head dim {D} "
                         f"in {dtype} (built: {tiles(kernel, D, dtype)})")


def forward_instance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block_q: int) -> Optional[tma.Spec]:
    """The tensor-map specs of the wgmma forward for this call, or None
    for flash.cuh's mma.sync instance: bf16 at ``WGMMA_HEAD_DIMS`` where
    TMA can read q, k and v in place (``tma.flash_maps``)."""
    if q.dtype != torch.bfloat16 or q.shape[-1] not in WGMMA_HEAD_DIMS:
        return None
    return tma.flash_maps(q, k, v, block_q)


def backward_instance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      g: torch.Tensor, kernel: str, tile: int
                      ) -> Optional[tma.Spec]:
    """The tensor-map specs of the wgmma ``kernel`` ("dq" or "dkdv") at
    ``tile`` for this call, or None for flash.cuh's mma.sync instance:
    bf16 at ``WGMMA_HEAD_DIMS`` where TMA can read q, k, v and dO in place
    (``tma.flash_bwd_maps``)."""
    if q.dtype != torch.bfloat16 or q.shape[-1] not in WGMMA_HEAD_DIMS:
        return None
    return tma.flash_bwd_maps(q, k, v, g, kernel, tile)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int = 0, block_q: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out [B,Sq,H,D] in q's dtype, lse [B,H,Sq] fp32), from the
    wgmma instance where ``forward_instance`` allows it, else from
    flash.cuh's."""
    code, B, Sq, Sk, H, KV, D = _check("flash_fwd", q, k, v, window=window)
    block_q = resolve_tiles(q, block_q, 0)[0]
    check_tile("flash_fwd", "fwd", D, q.dtype, block_q)
    maps = forward_instance(q, k, v, block_q)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if maps is not None:
        launch("flash_fwd_wgmma", q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), lse.data_ptr(), B, Sq, Sk, H, KV, D, window,
               1.0 / math.sqrt(D), (ctypes.c_longlong * len(maps))(*maps),
               block_q, current_stream(q))
        return out, lse
    launch("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), lse.data_ptr(), B, Sq, Sk, H, KV, D, window,
           1.0 / math.sqrt(D), *_strides(q), *_strides(k), *_strides(v),
           block_q, code, current_stream(q))
    return out, lse


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 window: int = 0, block_q: Optional[int] = None
                 ) -> torch.Tensor:
    """dq [B,Sq,H,D] from dO = g, the forward's lse and delta, from the
    wgmma instance where ``backward_instance`` allows it, else from
    flash.cuh's."""
    code, B, Sq, Sk, H, KV, D = _check("flash_bwd_dq", q, k, v, g,
                                       window=window)
    _check_rows("flash_bwd_dq", lse, delta, B, H, Sq)
    block_q = resolve_tiles(q, block_q, 0)[0]
    check_tile("flash_bwd_dq", "dq", D, q.dtype, block_q)
    maps = backward_instance(q, k, v, g, "dq", block_q)
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if maps is not None:
        launch("flash_bwd_dq_wgmma", q.data_ptr(), k.data_ptr(),
               v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
               dq.data_ptr(), B, Sq, Sk, H, KV, D, window,
               1.0 / math.sqrt(D), (ctypes.c_longlong * len(maps))(*maps),
               block_q, current_stream(q))
        return dq
    launch("flash_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
           g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
           B, Sq, Sk, H, KV, D, window, 1.0 / math.sqrt(D), *_strides(q),
           *_strides(k), *_strides(v), *_strides(g), block_q, code,
           current_stream(q))
    return dq


def flash_bwd_dkdv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                   window: int = 0, block_k: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each [B,Sk,KV,D], summed over the group in fp32, from
    the wgmma instance where ``backward_instance`` allows it, else from
    flash.cuh's."""
    code, B, Sq, Sk, H, KV, D = _check("flash_bwd_dkdv", q, k, v, g,
                                       window=window)
    _check_rows("flash_bwd_dkdv", lse, delta, B, H, Sq)
    block_k = resolve_tiles(q, 0, block_k)[1]
    check_tile("flash_bwd_dkdv", "dkdv", D, q.dtype, block_k)
    maps = backward_instance(q, k, v, g, "dkdv", block_k)
    dk = torch.empty((B, Sk, KV, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, Sk, KV, D), dtype=v.dtype, device=v.device)
    if maps is not None:
        launch("flash_bwd_dkdv_wgmma", q.data_ptr(), k.data_ptr(),
               v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
               dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, KV, D, window,
               1.0 / math.sqrt(D), (ctypes.c_longlong * len(maps))(*maps),
               block_k, current_stream(q))
        return dk, dv
    launch("flash_bwd_dkdv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
           g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
           dv.data_ptr(), B, Sq, Sk, H, KV, D, window, 1.0 / math.sqrt(D),
           *_strides(q), *_strides(k), *_strides(v), *_strides(g), block_k,
           code, current_stream(q))
    return dk, dv
