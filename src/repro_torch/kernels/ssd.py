"""Mamba2 SSD chunked scan on the card: wrappers around the CUDA kernels
of ``csrc/ssd.cu`` and ``csrc/ssd_wgmma.cu`` (``ops.SSD`` is their
``torch.autograd.Function``).

  * ``ssd_fwd``: (y, final state, cstates) in three chunk-parallel
    phases launched by one entry point: each chunk's local state, a scan
    over the chunks of the [P, N] states (in place in cstates), each
    chunk's y; every product on the tensor cores.
  * ``ssd_bwd``: (dx, ddt, dA, dB, dC) in the same three phases from the
    saved cstates: each chunk's local state cotangent into an fp32
    scratch [b, H, nc, P, N] allocated here, the reverse scan that turns
    it into the carried dS1, each chunk's gradients.  dA comes out as one
    fp32 partial per (batch, head, chunk), summed here in a fixed order:
    no atomics, so two runs are bitwise equal.

x, y, gy and dx are [b, S, H, P]; dt and ddt [b, S, H] fp32; A [H] fp32;
B, C, dB and dC [b, S, H, N]; states [b, H, P, N] fp32 and cstates
[b, H, nc, P, N] fp32, nc = ceil(S / chunk).  The chunk is one of
``CHUNKS``, by default the autotuner's (``autotune.ssd_config``); the
backward must take its forward's.  x, dt, B, C and gy are read
through their strides (the last dim must be dense; B and C may be one
group expanded over the heads with head stride 0); outputs are new
contiguous tensors.  In bf16 at (P, N) = (64, 128) and (64, 16), chunk
64, wherever TMA can read x, B, C (and gy) in place (``tma.ssd_maps``),
the call runs the warp-specialised wgmma instance (``csrc/ssd_wgmma.cu``,
launched as ``ssd_fwd_wgmma`` and ``ssd_bwd_wgmma``); every other call
(fp32, chunk 32, (16, 16), operands TMA cannot read) ssd.cu's mma.sync
instance.  Every wrapper takes CUDA
tensors only and raises on anything else, including a (P, N) or chunk
the kernels are not built for; the CPU path never reaches this module (``kernels/ops.py`` routes
a CPU tensor to the plain versions in ``kernels/ref.py``).  Launches
are counted in ``build.LAUNCHES``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import autotune, tma
from repro_torch.kernels.build import check_tensors, current_stream, launch
from repro_torch.kernels.ref import SSD_CHUNK as CHUNK

#: (head dim P, state size N) pairs with a template instance in
#: csrc/ssd.cu: mamba2-780m, hymba-1.5b, the reduced configs
SHAPES = ((64, 128), (64, 16), (16, 16))
#: chunk lengths built for each of SHAPES (CHUNK, 64, is the autotuner's
#: heuristic; 128 does not fit the backward chunk phase, csrc/ssd.cu)
CHUNKS = (32, 64)


def resolve_chunk(x: torch.Tensor, B: torch.Tensor,
                  chunk: Optional[int] = None) -> int:
    """``chunk``, or the autotuner's for x [b, S, H, P], B [.., N]."""
    if chunk is None:
        chunk = autotune.ssd_config(autotune.backend_of(x.device), x.dtype,
                                    x.shape[1], x.shape[-1],
                                    B.shape[-1])["chunk"]
    return int(chunk)


def check_chunk(name: str, chunk: int) -> None:
    if chunk not in CHUNKS:
        raise ValueError(f"{name}: chunk {chunk} is not built (one of "
                         f"{CHUNKS})")


def _strides(t: torch.Tensor) -> Tuple[int, int, int]:
    return t.stride(0), t.stride(1), t.stride(2)


def _check(name: str, x, dt, A, B, C, *more) -> Tuple:
    """Validate the scan's operands (``more``: tensors shaped like x);
    return (code, b, S, H, P, N)."""
    code = check_tensors(name, x, B, C, *more)
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"{name}: x [b,S,H,P] and B/C [b,S,H,N] expected, "
                         f"got {tuple(x.shape)} {tuple(B.shape)}")
    b, S, H, P = x.shape
    N = B.shape[-1]
    if (B.shape != (b, S, H, N) or C.shape != B.shape
            or dt.shape != (b, S, H) or A.shape != (H,) or S == 0
            or any(t.shape != x.shape for t in more)):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} A {tuple(A.shape)} B "
                         f"{tuple(B.shape)} C {tuple(C.shape)} "
                         f"{[tuple(t.shape) for t in more]}")
    if (P, N) not in SHAPES:
        raise ValueError(f"{name}: (P, N) = {(P, N)} not built (one of "
                         f"{SHAPES})")
    for t in (dt, A):
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name}: dt and A must be fp32 on {x.device}, "
                             f"got {t.dtype} on {t.device}")
    if not A.is_contiguous():
        raise ValueError(f"{name}: A must be contiguous")
    for t in (x, B, C, *more):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dim must be dense "
                             f"(strides {t.stride()})")
    return code, b, S, H, P, N


def _check_states(name: str, like: torch.Tensor, *states: torch.Tensor
                  ) -> None:
    for t, shape in states:
        if (t.shape != shape or t.dtype != torch.float32
                or t.device != like.device or not t.is_contiguous()):
            raise ValueError(f"{name}: state must be contiguous {shape} fp32 "
                             f"on {like.device}, got {tuple(t.shape)} "
                             f"{t.dtype} {t.device}")


def wgmma_at(dtype: torch.dtype, P: int, N: int) -> bool:
    """Whether a call in ``dtype`` at (P, N), chunk 64, takes the wgmma
    instance where TMA can read its operands: bf16 at mamba2-780m's and
    hymba-1.5b's (P, N).  fp32 keeps ssd.cu's: its 3xTF32 wgmma instance
    was slower in the backward and no faster end to end (PERF.md)."""
    return dtype == torch.bfloat16 and (P, N) in tma.SSD_SHAPES


def instance(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             chunk: int, gy: Optional[torch.Tensor] = None
             ) -> Optional[Tuple[tma.Spec, int]]:
    """The tensor-map specs and B/C head flag of the wgmma instance for
    this call (``tma.ssd_maps``; with gy: the backward's), or None for
    ssd.cu's mma.sync instance: chunk ``tma.SSD_CHUNK`` where
    ``wgmma_at`` and TMA can read the operands in place."""
    if chunk != tma.SSD_CHUNK or not wgmma_at(x.dtype, x.shape[-1],
                                              B.shape[-1]):
        return None
    return tma.ssd_maps(x, B, C, gy)


def _specs(maps: tma.Spec):
    return (ctypes.c_longlong * len(maps))(*maps)


def ssd_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, chunk: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (y [b,S,H,P] in x's dtype, final state [b,H,P,N] fp32,
    cstates [b,H,nc,P,N] fp32)."""
    code, b, S, H, P, N = _check("ssd_fwd", x, dt, A, B, C)
    chunk = resolve_chunk(x, B, chunk)
    check_chunk("ssd_fwd", chunk)
    nc = -(-S // chunk)
    y = torch.empty((b, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    cstates = torch.empty((b, H, nc, P, N), dtype=torch.float32,
                          device=x.device)
    inst = instance(x, B, C, chunk)
    if inst is not None:
        launch("ssd_fwd_wgmma", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
               B.data_ptr(), C.data_ptr(), y.data_ptr(), state.data_ptr(),
               cstates.data_ptr(), b, S, H, N, *_strides(dt), inst[1],
               _specs(inst[0]), code, current_stream(x))
        return y, state, cstates
    launch("ssd_fwd", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
           B.data_ptr(), C.data_ptr(), y.data_ptr(), state.data_ptr(),
           cstates.data_ptr(), b, S, H, P, N, chunk, *_strides(x),
           *_strides(dt), *_strides(B), *_strides(C), code,
           current_stream(x))
    return y, state, cstates


def ssd_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, cstates: torch.Tensor,
            gy: torch.Tensor, gstate: torch.Tensor,
            chunk: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, dA, dB, dC) in the primals' dtypes from the cotangents
    gy (of y) and gstate (of the final state, fp32) and the forward's
    cstates, made at the same chunk."""
    code, b, S, H, P, N = _check("ssd_bwd", x, dt, A, B, C, gy)
    chunk = resolve_chunk(x, B, chunk)
    check_chunk("ssd_bwd", chunk)
    nc = -(-S // chunk)
    _check_states("ssd_bwd", x, (cstates, (b, H, nc, P, N)),
                  (gstate, (b, H, P, N)))
    dx = torch.empty((b, S, H, P), dtype=x.dtype, device=x.device)
    ddt = torch.empty((b, S, H), dtype=torch.float32, device=x.device)
    dB = torch.empty((b, S, H, N), dtype=B.dtype, device=x.device)
    dC = torch.empty((b, S, H, N), dtype=C.dtype, device=x.device)
    dA_part = torch.empty((b, H, nc), dtype=torch.float32, device=x.device)
    # the chunks' local state cotangents, then the carried ones (dS1)
    scratch = torch.empty((b, H, nc, P, N), dtype=torch.float32,
                          device=x.device)
    inst = instance(x, B, C, chunk, gy)
    if inst is not None:
        launch("ssd_bwd_wgmma", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
               B.data_ptr(), C.data_ptr(), cstates.data_ptr(),
               gy.data_ptr(), gstate.data_ptr(), dx.data_ptr(),
               ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(),
               dA_part.data_ptr(), scratch.data_ptr(), b, S, H, N,
               *_strides(dt), inst[1], _specs(inst[0]), code,
               current_stream(x))
        return dx, ddt, dA_part.sum((0, 2)), dB, dC
    launch("ssd_bwd", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
           B.data_ptr(), C.data_ptr(), cstates.data_ptr(), gy.data_ptr(),
           gstate.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dB.data_ptr(),
           dC.data_ptr(), dA_part.data_ptr(), scratch.data_ptr(), b, S, H, P,
           N, chunk,
           *_strides(x), *_strides(dt), *_strides(B), *_strides(C),
           *_strides(gy), code, current_stream(x))
    dA = dA_part.sum((0, 2))
    return dx, ddt, dA, dB, dC
