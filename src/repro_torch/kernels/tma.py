"""Tensor maps of the wgmma kernels (``csrc/gemm_wgmma.cu``,
``csrc/flash_wgmma.cu``, ``csrc/flash_bwd_wgmma.cu``,
``csrc/ssd_wgmma.cu``), computed on the host.

A kernel reads an operand through a TMA tensor map that the C entry
point encodes (``csrc/hopper.cuh::encode_map``, libcuda's
``cuTensorMapEncodeTiled``: bf16, 128-byte swizzle, out-of-bounds
elements as 0) from a spec computed here: the dims (innermost first),
the strides in bytes of dims 1.., and the box the kernel copies.  The
rules a spec must keep (``cuTensorMapEncodeTiled``'s documentation):
the base 16-byte aligned; every dim in [1, 2^32]; every stride a
positive multiple of 16 below 2^40; every box dim in [1, 256]; the box's
inner extent a multiple of 16 bytes and, under the 128-byte swizzle, at
most 128.  ``spec`` returns None for a call that breaks one, and the
wrappers then take the mma.sync instances (``kernels/fused.py``,
``kernels/flash.py``, ``kernels/ssd.py``).  The SSD's rows shorter than
128 bytes (N 16's B and C) are one dense box a row, no swizzle.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

#: bytes of an element (bf16: the wgmma kernels' only dtype)
ITEMSIZE = 2
#: elements of the box's inner extent: one 128-byte swizzle row
INNER = 128 // ITEMSIZE
#: the rows and columns of C a GEMM block computes and its K slice
#: (gemm_wgmma.cu WBM, WBN, WBK)
GEMM_ROWS, GEMM_COLS, GEMM_BK = 128, 256, 64

Spec = Tuple[int, ...]


def spec(dims: Sequence[int], strides: Sequence[int], box: Sequence[int],
         addr: int) -> Optional[Spec]:
    """(dims..., strides..., box...) of a legal map, else None.  dims and
    box innermost first; strides in bytes, of dims 1.. (one fewer)."""
    dims, strides, box = tuple(dims), tuple(strides), tuple(box)
    if (addr % 16 or len(strides) != len(dims) - 1 or len(box) != len(dims)
            or not all(1 <= d <= 2 ** 32 for d in dims)
            or not all(0 < s < 2 ** 40 and s % 16 == 0 for s in strides)
            or not all(1 <= b <= 256 for b in box)
            or (box[0] * ITEMSIZE) % 16 or box[0] * ITEMSIZE > 128):
        return None
    return dims + strides + box


def gemm_maps(M: int, N: int, K: int, a_strides: Sequence[int],
              b_strides: Sequence[int], a_addr: int, b_addr: int
              ) -> Optional[Tuple[Spec, Spec]]:
    """The specs of A [M, K] and B [K, N] (strides in elements, as the
    [M, K] and [K, N] views) for ``gemm_bias_wgmma``, or None.  A K-major
    operand (its K stride 1) is one box of 64 K by the tile's rows (A) or
    columns (B); an M- or N-major one boxes of 64 of its stride-1 dim by
    64 K (the kernel issues the others at +64, +128, ...)."""
    sam, sak = a_strides
    sbk, sbn = b_strides
    if sak == 1:
        a = spec((K, M), (sam * ITEMSIZE,), (INNER, GEMM_ROWS), a_addr)
    elif sam == 1:
        a = spec((M, K), (sak * ITEMSIZE,), (INNER, GEMM_BK), a_addr)
    else:
        return None
    if sbk == 1 and sbn != 1:
        b = spec((K, N), (sbn * ITEMSIZE,), (INNER, GEMM_COLS), b_addr)
    elif sbn == 1:
        b = spec((N, K), (sbk * ITEMSIZE,), (INNER, GEMM_BK), b_addr)
    else:
        return None
    return None if a is None or b is None else (a, b)


#: head dims of the wgmma flash kernels and the kv rows of a stage of the
#: forward and dq (flash_wgmma.cu FwGeom::BK, flash_bwd_wgmma.cu
#: DqGeom::BK)
FLASH_KV_ROWS = {64: 128, 128: 64}


def flash_map(shape: Sequence[int], strides: Sequence[int], addr: int,
              rows: int) -> Optional[Spec]:
    """The spec of one attention operand [B, S, heads, D] (strides in
    elements, the head dim dense): dims (D, heads, S, B), a box of 64
    columns of one head's ``rows`` positions (the kernel issues one a 64
    columns of D)."""
    B, S, heads, D = shape
    if strides[3] != 1:
        return None
    return spec((D, heads, S, B),
                tuple(s * ITEMSIZE for s in (strides[2], strides[1],
                                             strides[0])),
                (INNER, 1, rows, 1), addr)


def flash_maps(q, k, v, tile: int) -> Optional[Spec]:
    """The three specs of q, k and v (tensors, or anything with
    ``shape``, ``stride()`` and ``data_ptr()``) for ``flash_fwd_wgmma``
    at q tile ``tile``, concatenated, or None where a head dim has no
    instance or a map is illegal."""
    rows = FLASH_KV_ROWS.get(q.shape[-1])
    if rows is None:
        return None
    return _flash_maps(_operands(q, k, v), (tile, rows, rows))


#: the query rows of dk/dv's stages in the wgmma backward
#: (flash_bwd_wgmma.cu DkvGeom::BQ); dq's kv stages are the forward's
#: ``FLASH_KV_ROWS``
FLASH_DKDV_Q_ROWS = 64


def flash_bwd_maps(q, k, v, g, kernel: str, tile: int) -> Optional[Spec]:
    """The four specs of q, k, v and dO for ``flash_bwd_dq_wgmma``
    (``kernel`` "dq": q and dO boxes of ``tile`` rows, k and v of
    ``FLASH_KV_ROWS[D]``) or ``flash_bwd_dkdv_wgmma`` ("dkdv": k and v
    boxes of ``tile`` rows, q and dO of ``FLASH_DKDV_Q_ROWS``),
    concatenated, or None where a head dim has no instance or a map is
    illegal."""
    rows = FLASH_KV_ROWS.get(q.shape[-1])
    if rows is None:
        return None
    q_rows, kv_rows = ((tile, rows) if kernel == "dq"
                       else (FLASH_DKDV_Q_ROWS, tile))
    return _flash_maps(_operands(q, k, v, g),
                       (q_rows, kv_rows, kv_rows, q_rows))


def _operands(*tensors):
    return tuple((tuple(t.shape), tuple(t.stride()), t.data_ptr() % 16)
                 for t in tensors)


@functools.lru_cache(maxsize=1024)
def _flash_maps(operands, rows) -> Optional[Spec]:
    # cached by shapes, strides, the bases' alignment and the boxes' rows
    # (the specs hold no address): the wrapper's host time a call
    out = ()
    for (shape, strides, misalign), r in zip(operands, rows):
        s = flash_map(shape, strides, misalign, r)
        if s is None:
            return None
        out += s
    return out


#: (P, N) and chunk of the SSD wgmma instances (csrc/ssd_wgmma.cu):
#: mamba2-780m's and hymba-1.5b's heads, one chunk a 64-row wgmma tile
SSD_SHAPES = ((64, 128), (64, 16))
SSD_CHUNK = 64


def ssd_map(shape: Sequence[int], strides: Sequence[int], addr: int
            ) -> Optional[Spec]:
    """The spec of one bf16 SSD operand [b, S, heads, D] (strides in
    elements, the last dim dense): dims (D, heads, S, b), a box of one
    head's ``SSD_CHUNK`` rows by 128 bytes of D, or all of D where a row
    is shorter (the kernel issues one box a 128 bytes).  A head stride of
    0 (B and C one group expanded over the heads, as the Mamba2 block
    hands them over) maps the group view: one head, every head of the
    kernel reading head coordinate 0."""
    b, S, heads, D = shape
    if strides[3] != 1:
        return None
    hstride = strides[2]
    if hstride == 0:
        heads, hstride = 1, strides[1]
    return spec((D, heads, S, b),
                tuple(s * ITEMSIZE for s in (hstride, strides[1],
                                             strides[0])),
                (min(D, INNER), 1, SSD_CHUNK, 1), addr)


def ssd_maps(x, B, C, gy=None) -> Optional[Tuple[Spec, int]]:
    """(the specs of bf16 x, B, C (and gy) concatenated, bc_head) for
    ``ssd_fwd_wgmma`` (``ssd_bwd_wgmma`` with gy), or None where (P, N)
    has no instance, a map is illegal, or B and C are not both per head
    or both one group over the heads.  bc_head is 1 for B and C per head,
    0 for one group (head stride 0).  Tensors, or anything with
    ``shape``, ``stride()`` and ``data_ptr()``."""
    if (x.shape[-1], B.shape[-1]) not in SSD_SHAPES:
        return None
    if (B.stride(2) == 0) != (C.stride(2) == 0):
        return None
    tensors = (x, B, C) + ((gy,) if gy is not None else ())
    got = _ssd_maps(_operands(*tensors))
    return None if got is None else (got, int(B.stride(2) != 0))


@functools.lru_cache(maxsize=1024)
def _ssd_maps(operands) -> Optional[Spec]:
    out = ()
    for shape, strides, misalign in operands:
        s = ssd_map(shape, strides, misalign)
        if s is None:
            return None
        out += s
    return out
