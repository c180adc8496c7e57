"""Fused stage epilogues on the card: wrappers around the CUDA kernels of
``csrc/fused.cu`` and their ``torch.autograd.Function``s.

  * ``AddRMSNorm``: residual-add + RMSNorm as one kernel returning both
    the new residual stream and the normed branch input; its backward
    is the second kernel (one pass over each row held in registers, an
    fp32 ``dw`` partial row per block) followed by a kernel that sums
    the partial rows in a fixed order.  ``norm_bwd_config`` picks the
    copy width and the registers a thread holds, and takes the rows per
    block from the autotuner (a measured entry, else ``norm_bwd_rows``).
  * ``MatmulBias``: one tiled GEMM with a bias epilogue over the
    concatenated QKV weight; its backward runs the SAME kernel for
    ``dx = g.W^T`` and ``dW = x^T.g``, with strides instead of
    transpose copies, and sums ``db`` in fp32.  ``gemm_config`` picks
    each call's operand layouts and copy width from the strides and
    addresses, and its tile and split over K through the autotuner
    (``kernels/autotune.py``: a measured table entry, else the planning
    model ``gemm_plan``; never a clock at run time).  In bf16, wherever
    TMA can read both operands (``tma.gemm_maps``), the call runs the
    warp-specialised wgmma instance (``csrc/gemm_wgmma.cu``, launched as
    ``gemm_bias_wgmma``), else fused.cu's mma.sync instance with
    element copies; fp32 always runs fused.cu's.

Every wrapper takes CUDA tensors only and raises on anything else; the
CPU path never reaches this module (``kernels/ops.py`` routes a CPU
tensor to ``kernels/ref.py``).  Launches are counted in
``build.LAUNCHES``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import ctypes

import torch

from repro_torch.kernels import autotune, tma
from repro_torch.kernels.build import check_tensors, current_stream, launch

_DTYPE_OF_SIZE = {4: "float32", 2: "bfloat16"}

# ----------------------------------------------------------------------
# GEMM launch configuration (functions of shapes, strides, addresses and
# the autotuner's tables: the same call always gets the same
# configuration)
# ----------------------------------------------------------------------
#: SMs of the H100 SXM, over which a grid's blocks are spread in waves
GEMM_SMS = 132
#: K slice of the kernel's shared-memory ring (csrc/fused.cu GBK); a
#: split over K covers a whole number of slices
GEMM_BK = 32
#: built tiles (bm, bn) -> (blocks resident per SM, relative rate of an
#: SM on that tile): 128 x 128 runs one 8-warp block per SM, 64 x 64 three
#: 4-warp blocks, each warp with a smaller tile and so more shared loads
#: per product; 128 x 256 is the bf16 wgmma instance's one tile
#: (csrc/gemm_wgmma.cu, three warpgroups), the planning model's unit rate
GEMM_TILES = {(128, 128): (1, 1.0), (64, 64): (3, 0.6), (128, 256): (1, 1.0)}
#: fused.cu's tiles with 16-byte copies (fp32; bf16 calls with 16-byte
#: rows run the wgmma instance); its element-copy instance, for rows TMA
#: cannot read, takes 64 x 64 in both dtypes
MMA_TILES = ((128, 128), (64, 64))
#: the wgmma instance's tile and K slice: a split covers whole slices
WGMMA_TILE = (tma.GEMM_ROWS, tma.GEMM_COLS)
WGMMA_BK = tma.GEMM_BK
#: assumed multiply-adds per second of one SM on the 128 x 128 tile,
#: 3xTF32 (the planning model's unit; only ratios matter)
_SM_MACS = 4.2e11
_HBM_BYTES_PER_S = 3.35e12
_LAUNCH_S = 5e-6
_MAX_SPLITS = 4


@dataclasses.dataclass(frozen=True)
class GemmConfig:
    """One launch of ``gemm_bias_kernel``: a bm x bn tile, K split into
    ``splits`` ranges of ``kchunk`` (a second kernel sums the fp32
    partials in order), the operands' shared layouts, and 16-byte
    (``vec``) or element copies."""
    bm: int
    bn: int
    splits: int
    kchunk: int
    a_kmajor: bool          # A's K stride is 1 (row-major A)
    b_kmajor: bool          # B's K stride is 1 (B read transposed)
    vec: bool
    #: the wgmma instance's tensor-map specs of A and B, or None (the
    #: mma.sync instance)
    maps: Optional[Tuple[tma.Spec, tma.Spec]] = None


def gemm_kchunk(K: int, splits: int, bk: int = GEMM_BK) -> int:
    """K rows per split: whole slices of ``bk`` (``GEMM_BK``, or
    ``WGMMA_BK`` for the wgmma instance)."""
    per_split = -(-K // splits)
    return -(-per_split // bk) * bk


def _vec_ok(unit: int, lead: int, addr: int, itemsize: int) -> bool:
    """Whether an operand takes 16-byte copies: its stride-1 dim (stride
    ``unit``) has stride 1, its other stride ``lead`` is a multiple of 16
    bytes, and its base address is 16-byte aligned."""
    return unit == 1 and (lead * itemsize) % 16 == 0 and addr % 16 == 0


def _gemm_seconds(M: int, N: int, K: int, bm: int, bn: int,
                  splits: int, bk: int = GEMM_BK) -> float:
    """Planning model: waves of resident blocks times one block's
    multiply-adds over its SM's share of the rate, plus the second
    pass's bytes and launch when split."""
    occ, rate = GEMM_TILES[(bm, bn)]
    jobs = -(-M // bm) * -(-N // bn) * splits
    waves = -(-jobs // (GEMM_SMS * occ))
    block_s = occ * bm * bn * gemm_kchunk(K, splits, bk) / (rate * _SM_MACS)
    reduce_s = (0.0 if splits == 1 else
                (splits + 1) * M * N * 4 / _HBM_BYTES_PER_S + _LAUNCH_S)
    return waves * block_s + reduce_s


@functools.lru_cache(maxsize=None)
def gemm_candidates(K: int, itemsize: int) -> Tuple[Tuple[int, int, int], ...]:
    """The legal (bm, bn, splits) of a call with 16-byte copies: the
    built tiles of its instance (fp32: fused.cu's ``MMA_TILES``; bf16:
    the wgmma instance's ``WGMMA_TILE``) and 1-4 splits that each cover
    a nonempty range of K (the element-copy instance takes 64 x 64 and
    one split alone)."""
    wgmma = itemsize == 2
    bk = WGMMA_BK if wgmma else GEMM_BK
    out = []
    for bm, bn in ([WGMMA_TILE] if wgmma else MMA_TILES):
        for splits in range(1, _MAX_SPLITS + 1):
            if gemm_kchunk(K, splits, bk) * (splits - 1) >= K:
                break
            out.append((bm, bn, splits))
    return tuple(out)


def gemm_plan(M: int, N: int, K: int, itemsize: int) -> Tuple[int, int, int]:
    """The planning model's (bm, bn, splits): the candidate that
    minimises ``_gemm_seconds``; ties go to the larger tile and the fewer
    splits.  The autotuner's heuristic for a key with no measured
    entry."""
    bk = WGMMA_BK if itemsize == 2 else GEMM_BK
    return min(gemm_candidates(K, itemsize),
               key=lambda c: (_gemm_seconds(M, N, K, *c, bk), -c[0] * c[1],
                              c[2]))


def gemm_config(M: int, N: int, K: int, a_strides: Sequence[int],
                b_strides: Sequence[int], a_addr: int, b_addr: int,
                itemsize: int, backend: Optional[str] = None,
                choice: Optional[Tuple[int, int, int]] = None) -> GemmConfig:
    """The launch of C[M, N] = A[M, K].B[K, N]: A and B's strides (as the
    [M, K] and [K, N] views), base addresses and element size.

    Layouts: A is K-major when its K stride is 1 (else M-major), B when
    its K stride is 1 and its N stride is not (else N-major).  Copies
    are 16-byte where both operands allow it (``_vec_ok``; in bf16 where
    TMA can read both, ``tma.gemm_maps``, and the call then runs the
    wgmma instance), else one element each (fused.cu's 64 x 64 tile, no
    split).  With 16-byte copies the (tile, split) is ``choice`` where
    given, else the autotuner's entry for ``backend``
    (``autotune.gemm_config_of``), else, with no backend, the planning
    model ``gemm_plan``; one that is not among ``gemm_candidates``
    raises."""
    sam, sak = a_strides
    sbk, sbn = b_strides
    a_kmajor = sak == 1
    b_kmajor = sbk == 1 and sbn != 1
    vec = (_vec_ok(sak if a_kmajor else sam, sam if a_kmajor else sak,
                   a_addr, itemsize)
           and _vec_ok(sbk if b_kmajor else sbn, sbn if b_kmajor else sbk,
                       b_addr, itemsize))
    maps = (tma.gemm_maps(M, N, K, a_strides, b_strides, a_addr, b_addr)
            if itemsize == 2 and vec else None)
    vec = vec and (itemsize == 4 or maps is not None)
    legal = gemm_candidates(K, itemsize) if vec else ((64, 64, 1),)
    if choice is None and not vec:
        choice = (64, 64, 1)
    elif choice is None and backend is None:
        choice = gemm_plan(M, N, K, itemsize)
    elif choice is None:
        cfg = autotune.gemm_config_of(backend, _DTYPE_OF_SIZE[itemsize], M, N,
                                      K, autotune.gemm_layout(a_kmajor,
                                                              b_kmajor))
        choice = (cfg["block_rows"], cfg["block_cols"], cfg["splits"])
    choice = tuple(int(c) for c in choice)
    if choice not in legal:
        raise ValueError(f"gemm_bias: (tile, split) {choice} is not built "
                         f"for this call (one of {legal})")
    bm, bn, splits = choice
    bk = GEMM_BK if maps is None else WGMMA_BK
    return GemmConfig(bm, bn, splits, gemm_kchunk(K, splits, bk), a_kmajor,
                      b_kmajor, vec, maps)


# ----------------------------------------------------------------------
# Backward norm launch configuration (a pure function of the shape, the
# element size and the addresses)
# ----------------------------------------------------------------------
#: elements of a row that one thread of the backward norm holds in
#: registers (CH chunks of E: 2 x 4 fp32, 1 x 8 bf16 or 8 x 1), twice
#: as many in 16-byte chunks where a row would take more than
#: NORM_MAX_WARPS warps (csrc/fused.cu kNormElems)
NORM_ELEMS = 8
#: warps that share a row at most (csrc/fused.cu kNormMaxWarps): rows
#: wider than 16 x 32 x 16 = 8192 take the looped variant
NORM_MAX_WARPS = 16
#: warps per SM the backward norm's grid aims at: four 4-warp blocks
#: (tools/norm_sweep.py times other choices of these three)
NORM_WARPS_PER_SM = 16


@dataclasses.dataclass(frozen=True)
class NormBwdConfig:
    """One launch of ``add_rmsnorm_bwd_kernel``: ``blocks`` blocks of
    ``rows_per_block`` rows each (the last may have fewer), each block
    running ``rows_per_round`` rows side by side with ``warps_per_row``
    warps a row; a thread holds ``chunks`` chunks of 16 bytes (``vec``)
    or of one element, ``chunks = 0`` being the looped variant.  The
    kernel writes one fp32 dw partial row per block."""
    rows_per_block: int
    rows_per_round: int
    warps_per_row: int
    blocks: int
    chunks: int
    vec: bool


def _norm_row_warps(d: int) -> Tuple[int, int]:
    """(R, G): G warps hold a row of d elements at ``NORM_ELEMS`` a
    thread, or at twice that where it would take more than
    ``NORM_MAX_WARPS`` (which the looped variant takes, beyond); R rows
    run side by side in 4-warp blocks where G <= 2."""
    G = -(-d // (32 * NORM_ELEMS))
    if G > NORM_MAX_WARPS:
        G = min(-(-d // (64 * NORM_ELEMS)), NORM_MAX_WARPS)
    return max(1, 4 // G), G


def norm_bwd_rows(M: int, d: int, warps_per_sm: Optional[int] = None
                  ) -> Tuple[int, int, int, int]:
    """(rows_per_block, rows_per_round R, warps_per_row G, blocks): the
    backward norm's row partition, a function of (M, d) alone (the
    autotuner's heuristic).  The rows of a block are whole rounds of R
    (``_norm_row_warps``), as few as let the grid reach ``warps_per_sm``
    (default ``NORM_WARPS_PER_SM``) warps (rounded up to whole blocks) on
    each of ``GEMM_SMS`` SMs, so one wave of blocks covers M and the
    partial rows stay few."""
    R, G = _norm_row_warps(d)
    per_sm = -(-(warps_per_sm or NORM_WARPS_PER_SM) // (R * G))
    rows = R * -(-M // (R * GEMM_SMS * per_sm))
    return rows, R, G, -(-M // rows)


#: warps per SM whose partitions the autotuner times (tune_norm)
NORM_TUNE_WARPS = (4, 8, 16, 32, 64)


def norm_rows_candidates(M: int, d: int) -> List[int]:
    """The rows per block ``tune_norm`` times: ``norm_bwd_rows``'s at
    each of ``NORM_TUNE_WARPS`` warps per SM, without repeats."""
    return sorted({norm_bwd_rows(M, d, w)[0] for w in NORM_TUNE_WARPS})


def norm_bwd_config(M: int, d: int, itemsize: int, addrs: Sequence[int],
                    backend: Optional[str] = None,
                    rows_per_block: Optional[int] = None) -> NormBwdConfig:
    """The backward norm's launch for [M, d] rows of ``itemsize``-byte
    elements at base addresses ``addrs`` (res, w, gres, gh, dres).  Rows
    per block: ``rows_per_block`` where given, else the autotuner's
    entry for ``backend`` (``autotune.norm_config``), else, with no
    backend, ``norm_bwd_rows``; it must be a positive multiple of the
    rows a round runs.  16-byte copies (E = 16 / itemsize elements)
    where d is a multiple of E and every base is 16-byte aligned, else
    one element each; a thread holds ``chunks`` = the power of two of
    E-chunks that covers its share of the row (at most 2 ``NORM_ELEMS``
    elements in 16-byte chunks, ``NORM_ELEMS`` single ones), or 0
    (looped) where the row is wider than ``NORM_MAX_WARPS`` warps hold
    so."""
    if rows_per_block is None and backend is None:
        rows_per_block = norm_bwd_rows(M, d)[0]
    elif rows_per_block is None:
        rows_per_block = autotune.norm_config(
            backend, _DTYPE_OF_SIZE[itemsize], M, d)["rows_per_block"]
    return _norm_bwd_config(M, d, itemsize, all(a % 16 == 0 for a in addrs),
                            int(rows_per_block))


@functools.lru_cache(maxsize=None)
def _norm_bwd_config(M: int, d: int, itemsize: int, aligned: bool,
                     rows: int) -> NormBwdConfig:
    # cached: the wrapper's host time is the call's time at small M
    R, G = _norm_row_warps(d)
    if rows <= 0 or rows % R:
        raise ValueError(f"add_rmsnorm_bwd: {rows} rows per block is not a "
                         f"positive multiple of the {R} rows a round runs")
    blocks = -(-M // rows)
    E = 16 // itemsize
    vec = d % E == 0 and aligned
    E = E if vec else 1
    if d > (64 if vec else 32) * NORM_ELEMS * NORM_MAX_WARPS:
        chunks = 0
    else:
        chunks = 1
        while chunks * E * 32 * G < d:
            chunks *= 2
    return NormBwdConfig(rows, R, G, blocks, chunks, vec)


# ----------------------------------------------------------------------
# Raw kernel wrappers
# ----------------------------------------------------------------------
def add_rmsnorm_fwd(x: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                    eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, r: [M, d] contiguous; w: [d].  Returns (res, h)."""
    code = check_tensors("add_rmsnorm_fwd", x, r, w)
    M, d = x.shape
    if r.shape != (M, d) or w.shape != (d,):
        raise ValueError(f"add_rmsnorm_fwd: shapes {x.shape} {r.shape} {w.shape}")
    x, r, w = x.contiguous(), r.contiguous(), w.contiguous()
    res, h = torch.empty_like(x), torch.empty_like(x)
    launch("add_rmsnorm_fwd", x.data_ptr(), r.data_ptr(), w.data_ptr(),
           res.data_ptr(), h.data_ptr(), M, d, float(eps), code,
           current_stream(x))
    return res, h


def add_rmsnorm_bwd(res: torch.Tensor, w: torch.Tensor, gres: torch.Tensor,
                    gh: torch.Tensor, eps: float,
                    rows_per_block: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (dres, dw): dres is the cotangent of both addends; dw is
    the fp32 sum over rows, cast to w's dtype (the row kernel's partial
    rows summed by the dw kernel, in one launch).  ``rows_per_block``
    defaults to the autotuner's (``norm_bwd_config``)."""
    code = check_tensors("add_rmsnorm_bwd", res, w, gres, gh)
    M, d = res.shape
    if gres.shape != (M, d) or gh.shape != (M, d) or w.shape != (d,):
        raise ValueError("add_rmsnorm_bwd: shape mismatch")
    res, w = res.contiguous(), w.contiguous()
    gres, gh = gres.contiguous(), gh.contiguous()
    dres, dw = torch.empty_like(res), torch.empty_like(w)
    cfg = norm_bwd_config(M, d, res.element_size(),
                          [t.data_ptr() for t in (res, w, gres, gh, dres)],
                          autotune.backend_of(res.device), rows_per_block)
    partials = torch.empty((cfg.blocks, d), dtype=torch.float32,
                           device=res.device)
    launch("add_rmsnorm_bwd", res.data_ptr(), w.data_ptr(), gres.data_ptr(),
           gh.data_ptr(), dres.data_ptr(), dw.data_ptr(), partials.data_ptr(),
           M, d, cfg.rows_per_block, cfg.rows_per_round, cfg.warps_per_row,
           cfg.chunks, int(cfg.vec), float(eps), code, current_stream(res))
    return dres, dw


def gemm_bias(a: torch.Tensor, b: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              choice: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """C = a.b (+ bias) with an fp32 accumulator, cast to a's dtype.
    a: [M, K], b: [K, N], any strides (a transposed view costs no copy);
    bias: [N] or None.  C is a new contiguous [M, N] tensor.  ``choice``
    (bm, bn, splits) defaults to the autotuner's (``gemm_config``, which
    also picks the instance from the operands)."""
    tensors = (a, b) if bias is None else (a, b, bias)
    code = check_tensors("gemm_bias", *tensors)
    (M, K), (K2, N) = a.shape, b.shape
    if K != K2 or (bias is not None and bias.shape != (N,)):
        raise ValueError(f"gemm_bias: shapes {a.shape} {b.shape} "
                         f"{None if bias is None else bias.shape}")
    if bias is not None:
        bias = bias.contiguous()
    cfg = gemm_config(M, N, K, a.stride(), b.stride(), a.data_ptr(),
                      b.data_ptr(), a.element_size(),
                      autotune.backend_of(a.device), choice)
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    ws = (torch.empty((cfg.splits, M, N), dtype=torch.float32,
                      device=a.device) if cfg.splits > 1 else None)
    ptrs = (a.data_ptr(), b.data_ptr(),
            None if bias is None else bias.data_ptr(), c.data_ptr(),
            None if ws is None else ws.data_ptr())
    if cfg.maps is not None:
        a_map, b_map = ((ctypes.c_longlong * len(m))(*m) for m in cfg.maps)
        launch("gemm_bias_wgmma", *ptrs, M, N, K, cfg.splits, cfg.kchunk,
               int(cfg.a_kmajor), int(cfg.b_kmajor), a_map, b_map,
               current_stream(a))
        return c
    launch("gemm_bias", *ptrs, M, N, K, a.stride(0), a.stride(1), b.stride(0),
           b.stride(1), cfg.bm, cfg.bn, cfg.splits, cfg.kchunk,
           int(cfg.a_kmajor), int(cfg.b_kmajor), int(cfg.vec), code,
           current_stream(a))
    return c


# ----------------------------------------------------------------------
# Autograd Functions
# ----------------------------------------------------------------------
class AddRMSNorm(torch.autograd.Function):
    """(res, h) = (x + r, rms_norm(w, x + r)) on [M, d] CUDA tensors."""

    @staticmethod
    def forward(ctx, x, r, w, eps: float):
        res, h = add_rmsnorm_fwd(x, r, w, eps)
        ctx.save_for_backward(res, w)
        ctx.eps = eps
        return res, h

    @staticmethod
    def backward(ctx, gres, gh):
        res, w = ctx.saved_tensors
        dres, dw = add_rmsnorm_bwd(res, w, gres, gh, ctx.eps)
        # res = x + r: both addends receive the full residual cotangent
        return dres, dres, dw, None


class MatmulBias(torch.autograd.Function):
    """y = x.W + b on [M, K] x [K, N] CUDA tensors, forward and backward
    through the one GEMM kernel."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        return gemm_bias(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = gemm_bias(g, w.t())            # [M, N] . [N, K]
        dw = gemm_bias(x.t(), g)            # [K, M] . [M, N]
        db = g.float().sum(0).to(g.dtype) if ctx.has_bias else None
        return dx, dw, db
