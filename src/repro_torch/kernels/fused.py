"""Fused stage epilogues on the card: wrappers around the CUDA kernels of
``csrc/fused.cu`` and their ``torch.autograd.Function``s.

  * ``AddRMSNorm``: residual-add + RMSNorm as one kernel returning both
    the new residual stream and the normed branch input; its backward
    is the second kernel (fp32 ``dw`` partial per row block, summed
    here, as ``repro/kernels/fused.py`` sums them outside its kernel).
  * ``MatmulBias``: one tiled GEMM with a bias epilogue over the
    concatenated QKV weight; its backward runs the SAME kernel for
    ``dx = g.W^T`` and ``dW = x^T.g``, with strides instead of
    transpose copies, and sums ``db`` in fp32.

Every wrapper takes CUDA tensors only and raises on anything else; the
CPU path never reaches this module (``kernels/ops.py`` routes a CPU
tensor to ``kernels/ref.py``).  Launches are counted in
``build.LAUNCHES``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import check_tensors, current_stream, launch

#: rows per block of the backward norm kernel: M / 8 blocks fill the
#: card at the main path's M = 1024 and keep the dw partials small
NORM_BWD_ROWS = 8


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
                    gh: torch.Tensor, eps: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (dres, dw): dres is the cotangent of both addends; dw is
    the fp32 sum of the per-block partials, cast to w's dtype."""
    code = check_tensors("add_rmsnorm_bwd", res, w, gres, gh)
    M, d = res.shape
    if gres.shape != (M, d) or gh.shape != (M, d) or w.shape != (d,):
        raise ValueError("add_rmsnorm_bwd: shape mismatch")
    res, w = res.contiguous(), w.contiguous()
    gres, gh = gres.contiguous(), gh.contiguous()
    blocks = -(-M // NORM_BWD_ROWS)
    dres = torch.empty_like(res)
    partials = torch.empty((blocks, d), dtype=torch.float32, device=res.device)
    launch("add_rmsnorm_bwd", res.data_ptr(), w.data_ptr(), gres.data_ptr(),
           gh.data_ptr(), dres.data_ptr(), partials.data_ptr(), M, d,
           NORM_BWD_ROWS, float(eps), code, current_stream(res))
    return dres, partials.sum(0).to(w.dtype)


def gemm_bias(a: torch.Tensor, b: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C = a.b (+ bias) with an fp32 accumulator, cast to a's dtype.
    a: [M, K], b: [K, N], any strides (a transposed view costs no copy);
    bias: [N] or None.  C is a new contiguous [M, N] tensor."""
    tensors = (a, b) if bias is None else (a, b, bias)
    code = check_tensors("gemm_bias", *tensors)
    (M, K), (K2, N) = a.shape, b.shape
    if K != K2 or (bias is not None and bias.shape != (N,)):
        raise ValueError(f"gemm_bias: shapes {a.shape} {b.shape} "
                         f"{None if bias is None else bias.shape}")
    if bias is not None:
        bias = bias.contiguous()
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    launch("gemm_bias", a.data_ptr(), b.data_ptr(),
           None if bias is None else bias.data_ptr(), c.data_ptr(),
           M, N, K, a.stride(0), a.stride(1), b.stride(0), b.stride(1),
           code, current_stream(a))
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
