"""The GEMM kernel's launch configuration and its arithmetic, on the CPU.

``kernels/fused.py::gemm_config`` picks each call's tile, split over K
and copy width as a pure function of shapes, strides and addresses;
``_blocks`` mirrors the kernel's index arithmetic.  The tests hold
that the configuration is deterministic, that the blocks cover every
output element once per K range with the ranges partitioning K, and that
16-byte copies are taken exactly where alignment allows them.

The arithmetic test emulates the kernel's fp32 product in numpy: the
3xTF32 split (x = big + small, big rounded to TF32 to nearest with ties
away from zero, as cvt.rna, and small = x - big truncated to TF32, as the
tensor core reads it), each mma step of 8 products added to its
accumulator with round-toward-zero (the accumulation the card showed,
tools/mma_rounding.py), and the accumulator promoted into an ordinary
fp32 sum every 32 k.  That must hold chip_smoke.py's fp32 GEMM
tolerance at the dW product's K = 4096; the same emulation without the
small terms (1xTF32) must fail it, so the tolerance would catch a kernel
that drops them."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import fused

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
GEMM_SHAPES = dict(CS.CARD_SHAPES["gemm_bias"])      # label -> (M, K, N)


def _blocks(cfg, M, N, K):
    """The kernel's grid as (m0, m1, n0, n1, k0, k1) per block: the output
    rows, columns and K range each block sums, by the index arithmetic of
    csrc/fused.cu's gemm_bias_kernel (grid (N tiles, M tiles, splits),
    split z over k in [z * kchunk, min(K, (z + 1) * kchunk)))."""
    out = []
    for z in range(cfg.splits):
        k0, k1 = z * cfg.kchunk, min(K, (z + 1) * cfg.kchunk)
        for by in range(-(-M // cfg.bm)):
            for bx in range(-(-N // cfg.bn)):
                out.append((by * cfg.bm, min(M, (by + 1) * cfg.bm),
                            bx * cfg.bn, min(N, (bx + 1) * cfg.bn), k0, k1))
    return out


def _layout(shape, layout):
    """(M, N, K, A strides, B strides) of the product chip_smoke.py's
    make_inputs builds for ``layout`` from the forward's (M, K, N):
    fwd x.W, dx g.W^T (W read transposed), dW x^T.g (x read transposed),
    all on contiguous tensors."""
    M, K, N = shape
    if layout == "fwd":
        return M, N, K, (K, 1), (N, 1)
    if layout == "dx":
        return M, K, N, (N, 1), (1, N)
    return K, N, M, (1, K), (N, 1)


@pytest.mark.parametrize("itemsize", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("layout", ["fwd", "dx", "dW"])
@pytest.mark.parametrize("label", ["flash", "naive", "ragged"])
def test_gemm_config_is_deterministic_and_covers_each_output_once(
        label, layout, itemsize):
    M, N, K, sa, sb = _layout(GEMM_SHAPES[label], layout)
    cfg = fused.gemm_config(M, N, K, sa, sb, 256, 512, itemsize)
    assert cfg == fused.gemm_config(M, N, K, sa, sb, 256, 512, itemsize)
    assert (cfg.bm, cfg.bn) in fused.GEMM_TILES
    # bf16: the wgmma instance's tile where TMA reads both operands
    assert itemsize == 4 or (cfg.bm, cfg.bn) == (
        fused.WGMMA_TILE if cfg.maps else (64, 64))
    assert cfg.kchunk % (fused.WGMMA_BK if cfg.maps else fused.GEMM_BK) == 0
    blocks = _blocks(cfg, M, N, K)
    ranges = sorted({(k0, k1) for *_, k0, k1 in blocks})
    assert len(ranges) == cfg.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(k0 < k1 for k0, k1 in ranges)
    for k_range in ranges:
        cover = np.zeros((M, N), dtype=np.uint8)
        for m0, m1, n0, n1, *kr in blocks:
            if tuple(kr) == k_range:
                assert m1 - m0 <= cfg.bm and n1 - n0 <= cfg.bn
                cover[m0:m1, n0:n1] += 1
        assert (cover == 1).all(), (label, layout, k_range)


def test_gemm_config_at_the_flash_path():
    """The flash path's three products take 16-byte copies and the
    128 x 128 tile; the dW product (192 tiles at 1.45 waves on 132 SMs)
    splits K = 4096 in two."""
    cfgs = {layout: fused.gemm_config(*_layout(GEMM_SHAPES["flash"], layout),
                                      0, 0, 4)
            for layout in ("fwd", "dx", "dW")}
    assert all(c.vec and (c.bm, c.bn) == (128, 128) for c in cfgs.values())
    assert (cfgs["fwd"].a_kmajor, cfgs["fwd"].b_kmajor) == (True, False)
    assert (cfgs["dx"].a_kmajor, cfgs["dx"].b_kmajor) == (True, True)
    assert (cfgs["dW"].a_kmajor, cfgs["dW"].b_kmajor) == (False, False)
    assert cfgs["fwd"].splits == cfgs["dx"].splits == 1
    assert cfgs["dW"].splits == 2


# (A strides, B strides, A address, B address, itemsize, 16-byte copies)
_ALIGN_CASES = [
    ((1024, 1), (3072, 1), 0, 0, 4, True),       # the flash path's forward
    ((999, 1), (3000, 1), 0, 0, 4, False),       # ragged rows of 999 floats
    ((1000, 1), (3000, 1), 4, 0, 4, False),      # A's base 4 bytes off
    ((1000, 1), (3000, 1), 0, 32, 4, True),      # 16-byte aligned bases
    ((1, 999), (3000, 1), 0, 0, 4, False),       # x^T of rows of 999
    ((1, 1000), (3000, 1), 0, 0, 4, True),       # x^T of rows of 1000
    ((3000, 1), (1, 999), 0, 0, 4, False),       # W^T of rows of 999
    ((3000, 1), (1, 1000), 0, 0, 4, True),
    ((1004, 1), (3000, 1), 0, 0, 2, False),      # bf16: 2008 bytes a row
    ((1000, 1), (3000, 1), 0, 0, 2, True),       # bf16: 2000 bytes a row
    ((2000, 2), (3000, 1), 0, 0, 4, False),      # no stride-1 dim
]


@pytest.mark.parametrize("sa,sb,aa,ab,itemsize,vec", _ALIGN_CASES)
def test_gemm_takes_element_copies_exactly_where_alignment_requires(
        sa, sb, aa, ab, itemsize, vec):
    cfg = fused.gemm_config(1000, 3000, 1000, sa, sb, aa, ab, itemsize)
    assert cfg.vec is vec
    if not vec:      # the element-copy instance: one tile, no split
        assert (cfg.bm, cfg.bn, cfg.splits) == (64, 64, 1)


# ----------------------------------------------------------------------
# The kernel's fp32 arithmetic, emulated
# ----------------------------------------------------------------------
def _tf32_rna(x):
    """Round fp32 to TF32 (10 mantissa bits), ties away from zero."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _tf32_trunc(x):
    """fp32 -> TF32 by dropping the 13 low mantissa bits."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _rz32(x):
    """float64 -> float32 rounded toward zero."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _emulated_gemm(a, b, small_terms=True, step=8, promote=32):
    """C = a.b as the kernel computes it: per mma step of ``step`` k the
    products small.big, big.small, big.big (TF32 operands, exact
    products) are each summed into the mma accumulator with
    round-toward-zero; every ``promote`` k the accumulator is added into
    an fp32 sum (round to nearest) and zeroed."""
    ab, bb = _tf32_rna(a), _tf32_rna(b)
    parts = [(ab, bb)]
    if small_terms:
        as_, bs = _tf32_trunc(a - ab), _tf32_trunc(b - bb)
        parts = [(as_, bb), (ab, bs), (ab, bb)]
    M, K = a.shape
    acc = np.zeros((M, b.shape[1]), np.float32)
    for k0 in range(0, K, promote):
        part = np.zeros_like(acc)
        for k in range(k0, min(k0 + promote, K), step):
            for x, y in parts:
                s = x[:, k:k + step].astype(np.float64) @ y[k:k + step].astype(
                    np.float64)
                part = _rz32(part.astype(np.float64) + s)
        acc = acc + part
    return acc


@pytest.mark.parametrize("small_terms", [True, False],
                         ids=["3xtf32-holds", "1xtf32-fails"])
def test_emulated_kernel_arithmetic_against_the_fp32_tolerance(small_terms):
    """The dW product's operands (x^T and an unscaled gradient, as
    chip_smoke.py's make_inputs builds them) at K = 4096, held to
    TOL_FP32["gemm_bias"] against a plain fp32 product."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((48, 4096)).astype(np.float32)
    b = rng.standard_normal((4096, 48)).astype(np.float32)
    plain = a @ b
    got = _emulated_gemm(a, b, small_terms=small_terms)
    (tol,) = CS.TOL_FP32["gemm_bias"]
    cond = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    limit = tol["atol"] + tol["rtol"] * np.abs(plain) + tol["ctol"] * cond
    worst = float((np.abs(got.astype(np.float64) - plain) / limit).max())
    if small_terms:
        assert worst < 0.25, worst
    else:
        assert worst > 1.0, worst


# ----------------------------------------------------------------------
# The wgmma instance's bf16 arithmetic, emulated
# ----------------------------------------------------------------------
def _bf16(x):
    """fp32 -> bf16 (round to nearest even), back as fp32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _emulated_wgmma_gemm(a, b, promote=None):
    """C = a.b as csrc/gemm_wgmma.cu computes it from bf16 operands, in
    fp32 before its final rounding: per k16 step the 16 products summed
    exactly and rounded toward zero into the wgmma accumulator
    (tools/mma_rounding.py on the H100: wgmma's bf16 accumulator rounds
    toward zero, a k step's products are summed exactly and each step is
    rounded in on its own), over the whole K; with ``promote`` the
    accumulator is instead zeroed and added into an fp32 sum every
    ``promote`` k, the design the kernel does not take."""
    return _emulated_gemm(a, b, small_terms=False, step=16,
                          promote=promote or a.shape[1])


def test_emulated_wgmma_arithmetic_against_the_bf16_tolerance():
    """The dW product's operands at phase 20's K = 8192 (x^T and an
    unscaled gradient, bf16 values), held to TOL_BF16["gemm_bias"]
    against the plain product (fp32 sums, one rounding to bf16: the two
    may round to neighbouring bf16 values).  The kernel's order, the
    whole K in the truncating accumulator, holds it; promoting every 64
    k would be closer to the exact product, but the tolerance does not
    need it, so the kernel spends neither the wait on every slice nor
    the second accumulator's registers."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(0)
    a = _bf16(rng.standard_normal((32, 8192)))
    b = _bf16(rng.standard_normal((8192, 32)))
    exact = a.astype(np.float64) @ b.astype(np.float64)
    plain = ref.matmul_bias_ref(torch.from_numpy(a).to(torch.bfloat16),
                                torch.from_numpy(b).to(torch.bfloat16)
                                ).float().numpy().astype(np.float64)
    (tol,) = CS.TOL_BF16["gemm_bias"]
    limit = tol["atol"] + tol["rtol"] * np.abs(plain)
    errs = {}
    for promote in (None, fused.WGMMA_BK):
        acc = _emulated_wgmma_gemm(a, b, promote)
        got = _bf16(acc).astype(np.float64)
        assert float((np.abs(got - plain) / limit).max()) < 1.0, promote
        errs[promote] = float(np.abs(acc - exact).max())
    assert errs[fused.WGMMA_BK] < errs[None], errs
