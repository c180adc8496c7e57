"""The SSD kernels' three-phase arithmetic, on the CPU.

csrc/ssd.cu runs each direction as three phases: every chunk's local
state (forward L_c = (x * w_last)^T.B; backward L'_c = gy^T.(C e^cum)),
a scan over the chunks of the [P, N] states (S_c+1 = S_c e^cum_Q + L_c;
dS1_c-1 = e^cum_Q dS1_c + L'_c), and every chunk's outputs from its
entering state (and state cotangent), with each product on the tensor
cores as 3xTF32.  A numpy emulation of that arithmetic (fp32 inputs),
each product as ``_emulated_gemm`` of tests/test_torch_gemm_tiles.py (x
= big + small, every mma step of 8 added to one zeroed accumulator per
product with round-toward-zero, as the kernels accumulate a product's
whole K), is held against the port's plain versions ``ref.ssd_fwd_ref``
and ``ref.ssd_bwd_ref`` under chip_smoke.py's SSD tolerance (rtol 1e-4
plus 1e-5 of each output's cond, the sum of its terms' magnitudes), at
the three (P, N) the kernels are built for, with a ragged last chunk and
B and C one group over the heads, at each built chunk (64 and 32,
``ssd.CHUNKS``; the ``-q32`` cases, their ragged last chunks at other
rows).  The same emulation without the small terms (1xTF32) must fail
the tolerance, so it would catch a kernel that drops them.

The bf16 wgmma instances (csrc/ssd_wgmma.cu, chunk 64 at (P, N) =
(64, 128) and (64, 16)) are emulated apart (``emulated_wgmma_fwd`` /
``_bwd``): each product's whole K accumulates in one wgmma accumulator,
every instruction's exact sum rounded into it toward zero
(tools/mma_rounding.py) at wgmma's k step of 16, the bf16 inputs exact
and each fp32 factor (the decayed, dt-weighted scores W and D, the
states S and dS1, x * w_last and gy * e^cum) split as hi + lo bf16.
Held to the plain versions under chip_smoke.py's TOL_BF16 (the states,
ddt and dA at the fp32 tolerance), with a ragged last chunk and B and C
one group over the heads; the same emulation without the lo terms must
fail.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref, ssd
from test_torch_gemm_tiles import CS, _emulated_gemm, _rz32

f32 = np.float32

# (b, S, H, P, N, B/C one group): the kernels' three (P, N), ragged S
SHAPES = {"mamba": (1, 100, 2, 64, 128, True),
          "hymba": (1, 130, 2, 64, 16, True),
          "reduced": (2, 70, 2, 16, 16, False)}
#: label -> (shape, chunk): the shapes above at the chunk of 64, and at
#: every other built chunk under "<label>-q<chunk>"
CASES = {**{k: (v, 64) for k, v in SHAPES.items()},
         **{f"{k}-q{c}": (v, c) for c in ssd.CHUNKS if c != 64
            for k, v in SHAPES.items()}}


def _inputs(shape, seed=0):
    """x, dt, A, B, C as chip_smoke.py's make_inputs draws them (dt and A
    in the Mamba2 block's ranges), and the backward's cotangents."""
    b, S, H, P, N, grouped = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P)).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)) - 3.0)).astype(f32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(f32)
    BC = [np.broadcast_to(rng.standard_normal((b, S, 1, N)), (b, S, H, N))
          if grouped else rng.standard_normal((b, S, H, N))
          for _ in range(2)]
    B, C = (np.ascontiguousarray(t).astype(f32) for t in BC)
    gy = rng.standard_normal((b, S, H, P)).astype(f32)
    gstate = rng.standard_normal((b, H, P, N)).astype(f32)
    return x, dt, A, B, C, gy, gstate


def _chunk(t, bi, h, c, Q):
    """Rows [cQ, cQ + Q) of t[bi, :, h], rows past S as 0."""
    rows = t[bi, c * Q:(c + 1) * Q, h]
    out = np.zeros((Q, *rows.shape[1:]), f32)
    out[:len(rows)] = rows
    return out


def _mm(a, b, small):
    return _emulated_gemm(np.ascontiguousarray(a, f32),
                          np.ascontiguousarray(b, f32), small_terms=small,
                          promote=a.shape[1])


def _decay(dtq, A):
    """cum, e^cum, e^(cum_Q - cum), w_last, e^cum_Q and the masked
    [Q, Q] decay (zero above the diagonal, masked before the exp)."""
    cum = np.cumsum(dtq * A, dtype=f32)
    Q = len(dtq)
    tri = np.tril(np.ones((Q, Q), bool))
    decay = np.where(tri, np.exp(np.where(tri, cum[:, None] - cum[None, :],
                                          0)), 0).astype(f32)
    el = np.exp(cum[-1] - cum).astype(f32)
    return cum, np.exp(cum).astype(f32), el, (el * dtq).astype(f32), \
        f32(np.exp(cum[-1])), decay


def emulated_fwd(x, dt, A, B, C, small=True, Q=64):
    """(y, final state, cstates) of the three forward phases at chunk Q."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    nc = -(-S // Q)
    y = np.zeros_like(x)
    state = np.zeros((b, H, P, N), f32)
    cstates = np.zeros((b, H, nc, P, N), f32)
    for bi in range(b):
        for h in range(H):
            terms = []
            for c in range(nc):      # phase 1: each chunk's local state
                dtq = _chunk(dt[..., None], bi, h, c, Q)[:, 0]
                *_, wl, eq, _ = _decay(dtq, A[h])
                xw = _chunk(x, bi, h, c, Q) * wl[:, None]
                terms.append((eq, _mm(xw.T, _chunk(B, bi, h, c, Q), small)))
            s = np.zeros((P, N), f32)
            for c, (eq, L) in enumerate(terms):   # phase 2: the scan
                cstates[bi, h, c] = s
                s = (s * eq + L).astype(f32)
            state[bi, h] = s
            for c in range(nc):      # phase 3: each chunk's y
                dtq = _chunk(dt[..., None], bi, h, c, Q)[:, 0]
                cum, ecum, _, _, _, decay = _decay(dtq, A[h])
                xq, Bq, Cq = (_chunk(t, bi, h, c, Q) for t in (x, B, C))
                W = _mm(Cq, Bq.T, small) * decay * dtq[None, :]
                yq = (_mm(W, xq, small)
                      + ecum[:, None] * _mm(Cq, cstates[bi, h, c].T, small))
                rows = min(Q, S - c * Q)
                y[bi, c * Q:c * Q + rows, h] = yq[:rows]
    return y, state, cstates


def emulated_bwd(x, dt, A, B, C, cstates, gy, gstate, small=True, Q=64):
    """(dx, ddt, dA, dB, dC) of the three backward phases at chunk Q."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    nc = -(-S // Q)
    dx, dB, dC = np.zeros_like(x), np.zeros_like(B), np.zeros_like(C)
    ddt = np.zeros_like(dt)
    dA = np.zeros(H, f32)
    for bi in range(b):
        for h in range(H):
            dS1 = [None] * nc
            locs, eqs = [], []
            for c in range(nc):      # phase 1: local state cotangents
                dtq = _chunk(dt[..., None], bi, h, c, Q)[:, 0]
                _, ecum, _, _, eq, _ = _decay(dtq, A[h])
                Ce = _chunk(C, bi, h, c, Q) * ecum[:, None]
                locs.append(_mm(_chunk(gy, bi, h, c, Q).T, Ce, small))
                eqs.append(eq)
            s = gstate[bi, h]
            for c in reversed(range(nc)):         # phase 2: reverse scan
                dS1[c] = s
                s = (eqs[c] * s + locs[c]).astype(f32)
            parts = []
            for c in range(nc):      # phase 3: each chunk's gradients
                dtq = _chunk(dt[..., None], bi, h, c, Q)[:, 0]
                cum, ecum, el, wl, eq, decay = _decay(dtq, A[h])
                xq, Bq, Cq, G = (_chunk(t, bi, h, c, Q) for t in (x, B, C, gy))
                S0, dS = cstates[bi, h, c], dS1[c]
                cb, dW = _mm(Cq, Bq.T, small), _mm(G, xq.T, small)
                W = cb * decay * dtq[None, :]
                D = dW * decay * dtq[None, :]
                X = dW * decay * cb
                xdS = _mm(xq, dS, small)
                GS0 = _mm(G, S0, small)
                dxq = _mm(W.T, G, small) + _mm(Bq, dS.T, small) * wl[:, None]
                dBq = _mm(D.T, Cq, small) + xdS * wl[:, None]
                dCq = _mm(D, Bq, small) + GS0 * ecum[:, None]
                dw = (xdS * Bq).sum(1, dtype=f32)
                v = dw * wl
                dc = ((X * dtq[None, :]).sum(1) - dtq * X.sum(0)
                      + (GS0 * Cq).sum(1) * ecum - v).astype(f32)
                dc[-1] += f32((dS * S0).sum()) * eq + v.sum()
                da = np.cumsum(dc[::-1])[::-1].astype(f32)
                rows = min(Q, S - c * Q)
                sl = slice(c * Q, c * Q + rows)
                ddt[bi, sl, h] = (X.sum(0) + dw * el + da * A[h])[:rows]
                dx[bi, sl, h], dB[bi, sl, h], dC[bi, sl, h] = (
                    t[:rows] for t in (dxq, dBq, dCq))
                parts.append(f32((da * dtq).sum()))
            dA[h] += f32(sum(parts))
    return dx, ddt, dA, dB, dC


def _worst(name, got, want, args, chunk):
    """Largest |emulated - plain| / limit over the outputs (chip_smoke.py's
    comparison, its conds at ``chunk``)."""
    worst = 0.0
    for g, w, cond, tol in zip(got, want, CS._conds(name, args, want, chunk),
                               CS.TOL_FP32[name]):
        w = w.double()
        limit = tol["atol"] + tol["rtol"] * w.abs() + tol["ctol"] * cond.double()
        worst = max(worst, float(((torch.from_numpy(np.asarray(g)).double()
                                   - w).abs() / limit).max()))
    return worst


@pytest.mark.parametrize("small", [True, False],
                         ids=["3xtf32-holds", "1xtf32-fails"])
@pytest.mark.parametrize("label", list(CASES))
def test_emulated_forward_against_the_fp32_tolerance(label, small):
    shape, Q = CASES[label]
    x, dt, A, B, C, _, _ = _inputs(shape)
    got = emulated_fwd(x, dt, A, B, C, small=small, Q=Q)
    args = tuple(torch.from_numpy(t) for t in (x, dt, A, B, C))
    worst = _worst("ssd_fwd", got, ref.ssd_fwd_ref(*args, chunk=Q), args, Q)
    if small:
        assert worst < 0.25, worst
    else:
        assert worst > 1.0, worst


@pytest.mark.parametrize("small", [True, False],
                         ids=["3xtf32-holds", "1xtf32-fails"])
@pytest.mark.parametrize("label", list(CASES))
def test_emulated_backward_against_the_fp32_tolerance(label, small):
    shape, Q = CASES[label]
    x, dt, A, B, C, gy, gstate = _inputs(shape, seed=1)
    prim = tuple(torch.from_numpy(t) for t in (x, dt, A, B, C))
    cstates = ref.ssd_fwd_ref(*prim, chunk=Q)[2]
    args = (*prim, cstates, torch.from_numpy(gy), torch.from_numpy(gstate))
    got = emulated_bwd(x, dt, A, B, C, cstates.numpy(), gy, gstate,
                       small=small, Q=Q)
    worst = _worst("ssd_bwd", got, ref.ssd_bwd_ref(*args, chunk=Q), args, Q)
    if small:
        assert worst < 0.25, worst
    else:
        assert worst > 1.0, worst


def test_scan_phases_match_the_sequential_recurrence():
    """The scan in place (phase 1 writes L_c where S_c+1 lands, phase 2
    turns it into S_c+1) gives what the reference's sequential loop
    gives: cstates and the final state bitwise, from the same L_c."""
    rng = np.random.default_rng(2)
    nc, P, N = 5, 4, 3
    L = rng.standard_normal((nc, P, N)).astype(f32)
    eq = rng.uniform(0.3, 1.0, nc).astype(f32)
    buf = np.zeros((nc, P, N), f32)
    buf[1:] = L[:-1]
    final = L[-1].copy()
    s = np.zeros((P, N), f32)
    buf[0] = s
    for c in range(nc):
        s = (s * eq[c] + (buf[c + 1] if c + 1 < nc else final)).astype(f32)
        if c + 1 < nc:
            buf[c + 1] = s
    want, w = [], np.zeros((P, N), f32)
    for c in range(nc):
        want.append(w)
        w = (w * eq[c] + L[c]).astype(f32)
    np.testing.assert_array_equal(buf, np.stack(want))
    np.testing.assert_array_equal(s, w)


# ----------------------------------------------------------------------
# The wgmma instances (csrc/ssd_wgmma.cu)
# ----------------------------------------------------------------------
#: the wgmma instances' (P, N) at ragged S, B and C one group
WG_SHAPES = {"mamba": SHAPES["mamba"], "hymba": SHAPES["hymba"]}


def _bf16(x):
    """fp32 -> bf16 (round to nearest even), as fp32."""
    return torch.from_numpy(np.ascontiguousarray(x, f32)).to(
        torch.bfloat16).float().numpy()


def _wg(a, b, a_split=False, b_split=False, lo=True):
    """a [M, K].b [K, W] as the bf16 wgmma instance issues it: every
    instruction's k step of 16 summed exactly, then rounded into the one
    accumulator of the product's whole K toward zero; bf16 operands, an
    fp32 factor (``a_split`` / ``b_split``) as hi + lo, the terms
    a_lo.b_hi, a_hi.b_lo, a_hi.b_hi in that order; ``lo`` False drops the
    lo terms."""
    a, b = np.ascontiguousarray(a, f32), np.ascontiguousarray(b, f32)
    ah, bh = _bf16(a), _bf16(b)
    terms = []
    if lo and a_split:
        terms.append((_bf16(a - ah), bh))
    if lo and b_split:
        terms.append((ah, _bf16(b - bh)))
    terms.append((ah, bh))
    acc = np.zeros((a.shape[0], b.shape[1]), f32)
    for k in range(0, a.shape[1], 16):
        for x, y in terms:
            acc = _rz32(acc.astype(np.float64) + x[:, k:k + 16].astype(
                np.float64) @ y[k:k + 16].astype(np.float64))
    return acc


def emulated_wgmma_fwd(x, dt, A, B, C, lo=True):
    """(y, final state, cstates) of the wgmma forward at chunk 64: the
    states phase (x * w_last)^T.B (x * w_last split in bf16), the scan,
    then y = W.x + e^cum (C.S^T) (W and S split in bf16)."""
    Q = 64
    b, S, H, P = x.shape
    N = B.shape[-1]
    nc = -(-S // Q)
    y = np.zeros_like(x)
    state = np.zeros((b, H, P, N), f32)
    cstates = np.zeros((b, H, nc, P, N), f32)
    for bi in range(b):
        for h in range(H):
            terms = []
            for c in range(nc):
                dtq = _chunk(dt[..., None], bi, h, c, Q)[:, 0]
                *_, wl, eq, _ = _decay(dtq, A[h])
                xw = _chunk(x, bi, h, c, Q) * wl[:, None]
                terms.append((eq, _wg(xw.T, _chunk(B, bi, h, c, Q),
                                      a_split=True, lo=lo)))
            s = np.zeros((P, N), f32)
            for c, (eq, L) in enumerate(terms):
                cstates[bi, h, c] = s
                s = (s * eq + L).astype(f32)
            state[bi, h] = s
            for c in range(nc):
                dtq = _chunk(dt[..., None], bi, h, c, Q)[:, 0]
                cum, ecum, _, _, _, decay = _decay(dtq, A[h])
                xq, Bq, Cq = (_chunk(t, bi, h, c, Q) for t in (x, B, C))
                W = _wg(Cq, Bq.T, lo=lo) * decay * dtq[None, :]
                yq = (_wg(W, xq, a_split=True, lo=lo)
                      + ecum[:, None] * _wg(Cq, cstates[bi, h, c].T,
                                            b_split=True, lo=lo))
                rows = min(Q, S - c * Q)
                y[bi, c * Q:c * Q + rows, h] = _bf16(yq[:rows])
    return y, state, cstates


def emulated_wgmma_bwd(x, dt, A, B, C, cstates, gy, gstate, lo=True):
    """(dx, ddt, dA, dB, dC) of the wgmma backward at chunk 64: the states
    phase (gy * e^cum)^T.C, the reverse scan, then the chunk phase's
    products with W, D, dS1 and S0 the fp32 factors (split in bf16)."""
    Q = 64
    b, S, H, P = x.shape
    nc = -(-S // Q)
    dx, dB, dC = np.zeros_like(x), np.zeros_like(B), np.zeros_like(C)
    ddt = np.zeros_like(dt)
    dA = np.zeros(H, f32)

    def mm(a, b_, **kw):
        return _wg(a, b_, lo=lo, **kw)
    for bi in range(b):
        for h in range(H):
            dS1 = [None] * nc
            locs, eqs = [], []
            for c in range(nc):
                dtq = _chunk(dt[..., None], bi, h, c, Q)[:, 0]
                _, ecum, _, _, eq, _ = _decay(dtq, A[h])
                Ge = _chunk(gy, bi, h, c, Q) * ecum[:, None]
                locs.append(mm(Ge.T, _chunk(C, bi, h, c, Q), a_split=True))
                eqs.append(eq)
            s = gstate[bi, h]
            for c in reversed(range(nc)):
                dS1[c] = s
                s = (eqs[c] * s + locs[c]).astype(f32)
            parts = []
            for c in range(nc):
                dtq = _chunk(dt[..., None], bi, h, c, Q)[:, 0]
                cum, ecum, el, wl, eq, decay = _decay(dtq, A[h])
                xq, Bq, Cq, G = (_chunk(t, bi, h, c, Q) for t in (x, B, C, gy))
                S0, dS = cstates[bi, h, c], dS1[c]
                cb, dW = mm(Cq, Bq.T), mm(G, xq.T)
                W = cb * decay * dtq[None, :]
                D = dW * decay * dtq[None, :]
                X = dW * decay * cb
                xdS = mm(xq, dS, b_split=True)
                GS0 = mm(G, S0, b_split=True)
                dxq = (mm(W.T, G, a_split=True)
                       + mm(Bq, dS.T, b_split=True) * wl[:, None])
                dBq = mm(D.T, Cq, a_split=True) + xdS * wl[:, None]
                dCq = mm(D, Bq, a_split=True) + GS0 * ecum[:, None]
                dw = (xdS * Bq).sum(1, dtype=f32)
                v = dw * wl
                dc = ((X * dtq[None, :]).sum(1) - dtq * X.sum(0)
                      + (GS0 * Cq).sum(1) * ecum - v).astype(f32)
                dc[-1] += f32((dS * S0).sum()) * eq + v.sum()
                da = np.cumsum(dc[::-1])[::-1].astype(f32)
                rows = min(Q, S - c * Q)
                sl = slice(c * Q, c * Q + rows)
                ddt[bi, sl, h] = (X.sum(0) + dw * el + da * A[h])[:rows]
                dx[bi, sl, h], dB[bi, sl, h], dC[bi, sl, h] = (
                    _bf16(t[:rows]) for t in (dxq, dBq, dCq))
                parts.append(f32((da * dtq).sum()))
            dA[h] += f32(sum(parts))
    return dx, ddt, dA, dB, dC


def _worst_at(name, got, want, args, dtype):
    """``_worst`` under chip_smoke.py's tolerance of ``dtype``."""
    worst = 0.0
    for g, w, cond, tol in zip(got, want, CS._conds(name, args, want, 64),
                               CS.tolerances(name, dtype)):
        w = w.double()
        limit = tol["atol"] + tol["rtol"] * w.abs() + tol["ctol"] * cond.double()
        worst = max(worst, float(((torch.from_numpy(np.asarray(g)).double()
                                   - w).abs() / limit).max()))
    return worst


def _wg_inputs(label, seed):
    """_inputs with x, B, C and gy in bf16 (bf16 values as fp32 for the
    emulation, bf16 tensors for the plain versions)."""
    x, dt, A, B, C, gy, gstate = _inputs(WG_SHAPES[label], seed)
    x, B, C, gy = (_bf16(t) for t in (x, B, C, gy))

    def t(a, cast=True):
        return (torch.from_numpy(a).to(torch.bfloat16) if cast
                else torch.from_numpy(a))
    prim = (t(x), t(dt, False), t(A, False), t(B), t(C))
    return (x, dt, A, B, C, gy, gstate), prim


@pytest.mark.parametrize("lo", [True, False], ids=["lo-holds", "no-lo-fails"])
@pytest.mark.parametrize("label", list(WG_SHAPES))
def test_emulated_wgmma_forward_against_the_tolerance(label, lo):
    (x, dt, A, B, C, _, _), prim = _wg_inputs(label, 0)
    got = emulated_wgmma_fwd(x, dt, A, B, C, lo=lo)
    worst = _worst_at("ssd_fwd", got, ref.ssd_fwd_ref(*prim, chunk=64), prim,
                      torch.bfloat16)
    if lo:
        assert worst < 0.5, worst
    else:
        assert worst > 1.0, worst


@pytest.mark.parametrize("lo", [True, False], ids=["lo-holds", "no-lo-fails"])
@pytest.mark.parametrize("label", list(WG_SHAPES))
def test_emulated_wgmma_backward_against_the_tolerance(label, lo):
    (x, dt, A, B, C, gy, gstate), prim = _wg_inputs(label, 1)
    cstates = ref.ssd_fwd_ref(*prim, chunk=64)[2]
    args = (*prim, cstates, torch.from_numpy(gy).to(torch.bfloat16),
            torch.from_numpy(gstate))
    got = emulated_wgmma_bwd(x, dt, A, B, C, cstates.numpy(), gy, gstate,
                             lo=lo)
    worst = _worst_at("ssd_bwd", got, ref.ssd_bwd_ref(*args, chunk=64), args,
                      torch.bfloat16)
    if lo:
        assert worst < 0.5, worst
    else:
        assert worst > 1.0, worst
