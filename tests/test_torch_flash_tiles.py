"""The flash forward and dq kernels' arithmetic and grid, on the CPU.

csrc/flash.cuh runs every product of ``flash_fwd_kernel`` and
``flash_bwd_dq_kernel`` on the tensor cores.  A numpy emulation of that
arithmetic (fp32 inputs) is held against the port's plain versions,
``ref.flash_fwd_ref`` and ``ref.flash_bwd_ref``, under chip_smoke.py's
fp32 flash tolerances:

  * each product as 3xTF32 mma steps of 8 (``_emulated_gemm`` of
    tests/test_torch_gemm_tiles.py: x = big + small, each step's exact
    sum added to the accumulator with round-toward-zero);
  * S = Q.K^T (and dP = dO.V^T) summed over D in one zeroed accumulator
    per kv block, as ``rows_dot`` does;
  * P.V (dS.K) summed over the block's 64 kv positions into a zeroed
    accumulator and promoted into the fp32 output once per kv block, as
    ``rows_acc`` does, with both operands read in the kernel's k-slot
    order (slot t <-> position 2t, slot t + 4 <-> 2t + 1 inside each step
    of 8: P and dS stay in the C fragments they were formed in);
  * the forward's online softmax: per kv block the running max m, p =
    exp(s.scale - m), corr = exp(m_old - m), l and O scaled by corr
    before the block's promotion; lse = m + log(max(l, 1e-20)).

The same emulation without the small terms (1xTF32) must fail the
tolerances, so they would catch a kernel that drops them.  It runs at
each built q tile (64, and 128 rows at head dims 64 and 128: the
``-bq128`` cases, whose diagonal q blocks span two kv blocks of 64),
and a 128-row tile gives outputs bitwise equal to the 64-row one.  The
grid tests mirror the kernels' grid mapping (forward and dq: grid (H,
B, q blocks), the q block taken from the last; dk/dv: kv blocks in
order): each block once, the blocks with the most work first, over the
reference's _kv_bounds and _q_bounds, at each tile.  With fewer queries
than keys (the queries the last Sq of Sk positions, a sequence shard's),
an emulation of the kernels' walks, their block bounds taken at key
positions and their per-warp skips, computes every visible (q, k) pair
exactly once and no other, dk/dv writes each kv row once, and at Sq ==
Sk every bound is the whole-sequence one.

The bf16 wgmma kernels (csrc/flash_wgmma.cu, csrc/flash_bwd_wgmma.cu)
are emulated from bf16 operands at phase 20's S 2048 and held to
chip_smoke.py's bf16 tolerance: each k16 step's products summed exactly
and rounded toward zero into the accumulator, no promotion, and p (ds)
split as hi + lo where a product takes it from registers; the same
emulation with one bf16 P (and dS) misses, so the split stays.
"""
import functools
import math

import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import _kv_bounds, _q_bounds
from repro_torch.kernels import ref
from test_torch_gemm_tiles import CS, _emulated_gemm

BLOCK = 64                  # the kv tile of the forward and dq
NEG_INF = np.float32(-1e30)
#: k-slot s of each mma step of 8 reads position PERM[s] of the step
PERM = np.array([0, 2, 4, 6, 1, 3, 5, 7])

# (B, S, H, KV, D, window): causal with a ragged last block, grouped
# query heads, a sliding window, and head dims 16, 80 and 96
SHAPES = {"causal": (1, 130, 2, 2, 64, 0), "gqa": (1, 100, 4, 2, 32, 0),
          "window": (1, 150, 4, 1, 32, 48), "d16": (1, 100, 2, 2, 16, 0),
          "d80": (1, 130, 2, 1, 80, 0), "d96": (1, 130, 2, 2, 96, 40)}
#: label -> (shape, q tile): the shapes above at 64, and the 128-row q
#: tile at head dims 64 (causal, a window) and 128 (grouped heads)
CASES = {**{k: (v, 64) for k, v in SHAPES.items()},
         "causal-bq128": ((1, 130, 2, 2, 64, 0), 128),
         "window-bq128": ((1, 200, 4, 1, 64, 48), 128),
         "gqa-d128-bq128": ((1, 150, 4, 2, 128, 0), 128)}


def _inputs(shape, seed=0):
    B, S, H, KV, D, window = shape
    rng = np.random.default_rng(seed)
    q, dout = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((B, S, KV, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v, dout


def _tile(x, row0, n=BLOCK):
    """Rows [row0, row0 + n) of a [S, D] array, rows past S as 0."""
    out = np.zeros((n, x.shape[1]), np.float32)
    rows = x[row0:row0 + n]
    out[:len(rows)] = rows
    return out


def _visible(q0, k0, S, window, bq=BLOCK):
    qpos = q0 + np.arange(bq)[:, None]
    kpos = k0 + np.arange(BLOCK)[None, :]
    ok = (kpos <= qpos) & (qpos < S)
    if window > 0:
        ok &= kpos > qpos - window
    return ok


def _block_sum(x, b, small_terms):
    """x.b over one block's 64 positions as rows_acc sums it: both operands
    in the kernel's k-slot order, one zeroed accumulator."""
    order = (np.arange(0, BLOCK, 8)[:, None] + PERM[None, :]).ravel()
    return _emulated_gemm(x[:, order], b[order], small_terms=small_terms,
                          promote=BLOCK)


def _rows_dot(a, b, small_terms):
    """a.b^T over D in one zeroed accumulator, as rows_dot sums it."""
    return _emulated_gemm(a, np.ascontiguousarray(b.T),
                          small_terms=small_terms, promote=a.shape[1])


def _heads(shape, bq=BLOCK):
    B, S, H, KV, D, window = shape
    nq = -(-S // bq)
    for b in range(B):
        for h in range(H):
            for iq in range(nq):
                lo, hi = _kv_range(iq, S, window, bq)
                yield b, h, h // (H // KV), iq, lo, hi


def _kv_range(iq, S, window, bq=BLOCK):
    """[lo, hi) of flash.cuh's QWalk at q tile bq (C division; lo is
    clamped at 0)."""
    q0 = iq * bq
    lo = max(int((q0 - window + 1) / BLOCK), 0) if window > 0 else 0
    return lo, min((q0 + bq - 1) // BLOCK + 1, -(-S // BLOCK))


def _q_range(ik, S, window, bk):
    """[qlo, qhi) of flash.cuh's dk/dv kernel at kv tile bk (q tiles of
    64)."""
    k0, nq = ik * bk, -(-S // BLOCK)
    qhi = (min((k0 + bk + window - 2) // BLOCK + 1, nq) if window > 0
           else nq)
    return k0 // BLOCK, qhi


def emulated_fwd(q, k, v, window, small_terms=True, bq=BLOCK):
    """(out, lse) of flash_fwd_kernel at q tile bq, emulated."""
    B, S, H, D = q.shape
    scale = np.float32(1.0 / math.sqrt(D))
    out = np.zeros_like(q)
    lse = np.zeros((B, H, S), np.float32)
    for b, h, kvh, iq, lo, hi in _heads((B, S, H, k.shape[2], D, window), bq):
        q0 = iq * bq
        qt = _tile(q[b, :, h], q0, bq)
        o = np.zeros((bq, D), np.float32)
        m = np.full(bq, NEG_INF, np.float32)
        l = np.zeros(bq, np.float32)
        for ik in range(lo, hi):
            k0 = ik * BLOCK
            ok = _visible(q0, k0, S, window, bq)
            s = _rows_dot(qt, _tile(k[b, :, kvh], k0), small_terms)
            s = np.where(ok, s * scale, NEG_INF).astype(np.float32)
            mx = np.maximum(m, s.max(1))
            p = np.where(ok, np.exp(s - mx[:, None]), 0).astype(np.float32)
            corr = np.exp(m - mx).astype(np.float32)
            l = (l * corr + p.sum(1, dtype=np.float32)).astype(np.float32)
            m = mx
            o = o * corr[:, None] + _block_sum(p, _tile(v[b, :, kvh], k0),
                                               small_terms)
        rows = min(bq, S - q0)
        li = np.maximum(l, np.float32(1e-20))
        out[b, q0:q0 + rows, h] = (o / li[:, None])[:rows]
        lse[b, h, q0:q0 + rows] = (m + np.log(li))[:rows]
    return out, lse


def emulated_dq(q, k, v, dout, lse, delta, window, small_terms=True,
                bq=BLOCK):
    """dq of flash_bwd_dq_kernel at q tile bq, emulated."""
    B, S, H, D = q.shape
    scale = np.float32(1.0 / math.sqrt(D))
    dq = np.zeros_like(q)
    for b, h, kvh, iq, lo, hi in _heads((B, S, H, k.shape[2], D, window), bq):
        q0 = iq * bq
        qt, gt = _tile(q[b, :, h], q0, bq), _tile(dout[b, :, h], q0, bq)
        rl = _tile(lse[b, h][:, None], q0, bq)
        rd = _tile(delta[b, h][:, None], q0, bq)
        acc = np.zeros((bq, D), np.float32)
        for ik in range(lo, hi):
            k0 = ik * BLOCK
            kt, vt = _tile(k[b, :, kvh], k0), _tile(v[b, :, kvh], k0)
            s = _rows_dot(qt, kt, small_terms)
            dp = _rows_dot(gt, vt, small_terms)
            p = np.where(_visible(q0, k0, S, window, bq),
                         np.exp(s * scale - rl), 0).astype(np.float32)
            ds = (p * (dp - rd) * scale).astype(np.float32)
            acc = acc + _block_sum(ds, kt, small_terms)
        rows = min(bq, S - q0)
        dq[b, q0:q0 + rows, h] = acc[:rows]
    return dq


def _worst(name, got, want, args):
    """Largest |emulated - plain| / limit over the outputs, chip_smoke.py's
    comparison (cond: the sum of the terms' magnitudes)."""
    worst = 0.0
    for g, w, cond, tol in zip(got, want, CS._conds(name, args, want),
                               CS.TOL_FP32[name]):
        w = w.double()
        limit = tol["atol"] + tol["rtol"] * w.abs()
        if cond is not None:
            limit = limit + tol["ctol"] * cond.double()
        worst = max(worst, float(((torch.from_numpy(g).double() - w).abs()
                                  / limit).max()))
    return worst


@pytest.mark.parametrize("small_terms", [True, False],
                         ids=["3xtf32-holds", "1xtf32-fails"])
@pytest.mark.parametrize("label", list(CASES))
def test_emulated_forward_against_the_fp32_tolerance(label, small_terms):
    shape, bq = CASES[label]
    window = shape[-1]
    q, k, v, _ = _inputs(shape)
    got = emulated_fwd(q, k, v, window, small_terms=small_terms, bq=bq)
    if bq != BLOCK:        # every tile gives the 64-row tile's outputs
        for a, b in zip(got, emulated_fwd(q, k, v, window, small_terms)):
            np.testing.assert_array_equal(a, b)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    want = ref.flash_fwd_ref(tq, tk, tv, window=window)
    worst = _worst("flash_fwd", got, want, (tq, tk, tv, window))
    if small_terms:
        assert worst < 0.25, worst
    else:
        assert worst > 1.0, worst


@pytest.mark.parametrize("small_terms", [True, False],
                         ids=["3xtf32-holds", "1xtf32-fails"])
@pytest.mark.parametrize("label", list(CASES))
def test_emulated_dq_against_the_fp32_tolerance(label, small_terms):
    shape, bq = CASES[label]
    window = shape[-1]
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(shape))
    out, lse = ref.flash_fwd_ref(q, k, v, window=window)
    delta = ref.flash_delta(out, dout)
    operands = [t.numpy() for t in (q, k, v, dout, lse, delta)]
    got = emulated_dq(*operands, window, small_terms=small_terms, bq=bq)
    if bq != BLOCK:
        np.testing.assert_array_equal(
            got, emulated_dq(*operands, window, small_terms=small_terms))
    want = ref.flash_bwd_ref(q, k, v, None, lse, dout, window=window,
                             delta=delta)[:1]
    worst = _worst("flash_bwd_dq", [got], want,
                   (q, k, v, dout, lse, delta, window))
    if small_terms:
        assert worst < 0.25, worst
    else:
        assert worst > 1.0, worst


def _grid_order(B, S, H):
    """(q block, head, batch) of each block of the forward's and dq's grid
    (H, B, nq) in dispatch order, x fastest: flash.cuh's QWalk takes h =
    blockIdx.x, b = blockIdx.y and q block nq - 1 - blockIdx.z."""
    nq = -(-S // BLOCK)
    return [(nq - 1 - z, x, y) for z in range(nq) for y in range(B)
            for x in range(H)]


@pytest.mark.parametrize("shape", [(2, 2048, 16, 16, 64, 0),
                                   (2, 1000, 16, 2, 128, 0),
                                   (2, 1000, 20, 4, 64, 256)],
                         ids=["flash", "gqa", "window"])
def test_grid_covers_each_q_block_once_longest_first(shape):
    """chip_smoke.py's card shapes: every (q block, head, batch) once, the
    kv range of each the reference's _kv_bounds, and the number of kv
    blocks never growing along the dispatch order."""
    B, S, H, KV, D, window = shape
    order = _grid_order(B, S, H)
    nq = -(-S // BLOCK)
    assert sorted(order) == [(iq, h, b) for iq in range(nq)
                             for h in range(H) for b in range(B)]
    lengths = []
    for iq, _, _ in order:
        lo, hi = _kv_range(iq, S, window)
        rlo, rhi = _kv_bounds(iq * BLOCK, BLOCK, BLOCK, window, nq)
        assert (lo, hi) == (int(rlo), int(rhi)), iq
        lengths.append(hi - lo)
    assert all(a >= b for a, b in zip(lengths, lengths[1:]))


@pytest.mark.parametrize("shape", [(2, 2048, 16, 16, 64, 0),
                                   (2, 1000, 16, 2, 128, 0),
                                   (2, 1000, 20, 4, 64, 256),
                                   (1, 130, 2, 2, 64, 48)],
                         ids=["flash", "gqa", "window", "short-window"])
@pytest.mark.parametrize("tile", [64, 128])
def test_grids_cover_each_block_once_at_every_tile(shape, tile):
    """The forward's and dq's grid at q tile ``tile`` (kv tiles of 64) and
    dk/dv's at kv tile ``tile`` (q tiles of 64): each block once, its
    range the reference's _kv_bounds / _q_bounds for those tiles, the
    longest blocks first; and every (q, k) pair the mask keeps lies in
    exactly one (q block, kv block) of each walk."""
    B, S, H, KV, D, window = shape
    nq, nk = -(-S // tile), -(-S // BLOCK)
    lengths = []
    for z in range(nq):           # q blocks from the last
        iq = nq - 1 - z
        lo, hi = _kv_range(iq, S, window, tile)
        rlo, rhi = _kv_bounds(iq * tile, tile, BLOCK, window, nk)
        assert (lo, hi) == (int(rlo), int(rhi)), iq
        lengths.append(hi - lo)
    assert all(a >= b for a, b in zip(lengths, lengths[1:]))
    lengths = []
    for ik in range(-(-S // tile)):          # kv blocks in order
        qlo, qhi = _q_range(ik, S, window, tile)
        rlo, rhi = _q_bounds(ik * tile, BLOCK, tile, window, -(-S // BLOCK))
        assert (qlo, qhi) == (int(rlo), int(rhi)), ik
        lengths.append(qhi - qlo)
    assert all(a >= b for a, b in zip(lengths, lengths[1:]))
    qpos, kpos = np.tril_indices(S)
    keep = (kpos > qpos - window) if window > 0 else np.ones_like(qpos, bool)
    qpos, kpos = qpos[keep], kpos[keep]
    for ranges, qblk, kblk in (
            ([_kv_range(i, S, window, tile) for i in range(nq)],
             qpos // tile, kpos // BLOCK),
            ([_q_range(i, S, window, tile) for i in range(-(-S // tile))],
             kpos // tile, qpos // BLOCK)):
        lo = np.array([r[0] for r in ranges])[qblk]
        hi = np.array([r[1] for r in ranges])[qblk]
        assert ((lo <= kblk) & (kblk < hi)).all()


# ----------------------------------------------------------------------
# Fewer queries than keys: the queries are the last Sq of Sk positions
# ----------------------------------------------------------------------
def _trunc(a, b):
    """C's integer division (toward zero)."""
    return int(a / b)


def _visible_at(qpos, kpos, Sk, window):
    """flash.cuh's visible(): positions are key positions."""
    ok = (kpos <= qpos) & (qpos < Sk)
    if window > 0:
        ok &= kpos > qpos - window
    return ok


def _kv_range_at(iq, Sq, Sk, window, bq):
    """[lo, hi) of flash.cuh's QWalk for q block iq at q tile bq: taken at
    the block's first key position p0 = iq * bq + Sk - Sq."""
    p0 = iq * bq + Sk - Sq
    lo = max(_trunc(p0 - window + 1, BLOCK), 0) if window > 0 else 0
    return lo, min(_trunc(p0 + bq - 1, BLOCK) + 1, -(-Sk // BLOCK))


def _q_range_at(ik, Sq, Sk, window, bk):
    """[qlo, qhi) of flash.cuh's dk/dv kernel for kv block ik at kv tile
    bk (q tiles of 64), and the number of q blocks it walks."""
    off, k0, nq = Sk - Sq, ik * bk, -(-Sq // BLOCK)
    qlo = _trunc(max(k0 - off, 0), BLOCK)
    last = k0 + bk + window - 2 - off
    qhi = ((0 if last < 0 else min(_trunc(last, BLOCK) + 1, nq))
           if window > 0 else nq)
    return qlo, qhi, max(qhi - qlo, 0)


def _walk_pairs(Sq, Sk, window, tile):
    """Every (q position, k position) each walk computes, as the kernels
    compute it: the forward's and dq's (q block, warp of 16 rows, kv
    block) over [lo, hi), dk/dv's (kv block, warp of 16 kv rows, q block)
    over [qlo, qhi), each skipping the pairs of rows none of which is
    visible (``none``), testing visible() per element unless ``all``;
    and how many times dk/dv writes each kv row."""
    off = Sk - Sq
    r16, c64 = np.arange(16)[:, None], np.arange(BLOCK)[None, :]
    fwd = []
    for iq in range(-(-Sq // tile)):
        lo, hi = _kv_range_at(iq, Sq, Sk, window, tile)
        for w in range(tile // 16):
            qr = iq * tile + off + 16 * w
            for ik in range(lo, hi):
                k0 = ik * BLOCK
                if (qr >= Sk or qr + 15 < k0 or
                        (window > 0 and qr - (k0 + BLOCK - 1) >= window)):
                    continue
                every = (k0 + BLOCK - 1 <= qr and qr + 15 < Sk and
                         (window <= 0 or qr + 15 - k0 < window))
                qp, kp = np.broadcast_arrays(qr + r16, k0 + c64)
                keep = every | _visible_at(qp, kp, Sk, window)
                fwd.append(np.stack([qp[keep], kp[keep]], 1))
    dkdv, written = [], np.zeros(-(-Sk // tile) * tile, int)
    for ik in range(-(-Sk // tile)):
        qlo, qhi, _ = _q_range_at(ik, Sq, Sk, window, tile)
        for w in range(tile // 16):
            kmin = ik * tile + 16 * w
            written[kmin:kmin + 16] += 1
            for iq in range(qlo, qhi):
                p0 = iq * BLOCK + off
                pmax = p0 + BLOCK - 1
                if pmax < kmin or (window > 0 and
                                   p0 - (kmin + 15) >= window):
                    continue
                every = (p0 >= kmin + 15 and pmax < Sk and
                         (window <= 0 or pmax - kmin < window))
                kp, qp = np.broadcast_arrays(kmin + r16, p0 + c64)
                keep = every | _visible_at(qp, kp, Sk, window)
                dkdv.append(np.stack([qp[keep], kp[keep]], 1))
    return (np.concatenate(fwd) if fwd else np.zeros((0, 2), int),
            np.concatenate(dkdv) if dkdv else np.zeros((0, 2), int),
            written[:Sk])


_OFFSET_CASES = [(Sq, Sk, window, tile)
                 for Sq, Sk in ((1, 1), (1, 70), (37, 37), (37, 100),
                                (64, 128), (100, 227), (130, 130),
                                (128, 512), (200, 264))
                 for window in (0, 6, 48)
                 for tile in (64, 128)]


@pytest.mark.parametrize("Sq,Sk,window,tile", _OFFSET_CASES)
def test_offset_walks_cover_exactly_the_visible_pairs(Sq, Sk, window, tile):
    """Queries the last Sq of Sk positions: each walk computes every
    visible (q, k) pair exactly once and no other, dk/dv's grid writes
    each of the Sk kv rows exactly once (a row no query sees then holds
    zeros: its block adds nothing), and at Sq == Sk every range is the
    whole-sequence kernels' (``_kv_range``, ``_q_range``)."""
    qp, kp = np.meshgrid(np.arange(Sq) + Sk - Sq, np.arange(Sk),
                         indexing="ij")
    keep = _visible_at(qp, kp, Sk, window)
    want = sorted(zip(qp[keep].tolist(), kp[keep].tolist()))
    fwd, dkdv, written = _walk_pairs(Sq, Sk, window, tile)
    for pairs in (fwd, dkdv):
        assert sorted(map(tuple, pairs.tolist())) == want
    assert (written == 1).all()
    if Sq == Sk:
        for iq in range(-(-Sq // tile)):
            assert _kv_range_at(iq, Sq, Sk, window, tile) == \
                _kv_range(iq, Sk, window, tile)
        for ik in range(-(-Sk // tile)):
            assert _q_range_at(ik, Sq, Sk, window, tile)[:2] == \
                _q_range(ik, Sk, window, tile)


def test_offset_kv_block_no_query_sees_walks_nothing():
    """Under a window, a kv block far behind every query has an empty q
    range (its rows are written as zeros) and never divides by it."""
    Sq, Sk, window = 64, 512, 6
    qlo, qhi, nqb = _q_range_at(0, Sq, Sk, window, 64)
    assert nqb == 0 and qhi == 0
    assert _q_range_at(7, Sq, Sk, window, 64)[2] == 1


# ----------------------------------------------------------------------
# The bf16 wgmma forward (csrc/flash_wgmma.cu), emulated
# ----------------------------------------------------------------------
from repro_torch.kernels import tma  # noqa: E402
from test_torch_gemm_tiles import (_bf16, _emulated_wgmma_gemm,  # noqa: E402
                                   _rz32)


def emulated_wgmma_fwd(q, k, v, window, split=True):
    """(out, lse) of flash_wgmma.cu from bf16 operands, emulated row by
    row (a row's sums do not depend on the block's consumer warpgroups,
    and a kv block none of whose keys a row sees leaves it unchanged, so
    only the rows that see a block take it): per kv block of
    ``tma.FLASH_KV_ROWS[D]`` keys, S = Q.K^T in k16 steps rounded toward
    zero into one zeroed accumulator; m kept in unscaled score units, p =
    2^(s.c - m.c) with c = log2(e)/sqrt(D) (the FFMA rounded once), corr
    = 2^((m_old - m).c), l = l.corr + rowsum(p); O = O.corr, then P
    split as hi + lo in bf16 (``split``; else P rounded to bf16 alone)
    and lo.V then hi.V each k16 step rounded toward zero into O (the
    kernel promotes nothing); O / l rounded to bf16, lse = m.scale +
    log(max(l, 1e-20))."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    BK = tma.FLASH_KV_ROWS[D]
    scale = np.float32(1.0 / math.sqrt(D))
    c2 = np.float32(scale * np.float32(1.4426950408889634))
    out = np.zeros_like(q)
    lse = np.zeros((B, H, S), np.float32)
    pos = np.arange(S)
    for b in range(B):
        for h in range(H):
            qt, kt, vt = q[b, :, h], k[b, :, h // G], v[b, :, h // G]
            o = np.zeros((S, D), np.float32)
            m = np.full(S, NEG_INF, np.float32)
            l = np.zeros(S, np.float32)
            for k0 in range(0, S, BK):
                kpos = np.arange(k0, min(k0 + BK, S))
                sees = pos >= k0
                if window > 0:
                    sees &= pos - kpos[-1] < window
                r = pos[sees]
                ok = kpos[None, :] <= r[:, None]
                if window > 0:
                    ok &= kpos[None, :] > r[:, None] - window
                s = _emulated_wgmma_gemm(qt[r], np.ascontiguousarray(
                    kt[kpos].T), promote=D)
                s = np.where(ok, s, NEG_INF).astype(np.float32)
                mx = np.maximum(m[r], s.max(1))
                mc = (mx * c2).astype(np.float32)
                p = np.exp2((s.astype(np.float64) * c2 - mc[:, None]
                             ).astype(np.float32)).astype(np.float32)
                p = np.where(ok, p, 0).astype(np.float32)
                corr = np.exp2(((m[r] - mx).astype(np.float32) * c2
                                ).astype(np.float32)).astype(np.float32)
                l[r] = (l[r] * corr + p.sum(1, dtype=np.float32)
                        ).astype(np.float32)
                m[r] = mx
                hi = _bf16(p)
                lo = _bf16(p - hi)
                acc = (o[r] * corr[:, None]).astype(np.float32)
                for j in range(0, len(kpos), 16):
                    vs = vt[kpos[j:j + 16]].astype(np.float64)
                    for part in ((lo, hi) if split else (hi,)):
                        acc = _rz32(acc.astype(np.float64)
                                    + part[:, j:j + 16].astype(np.float64)
                                    @ vs)
                o[r] = acc
            li = np.maximum(l, np.float32(1e-20))
            out[b, :, h] = _bf16(o / li[:, None])
            lse[b, h] = (m.astype(np.float64) * scale + np.log(li)
                         ).astype(np.float32)
    return out, lse


def _worst_bf16(got, want, args):
    """Largest |emulated - plain| / limit of each output under
    chip_smoke.py's bf16 flash tolerance."""
    out = []
    for g, w, cond, tol in zip(got, want, CS._conds("flash_fwd", args, want),
                               CS.TOL_BF16["flash_fwd"]):
        w = w.double()
        limit = tol["atol"] + tol["rtol"] * w.abs()
        if cond is not None:
            limit = limit + tol["ctol"] * cond.double()
        out.append(float(((torch.from_numpy(g).double() - w).abs()
                          / limit).max()))
    return out


#: phase 20's head dims at S 2048 (one sequence, one kv head): 20a's and
#: 20c's 128, 20b's 64 under hymba's window (cut to 512 here, so it
#: cuts causal pairs)
WGMMA_CASES = {"d128": (1, 2048, 2, 1, 128, 0),
               "d64-window": (1, 2048, 2, 1, 64, 512)}


@pytest.mark.parametrize("split", [True, False],
                         ids=["hi-lo-holds", "one-bf16-p-fails"])
@pytest.mark.parametrize("label", list(WGMMA_CASES))
def test_emulated_wgmma_forward_against_the_bf16_tolerance(label, split):
    """The wgmma forward's arithmetic at phase 20's S 2048 and head dims,
    bf16 inputs, against the plain forward under chip_smoke.py's bf16
    tolerance: with P split as hi + lo it holds; with one bf16 P (a
    single P.V product) the output misses 1e-3 of its cond where few
    terms cancel, so the split stays."""
    shape = WGMMA_CASES[label]
    window = shape[-1]
    q, k, v, _ = (_bf16(x) for x in _inputs(shape))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    want = ref.flash_fwd_ref(tq, tk, tv, window=window)
    got = emulated_wgmma_fwd(q, k, v, window, split=split)
    worst = _worst_bf16(got, want, (tq, tk, tv, window))
    assert worst[1] < 0.25, worst            # lse: fp32 on both sides
    if split:
        assert worst[0] < 0.5, worst
    else:
        assert worst[0] > 1.0, worst



# ----------------------------------------------------------------------
# The bf16 wgmma backward (csrc/flash_bwd_wgmma.cu), emulated
# ----------------------------------------------------------------------
LOG2E = np.float32(1.4426950408889634)
_CUT = np.uint64(0xFFFFFFFFE0000000)    # float64 bits kept by float32's 24


def _rz(x):
    """float64 -> float32 rounded toward zero, as ``_rz32``: the float64
    mantissa cut to float32's 24 bits (exact in float32's normal range),
    the rare results below it through ``_rz32``."""
    x = np.ascontiguousarray(x, np.float64)
    r = (x.view(np.uint64) & _CUT).view(np.float64).astype(np.float32)
    tiny = np.flatnonzero(np.abs(r) < np.float32(2.0 ** -126))
    tiny = tiny[x.ravel()[tiny] != 0]
    if tiny.size:
        r.ravel()[tiny] = _rz32(x.ravel()[tiny])
    return r


def _wgmma_dot_t(a, b):
    """a.b^T over D as the wgmma kernels sum a score tile: k16 steps
    rounded toward zero into one zeroed accumulator (S = Q.K^T and S^T =
    K.Q^T take the same products in the same order, so one matrix serves
    both)."""
    acc = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for kk in range(0, a.shape[1], 16):
        acc = _rz(acc + a[:, kk:kk + 16].astype(np.float64)
                  @ b[:, kk:kk + 16].T.astype(np.float64))
    return acc


def _span(j, first, end, n):
    """[j + first, j + end) clamped to [0, n), each None for the edge:
    the accumulator rows a k16 step at column j can change (the rows
    that see none of columns j .. j + 15 take zero terms there, which
    leave an accumulator unchanged)."""
    return (0 if first is None else min(max(j + first, 0), n),
            n if end is None else min(max(j + end, 0), n))


def wgmma_bwd_terms(q, k, v, dout, lse, delta, window):
    """{(batch, query head): (p, ds)}, [Sq, Sk] fp32 as both wgmma
    backward kernels form them on the accumulator registers: s and dp
    from ``_wgmma_dot_t``, p = 2^(s.c - lse.log2(e)) with c =
    log2(e)/sqrt(D) (the FFMA rounded once, lse.log2(e) rounded to fp32
    first), 0 where a pair is not visible, ds = (p.(dp - delta)).scale
    rounded at each step.  Scores are formed only over the visible
    columns of each 256 rows."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G, off = H // KV, Sk - Sq
    scale = np.float32(1.0 / math.sqrt(D))
    c2 = np.float32(scale * LOG2E)
    out = {}
    for b in range(B):
        for h in range(H):
            p = np.zeros((Sq, Sk), np.float32)
            ds = np.zeros((Sq, Sk), np.float32)
            for r0 in range(0, Sq, 256):
                r1 = min(r0 + 256, Sq)
                c0 = max(r0 + off - window + 1, 0) if window > 0 else 0
                c1 = r1 + off
                qpos = np.arange(r0, r1)[:, None] + off
                kpos = np.arange(c0, c1)[None, :]
                ok = kpos <= qpos
                if window > 0:
                    ok &= kpos > qpos - window
                s = _wgmma_dot_t(q[b, r0:r1, h], k[b, c0:c1, h // G])
                dp = _wgmma_dot_t(dout[b, r0:r1, h], v[b, c0:c1, h // G])
                l2 = (lse[b, h, r0:r1] * LOG2E).astype(np.float32)[:, None]
                pb = np.exp2((s.astype(np.float64) * c2 - l2
                              ).astype(np.float32)).astype(np.float32)
                pb = np.where(ok, pb, np.float32(0)).astype(np.float32)
                t = (dp - delta[b, h, r0:r1][:, None]).astype(np.float32)
                p[r0:r1, c0:c1] = pb
                ds[r0:r1, c0:c1] = ((pb * t).astype(np.float32) * scale
                                    ).astype(np.float32)
            out[b, h] = (p, ds)
    return out


def _wgmma_acc(acc, x, y, split, span):
    """acc += x.y as wgmma with A = x from registers and B = y MN-major,
    k16 steps of x's columns in order, each rounded toward zero into acc
    (no promotion): x split as hi + lo in bf16, lo.y then hi.y a step, or
    rounded to bf16 alone; ``span(j)``: the rows step j can change."""
    hi = _bf16(x)
    parts = (_bf16(x - hi), hi) if split else (hi,)
    for j in range(0, x.shape[1], 16):
        r0, r1 = span(j)
        if r0 >= r1:
            continue
        ys = y[j:j + 16].astype(np.float64)
        for part in parts:
            acc[r0:r1] = _rz(acc[r0:r1] + part[r0:r1, j:j + 16] @ ys)
    return acc


def emulated_wgmma_dq(k, terms, window, split=True):
    """dq [B, Sq, H, D] of flash_bwd_wgmma.cu from bf16 operands and
    ``wgmma_bwd_terms``: per query row, dq += dS.K over the kv positions
    in order (kv blocks in order, k16 steps in a block) in one
    accumulator, rounded to bf16 once."""
    B, Sk, KV, D = k.shape
    Sq = next(iter(terms.values()))[0].shape[0]
    H, off = len(terms) // B, Sk - Sq
    dq = np.zeros((B, Sq, H, D), np.float32)
    for (b, h), (_, ds) in terms.items():
        acc = np.zeros((Sq, D), np.float32)
        _wgmma_acc(acc, ds, k[b, :, h // (H // KV)], split,
                   lambda j: _span(j, -off, window + 15 - off
                                   if window > 0 else None, Sq))
        dq[b, :, h] = _bf16(acc)
    return dq


def emulated_wgmma_dkdv(q, k, dout, terms, window, split=True):
    """(dk, dv) [B, Sk, KV, D] of flash_bwd_wgmma.cu from bf16 operands
    and ``wgmma_bwd_terms``: per kv row one accumulator each, over the G
    query heads of its kv head in order and in each the queries in order
    (q blocks in order, k16 steps in a block): dv += P^T.dO, dk +=
    dS^T.Q; rounded to bf16 once."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G, off = H // KV, Sk - Sq
    dk, dv = np.zeros_like(k), np.zeros_like(k)
    for b in range(B):
        for kvh in range(KV):
            ak = np.zeros((Sk, D), np.float32)
            av = np.zeros((Sk, D), np.float32)
            for h in range(kvh * G, (kvh + 1) * G):
                p, ds = terms[b, h]
                for acc, x, y in ((av, p, dout), (ak, ds, q)):
                    _wgmma_acc(acc, np.ascontiguousarray(x.T), y[b, :, h],
                               split, lambda j: _span(
                                   j, off - window + 1 if window > 0
                                   else None, off + 16, Sk))
            dk[b, :, kvh], dv[b, :, kvh] = _bf16(ak), _bf16(av)
    return dk, dv


#: label -> (B, S, H, KV, D, window), the outputs one bf16 P and dS (no
#: hi + lo split) push past the bf16 tolerance: phase 20's S 2048 at 20c's
#: group of 8 query heads on one kv head of 128 (the longest sum of dk
#: and dv: 8 x 2048 query rows), at head dim 64 under a window of 512
#: (20b's 2048 cut down so that it cuts causal pairs), and at S 512
#: where one bf16 P^T misses in dv
WGMMA_BWD_CASES = {"d128-g8": ((1, 2048, 8, 1, 128, 0), ("dq",)),
                   "d64-window": ((1, 2048, 2, 1, 64, 512), ("dq", "dk")),
                   "d64-s512": ((1, 512, 2, 1, 64, 0), ("dq", "dv"))}


@functools.lru_cache(maxsize=1)
def _wgmma_bwd_case(label):
    """(bf16 operands as fp32 numpy, the plain backward, its args, the
    kernels' terms) of one case: the plain forward's lse and delta, as
    chip_smoke.py's make_inputs builds them."""
    shape = WGMMA_BWD_CASES[label][0]
    window = shape[-1]
    q, k, v, g = (_bf16(x) for x in _inputs(shape))
    tq, tk, tv, tg = (torch.from_numpy(x).to(torch.bfloat16)
                      for x in (q, k, v, g))
    out, lse = ref.flash_fwd_ref(tq, tk, tv, window=window)
    delta = ref.flash_delta(out, tg)
    args = (tq, tk, tv, tg, lse, delta, window)
    want = ref.flash_bwd_ref(tq, tk, tv, None, lse, tg, window=window,
                             delta=delta)
    terms = wgmma_bwd_terms(q, k, v, g, lse.numpy(), delta.numpy(), window)
    return (q, k, g), want, args, terms


def _worst_bwd(name, got, want, args):
    """Largest |emulated - plain| / limit of each output under
    chip_smoke.py's bf16 tolerance of kernel ``name``."""
    out = []
    for g, w, cond, tol in zip(got, want, CS._conds(name, args, want),
                               CS.TOL_BF16[name]):
        w = w.double()
        limit = tol["atol"] + tol["rtol"] * w.abs() + tol["ctol"] * cond.double()
        out.append(float(((torch.from_numpy(g).double() - w).abs()
                          / limit).max()))
    return out


@pytest.mark.parametrize("split", [True, False],
                         ids=["hi-lo-holds", "one-bf16-misses"])
@pytest.mark.parametrize("label", list(WGMMA_BWD_CASES))
def test_emulated_wgmma_backward_against_the_bf16_tolerance(label, split):
    """The wgmma dq and dk/dv arithmetic at phase 20's S 2048, bf16
    inputs, against the plain backward under chip_smoke.py's bf16
    tolerance, without promoting any accumulator: with p and ds split as
    hi + lo every output holds, dk and dv too at G 8 (8 x 2048 query rows
    into one accumulator); with one bf16 P and dS the case's listed
    outputs miss 1e-3 of their cond where few terms cancel, so every
    product that takes p or ds from registers keeps the split."""
    (q, k, g), want, args, terms = _wgmma_bwd_case(label)
    window = args[-1]
    worst = dict(zip(("dq",), _worst_bwd(
        "flash_bwd_dq", [emulated_wgmma_dq(k, terms, window, split)],
        want[:1], args)))
    worst.update(zip(("dk", "dv"), _worst_bwd(
        "flash_bwd_dkdv", emulated_wgmma_dkdv(q, k, g, terms, window, split),
        want[1:], args)))
    if split:
        assert max(worst.values()) < 0.5, worst
    else:
        assert all(worst[o] > 1.0 for o in WGMMA_BWD_CASES[label][1]), worst
