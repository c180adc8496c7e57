"""The wgmma instances' tensor maps and dispatch, on the CPU.

``kernels/tma.py`` computes each operand's TMA tensor map (dims,
strides in bytes, box) on the host, and the wrappers take the wgmma
instances exactly where those maps are legal (``kernels/fused.py::
gemm_config``, ``kernels/flash.py::forward_instance`` and
``backward_instance``).  These tests hold, for every phase 20 shape of
chip_smoke.py, the fused QKV GEMM's three products and the flash
forward, dq and dk/dv on the fused QKV output's views: that
the specs keep ``cuTensorMapEncodeTiled``'s rules (a 16-byte aligned base, strides
positive multiples of 16 bytes, a box of at most 256 a dim whose inner
extent is the 128-byte swizzle row), that they describe the operand as
it lies in memory, and that the wgmma instance is chosen; and where a
rule breaks, that the mma.sync instance is.  Meta tensors stand in for
the operands (shapes, strides and a zero address, no storage)."""
import pytest
import torch

from repro_torch.kernels import flash, fused, ssd, tma
from test_torch_gemm_tiles import CS, _layout

P20_GEMM = [(label, shape) for label, shape in CS.CARD_SHAPES["gemm_bias"]
            if label in CS.P20_LABELS]
P20_FLASH = [(label, shape) for label, shape in CS.CARD_SHAPES["flash"]
             if label in CS.P20_LABELS]


def _legal(spec, rank):
    """``cuTensorMapEncodeTiled``'s rules on one spec of ``rank`` dims."""
    dims, strides, box = (spec[:rank], spec[rank:2 * rank - 1],
                          spec[2 * rank - 1:])
    assert len(spec) == 3 * rank - 1
    assert all(1 <= d <= 2 ** 32 for d in dims)
    assert all(0 < s < 2 ** 40 and s % 16 == 0 for s in strides)
    assert all(1 <= b <= 256 for b in box)
    assert box[0] * tma.ITEMSIZE == 128
    return dims, strides, box


@pytest.mark.parametrize("layout", ["fwd", "dx", "dW"])
@pytest.mark.parametrize("label,shape", P20_GEMM, ids=[l for l, _ in P20_GEMM])
def test_gemm_maps_at_phase_20_shapes(label, shape, layout):
    """Each product of the fused QKV at phase 20's shapes takes the wgmma
    instance, its maps over A and B as they lie in memory: a K-major
    operand one box of 64 K by the tile's 128 rows (A) or 256 columns
    (B), an M- or N-major one boxes of 64 by 64 K."""
    M, N, K, sa, sb = _layout(shape, layout)
    cfg = fused.gemm_config(M, N, K, sa, sb, 0, 256, 2)
    assert cfg.maps is not None and (cfg.bm, cfg.bn) == fused.WGMMA_TILE
    assert cfg.kchunk % fused.WGMMA_BK == 0
    a, b = (_legal(s, 2) for s in cfg.maps)
    if cfg.a_kmajor:
        assert a == ((K, M), (sa[0] * 2,), (64, 128))
    else:
        assert a == ((M, K), (sa[1] * 2,), (64, 64))
    if cfg.b_kmajor:
        assert b == ((K, N), (sb[1] * 2,), (64, 256))
    else:
        assert b == ((N, K), (sb[0] * 2,), (64, 64))
    assert (cfg.a_kmajor, cfg.b_kmajor) == {
        "fwd": (True, False), "dx": (True, True), "dW": (False, False)}[layout]


@pytest.mark.parametrize("sa,sb,aa,ab", [
    ((999, 1), (3000, 1), 0, 0),        # rows of 999 bf16: 1998 bytes
    ((1000, 1), (3000, 1), 8, 0),       # A's base 8 bytes off
    ((2000, 2), (3000, 1), 0, 0),       # no stride-1 dim
    ((1000, 1), (1, 1004), 0, 0),       # W^T of rows of 1004: 2008 bytes
    ((1000, 1), (0, 1), 0, 0),          # B broadcast over K: stride 0
])
def test_gemm_takes_the_mma_instance_where_tma_cannot(sa, sb, aa, ab):
    """Where TMA cannot read an operand the call runs fused.cu's
    element-copy instance (64 x 64, no split): bf16 has no mma.sync
    instance with 16-byte copies, so a stride of 0, whose rows would
    take them, takes element copies too."""
    cfg = fused.gemm_config(1000, 3000, 1000, sa, sb, aa, ab, 2)
    assert cfg.maps is None and not cfg.vec
    assert (cfg.bm, cfg.bn, cfg.splits) == (64, 64, 1)
    with pytest.raises(ValueError, match="not built"):
        fused.gemm_config(1000, 3000, 1000, sa, sb, aa, ab, 2,
                          choice=fused.gemm_plan(1000, 3000, 1000, 2))


def test_fp32_and_the_asked_mma_instance_take_no_maps():
    """fp32 runs fused.cu's instance with 16-byte copies at phase 20's
    shapes, and bf16 asks for fused.cu's element-copy one only through
    its operands (rows of 999), neither with a tensor map."""
    M, N, K, sa, sb = _layout(dict(P20_GEMM)["20a"], "fwd")
    cfg = fused.gemm_config(M, N, K, sa, sb, 0, 0, 4)
    assert cfg.maps is None and cfg.vec
    assert (cfg.bm, cfg.bn) in fused.MMA_TILES
    cfg = fused.gemm_config(M, N, 999, (999, 1), sb, 0, 0, 2)
    assert cfg.maps is None and (cfg.bm, cfg.bn, cfg.vec) == (64, 64, False)


def _fused_views(B, S, H, KV, D, dtype=torch.bfloat16):
    """q, k and v as views of one fused QKV output [B * S, (H + 2KV) D],
    as ``ops.fused_qkv`` hands them over."""
    qkv = torch.empty(B * S, (H + 2 * KV) * D, dtype=dtype, device="meta")
    q = qkv[:, :H * D].reshape(B, S, H, D)
    k = qkv[:, H * D:(H + KV) * D].reshape(B, S, KV, D)
    v = qkv[:, (H + KV) * D:].reshape(B, S, KV, D)
    return q, k, v


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("label,shape", P20_FLASH,
                         ids=[l for l, _ in P20_FLASH])
def test_flash_maps_at_phase_20_shapes_on_fused_views(label, shape, tile):
    """The flash forward at phase 20's shapes on the fused QKV views (and
    on contiguous q and k, as RoPE hands them over) takes the wgmma
    instance at both q tiles, each map over its operand in place: dims
    (D, heads, S, B), the (head, seq, batch) strides in bytes, a box of
    64 columns of one head's rows (the q tile, or the kv rows of a
    stage)."""
    B, S, H, KV, D, _ = shape
    q, k, v = _fused_views(B, S, H, KV, D)
    cols = (H + 2 * KV) * D * 2
    for qq, kk in ((q, k), (q.contiguous(), k.contiguous())):
        maps = flash.forward_instance(qq, kk, v, tile)
        assert maps is not None and len(maps) == 33
        for t, spec, rows in ((qq, maps[:11], tile),
                              (kk, maps[11:22], tma.FLASH_KV_ROWS[D]),
                              (v, maps[22:], tma.FLASH_KV_ROWS[D])):
            dims, strides, box = _legal(spec, 4)
            assert dims == (D, t.shape[2], S, B)
            assert strides == tuple(2 * s for s in (t.stride(2), t.stride(1),
                                                    t.stride(0)))
            assert box == (64, 1, rows, 1)
        assert maps[22 + 5] == cols            # v's row stride: the fused row


def test_flash_takes_the_mma_instance_where_tma_cannot():
    """Head dims without a wgmma instance, fp32, rows not 16-byte aligned
    or a misaligned base: no maps, the mma.sync instance."""
    q, k, v = _fused_views(2, 100, 4, 2, 80)
    assert flash.forward_instance(q, k, v, 64) is None
    q, k, v = _fused_views(2, 100, 4, 2, 64, torch.float32)
    assert flash.forward_instance(q, k, v, 64) is None
    rows = torch.empty(2, 100, 2 * 64 + 4, dtype=torch.bfloat16,
                       device="meta")
    q = rows[..., :128].unflatten(-1, (2, 64))      # rows of 264 bytes
    assert flash.forward_instance(q, q, q, 64) is None
    assert tma.flash_map((2, 100, 2, 64), (25600, 128, 64, 1), 8, 64) is None
    assert tma.flash_map((2, 100, 2, 64), (25600, 128, 64, 1), 0, 64)


@pytest.mark.parametrize("kernel", ["dq", "dkdv"])
@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("label,shape", P20_FLASH,
                         ids=[l for l, _ in P20_FLASH])
def test_flash_backward_maps_at_phase_20_shapes_on_fused_views(label, shape,
                                                               tile, kernel):
    """dq and dk/dv at phase 20's shapes on the fused QKV views (and on
    contiguous q and k), dO contiguous as the autograd function hands it
    over, take the wgmma instances at both tiles, each map over its
    operand in place: dq's q and dO boxes of the tile's rows and k and v
    of the forward's kv stage, dk/dv's k and v of the tile's rows and q
    and dO of 64."""
    B, S, H, KV, D, _ = shape
    q, k, v = _fused_views(B, S, H, KV, D)
    g = torch.empty(B, S, H, D, dtype=torch.bfloat16, device="meta")
    q_rows, kv_rows = ((tile, tma.FLASH_KV_ROWS[D]) if kernel == "dq"
                       else (64, tile))
    for qq, kk in ((q, k), (q.contiguous(), k.contiguous())):
        maps = flash.backward_instance(qq, kk, v, g, kernel, tile)
        assert maps is not None and len(maps) == 44
        for i, (t, rows) in enumerate(((qq, q_rows), (kk, kv_rows),
                                       (v, kv_rows), (g, q_rows))):
            dims, strides, box = _legal(maps[11 * i:11 * i + 11], 4)
            assert dims == (D, t.shape[2], S, B)
            assert strides == tuple(2 * s for s in (t.stride(2), t.stride(1),
                                                    t.stride(0)))
            assert box == (64, 1, rows, 1)
        assert maps[22 + 5] == (H + 2 * KV) * D * 2   # v: the fused row


def test_flash_backward_takes_the_mma_instance_where_tma_cannot():
    """Head dims without a wgmma instance, fp32, a dO whose rows are not
    16-byte aligned or whose base is misaligned: no maps, the mma.sync
    instances of dq and dk/dv."""
    for kernel in ("dq", "dkdv"):
        q, k, v = _fused_views(2, 100, 4, 2, 80)
        assert flash.backward_instance(q, k, v, q, kernel, 64) is None
        q, k, v = _fused_views(2, 100, 4, 2, 64, torch.float32)
        assert flash.backward_instance(q, k, v, q, kernel, 64) is None
        q, k, v = _fused_views(2, 100, 4, 2, 64)
        rows = torch.empty(2, 100, 4 * 64 + 4, dtype=torch.bfloat16,
                           device="meta")
        g = rows[..., :256].unflatten(-1, (4, 64))      # rows of 520 bytes
        assert flash.backward_instance(q, k, v, g, kernel, 64) is None
        assert flash.backward_instance(q, k, v, q.contiguous(), kernel, 64)
    shape, strides = (2, 100, 4, 64), (25600, 256, 64, 1)
    ops = tuple((shape, strides, 0) for _ in range(4))
    assert tma._flash_maps(ops, (64, 128, 128, 64))
    assert tma._flash_maps(ops[:3] + ((shape, strides, 8),),
                           (64, 128, 128, 64)) is None


# ----------------------------------------------------------------------
# The SSD wgmma instances (csrc/ssd_wgmma.cu, kernels/ssd.py::instance)
# ----------------------------------------------------------------------
#: chip_smoke.py's SSD shapes the wgmma instances are built for
SSD_WG = [(label, shape) for label, shape in CS.CARD_SHAPES["ssd"]
          if tuple(shape[3:5]) in tma.SSD_SHAPES]


def _mixer_views(b, S, H, P, N, dtype):
    """x, B and C as the Mamba2 block hands them over: views of one conv
    output [b, S, H P + 2 N], B and C one group expanded over the heads
    (head stride 0, ``models/ssm.py::_expand_groups``)."""
    xbc = torch.empty(b, S, H * P + 2 * N, dtype=dtype, device="meta")
    x = xbc[..., :H * P].reshape(b, S, H, P)
    B, C = (xbc[..., H * P + i * N:H * P + (i + 1) * N].reshape(b, S, 1, N)
            .unsqueeze(-2).expand(b, S, 1, H, N).reshape(b, S, H, N)
            for i in range(2))
    return x, B, C


def _legal_ssd(spec):
    dims, strides, box = spec[:4], spec[4:7], spec[7:]
    assert all(1 <= d <= 2 ** 32 for d in dims)
    assert all(0 < s < 2 ** 40 and s % 16 == 0 for s in strides)
    assert all(1 <= b <= 256 for b in box)
    assert box[0] * 2 == min(128, dims[0] * 2)
    return dims, strides, box


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("label,shape", SSD_WG, ids=[l for l, _ in SSD_WG])
def test_ssd_maps_on_the_mixer_views(label, shape, dtype):
    """Forward and backward at each wgmma SSD shape of chip_smoke.py (S
    1000 at hymba's, a ragged last chunk TMA zero-fills) have legal maps
    on the mixer's views: x over (P, H, S, b) in place, B and C over their
    group view (one head, the seq stride standing in for the head's),
    each box one head's 64 rows by 128 bytes of the row or the whole of N
    16's shorter row; gy contiguous.  bf16 calls take the wgmma instance
    on them, fp32 calls ssd.cu's."""
    b, S, H, P, N, _ = shape
    x, B, C = _mixer_views(b, S, H, P, N, dtype)
    assert B.stride(2) == 0 and C.stride(2) == 0
    gy = torch.empty(b, S, H, P, dtype=dtype, device="meta")
    item = 2
    for g, count in ((None, 3), (gy, 4)):
        routed = ssd.instance(x, B, C, 64, g)
        assert (routed is not None) == (dtype == torch.bfloat16)
        assert ssd.wgmma_at(dtype, P, N) == (dtype == torch.bfloat16)
        if routed is None:
            continue
        specs, bc_head = tma.ssd_maps(x, B, C, g)
        assert routed == (specs, bc_head)
        assert bc_head == 0 and len(specs) == 11 * count
        for i, t in enumerate((x, B, C, g)[:count]):
            dims, strides, box = _legal_ssd(specs[11 * i:11 * i + 11])
            D = t.shape[-1]
            heads = 1 if t.stride(2) == 0 else H
            assert dims == (D, heads, S, b)
            hstride = t.stride(2) or t.stride(1)
            assert strides == tuple(item * s for s in (hstride, t.stride(1),
                                                       t.stride(0)))
            assert box == (min(D, 128 // item), 1, 64, 1)
        assert specs[4 + 1] == (H * P + 2 * N) * item   # x's row: the conv row


def test_ssd_stride_zero_head_view_maps_its_group_tensor():
    """A head stride of 0 maps the group tensor [b, S, 1, N] underneath
    (bc_head 0); B and C per head map every head (bc_head 1); one of each
    takes the mma.sync instance."""
    bf16 = torch.bfloat16
    x = torch.empty(2, 1000, 50, 64, dtype=bf16, device="meta")
    grp = torch.empty(2, 1000, 1, 16, dtype=bf16, device="meta")
    B = grp.expand(2, 1000, 50, 16)
    per = torch.empty(2, 1000, 50, 16, dtype=bf16, device="meta")
    specs, bc = tma.ssd_maps(x, B, B)
    assert bc == 0 and specs[11:15] == (16, 1, 1000, 2)
    assert specs[15:18] == (32, 32, 32000)
    assert specs[18:22] == (16, 1, 64, 1)
    assert specs[11:22] == tma.ssd_map(grp.shape, grp.stride(), 0)
    specs, bc = tma.ssd_maps(x, per, per)
    assert bc == 1 and specs[11:15] == (16, 50, 1000, 2)
    assert tma.ssd_maps(x, B, per) is None


def test_ssd_takes_the_mma_instance_where_tma_cannot():
    """Rows of x not 16-byte aligned, a misaligned base, chunk 32, the
    reduced configs' (16, 16), a state size without an instance and fp32:
    no maps, ssd.cu's mma.sync instance."""
    for dtype in (torch.float32, torch.bfloat16):
        x, B, C = _mixer_views(1, 2048, 48, 64, 128, dtype)
        assert (ssd.instance(x, B, C, 64) is not None) == (
            dtype == torch.bfloat16)
        assert ssd.instance(x, B, C, 32) is None
        rows = torch.empty(1, 2048, 48 * 64 + 2, dtype=dtype, device="meta")
        xs = rows[..., :48 * 64].reshape(1, 2048, 48, 64)   # a row of 3074
        assert ssd.instance(xs, B, C, 64) is None
        x16, B16, C16 = _mixer_views(2, 300, 8, 16, 16, dtype)
        assert ssd.instance(x16, B16, C16, 64) is None
        x32, B32, C32 = _mixer_views(2, 300, 8, 64, 32, dtype)
        assert ssd.instance(x32, B32, C32, 64) is None
    shape, strides = (1, 2048, 48, 64), (2048 * 3328, 3328, 64, 1)
    assert tma.ssd_map(shape, strides, 0)
    assert tma.ssd_map(shape, strides, 8) is None
    assert tma._ssd_maps(((shape, strides, 0),))
    assert tma._ssd_maps(((shape, strides, 8),)) is None


def test_ssd_routes_where_the_wgmma_instance_measured_faster():
    """bf16 at both state sizes in both directions takes the wgmma
    instance; fp32 keeps ssd.cu's (its 3xTF32 wgmma instance measured
    slower in the backward and no faster end to end, PERF.md)."""
    for dtype in (torch.float32, torch.bfloat16):
        for N in (128, 16):
            x, B, C = _mixer_views(1, 2048, 24, 64, N, dtype)
            gy = torch.empty(1, 2048, 24, 64, dtype=dtype, device="meta")
            fwd = ssd.instance(x, B, C, 64) is not None
            bwd = ssd.instance(x, B, C, 64, gy) is not None
            bf16 = dtype == torch.bfloat16
            assert fwd == bf16 and bwd == bf16, (dtype, N)
