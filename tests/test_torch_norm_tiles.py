"""The backward norm kernel's launch configuration and its weight-gradient
summation order, on the CPU.

``kernels/fused.py::norm_bwd_config`` picks the row partition (rows per
block, rows a block runs side by side, warps a row), the copy width and
the registers a thread holds; the partition is a function of (M, d)
alone.  ``_rows`` mirrors the row kernel's index arithmetic
(csrc/fused.cu ``norm_bwd_resident`` / ``norm_bwd_looped``).  The tests
hold that the configuration is deterministic, that its blocks cover
every row exactly once, that it fills the card's 132 SMs at the paths'
shapes, that a thread's registers cover its share of the row, and that
16-byte copies are taken exactly where the width and the addresses
allow them.

The arithmetic test emulates the order in which the kernels sum dw in
numpy fp32: each row slot of a block adds gh.n over its rows in round
order, the block folds its slots in slot order into its partial row, and
``add_rmsnorm_bwd_dw_kernel`` gives each of 32 warps a contiguous 32nd
of the partial rows, summed in row order, then adds the 32 warp sums in
warp order.  That must hold chip_smoke.py's fp32 tolerance for dw
against ``ref.add_rmsnorm_bwd_ref`` at the paths' shapes."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import fused, ref

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
NORM_SHAPES = dict(CS.CARD_SHAPES["add_rmsnorm_bwd"])    # label -> (M, d)
#: the widths that reach the kernel (reduced configs, gpt3-medium and
#: its family, hymba, 2048-5120 up to qwen2.5-32b, ragged ones) and one
#: past the registers (the looped variant)
WIDTHS = (64, 130, 999, 1024, 1600, 2048, 2560, 3072, 4096, 5120, 8192,
          10000)
ALIGNED = (0, 4096, 8192, 12288, 16384)


def _rows(cfg, M):
    """Per block, per row slot, the rows that slot takes in round order
    (row0 + round.R + slot while below the block's end)."""
    out = []
    for b in range(cfg.blocks):
        row0 = b * cfg.rows_per_block
        row1 = min(row0 + cfg.rows_per_block, M)
        out.append([list(range(row0 + s, row1, cfg.rows_per_round))
                    for s in range(cfg.rows_per_round)])
    return out


@pytest.mark.parametrize("M", [1, 3, 7, 1000, 1024, 4096, 4099])
@pytest.mark.parametrize("d", WIDTHS)
def test_partition_is_a_function_of_the_shape_and_covers_every_row_once(M, d):
    cfgs = [fused.norm_bwd_config(M, d, size, addrs)
            for size in (4, 2) for addrs in (ALIGNED, (2, 4096, 0, 0, 0))]
    parts = {(c.rows_per_block, c.rows_per_round, c.warps_per_row, c.blocks)
             for c in cfgs}
    assert parts == {fused.norm_bwd_rows(M, d)}
    assert fused.norm_bwd_config(M, d, 4, ALIGNED) == cfgs[0]
    cfg = cfgs[0]
    assert cfg.rows_per_block % cfg.rows_per_round == 0
    assert cfg.rows_per_round * cfg.warps_per_row <= fused.NORM_MAX_WARPS
    rows = sorted(r for block in _rows(cfg, M) for slot in block for r in slot)
    assert rows == list(range(M))
    assert all(any(block) for block in _rows(cfg, M))     # no idle block


@pytest.mark.parametrize("label", ["flash", "naive"])
def test_partition_fills_the_sms_in_one_wave_at_the_path_shapes(label):
    M, d = NORM_SHAPES[label]
    cfg = fused.norm_bwd_config(M, d, 4, ALIGNED)
    warps = cfg.rows_per_round * cfg.warps_per_row
    assert cfg.blocks >= fused.GEMM_SMS
    assert cfg.blocks * warps <= fused.GEMM_SMS * fused.NORM_WARPS_PER_SM
    assert (cfg.rows_per_round, cfg.warps_per_row, cfg.chunks, cfg.vec) == (
        1, 4, 2, True)


@pytest.mark.parametrize("size", [4, 2])
@pytest.mark.parametrize("d", WIDTHS)
def test_registers_cover_a_row_and_copies_are_16_bytes_where_allowed(d, size):
    per = 16 // size
    for addrs in (ALIGNED, (8, 4096, 0, 0, 0), (0, 4096, 0, 0, 2 * size)):
        cfg = fused.norm_bwd_config(5, d, size, addrs)
        assert cfg.vec == (d % per == 0 and all(a % 16 == 0 for a in addrs))
        e = per if cfg.vec else 1
        one = 32 * fused.NORM_ELEMS * fused.NORM_MAX_WARPS  # 8 a thread
        if d > (2 * one if cfg.vec else one):
            assert cfg.chunks == 0 and cfg.rows_per_round == 1
            continue
        held = 32 * cfg.warps_per_row * cfg.chunks * e
        assert cfg.chunks & (cfg.chunks - 1) == 0
        assert cfg.chunks * e <= fused.NORM_ELEMS * (1 if d <= one else 2)
        assert held >= d and (cfg.chunks == 1 or held // 2 < d)


def _dw_in_kernel_order(cfg, M, gn):
    """dw as the kernels sum it: ``gn`` [M, d] fp32 holds gh.n."""
    gn = gn.astype(np.float32)
    partials = []
    for block in _rows(cfg, M):
        fold = None
        for slot in block:
            acc = np.zeros(gn.shape[1], np.float32)
            for r in slot:
                acc = acc + gn[r]
            fold = acc if fold is None else fold + acc
        partials.append(fold)
    P = len(partials)
    per = -(-P // 32)
    warp_sums = []
    for w in range(32):
        acc = np.zeros(gn.shape[1], np.float32)
        for q in range(w * per, min(P, (w + 1) * per)):
            acc = acc + partials[q]
        warp_sums.append(acc)
    out = warp_sums[0]
    for s in warp_sums[1:]:
        out = out + s
    return out


@pytest.mark.parametrize("label,shape", [
    *NORM_SHAPES.items(), ("qwen2.5-32b", (100, 5120)),
    ("looped", (40, 10000))])
def test_dw_summation_order_holds_the_fp32_tolerance(label, shape):
    """The kernels' order holds chip_smoke.py's fp32 dw tolerance; the
    same order with one block's partial row dropped fails it."""
    M, d = shape
    res, w, gres, gh = CS.make_inputs("add_rmsnorm_bwd", shape, torch.float32,
                                      torch.device("cpu"), seed=1)
    _, want = ref.add_rmsnorm_bwd_ref(res, w, gres, gh, eps=1e-6)
    res32 = res.numpy()
    rs = 1 / np.sqrt((res32 * res32).mean(-1, keepdims=True) + 1e-6)
    gn = gh.numpy() * (res32 * rs).astype(np.float32)
    cond = CS._conds("add_rmsnorm_bwd", (res, w, gres, gh), [None, want])[1]
    tol = CS.TOL_FP32["add_rmsnorm_bwd"][1]
    limit = tol["atol"] + tol["rtol"] * want.abs() + tol["ctol"] * cond
    cfg = fused.norm_bwd_config(M, d, 4, ALIGNED)
    got = torch.from_numpy(_dw_in_kernel_order(cfg, M, gn))
    assert ((got - want).abs() <= limit).all()
    last = cfg.rows_per_block * (cfg.blocks - 1)
    gn[last:] = 0
    dropped = torch.from_numpy(_dw_in_kernel_order(cfg, M, gn))
    assert not ((dropped - want).abs() <= limit).all()
