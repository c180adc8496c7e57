"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test asks for the ``card`` fixture, which skips
with a reason where PyTorch sees no CUDA device (a kernel written in
CUDA has no CPU mode).  On a machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances as chip_smoke.py states them: fp32 GEMM rtol = atol = 1e-4
(another summation order), fp32 norms rtol 1e-5 / atol 1e-6 (the weight
gradient, a sum over rows, against the sum of its terms' magnitudes),
bf16 2e-2."""
import pytest
import torch

from repro_torch.kernels import fused, ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from repro_torch.utils.device import strict_fp32_numerics
    strict_fp32_numerics()
    return torch.device("cuda")


def _tol(dtype, gemm=False):
    if dtype == torch.bfloat16:
        return dict(rtol=2e-2, atol=2e-2)
    return dict(rtol=1e-4, atol=1e-4) if gemm else dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,d", [(256, 1024), (1000, 999), (7, 40)])
def test_add_rmsnorm_kernels_match_plain(card, M, d, dtype):
    g = torch.Generator(device=card).manual_seed(0)
    x, r, gres, gh = (torch.randn(M, d, generator=g, device=card).to(dtype)
                      for _ in range(4))
    w = (torch.randn(d, generator=g, device=card) * 0.2 + 1).to(dtype)
    for a, b in zip(fused.add_rmsnorm_fwd(x, r, w, 1e-6),
                    ref.add_rmsnorm_ref(x, r, w)):
        torch.testing.assert_close(a, b, **_tol(dtype))
    res = x + r
    dres, dw = fused.add_rmsnorm_bwd(res, w, gres, gh, 1e-6)
    pres, pdw = ref.add_rmsnorm_bwd_ref(res, w, gres, gh)
    torch.testing.assert_close(dres, pres, **_tol(dtype))
    n = res.float() * (res.float().square().mean(-1, keepdim=True)
                       + 1e-6).rsqrt()
    scale = (gh.float().abs() * n.abs()).sum(0)
    tol = _tol(dtype)
    assert ((dw.float() - pdw.float()).abs()
            <= tol["atol"] + tol["rtol"] * scale).all()
    assert torch.equal(fused.add_rmsnorm_bwd(res, w, gres, gh, 1e-6)[0], dres)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(256, 1024, 3072), (1000, 999, 3000),
                                   (5, 7, 9)])
def test_gemm_kernel_all_layouts_match_plain(card, M, K, N, dtype):
    g = torch.Generator(device=card).manual_seed(1)
    x = torch.randn(M, K, generator=g, device=card).to(dtype)
    w = (torch.randn(K, N, generator=g, device=card) * K ** -0.5).to(dtype)
    gy = torch.randn(M, N, generator=g, device=card).to(dtype)
    b = torch.randn(N, generator=g, device=card).to(dtype)
    for a_, b_, bias in ((x, w, b), (gy, w.t(), None), (x.t(), gy, None)):
        got = fused.gemm_bias(a_, b_, bias)
        torch.testing.assert_close(got, ref.matmul_bias_ref(a_, b_, bias),
                                   **_tol(dtype, gemm=True))
        assert torch.equal(got, fused.gemm_bias(a_, b_, bias))


def test_fused_ops_gradients_match_plain_on_card(card):
    g = torch.Generator(device=card).manual_seed(2)
    x = torch.randn(2, 64, 128, generator=g, device=card)
    ws = [torch.randn(128, c, generator=g, device=card) * 128 ** -0.5
          for c in (128, 64, 64)]
    bs = [torch.randn(c, generator=g, device=card) for c in (128, 64, 64)]
    outs = {}
    for route in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (x, *ws, *bs)]
        fn = ops.fused_qkv if route == "kernel" else ref.qkv_ref
        q, k, v = fn(*leaves)
        res, h = (ops.fused_add_rmsnorm if route == "kernel"
                  else ref.add_rmsnorm_ref)(q, v.repeat(1, 1, 2),
                                            torch.ones(128, device=card))
        loss = (h * h).sum() + res.sum() + k.sum()
        outs[route] = torch.autograd.grad(loss, leaves)
    for a, b in zip(outs["kernel"], outs["plain"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_training_on_card_launches_every_kernel(card):
    from repro_torch.launch import train
    fused.reset_launches()
    out = train.main(["--steps", "3", "--kill-at", "1", "--layers", "2"])
    assert out["losses"][-1] < out["losses"][0]
    assert all(d == 0.0 for d in out["divergences"])
    assert all(n > 0 for n in fused.LAUNCHES.values()), fused.LAUNCHES
