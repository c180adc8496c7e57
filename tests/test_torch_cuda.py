"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test asks for the ``card`` fixture, which skips
with a reason where PyTorch sees no CUDA device (a kernel written in
CUDA has no CPU mode).  On a machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances as chip_smoke.py states them: fp32 GEMM rtol = atol = 1e-4
plus 1e-6 of its cond (another summation order; the GEMM tests at the
paths' shapes take chip_smoke.py's own comparison, the first, smaller
one rtol = atol = 1e-4 alone), fp32 norms rtol 1e-5 / atol 1e-6, fp32
flash out 1e-4, flash lse 1e-5, bf16 elementwise outputs 2e-2.  An output that
is a sum of many terms (the norm's weight gradient; the flash gradients,
and the flash out in bf16) is held against the sum of its terms'
magnitudes, ``cond``: fp32 1e-4 of cond (the norm's dw 1e-5); bf16 2e-2
of its value plus 1e-3 of cond, since its value is often only a few
percent of cond.  The SSD kernels are held by chip_smoke.py's own
comparison (every output against its cond, fp32 rtol 1e-4 plus 1e-5 of
cond)."""
import pytest
import torch

from repro_torch.kernels import build, flash, fused, ops, ref, ssd

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


def _sum_close(got, want, cond, fp32_ctol, fp32_atol):
    """|got - want| within the tolerance of an output that is a sum of
    many terms, ``cond`` being the sum of their magnitudes."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.bfloat16:
        limit = 1e-5 + 2e-2 * want.float().abs() + 1e-3 * cond
    else:
        limit = fp32_atol + fp32_ctol * cond
    assert ((got.float() - want.float()).abs() <= limit).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,d", [
    (256, 1024), (1000, 999), (7, 40),
    # the backward's rows: fewer than a block's (4 a round where d <=
    # 256) and not a multiple of them; the widths 64, 1600 (7 warps a
    # row), qwen2.5-32b's 5120 (10 warps a row, 16 elements a thread),
    # 130 (not a multiple of 4: one element a copy), 10000 and 5001 (the
    # looped variant: past 16 warps' registers; one element a copy past
    # 4096)
    (3, 64), (37, 1600), (9, 5120), (5, 130), (6, 10000), (4, 5001)])
def test_add_rmsnorm_kernels_match_plain(card, M, d, dtype):
    g = torch.Generator(device=card).manual_seed(0)
    x, r, gres, gh = (torch.randn(M, d, generator=g, device=card).to(dtype)
                      for _ in range(4))
    w = (torch.randn(d, generator=g, device=card) * 0.2 + 1).to(dtype)
    for a, b in zip(fused.add_rmsnorm_fwd(x, r, w, 1e-6),
                    ref.add_rmsnorm_ref(x, r, w)):
        torch.testing.assert_close(a, b, **_tol(dtype))
    res = x + r
    build.reset_launches()
    dres, dw = fused.add_rmsnorm_bwd(res, w, gres, gh, 1e-6)
    assert build.LAUNCHES["add_rmsnorm_bwd"] == 1, build.LAUNCHES
    pres, pdw = ref.add_rmsnorm_bwd_ref(res, w, gres, gh)
    torch.testing.assert_close(dres, pres, **_tol(dtype))
    n = res.float() * (res.float().square().mean(-1, keepdim=True)
                       + 1e-6).rsqrt()
    _sum_close(dw, pdw, (gh.float().abs() * n.abs()).sum(0), 1e-5, 1e-6)
    again = fused.add_rmsnorm_bwd(res, w, gres, gh, 1e-6)
    assert torch.equal(again[0], dres) and torch.equal(again[1], dw)
    assert build.LAUNCHES["add_rmsnorm_bwd"] == 2, build.LAUNCHES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_rmsnorm_bwd_unaligned_rows_match_plain(card, dtype):
    """res, gres and gh one element off a 16-byte boundary (views into
    a buffer, so the wrapper makes no copy) take the element copies
    instead of the 16-byte ones; chip_smoke.py's comparison, reruns
    bitwise equal."""
    cs = _chip_smoke()
    kern, plain, _ = cs.kernel_table(card)["add_rmsnorm_bwd"]
    args = list(cs.make_inputs("add_rmsnorm_bwd", (300, 1024), dtype, card,
                               seed=12))
    for i in (0, 2, 3):
        buf = torch.empty(args[i].numel() + 1, dtype=dtype, device=card)
        args[i] = buf[1:].view(args[i].shape).copy_(args[i])
    cfg = fused.norm_bwd_config(300, 1024, args[0].element_size(),
                                [t.data_ptr() for t in args])
    assert not cfg.vec and args[0].is_contiguous()
    cs.compare("add_rmsnorm_bwd", kern, plain, tuple(args), dtype)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["fwd", "dx", "dW"])
@pytest.mark.parametrize("label", ["flash", "naive"])
def test_gemm_kernel_at_path_shapes_matches_plain(card, label, layout, dtype):
    """The three products of the fused QKV at the flash and naive paths'
    shapes (the dW product sums K = 4096 at the flash shape, split in
    two), with chip_smoke.py's tolerance and its cond term; bitwise equal
    across two runs."""
    cs = _chip_smoke()
    kern, plain, _ = cs.kernel_table(card)["gemm_bias"]
    shape = dict(cs.CARD_SHAPES["gemm_bias"])[label]
    args = cs.make_inputs("gemm_bias", shape, dtype, card, seed=6,
                          layout=layout)
    cs.compare("gemm_bias", kern, plain, args, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_kernel_unaligned_operands_match_plain(card, dtype):
    """Operands whose base is one element off a 16-byte boundary, and a
    row stride of 1001 elements, take the element-copy instance."""
    cs = _chip_smoke()
    g = torch.Generator(device=card).manual_seed(7)
    x = torch.randn(300 * 512 + 1, generator=g, device=card).to(dtype)
    x = x[1:].view(300, 512)
    w = (torch.randn(512, 1001, generator=g, device=card) * 512 ** -0.5
         ).to(dtype)[:, :640]
    b = torch.randn(640, generator=g, device=card).to(dtype)
    cfg = fused.gemm_config(300, 640, 512, x.stride(), w.stride(),
                            x.data_ptr(), w.data_ptr(), x.element_size())
    assert not cfg.vec
    cs.compare("gemm_bias", fused.gemm_bias, ref.matmul_bias_ref, (x, w, b),
               dtype)


def test_gemm_launcher_refuses_an_unbuilt_tile(card):
    a = torch.zeros(64, 64, device=card)
    c = torch.empty(64, 64, device=card)
    with pytest.raises(RuntimeError, match="gemm_bias"):
        build.launch("gemm_bias", a.data_ptr(), a.data_ptr(), None,
                     c.data_ptr(), None, 64, 64, 64, 64, 1, 64, 1,
                     32, 32, 1, 64, 1, 0, 1, 0, build.current_stream(a))


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
    build.reset_launches()
    out = train.main(["--steps", "3", "--kill-at", "1", "--layers", "2"])
    assert out["losses"][-1] < out["losses"][0]
    assert all(d == 0.0 for d in out["divergences"])
    assert all(build.LAUNCHES[k] > 0 for k in
               ("add_rmsnorm_fwd", "add_rmsnorm_bwd", "gemm_bias")), build.LAUNCHES


def _flash_inputs(card, B, S, H, KV, D, dtype, seed=3):
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(B, S, H, D, generator=g, device=card).to(dtype)
    k, v = (torch.randn(B, S, KV, D, generator=g, device=card).to(dtype)
            for _ in range(2))
    return q, k, v, torch.randn(B, S, H, D, generator=g, device=card).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,D,window", [
    (2, 256, 4, 4, 64, 0), (1, 200, 8, 2, 128, 0), (2, 130, 5, 1, 32, 48),
    (1, 7, 2, 2, 64, 0)])
def test_flash_kernels_match_plain(card, B, S, H, KV, D, window, dtype):
    q, k, v, dout = _flash_inputs(card, B, S, H, KV, D, dtype)
    out, lse = flash.flash_fwd(q, k, v, window)
    pout, plse = ref.flash_fwd_ref(q, k, v, window=window)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    delta = ref.flash_delta(pout, dout)
    dq = flash.flash_bwd_dq(q, k, v, dout, plse, delta, window)
    dk, dv = flash.flash_bwd_dkdv(q, k, v, dout, plse, delta, window)
    p, ds = ref.flash_bwd_terms(q, k, v, plse, dout, delta, window=window)
    if dtype == torch.bfloat16:
        _sum_close(out, pout, torch.einsum("bkgqs,bskd->bqkgd", p,
                                           v.float().abs()).reshape(q.shape),
                   None, None)
    else:
        torch.testing.assert_close(out, pout, rtol=1e-4, atol=1e-4)
    want = ref.flash_bwd_ref(q, k, v, None, plse, dout, window=window,
                             delta=delta)
    grouped = lambda t: t.float().abs().reshape(B, S, KV, H // KV, D)  # noqa: E731
    scales = (torch.einsum("bkgqs,bskd->bqkgd", ds.abs(), k.float().abs()
                           ).reshape(B, S, H, D),
              torch.einsum("bkgqs,bqkgd->bskd", ds.abs(), grouped(q)),
              torch.einsum("bkgqs,bqkgd->bskd", p, grouped(dout)))
    for got, exp, scale in zip((dq, dk, dv), want, scales):
        _sum_close(got, exp, scale, 1e-4, 1e-4)
    assert torch.equal(flash.flash_bwd_dkdv(q, k, v, dout, plse, delta,
                                            window)[0], dk)
    assert torch.equal(flash.flash_fwd(q, k, v, window)[0], out)


#: the three flash kernels, all on the tensor cores
TENSOR_CORE_FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 2048, 16, 16, 64, 0), (2, 300, 8, 2, 32, 0), (1, 200, 8, 2, 128, 0),
    (2, 257, 10, 2, 64, 96), (1, 130, 4, 1, 128, 40),
    (2, 300, 4, 4, 16, 0), (1, 1000, 32, 32, 80, 0), (2, 257, 8, 2, 80, 96),
    (1, 300, 8, 2, 96, 0), (2, 130, 4, 1, 96, 40), (1, 130, 6, 2, 16, 50)],
    ids=["flash-path", "gqa-d32", "gqa-d128", "window-d64", "window-d128",
         "d16", "d80-gpt3-2.7b", "window-d80", "gqa-d96", "window-d96",
         "window-d16"])
@pytest.mark.parametrize("name", TENSOR_CORE_FLASH)
def test_flash_tensor_core_kernel_matches_plain(card, name, shape, dtype):
    """Each tensor-core flash kernel against its plain version with
    chip_smoke.py's condition-aware tolerances, at head dims 16, 32, 64,
    80, 96 and 128, with grouped query heads and a sliding window; bitwise
    equal across two runs."""
    cs = _chip_smoke()
    kern, plain, _ = cs.kernel_table(card)[name]
    args = cs.make_inputs(name, shape, dtype, card, seed=8)
    cs.compare(name, kern, plain, args, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", TENSOR_CORE_FLASH)
def test_flash_tensor_core_kernel_unaligned_rows_match_plain(card, name,
                                                             dtype):
    """Operands one element off a 16-byte boundary take the kernels'
    element copies instead of their 16-byte cp.async ones."""
    cs = _chip_smoke()
    kern, plain, _ = cs.kernel_table(card)[name]
    args = cs.make_inputs(name, (1, 130, 4, 2, 64, 0), dtype, card, seed=9)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out
    n = 3 if name == "flash_fwd" else 4      # q, k, v (and dO)
    args = tuple(shifted(a) if i < n else a for i, a in enumerate(args))
    assert args[0].data_ptr() % 16 != 0
    cs.compare(name, kern, plain, args, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 300, 8, 2, 64, 0, 700), (1, 130, 4, 1, 128, 40, 300),
    (2, 64, 8, 8, 16, 0, 1000), (1, 1, 4, 2, 64, 0, 77),
    (1, 200, 10, 2, 80, 96, 1000), (1, 257, 8, 2, 32, 0, 257)],
    ids=["gqa-d64", "window-d128", "d16-far", "one-query", "window-d80-far",
         "sq-eq-sk"])
@pytest.mark.parametrize("name", TENSOR_CORE_FLASH)
def test_flash_kernels_take_fewer_queries_than_keys(card, name, shape,
                                                    dtype):
    """Queries the last Sq of Sk positions, at offsets that are not a
    multiple of the tiles and with windows that leave kv blocks no query
    sees (dk and dv zero there): each built tile against its plain
    version with chip_smoke.py's comparison."""
    cs = _chip_smoke()
    _, plain, _ = cs.kernel_table(card)[name]
    args = cs.make_inputs(name, shape, dtype, card, seed=10)
    for _, kern, _, _ in cs.variants(name, args, dtype, card):
        cs.compare(name, kern, plain, args, dtype)


def test_flash_wrappers_refuse_more_queries_than_keys(card):
    q, k, v, _ = _flash_inputs(card, 1, 64, 2, 2, 64, torch.float32)
    with pytest.raises(ValueError):
        flash.flash_fwd(q, k[:, :32], v[:, :32])


def test_flash_wrappers_refuse_other_head_dims(card):
    q, k, v, _ = _flash_inputs(card, 1, 64, 2, 2, 48, torch.float32)
    with pytest.raises(ValueError):
        flash.flash_fwd(q, k, v)


def test_flash_attention_gradients_match_plain_on_card(card):
    q, k, v, dout = _flash_inputs(card, 2, 300, 8, 2, 64, torch.float32)
    grads = {}
    for route in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = (ops.flash_attention(*leaves, window=100) if route == "kernel"
               else ref.attention_ref(*leaves, window=100))
        grads[route] = (out, *torch.autograd.grad(out, leaves, dout))
    for a, b in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch_name", ["gpt3_medium", "qwen2_5_3b"])
def test_flash_model_matches_naive_on_card(card, arch_name):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import Model
    from repro_torch.utils.tree import tree_leaves, tree_unflatten_like
    arch = reduced(get_arch(arch_name), layers=2)   # d_model 64: head dim 16
    g = torch.Generator(device=card).manual_seed(4)
    batch = {key: torch.randint(0, arch.vocab_size, (2, 200), generator=g,
                                device=card) for key in ("tokens", "labels")}
    params = Model(arch, dtype=torch.float32).init(
        torch.Generator(device=card).manual_seed(0))
    out = {}
    build.reset_launches()
    for impl in ("kernel", "naive"):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in tree_leaves(params)]
        # no remat: each kernel launches once per layer in forward
        model = Model(arch, dtype=torch.float32, attn_impl=impl, remat=False)
        loss, _ = model.loss(tree_unflatten_like(params, leaves), batch)
        out[impl] = (loss, torch.autograd.grad(loss, leaves))
    assert all(build.LAUNCHES[k] == 2 for k in
               ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")), build.LAUNCHES
    torch.testing.assert_close(out["kernel"][0], out["naive"][0],
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(out["kernel"][1], out["naive"][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (1, 1000, 6, 64, 128, True), (2, 1000, 50, 64, 16, True),
    (2, 300, 8, 16, 16, False), (1, 7, 2, 16, 16, False),
    (1, 4000, 3, 64, 128, True), (2, 2500, 2, 64, 16, False),
    (2, 1000, 4, 16, 16, True)],
    ids=["mamba-heads", "hymba", "reduced", "short", "many-chunks-b1",
         "many-chunks-b2", "many-chunks-reduced-b2"])
def test_ssd_kernels_match_plain(card, shape, dtype):
    """Both SSD kernels against their plain versions with chip_smoke.py's
    condition-aware tolerances (fp32: rtol 1e-4 plus 1e-5 of the sum of
    the terms' magnitudes; bf16 outputs 2e-2 plus 1e-3 of it), bitwise
    equal across two runs."""
    cs = _chip_smoke()
    table = cs.kernel_table(card)
    for name in ("ssd_fwd", "ssd_bwd"):
        kern, plain, _ = table[name]
        args = cs.make_inputs(name, shape, dtype, card, seed=5)
        cs.compare(name, kern, plain, args, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernels_rerun_bitwise_and_count_one_launch(card, dtype):
    """At chip_smoke.py's mamba shape (32 chunks, 48 heads, B and C one
    group): three calls of each SSD wrapper give bitwise-equal outputs,
    and each call counts one launch of the instance it runs (its three
    phases are one entry point): the wgmma one in bf16, ssd.cu's in
    fp32."""
    cs = _chip_smoke()
    table = cs.kernel_table(card)
    shape = dict(cs.CARD_SHAPES["ssd"])["mamba"]
    for name in ("ssd_fwd", "ssd_bwd"):
        kern = table[name][0]
        args = cs.make_inputs(name, shape, dtype, card, seed=10)
        build.reset_launches()
        runs = [kern(*args) for _ in range(3)]
        ran = name + "_wgmma" if cs.takes_wgmma(name, args) else name
        assert ran.endswith("_wgmma") == ssd.wgmma_at(dtype, 64, 128)
        assert build.LAUNCHES[ran] == 3, build.LAUNCHES
        assert sum(build.LAUNCHES[k] for k in (name, name + "_wgmma")) == 3
        for again in runs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(runs[0], again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernels_unaligned_rows_match_plain(card, dtype):
    """x, B, C (and gy) one element off a 16-byte boundary take the
    kernels' element copies instead of their 16-byte cp.async ones."""
    cs = _chip_smoke()
    table = cs.kernel_table(card)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out
    for name in ("ssd_fwd", "ssd_bwd"):
        kern, plain, _ = table[name]
        args = list(cs.make_inputs(name, (2, 300, 3, 64, 16, False), dtype,
                                   card, seed=11))
        for i in (0, 3, 4) + ((6,) if name == "ssd_bwd" else ()):
            args[i] = shifted(args[i])
        assert args[0].data_ptr() % 16 != 0
        cs.compare(name, kern, plain, tuple(args), dtype)


def test_ssd_wrappers_refuse_other_shapes(card):
    x = torch.zeros(1, 8, 2, 32, device=card)
    dt = torch.zeros(1, 8, 2, device=card)
    A = torch.zeros(2, device=card)
    B = torch.zeros(1, 8, 2, 16, device=card)
    with pytest.raises(ValueError):
        ssd.ssd_fwd(x, dt, A, B, B)
    with pytest.raises(ValueError):
        ssd.ssd_fwd(x[..., :16], dt.double(), A, B, B)


def test_ssd_gradients_match_autograd_on_card(card):
    """ops.ssd (both kernels) against autograd through the per-timestep
    oracle, B and C one group expanded over the heads: 2e-4 relative to
    each output's largest entry (the reference's own oracle tolerance)."""
    g = torch.Generator(device=card).manual_seed(6)
    b, S, H, P, N = 2, 150, 4, 64, 16
    x = torch.randn(b, S, H, P, generator=g, device=card)
    dt = torch.nn.functional.softplus(
        torch.randn(b, S, H, generator=g, device=card) - 3.0)
    A = -torch.exp(torch.randn(H, generator=g, device=card) * 0.5)
    Bg, Cg = (torch.randn(b, S, 1, N, generator=g, device=card)
              for _ in range(2))
    gy = torch.randn(b, S, H, P, generator=g, device=card)
    outs = {}
    for route in ("kernel", "oracle"):
        leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, Bg, Cg)]
        xx, dd, AA, BB, CC = leaves
        BB, CC = BB.expand(b, S, H, N), CC.expand(b, S, H, N)
        fn = ops.ssd if route == "kernel" else ref.ssd_ref
        y, _ = fn(xx, dd, AA, BB, CC)
        outs[route] = (y, *torch.autograd.grad(y, leaves, gy))
    for a, b_ in zip(outs["kernel"], outs["oracle"]):
        scale = float(b_.abs().max())
        torch.testing.assert_close(a, b_, rtol=0, atol=2e-4 * scale)


def test_ssm_models_match_plain_on_card(card):
    """Reduced mamba2 through the SSD kernels against the chunked scan in
    plain ops: loss to 1e-5, gradients to 1e-4; every SSD launch counted
    (one per layer)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import Model
    from repro_torch.utils.tree import tree_leaves, tree_unflatten_like
    arch = reduced(get_arch("mamba2_780m"), layers=2, d_model=128)
    g = torch.Generator(device=card).manual_seed(7)
    batch = {key: torch.randint(0, arch.vocab_size, (2, 200), generator=g,
                                device=card) for key in ("tokens", "labels")}
    params = Model(arch, dtype=torch.float32).init(
        torch.Generator(device=card).manual_seed(0))
    out = {}
    build.reset_launches()
    for impl in ("kernel", "chunked"):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in tree_leaves(params)]
        model = Model(arch, dtype=torch.float32, ssd_impl=impl, remat=False)
        loss, _ = model.loss(tree_unflatten_like(params, leaves), batch)
        out[impl] = (loss, torch.autograd.grad(loss, leaves))
    assert build.LAUNCHES["ssd_fwd"] == build.LAUNCHES["ssd_bwd"] == 2
    torch.testing.assert_close(out["kernel"][0], out["chunked"][0],
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(out["kernel"][1], out["chunked"][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------------
# The lifecycle on the card: checkpoints, the eager walker, no host reads
# ----------------------------------------------------------------------
def _card_trainer(card, mode="compiled", params=None, opt_state=None):
    """Reduced gpt3-medium (2 layers, head dim 16) through the flash and
    fused kernels on a 5-node engine, f 1, n0 2."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core import EngineConfig, OobleckEngine, build_profile
    from repro_torch.data import GlobalBatchDispenser, SyntheticLM
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime import HeteroTrainer
    arch = reduced(get_arch("gpt3_medium"), layers=2)
    model = Model(arch, dtype=torch.float32, attn_impl="kernel")
    if params is None:
        params = model.init(torch.Generator(device=card).manual_seed(0))
    engine = OobleckEngine(
        build_profile(arch, microbatch=2, seq_len=64),
        [f"n{i}" for i in range(5)],
        EngineConfig(fault_tolerance=1, global_batch=16, microbatch=2,
                     gpus_per_node=1, n0_override=2))
    tr = HeteroTrainer(model, engine, params, adamw.AdamWConfig(
        lr=1e-3, warmup_steps=0, clip_norm=1.0, weight_decay=0.0),
        mode=mode, opt_state=opt_state)
    disp = GlobalBatchDispenser(SyntheticLM(arch.vocab_size, 64, seed=5))
    return arch, tr, disp


def _drive(tr, disp):
    batches = disp.next_step(tr.engine.batch.minibatch_sizes())
    return tr.train_step([[{k: v[i:i + 2] for k, v in b.items()
                            if not k.startswith("_")}
                           for i in range(0, b["tokens"].shape[0], 2)]
                          for b in batches])


def test_checkpoint_roundtrip_of_cuda_state_is_bitwise(card, tmp_path):
    """A trained state on the card, saved asynchronously while the next
    step runs, restores onto the card bit for bit: params, both moments
    and the step; a trainer built from it has the same content hashes."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.utils.tree import tree_leaves
    arch, tr, disp = _card_trainer(card)
    for _ in range(2):
        _drive(tr, disp)
    snap = tr.snapshot(disp.state(), 3)
    mgr = CheckpointManager(str(tmp_path), num_layers=arch.num_layers)
    mgr.save(snap)
    _drive(tr, disp)                        # the next step overlaps the write
    mgr.wait()
    got = mgr.restore(snap.params, snap.opt_state, device=card)
    assert got.step == 2 and got.data_state == snap.data_state
    for a, b in zip(tree_leaves((snap.params, snap.opt_state)),
                    tree_leaves((got.params, got.opt_state))):
        assert b.device.type == "cuda" and torch.equal(a, b)
    _, tr2, _ = _card_trainer(card, params=got.params,
                              opt_state=got.opt_state)
    assert mgr.hashes(tr2.snapshot(snap.data_state, 3)) == mgr.hashes(snap)


def test_eager_walker_matches_compiled_on_card(card):
    """The 1F1B walker against the step programs through a failure, with
    every flash and fused kernel in both: per-microbatch NLL, losses and
    parameters bitwise equal (the kernels use fixed summation orders and
    no atomics, and the walker keeps the programs' order)."""
    from repro_torch.utils.tree import tree_leaves
    _, tc, dc = _card_trainer(card)
    _, te, de = _card_trainer(card, mode="eager")
    build.reset_launches()
    for step in range(3):
        if step == 2:
            victim = tc.engine.instances[0].nodes[0]
            tc.recover({victim})
            te.recover({victim})
        assert torch.equal(_drive(tc, dc)["loss"], _drive(te, de)["loss"])
    assert all(build.LAUNCHES[k] > 0 for k in build.LAUNCHES
               if not k.startswith("ssd") and not k.endswith("_wgmma")
               ), build.LAUNCHES
    for a, b in zip(tree_leaves(tc.full_params()),
                    tree_leaves(te.full_params())):
        assert torch.equal(a, b)
    assert tc.replica_divergence() == te.replica_divergence() == 0.0


@pytest.mark.parametrize("mode", ["compiled", "eager"])
def test_train_step_reads_nothing_back_on_card(card, mode):
    """Under set_sync_debug_mode("error") (which turns any synchronizing
    CUDA call into an error) a train step runs through and the spies
    count no device->host read; the control shows both guards fire."""
    from repro_torch.runtime import track_host_transfers
    _, tr, disp = _card_trainer(card, mode=mode)
    _drive(tr, disp)
    with pytest.raises(RuntimeError):
        with track_host_transfers(card) as ctl:
            (torch.ones((), device=card) + 1).item()
    assert ctl.device_to_host == 1
    assert torch.cuda.get_sync_debug_mode() == 0      # restored
    with track_host_transfers(card) as log:
        out = _drive(tr, disp)
    assert log.device_to_host == 0, log
    assert float(out["loss"]) > 0


# ----------------------------------------------------------------------
# MoE, remat, the chunked CE and decode with the kernels inside
# ----------------------------------------------------------------------
def _small(name):
    from repro_torch.configs import get_arch, reduced
    return reduced(get_arch(name), layers=2, d_model=128, vocab=512)


KERN = dict(attn_impl="kernel", fuse="fused", ssd_impl="kernel")
PLAIN = dict(attn_impl="naive", fuse="none", ssd_impl="chunked")


def _assert_same_training(card, arch, through, plain, seq=200):
    """chip_smoke.py phase 5's comparison: loss to 1e-5 relative,
    gradients to 1e-4 absolute."""
    cs = _chip_smoke()
    lk, gk = cs._loss_and_grads(card, arch, seq, **through)
    ln, gn = cs._loss_and_grads(card, arch, seq, **plain)
    torch.testing.assert_close(lk, ln, rtol=1e-5, atol=1e-6)
    for a, b in zip(gk, gn):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch_name", ["granite_moe_1b_a400m",
                                       "qwen2_moe_a2_7b"])
def test_moe_models_match_plain_on_card(card, arch_name):
    """Reduced granite-moe and qwen2-moe (shared expert, QKV bias)
    through every kernel (no remat: each launches once per layer)
    against plain ops."""
    build.reset_launches()
    _assert_same_training(card, _small(arch_name), dict(KERN, remat=False),
                          dict(PLAIN, remat=False))
    assert all(build.LAUNCHES[k] == 2 for k in
               ("add_rmsnorm_fwd", "add_rmsnorm_bwd", "flash_fwd",
                "flash_bwd_dq", "flash_bwd_dkdv")), build.LAUNCHES
    assert build.LAUNCHES["gemm_bias"] == 6, build.LAUNCHES


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch_name", ["granite_moe_1b_a400m", "hymba_1_5b"])
def test_remat_recomputes_the_kernels_correctly_on_card(card, arch_name,
                                                        policy):
    """Under remat the kernels' autograd Functions run again in backward:
    the forward kernels launch twice a layer, the backward ones once,
    and loss and gradients match no remat."""
    build.reset_launches()
    _assert_same_training(card, _small(arch_name),
                          dict(KERN, remat=True, remat_policy=policy),
                          dict(KERN, remat=False))
    assert build.LAUNCHES["add_rmsnorm_fwd"] == 2 + 2 * 2, build.LAUNCHES
    assert build.LAUNCHES["add_rmsnorm_bwd"] == 2 + 2, build.LAUNCHES


def test_loss_chunk_with_kernels_matches_whole_ce_on_card(card):
    _assert_same_training(card, _small("granite_moe_1b_a400m"),
                          dict(KERN, loss_chunk=64), KERN)


@pytest.mark.parametrize("arch_name", ["granite_moe_1b_a400m", "hymba_1_5b"])
def test_decode_matches_the_kernels_forward_on_card(card, arch_name):
    """chip_smoke.py's decode check: 40 positions one at a time against
    the forward through the kernels (hymba's window cut to 16, so the
    ring buffer wraps), logits to 1e-5."""
    import dataclasses
    arch = _small(arch_name)
    if arch.sliding_window:
        arch = dataclasses.replace(arch, sliding_window=16)
    assert _chip_smoke().decode_gap(card, arch) <= 1e-5


def test_eager_walker_carries_the_aux_gradient_on_card(card):
    """Reduced granite-moe on the card: the 1F1B walker hands each
    router's aux cotangent across stage boundaries; its per-layer
    gradients match the step program's at the executor's fp32 tolerance
    (atol 5e-7, rtol 5e-4)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core import EngineConfig, OobleckEngine, build_profile
    from repro_torch.data import GlobalBatchDispenser, SyntheticLM
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime import HeteroTrainer
    from repro_torch.utils.tree import tree_leaves
    arch = reduced(get_arch("granite_moe_1b_a400m"), layers=4)
    model = Model(arch, dtype=torch.float32, attn_impl="kernel")
    params = model.init(torch.Generator(device=card).manual_seed(0))
    trainers = []
    for mode in ("compiled", "eager"):
        engine = OobleckEngine(
            build_profile(arch, microbatch=2, seq_len=64),
            [f"n{i}" for i in range(5)],
            EngineConfig(fault_tolerance=1, global_batch=16, microbatch=2,
                         gpus_per_node=1, n0_override=2))
        trainers.append(HeteroTrainer(
            model, engine, params, adamw.AdamWConfig(lr=1e-3, warmup_steps=0),
            mode=mode, sync_mode="perlayer"))
    tc, te = trainers
    assert max(r.num_stages for r in te.runs) >= 2
    disp = GlobalBatchDispenser(SyntheticLM(arch.vocab_size, 64, seed=5))
    batches = disp.next_step(tc.engine.batch.minibatch_sizes())
    for rc, re_, b in zip(tc.runs, te.runs, batches):
        mbs = [{k: v[i:i + 2] for k, v in b.items() if not k.startswith("_")}
               for i in range(0, b["tokens"].shape[0], 2)]
        gc, nc = tc._run_pipeline(rc, mbs)
        ge, ne = te._run_pipeline(re_, mbs)
        torch.testing.assert_close(ne, nc, rtol=5e-4, atol=5e-7)
        for l in gc:
            for a, b_ in zip(tree_leaves(gc[l]), tree_leaves(ge[l])):
                torch.testing.assert_close(b_, a, rtol=5e-4, atol=5e-7)


# ----------------------------------------------------------------------
# Serving (runtime/serve_exec.py): no kernel on the path
# ----------------------------------------------------------------------
def _serve_executor(card, arch_name, temperature, params=None):
    from repro_torch.launch.serve import build_serving_engine
    from repro_torch.models import Model
    from repro_torch.runtime.serve_exec import SamplingParams, ServeExecutor
    from repro_torch.utils import prng
    arch = _small(arch_name)
    model = Model(arch, dtype=torch.float32, remat=False)
    if params is None:
        params = model.init(torch.Generator(device=card).manual_seed(0))
    engine = build_serving_engine(arch, nodes=[f"node{i}" for i in range(6)])
    return ServeExecutor(model, params, engine, num_slots=2, max_len=24,
                         max_new_cap=8,
                         sampling=SamplingParams(temperature=temperature),
                         sample_key=prng.prng_key(42, card))


def _serve_prompts(n, vocab=512):
    import numpy as np
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, 9).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("arch_name", ["qwen3_1_7b", "mamba2_780m"])
def test_serving_through_a_failure_is_bitwise_on_card(card, arch_name,
                                                      temperature):
    """Reduced qwen3 and mamba2 on the card: a node killed after two
    ticks builds nothing, moves at least one request, launches no kernel
    and leaves every stream bitwise equal to the unfailed run's."""
    import numpy as np
    from repro_torch.runtime import track_compiles
    streams = []
    for fail in (False, True):
        ex = _serve_executor(card, arch_name, temperature)
        for p in _serve_prompts(6):
            ex.submit(p, max_new=6)
        ex.tick()
        ex.tick()
        build.reset_launches()
        with track_compiles() as log:
            if fail:
                victim = ex.engine.instances[0].nodes[0]
                ex.engine.monitor.inject("fail", [victim])
                ex.engine.monitor.poll(0.0)
            ex.drain()
        assert log.backend_compiles == 0
        assert not any(build.LAUNCHES.values()), build.LAUNCHES
        assert len(ex.completed) == 6
        if fail:
            rec = ex.last_recovery
            assert rec["replayed"] + rec["migrated"] >= 1, rec
        streams.append({r.rid: r.tokens for r in ex.completed})
    for rid, toks in streams[0].items():
        np.testing.assert_array_equal(streams[1][rid], toks)


@pytest.mark.parametrize("arch_name", ["qwen3_1_7b", "mamba2_780m",
                                       "hymba_1_5b"])
def test_serving_decode_ticks_read_nothing_back_on_card(card, arch_name):
    """Two pure decode ticks (no admission, no request finishing) under
    set_sync_debug_mode("error"): no synchronizing CUDA call, no read."""
    from repro_torch.runtime import track_host_transfers
    ex = _serve_executor(card, arch_name, 0.8)
    for p in _serve_prompts(4):
        ex.submit(p, max_new=8)
    ex.tick()
    ex.synchronize()
    with track_host_transfers(card) as log:
        ex.tick()
        ex.tick()
    assert log.device_to_host == 0, log
    ex.drain()
    assert all(len(r.tokens) == 8 for r in ex.completed)


def test_serving_on_card_equals_serving_on_cpu(card):
    """The same weights, prompts and key on the card and on the CPU give
    the same streams at T 0.8: the sampler's keys and bits are integer
    arithmetic, bitwise equal on both; the noise and logits differ by
    rounding only, far below the gap between the two largest perturbed
    logits (the top two of a Gumbel sample lie an Exp(1) apart)."""
    import numpy as np
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_map
    ex = _serve_executor(card, "qwen3_1_7b", 0.8)
    cpu = _serve_executor(torch.device("cpu"), "qwen3_1_7b", 0.8,
                          params=tree_map(lambda t: t.cpu(), ex.params))
    out = []
    for e in (ex, cpu):
        for p in _serve_prompts(4):
            e.submit(p, max_new=6)
        e.drain()
        out.append({r.rid: r.tokens for r in e.completed})
    keys = torch.stack([cpu._base_key(rid) for rid in sorted(out[1])])
    assert torch.equal(
        torch.stack([ex._base_key(rid) for rid in sorted(out[0])]).cpu(),
        keys)
    bits = prng.random_bits(keys.to(card), 512)
    assert torch.equal(bits.cpu(), prng.random_bits(keys, 512))
    for rid, toks in out[1].items():
        np.testing.assert_array_equal(out[0][rid], toks)


def test_multihost_workers_on_card_are_bitwise_through_a_sigkill(card):
    """Two worker processes on the card (reduced gpt3-medium, the flash
    and fused kernels): each step's loss and grad norm bitwise equal to
    the single-process trainer's on the card, through a SIGKILL of the
    rank that leads replica 1 (the mid-step kill of
    tests/test_multihost.py's conformance run) and the recovery; no
    build on the survivor, every flash and fused kernel launched by the
    workers and none by the coordinator."""
    from repro_torch.data import GlobalBatchDispenser, SyntheticLM
    from repro_torch.runtime import HeteroTrainer, WorkerLost
    from repro_torch.runtime.multihost import (MultiHostExecutor,
                                               build_setup, make_job_spec)
    mb = 2
    # 6 nodes: three 2-node replicas, rank 1 leads the third; killing it
    # leaves 4 nodes, the (f+1)*n0 floor
    spec = make_job_spec(arch="gpt3_medium", layers=4, seq_len=64,
                         microbatch=mb, global_batch=16, f=1, n0=2,
                         nodes=[f"n{i}" for i in range(6)],
                         hosting={"n0": 0, "n1": 0, "n2": 0, "n3": 0,
                                  "n4": 1, "n5": 1},
                         procs=2, seed=3, device="cuda", attn_impl="kernel")
    model, params, _, opt_cfg, engine = build_setup(spec)
    ref = HeteroTrainer(model, engine, params, opt_cfg)
    src = SyntheticLM(model.arch.vocab_size, 64, seed=5)
    d_ref, d_mh = GlobalBatchDispenser(src), GlobalBatchDispenser(src)

    def feed(disp, eng):
        out = []
        for b in disp.next_step(eng.batch.minibatch_sizes()):
            n = b["tokens"].shape[0] // mb
            out.append([{k: v[i * mb:(i + 1) * mb] for k, v in b.items()
                         if not k.startswith("_")} for i in range(n)])
        return out
    build.reset_launches()
    with MultiHostExecutor(spec, rpc_timeout=300.0) as mh:
        mh.warm_templates()
        for step in range(4):
            if step == 2:
                batches = feed(d_mh, mh.engine)
                feed(d_ref, ref.engine)
                mh.kill_worker(1)
                with pytest.raises(WorkerLost):
                    mh.step(batches)            # the iteration is lost
                dead, _ = mh.detected_dead(timeout=30.0)
                assert dead == {"n4", "n5"}
                mh.recover(dead)
                ref.recover(dead)
            o_ref = ref.step(feed(d_ref, ref.engine))
            before = dict(build.LAUNCHES)
            o_mh = mh.step(feed(d_mh, mh.engine))
            assert build.LAUNCHES == before     # the coordinator launches none
            for key in ("loss", "grad_norm"):
                assert torch.equal(o_ref[key], o_mh[key]), (step, key)
        counts = mh.worker_counts()
        assert {r: c["since_mark"] for r, c in counts.items()} == {0: 0}
        assert mh.replica_divergence() == 0
    launched = counts[0]["launches"]
    assert all(launched[k] > 0 for k in launched
               if not k.startswith("ssd") and not k.endswith("_wgmma")
               ), launched


def test_spmd_executor_with_kernels_tracks_plain_cpu(card):
    """SPMDExecutor on reduced gpt3-medium (2 layers) through the flash
    and fused kernels, remat full and the chunked CE, against the same
    executor on the CPU's plain versions: three steps' losses and the
    parameters at tests/test_executor.py's fp32 tolerance (atol 5e-7,
    rtol 5e-4; parameters by its tracking rule), one build, every
    kernel launched, and recover raising ExecutorUnsupported."""
    import numpy as np
    from repro_torch.configs import ShapeConfig, get_arch, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime import ExecutorUnsupported, SPMDExecutor
    from repro_torch.utils.tree import tree_leaves, tree_map
    arch = reduced(get_arch("gpt3_medium"), layers=2)
    model = Model(arch, dtype=torch.float32, attn_impl="kernel",
                  fuse="fused", remat=True, loss_chunk=16)
    lr = 1e-3
    opt = adamw.AdamWConfig(lr=lr, warmup_steps=0, clip_norm=1.0,
                            weight_decay=0.0)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    shape = ShapeConfig("t", 64, 8, "train")
    gpu = SPMDExecutor(model, params, opt, shape=shape)
    cpu = SPMDExecutor(model, tree_map(lambda t: t.cpu(), params), opt,
                       shape=shape)
    src = SyntheticLM(arch.vocab_size, 64, seed=5)
    build.reset_launches()
    for step in range(3):
        batch = src.batch(np.arange(8 * step, 8 * step + 8))
        lg, lc = gpu.step(batch)["loss"], cpu.step(batch)["loss"]
        torch.testing.assert_close(lg.cpu(), lc, rtol=5e-4, atol=5e-7)
    assert all(build.LAUNCHES[k] > 0 for k in build.LAUNCHES
               if not k.startswith("ssd") and not k.endswith("_wgmma")
               ), build.LAUNCHES
    for a, b in zip(tree_leaves(gpu.params), tree_leaves(cpu.params)):
        diff = (a.cpu() - b).abs()
        assert diff.max() <= 2.5 * lr, diff.max()
        assert (diff > lr / 10).float().mean() < 1e-3
    assert gpu.cache.stats.compiles == 1
    with pytest.raises(ExecutorUnsupported):
        gpu.recover({"n0"})


def mesh_rank_on_card(params_np, batches):
    """A rank of the card's 2 x 2 mesh (run by ``spawn_world``)."""
    from repro_torch.configs import ShapeConfig, get_arch, reduced
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import ProcessMesh, init_world
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime import ShardingStrategy, SPMDExecutor
    from repro_torch.runtime.sharding import gather_tree
    from repro_torch.utils.device import strict_fp32_numerics
    from repro_torch.utils.tree import tree_map
    dev = init_world("cuda")
    strict_fp32_numerics()
    mesh = ProcessMesh(("data", "model"), (2, 2))
    model = Model(reduced(get_arch("gpt3_medium"), layers=2),
                  dtype=torch.float32, attn_impl="kernel", fuse="fused",
                  remat=True, loss_chunk=16)
    ex = SPMDExecutor(model, params_from_numpy(params_np, dev),
                      adamw.AdamWConfig(lr=1e-3, warmup_steps=0,
                                        clip_norm=1.0, weight_decay=0.0),
                      mesh=mesh, strategy=ShardingStrategy(),
                      shape=ShapeConfig("t", 64, 8, "train"))
    build.reset_launches()
    losses = [float(ex.step(b)["loss"]) for b in batches]
    full = gather_tree(ex.pspecs, ex.params, mesh)
    return {"losses": losses, "launches": dict(build.LAUNCHES),
            "params": tree_map(lambda t: t.cpu(), full),
            "backend": mesh.backend, "compiles": ex.cache.stats.compiles}


def test_spmd_executor_over_a_process_mesh_on_card_tracks_plain_cpu(card):
    """SPMDExecutor over a data 2 x model 2 ProcessMesh of 4 rank
    processes sharing the card (gloo), reduced gpt3-medium through the
    flash and fused kernels with remat and the chunked CE, against the
    one-process executor on the CPU's plain versions: three steps'
    losses at tests/test_executor.py's fp32 tolerance on every rank
    (bitwise equal across ranks), the parameters by its tracking rule,
    one build and every kernel launched in every rank."""
    import numpy as np
    from repro_torch.configs import ShapeConfig, get_arch, reduced
    from repro_torch.convert import to_numpy
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime import SPMDExecutor
    from repro_torch.utils.tree import tree_leaves
    arch = reduced(get_arch("gpt3_medium"), layers=2)
    model = Model(arch, dtype=torch.float32, attn_impl="kernel",
                  fuse="fused", remat=True, loss_chunk=16)
    lr = 1e-3
    params = model.init(torch.Generator().manual_seed(0))
    cpu = SPMDExecutor(model, params, adamw.AdamWConfig(
        lr=lr, warmup_steps=0, clip_norm=1.0, weight_decay=0.0),
        shape=ShapeConfig("t", 64, 8, "train"))
    src = SyntheticLM(arch.vocab_size, 64, seed=5)
    batches = [src.batch(np.arange(8 * i, 8 * i + 8)) for i in range(3)]
    want = [float(cpu.step(b)["loss"]) for b in batches]
    ranks = spawn_world(f"{__name__}:mesh_rank_on_card", 4,
                        {"params_np": to_numpy(params), "batches": batches},
                        device="cuda", timeout=600,
                        paths=[__file__.rsplit("/", 1)[0]])
    for r in ranks:
        assert r["backend"] == "gloo" and r["compiles"] == 1
        assert r["losses"] == ranks[0]["losses"]
        np.testing.assert_allclose(r["losses"], want, rtol=5e-4, atol=5e-7)
        assert all(r["launches"][k] > 0 for k in r["launches"]
                   if not k.startswith("ssd") and not k.endswith("_wgmma")
                   ), r["launches"]
    for a, b in zip(tree_leaves(ranks[0]["params"]), tree_leaves(cpu.params)):
        diff = (a - b).abs()
        assert diff.max() <= 2.5 * lr, diff.max()
        assert (diff > lr / 10).float().mean() < 1e-3


def tp_rank_on_card(params_np, batches, arch_kw):
    """A rank of the card's 2 x 2 mesh under ``strategy="tp"`` (run by
    ``spawn_world``): reduced qwen3 with ``arch_kw``."""
    import dataclasses
    from repro_torch.configs import ShapeConfig, get_arch, reduced
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import ProcessMesh, init_world
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime import ShardingStrategy, SPMDExecutor
    from repro_torch.runtime.sharding import gather_tree
    from repro_torch.utils.device import strict_fp32_numerics
    from repro_torch.utils.tree import tree_map
    dev = init_world("cuda")
    strict_fp32_numerics()
    mesh = ProcessMesh(("data", "model"), (2, 2))
    arch = dataclasses.replace(reduced(get_arch("qwen3_1_7b"), layers=2),
                               **arch_kw)
    model = Model(arch, dtype=torch.float32, attn_impl="kernel",
                  fuse="fused", remat=True, loss_chunk=16)
    ex = SPMDExecutor(model, params_from_numpy(params_np, dev),
                      adamw.AdamWConfig(lr=1e-3, warmup_steps=0,
                                        clip_norm=1.0, weight_decay=0.0),
                      mesh=mesh, strategy=ShardingStrategy(strategy="tp"),
                      shape=ShapeConfig("t", 64, 8, "train"))
    build.reset_launches()
    losses = [float(ex.step(b)["loss"]) for b in batches]
    full = gather_tree(ex.pspecs, ex.params, mesh)
    return {"losses": losses, "launches": dict(build.LAUNCHES),
            "params": tree_map(lambda t: t.cpu(), full),
            "backend": mesh.backend, "compiles": ex.cache.stats.compiles}


#: reduced qwen3 (4 / 4 heads, the tied table vocab-parallel) and hymba
#: with 10 / 5 heads under a window of 8 (whole kv groups, 3 and 2 a
#: rank; the ring buffer wraps within the ticks)
SERVE_ON_CARD = {"qwen3_1_7b": {},
                 "hymba_1_5b": {"num_heads": 10, "num_kv_heads": 5,
                                "sliding_window": 8}}


def _serve_model(name, kernels):
    import dataclasses
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import Model
    arch = dataclasses.replace(reduced(get_arch(name), layers=2),
                               **SERVE_ON_CARD[name])
    kw = (dict(attn_impl="kernel", ssd_impl="kernel", fuse="fused")
          if kernels else dict(attn_impl="naive", ssd_impl="chunked",
                               fuse="none"))
    return Model(arch, dtype=torch.float32, remat=False, **kw)


def serve_rank_on_card(name, params_np, tokens, ticks):
    """A rank of the card's 2 x 2 mesh serving under ``strategy="tp"``
    (run by ``spawn_world``): the prefill through the kernels at the
    rank's heads, then ``ticks`` teacher-forced decode ticks from an
    empty cache."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import ProcessMesh, init_world
    from repro_torch.runtime import ShardingStrategy, SPMDServer
    from repro_torch.utils.device import strict_fp32_numerics
    dev = init_world("cuda")
    strict_fp32_numerics()
    mesh = ProcessMesh(("data", "model"), (2, 2))
    server = SPMDServer(_serve_model(name, True),
                        params_from_numpy(params_np, dev), mesh,
                        ShardingStrategy(strategy="tp"),
                        ShapeConfig("s", tokens.shape[1], tokens.shape[0],
                                    "prefill"))
    build.reset_launches()
    rows = torch.from_numpy(server.rows(tokens)).to(dev)
    prefill = server.gather_rows(server.prefill({"tokens": rows})).cpu()
    launches = dict(build.LAUNCHES)
    cache = server.init_cache(ticks)
    logits = []
    for t in range(ticks):
        out, cache = server.decode(rows[:, t:t + 1], cache, t)
        logits.append(server.gather_rows(out).cpu())
    full = server.gather_cache(cache)
    return {"prefill": prefill, "decode": torch.stack(logits),
            "cache": {p: {k: v.cpu() for k, v in leaves.items()}
                      for p, leaves in full.items()},
            "launches": launches, "backend": mesh.backend,
            "compiles": server.cache.stats.compiles}


@pytest.mark.parametrize("name", list(SERVE_ON_CARD))
def test_spmd_server_tp_decode_on_card_tracks_plain_cpu(card, name):
    """SPMDServer under strategy="tp" over a data 2 x model 2 ProcessMesh
    of 4 rank processes sharing the card (gloo): the prefill through the
    flash, fused-QKV, norm (and hymba's SSD) kernels at the rank's heads,
    and 12 decode ticks at them from an empty cache, against one CPU
    process's plain model on the same weights: logits and the gathered
    cache at 1e-4 (every kernel's fp32 tolerance), bitwise equal on
    every rank, one build a step."""
    from repro_torch.convert import to_numpy
    from repro_torch.launch.mesh import spawn_world
    ticks = 12
    model = _serve_model(name, False)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, model.arch.vocab_size, (4, 16),
                           generator=torch.Generator().manual_seed(3),
                           dtype=torch.int32)
    with torch.no_grad():
        want_prefill = model.prefill(params, tokens)
        cache = model.init_cache(4, ticks, "cpu")
        want = torch.stack([model.decode_step_(params, tokens[:, t:t + 1],
                                               cache, t)
                            for t in range(ticks)])
    ranks = spawn_world(f"{__name__}:serve_rank_on_card", 4,
                        {"name": name, "params_np": to_numpy(params),
                         "tokens": tokens.numpy(), "ticks": ticks},
                        device="cuda", timeout=600,
                        paths=[__file__.rsplit("/", 1)[0]])
    for r in ranks:
        assert r["backend"] == "gloo" and r["compiles"] == 2
        assert torch.equal(r["prefill"], ranks[0]["prefill"])
        assert torch.equal(r["decode"], ranks[0]["decode"])
        assert r["launches"]["flash_fwd"] == 2
        assert r["launches"]["gemm_bias"] == 2
        assert r["launches"]["add_rmsnorm_fwd"] == 2
        assert r["launches"]["ssd_fwd"] == (2 if name == "hymba_1_5b" else 0)
    torch.testing.assert_close(ranks[0]["prefill"], want_prefill,
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ranks[0]["decode"], want, rtol=1e-4,
                               atol=1e-4)
    for part, leaves in cache.items():
        for k, v in leaves.items():
            torch.testing.assert_close(ranks[0]["cache"][part][k], v,
                                       rtol=1e-4, atol=1e-4)


def test_spmd_tp_over_a_process_mesh_on_card_tracks_plain_cpu(card):
    """SPMDExecutor under strategy="tp" over a data 2 x model 2
    ProcessMesh of 4 rank processes sharing the card (gloo): reduced
    qwen3 with 2 kv heads (GQA, q/k norms, the tied table
    vocab-parallel) through the flash and fused kernels at a rank's
    heads, with remat and the chunked CE, against the one-process
    executor on the CPU's plain versions: three steps' losses at
    tests/test_executor.py's fp32 tolerance on every rank (bitwise equal
    across ranks), the parameters by its tracking rule, one build and
    every kernel launched in every rank."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import ShapeConfig, get_arch, reduced
    from repro_torch.convert import to_numpy
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime import SPMDExecutor
    from repro_torch.utils.tree import tree_leaves
    kw = {"num_kv_heads": 2}
    arch = dataclasses.replace(reduced(get_arch("qwen3_1_7b"), layers=2),
                               **kw)
    model = Model(arch, dtype=torch.float32, attn_impl="kernel",
                  fuse="fused", remat=True, loss_chunk=16)
    lr = 1e-3
    params = model.init(torch.Generator().manual_seed(0))
    cpu = SPMDExecutor(model, params, adamw.AdamWConfig(
        lr=lr, warmup_steps=0, clip_norm=1.0, weight_decay=0.0),
        shape=ShapeConfig("t", 64, 8, "train"))
    src = SyntheticLM(arch.vocab_size, 64, seed=5)
    batches = [src.batch(np.arange(8 * i, 8 * i + 8)) for i in range(3)]
    want = [float(cpu.step(b)["loss"]) for b in batches]
    ranks = spawn_world(f"{__name__}:tp_rank_on_card", 4,
                        {"params_np": to_numpy(params), "batches": batches,
                         "arch_kw": kw},
                        device="cuda", timeout=600,
                        paths=[__file__.rsplit("/", 1)[0]])
    for r in ranks:
        assert r["backend"] == "gloo" and r["compiles"] == 1
        assert r["losses"] == ranks[0]["losses"]
        np.testing.assert_allclose(r["losses"], want, rtol=5e-4, atol=5e-7)
        assert all(r["launches"][k] > 0 for k in r["launches"]
                   if not k.startswith("ssd") and not k.endswith("_wgmma")
                   ), r["launches"]
    for a, b in zip(tree_leaves(ranks[0]["params"]), tree_leaves(cpu.params)):
        diff = (a - b).abs()
        assert diff.max() <= 2.5 * lr, diff.max()
        assert (diff > lr / 10).float().mean() < 1e-3


#: the kernels at chip_smoke.py's shard shapes of its phase 18 (a rank's
#: heads, columns and rows under TP): (kernel, label, GEMM layout)
TP_SHAPES = ([("gemm_bias", label, layout) for label in ("tp-a", "tp-b", "tp-c")
              for layout in ("fwd", "dx", "dW")]
             + [(name, label, "fwd") for name in TENSOR_CORE_FLASH
                for label in ("tp-a", "tp-b", "tp-c")]
             + [(name, "tp-c", "fwd")
                for name in ("add_rmsnorm_fwd", "add_rmsnorm_bwd")])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,label,layout", TP_SHAPES,
                         ids=[f"{n}-{lab}-{lay}" for n, lab, lay in TP_SHAPES])
def test_kernels_at_tp_shard_shapes_match_plain(card, name, label, layout,
                                                dtype):
    """Each kernel at phase 18's shard shapes (the fused QKV of 8 heads
    of 64, of GQA 8 / 4 heads of 64 and of 128 at d 2048; flash at a
    rank's 8 query heads over 8 or 4 kv heads; the norms at d 2048)
    against its plain version with chip_smoke.py's comparison, which
    also reruns it bitwise."""
    cs = _chip_smoke()
    kern, plain, _ = cs.kernel_table(card)[name]
    shape = dict(cs._shapes(cs.CARD_SHAPES, name))[label]
    args = cs.make_inputs(name, shape, dtype, card, seed=13, layout=layout)
    cs.compare(name, kern, plain, args, dtype)


# ----------------------------------------------------------------------
# The autotuner's variants: every built tile and chunk, no fallback
# ----------------------------------------------------------------------
WIDE_FLASH = [(k, D, dt) for k, D, dt, t in flash.INSTANCES if t == 128]
_FLASH_NAME = {"fwd": "flash_fwd", "dq": "flash_bwd_dq",
               "dkdv": "flash_bwd_dkdv"}


@pytest.mark.parametrize("shape", [(1, 300, 4, 2, 0), (2, 257, 4, 1, 96)],
                         ids=["gqa", "window"])
@pytest.mark.parametrize("kernel,D,dtype", WIDE_FLASH,
                         ids=[f"{k}-d{D}-{str(dt)[6:]}"
                              for k, D, dt in WIDE_FLASH])
def test_flash_wide_tile_matches_plain_and_the_64_tile(card, kernel, D,
                                                       dtype, shape):
    """Each 128-row flash instance against its plain version (chip_smoke's
    condition-aware tolerances, a bitwise rerun) and bitwise equal to the
    64-row tile on the same inputs, with diagonals across two 64-row
    blocks and a sliding window."""
    import functools
    cs = _chip_smoke()
    name = _FLASH_NAME[kernel]
    B, S, H, KV, window = shape
    kern, plain, _ = cs.kernel_table(card)[name]
    args = cs.make_inputs(name, (B, S, H, KV, D, window), dtype, card, seed=12)
    kw = "block_k" if kernel == "dkdv" else "block_q"
    wide = functools.partial(kern, **{kw: 128})
    cs.compare(name, wide, plain, args, dtype)
    narrow = cs._flat(functools.partial(kern, **{kw: 64})(*args))
    assert all(torch.equal(a, b) for a, b in zip(cs._flat(wide(*args)),
                                                 narrow))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,N", ssd.SHAPES)
def test_ssd_chunk_32_matches_plain(card, P, N, dtype):
    """Both SSD kernels at chunk 32 against the plain versions at chunk
    32, with a ragged last chunk; bitwise reruns."""
    import functools
    cs = _chip_smoke()
    table = cs.kernel_table(card)
    for name in ("ssd_fwd", "ssd_bwd"):
        kern, plain, _ = table[name]
        args = cs.make_inputs(name, (2, 1000, 6, P, N, True), dtype, card,
                              seed=13, chunk=32)
        cs.compare(name, functools.partial(kern, chunk=32),
                   functools.partial(plain, chunk=32), args, dtype, 32)


def test_ops_ssd_takes_chunk_32_through_autograd_on_card(card):
    """ops.ssd(chunk=32): the forward's chunk reaches the backward (its
    cstates have ceil(S / 32) entries), one launch each, gradients as
    the CPU route's at the same chunk (2e-4 of each output's largest
    entry, as test_ssd_gradients_match_autograd_on_card)."""
    g = torch.Generator().manual_seed(14)
    b, S, H, P, N = 1, 300, 4, 64, 16
    x, gy = (torch.randn(b, S, H, P, generator=g) for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn(b, S, H, generator=g) - 3)
    A = -torch.exp(torch.randn(H, generator=g) * 0.5)
    B, C = (torch.randn(b, S, H, N, generator=g) for _ in range(2))
    outs = {}
    for dev in ("cpu", card):
        leaves = [t.clone().to(dev).requires_grad_(True)
                  for t in (x, dt, A, B, C)]
        build.reset_launches()
        y, _ = ops.ssd(*leaves, chunk=32)
        grads = torch.autograd.grad(y, leaves, gy.to(dev))
        outs[str(dev)] = [t.cpu() for t in (y, *grads)]
    assert build.LAUNCHES["ssd_fwd"] == build.LAUNCHES["ssd_bwd"] == 1
    for a, c in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(a, c, rtol=0,
                                   atol=2e-4 * float(c.abs().max()))


def test_unbuilt_tiles_and_chunks_raise_on_card(card):
    """No fallback: a tile or chunk with no instance raises before any
    launch, in the wrappers and in ops; the C launchers refuse too."""
    q, k, v, dout = _flash_inputs(card, 1, 200, 4, 2, 128, torch.float32)
    lse = torch.zeros(1, 4, 200, device=card)
    with pytest.raises(ValueError, match="not built"):
        flash.flash_bwd_dq(q, k, v, dout, lse, lse, 0, block_q=128)
    with pytest.raises(ValueError, match="not built"):
        flash.flash_bwd_dkdv(q, k, v, dout, lse, lse, 0, block_k=128)
    with pytest.raises(ValueError, match="not built"):
        ops.flash_attention(q, k, v, block_q=128)      # dq at fp32 D 128
    q32, k32, v32, _ = _flash_inputs(card, 1, 200, 4, 2, 32, torch.float32)
    with pytest.raises(ValueError, match="not built"):
        flash.flash_fwd(q32, k32, v32, 0, block_q=128)
    with pytest.raises(ValueError, match="not built"):
        ops.flash_attention(q32, k32, v32, block_k=96)
    out = torch.empty_like(q32)
    build.reset_launches()
    with pytest.raises(RuntimeError, match="flash_fwd"):
        build.launch("flash_fwd", q32.data_ptr(), k32.data_ptr(),
                     v32.data_ptr(), out.data_ptr(), lse.data_ptr(), 1, 200,
                     200, 4, 2, 32, 0, 1.0, *q32.stride()[:3],
                     *k32.stride()[:3], *v32.stride()[:3], 128, 0,
                     build.current_stream(q32))
    x = torch.zeros(1, 100, 2, 64, device=card)
    dt = torch.zeros(1, 100, 2, device=card)
    A = torch.zeros(2, device=card)
    B = torch.zeros(1, 100, 2, 16, device=card)
    for chunk in (16, 128):
        with pytest.raises(ValueError, match="not built"):
            ssd.ssd_fwd(x, dt, A, B, B, chunk=chunk)
        with pytest.raises(ValueError, match="not built"):
            ops.ssd(x, dt, A, B, B, chunk=chunk)
    assert sum(build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("layout", ["fwd", "dx", "dW"])
def test_gemm_every_tile_and_split_matches_plain(card, layout):
    """Each legal (tile, split) of the GEMM against the plain product in
    each operand layout at a path-like shape, bitwise reruns."""
    import functools
    cs = _chip_smoke()
    plain = cs.kernel_table(card)["gemm_bias"][1]
    for dtype in (torch.float32, torch.bfloat16):
        args = cs.make_inputs("gemm_bias", (512, 1024, 3072), dtype, card,
                              seed=15, layout=layout)
        cands = fused.gemm_candidates(args[0].shape[1], args[0].element_size())
        assert len(cands) == (8 if dtype == torch.float32 else 4)
        for choice in cands:
            cs.compare("gemm_bias", functools.partial(
                fused.gemm_bias, choice=choice), plain, args, dtype)


def test_norm_every_row_partition_matches_plain(card):
    cs = _chip_smoke()
    plain = cs.kernel_table(card)["add_rmsnorm_bwd"][1]
    for dtype in (torch.float32, torch.bfloat16):
        for M, d in ((2048, 1024), (1000, 999)):
            args = cs.make_inputs("add_rmsnorm_bwd", (M, d), dtype, card,
                                  seed=16)
            for n in fused.norm_rows_candidates(M, d):
                cs.compare("add_rmsnorm_bwd",
                           lambda *a, n=n: fused.add_rmsnorm_bwd(
                               *a, 1e-6, rows_per_block=n), plain, args, dtype)


# ----------------------------------------------------------------------
# The bf16 wgmma instances (csrc/gemm_wgmma.cu, csrc/flash_wgmma.cu)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("M,K,N", [(300, 200, 264), (8, 64, 8),
                                   (129, 72, 136), (1000, 1000, 3000)],
                         ids=["ragged", "one-block", "edges", "wide"])
@pytest.mark.parametrize("layout", ["fwd", "dx", "dW"])
def test_gemm_wgmma_matches_plain_at_ragged_edges(card, M, K, N, layout):
    """The wgmma GEMM at every split against the plain product (bf16
    tolerance, a bitwise rerun), where M, N and K are not whole tiles or
    K slices (multiples of 8: TMA's 16-byte rows), in each layout; the
    mma.sync instance launches none."""
    import functools
    cs = _chip_smoke()
    args = cs.make_inputs("gemm_bias", (M, K, N), torch.bfloat16, card,
                          seed=21, layout=layout)
    build.reset_launches()
    for choice in fused.gemm_candidates(args[0].shape[1], 2):
        cs.compare("gemm_bias_wgmma", functools.partial(
            fused.gemm_bias, choice=choice), ref.matmul_bias_ref, args,
            torch.bfloat16)
    assert build.LAUNCHES["gemm_bias_wgmma"] > 0, build.LAUNCHES
    assert build.LAUNCHES["gemm_bias"] == 0, build.LAUNCHES


def test_gemm_dispatch_takes_the_wgmma_instance_where_tma_reads(card):
    """bf16 with 16-byte rows: the wgmma instance; rows of 999 elements:
    the mma.sync instance with element copies, and a tile of the wgmma
    one raises there; fp32: the mma.sync instance.  fused.cu's bf16
    entry refuses 16-byte copies (those calls are the wgmma
    instance's)."""
    cs = _chip_smoke()
    for shape, dtype, launcher in (
            ((256, 1024, 512), torch.bfloat16, "gemm_bias_wgmma"),
            ((256, 999, 512), torch.bfloat16, "gemm_bias"),
            ((256, 1024, 512), torch.float32, "gemm_bias")):
        args = cs.make_inputs("gemm_bias", shape, dtype, card, seed=22)
        build.reset_launches()
        cs.compare("gemm_bias", fused.gemm_bias, ref.matmul_bias_ref, args,
                   dtype)
        assert build.LAUNCHES[launcher] == 2, (shape, build.LAUNCHES)
    x, w, b = cs.make_inputs("gemm_bias", (256, 999, 512), torch.bfloat16,
                             card, seed=22)
    with pytest.raises(ValueError, match="not built"):
        fused.gemm_bias(x, w, b, choice=(128, 256, 1))
    x, w, b = cs.make_inputs("gemm_bias", (256, 1024, 512), torch.bfloat16,
                             card, seed=22)
    c = torch.empty(256, 512, dtype=torch.bfloat16, device=card)
    build.reset_launches()
    with pytest.raises(RuntimeError, match="gemm_bias"):
        build.launch("gemm_bias", x.data_ptr(), w.data_ptr(), b.data_ptr(),
                     c.data_ptr(), None, 256, 512, 1024, *x.stride(),
                     *w.stride(), 64, 64, 1, 1024, 1, 0, 1,
                     build.check_tensors("gemm_bias", x),
                     build.current_stream(x))
    assert sum(build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("shape", [
    (1, 130, 2, 2, 64, 0), (2, 300, 8, 2, 128, 0), (1, 400, 5, 1, 64, 96),
    (1, 200, 4, 2, 128, 0, 500), (2, 129, 4, 4, 64, 40, 257)],
    ids=["causal", "gqa", "window", "sq-lt-sk", "window-sq-lt-sk"])
def test_flash_wgmma_matches_plain_and_its_tiles_agree(card, shape):
    """The wgmma forward at both q tiles against the plain forward (bf16
    tolerance, a bitwise rerun), the tiles bitwise equal: ragged
    sequences, grouped query heads, the sliding window, fewer queries
    than keys."""
    import functools
    cs = _chip_smoke()
    args = cs.make_inputs("flash_fwd", shape, torch.bfloat16, card, seed=23)
    build.reset_launches()
    outs = []
    for bq in (64, 128):
        kern = functools.partial(flash.flash_fwd, block_q=bq)
        cs.compare("flash_fwd_wgmma", kern, cs.kernel_table(card)[
            "flash_fwd"][1], args, torch.bfloat16)
        outs.append(cs._flat(kern(*args)))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert build.LAUNCHES["flash_fwd_wgmma"] == 6, build.LAUNCHES
    assert build.LAUNCHES["flash_fwd"] == 0, build.LAUNCHES


def test_flash_wgmma_reads_the_fused_qkv_views(card):
    """q, k and v as views of one fused QKV output (qwen3-1.7b's 16 / 8
    heads of 128 at a short sequence): the wrapper's default dispatch
    takes the wgmma instance and matches the plain forward on contiguous
    copies."""
    B, S, H, KV, D = 2, 320, 16, 8, 128
    g = torch.Generator(device=card).manual_seed(24)
    qkv = torch.randn(B, S, (H + 2 * KV) * D, generator=g,
                      device=card).to(torch.bfloat16)
    q = qkv[..., :H * D].view(B, S, H, D)
    k = qkv[..., H * D:(H + KV) * D].view(B, S, KV, D)
    v = qkv[..., (H + KV) * D:].view(B, S, KV, D)
    build.reset_launches()
    out, lse = flash.flash_fwd(q, k, v)
    assert build.LAUNCHES["flash_fwd_wgmma"] == 1, build.LAUNCHES
    want, wlse = ref.flash_fwd_ref(q.contiguous(), k.contiguous(),
                                   v.contiguous())
    p, _ = ref.flash_bwd_terms(q, k, v, wlse, torch.zeros_like(q),
                               torch.zeros_like(wlse))
    cond = torch.einsum("bkgqs,bskd->bqkgd", p, v.float().abs()).reshape(
        q.shape)
    _sum_close(out, want, cond, 1e-4, 1e-4)
    torch.testing.assert_close(lse, wlse, rtol=1e-5, atol=1e-5)


def test_flash_dispatch_keeps_the_mma_instance_where_wgmma_cannot(card):
    """Head dim 80 (no wgmma instance) and rows not 16-byte aligned run
    flash.cuh's instance."""
    cs = _chip_smoke()
    args = cs.make_inputs("flash_fwd", (1, 100, 2, 2, 80, 0), torch.bfloat16,
                          card, seed=25)
    build.reset_launches()
    flash.flash_fwd(*args)
    assert build.LAUNCHES["flash_fwd"] == 1, build.LAUNCHES
    base = torch.zeros(1, 100, 2 * 64 + 4, device=card, dtype=torch.bfloat16)
    q = base[..., :128].unflatten(-1, (2, 64))          # rows of 264 bytes
    assert flash.forward_instance(q, q, q, 64) is None
    flash.flash_fwd(q, q, q)
    assert build.LAUNCHES["flash_fwd"] == 2, build.LAUNCHES
    assert build.LAUNCHES["flash_fwd_wgmma"] == 0, build.LAUNCHES


#: the wgmma backward's cases: phase 20's four shapes (G 2, 5, 8 and 1),
#: fewer queries than keys, a window that cuts causal pairs
WGMMA_BWD_SHAPES = [
    *[(label, shape) for label, shape in _chip_smoke().CARD_SHAPES["flash"]
      if label in ("20a", "20b", "20c", "20d")],
    ("sq-lt-sk", (1, 200, 4, 2, 128, 0, 500)),
    ("window-sq-lt-sk", (2, 129, 4, 4, 64, 40, 257)),
    ("window", (1, 400, 5, 1, 64, 96))]


@pytest.mark.parametrize("name", ["flash_bwd_dq", "flash_bwd_dkdv"])
@pytest.mark.parametrize("label,shape", WGMMA_BWD_SHAPES,
                         ids=[l for l, _ in WGMMA_BWD_SHAPES])
def test_flash_wgmma_backward_matches_plain_and_its_tiles_agree(card, label,
                                                                shape, name):
    """The wgmma dq and dk/dv at both tiles against the plain backward
    (bf16 tolerance, a bitwise rerun), the tiles bitwise equal, each call
    on the wgmma instance."""
    import functools
    cs = _chip_smoke()
    args = cs.make_inputs(name, shape, torch.bfloat16, card, seed=26,
                          draw_on_device=True)
    plain = cs.kernel_table(card)[name][1]
    kw = "block_q" if name == "flash_bwd_dq" else "block_k"
    build.reset_launches()
    outs = []
    for tile in (64, 128):
        kern = functools.partial(cs.kernel_table(card)[name][0],
                                 **{kw: tile})
        cs.compare(name + "_wgmma", kern, plain, args, torch.bfloat16)
        outs.append(cs._flat(kern(*args)))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert build.LAUNCHES[name + "_wgmma"] == 6, build.LAUNCHES
    assert build.LAUNCHES[name] == 0, build.LAUNCHES


def test_flash_backward_dispatch_keeps_the_mma_instance_where_tma_cannot(
        card):
    """Head dim 80 (no wgmma instance), fp32, and a dO whose rows are
    not 16-byte aligned run flash.cuh's dq and dk/dv; the same call with
    a contiguous dO runs the wgmma ones, and both agree with the plain
    backward."""
    cs = _chip_smoke()
    for name in ("flash_bwd_dq", "flash_bwd_dkdv"):
        kern, plain, _ = cs.kernel_table(card)[name]
        for shape, dtype in (((1, 100, 2, 2, 80, 0), torch.bfloat16),
                             ((1, 100, 4, 2, 64, 0), torch.float32)):
            args = cs.make_inputs(name, shape, dtype, card, seed=27)
            build.reset_launches()
            kern(*args)
            assert build.LAUNCHES[name] == 1, build.LAUNCHES
            assert build.LAUNCHES[name + "_wgmma"] == 0, build.LAUNCHES
        args = cs.make_inputs(name, (1, 100, 4, 2, 64, 0), torch.bfloat16,
                              card, seed=27)
        rows = torch.zeros(1, 100, 4 * 64 + 4, device=card,
                           dtype=torch.bfloat16)
        g = rows[..., :256].unflatten(-1, (4, 64))       # rows of 520 bytes
        g.copy_(args[3])
        odd = args[:3] + (g,) + args[4:]
        assert flash.backward_instance(*odd[:4], "dq", 64) is None
        build.reset_launches()
        cs.compare(name, kern, plain, odd, torch.bfloat16)
        assert build.LAUNCHES[name] == 2, build.LAUNCHES
        cs.compare(name, kern, plain, args, torch.bfloat16)
        assert build.LAUNCHES[name + "_wgmma"] == 2, build.LAUNCHES


@pytest.mark.parametrize("shape", [(2, 300, 16, 2, 128, 0),
                                   (2, 257, 10, 2, 64, 96)],
                         ids=["gqa-d128", "window-d64"])
def test_flash_attention_bf16_gradients_on_card_track_plain_cpu(card, shape):
    """``FlashAttention`` in bf16 on the card (the wgmma forward, dq and
    dk/dv) against the plain bf16 route on the CPU, on the same numbers:
    the output and each gradient within twice the plain route's own
    bf16-to-fp32 gap (relative Frobenius norms)."""
    B, S, H, KV, D, window = shape
    gen = torch.Generator().manual_seed(28)
    q, dout = (torch.randn(B, S, H, D, generator=gen).to(torch.bfloat16)
               for _ in range(2))
    k, v = (torch.randn(B, S, KV, D, generator=gen).to(torch.bfloat16)
            for _ in range(2))

    def run(device, dtype):
        leaves = [t.to(device=device, dtype=dtype).requires_grad_(True)
                  for t in (q, k, v)]
        out = ops.flash_attention(*leaves, window=window)
        grads = torch.autograd.grad(out, leaves, dout.to(device, dtype))
        return [t.detach().float().cpu() for t in (out, *grads)]
    build.reset_launches()
    got = run(card, torch.bfloat16)
    assert all(build.LAUNCHES[n] == 1 for n in (
        "flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma")), \
        build.LAUNCHES
    assert all(build.LAUNCHES[n] == 0 for n in (
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")), build.LAUNCHES
    plain, exact = run("cpu", torch.bfloat16), run("cpu", torch.float32)
    for name, a, b, c in zip(("out", "dq", "dk", "dv"), got, plain, exact):
        err, gap = (a - b).norm() / c.norm(), (b - c).norm() / c.norm()
        assert err <= 2 * gap, (name, float(err), float(gap))


# ----------------------------------------------------------------------
# The SSD pair's wgmma instances (csrc/ssd_wgmma.cu)
# ----------------------------------------------------------------------
#: chip_smoke.py's SSD shapes of the training paths the wgmma instances
#: carry: mamba2-780m (phase 8), hymba-1.5b at S 1000, the TP shards
#: (phase 19), phase 21's prefill shard and phase 20's hymba
SSD_WG_LABELS = ("mamba", "hymba", "tp-d", "tp-g", "sv-b", "20b")


def _kernel_ab():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "tools/kernel_ab.py"
    spec = importlib.util.spec_from_file_location("kernel_ab", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("label", SSD_WG_LABELS)
def test_ssd_wgmma_matches_plain_and_the_mma_instance(card, label):
    """Each bf16 wgmma SSD instance at each path's shape, through the
    wrapper, against the plain version and against ssd.cu's mma.sync
    instance on the same inputs, under chip_smoke.py's SSD tolerances;
    two launches bitwise equal (``compare``), counted on the wgmma
    entry."""
    cs, ab = _chip_smoke(), _kernel_ab()
    table = cs.kernel_table(card)
    shape = dict(cs.CARD_SHAPES["ssd"])[label]
    dtype = torch.bfloat16
    for name in ("ssd_fwd", "ssd_bwd"):
        kern, plain = table[name][:2]
        args = cs.make_inputs(name, shape, dtype, card, seed=21,
                              draw_on_device=True)
        assert cs.takes_wgmma(name, args)
        build.reset_launches()
        cs.compare(name, kern, plain, args, dtype)
        assert build.LAUNCHES[name + "_wgmma"] == 2, build.LAUNCHES
        cs.compare(name, kern, ab.mma_ssd(name), args, dtype)
        assert build.LAUNCHES[name] == 1, build.LAUNCHES


def test_ssd_wgmma_reads_the_mixer_views(card):
    """bf16 x, B and C as views of one conv output (the Mamba2 block's:
    x's rows the conv row apart, B and C one group at head stride 0) take
    the wgmma instance and match the same inputs made contiguous."""
    b, S, H, P, N = 2, 300, 6, 64, 128
    g = torch.Generator(device=card).manual_seed(22)
    xbc = torch.randn(b, S, H * P + 2 * N, generator=g,
                      device=card).to(torch.bfloat16)
    x = xbc[..., :H * P].reshape(b, S, H, P)
    B, C = (xbc[..., H * P + i * N:H * P + (i + 1) * N].reshape(b, S, 1, N)
            .expand(b, S, H, N) for i in range(2))
    dt = torch.nn.functional.softplus(
        torch.randn(b, S, H, generator=g, device=card) - 3.0)
    A = -torch.exp(torch.randn(H, generator=g, device=card) * 0.5)
    assert ssd.instance(x, B, C, 64) is not None
    build.reset_launches()
    got = ssd.ssd_fwd(x, dt, A, B, C, chunk=64)
    assert build.LAUNCHES["ssd_fwd_wgmma"] == 1
    want = ssd.ssd_fwd(x.contiguous(), dt, A, B.contiguous(),
                       C.contiguous(), chunk=64)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, want))


def test_ssd_wgmma_keeps_the_mma_instance_where_it_cannot(card):
    """fp32, and in bf16 chunk 32, (P, N) = (16, 16) and a misaligned x
    take ssd.cu's instance (counted on it), never the wgmma one."""
    cs = _chip_smoke()
    import functools
    for shape, dtype, chunk, shift in (
            ((1, 300, 4, 64, 128, True), torch.float32, 64, False),
            ((1, 300, 4, 64, 128, True), torch.bfloat16, 32, False),
            ((2, 300, 8, 16, 16, False), torch.bfloat16, 64, False),
            ((1, 300, 4, 64, 16, True), torch.bfloat16, 64, True)):
        args = list(cs.make_inputs("ssd_fwd", shape, dtype, card, seed=23,
                                   chunk=chunk))
        if shift:
            buf = torch.empty(args[0].numel() + 1, dtype=dtype, device=card)
            args[0] = buf[1:].view(args[0].shape).copy_(args[0])
        build.reset_launches()
        cs.compare("ssd_fwd", functools.partial(ssd.ssd_fwd, chunk=chunk),
                   functools.partial(cs.kernel_table(card)["ssd_fwd"][1],
                                     chunk=chunk), tuple(args), dtype, chunk)
        assert build.LAUNCHES["ssd_fwd_wgmma"] == 0, build.LAUNCHES
        assert build.LAUNCHES["ssd_fwd"] == 2, build.LAUNCHES
