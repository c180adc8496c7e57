"""The plain versions of the port's kernels (kernels/ref.py) against the
JAX package's Pallas kernels run in interpret mode on the CPU
(``repro/kernels/fused.py``, as tests/test_fused.py runs them): forward
and gradients, fp32 and bf16, ragged rows.  Plus the routing contract of
kernels/ops.py (CPU tensor -> plain version, anything else but CUDA ->
raise), the kernel wrappers' refusal of non-CUDA tensors, and the ctypes
binding against the CUDA source.

Tolerances: fp32 rtol = atol = 2e-5 (the two frameworks reduce in other
orders); bf16 2e-2 (one bf16 ulp near 1-4); the bf16 weight gradient is
a row reduction that the interpreted kernel accumulates in fp32 partials
per row block, so it is compared at reduction precision."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused as jfused

from repro_torch.kernels import build, fused, ops, ref

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tol(dtype):
    return BF16 if dtype == "bfloat16" else F32


def _pair(a, dtype):
    """One numpy array -> (jax array, torch tensor) in ``dtype``."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a.copy()).to(getattr(torch, dtype)))


def _norm_inputs(rows, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    r = rng.standard_normal((rows, d)).astype(np.float32)
    w = (rng.standard_normal(d) * 0.2 + 1).astype(np.float32)
    return _pair(x, dtype), _pair(r, dtype), _pair(w, dtype)


SHAPES = [(64, 64), (33, 48), (7, 96), (129, 40)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", SHAPES)
def test_add_rmsnorm_forward_matches_pallas(rows, d, dtype):
    (xj, xt), (rj, rt), (wj, wt) = _norm_inputs(rows, d, dtype)
    res_j, h_j = jfused.add_rmsnorm(xj, rj, wj, block_rows=32, interpret=True)
    res_t, h_t = ref.add_rmsnorm_ref(xt, rt, wt)
    assert res_t.dtype == h_t.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(res_t), _np(res_j))
    np.testing.assert_allclose(_np(h_t), _np(h_j), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", SHAPES[:2])
def test_add_rmsnorm_gradients_match_pallas(rows, d, dtype):
    (xj, xt), (rj, rt), (wj, wt) = _norm_inputs(rows, d, dtype)
    rng = np.random.default_rng(1)
    gres_j, gres_t = _pair(rng.standard_normal((rows, d)).astype(np.float32),
                           dtype)
    gh_j, gh_t = _pair(rng.standard_normal((rows, d)).astype(np.float32), dtype)

    def jloss(x, r, w):
        res, h = jfused.add_rmsnorm(x, r, w, block_rows=32, interpret=True)
        return (jnp.sum(res.astype(jnp.float32) * gres_j.astype(jnp.float32))
                + jnp.sum(h.astype(jnp.float32) * gh_j.astype(jnp.float32)))
    gj = jax.grad(jloss, argnums=(0, 1, 2))(xj, rj, wj)

    # autograd through the CPU route of ops, and the plain version of
    # the backward kernel itself
    leaves = [t.clone().requires_grad_(True) for t in (xt, rt, wt)]
    res, h = ops.fused_add_rmsnorm(*leaves)
    loss = (res.float() * gres_t.float()).sum() + (h.float() * gh_t.float()).sum()
    gt = torch.autograd.grad(loss, leaves)
    res_t, _ = ref.add_rmsnorm_ref(xt, rt, wt)
    dres, dw = ref.add_rmsnorm_bwd_ref(res_t, wt, gres_t, gh_t)
    for name, a, b_auto, b_kern in zip(("dx", "dr", "dw"), gj, gt,
                                       (dres, dres, dw)):
        tol = _tol(dtype)
        if name == "dw" and dtype == "bfloat16":
            tol = dict(rtol=5e-2, atol=0.3)
        np.testing.assert_allclose(_np(b_kern), _np(a), err_msg=name, **tol)
        np.testing.assert_allclose(_np(b_auto), _np(a), err_msg=name, **tol)


def _qkv_inputs(rows, d, cq, ckv, dtype, bias, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, rows, d)).astype(np.float32)
    ws = [(rng.standard_normal((d, c)) * d ** -0.5).astype(np.float32)
          for c in (cq, ckv, ckv)]
    bs = ([rng.standard_normal(c).astype(np.float32) for c in (cq, ckv, ckv)]
          if bias else [None] * 3)
    xj, xt = _pair(x, dtype)
    wj = [jnp.asarray(w) for w in ws]
    wt = [torch.from_numpy(w.copy()) for w in ws]
    bj = [None if b is None else jnp.asarray(b) for b in bs]
    bt = [None if b is None else torch.from_numpy(b.copy()) for b in bs]
    return (xj, wj, bj), (xt, wt, bt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("rows,d,cq,ckv", [(32, 64, 64, 32), (21, 48, 40, 24)])
def test_qkv_forward_matches_pallas(rows, d, cq, ckv, dtype, bias):
    (xj, wj, bj), (xt, wt, bt) = _qkv_inputs(rows, d, cq, ckv, dtype, bias)
    out_j = jfused.qkv(xj, *wj, *bj, block_m=16, block_n=32, interpret=True)
    out_t = ops.fused_qkv(xt, *wt, *bt)
    for a, b, nm in zip(out_t, out_j, "qkv"):
        assert tuple(a.shape) == b.shape and a.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(a), _np(b), err_msg=nm, **_tol(dtype))


@pytest.mark.parametrize("bias", [False, True])
def test_qkv_gradients_match_pallas(bias):
    (xj, wj, bj), (xt, wt, bt) = _qkv_inputs(24, 32, 32, 16, "float32", bias)

    def jloss(x, wq, wk, wv):
        q, k, v = jfused.qkv(x, wq, wk, wv, *bj, block_m=16, block_n=16,
                             interpret=True)
        return jnp.sum(q * q) + jnp.sum(k) + jnp.sum(v * 0.5)
    gj = jax.grad(jloss, argnums=(0, 1, 2, 3))(xj, *wj)
    leaves = [t.clone().requires_grad_(True) for t in (xt, *wt)]
    q, k, v = ops.fused_qkv(*leaves, *bt)
    gt = torch.autograd.grad((q * q).sum() + k.sum() + (v * 0.5).sum(), leaves)
    for a, b, nm in zip(gt, gj, ("dx", "dwq", "dwk", "dwv")):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-4,
                                   err_msg=nm)


@pytest.mark.parametrize("layout", ["fwd", "dx", "dW"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_bias_ref_all_layouts(layout, dtype):
    """The GEMM's plain version on strided operands, against float64."""
    rng = np.random.default_rng(3)
    M, K, N = 37, 29, 53
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32) * K ** -0.5
    g = rng.standard_normal((M, N)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    td = getattr(torch, dtype)
    T = lambda a: torch.from_numpy(a.copy()).to(td)          # noqa: E731
    rnd = lambda a: T(a).double().numpy()                    # noqa: E731
    if layout == "fwd":
        a_t, b_t, bias_t = T(x), T(w), T(b)
        want = rnd(x) @ rnd(w) + rnd(b)
    elif layout == "dx":
        a_t, b_t, bias_t = T(g), T(w).t(), None
        want = rnd(g) @ rnd(w).T
    else:
        a_t, b_t, bias_t = T(x).t(), T(g), None
        want = rnd(x).T @ rnd(g)
    got = ref.matmul_bias_ref(a_t, b_t, bias_t)
    assert got.dtype == td and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), want, **(_tol(dtype) if dtype ==
                                                   "bfloat16" else F32))


# ----------------------------------------------------------------------
# Routing, wrappers, binding
# ----------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a kernel Function ran for a CPU tensor")
    monkeypatch.setattr(fused.AddRMSNorm, "apply", boom)
    monkeypatch.setattr(fused.MatmulBias, "apply", boom)
    x = torch.randn(4, 8)
    ops.fused_add_rmsnorm(x, x, torch.ones(8))
    ops.fused_qkv(x, torch.randn(8, 8), torch.randn(8, 4), torch.randn(8, 4))
    assert all(n == 0 for n in build.LAUNCHES.values())


def test_other_devices_raise():
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError):
        ops.fused_add_rmsnorm(x, x, torch.empty(8, device="meta"))
    with pytest.raises(ValueError):
        ops.fused_qkv(x, x, x, x)


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.randn(4, 8)
    with pytest.raises(ValueError):
        fused.add_rmsnorm_fwd(x, x, torch.ones(8), 1e-6)
    with pytest.raises(ValueError):
        fused.gemm_bias(x, torch.randn(8, 3))
    assert build._LIB is None          # nothing was built or loaded


def test_backend_signature_names_device_torch_and_sources():
    sig = ops.backend_signature("cpu")
    assert sig[0] == "cpu" and sig[3] == torch.__version__
    assert sig[4] == build.source_hash() and len(sig[4]) == 16


def test_ctypes_signatures_match_the_cuda_source():
    decls = {}
    for path in build.SOURCES:
        src = path.read_text()
        if 'extern "C" {' not in src:      # a source of kernel instances
            continue
        block = src[src.index('extern "C" {'):]
        decls.update(re.findall(r"^int (\w+)\(([^)]*)\)", block, re.M | re.S))
    assert set(decls) == set(build.SIGNATURES) == set(build.LAUNCHES)
    for name, args in decls.items():
        params = [p.strip() for p in args.split(",")]
        assert len(params) == len(build.SIGNATURES[name]), name
        for p, ct in zip(params, build.SIGNATURES[name]):
            kind = ("ptr" if "*" in p else "float" if p.startswith("float")
                    else "int")
            want = {"ptr": build.ctypes.c_void_p, "float": build.ctypes.c_float,
                    "int": build.ctypes.c_int}[kind]
            assert ct is want, (name, p)
