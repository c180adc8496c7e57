"""The plain versions of the port's flash-attention kernels
(kernels/ref.py) against the JAX package's Pallas kernels run in
interpret mode on the CPU (``repro/kernels/flash_attention.py``), and
the CPU route of ``ops.flash_attention`` (the custom backward's math)
against autograd through ``attention_ref``.  Inputs come from numpy with
a seed; group sizes G 1, 2, 4, ragged sequences (40 and 100 with the
reference's 32-row blocks), window 0 and 24.  Plus the routing contract:
a CPU tensor never reaches kernels/flash.py, another device raises, and
the kernel wrappers refuse CPU tensors.

Tolerances: fp32 rtol = atol = 1e-5 (the same fp32 arithmetic, summed in
another order); bf16 2e-2 (one bf16 ulp near 1-4, and the reference sums
the G per-head dk/dv after rounding each to bf16 while the port sums in
fp32 before one cast)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa

from repro_torch.kernels import build, flash, ops, ref

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

B, KV, D, BLOCK = 2, 2, 32, 32
CASES = [(G, S, window) for G in (1, 2, 4) for S in (40, 100)
         for window in (0, 24)]


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=1e-5, atol=1e-5))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _inputs(G, S):
    rng = np.random.default_rng(G * 1000 + S)
    H = KV * G
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)))


def _torch(a, dtype):
    return torch.from_numpy(np.array(a)).to(getattr(torch, dtype))


@functools.lru_cache(maxsize=None)
def _pallas(G, S, window, dtype):
    """The JAX package's forward and backward kernels, interpreted:
    (out, lse, dq, dk, dv) as float32 numpy arrays, and out in dtype."""
    q, k, v, g = (jnp.asarray(a).astype(getattr(jnp, dtype))
                  for a in _inputs(G, S))
    kw = dict(window=window, block_q=BLOCK, block_k=BLOCK, interpret=True)
    out, lse = jfa.flash_attention_fwd(q, k, v, **kw)
    grads = jfa.flash_attention_bwd(q, k, v, out, lse, g, **kw)
    return tuple(_np(t) for t in (out, lse, *grads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,S,window", CASES)
def test_flash_fwd_ref_matches_pallas(G, S, window, dtype):
    q, k, v, _ = (_torch(a, dtype) for a in _inputs(G, S))
    out, lse = ref.flash_fwd_ref(q, k, v, window=window)
    want_out, want_lse = _pallas(G, S, window, dtype)[:2]
    assert out.dtype == q.dtype and tuple(out.shape) == want_out.shape
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, KV * G, S)
    np.testing.assert_allclose(_np(out), want_out, **_tol(dtype))
    np.testing.assert_allclose(_np(lse), want_lse, **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,S,window", CASES)
def test_flash_bwd_ref_matches_pallas(G, S, window, dtype):
    """Both backwards on the same (out, lse, g): the Pallas forward's."""
    q, k, v, g = (_torch(a, dtype) for a in _inputs(G, S))
    out, lse, *want = _pallas(G, S, window, dtype)
    got = ref.flash_bwd_ref(q, k, v, _torch(out, dtype), _torch(lse, "float32"),
                            g, window=window)
    for name, a, b, like in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert a.dtype == like.dtype and a.shape == like.shape, name
        np.testing.assert_allclose(_np(a), b, err_msg=name, **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,S,window", CASES)
def test_flash_attention_cpu_gradients_match_autograd(G, S, window, dtype):
    """ops.flash_attention's CPU route (forward saving lse, the flash
    backward's math) against autograd through attention_ref."""
    leaves = {}
    for route in ("flash", "autograd"):
        ins = [_torch(a, dtype).requires_grad_(True) for a in _inputs(G, S)]
        q, k, v, g = ins
        if route == "flash":
            out = ops.flash_attention(q, k, v, window=window)
        else:
            out = ref.attention_ref(q, k, v, window=window)
        grads = torch.autograd.grad(out, (q, k, v), g.detach())
        leaves[route] = (out, *grads)
    for name, a, b in zip(("out", "dq", "dk", "dv"), leaves["flash"],
                          leaves["autograd"]):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_allclose(_np(a), _np(b), err_msg=name,
                                   **_tol(dtype))


def test_cpu_tensors_never_reach_the_kernel_module(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernels/flash.py ran for a CPU tensor")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
        monkeypatch.setattr(flash, name, boom)
    q, k, v, g = (_torch(a, "float32").requires_grad_(True)
                  for a in _inputs(2, 40))
    out = ops.flash_attention(q, k, v, window=24)
    torch.autograd.grad(out, (q, k, v), g.detach())
    assert build.LAUNCHES["flash_fwd"] == build.LAUNCHES["flash_bwd_dq"] == \
        build.LAUNCHES["flash_bwd_dkdv"] == 0


def test_other_devices_raise():
    q = torch.empty(1, 8, 2, 32, device="meta")
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q)


def test_flash_wrappers_refuse_cpu_tensors():
    q = torch.randn(1, 8, 2, 32)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError):
        flash.flash_fwd(q, q, q)
    with pytest.raises(ValueError):
        flash.flash_bwd_dq(q, q, q, q, lse, lse)
    with pytest.raises(ValueError):
        flash.flash_bwd_dkdv(q, q, q, q, lse, lse)
    assert build._LIB is None          # nothing was built or loaded
