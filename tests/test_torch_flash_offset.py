"""Attention with fewer queries than keys, on the CPU: the queries are
the last Sq of Sk positions (a sequence shard's queries against the keys
up to the shard's end, ``models/attention.py``), so query i sees keys
<= i + Sk - Sq.

The oracle is the full problem: attention over all Sk queries through
autograd of ``ref.attention_ref``, restricted to its last Sq rows (the
cotangent zero on the others).  Held against it, on inputs from numpy
with a seed, with and without a sliding window, GQA included:

  * the flash kernels' plain versions ``ref.flash_fwd_ref`` and
    ``ref.flash_bwd_ref`` (out, lse, dq; dk and dv over all Sk rows,
    zero where no query sees a key);
  * ``ops.flash_attention``'s CPU route (the flash backward's math
    through its autograd Function);
  * the model's ``_sdpa_naive`` and ``_sdpa_blocked``.

Tolerances as tests/test_torch_flash.py: fp32 rtol = atol = 1e-5, bf16
2e-2.  The kernels' own walks at Sq < Sk are emulated in
tests/test_torch_flash_tiles.py; the card holds them in chip_smoke.py
phase 3 and tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn

torch.set_num_threads(1)

B, D = 2, 16
#: (H, KV, Sq, Sk, window)
CASES = [(2, 2, 8, 24, 0), (4, 2, 8, 24, 6), (4, 1, 13, 40, 0),
         (4, 2, 20, 20, 5), (2, 2, 1, 9, 0), (6, 2, 16, 64, 20)]


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
            else dict(rtol=1e-5, atol=1e-5))


def _inputs(H, KV, Sq, Sk, dtype, seed=0):
    rng = np.random.default_rng(seed + 97 * Sk + Sq)
    q, g = (torch.from_numpy(rng.standard_normal((B, Sk, H, D))
                             .astype(np.float32)).to(dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, Sk, KV, D))
                             .astype(np.float32)).to(dtype) for _ in range(2))
    g[:, :Sk - Sq] = 0
    return q, k, v, g


def _oracle(q, k, v, g, Sq, window):
    """(out, dq of the last Sq rows, dk, dv) of the full problem whose
    cotangent is zero on the first Sk - Sq rows."""
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = ref.attention_ref(q, k, v, window=window)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
    Sk = q.shape[1]
    return out[:, Sk - Sq:].detach(), dq[:, Sk - Sq:], dk, dv


def _close(got, want, dtype, what):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               want.detach().float().numpy(), err_msg=what,
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("H,KV,Sq,Sk,window", CASES)
def test_plain_flash_versions_take_fewer_queries(H, KV, Sq, Sk, window,
                                                 dtype):
    q, k, v, g = _inputs(H, KV, Sq, Sk, dtype)
    out_w, dq_w, dk_w, dv_w = _oracle(q, k, v, g, Sq, window)
    qs, gs = q[:, Sk - Sq:], g[:, Sk - Sq:].contiguous()
    out, lse = ref.flash_fwd_ref(qs, k, v, window=window)
    assert out.shape == (B, Sq, H, D) and lse.shape == (B, H, Sq)
    _close(out, out_w, dtype, "out")
    # the lse of the full problem's last rows
    _close(lse, ref.flash_fwd_ref(q, k, v, window=window)[1][..., Sk - Sq:],
           torch.float32, "lse")
    dq, dk, dv = ref.flash_bwd_ref(qs, k, v, out, lse, gs, window=window)
    assert dk.shape == dv.shape == k.shape
    for name, a, b in (("dq", dq, dq_w), ("dk", dk, dk_w), ("dv", dv, dv_w)):
        _close(a, b, dtype, name)
    if window:      # keys no query sees get exact zeros
        unseen = Sk - Sq - window + 1
        if unseen > 0:
            assert not dk[:, :unseen].any() and not dv[:, :unseen].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("H,KV,Sq,Sk,window", CASES)
def test_flash_attention_cpu_route_takes_fewer_queries(H, KV, Sq, Sk, window,
                                                       dtype):
    q, k, v, g = _inputs(H, KV, Sq, Sk, dtype)
    out_w, dq_w, dk_w, dv_w = _oracle(q, k, v, g, Sq, window)
    qs = q[:, Sk - Sq:].detach().requires_grad_(True)
    kk, vv = (t.detach().requires_grad_(True) for t in (k, v))
    out = ops.flash_attention(qs, kk, vv, window=window)
    dq, dk, dv = torch.autograd.grad(out, (qs, kk, vv), g[:, Sk - Sq:])
    for name, a, b in (("out", out, out_w), ("dq", dq, dq_w),
                       ("dk", dk, dk_w), ("dv", dv, dv_w)):
        _close(a, b, dtype, name)


@pytest.mark.parametrize("impl", ["naive", "blocked"])
@pytest.mark.parametrize("H,KV,Sq,Sk,window", CASES)
def test_model_attention_takes_fewer_queries(H, KV, Sq, Sk, window, impl):
    """The model's two plain attentions, fp32, the blocked one over kv
    blocks of 8 (a ragged last block in most cases)."""
    dtype = torch.float32
    q, k, v, g = _inputs(H, KV, Sq, Sk, dtype)
    out_w, dq_w, dk_w, dv_w = _oracle(q, k, v, g, Sq, window)
    qs = q[:, Sk - Sq:].detach().requires_grad_(True)
    kk, vv = (t.detach().requires_grad_(True) for t in (k, v))
    if impl == "naive":
        out = attn._sdpa_naive(qs, kk, vv, causal=True, window=window)
    else:
        out = attn._sdpa_blocked(qs, kk, vv, causal=True, window=window,
                                 block_kv=8)
    dq, dk, dv = torch.autograd.grad(out, (qs, kk, vv), g[:, Sk - Sq:])
    for name, a, b in (("out", out, out_w), ("dq", dq, dq_w),
                       ("dk", dk, dk_w), ("dv", dv, dv_w)):
        _close(a, b, dtype, name)


def test_more_queries_than_keys_raise():
    q, k = torch.randn(1, 8, 2, D), torch.randn(1, 4, 2, D)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        ops.flash_attention(q, k, k)
