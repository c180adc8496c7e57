"""The plain versions of the port's SSD kernels (kernels/ref.py) against
the JAX package's Pallas kernels run in interpret mode on the CPU
(``repro/kernels/ssd.py``), at the same chunk; the CPU route of
``ops.ssd`` (the custom backward's math) against autograd through the
per-timestep oracle ``ssd_ref``, and its chunk invariance.  Inputs come
from numpy with a seed: sequences 7, 33, 40 and 128 (ragged against the
16-row chunk), (P, N) = (8, 16) and (16, 8), fp32 and bf16.  Plus the
routing contract: a CPU tensor never reaches kernels/ssd.py, another
device raises, and the kernel wrappers refuse CPU tensors.

Tolerances against the Pallas kernels: each element within 1e-6 + rtol
of its value + 1e-5 of its cond, the sum of its terms' magnitudes (the
plain versions run on the inputs' magnitudes): the same fp32 algorithm
summed in another order rounds in proportion to that sum, and dA, a sum
over every position, is often a small fraction of it.  rtol is 1e-5 for
fp32 outputs (in bf16 too: the states, ddt and dA are fp32 on both
sides, computed from the same bf16 inputs) and 2e-2 (one bf16 ulp) for
bf16 outputs.  Against the per-timestep oracle, which sums in another
order altogether, the reference's own 2e-4 (forward) and 2e-3
(gradients) of tests/test_kernels.py."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ssd as jssd

from repro_torch.kernels import build, ops, ref, ssd

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

b, H, CHUNK = 2, 3, 16
SHAPES = [(S, P, N) for S in (7, 33, 40, 128) for P, N in ((8, 16), (16, 8))]


def _close(got, want, cond, name):
    """|got - want| <= 1e-6 + rtol |want| + 1e-5 cond (see the module
    docstring); ``want`` and ``cond`` are float32 numpy arrays."""
    rtol = 2e-2 if got.dtype == torch.bfloat16 else 1e-5
    diff = np.abs(_np(got) - want)
    limit = 1e-6 + rtol * np.abs(want) + 1e-5 * cond
    assert (diff <= limit).all(), (name, float(diff.max()),
                                   float((diff - limit).max()))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _chunk(S):
    """The reference kernels' chunk at sequence S (``_ssd_call`` takes
    min(chunk, max(S, 8)))."""
    return min(CHUNK, max(S, 8))


@functools.lru_cache(maxsize=None)
def _inputs(S, P, N):
    """(x, dt, A, B, C, gy, gstate) as float32 numpy arrays."""
    rng = np.random.default_rng(S * 100 + P * 10 + N)
    x = rng.standard_normal((b, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H))))      # softplus
    A = -np.exp(rng.standard_normal(H) * 0.5)
    B, C = (rng.standard_normal((b, S, H, N)) for _ in range(2))
    gy = rng.standard_normal((b, S, H, P))
    gstate = rng.standard_normal((b, H, P, N))
    return tuple(a.astype(np.float32) for a in (x, dt, A, B, C, gy, gstate))


def _torch(S, P, N, dtype):
    """The port's inputs: x, B, C and gy in dtype, the rest fp32."""
    x, dt, A, B, C, gy, gs = (torch.from_numpy(np.array(a))
                              for a in _inputs(S, P, N))
    return (x.to(dtype), dt, A, B.to(dtype), C.to(dtype), gy.to(dtype), gs)


@functools.lru_cache(maxsize=None)
def _conds(S, P, N):
    """The sums of the terms' magnitudes of (y, state, cstates, dx, ddt,
    dA, dB, dC), float32 numpy arrays."""
    x, dt, A, B, C, gy, gs = (torch.from_numpy(np.array(a))
                              for a in _inputs(S, P, N))
    ax, aB, aC = x.abs(), B.abs(), C.abs()
    fwd = ref.ssd_fwd_ref(ax, dt, A, aB, aC, chunk=_chunk(S))
    bwd = ref.ssd_bwd_ref(ax, dt, A, aB, aC, fwd[2], gy.abs(), gs.abs(),
                          chunk=_chunk(S), magnitudes=True)
    return tuple(_np(t) for t in (*fwd, *bwd))


@functools.lru_cache(maxsize=None)
def _pallas(S, P, N, dtype):
    """The JAX package's forward-for-backward and backward kernels,
    interpreted: (y, state, cstates, dx, ddt, dA, dB, dC) as float32
    numpy arrays."""
    x, dt, A, B, C, gy, gs = (jnp.asarray(a) for a in _inputs(S, P, N))
    jd = getattr(jnp, dtype)
    x, B, C, gy = (t.astype(jd) for t in (x, B, C, gy))
    kw = dict(chunk=_chunk(S), interpret=True)
    y, state, cstates = jssd.ssd_fwd(x, dt, A, B, C, **kw)
    grads = jssd.ssd_bwd(x, dt, A, B, C, cstates, gy, gs, **kw)
    return tuple(_np(t) for t in (y, state, cstates, *grads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,P,N", SHAPES)
def test_ssd_fwd_ref_matches_pallas(S, P, N, dtype):
    x, dt, A, B, C, _, _ = _torch(S, P, N, getattr(torch, dtype))
    y, state, cstates = ref.ssd_fwd_ref(x, dt, A, B, C, chunk=_chunk(S))
    want = _pallas(S, P, N, dtype)[:3]
    assert y.dtype == x.dtype and tuple(y.shape) == (b, S, H, P)
    nc = -(-S // _chunk(S))
    assert tuple(state.shape) == (b, H, P, N) and state.dtype == torch.float32
    assert tuple(cstates.shape) == (b, H, nc, P, N)
    for name, got, exp, cond in zip(("y", "state", "cstates"),
                                    (y, state, cstates), want,
                                    _conds(S, P, N)):
        _close(got, exp, cond, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,P,N", SHAPES)
def test_ssd_bwd_ref_matches_pallas(S, P, N, dtype):
    """Both backwards on the same cstates (the Pallas forward's) and
    random cotangents of y and of the final state."""
    x, dt, A, B, C, gy, gs = _torch(S, P, N, getattr(torch, dtype))
    want = _pallas(S, P, N, dtype)
    cstates = torch.from_numpy(np.array(want[2]))
    got = ref.ssd_bwd_ref(x, dt, A, B, C, cstates, gy, gs, chunk=_chunk(S))
    for name, a, exp, cond, like in zip(("dx", "ddt", "dA", "dB", "dC"), got,
                                        want[3:], _conds(S, P, N)[3:],
                                        (x, dt, A, B, C)):
        assert a.dtype == like.dtype and a.shape == like.shape, name
        _close(a, exp, cond, name)


@pytest.mark.parametrize("S,P,N", SHAPES)
def test_ssd_cpu_gradients_match_autograd_through_oracle(S, P, N):
    """ops.ssd's CPU route (forward saving cstates, the reverse-chunk
    backward's math) against autograd through ssd_ref, y and the final
    state both used, dA included."""
    x, dt, A, B, C, gy, gs = _torch(S, P, N, torch.float32)
    outs = {}
    for route in ("ops", "oracle"):
        leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C)]
        fn = (functools.partial(ops.ssd, chunk=CHUNK) if route == "ops"
              else ref.ssd_ref)
        y, state = fn(*leaves)
        outs[route] = (y, state, *torch.autograd.grad((y, state), leaves,
                                                      (gy, gs)))
    for name, a, c, tol in zip(
            ("y", "state", "dx", "ddt", "dA", "dB", "dC"), outs["ops"],
            outs["oracle"], [2e-4] * 2 + [2e-3] * 5):
        np.testing.assert_allclose(_np(a), _np(c), rtol=tol, atol=tol,
                                   err_msg=name)


def test_ssd_unused_state_gets_a_zero_cotangent():
    """Only y used: the state's cotangent is fp32 zeros, as the
    reference's custom VJP takes it."""
    x, dt, A, B, C, gy, _ = _torch(40, 8, 16, torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C)]
    y, _ = ops.ssd(*leaves)
    got = torch.autograd.grad(y, leaves, gy)
    want = ref.ssd_bwd_ref(x, dt, A, B, C,
                           ref.ssd_fwd_ref(x, dt, A, B, C)[2], gy,
                           torch.zeros(b, H, 8, 16))
    for a, c in zip(got, want):
        assert torch.equal(a, c)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunk_invariance(chunk):
    x, dt, A, B, C, gy, _ = _torch(128, 16, 8, torch.float32)
    outs = {}
    for q in (chunk, 32):
        leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C)]
        y, state = ops.ssd(*leaves, chunk=q)
        outs[q] = (y, state, *torch.autograd.grad(y, leaves, gy))
    for a, c in zip(outs[chunk], outs[32]):
        np.testing.assert_allclose(_np(a), _np(c), rtol=2e-4, atol=2e-4)


def test_ssd_expanded_groups_match_copies():
    """B and C as one group viewed over the heads (head stride 0), as the
    Mamba2 block passes them: the same values and gradients as per-head
    copies."""
    x, dt, A, B, C, gy, _ = _torch(33, 16, 8, torch.float32)
    Bg, Cg = B[:, :, :1], C[:, :, :1]
    outs = []
    for copy in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in (x, Bg, Cg)]
        xx, bb, cc = leaves
        bb, cc = (t.expand(b, 33, H, 8) for t in (bb, cc))
        if copy:
            bb, cc = bb.contiguous(), cc.contiguous()
        else:
            assert bb.stride(2) == 0
        y, _ = ops.ssd(xx, dt, A, bb, cc)
        outs.append((y, *torch.autograd.grad(y, leaves, gy)))
    for a, c in zip(*outs):
        np.testing.assert_allclose(_np(a), _np(c), rtol=1e-6, atol=1e-6)


def test_cpu_tensors_never_reach_the_kernel_module(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernels/ssd.py ran for a CPU tensor")
    for name in ("ssd_fwd", "ssd_bwd"):
        monkeypatch.setattr(ssd, name, boom)
    x, dt, A, B, C, gy, _ = _torch(40, 8, 16, torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C)]
    y, _ = ops.ssd(*leaves)
    torch.autograd.grad(y, leaves, gy)
    assert build.LAUNCHES["ssd_fwd"] == build.LAUNCHES["ssd_bwd"] == 0


def test_other_devices_raise():
    x = torch.empty(1, 8, 2, 16, device="meta")
    dt = torch.empty(1, 8, 2, device="meta")
    with pytest.raises(ValueError):
        ops.ssd(x, dt, torch.empty(2, device="meta"), x, x)


def test_ssd_wrappers_refuse_cpu_tensors():
    x, dt, A, B, C, gy, gs = _torch(40, 16, 16, torch.float32)
    cstates = torch.zeros(b, H, 1, 16, 16)
    with pytest.raises(ValueError):
        ssd.ssd_fwd(x, dt, A, B, C)
    with pytest.raises(ValueError):
        ssd.ssd_bwd(x, dt, A, B, C, cstates, gy, gs)
    assert build._LIB is None          # nothing was built or loaded
