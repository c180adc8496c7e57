"""The port's Mamba2 pieces (models/ssm.py) and its SSM and hybrid
families against the JAX package on the CPU: the same inputs (numpy,
from a seed) and the same weights (the JAX package's init, carried over
by repro_torch.convert) through both, in fp32.  With the ``kernel``
evaluator the JAX package runs its Pallas SSD kernels in interpret mode
and the port the plain versions of its SSD kernels.

Tolerance: fp32 rtol 1e-5 (atol 1e-5 for values up to ~10) for the same
algorithm; 2e-4 where the two sides run different SSD evaluators
(chunked against the per-timestep scan: the reference's own
tests/test_models.py bound); gradients, whose backward sums run in
another order in each framework, rtol 1e-4 with an absolute floor of
1e-6 — for the lone block, driven by a unit cotangent, 1e-6 of the
leaf's largest entry (a weight gradient there sums b.S positions of
magnitude ~10, and an entry near zero holds their cancellation)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.models import ssm as jssm

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.models import Model
from repro_torch.models import ssm as tssm
from repro_torch.utils.tree import (tree_leaves, tree_leaves_with_path,
                                    tree_unflatten_like)

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ssd_inputs(S, H=3, P=8, N=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((2, S, H))))      # softplus
    A = -np.exp(rng.standard_normal(H) * 0.5)
    B, C = (rng.standard_normal((2, S, H, N)) for _ in range(2))
    arrs = [a.astype(np.float32) for a in (x, dt, A, B, C)]
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("S,chunk", [(32, 8), (40, 16), (7, 8)])
def test_ssd_evaluators_match_jax(S, chunk):
    jin, tin = _ssd_inputs(S)
    for name, jfn, tfn, tol in (
            ("scan", jssm.ssd_scan, tssm.ssd_scan, VAL),
            ("chunked", lambda *a: jssm.ssd_chunked(*a, chunk=chunk),
             lambda *a: tssm.ssd_chunked(*a, chunk=chunk), VAL)):
        (jy, js), (ty, ts) = jfn(*jin), tfn(*tin)
        np.testing.assert_allclose(_np(ty), _np(jy), err_msg=name, **tol)
        np.testing.assert_allclose(_np(ts), _np(js), err_msg=name, **tol)
    # the chunked algorithm against the scan oracle, both in the port
    y_c, s_c = tssm.ssd_chunked(*tin, chunk=chunk)
    y_s, s_s = tssm.ssd_scan(*tin)
    np.testing.assert_allclose(_np(y_c), _np(y_s), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(s_c), _np(s_s), rtol=2e-4, atol=2e-4)


def test_causal_conv1d_matches_jax():
    rng = np.random.default_rng(1)
    x, w, bias = (rng.standard_normal(s).astype(np.float32)
                  for s in ((2, 21, 40), (4, 40), (40,)))
    want = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(bias))
    got = tssm.causal_conv1d(*(torch.from_numpy(a) for a in (x, w, bias)))
    assert got.stride(-1) == 1
    np.testing.assert_allclose(_np(got), _np(want), **VAL)


def test_expand_groups_is_a_view_for_one_group():
    t = torch.randn(2, 5, 1, 16)
    e = tssm._expand_groups(t, 8, 1)
    assert e.shape == (2, 5, 8, 16) and e.stride(2) == 0
    assert e.data_ptr() == t.data_ptr()
    t2 = torch.randn(2, 5, 2, 16)
    want = jssm._expand_groups(jnp.asarray(t2.numpy()), 8, 2)
    np.testing.assert_array_equal(tssm._expand_groups(t2, 8, 2).numpy(),
                                  np.asarray(want))


def _arch(name, **kw):
    return jreduced(jget_arch(name), **kw), reduced(get_arch(name), **kw)


@pytest.mark.parametrize("evaluator", ["chunked", "scan", "kernel"])
def test_mamba_block_matches_jax(evaluator):
    """The Mamba2 block, forward and gradients, on the JAX package's
    weights; ``kernel`` runs the Pallas kernels interpreted (JAX) and the
    plain versions of the CUDA kernels (port)."""
    jarch, arch = _arch("mamba2_780m", d_model=64)
    jp = jssm.init_mamba(jax.random.PRNGKey(3), jarch)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(2).standard_normal((2, 40, 64)).astype(
        np.float32)
    jy, jvjp = jax.vjp(lambda p, x: jssm.mamba(p, jarch, x,
                                               evaluator=evaluator),
                       jp, jnp.asarray(x))
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tssm.mamba(tree_unflatten_like(tp, leaves), arch, tx,
                    evaluator=evaluator)
    np.testing.assert_allclose(_np(ty), _np(jy), **VAL)
    g = np.random.default_rng(4).standard_normal(ty.shape).astype(np.float32)
    jgp, jgx = jvjp(jnp.asarray(g))
    tg = torch.autograd.grad(ty, [*leaves, tx], torch.from_numpy(g))
    jleaves = dict(tree_leaves_with_path(jax.tree.map(np.asarray, jgp)))
    pairs = [("x", tg[-1], _np(jgx))] + [
        (path, got, jleaves[path])
        for (path, _), got in zip(tree_leaves_with_path(tp), tg[:-1])]
    for path, got, want in pairs:
        np.testing.assert_allclose(_np(got), want, err_msg=path, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(want).max()))


def _loss_and_grads(jm, tm, jp, seq=40):
    rng = np.random.default_rng(5)
    tokens, labels = (rng.integers(0, tm.arch.vocab_size, (2, seq))
                      for _ in range(2))
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    (jl, _), jg = jax.value_and_grad(lambda p: jm.loss(p, jb),
                                     has_aux=True)(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    tl, _ = tm.loss(tree_unflatten_like(tp, leaves), tb)
    tg = torch.autograd.grad(tl, leaves)
    want = dict(tree_leaves_with_path(jax.tree.map(np.asarray, jg)))
    got = dict(zip([p for p, _ in tree_leaves_with_path(tp)],
                   [_np(g) for g in tg]))
    return float(jl), float(tl.detach()), want, got


@pytest.mark.parametrize("name,attn_impl,ssd_impl", [
    ("mamba2_780m", "naive", "chunked"), ("mamba2_780m", "naive", "kernel"),
    ("hymba_1_5b", "naive", "chunked"), ("hymba_1_5b", "kernel", "kernel")])
def test_ssm_and_hybrid_models_match_jax(name, attn_impl, ssd_impl):
    """Reduced mamba2 (attention-free) and hymba (attention and Mamba
    heads in parallel, fused epilogues): loss and every gradient."""
    jarch, arch = _arch(name, layers=2)
    jm = JModel(jarch, dtype=jnp.float32, remat=False, attn_impl=attn_impl,
                ssd_impl=ssd_impl, scan_layers=False)
    tm = Model(arch, dtype=torch.float32, attn_impl=attn_impl,
               ssd_impl=ssd_impl)
    jl, tl, want, got = _loss_and_grads(jm, tm, jm.init(jax.random.PRNGKey(7)))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert want.keys() == got.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=path,
                                   **GRAD)


@pytest.mark.parametrize("name", ["mamba2_780m", "hymba_1_5b"])
def test_ssm_model_init_matches_reference_shapes(name):
    jarch, arch = _arch(name, layers=3)
    jp = JModel(jarch, dtype=jnp.float32).init(jax.random.PRNGKey(0))
    tp = Model(arch, dtype=torch.float32).init(
        torch.Generator().manual_seed(0))
    js = {p: (a.shape, a.dtype.name)
          for p, a in tree_leaves_with_path(jax.tree.map(np.asarray, jp))}
    ts = {p: (tuple(a.shape), str(a.dtype)[6:])
          for p, a in tree_leaves_with_path(tp)}
    assert js == ts
    tnp = dict(tree_leaves_with_path(to_numpy(tp)))
    for p, a in tree_leaves_with_path(jax.tree.map(np.asarray, jp)):
        if a.ndim >= 2 and a.size >= 1024:
            assert abs(a.std() - tnp[p].std()) <= 0.1 * a.std(), p


def test_ssd_impl_resolves_and_rejects():
    arch = reduced(get_arch("mamba2_780m"))
    assert Model(arch, ssd_impl="auto").ssd_impl == "kernel"
    with pytest.raises(ValueError):
        Model(arch, ssd_impl="pallas")
