"""The port's layers, attention, block and Model.loss against the JAX
package on the CPU: the same inputs (numpy, from a seed) and the same
weights (the JAX package's init, carried over by repro_torch.convert)
through both, in fp32.  On the CPU both packages run the plain versions
of the fused QKV and residual-add + RMSNorm; with ``impl="kernel"`` the
JAX package runs its Pallas flash attention in interpret mode and the
port the plain versions of its flash kernels.

Tolerance: fp32 rtol 1e-5 for values; gradients, which go through a
backward whose sums run in another order in each framework, at
rtol 1e-4 with an absolute floor of 1e-6 for near-zero entries."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro.models import layers as jlayers

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.models import Model
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.utils.tree import (tree_leaves, tree_leaves_with_path,
                                    tree_unflatten_like)

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(a, b, **tol):
    np.testing.assert_allclose(_np(a), _np(b), **(tol or VAL))


def randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def test_rms_norm():
    rng = np.random.default_rng(0)
    (xj, xt), (wj, wt) = both(randn(rng, 4, 16, 64)), both(
        randn(rng, 64, scale=0.2) + 1)
    close(jlayers.rms_norm(wj, xj, 1e-6), tlayers.rms_norm(wt, xt, 1e-6))


def test_apply_rope():
    rng = np.random.default_rng(1)
    xj, xt = both(randn(rng, 2, 16, 4, 16))
    pos = np.broadcast_to(np.arange(16), (2, 16)).astype(np.int32)
    close(jlayers.apply_rope(xj, jnp.asarray(pos), 10000.0),
          tlayers.apply_rope(xt, torch.from_numpy(pos.copy()), 10000.0))


@pytest.mark.parametrize("variant", ["gelu", "swiglu"])
def test_mlp(variant):
    rng = np.random.default_rng(2)
    names = ("gate", "up", "down") if variant == "swiglu" else ("up", "down")
    p = {n: randn(rng, *((128, 64) if n == "down" else (64, 128)), scale=0.1)
         for n in names}
    xj, xt = both(randn(rng, 2, 8, 64))
    close(jlayers.mlp({k: jnp.asarray(v) for k, v in p.items()}, xj, variant),
          tlayers.mlp(params_from_numpy(p, "cpu"), xt, variant))


@pytest.mark.parametrize("masked", [False, True])
def test_embed_unembed_cross_entropy(masked):
    rng = np.random.default_rng(3)
    table = {"table": randn(rng, 512, 64, scale=0.02)}
    tok = rng.integers(0, 512, (2, 16)).astype(np.int32)
    lab = rng.integers(0, 512, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) > 0.3).astype(np.float32) if masked else None
    jt = {"table": jnp.asarray(table["table"])}
    tt = params_from_numpy(table, "cpu")
    xj = jlayers.embed(jt, jnp.asarray(tok), jnp.float32)
    xt = tlayers.embed(tt, torch.from_numpy(tok), torch.float32)
    close(xj, xt, rtol=0, atol=0)
    lj, lt = jlayers.unembed(jt, xj), tlayers.unembed(tt, xt)
    close(lj, lt)
    close(jlayers.cross_entropy(lj, jnp.asarray(lab),
                                None if mask is None else jnp.asarray(mask)),
          tlayers.cross_entropy(lt, torch.from_numpy(lab),
                                None if mask is None else torch.from_numpy(mask)))


ARCHS = ["gpt3_medium", "qwen3_1_7b", "qwen2_5_3b"]   # plain, qk_norm, qkv_bias


@pytest.mark.parametrize("arch_name", ARCHS)
@pytest.mark.parametrize("impl", ["naive", "blocked", "kernel"])
@pytest.mark.parametrize("fused", [True, False])
def test_attention(arch_name, impl, fused):
    jarch = jreduced(jget_arch(arch_name), layers=1)
    arch = reduced(get_arch(arch_name), layers=1)
    params = jax.tree.map(np.asarray, jattn.init_attention(
        jax.random.PRNGKey(4), jarch))
    if jarch.qkv_bias:       # zero at init: give the bias path real values
        rng = np.random.default_rng(9)
        for k in ("bq", "bk", "bv"):
            params[k] = randn(rng, *params[k].shape, scale=0.1)
    rng = np.random.default_rng(5)
    xj, xt = both(randn(rng, 2, 48, arch.d_model))
    oj = jattn.attention(jax.tree.map(jnp.asarray, params), jarch, xj,
                         impl=impl, fused=fused, block_kv=16)
    ot = tattn.attention(params_from_numpy(params, "cpu"), arch, xt,
                         impl=impl, fused=fused, block_kv=16)
    close(oj, ot)


def _models(arch_name, impl, fuse, layers=2):
    jarch = jreduced(jget_arch(arch_name), layers=layers)
    jm = JModel(jarch, dtype=jnp.float32, remat=False, attn_impl=impl,
                fuse=fuse, scan_layers=False)
    tm = Model(reduced(get_arch(arch_name), layers=layers),
               dtype=torch.float32, attn_impl=impl, fuse=fuse)
    jparams = jm.init(jax.random.PRNGKey(6))
    return jm, tm, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("impl", ["naive", "blocked"])
@pytest.mark.parametrize("fuse", ["fused", "none"])
def test_block(impl, fuse):
    jm, tm, jp, tp = _models("gpt3_medium", impl, fuse)
    rng = np.random.default_rng(7)
    xj, xt = both(randn(rng, 2, 16, 64))
    jbp = jax.tree.map(lambda t: t[1], jp["blocks"])
    from repro_torch.utils.tree import tree_map
    tbp = tree_map(lambda t: t[1], tp["blocks"])
    yj, _ = jm.block(jbp, xj, jnp.zeros(()))
    yt, _ = tm.block(tbp, xt, torch.zeros(()))
    close(yj, yt)


@pytest.mark.parametrize("arch_name", ["gpt3_medium", "qwen3_1_7b"])
@pytest.mark.parametrize("impl", ["naive", "blocked", "kernel"])
@pytest.mark.parametrize("fuse", ["fused", "none"])
def test_model_loss_and_grads(arch_name, impl, fuse):
    jm, tm, jp, tp = _models(arch_name, impl, fuse)
    rng = np.random.default_rng(8)
    arr = rng.integers(0, 512, (2, 17)).astype(np.int32)
    batch = {"tokens": arr[:, :-1], "labels": arr[:, 1:]}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()})[0]
    )(jp)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    tparams = tree_unflatten_like(tp, leaves)
    tloss, _ = tm.loss(tparams, {k: torch.from_numpy(v.copy())
                                 for k, v in batch.items()})
    tgrads = torch.autograd.grad(tloss, leaves)
    close(jloss, tloss)
    jg = dict(tree_leaves_with_path(jax.tree.map(np.asarray, jgrads)))
    tg = dict(tree_leaves_with_path(to_numpy(
        tree_unflatten_like(tp, list(tgrads)))))
    assert jg.keys() == tg.keys()
    for path in jg:
        np.testing.assert_allclose(tg[path], jg[path], err_msg=path, **GRAD)


def test_model_init_matches_reference_shapes():
    jm, tm, jp, _ = _models("gpt3_medium", "naive", "fused", layers=3)
    gen = torch.Generator().manual_seed(0)
    tp = tm.init(gen)
    js = {p: (a.shape, a.dtype.name)
          for p, a in tree_leaves_with_path(jax.tree.map(np.asarray, jp))}
    ts = {p: (tuple(a.shape), str(a.dtype)[6:])
          for p, a in tree_leaves_with_path(tp)}
    assert js == ts
    # same scales: the per-leaf standard deviations agree loosely
    for p, a in tree_leaves_with_path(jax.tree.map(np.asarray, jp)):
        t = dict(tree_leaves_with_path(to_numpy(tp)))[p]
        if a.ndim >= 2 and a.size >= 1024:
            assert abs(a.std() - t.std()) <= 0.1 * a.std(), p


def test_unported_families_and_paths_raise():
    """Every family is ported: each of the 10 assigned architectures
    constructs (MoE, SSM, hybrid and the frontends included), with the
    reference's defaults; an unknown implementation name still raises."""
    from repro_torch.configs import ARCH_IDS
    for name in ARCH_IDS:
        m = Model(reduced(get_arch(name)))
        assert (m.moe_impl, m.remat, m.remat_policy, m.loss_chunk) == (
            "dense", True, "full", 0), name
    for name in ("mamba2_780m", "hymba_1_5b"):     # ported with the SSD
        assert Model(reduced(get_arch(name))).ssd_impl == "chunked"
    assert Model(reduced(get_arch("gpt3_medium")),
                 attn_impl="auto").attn_impl == "kernel"
    for bad in (dict(moe_impl="sparse"), dict(remat_policy="none"),
                dict(attn_impl="flash"), dict(ssd_impl="fast")):
        with pytest.raises(ValueError):
            Model(reduced(get_arch("granite_moe_1b_a400m")), **bad)


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no-mask"])
def test_model_loss_honours_the_mask(masked):
    """Model.loss of reduced gpt3-medium against the JAX package's with a
    0/1 mask that drops about 30 % of the positions (sliced [:, :-1] as
    the reference slices it), and without one; the same weights through
    convert.py; test_executor.py's fp32 tolerance (atol 5e-7, rtol
    5e-4)."""
    jm, tm, jp, tp = _models("gpt3_medium", "naive", "fused")
    rng = np.random.default_rng(10)
    arr = rng.integers(0, 512, (2, 33)).astype(np.int32)
    batch = {"tokens": arr[:, :-1], "labels": arr[:, 1:]}
    if masked:
        batch["mask"] = (rng.random((2, 32)) >= 0.3).astype(np.float32)
    jloss, _ = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, _ = tm.loss(tp, {k: torch.from_numpy(v.copy())
                            for k, v in batch.items()})
    np.testing.assert_allclose(_np(tloss), _np(jloss), atol=5e-7, rtol=5e-4)
    if masked:      # the mask changes the loss: it was not dropped
        unmasked, _ = tm.loss(tp, {k: torch.from_numpy(v.copy())
                                   for k, v in batch.items() if k != "mask"})
        assert abs(float(unmasked) - float(tloss)) > 1e-4
