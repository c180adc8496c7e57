"""The reference's default dtype, bf16 activations over fp32 parameters
(``src/repro/models/transformer.py``'s ``Model.dtype``; the SPMD fast
path's ``build_model``), through the port against the JAX package on the
CPU, at ``reduced(...)`` sizes (2 layers, d_model 64, 4 experts top-2),
with the same weights (the reference's init, carried over by convert.py)
and the same tokens and frontend embeddings (numpy, from a seed) as
tests/test_torch_archs.py:

  * ``Model.loss`` and its gradients for all ten architectures against
    the reference's ``Model(dtype=jnp.bfloat16)``;
  * remat full and the chunked CE in bf16 (qwen3-1.7b, hymba-1.5b)
    against the same model without them, and against the reference's
    plain bf16 model;
  * one ``SPMDExecutor`` step of ``build_model``'s default dtype (bf16)
    against the reference's ``build_train_step`` in bf16, jitted
    (qwen3-1.7b, hymba-1.5b).

Tolerances.  bf16 keeps 8 bits of mantissa, so two correct bf16
programs that round at different points (XLA fuses and reorders where
torch runs op by op) differ by about what bf16 costs against fp32; the
bound is therefore the reference's own bf16 error, not a constant:

  * loss: rtol 5e-4 against the reference's bf16 loss (the losses are
    fp32 reductions of fp32 logits over bf16 hidden states; measured
    relative gaps 4.6e-7 to 1.2e-4 over the ten, qwen2-moe the largest);
  * each gradient leaf: max |port - ref bf16| <= 2 x max |ref bf16 -
    ref fp32| on that leaf, the gap floored at 1e-3 of the leaf's
    max |ref bf16| (a leaf that bf16 hardly moves).  Measured, the
    largest ratio of the port's distance to the reference's own gap in
    each architecture: 0.69-1.41 (mamba2's ``conv_b`` the largest: its
    gradient is a sum over every position of the conv's bf16 output,
    which XLA and torch reduce in other orders; the casts around the
    conv are the reference's);
  * MoE: every routing decision's top-k margin above 1e-4, as
    tests/test_torch_archs.py asserts it, so a flipped route reads as a
    fault;
  * the step: loss as above; the parameters after it by
    tests/test_executor.py's ``assert_params_track``, max |diff| <= 2.5
    lr on every leaf, but with the share of elements off by more than
    lr / 10 held to 2 x the reference's own bf16-to-fp32 share after the
    same step (floored at that test's 1e-3).  AdamW's first update is
    lr * g / (|g| + eps), so an element whose bf16 gradient sits inside
    bf16's noise flips sign and moves by 2 lr: measured, the reference's
    bf16 step against its fp32 step 0.0053 (qwen3-1.7b) and 0.0055
    (hymba-1.5b) of the elements, the port against the reference's bf16
    0.0036 and 0.0051; 1e-3 fails them both.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.optim import adamw as jadamw
from repro.runtime.spmd import build_train_step

from repro_torch.configs import ARCH_IDS, ShapeConfig, get_arch, reduced
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.models import moe as tmoe
from repro_torch.optim import adamw
from repro_torch.runtime import ShardingStrategy, SPMDExecutor
from repro_torch.runtime.spmd import build_model
from repro_torch.utils.tree import (tree_leaves, tree_leaves_with_path,
                                    tree_unflatten_like)

torch.set_num_threads(1)

LOSS_RTOL = 5e-4
#: a port leaf may sit this many times the reference's own bf16-to-fp32
#: gap from the reference's bf16 gradient
GAP_RATIO = 2.0
#: the gap's floor, a fraction of the leaf's largest |gradient|
GAP_FLOOR = 1e-3
MARGIN = 1e-4
B, S = 2, 16
LR = 1e-3


@pytest.fixture
def margins(monkeypatch):
    """The smallest top-k margin of every routing decision the port
    makes while the test runs."""
    seen = []
    real = tmoe._route

    def recording(router, x, k):
        out = real(router, x, k)
        p = torch.sort(out[0].detach(), -1, descending=True).values
        seen.append(float((p[..., k - 1] - p[..., k]).min()))
        return out
    monkeypatch.setattr(tmoe, "_route", recording)
    return seen


def _setup(arch_id, seed=0):
    """(reduced reference arch, reduced port arch, reference params, the
    same params as torch tensors); tests/test_torch_archs.py's."""
    jarch, arch = jreduced(jget_arch(arch_id)), reduced(get_arch(arch_id))
    jp = JModel(jarch, dtype=jnp.float32, scan_layers=False).init(
        jax.random.PRNGKey(seed))
    return jarch, arch, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                              "cpu")


def _batch(arch, seed=1, b=B):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, arch.vocab_size, (b, S + 1)).astype(np.int32)
    batch = {"tokens": arr[:, :-1], "labels": arr[:, 1:]}
    if arch.frontend:
        batch["frontend_embeds"] = (rng.standard_normal(
            (b, arch.frontend_tokens, arch.d_model)) * 0.02).astype(np.float32)
    return batch


def _ref_loss_and_grads(jarch, jp, batch, dtype, **kw):
    jm = JModel(jarch, dtype=dtype, scan_layers=False,
                **dict(dict(remat=False, attn_impl="naive"), **kw))
    (loss, _), grads = jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    return float(loss), dict(tree_leaves_with_path(
        jax.tree.map(lambda g: np.asarray(g, np.float32), grads)))


@functools.lru_cache(maxsize=None)
def _reference(arch_id):
    """(reduced archs, params, batch, the reference's bf16 loss, its bf16
    gradients, each leaf's allowance ``_gaps``) of the plain model (no
    remat, the whole CE), computed once a module."""
    jarch, arch, jp, tp = _setup(arch_id)
    batch = _batch(arch)
    l16, g16 = _ref_loss_and_grads(jarch, jp, batch, jnp.bfloat16)
    _, g32 = _ref_loss_and_grads(jarch, jp, batch, jnp.float32)
    return arch, tp, batch, l16, g16, _gaps(g16, g32)


def _port_loss_and_grads(arch, tp, batch, **kw):
    model = Model(arch, **dict(dict(dtype=torch.bfloat16, attn_impl="naive",
                                    remat=False), **kw))
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    loss, _ = model.loss(tree_unflatten_like(tp, leaves),
                         {k: torch.from_numpy(v.copy())
                          for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), dict(tree_leaves_with_path(to_numpy(
        tree_unflatten_like(tp, list(grads)))))


def _gaps(ref16, ref32):
    """Each leaf's allowance: the reference's own bf16-to-fp32 gap,
    floored at GAP_FLOOR of the leaf's largest |gradient|."""
    return {k: max(float(np.abs(ref16[k] - ref32[k]).max()),
                   GAP_FLOOR * float(np.abs(ref16[k]).max()))
            for k in ref16}


def _assert_within_gap(got, ref16, gaps):
    assert got.keys() == ref16.keys()
    worst = {k: float(np.abs(got[k] - ref16[k]).max()) / gaps[k]
             for k in ref16 if gaps[k] > 0}
    for k in ref16:
        if gaps[k] == 0:        # a leaf no input reaches
            np.testing.assert_array_equal(got[k], ref16[k], err_msg=k)
    bad = {k: r for k, r in worst.items() if r > GAP_RATIO}
    assert not bad, f"leaves beyond {GAP_RATIO} x the reference's gap: {bad}"


def _assert_margins(arch, margins):
    if arch.moe is not None:
        assert margins and min(margins) > MARGIN, min(margins)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_bf16_loss_and_grads_match_reference(arch_id, margins):
    arch, tp, batch, l16, g16, gaps = _reference(arch_id)
    loss, grads = _port_loss_and_grads(arch, tp, batch)
    _assert_margins(arch, margins)
    np.testing.assert_allclose(loss, l16, rtol=LOSS_RTOL)
    _assert_within_gap(grads, g16, gaps)


BF16_ARCHS = ["qwen3_1_7b", "hymba_1_5b"]


@pytest.mark.parametrize("arch_id", BF16_ARCHS)
def test_bf16_remat_and_chunked_ce_match_plain_and_reference(arch_id):
    """Remat full and the chunked CE (8 positions a chunk) change where
    bf16 rounds only through the CE's fp32 sums: the port with them
    against the port without them and against the reference's plain
    bf16 model, each at the bf16 tolerance (the plain model's gaps)."""
    arch, tp, batch, l16, g16, gaps = _reference(arch_id)
    plain = _port_loss_and_grads(arch, tp, batch)
    loss, grads = _port_loss_and_grads(arch, tp, batch, remat=True,
                                       remat_policy="full", loss_chunk=8)
    np.testing.assert_allclose(loss, plain[0], rtol=LOSS_RTOL)
    _assert_within_gap(grads, plain[1], gaps)
    np.testing.assert_allclose(loss, l16, rtol=LOSS_RTOL)
    _assert_within_gap(grads, g16, gaps)


@pytest.mark.parametrize("arch_id", BF16_ARCHS)
def test_bf16_spmd_step_tracks_reference_train_step(arch_id):
    """``build_model``'s default dtype is bf16, as the reference's; one
    ``SPMDExecutor`` step (remat full, the chunked CE) against the
    reference's ``build_train_step`` on the same bf16 model, jitted."""
    jarch, arch, jp, tp = _setup(arch_id, seed=3)
    gb = 4
    batch = _batch(arch, seed=5, b=gb)
    opt = dict(lr=LR, warmup_steps=0, clip_norm=1.0, weight_decay=0.0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = {}
    for dtype in (jnp.bfloat16, jnp.float32):
        jm = JModel(jarch, dtype=dtype, remat=True, attn_impl="naive",
                    loss_chunk=8, scan_layers=False)
        step = jax.jit(build_train_step(jm, jadamw.AdamWConfig(**opt)))
        p, _, stats = step(jp, jadamw.init(jp), jbatch)
        ref[dtype] = (jax.tree.leaves(jax.tree.map(np.asarray, p)),
                      float(stats["loss"]))
    assert JModel(jarch).dtype == jnp.bfloat16
    shape = ShapeConfig("bf16", S, gb, "train")
    mesh = make_mesh((1, 1), ("data", "model"))
    model = build_model(arch, ShardingStrategy(), mesh, gb,
                        attn_impl="naive", loss_chunk=8)
    assert model.dtype == torch.bfloat16 and model.remat
    ex = SPMDExecutor(model, tp, adamw.AdamWConfig(**opt), mesh=mesh,
                      strategy=ShardingStrategy(), shape=shape)
    loss = float(ex.step(batch)["loss"])
    (p16, l16), (p32, _) = ref[jnp.bfloat16], ref[jnp.float32]
    np.testing.assert_allclose(loss, l16, rtol=LOSS_RTOL)
    got = tree_leaves(to_numpy(ex.params))
    for x, y in zip(p16, got):
        assert np.abs(x - y).max() <= 2.5 * LR, np.abs(x - y).max()

    def share(a, b):
        return (sum(int((np.abs(x - y) > LR / 10).sum()) for x, y in zip(a, b))
                / sum(x.size for x in a))
    allowed = max(1e-3, GAP_RATIO * share(p16, p32))
    assert share(p16, got) <= allowed, (share(p16, got), allowed)
    assert ex.cache.stats.compiles == 1
    assert all(t.dtype == torch.float32 for t in tree_leaves(ex.params))
