"""Every assigned architecture (configs ARCH_IDS: dense, MoE, SSM, hybrid,
vision and audio frontends) through the port's Model against the JAX
package's on the CPU, reduced (2 layers, d_model 64, 4 experts top-2)
as tests/test_arch_smoke.py reduces them: the same weights (the
reference's init, carried over by convert.py) and the same tokens and
frontend embeddings (numpy, from a seed), in fp32.

  * ``Model.init``'s tree against the reference's;
  * ``Model.loss`` (nll + router_aux_loss_coef * aux) and its gradients;
  * ``remat`` (``full`` and ``dots``) against no remat, and the
    ``dots`` policy keeping the products' outputs;
  * the chunked CE (``loss_chunk``) against the whole CE, with a mask;
  * ``decode_step`` token by token and ``prefill`` against the
    reference's, and against the port's own full forward; per-row
    positions; a sliding-window ring buffer that wraps.

Where a model routes to experts, every routing decision of the run is
first asserted to have a top-k margin above 1e-4 (the k-th and
(k+1)-th router probabilities), so a flipped route reads as a fault.
Tolerance: values rtol 1e-5 (atol 1e-6), gradients rtol 1e-4 (atol
1e-6), as tests/test_torch_layers.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import Model as JModel

from repro_torch.configs import ARCH_IDS, get_arch, reduced
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.models import Model
from repro_torch.models import moe as tmoe
from repro_torch.utils.tree import (tree_leaves, tree_leaves_with_path,
                                    tree_unflatten_like)

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
MARGIN = 1e-4
B, S = 2, 16


@pytest.fixture
def margins(monkeypatch):
    """Records the smallest top-k margin of every routing decision the
    port makes while the test runs."""
    seen = []
    real = tmoe._route

    def recording(router, x, k):
        out = real(router, x, k)
        p = torch.sort(out[0].detach(), -1, descending=True).values
        seen.append(float((p[..., k - 1] - p[..., k]).min()))
        return out
    monkeypatch.setattr(tmoe, "_route", recording)
    return seen


def _archs(arch_id, **replace):
    jarch = dataclasses.replace(jreduced(jget_arch(arch_id)), **replace)
    arch = dataclasses.replace(reduced(get_arch(arch_id)), **replace)
    return jarch, arch


def _setup(arch_id, seed=0, **replace):
    jarch, arch = _archs(arch_id, **replace)
    jm = JModel(jarch, dtype=jnp.float32, remat=False, attn_impl="naive",
                scan_layers=False)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, arch, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                           "cpu")


def _batch(arch, seed=1, mask=False):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, arch.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": arr[:, :-1], "labels": arr[:, 1:]}
    if arch.frontend:
        batch["frontend_embeds"] = (rng.standard_normal(
            (B, arch.frontend_tokens, arch.d_model)) * 0.02).astype(np.float32)
    if mask:
        batch["mask"] = (rng.random((B, S)) >= 0.3).astype(np.float32)
    return batch


def _tensors(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _port_loss_and_grads(model, params, batch):
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(params)]
    loss, metrics = model.loss(tree_unflatten_like(params, leaves),
                               _tensors(batch))
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), metrics, tree_unflatten_like(params, list(grads))


def _assert_grads(got, want):
    got = dict(tree_leaves_with_path(to_numpy(got)))
    want = dict(tree_leaves_with_path(want))
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=path,
                                   **GRAD)


def _assert_margins(arch, margins):
    if arch.moe is not None:
        assert margins and min(margins) > MARGIN, min(margins)


def test_the_ten_architectures_are_the_reference_s():
    assert ARCH_IDS == JARCH_IDS and len(ARCH_IDS) == 10


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_init_matches_reference_tree(arch_id):
    """The port's own init builds the reference's tree (keys, shapes,
    dtypes; the MoE's stacked experts, router and merged shared expert
    included), so convert.py carries weights across leaf by leaf, and
    its large leaves have the reference's scale."""
    _, arch, jp, _ = _setup(arch_id)
    tp = Model(arch).init(torch.Generator().manual_seed(0))
    want = dict(tree_leaves_with_path(jax.tree.map(np.asarray, jp)))
    got = dict(tree_leaves_with_path(to_numpy(tp)))
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == \
        {k: (v.shape, v.dtype) for k, v in want.items()}
    for k, v in want.items():
        if v.ndim >= 2 and v.size >= 1024:
            assert abs(got[k].std() - v.std()) <= 0.1 * v.std(), k


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_loss_and_grads_match_reference(arch_id, margins):
    jm, arch, jp, tp = _setup(arch_id)
    batch = _batch(arch)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    model = Model(arch, dtype=torch.float32, attn_impl="naive", remat=False)
    loss, met, grads = _port_loss_and_grads(model, tp, batch)
    _assert_margins(arch, margins)
    np.testing.assert_allclose(float(loss), float(jloss), **VAL)
    np.testing.assert_allclose(float(met["nll"].detach()), float(jmet["nll"]),
                               **VAL)
    np.testing.assert_allclose(float(met["aux"].detach()), float(jmet["aux"]),
                               **VAL)
    if arch.moe is not None:      # the aux term is in the loss
        nll, aux = float(met["nll"].detach()), float(met["aux"].detach())
        assert aux > 0
        np.testing.assert_allclose(
            float(loss), nll + arch.moe.router_aux_loss_coef * aux, **VAL)
    _assert_grads(grads, jax.tree.map(np.asarray, jgrads))


REMAT_ARCHS = ["qwen3_1_7b", "granite_moe_1b_a400m", "qwen2_moe_a2_7b",
               "hymba_1_5b", "mamba2_780m", "phi3_vision_4_2b"]


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch_id", REMAT_ARCHS)
def test_remat_matches_no_remat_and_reference(arch_id, policy, margins):
    jm, arch, jp, tp = _setup(arch_id)
    batch = _batch(arch)
    plain = _port_loss_and_grads(
        Model(arch, dtype=torch.float32, attn_impl="naive", remat=False),
        tp, batch)
    remat = _port_loss_and_grads(
        Model(arch, dtype=torch.float32, attn_impl="naive", remat=True,
              remat_policy=policy), tp, batch)
    _assert_margins(arch, margins)
    np.testing.assert_allclose(float(remat[0]), float(plain[0]), **VAL)
    _assert_grads(remat[2], to_numpy(plain[2]))
    jr = dataclasses.replace(jm, remat=True, remat_policy=policy)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jr.loss(p, {k: jnp.asarray(v) for k, v in batch.items()})[0]
    )(jp)
    np.testing.assert_allclose(float(remat[0]), float(jloss), **VAL)
    _assert_grads(remat[2], jax.tree.map(np.asarray, jgrads))


class _CountProducts(TorchDispatchMode):
    OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
           torch.ops.aten.bmm.default)

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func in self.OPS
        return func(*args, **(kwargs or {}))


def test_dots_policy_keeps_the_products():
    """In backward, ``full`` recomputes every block's products; ``dots``
    keeps their outputs, so its backward runs exactly the products
    that no remat runs."""
    _, arch, _, tp = _setup("granite_moe_1b_a400m")
    batch = _tensors(_batch(arch))
    counts = {}
    for label, kw in (("none", dict(remat=False)), ("full", dict(remat=True)),
                      ("dots", dict(remat=True, remat_policy="dots"))):
        leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
        model = Model(arch, dtype=torch.float32, attn_impl="naive", **kw)
        loss, _ = model.loss(tree_unflatten_like(tp, leaves), batch)
        with _CountProducts() as mode:
            torch.autograd.grad(loss, leaves)
        counts[label] = mode.count
    assert counts["dots"] == counts["none"] < counts["full"], counts


@pytest.mark.parametrize("chunk", [5, 64])
@pytest.mark.parametrize("arch_id", ["qwen2_5_3b", "granite_moe_1b_a400m",
                                     "musicgen_large"])
def test_loss_chunk_matches_whole_ce(arch_id, chunk):
    """The chunked CE (chunks of 5 over 15 positions: 3; of 64: one) with
    a mask equals the whole CE, in value and gradients, and the
    reference's chunked CE."""
    jm, arch, jp, tp = _setup(arch_id)
    batch = _batch(arch, mask=True)
    whole = _port_loss_and_grads(
        Model(arch, dtype=torch.float32, attn_impl="naive", remat=False),
        tp, batch)
    chunked = _port_loss_and_grads(
        Model(arch, dtype=torch.float32, attn_impl="naive", remat=False,
              loss_chunk=chunk), tp, batch)
    np.testing.assert_allclose(float(chunked[0]), float(whole[0]), **VAL)
    _assert_grads(chunked[2], to_numpy(whole[2]))
    jc = dataclasses.replace(jm, loss_chunk=chunk)
    jloss = jc.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})[0]
    np.testing.assert_allclose(float(chunked[0]), float(jloss), **VAL)
    nomask = {k: v for k, v in batch.items() if k != "mask"}
    assert abs(float(_port_loss_and_grads(
        Model(arch, dtype=torch.float32, attn_impl="naive", remat=False,
              loss_chunk=chunk), tp, nomask)[0]) - float(chunked[0])) > 1e-4


def _decode_both(jm, model, jp, tp, tokens, positions, max_len=S):
    """Decode ``tokens`` [B, T] one column at a time in both packages;
    positions[t] is the scalar or per-row position of column t.  Returns
    the two [B, T, V] logits."""
    jc = jm.init_cache(B, max_len)
    tc = model.init_cache(B, max_len, device="cpu")
    jl, tl = [], []
    for t, pos in enumerate(positions):
        col = tokens[:, t:t + 1]
        lj, jc = jm.decode_step(jp, jnp.asarray(col), jc, jnp.asarray(pos))
        lt, tc = model.decode_step(tp, torch.from_numpy(col.copy()), tc,
                                   torch.as_tensor(pos))
        jl.append(np.asarray(lj))
        tl.append(lt.numpy())
    return np.concatenate(jl, 1), np.concatenate(tl, 1)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_decode_and_prefill_match_reference(arch_id, margins):
    """Token-by-token decode of the first 12 positions equals the
    reference's decode and the port's full forward at each position;
    prefill (frontend embeddings ahead, where the architecture has
    them) equals the reference's."""
    jm, arch, jp, tp = _setup(arch_id)
    batch = _batch(arch)
    model = Model(arch, dtype=torch.float32, attn_impl="naive", remat=False)
    T = 12
    tokens = batch["tokens"][:, :T]
    with torch.no_grad():
        jl, tl = _decode_both(jm, model, jp, tp, tokens,
                              [np.int32(t) for t in range(T)])
        full, _ = model.forward(tp, torch.from_numpy(tokens.copy()))
        fe = batch.get("frontend_embeds")
        pre = model.prefill(tp, torch.from_numpy(tokens.copy()),
                            None if fe is None else torch.from_numpy(fe))
    _assert_margins(arch, margins)
    np.testing.assert_allclose(tl, jl, **VAL)
    np.testing.assert_allclose(tl, full.numpy(), **VAL)
    jpre = jm.prefill(jp, jnp.asarray(tokens),
                      None if fe is None else jnp.asarray(fe))
    assert pre.shape == (B, 1, arch.vocab_size)
    np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), **VAL)


@pytest.mark.parametrize("arch_id", ["qwen2_5_3b", "granite_moe_1b_a400m",
                                     "hymba_1_5b", "mamba2_780m"])
def test_decode_at_per_row_positions_matches_reference(arch_id, margins):
    """[B] positions (the serving plane's slot caches): row 1 decodes
    three positions ahead of row 0, each writing its own cache slot and
    masking its own length."""
    jm, arch, jp, tp = _setup(arch_id)
    tokens = _batch(arch)["tokens"][:, :8]
    model = Model(arch, dtype=torch.float32, attn_impl="naive", remat=False)
    with torch.no_grad():
        jl, tl = _decode_both(jm, model, jp, tp, tokens,
                              [np.array([t, t + 3], np.int32)
                               for t in range(8)])
    _assert_margins(arch, margins)
    np.testing.assert_allclose(tl, jl, **VAL)


def test_sliding_window_ring_buffer_wraps():
    """hymba with its window shrunk to 6 below the 16 positions decoded:
    the KV cache is a 6-slot ring buffer that wraps twice; decode equals
    the reference's and the windowed full forward at every position."""
    jm, arch, jp, tp = _setup("hymba_1_5b", sliding_window=6)
    tokens = _batch(arch)["tokens"]
    model = Model(arch, dtype=torch.float32, attn_impl="naive", remat=False)
    assert model.init_cache(B, S, device="cpu")["attn"]["k"].shape[2] == 6
    with torch.no_grad():
        jl, tl = _decode_both(jm, model, jp, tp, tokens,
                              [np.int32(t) for t in range(S)])
        full, _ = model.forward(tp, torch.from_numpy(tokens.copy()))
        unwindowed, _ = Model(dataclasses.replace(arch, sliding_window=0),
                              dtype=torch.float32, attn_impl="naive",
                              remat=False).forward(
            tp, torch.from_numpy(tokens.copy()))
    np.testing.assert_allclose(tl, jl, **VAL)
    np.testing.assert_allclose(tl, full.numpy(), **VAL)
    # past the window the answer is not the unwindowed one
    assert np.abs(tl[:, 6:] - unwindowed.numpy()[:, 6:]).max() > 1e-4
