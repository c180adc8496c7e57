"""The port's MoE layer (``repro_torch/models/moe.py``) against the JAX
package's on the CPU: every dispatch (dense, grouped, capacity as a
scan over groups and vectorized) on reduced granite-moe (no shared
expert) and reduced qwen2-moe (a merged shared expert), the same
weights (the reference's ``init_moe`` carried over by convert.py) and
the same inputs (numpy, from a seed), in fp32.  The output y, the
load-balance aux loss and the gradients of a scalar of both against x
and every weight.

Each case first asserts that every token's k-th and (k+1)-th router
probabilities are more than 1e-4 apart, so both frameworks must pick
the same experts: a flipped route reads as a fault, not as noise.
Tolerance: values rtol 1e-5 (atol 1e-6), gradients rtol 1e-4 (atol
1e-6), as tests/test_torch_layers.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import moe as jmoe

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.models import moe as tmoe
from repro_torch.utils.tree import (tree_leaves_with_path, tree_leaves,
                                    tree_unflatten_like)

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
MARGIN = 1e-4
# a group of 8 positions: 3 groups over the 24 below, C = ceil(2 * 8 / 4
# * 1.25) = 5 places an expert a group, so some picks are dropped
GROUP = 8


def top_k_margin(x, router, k):
    """Smallest gap between a token's k-th and (k+1)-th router
    probability (float64)."""
    logits = x.astype(np.float64).reshape(-1, x.shape[-1]) @ router
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.sort(p / p.sum(-1, keepdims=True), -1)[:, ::-1]
    return float((p[:, k - 1] - p[:, k]).min())


def _impls(mod):
    return {"dense": mod.moe_mlp, "grouped": mod.moe_mlp_grouped,
            "capacity": functools.partial(mod.moe_mlp_capacity,
                                          group_size=GROUP),
            "capacity_vec": functools.partial(
                mod.moe_mlp_capacity, group_size=GROUP, scan_groups=False)}


def _case(arch_name, seed=0, S=24):
    jarch = jreduced(jget_arch(arch_name))
    arch = reduced(get_arch(arch_name))
    params = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed),
                                                     jarch))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, arch.d_model)).astype(np.float32)
    # the cotangent of a mean over the 2 x S tokens, as a loss gives it
    gy = (rng.standard_normal((2, S, arch.d_model)) / (2 * S)).astype(
        np.float32)
    return jarch, arch, params, x, gy


@pytest.mark.parametrize("impl", ["dense", "grouped", "capacity",
                                  "capacity_vec"])
@pytest.mark.parametrize("arch_name", ["granite_moe_1b_a400m",
                                       "qwen2_moe_a2_7b"])
def test_moe_matches_reference(arch_name, impl):
    jarch, arch, params, x, gy = _case(arch_name)
    assert top_k_margin(x, params["router"], arch.moe.top_k) > MARGIN
    assert ("shared" in params) == (arch_name == "qwen2_moe_a2_7b")
    c = 0.37                                    # weight of aux in the scalar
    jfn, tfn = _impls(jmoe)[impl], _impls(tmoe)[impl]

    def jscalar(p, xx):
        y, aux = jfn(p, jarch, xx)
        return jnp.sum(y * gy) + c * aux, (y, aux)
    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jscalar, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))

    tp = params_from_numpy(params, "cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    ty, taux = tfn(tree_unflatten_like(tp, leaves), arch, tx)
    g = torch.autograd.grad((ty * torch.from_numpy(gy)).sum() + c * taux,
                            leaves + [tx])
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **VAL)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), **VAL)
    np.testing.assert_allclose(g[-1].numpy(), np.asarray(jgx), **GRAD)
    want = dict(tree_leaves_with_path(jax.tree.map(np.asarray, jgp)))
    got = dict(tree_leaves_with_path(to_numpy(
        tree_unflatten_like(tp, list(g[:-1])))))
    assert want.keys() == got.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=path, **GRAD)
    # the router's gradient is nonzero: the aux term and the top-k weights
    # both reach it
    assert float(np.abs(got["['router']"]).max()) > 1e-4


def test_capacity_dispatch_drops_what_overflows():
    """At C = 5 places a group some expert receives more picks than it
    has places: the capacity output differs from the dropless dense one,
    and the vectorized form (the same groups as one batch) gives the
    scan's output."""
    _, arch, params, x, _ = _case("granite_moe_1b_a400m")
    logits = x.reshape(2, -1, GROUP, arch.d_model) @ params["router"]
    picks = np.argsort(-logits, -1)[..., :arch.moe.top_k]
    per_expert = np.stack([(picks == e).sum((-1, -2))
                           for e in range(arch.moe.num_experts)], -1)
    assert per_expert.max() > 5, per_expert
    tp = params_from_numpy(params, "cpu")
    tx = torch.from_numpy(x.copy())
    yd, _ = tmoe.moe_mlp(tp, arch, tx)
    yc, _ = tmoe.moe_mlp_capacity(tp, arch, tx, group_size=GROUP)
    yv, _ = tmoe.moe_mlp_capacity(tp, arch, tx, group_size=GROUP,
                                  scan_groups=False)
    assert float((yd - yc).abs().max()) > 1e-3
    torch.testing.assert_close(yc, yv, **VAL)

