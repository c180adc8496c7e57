"""The port's AdamW against the JAX package's over several steps: global
norm clip, weight decay on ndim >= 2 only, fp32 bias correction and the
warmup-cosine schedule.  fp32, rtol 1e-5 (element ops in another
order in each framework; Adam's normalisation keeps errors relative)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw

from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.optim import adamw
from repro_torch.utils.tree import tree_leaves_with_path

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-7)


def _tree(rng):
    return {"w": rng.standard_normal((16, 8)).astype(np.float32),
            "b": rng.standard_normal(8).astype(np.float32),
            "nested": {"emb": rng.standard_normal((4, 3, 5)).astype(np.float32)}}


@pytest.mark.parametrize("clip,wd,warmup", [(1.0, 0.1, 3), (0.0, 0.0, 0),
                                            (0.05, 0.2, 1)])
def test_adamw_matches_reference(clip, wd, warmup):
    kw = dict(lr=1e-2, weight_decay=wd, clip_norm=clip, warmup_steps=warmup,
              total_steps=10)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, p0), params_from_numpy(p0, "cpu")
    js, ts = jadamw.init(jp), adamw.init(tp)
    for step in range(5):
        g = _tree(rng)
        jp, js, jm = jadamw.apply(jcfg, jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tm = adamw.apply(tcfg, tp, params_from_numpy(g, "cpu"), ts)
        np.testing.assert_allclose(tm["lr"].numpy(), np.asarray(jm["lr"]), **TOL)
        np.testing.assert_allclose(tm["grad_norm"].numpy(),
                                   np.asarray(jm["grad_norm"]), **TOL)
        assert int(ts.step) == int(js.step) == step + 1
    for name, tree_j, tree_t in (("p", jp, tp), ("m", js.m, ts.m),
                                 ("v", js.v, ts.v)):
        want = dict(tree_leaves_with_path(jax.tree.map(np.asarray, tree_j)))
        got = dict(tree_leaves_with_path(to_numpy(tree_t)))
        assert want.keys() == got.keys()
        for path in want:
            np.testing.assert_allclose(got[path], want[path],
                                       err_msg=name + path, **TOL)


def test_schedule_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(
            adamw.schedule(adamw.AdamWConfig(**cfg),
                           torch.tensor(s, dtype=torch.int32)).numpy(),
            np.asarray(jadamw.schedule(jadamw.AdamWConfig(**cfg),
                                       jnp.asarray(s, jnp.int32))), **TOL)


def test_weight_decay_skips_vectors():
    cfg = adamw.AdamWConfig(lr=1.0, weight_decay=0.5, clip_norm=0.0,
                            warmup_steps=0)
    p = {"mat": torch.ones(2, 2), "vec": torch.ones(2)}
    zeros = {"mat": torch.zeros(2, 2), "vec": torch.zeros(2)}
    new, _, _ = adamw.apply(cfg, p, zeros, adamw.init(p))
    assert torch.all(new["vec"] == 1.0)          # no gradient, no decay
    assert torch.all(new["mat"] < 1.0)
