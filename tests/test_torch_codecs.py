"""The port's tree codecs (``repro_torch/runtime/compression.py``:
``compress``, ``decompress``, ``roundtrip``, ``roundtrip_flat``,
``encoded_nbytes``, ``wire_bytes``) against the JAX package's on the
same numpy gradients, and the properties tests/test_compression.py
holds the reference's to: the bytes counted are the bytes encoded (one
int8 scale per leaf, one per flat bucket), decoding restores fp32 and
the shapes, and with error feedback the accumulated error of a constant
gradient stays within a quantisation step while the plain codec's
grows.  The encodings are bitwise the reference's (round to nearest
even in both)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import compression as jcomp

from repro_torch.core.sync import flat_wire_bytes
from repro_torch.runtime import compression as tcomp
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path, tree_map

CODECS = ["none", "bf16", "int8"]


def _tree(seed=0):
    """A nested gradient tree of fp32 leaves (numpy, from a seed)."""
    rng = np.random.default_rng(seed)

    def g(*shape, scale=0.01):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"attn": {"wq": g(32, 8), "wk": g(32, 4, scale=1e-4)},
            "mlp": {"w1": g(7), "w2": g(3, 5, scale=3.0)},
            "norm": g(16)}


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(a.copy()), tree)


def _np(tree):
    return {p: np.asarray(t.float() if isinstance(t, torch.Tensor) else
                          jnp.asarray(t, jnp.float32))
            for p, t in tree_leaves_with_path(tree)}


@pytest.mark.parametrize("codec", CODECS)
def test_tree_codecs_match_reference_bitwise(codec):
    tree = _tree()
    jenc = jcomp.compress(jax.tree.map(jnp.asarray, tree), codec)
    tenc = tcomp.compress(_torch(tree), codec)
    if codec == "int8":
        for name in ("q", "scale"):
            jl = jax.tree.leaves(jax.tree.map(lambda d: d[name], jenc,
                                              is_leaf=lambda x: isinstance(
                                                  x, dict) and "q" in x))
            tl = [d[name] for d in tcomp._int8_leaves(tenc)]
            assert len(jl) == len(tl) == len(tree_leaves(tree))
            for a, b in zip(jl, tl):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    else:
        for (p, a), (_, b) in zip(_np(jenc).items(), _np(tenc).items()):
            np.testing.assert_array_equal(b, a, err_msg=p)
    jdec, tdec = _np(jcomp.roundtrip(jax.tree.map(jnp.asarray, tree), codec)), \
        _np(tcomp.roundtrip(_torch(tree), codec))
    assert jdec.keys() == tdec.keys()
    for p in jdec:
        np.testing.assert_array_equal(tdec[p], jdec[p], err_msg=p)


@pytest.mark.parametrize("codec", CODECS)
def test_flat_roundtrip_matches_reference_bitwise(codec):
    flat = np.concatenate([a.ravel() for a in tree_leaves(_tree(1))])
    want = np.asarray(jcomp.roundtrip_flat(jnp.asarray(flat), codec))
    got = tcomp.roundtrip_flat(torch.from_numpy(flat), codec)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    enc = tcomp.encode_flat(torch.from_numpy(flat), codec)
    assert tcomp.encoded_nbytes(enc, codec) == flat_wire_bytes(flat.size,
                                                               codec)


@pytest.mark.parametrize("codec", CODECS)
def test_wire_bytes_matches_codec_output(codec):
    tree = _torch(_tree())
    got = tcomp.wire_bytes(tree, codec)
    assert got == tcomp.encoded_nbytes(tcomp.compress(tree, codec), codec)
    assert got == jcomp.wire_bytes(jax.tree.map(jnp.asarray, _tree()), codec)


def test_wire_bytes_counts_one_scale_per_leaf():
    one = {"w": torch.ones(100)}
    two = {"w": torch.ones(50), "v": torch.ones(50)}
    assert tcomp.wire_bytes(two, "int8") == tcomp.wire_bytes(one, "int8") + 4
    assert tcomp.wire_bytes(one, "bf16") == 200
    assert tcomp.wire_bytes(one, "none") == 400


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_decompress_restores_dtype_shape_and_bounds_the_error(codec):
    tree = _torch(_tree(2))
    rt = tcomp.roundtrip(tree, codec)
    for (p, a), (_, b) in zip(tree_leaves_with_path(tree),
                              tree_leaves_with_path(rt)):
        assert b.dtype == torch.float32 and b.shape == a.shape, p
        if codec == "int8":      # half a step of the leaf's own scale
            step = float(a.abs().max()) / 127
            assert float((a - b).abs().max()) <= step / 2 * (1 + 1e-6), p
        else:                    # bf16 keeps 8 significant bits
            assert bool(((a - b).abs() <= a.abs() * 2.0 ** -8).all()), p


def test_unknown_codec_raises():
    for fn in (tcomp.compress, tcomp.decompress, tcomp.encode_flat):
        with pytest.raises(ValueError):
            fn({"w": torch.ones(2)} if fn is not tcomp.encode_flat
               else torch.ones(2), "fp4")


def test_error_feedback_keeps_the_accumulated_error_bounded():
    """A constant gradient sent T = 32 times through int8: the plain
    codec's accumulated error grows linearly; carrying the residual
    (``ErrorFeedback``, keyed as the sync plane keys it) keeps it within
    a few quantisation steps."""
    g = {"w": torch.from_numpy((np.random.default_rng(2).standard_normal(128)
                                * 0.03).astype(np.float32))}
    ef = tcomp.ErrorFeedback("int8")
    plain_sum, ef_sum = torch.zeros(128), torch.zeros(128)
    plain_err, ef_err = [], []
    for t in range(1, 33):
        plain_sum += tcomp.roundtrip(g, "int8")["w"]
        res = ef.get("bucket0")
        x = g if res is None else tree_map(torch.add, g, res)
        sent = tcomp.roundtrip(x, "int8")
        ef.put("bucket0", tree_map(torch.sub, x, sent))
        ef_sum += sent["w"]
        plain_err.append(float((plain_sum - t * g["w"]).abs().max()))
        ef_err.append(float((ef_sum - t * g["w"]).abs().max()))
    assert plain_err[-1] > 4 * plain_err[3]
    assert ef_err[-1] < 3 * max(ef_err[3], 1e-9)
    assert ef_err[-1] < plain_err[-1] / 4
