"""``SPMDExecutor`` with ``strategy="tp"`` over a real process mesh:
Megatron tensor parallelism and expert parallelism.

One world of 4 CPU processes joined by gloo (``launch/mesh.py::
spawn_world``) runs every scenario, each reduced to 2 blocks at d 64,
sequence 16, vocabulary 512 (so the model axis cuts the table):

  * gpt3-medium on data 2 x model 2 (2 heads a rank, the flash kernels'
    plain versions, the chunked CE) and on 1 x 4 (one head a rank, the
    blocked softmax, the whole CE);
  * gpt3-medium with global batch 1 on 2 x 2: TP over model, the
    sequence over data;
  * gpt3-medium with a vocabulary of 511: the table stays whole;
  * qwen3 with 2 kv heads (GQA, the q/k norms, a tied vocab-parallel
    table) on 2 x 2, and on 1 x 4, where a rank's kv head is cut inside
    and its weights are gathered at use;
  * qwen2.5-3b on 2 x 2 (the QKV biases);
  * granite-moe's dense dispatch on 2 x 2 (2 experts a rank), its
    capacity dispatch on 1 x 4 (one expert a rank) and its grouped
    dispatch on 2 x 2;
  * qwen2-moe's shared expert, column / row parallel beside 2 experts a
    rank on 2 x 2, and beside 6 experts the model axis of 4 leaves
    whole (computed alike on every rank, added after the sum).

Each scenario is held against the JAX package's ``SPMDExecutor`` without
a mesh (one program on one CPU device) on the same weights
(``repro_torch.convert``) and batches: two steps' losses, global
gradient norms and MoE aux losses at tests/test_executor.py's fp32
tolerance, the params by its tracking rule.  Within each run: every
rank's losses are bitwise equal; after every step each leaf whose spec
does not name the model axis is bitwise equal across the model group
(the TP form of ``replica_divergence() == 0``); each rank's state bytes
equal the dry-run's per-card args less the batch; each batch shape
builds one program; and the "tp"-tagged all-reduce bytes a step equal a
count from the shapes (``tp_reduced_bytes``).  A world of 2 processes
holds the operators alone: *f*, *g*, the maximum, the vocab-parallel
embedding and CE.

The module imports no JAX at its top: the ranks import it."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_arch, reduced

LR, STEPS = 1e-3, 2
#: tests/test_executor.py's fp32 tolerance (tree_allclose_ulp)
ATOL, RTOL = 5e-7, 5e-4
SEQ = 16

#: name -> (arch, arch fields replaced, mesh (data, model), global
#: batch, the port's model options)
SCENARIOS = {
    "gpt3_2x2": ("gpt3_medium", {}, (2, 2), 4,
                 dict(attn_impl="kernel", loss_chunk=8)),
    "gpt3_1x4": ("gpt3_medium", {}, (1, 4), 4,
                 dict(attn_impl="blocked", loss_chunk=0)),
    "gpt3_seq_over_data": ("gpt3_medium", {}, (2, 2), 1,
                           dict(attn_impl="kernel", loss_chunk=0)),
    "gpt3_vocab511": ("gpt3_medium", {"vocab_size": 511}, (2, 2), 4,
                      dict(attn_impl="naive", loss_chunk=8)),
    "qwen3_2x2": ("qwen3_1_7b", {"num_kv_heads": 2}, (2, 2), 4,
                  dict(attn_impl="kernel", loss_chunk=8)),
    "qwen3_1x4_kv_cut": ("qwen3_1_7b", {"num_kv_heads": 2}, (1, 4), 4,
                         dict(attn_impl="naive", loss_chunk=0)),
    "qwen25_2x2_bias": ("qwen2_5_3b", {}, (2, 2), 4,
                        dict(attn_impl="kernel", loss_chunk=8)),
    "moe_2x2_dense": ("granite_moe_1b_a400m", {}, (2, 2), 4,
                      dict(attn_impl="kernel", loss_chunk=8)),
    "moe_1x4_capacity": ("granite_moe_1b_a400m", {}, (1, 4), 4,
                         dict(attn_impl="naive", loss_chunk=0,
                              moe_impl="capacity")),
    "moe_2x2_grouped": ("granite_moe_1b_a400m", {}, (2, 2), 4,
                        dict(attn_impl="blocked", loss_chunk=8,
                             moe_impl="grouped")),
    "moe_shared_2x2": ("qwen2_moe_a2_7b", {}, (2, 2), 4,
                       dict(attn_impl="kernel", loss_chunk=8)),
    "moe_shared_1x4_experts_whole": ("qwen2_moe_a2_7b", {"num_experts": 6},
                                     (1, 4), 4,
                                     dict(attn_impl="naive", loss_chunk=0)),
}


def with_fields(arch, kw):
    """``arch`` with ``kw`` replaced; ``num_experts`` is the MoE's."""
    kw = dict(kw)
    if "num_experts" in kw:
        kw["moe"] = dataclasses.replace(arch.moe,
                                        num_experts=kw.pop("num_experts"))
    return dataclasses.replace(arch, **kw)


def port_arch(name, kw):
    return with_fields(reduced(get_arch(name), layers=2), kw)


def opt_config():
    return dict(lr=LR, warmup_steps=0, clip_norm=1.0, weight_decay=0.0)


def tp_reduced_bytes(arch, mesh_shape, gb, remat=True):
    """The "tp"-tagged all-reduce bytes of one step on a rank: per block,
    the attention's and the MLP's *g* in the forward and *f* in the
    backward (each [rows, positions, d] fp32), the attention's *g* again
    in remat's recompute (torch's checkpoint stops its recompute at the
    block's last saved tensor, the MLP's down product's input, so the
    MLP's *g* is not rerun), and with q/k norms their weights' *f* ([hd]
    each).  An MoE's experts are tagged "experts"."""
    data, model = mesh_shape
    rows = gb // data if gb % data == 0 else gb
    positions = SEQ if gb % data == 0 else SEQ // data
    act = rows * positions * arch.d_model * 4
    sites = 2 if arch.moe is None else 1           # attention, MLP
    per_block = (2 * sites + (1 if remat else 0)) * act
    if arch.qk_norm:
        per_block += 2 * arch.head_dim * 4
    return arch.num_layers * per_block if model > 1 else 0


def run_scenarios(params_np, batches, names):
    """A rank's part: the scenarios ``names`` over this world, in order."""
    from repro_torch.convert import params_from_numpy, to_numpy
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import ProcessMesh, init_world
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime import ShardingStrategy, SPMDExecutor
    from repro_torch.runtime.sharding import gather_tree, spec_leaves
    from repro_torch.utils.tree import tree_leaves
    dev = init_world("cpu")
    meshes, out = {}, {}
    for name in names:
        arch_name, kw, shape, gb, opts = SCENARIOS[name]
        if shape not in meshes:
            meshes[shape] = ProcessMesh(("data", "model"), shape)
        mesh = meshes[shape]
        model = Model(port_arch(arch_name, kw), dtype=torch.float32,
                      remat=True, **opts)
        strategy = ShardingStrategy(strategy="tp")
        sc = ShapeConfig("t", SEQ, gb, "train")
        ex = SPMDExecutor(model, params_from_numpy(params_np[name], dev),
                          adamw.AdamWConfig(**opt_config()), mesh=mesh,
                          strategy=strategy, shape=sc)
        held = sum(t.numel() * t.element_size()
                   for t in tree_leaves((ex.params, ex.opt_state)))
        want = dryrun.spec_bytes(model.arch, sc, mesh, strategy, model=model)
        stats, whole, tp_bytes = [], [], []
        for b in batches[(arch_name, kw.get("vocab_size"), gb)]:
            mesh.transport.reset()
            stats.append(ex.step(b))
            tp_bytes.append(mesh.transport.tagged.get(
                "tp", {}).get("reduced", 0))
            # the leaves whose spec does not name the model axis
            whole.append({p: t.detach().numpy().copy() for p, spec, t in
                          spec_leaves(ex.pspecs, ex.params)
                          if "model" not in spec})
        full = gather_tree(ex.pspecs, ex.params, mesh)
        out[name] = {"losses": [float(x["loss"]) for x in stats],
                     "loss_bits": [x["loss"].numpy().tobytes()
                                   for x in stats],
                     "norms": [float(x["grad_norm"]) for x in stats],
                     "aux": [float(x["aux"]) for x in stats],
                     "params": to_numpy(full), "whole": whole,
                     "tp_bytes": tp_bytes, "coords": dict(mesh.coords),
                     "held": held, "want": want["args"] - want["batch"],
                     "compiles": ex.cache.stats.compiles}
    return out


def _batches(vocab, gb, seed):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, (gb, SEQ)).astype(np.int32),
             "labels": rng.integers(0, vocab, (gb, SEQ)).astype(np.int32)}
            for _ in range(STEPS)]


def _ref_key(name):
    arch, kw, _, gb, opts = SCENARIOS[name]
    return (arch, tuple(sorted(kw.items())), gb, opts.get("loss_chunk", 0),
            opts.get("moe_impl", "dense"))


@pytest.fixture(scope="module")
def results():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as jget_arch
    from repro.configs import reduced as jreduced
    from repro.models import Model as JModel
    from repro.optim import adamw as jadamw
    from repro.runtime import SPMDExecutor as JSPMDExecutor
    from repro_torch.launch.mesh import spawn_world
    jparams, params_np, ref, batches = {}, {}, {}, {}
    for name, (arch, kw, _, gb, _) in SCENARIOS.items():
        jarch = with_fields(jreduced(jget_arch(arch), layers=2), kw)
        bkey = (arch, kw.get("vocab_size"), gb)
        if bkey not in batches:
            batches[bkey] = _batches(jarch.vocab_size, gb, 11 + gb)
        key = _ref_key(name)
        wkey = (arch, tuple(sorted(kw.items())))
        if wkey not in jparams:
            jparams[wkey] = JModel(jarch, dtype=jnp.float32).init(
                jax.random.PRNGKey(7))
        params_np[name] = jax.tree.map(np.asarray, jparams[wkey])
        if key in ref:
            continue
        jmodel = JModel(jarch, dtype=jnp.float32, remat=True,
                        attn_impl="naive", loss_chunk=key[3],
                        moe_impl=key[4])
        jex = JSPMDExecutor(jmodel, jparams[wkey],
                            jadamw.AdamWConfig(**opt_config()))
        stats = [jex.step(b) for b in batches[bkey]]
        ref[key] = ([float(x["loss"]) for x in stats],
                    [float(x["grad_norm"]) for x in stats],
                    [float(x["aux"]) for x in stats],
                    [np.asarray(x) for x in jax.tree.leaves(jex.params)])
    world = spawn_world(f"{__name__}:run_scenarios", 4,
                        {"params_np": params_np, "batches": batches,
                         "names": list(SCENARIOS)},
                        device="cpu", timeout=300,
                        paths=[__file__.rsplit("/", 1)[0]])
    return world, ref


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tp_executor_tracks_the_reference(results, name):
    world, ref = results
    r = world[0][name]
    losses, norms, auxes, jleaves = ref[_ref_key(name)]
    np.testing.assert_allclose(r["losses"], losses, atol=ATOL, rtol=RTOL)
    # the global norm the clip divides by: each element counted once
    np.testing.assert_allclose(r["norms"], norms, atol=ATOL, rtol=RTOL)
    # the global load-balance loss (0 without experts)
    np.testing.assert_allclose(r["aux"], auxes, atol=ATOL, rtol=RTOL)
    from repro_torch.utils.tree import tree_leaves
    ours = tree_leaves(r["params"])
    assert len(ours) == len(jleaves)
    for x, y in zip(jleaves, ours):
        assert x.shape == y.shape
        diff = np.abs(x - y)
        # tests/test_executor.py::assert_params_track
        assert diff.max() <= 2.5 * LR, diff.max()
        assert (diff > LR / 10).mean() < 1e-3


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tp_ranks_agree_bitwise(results, name):
    """Every rank's loss is bitwise rank 0's, and after every step each
    leaf whose spec does not name the model axis is bitwise equal across
    the model group."""
    world, _ = results
    r0 = world[0][name]
    for rank in world[1:]:
        assert rank[name]["loss_bits"] == r0["loss_bits"]
        assert rank[name]["aux"] == r0["aux"]
    groups = {}
    for rank in world:
        groups.setdefault(rank[name]["coords"]["data"], []).append(rank[name])
    for members in groups.values():
        first = members[0]["whole"]
        assert first and len(first) == STEPS
        for other in members[1:]:
            for step, leaves in enumerate(other["whole"]):
                assert leaves.keys() == first[step].keys()
                for path, t in leaves.items():
                    assert np.array_equal(t, first[step][path]), (step, path)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tp_state_builds_and_traffic(results, name):
    """Each rank's state is the dry-run's per-card args less the batch,
    each batch shape builds one program, and the activations' all-reduce
    bytes are the count from the shapes."""
    world, _ = results
    arch, kw, shape, gb, opts = SCENARIOS[name]
    want_tp = tp_reduced_bytes(port_arch(arch, kw), shape, gb)
    for rank in world:
        r = rank[name]
        assert r["held"] == r["want"]
        assert r["compiles"] == 1
        assert r["tp_bytes"] == [want_tp] * STEPS


# ----------------------------------------------------------------------
# The operators alone, in a world of 2
# ----------------------------------------------------------------------
V, D, B, S = 12, 5, 2, 3


def run_units():
    """A rank's part of the operator checks on a 1 x 2 mesh."""
    from repro_torch.launch.mesh import ProcessMesh, init_world
    from repro_torch.models.layers import cross_entropy, vocab_embed
    from repro_torch.runtime.sharding import TPContext
    init_world("cpu")
    mesh = ProcessMesh(("data", "model"), (1, 2))
    arch = port_arch("gpt3_medium", {"vocab_size": V})
    tp = TPContext.of(mesh, "model", arch)
    r = mesh.axis_index("model")
    g = torch.Generator().manual_seed(3)
    x = torch.randn((B, S, D), generator=g, dtype=torch.float32)
    table = torch.randn((V, D), generator=g, dtype=torch.float32)
    tokens = torch.randint(0, V, (B, S), generator=g)
    tokens[0, 0] = 0                     # row 0 looked up on rank 0 only
    labels = torch.randint(0, V, (B, S), generator=g)
    up = torch.randn((B, S, D), generator=g, dtype=torch.float32)
    out = {"rank": r, "vocab": tp.vocab}
    # f: identity forward, the cotangent summed over the group
    xf = x.clone().requires_grad_(True)
    y = tp.f(xf)
    (y * (r + 1)).sum().backward()
    out["f"] = (torch.equal(y, x), xf.grad)
    # g: the sum forward, the cotangent passed on
    xg = (x * (r + 1)).requires_grad_(True)
    y = tp.g(xg)
    (y * up).sum().backward()
    out["g"] = (y, xg.grad)
    # the maximum, no gradient
    out["max"] = tp.max(x[..., 0] * (1 - 2 * r))
    # the vocab-parallel embedding: this rank's rows of the table
    v0, v1 = tp.vocab
    shard = table[v0:v1].clone().requires_grad_(True)
    e = vocab_embed({"table": shard}, tokens, torch.float32, tp)
    (e * up).sum().backward()
    out["embed"] = (e, shard.grad)
    # the vocab-parallel CE on this rank's logits of f(x)
    xs = x.clone().requires_grad_(True)
    ws = table[v0:v1].clone().requires_grad_(True)
    logits = tp.f(xs, "vocab") @ ws.t()
    nll = cross_entropy(logits, labels, tp=tp)
    nll.backward()
    out["ce"] = (nll.detach(), xs.grad, ws.grad)
    out["tagged"] = {k: dict(v) for k, v in mesh.transport.tagged.items()}
    return out


@pytest.fixture(scope="module")
def units():
    from repro_torch.launch.mesh import spawn_world
    return spawn_world(f"{__name__}:run_units", 2, {}, device="cpu",
                       timeout=120, paths=[__file__.rsplit("/", 1)[0]])


def _inputs():
    g = torch.Generator().manual_seed(3)
    x = torch.randn((B, S, D), generator=g, dtype=torch.float32)
    table = torch.randn((V, D), generator=g, dtype=torch.float32)
    tokens = torch.randint(0, V, (B, S), generator=g)
    tokens[0, 0] = 0
    labels = torch.randint(0, V, (B, S), generator=g)
    up = torch.randn((B, S, D), generator=g, dtype=torch.float32)
    return x, table, tokens, labels, up


@pytest.mark.parametrize("op", ["f", "g", "max"])
def test_megatron_operators(units, op):
    x, _, _, _, up = _inputs()
    for u in units:
        if op == "f":
            same, grad = u["f"]
            # identity forward; the cotangents 1 and 2 summed
            assert same and torch.equal(grad, torch.full_like(x, 3.0))
        elif op == "g":
            y, grad = u["g"]
            assert torch.equal(y, x * 1 + x * 2)
            assert torch.equal(grad, up)
        else:
            assert torch.equal(u["max"], torch.maximum(x[..., 0], -x[..., 0]))
            # no gradient, and it moved [B, S] a member under "vocab"
            assert not u["max"].requires_grad
            assert u["tagged"]["vocab"]["gathered"] >= 2 * B * S * 4


def test_vocab_parallel_embedding(units):
    """The rows summed over the group are the whole table's lookup,
    bitwise; each shard's gradient is its rows of the whole one, with
    row 0 untouched by the tokens another rank holds."""
    import torch.nn.functional as F
    x, table, tokens, _, up = _inputs()
    whole = table.clone().requires_grad_(True)
    e = F.embedding(tokens, whole)
    (e * up).sum().backward()
    for u in units:
        got, grad = u["embed"]
        v0, v1 = u["vocab"]
        assert torch.equal(got, e)
        # a row's cotangents summed in the same order as the whole's
        assert torch.equal(grad, whole.grad[v0:v1])


def test_vocab_parallel_cross_entropy(units):
    """The NLL and the gradients of x and of each rank's rows equal the
    whole vocabulary's (fp32 in another summation order)."""
    from repro_torch.models.layers import cross_entropy
    x, table, _, labels, _ = _inputs()
    xs = x.clone().requires_grad_(True)
    ws = table.clone().requires_grad_(True)
    nll = cross_entropy(xs @ ws.t(), labels)
    nll.backward()
    for u in units:
        got, gx, gw = u["ce"]
        v0, v1 = u["vocab"]
        torch.testing.assert_close(got, nll.detach(), rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(gx, xs.grad, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(gw, ws.grad[v0:v1], rtol=RTOL, atol=ATOL)
    # every member computes the same NLL bit for bit
    assert units[0]["ce"][0].item() == units[1]["ce"][0].item()
