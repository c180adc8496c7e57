"""``strategy="tp"`` over a model axis whose ranks split kv groups: fewer
kv heads than ranks, not dividing them, so a rank's query heads may
straddle two kv groups and run as pieces of one GQA shape each
(``sharding.tp_heads``, ``tp_pieces``; ``models/attention.py``).

One world of 4 CPU processes joined by gloo (``launch/mesh.py::
spawn_world``) runs every scenario on data 1 x model 4, each reduced to 2
blocks, sequence 16, vocabulary 512:

  * hymba with 9 query / 3 kv heads of 16 (d 64) and a window of 8:
    query heads 3 / 2 / 2 / 2, rank 2's heads 5-6 straddling kv heads 1
    and 2 (hymba-1.5b's model-8 layout in small), beside 2 Mamba2 heads a
    rank, with the flash and SSD kernels' plain versions and the chunked
    CE;
  * qwen2.5-3b's family with 10 query / 2 kv heads and the QKV biases,
    through the fused QKV: heads 3 / 3 / 2 / 2, rank 1's heads 3-5
    straddling kv heads 0 and 1 (qwen2.5-32b's model-16 layout in small).

Each is held against the JAX package's ``SPMDExecutor`` without a mesh
(one program on one CPU device) on the same weights
(``repro_torch.convert``) and batches: two steps' losses and global
gradient norms at tests/test_executor.py's fp32 tolerance, the params by
its tracking rule.  Within each run: every rank's losses are bitwise
equal; after every step each leaf whose spec does not name the model
axis is bitwise equal across the model group; each rank's state bytes
equal the dry-run's per-card args less the batch; each batch shape
builds one program; and the "tp"-tagged all-reduce bytes a step equal a
count from the shapes.

The hymba scenario is served in the same world (``SPMDServer``): its
prefill's last-position logits and greedy decode ticks from a seeded
cache, held at 1e-5 to the JAX package's ``prefill_bundle(...).jit()``
and ``decode_bundle(...).jit()`` on 4 forced host devices over the same
mesh (a subprocess); the greedy tokens equal, the gathered cache equal to
the reference's, and the two copies of a kv head two ranks share
bitwise equal.

The module imports no JAX at its top: the ranks import it."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_arch, reduced
from repro_torch.runtime.sharding import tp_heads, tp_pieces

LR, STEPS = 1e-3, 2
#: tests/test_executor.py's fp32 tolerance (tree_allclose_ulp)
ATOL, RTOL = 5e-7, 5e-4
SEQ = 16
MESH = (1, 4)
#: name -> (arch, arch fields replaced, global batch, the port's model
#: options)
SCENARIOS = {
    "hymba_9q_3kv": ("hymba_1_5b", {"num_heads": 9, "num_kv_heads": 3,
                                    "sliding_window": 8}, 4,
                     dict(attn_impl="kernel", ssd_impl="kernel",
                          loss_chunk=8)),
    "qwen25_10q_2kv": ("qwen2_5_3b", {"num_heads": 10, "num_kv_heads": 2},
                       4, dict(attn_impl="kernel", fuse="fused",
                               loss_chunk=0)),
}
#: the serving case: the hymba scenario's model, a seeded cache at
#: position POS0 of MAX_LEN, TICKS greedy decode ticks
SERVE, MAX_LEN, POS0, TICKS = "hymba_9q_3kv", 12, 9, 3
SERVE_ATOL = 1e-5
#: the reference's top-2 logit gap at each greedy tick must exceed this,
#: so that the ports' logits within SERVE_ATOL pick the same token
MARGIN = 1e-4


def make_arch(name, reduce=reduced, get=get_arch):
    arch, kw, _, _ = SCENARIOS[name]
    return dataclasses.replace(reduce(get(arch), layers=2), **kw)


def opt_config():
    return dict(lr=LR, warmup_steps=0, clip_norm=1.0, weight_decay=0.0)


def tp_reduced_bytes(arch, gb, remat=True):
    """The "tp"-tagged all-reduce bytes of one step on a rank of data 1 x
    model 4 (each [rows, positions, d] fp32 activation): a dense block's
    attention and MLP *g* forward and *f* backward, the attention's *g*
    again in remat's recompute (the MLP's is not rerun: torch's
    checkpoint stops at the block's last saved tensor); a hybrid block's
    branch pair and its MLP one of each, the pair's *g* again in the
    recompute.  Every weight of these blocks is cut over model (the axis
    of 4 divides each dimension), so none is taken whole through *f*."""
    act = gb * SEQ * arch.d_model * 4
    extra = 1 if remat else 0
    return arch.num_layers * (2 + extra + 2) * act


def run_world(params_np, batches, serve):
    """A rank's part: the training scenarios, then the serving case."""
    from repro_torch.convert import params_from_numpy, to_numpy
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import ProcessMesh, init_world
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime import (ShardingStrategy, SPMDExecutor,
                                     SPMDServer)
    from repro_torch.runtime.sharding import gather_tree, spec_leaves
    from repro_torch.utils.tree import tree_leaves, tree_map
    dev = init_world("cpu")
    mesh = ProcessMesh(("data", "model"), MESH)
    strategy = ShardingStrategy(strategy="tp")
    out = {"coords": dict(mesh.coords), "train": {}}
    for name, (_, _, gb, opts) in SCENARIOS.items():
        model = Model(make_arch(name), dtype=torch.float32, remat=True,
                      **opts)
        sc = ShapeConfig("t", SEQ, gb, "train")
        ex = SPMDExecutor(model, params_from_numpy(params_np[name], dev),
                          adamw.AdamWConfig(**opt_config()), mesh=mesh,
                          strategy=strategy, shape=sc)
        held = sum(t.numel() * t.element_size()
                   for t in tree_leaves((ex.params, ex.opt_state)))
        want = dryrun.spec_bytes(model.arch, sc, mesh, strategy, model=model)
        tp = strategy.tp_context(mesh, model.arch)
        stats, whole, reduced_bytes = [], [], []
        for b in batches[name]:
            mesh.transport.reset()
            stats.append(ex.step(b))
            reduced_bytes.append(
                mesh.transport.tagged.get("tp", {}).get("reduced", 0))
            whole.append({p: t.detach().numpy().copy() for p, spec, t in
                          spec_leaves(ex.pspecs, ex.params)
                          if "model" not in spec})
        full = gather_tree(ex.pspecs, ex.params, mesh)
        out["train"][name] = {
            "losses": [float(x["loss"]) for x in stats],
            "loss_bits": [x["loss"].numpy().tobytes() for x in stats],
            "norms": [float(x["grad_norm"]) for x in stats],
            "params": to_numpy(full), "whole": whole,
            "reduced": reduced_bytes, "heads": tp.heads,
            "kv_heads": tp.kv_heads, "pieces": tp.pieces, "held": held,
            "want": want["args"] - want["batch"],
            "compiles": ex.cache.stats.compiles}
    _, _, gb, opts = SCENARIOS[SERVE]
    model = Model(make_arch(SERVE), dtype=torch.float32, remat=False,
                  fuse="fused", **opts)
    server = SPMDServer(model, params_from_numpy(params_np[SERVE], dev),
                        mesh, strategy, ShapeConfig("s", SEQ, gb, "prefill"))
    r = {"prefill": server.gather_rows(server.prefill(
        {"tokens": torch.from_numpy(server.rows(serve["tokens"]))}
    )).numpy().copy()}
    cache = server.shard_cache({part: {leaf: torch.from_numpy(v).to(dev)
                                       for leaf, v in leaves.items()}
                                for part, leaves in serve["cache"].items()})
    token, ticks = serve["token"], []
    for t in range(TICKS):
        logits, cache = server.decode(torch.from_numpy(server.rows(token)),
                                      cache, POS0 + t)
        logits = server.gather_rows(logits).numpy().copy()
        ticks.append(logits)
        token = logits[:, -1].argmax(-1).astype(np.int32)[:, None]
    r.update(ticks=ticks,
             attn={k: cache["attn"][k].numpy().copy() for k in ("k", "v")},
             cache=tree_map(lambda t: t.numpy().copy(),
                            server.gather_cache(cache)),
             kv_heads=server._model.tp.kv_heads,
             builds=server.cache.stats.compiles)
    out["serve"] = r
    return out


#: the reference's bundles on 4 forced host devices over data 1 x model
#: 4, the greedy ticks chosen from its own logits, written to an npz
SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.configs import ShapeConfig, get_arch, reduced
    from repro.launch.mesh import make_mesh_compat
    from repro.runtime import spmd
    from repro.runtime.sharding import ShardingStrategy

    spec = json.loads(sys.argv[3])
    data = np.load(sys.argv[1])
    mesh = make_mesh_compat(tuple(spec["mesh"]), ("data", "model"))
    arch = dataclasses.replace(reduced(get_arch(spec["arch"]), layers=2),
                               **spec["fields"])
    strategy = ShardingStrategy(strategy="tp")
    gb = spec["gb"]
    model = spmd.build_model(arch, strategy, mesh, gb, dtype=jnp.float32,
                             remat=False, attn_impl="naive")
    params = model.init(jax.random.PRNGKey(spec["key"]))
    cache = {}
    for k in data.files:
        if k.startswith("cache/"):
            _, part, leaf = k.split("/")
            cache.setdefault(part, {})[leaf] = jnp.asarray(data[k])
    out = {}
    with mesh:
        pre = spmd.prefill_bundle(model, strategy, mesh, params,
                                  ShapeConfig("s", spec["seq"], gb,
                                              "prefill")).jit()
        out["prefill"] = np.asarray(pre(params, {
            "tokens": jnp.asarray(data["tokens"])}))
        dec = spmd.decode_bundle(model, strategy, mesh, params, cache,
                                 ShapeConfig("d", spec["max_len"], gb,
                                             "decode")).jit()
        token = data["token"]
        for t in range(spec["ticks"]):
            logits, cache = dec(params, jnp.asarray(token), cache,
                                jnp.int32(spec["pos0"] + t))
            logits = np.asarray(logits)
            out[f"tick{t}"] = logits
            token = logits[:, -1].argmax(-1).astype(np.int32)[:, None]
    for part, leaves in cache.items():
        for leaf, v in leaves.items():
            out[f"cache/{part}/{leaf}"] = np.asarray(v)
    np.savez(sys.argv[2], **out)
""")


def _serve_inputs(arch, gb):
    """The serving case's prompts, first decode token and seeded cache."""
    from repro_torch.models import Model
    rng = np.random.default_rng(33)
    out = {"tokens": rng.integers(0, arch.vocab_size, (gb, SEQ)
                                  ).astype(np.int32),
           "token": rng.integers(0, arch.vocab_size, (gb, 1)
                                 ).astype(np.int32), "cache": {}}
    shapes = Model(arch, dtype=torch.float32).init_cache(gb, MAX_LEN, "cpu")
    for part, leaves in shapes.items():
        out["cache"][part] = {leaf: (0.5 * rng.standard_normal(
            tuple(t.shape))).astype(np.float32) for leaf, t in leaves.items()}
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as jget_arch
    from repro.configs import reduced as jreduced
    from repro.models import Model as JModel
    from repro.optim import adamw as jadamw
    from repro.runtime import SPMDExecutor as JSPMDExecutor
    from repro_torch.launch.mesh import spawn_world
    tmp = tmp_path_factory.mktemp("tp_heads")
    _, kw, gb, _ = SCENARIOS[SERVE]
    serve = _serve_inputs(make_arch(SERVE), gb)
    flat = {"tokens": serve["tokens"], "token": serve["token"]}
    flat.update({f"cache/{p}/{k}": v for p, leaves in serve["cache"].items()
                 for k, v in leaves.items()})
    np.savez(tmp / "in.npz", **flat)
    spec = {"arch": SCENARIOS[SERVE][0], "fields": kw, "gb": gb,
            "mesh": MESH, "key": 7, "seq": SEQ, "max_len": MAX_LEN,
            "pos0": POS0, "ticks": TICKS}
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    env.pop("XLA_FLAGS", None)
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz"), json.dumps(spec)],
        env=env, stderr=subprocess.PIPE, text=True)
    try:
        params_np, batches, ref = {}, {}, {}
        for name, (_, _, gb, opts) in SCENARIOS.items():
            jarch = make_arch(name, jreduced, jget_arch)
            rng = np.random.default_rng(11 + len(params_np))
            batches[name] = [
                {"tokens": rng.integers(0, jarch.vocab_size, (gb, SEQ)
                                        ).astype(np.int32),
                 "labels": rng.integers(0, jarch.vocab_size, (gb, SEQ)
                                        ).astype(np.int32)}
                for _ in range(STEPS)]
            jparams = JModel(jarch, dtype=jnp.float32).init(
                jax.random.PRNGKey(7))
            params_np[name] = jax.tree.map(np.asarray, jparams)
            jmodel = JModel(jarch, dtype=jnp.float32, remat=True,
                            attn_impl="naive",
                            loss_chunk=opts.get("loss_chunk", 0))
            jex = JSPMDExecutor(jmodel, jparams,
                                jadamw.AdamWConfig(**opt_config()))
            stats = [jex.step(b) for b in batches[name]]
            ref[name] = ([float(x["loss"]) for x in stats],
                         [float(x["grad_norm"]) for x in stats],
                         [np.asarray(x) for x in jax.tree.leaves(jex.params)])
        world = spawn_world(f"{__name__}:run_world", 4,
                            {"params_np": params_np, "batches": batches,
                             "serve": serve},
                            device="cpu", timeout=300,
                            paths=[os.path.dirname(__file__)])
        err = ref_proc.communicate(timeout=600)[1]
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.wait()
    assert ref_proc.returncode == 0, err[-3000:]
    with np.load(tmp / "out.npz") as f:
        bundles = {k: f[k] for k in f.files}
    return world, ref, bundles


def test_scenarios_straddle_kv_groups():
    """The reduced scenarios place heads as their names say, one rank in
    each straddling two kv groups."""
    h = make_arch("hymba_9q_3kv")
    assert heads_of(h) == [((0, 3), (0, 1)), ((3, 5), (1, 2)),
                           ((5, 7), (1, 3)), ((7, 9), (2, 3))]
    assert tp_pieces(h, (5, 7)) == (((5, 6), (1, 2)), ((6, 7), (2, 3)))
    q = make_arch("qwen25_10q_2kv")
    assert heads_of(q) == [((0, 3), (0, 1)), ((3, 6), (0, 2)),
                           ((6, 8), (1, 2)), ((8, 10), (1, 2))]
    assert tp_pieces(q, (3, 6)) == (((3, 5), (0, 1)), ((5, 6), (1, 2)))
    assert q.qkv_bias and (h.head_dim, q.head_dim) == (16, 16)


def heads_of(arch):
    return [tp_heads(arch, MESH[1], r) for r in range(MESH[1])]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_straddling_heads_track_the_reference(results, name):
    world, ref, _ = results
    r = world[0]["train"][name]
    losses, norms, jleaves = ref[name]
    np.testing.assert_allclose(r["losses"], losses, atol=ATOL, rtol=RTOL)
    # the global norm the clip divides by: each element counted once
    np.testing.assert_allclose(r["norms"], norms, atol=ATOL, rtol=RTOL)
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
def test_straddling_heads_ranks_agree_bitwise(results, name):
    """Every rank's loss is bitwise rank 0's, and after every step each
    leaf whose spec does not name the model axis is bitwise equal across
    the model group (all four ranks)."""
    world, _, _ = results
    first = world[0]["train"][name]
    assert first["whole"] and len(first["whole"]) == STEPS
    for rank in world[1:]:
        r = rank["train"][name]
        assert r["loss_bits"] == first["loss_bits"]
        for step, leaves in enumerate(r["whole"]):
            assert leaves.keys() == first["whole"][step].keys()
            for path, t in leaves.items():
                assert np.array_equal(t, first["whole"][step][path]), (
                    step, path)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_straddling_heads_state_builds_and_traffic(results, name):
    """Each rank's state is the dry-run's per-card args less the batch,
    each batch shape builds one program, each rank computes the heads
    and pieces ``TPContext`` gives it, and the "tp" all-reduce bytes are
    the count from the shapes."""
    world, _, _ = results
    arch = make_arch(name)
    want = tp_reduced_bytes(arch, SCENARIOS[name][2])
    straddle = 0
    for rank in world:
        r = rank["train"][name]
        m = rank["coords"]["model"]
        assert r["held"] == r["want"]
        assert r["compiles"] == 1
        heads, kv = tp_heads(arch, MESH[1], m)
        assert (r["heads"], r["kv_heads"]) == (heads, kv)
        assert r["pieces"] == tuple(
            ((a - heads[0], b - heads[0]), (c - kv[0], d - kv[0]))
            for (a, b), (c, d) in tp_pieces(arch, heads))
        straddle += len(r["pieces"]) > 1
        assert r["reduced"] == [want] * STEPS
    assert straddle == 1


def _err(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


def test_straddling_heads_serve_like_the_reference_bundles(results):
    """The prefill's and each greedy tick's logits within 1e-5 of the
    reference's bundles on every rank, the greedy tokens equal (the
    reference's top-2 gap above ``MARGIN`` at each tick), the gathered
    cache within 1e-5 of the reference's, two programs a rank."""
    world, _, ref = results
    for rank in world:
        r = rank["serve"]
        assert _err(r["prefill"], ref["prefill"]) < SERVE_ATOL
        for t in range(TICKS):
            want = ref[f"tick{t}"]
            assert _err(r["ticks"][t], want) < SERVE_ATOL, t
            top2 = np.sort(want[:, -1], axis=-1)[:, -2:]
            assert (top2[:, 1] - top2[:, 0] > MARGIN).all(), t
            assert np.array_equal(r["ticks"][t][:, -1].argmax(-1),
                                  want[:, -1].argmax(-1))
        for part, leaves in r["cache"].items():
            for leaf, got in leaves.items():
                assert _err(got, ref[f"cache/{part}/{leaf}"]) < SERVE_ATOL
        assert r["builds"] == 2


def test_shared_kv_head_cache_copies_are_bitwise_equal(results):
    """A kv head two ranks share (their query heads split its group) is
    written by both from the same inputs and the same gathered columns:
    the two copies are bitwise equal after the decode ticks."""
    world, _, _ = results
    shared = 0
    for i, a in enumerate(world):
        for b in world[i + 1:]:
            shared += _same_copies(a["serve"], b["serve"])
    # kv heads 0 / 1 / 1-2 / 2: heads 1 and 2 held twice each
    assert shared == 2


def _same_copies(a, b):
    """How many kv heads ranks a and b both hold, each asserted bitwise
    equal in both copies."""
    (a0, a1), (b0, b1) = a["kv_heads"], b["kv_heads"]
    for h in range(max(a0, b0), min(a1, b1)):
        for leaf in ("k", "v"):
            assert np.array_equal(a["attn"][leaf][..., h - a0, :],
                                  b["attn"][leaf][..., h - b0, :]), (h, leaf)
    return max(0, min(a1, b1) - max(a0, b0))
