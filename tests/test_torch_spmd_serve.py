"""The prefill and decode bundles run over a process mesh
(``runtime/spmd.py::SPMDServer``) and the stage pipeline beside another
mesh axis (``runtime/spmd_pipeline.py``), against the JAX package's.

One world of 4 CPU processes joined by gloo runs every case on a data 2 x
model 2 mesh, each reduced to 2 blocks, sequence 16, vocabulary 512 (so
the model axis cuts the table), on the JAX package's weights
(``repro_torch.convert``):

  * ``strategy="tp"`` and ``"fsdp"`` for qwen3-1.7b (tied table, q/k
    norms), hymba-1.5b with 10 query / 5 kv heads and a window of 8
    (whole kv groups a rank, 3 on rank 0 and 2 on rank 1, the ring buffer
    filled), mamba2-780m, granite-moe-1b-a400m (the capacity dispatch
    for prefill, the grouped one for decode, as the reference's dry-run
    serves MoE) and musicgen-large (16 frame embeddings ahead of the
    tokens), at global batch 4, and qwen3 at global batch 2 (under FSDP
    the sequence over model in prefill, the rows whole on the model
    group in decode);
  * each held at 1e-5 against ``prefill_bundle(...).jit()`` and
    ``decode_bundle(...).jit()`` run in a subprocess on 4 forced host
    devices over the same mesh: the prefill's last-position logits, 3
    decode ticks' logits from a seeded cache at position 9 and the
    cache after them, gathered from the ranks (``gather_rows``,
    ``gather_cache``);
  * within the world: every rank gathers the same values, the ranks of
    a model group return bitwise-equal rows under TP, each step builds
    one program, and a rank's TP cache holds its heads.

The pipeline (reduced gpt3-medium with 8 blocks, M 3 microbatches of 2 x
8 tokens) runs on stage 2 x data 2 and on data 2 x stage 2: its logits
against the reference's ``pipeline_logits`` and its gradients against
``jax.grad`` of the reference's ``pipeline_loss`` on a ("stage", "data")
mesh of 4 forced host devices (1e-5); the ranks of one stage bitwise
equal in their gradients and their parameters after a step, and the
loss bitwise on every rank.

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
from repro_torch.runtime.spmd import DECODE_MOE_IMPL

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SEQ, MAX_LEN, POS0, TICKS = 16, 12, 9, 3
ATOL = 1e-5
#: name -> (arch, arch fields replaced, strategy, global batch)
CASES = {
    f"{arch}-{strategy}" + ("-gb2" if gb == 2 else ""): (arch, fields,
                                                         strategy, gb)
    for arch, fields, gbs in (
        ("qwen3_1_7b", {}, (4, 2)),
        ("hymba_1_5b", {"num_heads": 10, "num_kv_heads": 5,
                        "sliding_window": 8}, (4,)),
        ("mamba2_780m", {}, (4,)),
        ("granite_moe_1b_a400m", {}, (4,)),
        ("musicgen_large", {}, (4,)))
    for gb in gbs for strategy in ("tp", "fsdp")}
#: the prefill's MoE dispatch, as the reference's dry-run serves it; the
#: decode's is the server's own (``DECODE_MOE_IMPL``)
PREFILL_MOE = "capacity"
#: the pipeline: the reference pipeline test's model and microbatches
M, B, S_PIPE, PIPE_LAYERS = 3, 2, 8, 8
OPT = dict(lr=1e-3, warmup_steps=0, clip_norm=1.0, weight_decay=0.0)


def make_arch(case, reduce=reduced, get=get_arch):
    name, fields, _, _ = CASES[case]
    return dataclasses.replace(reduce(get(name), layers=2), **fields)


def inputs(case):
    """The case's prompts (and frame embeddings), decode tokens and
    seeded one-program cache, from numpy."""
    arch = make_arch(case)
    gb = CASES[case][3]
    rng = np.random.default_rng(list(CASES).index(case))
    out = {"tokens": rng.integers(0, arch.vocab_size, (gb, SEQ)
                                  ).astype(np.int32),
           "decode": rng.integers(0, arch.vocab_size, (TICKS, gb, 1)
                                  ).astype(np.int32)}
    if arch.frontend:
        out["frontend_embeds"] = rng.standard_normal(
            (gb, arch.frontend_tokens, arch.d_model)).astype(np.float32)
    from repro_torch.models import Model
    shapes = Model(arch, dtype=torch.float32).init_cache(gb, MAX_LEN, "cpu")
    for part, leaves in shapes.items():
        for leaf, t in leaves.items():
            out[f"cache/{part}/{leaf}"] = (0.5 * rng.standard_normal(
                tuple(t.shape))).astype(np.float32)
    return out


#: the reference's bundles on 4 forced host devices over data 2 x model 2,
#: and its pipeline over ("stage", "data") 2 x 2, written to an npz
SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.configs import ShapeConfig, get_arch, reduced
    from repro.launch.mesh import make_mesh_compat
    from repro.models import Model
    from repro.models.layers import cross_entropy
    from repro.runtime import spmd
    from repro.runtime.sharding import ShardingStrategy
    from repro.runtime.spmd_pipeline import pipeline_logits, pipeline_loss

    spec = json.loads(sys.argv[3])
    data = np.load(sys.argv[1])
    out = {}
    mesh = make_mesh_compat((2, 2), ("data", "model"))
    for case, (name, fields, strat, gb) in spec["cases"].items():
        arch = dataclasses.replace(reduced(get_arch(name), layers=2),
                                   **fields)
        strategy = ShardingStrategy(strategy=strat)

        def model(impl):
            return spmd.build_model(arch, strategy, mesh, gb,
                                    dtype=jnp.float32, remat=False,
                                    attn_impl="naive", moe_impl=impl)
        pm, dm = model(spec["prefill_moe"]), model(spec["decode_moe"])
        params = pm.init(jax.random.PRNGKey(0))
        batch = {"tokens": jnp.asarray(data[case + ":tokens"])}
        if arch.frontend:
            batch["frontend_embeds"] = jnp.asarray(
                data[case + ":frontend_embeds"])
        cache = {}
        for k in data.files:
            if k.startswith(case + ":cache/"):
                _, part, leaf = k.split(":")[1].split("/")
                cache.setdefault(part, {})[leaf] = jnp.asarray(data[k])
        with mesh:
            shape = ShapeConfig("s", spec["seq"], gb, "prefill")
            pre = spmd.prefill_bundle(pm, strategy, mesh, params,
                                      shape).jit()
            out[case + ":prefill"] = np.asarray(pre(params, batch))
            dec = spmd.decode_bundle(dm, strategy, mesh, params, cache,
                                     ShapeConfig("d", spec["max_len"], gb,
                                                 "decode")).jit()
            for t, tok in enumerate(data[case + ":decode"]):
                logits, cache = dec(params, jnp.asarray(tok), cache,
                                    jnp.int32(spec["pos0"] + t))
                out[case + f":decode{t}"] = np.asarray(logits)
        for part, leaves in cache.items():
            for leaf, v in leaves.items():
                out[case + f":cache/{part}/{leaf}"] = np.asarray(v)

    pmesh = make_mesh_compat((2, 2), ("stage", "data"))
    arch = reduced(get_arch("gpt3_medium"), layers=spec["pipe_layers"])
    model = Model(arch, dtype=jnp.float32, remat=False, attn_impl="naive")
    params = model.init(jax.random.PRNGKey(0))
    tokens = jnp.asarray(data["pipe:tokens"])
    labels = jnp.asarray(data["pipe:labels"])
    with pmesh:
        out["pipe:logits"] = np.asarray(pipeline_logits(model, params,
                                                        tokens, pmesh))
        loss, grads = jax.value_and_grad(lambda p: pipeline_loss(
            model, p, tokens, labels, pmesh))(params)
    out["pipe:loss"] = np.asarray(loss)
    for i, g in enumerate(jax.tree.leaves(grads)):
        out[f"pipe:grad{i}"] = np.asarray(g)
    np.savez(sys.argv[2], **out)
""")


def _cache_of(flat, dev):
    cache = {}
    for k, v in flat.items():
        if k.startswith("cache/"):
            _, part, leaf = k.split("/")
            cache.setdefault(part, {})[leaf] = torch.from_numpy(v).to(dev)
    return cache


def run_world(params_np, data, pipe_params_np, pipe_data):
    """A rank's part: every serving case on data 2 x model 2, then the
    pipeline on stage 2 x data 2 and data 2 x stage 2."""
    from repro_torch.convert import params_from_numpy, to_numpy
    from repro_torch.launch.mesh import ProcessMesh, init_world
    from repro_torch.models import Model
    from repro_torch.runtime import ShardingStrategy, SPMDServer
    from repro_torch.utils.tree import tree_map
    dev = init_world("cpu")
    mesh = ProcessMesh(("data", "model"), (2, 2))
    out = {"coords": dict(mesh.coords), "cases": {}}
    for case, (_, _, strat, gb) in CASES.items():
        arch = make_arch(case)
        model = Model(arch, dtype=torch.float32, remat=False,
                      attn_impl="kernel", ssd_impl="kernel", fuse="fused",
                      moe_impl=PREFILL_MOE)
        server = SPMDServer(model, params_from_numpy(params_np[case], dev),
                            mesh, ShardingStrategy(strategy=strat),
                            ShapeConfig("s", SEQ, gb, "prefill"))
        d = data[case]
        batch = {"tokens": torch.from_numpy(server.rows(d["tokens"]))}
        if "frontend_embeds" in d:
            batch["frontend_embeds"] = torch.from_numpy(
                server.rows(d["frontend_embeds"]))
        rows = server.prefill(batch)
        r = {"prefill_rows": rows.numpy().copy(),
             "prefill": server.gather_rows(rows).numpy().copy()}
        cache = server.shard_cache(_cache_of(d, dev))
        r["cache_shapes"] = {f"{p}/{k}": tuple(v.shape)
                             for p, leaves in cache.items()
                             for k, v in leaves.items()}
        for t in range(TICKS):
            tok = torch.from_numpy(server.rows(d["decode"][t]))
            logits, cache = server.decode(tok, cache, POS0 + t)
            r[f"decode{t}_rows"] = logits.numpy().copy()
            r[f"decode{t}"] = server.gather_rows(logits).numpy().copy()
        full = server.gather_cache(cache)
        r["cache"] = tree_map(lambda t: t.numpy().copy(), full)
        again = server.shard_cache(full)
        r["roundtrip"] = all(torch.equal(again[p][k], cache[p][k])
                             for p in cache for k in cache[p])
        r["builds"] = server.cache.stats.compiles
        tp = server._model.tp
        r["kv_heads"] = tp.kv_heads if tp is not None else None
        r["ssm_heads"] = tp.ssm_heads if tp is not None else None
        out["cases"][case] = r
    out["pipe"] = {}
    for axes in (("stage", "data"), ("data", "stage")):
        out["pipe"][axes] = run_pipeline(axes, pipe_params_np, pipe_data,
                                         dev)
    return out


def run_pipeline(axes, params_np, data, dev):
    from repro_torch.convert import params_from_numpy, to_numpy
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime.spmd_pipeline import (gather_stages,
                                                   make_pipeline_train_step,
                                                   pipeline_logits,
                                                   pipeline_value_and_grad,
                                                   stage_params)
    from repro_torch.utils.tree import tree_map
    mesh = ProcessMesh(axes, (2, 2))
    model = Model(reduced(get_arch("gpt3_medium"), layers=PIPE_LAYERS),
                  dtype=torch.float32, remat=False, attn_impl="naive")
    local = stage_params(params_from_numpy(params_np, dev), mesh)
    tok = torch.from_numpy(data["tokens"])
    lab = torch.from_numpy(data["labels"])
    logits = pipeline_logits(model, local, tok, mesh)
    loss, grads = pipeline_value_and_grad(model, local, tok, lab, mesh)
    local_grads = tree_map(lambda t: t.numpy().copy(), grads)
    grads = gather_stages(grads, mesh)
    step = make_pipeline_train_step(model, adamw.AdamWConfig(**OPT), mesh)
    local, _, stats = step(local, adamw.init(local), tok, lab)
    return {"stage": mesh.axis_index("stage"),
            "logits": logits.numpy(), "loss": loss.numpy().tobytes(),
            "grads": to_numpy(grads), "local_grads": local_grads,
            "step_loss": stats["loss"].numpy().tobytes(),
            "params": tree_map(lambda t: t.numpy().copy(), local)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as jget_arch
    from repro.configs import reduced as jreduced
    from repro.models import Model as JModel
    tmp = tmp_path_factory.mktemp("serve")
    data = {case: inputs(case) for case in CASES}
    rng = np.random.default_rng(7)
    pipe = {"tokens": rng.integers(0, 512, (M, B, S_PIPE)).astype(np.int32),
            "labels": rng.integers(0, 512, (M, B, S_PIPE)).astype(np.int32)}
    flat = {f"{case}:{k}": v for case, d in data.items() for k, v in d.items()}
    flat.update({f"pipe:{k}": v for k, v in pipe.items()})
    np.savez(tmp / "in.npz", **flat)
    spec = {"cases": CASES, "prefill_moe": PREFILL_MOE,
            "decode_moe": DECODE_MOE_IMPL, "seq": SEQ, "max_len": MAX_LEN,
            "pos0": POS0, "pipe_layers": PIPE_LAYERS}
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz"), json.dumps(spec)],
        env=env, stderr=subprocess.PIPE, text=True)
    try:
        params = {case: jax.tree.map(np.asarray, JModel(
            make_arch(case, jreduced, jget_arch), dtype=jnp.float32
        ).init(jax.random.PRNGKey(0))) for case in CASES}
        pipe_params = jax.tree.map(np.asarray, JModel(
            jreduced(jget_arch("gpt3_medium"), layers=PIPE_LAYERS),
            dtype=jnp.float32).init(jax.random.PRNGKey(0)))
        from repro_torch.launch.mesh import spawn_world
        world = spawn_world(f"{__name__}:run_world", 4,
                            {"params_np": params, "data": data,
                             "pipe_params_np": pipe_params,
                             "pipe_data": pipe},
                            device="cpu", timeout=300,
                            paths=[os.path.dirname(__file__)])
        err = ref_proc.communicate(timeout=600)[1]
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.wait()
    assert ref_proc.returncode == 0, err[-3000:]
    with np.load(tmp / "out.npz") as f:
        ref = {k: f[k] for k in f.files}
    return world, ref


def _err(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_prefill_matches_the_reference_bundle(results, case,
                                                   record_property):
    world, ref = results
    want = ref[f"{case}:prefill"]
    for rank in world:
        err = _err(rank["cases"][case]["prefill"], want)
        record_property("err", err)
        assert err < ATOL, (case, err)
        assert np.array_equal(rank["cases"][case]["prefill"],
                              world[0]["cases"][case]["prefill"])


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_decode_ticks_match_the_reference_bundle(results, case):
    world, ref = results
    for t in range(TICKS):
        want = ref[f"{case}:decode{t}"]
        for rank in world:
            err = _err(rank["cases"][case][f"decode{t}"], want)
            assert err < ATOL, (case, t, err)


@pytest.mark.parametrize("case", list(CASES))
def test_gathered_cache_matches_the_reference_bundle(results, case):
    """The ranks' caches gathered equal the reference's cache after the
    ticks (the inputs were cut from one seeded cache by
    ``shard_cache``, and cutting the gathered cache again gives each
    rank's own bitwise)."""
    world, ref = results
    for rank in world:
        r = rank["cases"][case]
        assert r["roundtrip"], case
        for part, leaves in r["cache"].items():
            for leaf, got in leaves.items():
                err = _err(got, ref[f"{case}:cache/{part}/{leaf}"])
                assert err < ATOL, (case, part, leaf, err)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_serving_layout_on_the_ranks(results, case):
    """One program a step and shape; under TP the ranks of a model group
    return bitwise-equal rows and hold the cache at their heads."""
    world, _ = results
    arch = make_arch(case)
    _, _, strat, gb = CASES[case]
    groups = {}
    for rank in world:
        r = rank["cases"][case]
        assert r["builds"] == 2, (case, r["builds"])
        groups.setdefault(rank["coords"]["data"], []).append(r)
        if strat == "tp":
            shapes = r["cache_shapes"]
            if arch.num_heads:
                kv = r["kv_heads"][1] - r["kv_heads"][0]
                assert shapes["attn/k"][3] == kv, (case, shapes)
            if arch.ssm is not None:
                h = r["ssm_heads"][1] - r["ssm_heads"][0]
                assert shapes["mamba/ssm"][2] == h, (case, shapes)
    if strat == "tp":
        for members in groups.values():
            for other in members[1:]:
                for key in ["prefill_rows"] + [f"decode{t}_rows"
                                               for t in range(TICKS)]:
                    assert np.array_equal(other[key], members[0][key]), key
    if case == "hymba_1_5b-tp":       # uneven whole kv groups: 3 and 2
        assert sorted({r["cases"][case]["kv_heads"] for r in world}) == [
            (0, 3), (3, 5)]


def _leaves(tree):
    from repro_torch.utils.tree import tree_leaves
    return tree_leaves(tree)


@pytest.mark.parametrize("axes", [("stage", "data"), ("data", "stage")],
                         ids=["stage-data", "data-stage"])
def test_pipeline_beside_data_matches_the_reference(results, axes):
    world, ref = results
    want = ref["pipe:logits"]
    for rank in world:
        p = rank["pipe"][axes]
        assert _err(p["logits"], want) < ATOL
        np.testing.assert_allclose(
            np.frombuffer(p["loss"], np.float32)[0], ref["pipe:loss"],
            atol=ATOL)
        ours = _leaves(p["grads"])
        theirs = [ref[f"pipe:grad{i}"] for i in range(len(ours))]
        assert f"pipe:grad{len(ours)}" not in ref
        gerr = max(_err(a, b) for a, b in zip(ours, theirs))
        assert gerr < ATOL, gerr


@pytest.mark.parametrize("axes", [("stage", "data"), ("data", "stage")],
                         ids=["stage-data", "data-stage"])
def test_pipeline_ranks_of_one_stage_are_bitwise_equal(results, axes):
    world, _ = results
    by_stage = {}
    for rank in world:
        p = rank["pipe"][axes]
        assert p["loss"] == world[0]["pipe"][axes]["loss"]
        assert p["step_loss"] == world[0]["pipe"][axes]["step_loss"]
        by_stage.setdefault(p["stage"], []).append(p)
    assert sorted(by_stage) == [0, 1]
    for members in by_stage.values():
        assert len(members) == 2
        a, b = members
        for x, y in zip(_leaves(a["local_grads"]), _leaves(b["local_grads"])):
            assert np.array_equal(x, y)
        for x, y in zip(_leaves(a["params"]), _leaves(b["params"])):
            assert np.array_equal(x, y)


def test_one_card_server_is_the_plain_model():
    """Without a mesh the server's prefill is ``Model.prefill`` bitwise and
    its decode ``Model.decode_step``'s; one build each."""
    from repro_torch.models import Model
    from repro_torch.runtime import SPMDServer
    arch = reduced(get_arch("qwen3_1_7b"), layers=2)
    model = Model(arch, dtype=torch.float32, remat=False)
    params = model.init(torch.Generator().manual_seed(0))
    server = SPMDServer(model, params, shape=ShapeConfig("s", 8, 2, "p"))
    tokens = torch.randint(0, arch.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model.prefill(params, tokens)
    assert torch.equal(server.prefill({"tokens": tokens}), want)
    cache = server.init_cache(8)
    ref_cache = model.init_cache(2, 8, "cpu")
    for t in range(3):
        got, cache = server.decode(tokens[:, t:t + 1], cache, t)
        with torch.no_grad():
            ref, ref_cache = model.decode_step(params, tokens[:, t:t + 1],
                                               ref_cache, t)
        assert torch.equal(got, ref)
    assert server.cache.stats.compiles == 2


def test_server_on_an_abstract_mesh_raises():
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.runtime import ShardingStrategy, SPMDServer
    model = Model(reduced(get_arch("qwen3_1_7b"), layers=2),
                  dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(TypeError, match="ProcessMesh"):
        SPMDServer(model, params, make_mesh((2, 2), ("data", "model")),
                   ShardingStrategy(strategy="tp"),
                   ShapeConfig("s", 8, 4, "p"))
    # 4 query heads over 8 ranks: a rank would compute none
    with pytest.raises(NotImplementedError, match="4 query heads"):
        SPMDServer(Model(reduced(get_arch("hymba_1_5b"), layers=2),
                         dtype=torch.float32), None,
                   make_mesh((1, 8), ("data", "model")),
                   ShardingStrategy(strategy="tp"), ShapeConfig("s", 8, 4, "p"))
