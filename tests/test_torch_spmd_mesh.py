"""``SPMDExecutor`` over a real process mesh (``repro_torch``'s FSDP and
ZeRO-1 data plane on ``torch.distributed``).

One world of 4 CPU processes joined by gloo (``launch/mesh.py::
spawn_world``) runs every scenario: reduced gpt3-medium (2 blocks, d 64,
S 16, remat and the chunked CE) on meshes data 2 x model 2, data 4 x
model 1 and data 1 x model 4, ZeRO-1 on and off, a batch whose masks
give the ranks unequal token counts, a clip norm that binds, reduced
qwen3 (tied head), and the 2 x 2 case a second time; a second world of
fresh processes runs the 2 x 2 case once more.  Each is held against the
JAX package's ``SPMDExecutor`` without a mesh (one program on one CPU
device) on the same weights (``repro_torch.convert``) and batches: two
steps' losses at tests/test_executor.py's fp32 tolerance, the params by
its tracking rule, and the global gradient norm the clip divides by
(AdamW's update hardly sees a clip's scale, so the norm is what shows
each element counted once).  Every rank's losses are bitwise equal, both
reruns are bitwise the first run, each rank's state bytes are the
dry-run's per-card args less the batch, and each batch shape builds one
program.  ``all_reduce_sum``'s backward sums the group's cotangents.
TP runs in tests/test_torch_spmd_tp.py and, for the Mamba2 mixer and
hymba, tests/test_torch_spmd_tp_ssm.py; heads no layout of whole heads a
rank places raise.  MoE over several batch ranks and a batch
that leaves a batch axis uncovered (the sequence then shards over it)
run in tests/test_torch_spmd_seq.py.

The module imports no JAX at its top: the ranks import it to run
``run_scenarios``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_arch, reduced
from repro_torch.launch.mesh import make_mesh, spawn_world
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.runtime import ShardingStrategy, SPMDExecutor

GB, SEQ, LR, STEPS = 8, 16, 1e-3, 2
#: tests/test_executor.py's fp32 tolerance (tree_allclose_ulp)
ATOL, RTOL = 5e-7, 5e-4

#: name -> (arch, mesh (data, model), zero1, data, clip_norm)
SCENARIOS = {
    "2x2": ("gpt3_medium", (2, 2), True, "plain", 1.0),
    "4x1": ("gpt3_medium", (4, 1), True, "plain", 1.0),
    "1x4": ("gpt3_medium", (1, 4), True, "plain", 1.0),
    "2x2_no_zero1": ("gpt3_medium", (2, 2), False, "plain", 1.0),
    "2x2_masked": ("gpt3_medium", (2, 2), True, "masked", 1.0),
    "2x2_clip_binds": ("gpt3_medium", (2, 2), True, "plain", 1e-2),
    "2x2_tied_qwen3": ("qwen3_1_7b", (2, 2), True, "plain", 1.0),
    "2x2_again": ("gpt3_medium", (2, 2), True, "plain", 1.0),
}


def make_model(name):
    return Model(reduced(get_arch(name), layers=2), dtype=torch.float32,
                 remat=True, attn_impl="naive", loss_chunk=8)


def opt_config(clip):
    return dict(lr=LR, warmup_steps=0, clip_norm=clip, weight_decay=0.0)


def run_scenarios(params_np, batches, names):
    """A rank's part: the scenarios ``names`` over this world, in order."""
    from repro_torch.convert import params_from_numpy, to_numpy
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import ProcessMesh, init_world
    from repro_torch.runtime.sharding import gather_tree
    from repro_torch.utils.tree import tree_leaves
    from repro_torch.runtime.collectives import all_reduce_sum
    dev = init_world("cpu")
    meshes, out = {}, {}
    # all_reduce_sum's backward: the cotangents summed over the group
    mesh = meshes[(2, 2)] = ProcessMesh(("data", "model"), (2, 2))
    x = torch.full((3,), float(mesh.rank + 1), requires_grad=True)
    y = all_reduce_sum(x, mesh, "model")
    (y * (mesh.rank + 1)).sum().backward()
    out["all_reduce_sum"] = {"y": y.tolist(), "grad": x.grad.tolist(),
                             "coords": mesh.coords}
    for name in names:
        arch, shape, zero1, data, clip = SCENARIOS[name]
        if shape not in meshes:
            meshes[shape] = ProcessMesh(("data", "model"), shape)
        mesh = meshes[shape]
        model = make_model(arch)
        strategy = ShardingStrategy(zero1=zero1)
        sc = ShapeConfig("t", SEQ, GB, "train")
        ex = SPMDExecutor(model, params_from_numpy(params_np[arch], dev),
                          adamw.AdamWConfig(**opt_config(clip)), mesh=mesh,
                          strategy=strategy, shape=sc)
        held = sum(t.numel() * t.element_size()
                   for t in tree_leaves((ex.params, ex.opt_state)))
        want = dryrun.spec_bytes(model.arch, sc, mesh, strategy, model=model)
        stats = [ex.step(b) for b in batches[data]]
        full = gather_tree(ex.pspecs, ex.params, mesh)
        out[name] = {"losses": [float(x["loss"]) for x in stats],
                     "norms": [float(x["grad_norm"]) for x in stats],
                     "params": to_numpy(full),
                     "held": held, "want": want["args"] - want["batch"],
                     "compiles": ex.cache.stats.compiles}
    return out


def _batches(vocab, seed):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, (GB, SEQ)).astype(np.int32),
             "labels": rng.integers(0, vocab, (GB, SEQ)).astype(np.int32)}
            for _ in range(STEPS)]


def _masked(batches, seed):
    """Masks giving the 4 batch ranks (2 rows each) unequal counts."""
    rng = np.random.default_rng(seed)
    keep = [0.9, 0.5, 0.25, 1.0]
    out = []
    for b in batches:
        m = np.stack([(rng.random(SEQ) < keep[r // 2]).astype(np.float32)
                      for r in range(GB)])
        out.append({**b, "mask": m})
    return out


@pytest.fixture(scope="module")
def results():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as jget_arch
    from repro.configs import reduced as jreduced
    from repro.models import Model as JModel
    from repro.optim import adamw as jadamw
    from repro.runtime import SPMDExecutor as JSPMDExecutor
    jparams, ref = {}, {}
    vocab = reduced(get_arch("gpt3_medium")).vocab_size
    plain = _batches(vocab, 5)
    batches = {"plain": plain, "masked": _masked(plain, 6)}
    for name, (arch, _, _, data, clip) in SCENARIOS.items():
        key = (arch, data, clip)
        if key in ref:
            continue
        jmodel = JModel(jreduced(jget_arch(arch), layers=2),
                        dtype=jnp.float32, remat=True, attn_impl="naive",
                        loss_chunk=8)
        if arch not in jparams:
            jparams[arch] = jmodel.init(jax.random.PRNGKey(7))
        jex = JSPMDExecutor(jmodel, jparams[arch],
                            jadamw.AdamWConfig(**opt_config(clip)))
        stats = [jex.step(b) for b in batches[data]]
        ref[key] = ([float(x["loss"]) for x in stats],
                    [float(x["grad_norm"]) for x in stats],
                    [np.asarray(x) for x in jax.tree.leaves(jex.params)])
    params_np = {k: jax.tree.map(np.asarray, v) for k, v in jparams.items()}
    kw = dict(device="cpu", timeout=300, paths=[__file__.rsplit("/", 1)[0]])
    world = spawn_world(f"{__name__}:run_scenarios", 4,
                        {"params_np": params_np, "batches": batches,
                         "names": list(SCENARIOS)}, **kw)
    # a second world of fresh processes runs the first scenario again
    again = spawn_world(f"{__name__}:run_scenarios", 4,
                        {"params_np": params_np, "batches": batches,
                         "names": ["2x2"]}, **kw)
    return world, ref, again


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_mesh_executor_tracks_the_reference(results, name):
    world, ref, _ = results
    arch, _, _, data, clip = SCENARIOS[name]
    r = world[0][name]
    losses, norms, jleaves = ref[(arch, data, clip)]
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
    # every rank reports the same losses, bit for bit
    for other in world[1:]:
        assert other[name]["losses"] == r["losses"]
    # each rank's state: the dry-run's per-card args less the batch; one
    # program for the bound shapes (a mask is one more batch entry, so
    # the masked batch builds its own)
    for rank in world:
        assert rank[name]["held"] == rank[name]["want"]
        assert rank[name]["compiles"] == (2 if data == "masked" else 1)


def test_all_reduce_sum_and_its_backward_sum_over_the_group(results):
    """Rank r's model group is {r - r % 2, r - r % 2 + 1}; each rank's
    objective is (rank + 1) * sum(y), so x's gradient is the sum of the
    group's weights."""
    world, _, _ = results
    for rank, r in enumerate(world):
        pair = (rank - rank % 2 + 1, rank - rank % 2 + 2)
        assert r["all_reduce_sum"]["y"] == [float(sum(pair))] * 3
        assert r["all_reduce_sum"]["grad"] == [float(sum(pair))] * 3


@pytest.mark.parametrize("rerun", ["same world", "fresh world"])
def test_same_world_twice_is_bitwise(results, rerun):
    world, _, again = results
    a = world[0]["2x2"]
    b = world[0]["2x2_again"] if rerun == "same world" else again[0]["2x2"]
    assert a["losses"] == b["losses"] and a["norms"] == b["norms"]
    from repro_torch.utils.tree import tree_leaves
    for x, y in zip(tree_leaves(a["params"]), tree_leaves(b["params"])):
        assert np.array_equal(x, y)


def test_sharded_state_is_smaller_than_one_card(results):
    world, _, _ = results
    one = world[0]["4x1"]["held"]
    # ZeRO-1 over 4 data ranks shards the moments; 1 x 4 shards params too
    assert world[0]["1x4"]["held"] < one
    assert world[0]["2x2_no_zero1"]["held"] > world[0]["2x2"]["held"]


#: case -> (arch fields replaced, model axis, what the message names):
#: a reduced hymba's 4 query heads over 8 ranks (a rank would compute
#: none); a reduced mamba2's 8 Mamba2 heads over 16
_UNPLACED = {"hymba_1_5b": ({}, 8, "4 query heads"),
             "mamba2_780m": ({}, 16, "8 Mamba2 heads")}


@pytest.mark.parametrize("case", ["mamba2_780m", "hymba_1_5b"])
def test_layouts_of_item_17c_raise(case):
    """TP over heads that no layout of whole heads a rank places raises
    before any process group is needed (tests/test_torch_spmd_tp_ssm.py
    runs the Mamba2 mixer and hymba where they fall, and
    tests/test_torch_spmd_tp_heads.py query heads that straddle kv
    groups)."""
    fields, n, names = _UNPLACED[case]
    model = Model(dataclasses.replace(reduced(get_arch(case), layers=2),
                                      **fields), dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(0))
    strategy = ShardingStrategy(strategy="tp")
    with pytest.raises(NotImplementedError, match=names):
        SPMDExecutor(model, params, adamw.AdamWConfig(**opt_config(1.0)),
                     mesh=make_mesh((1, n), ("data", "model")),
                     strategy=strategy, shape=ShapeConfig("t", SEQ, GB,
                                                          "train"))
