"""``SPMDExecutor`` over a real process mesh where the global batch does
not simply split into rows: MoE over several batch ranks, and sequence
parallelism over the batch axes a small batch leaves uncovered.

One world of 4 CPU processes joined by gloo (``launch/mesh.py::
spawn_world``) runs every scenario, each reduced to 2 blocks at d 64:

  * granite-moe, global batch 8 on data 2 x model 2, 4 x 1 and 1 x 4
    (the router's statistics summed over 4 batch ranks), and on 2 x 2
    with masks that give the ranks unequal token counts;
  * gpt3-medium with global batch 2 on 2 x 2 (rows over data, the
    sequence over model) and global batch 1 (the sequence over data x
    model, 4 positions a rank);
  * qwen3 (GQA, tied head), mamba2 (the mixer's input gathered, the
    scan over the whole sequence on each rank), hymba (attention and
    the SSM heads in parallel, a sliding window of 6 in both packages)
    and granite-moe (MoE and the sequence together), each with global
    batch 2;
  * granite-moe with global batch 1 at sequence 18 over 4 ranks: 4 does
    not divide 18, so the sequence stays whole on every rank and each
    rank counts the same tokens;
  * granite-moe's capacity dispatch over 4 batch ranks (each group's
    statistics summed over them) and its grouped dispatch with the
    sequence over model.

The port's models mix the attention paths (the flash kernels' plain
versions through their custom backward, the blocked and the naive
softmax) and the whole and the chunked CE.  Each scenario is held
against the JAX package's ``SPMDExecutor`` without a mesh (one program
on one CPU device) on the same weights (``repro_torch.convert``) and
batches: two steps' losses, global gradient norms and MoE aux losses at
tests/test_executor.py's fp32 tolerance, the params by its tracking
rule; every rank's losses are bitwise equal, each rank's state bytes
equal the dry-run's per-card args less the batch (``launch/dryrun.py``
prices the reference's program, unchanged), and each batch shape builds
one program.

The module imports no JAX at its top: the ranks import it to run
``run_scenarios``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_arch, reduced

LR, STEPS = 1e-3, 2
#: tests/test_executor.py's fp32 tolerance (tree_allclose_ulp)
ATOL, RTOL = 5e-7, 5e-4

#: name -> (arch, mesh (data, model), global batch, sequence, data,
#: the port's model options)
SCENARIOS = {
    "moe_2x2": ("granite_moe_1b_a400m", (2, 2), 8, 16, "plain",
                dict(attn_impl="kernel", loss_chunk=8)),
    "moe_4x1": ("granite_moe_1b_a400m", (4, 1), 8, 16, "plain",
                dict(attn_impl="naive", loss_chunk=8)),
    "moe_1x4": ("granite_moe_1b_a400m", (1, 4), 8, 16, "plain",
                dict(attn_impl="blocked", loss_chunk=8)),
    "moe_2x2_masked": ("granite_moe_1b_a400m", (2, 2), 8, 16, "masked",
                       dict(attn_impl="kernel", loss_chunk=8)),
    "gpt3_seq_model": ("gpt3_medium", (2, 2), 2, 16, "plain",
                       dict(attn_impl="kernel", loss_chunk=8)),
    "gpt3_seq_all": ("gpt3_medium", (2, 2), 1, 16, "plain",
                     dict(attn_impl="blocked", loss_chunk=0)),
    "qwen3_seq": ("qwen3_1_7b", (2, 2), 2, 16, "plain",
                  dict(attn_impl="naive", loss_chunk=8)),
    "mamba2_seq": ("mamba2_780m", (2, 2), 2, 16, "plain",
                   dict(ssd_impl="kernel", loss_chunk=8)),
    "hymba_seq": ("hymba_1_5b", (2, 2), 2, 16, "plain",
                  dict(attn_impl="kernel", ssd_impl="kernel", loss_chunk=0)),
    "moe_seq": ("granite_moe_1b_a400m", (2, 2), 2, 16, "plain",
                dict(attn_impl="kernel", loss_chunk=8)),
    "moe_whole_s18": ("granite_moe_1b_a400m", (2, 2), 1, 18, "plain",
                      dict(attn_impl="kernel", loss_chunk=0)),
    "moe_capacity_2x2": ("granite_moe_1b_a400m", (2, 2), 8, 16, "plain",
                         dict(attn_impl="naive", loss_chunk=8,
                              moe_impl="capacity")),
    "moe_grouped_seq": ("granite_moe_1b_a400m", (2, 2), 2, 16, "plain",
                        dict(attn_impl="blocked", loss_chunk=0,
                             moe_impl="grouped")),
}
#: hymba's sliding window, shrunk to cut the reduced sequence
WINDOW = 6


def port_arch(name):
    arch = reduced(get_arch(name), layers=2)
    if arch.sliding_window:
        arch = dataclasses.replace(arch, sliding_window=WINDOW)
    return arch


def make_model(name, opts):
    from repro_torch.models import Model
    return Model(port_arch(name), dtype=torch.float32, remat=True, **opts)


def opt_config():
    return dict(lr=LR, warmup_steps=0, clip_norm=1.0, weight_decay=0.0)


def run_scenarios(params_np, batches, names):
    """A rank's part: the scenarios ``names`` over this world, in order."""
    from repro_torch.convert import params_from_numpy, to_numpy
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import ProcessMesh, init_world
    from repro_torch.optim import adamw
    from repro_torch.runtime import ShardingStrategy, SPMDExecutor
    from repro_torch.runtime.sharding import gather_tree
    from repro_torch.utils.tree import tree_leaves
    dev = init_world("cpu")
    meshes, out = {}, {}
    for name in names:
        arch, shape, gb, seq, data, opts = SCENARIOS[name]
        if shape not in meshes:
            meshes[shape] = ProcessMesh(("data", "model"), shape)
        mesh = meshes[shape]
        model = make_model(arch, opts)
        strategy = ShardingStrategy()
        sc = ShapeConfig("t", seq, gb, "train")
        ex = SPMDExecutor(model, params_from_numpy(params_np[arch], dev),
                          adamw.AdamWConfig(**opt_config()), mesh=mesh,
                          strategy=strategy, shape=sc)
        held = sum(t.numel() * t.element_size()
                   for t in tree_leaves((ex.params, ex.opt_state)))
        want = dryrun.spec_bytes(model.arch, sc, mesh, strategy, model=model)
        stats = [ex.step(b) for b in batches[(data, gb, seq)]]
        full = gather_tree(ex.pspecs, ex.params, mesh)
        out[name] = {"losses": [float(x["loss"]) for x in stats],
                     "norms": [float(x["grad_norm"]) for x in stats],
                     "aux": [float(x["aux"]) for x in stats],
                     "params": to_numpy(full),
                     "held": held, "want": want["args"] - want["batch"],
                     "compiles": ex.cache.stats.compiles}
    return out


def _ref_key(name):
    """The reference run a scenario is held to: (arch, data, global
    batch, sequence, loss chunk, MoE dispatch)."""
    arch, _, gb, seq, data, opts = SCENARIOS[name]
    return (arch, data, gb, seq, opts.get("loss_chunk", 0),
            opts.get("moe_impl", "dense"))


def _batches(vocab, gb, seq, seed):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, (gb, seq)).astype(np.int32),
             "labels": rng.integers(0, vocab, (gb, seq)).astype(np.int32)}
            for _ in range(STEPS)]


def _masked(batches, seed):
    """Masks giving the 4 batch ranks (2 rows each) unequal counts."""
    rng = np.random.default_rng(seed)
    keep = [0.9, 0.5, 0.25, 1.0]
    out = []
    for b in batches:
        gb, seq = b["tokens"].shape
        m = np.stack([(rng.random(seq) < keep[r // 2]).astype(np.float32)
                      for r in range(gb)])
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
    from repro_torch.launch.mesh import spawn_world
    jparams, ref, batches = {}, {}, {}
    vocab = port_arch("gpt3_medium").vocab_size
    for name, (arch, _, gb, seq, data, opts) in SCENARIOS.items():
        if ("plain", gb, seq) not in batches:
            batches[("plain", gb, seq)] = _batches(vocab, gb, seq, 5 + seq)
        if data == "masked" and (data, gb, seq) not in batches:
            batches[(data, gb, seq)] = _masked(batches[("plain", gb, seq)], 6)
        key = _ref_key(name)
        if key in ref:
            continue
        jarch = jreduced(jget_arch(arch), layers=2)
        if jarch.sliding_window:
            jarch = dataclasses.replace(jarch, sliding_window=WINDOW)
        jmodel = JModel(jarch, dtype=jnp.float32, remat=True,
                        attn_impl="naive", loss_chunk=key[4],
                        moe_impl=key[5])
        if arch not in jparams:
            jparams[arch] = jmodel.init(jax.random.PRNGKey(7))
        jex = JSPMDExecutor(jmodel, jparams[arch],
                            jadamw.AdamWConfig(**opt_config()))
        stats = [jex.step(b) for b in batches[(data, gb, seq)]]
        ref[key] = ([float(x["loss"]) for x in stats],
                    [float(x["grad_norm"]) for x in stats],
                    [float(x["aux"]) for x in stats],
                    [np.asarray(x) for x in jax.tree.leaves(jex.params)])
    params_np = {k: jax.tree.map(np.asarray, v) for k, v in jparams.items()}
    world = spawn_world(f"{__name__}:run_scenarios", 4,
                        {"params_np": params_np, "batches": batches,
                         "names": list(SCENARIOS)},
                        device="cpu", timeout=300,
                        paths=[__file__.rsplit("/", 1)[0]])
    return world, ref


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_mesh_executor_tracks_the_reference(results, name):
    world, ref = results
    arch, _, gb, seq, data, opts = SCENARIOS[name]
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
    # every rank reports the same losses and aux, bit for bit
    for other in world[1:]:
        assert other[name]["losses"] == r["losses"]
        assert other[name]["aux"] == r["aux"]
    # each rank's state: the dry-run's per-card args less the batch; one
    # program for the bound shapes (a mask is one more batch entry, so
    # the masked batch builds its own)
    for rank in world:
        assert rank[name]["held"] == rank[name]["want"]
        assert rank[name]["compiles"] == (2 if data == "masked" else 1)


def test_capacity_groups_must_not_straddle_sequence_shards():
    """A capacity group wider than a rank's positions would need tokens
    of another shard: refused before any collective."""
    from repro_torch.models import moe
    from repro_torch.runtime.sharding import SeqShard
    arch = port_arch("granite_moe_1b_a400m")
    params = moe.init_moe(torch.Generator().manual_seed(0), arch)
    x = torch.zeros((1, 8, arch.d_model))
    with pytest.raises(ValueError, match="straddle"):
        moe.moe_mlp_capacity(params, arch, x, SeqShard(None, 8, 16, 16),
                             group_size=16)

