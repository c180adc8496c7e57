"""``SPMDExecutor`` with ``strategy="tp"`` over a real process mesh: the
Mamba2 mixer and hymba's hybrid block under tensor parallelism, each
rank computing whole heads.

One world of 4 CPU processes joined by gloo (``launch/mesh.py::
spawn_world``) runs every scenario, each reduced to 2 blocks, sequence
16, vocabulary 512 (so the model axis cuts the table):

  * mamba2 (d 64: 8 Mamba2 heads of 16, ``in_proj`` 296 columns) on data
    2 x model 2, where the spec cuts ``in_proj`` inside x, with the SSD
    kernels' plain versions and the chunked CE;
  * mamba2 on 1 x 4: the cut falls inside z, 2 Mamba2 heads a rank, the
    chunked scan, the whole CE;
  * mamba2 with global batch 1 on 2 x 2: TP over model, the sequence over
    data (the mixer's input gathered over the sequence group at the
    rank's widths);
  * hymba with 10 query / 5 kv heads and a window of 8 on 2 x 2: whole
    kv groups a rank, 3 on rank 0 and 2 on rank 1, every weight of the
    attention gathered at use, and the two branches under one *f* and
    one *g*;
  * hymba at d 80 on 1 x 4: ``in_proj``'s 362 columns stay whole (through
    *f*), the 10 Mamba2 heads fall 3 / 3 / 2 / 2, and ``norm_w`` and
    ``out_proj`` are cut inside a head: hymba-1.5b's model-4 layout in
    small.

Each scenario is held against the JAX package's ``SPMDExecutor`` without
a mesh (one program on one CPU device) on the same weights
(``repro_torch.convert``) and batches: two steps' losses and global
gradient norms at tests/test_executor.py's fp32 tolerance, the params by
its tracking rule.  Within each run: every rank's losses are bitwise
equal; after every step each leaf whose spec does not name the model
axis is bitwise equal across the model group; each rank's state bytes
equal the dry-run's per-card args less the batch; each batch shape
builds one program; and the "tp"- and "ssm_norm"-tagged all-reduce bytes
a step equal a count from the shapes (``tp_reduced_bytes``).  Pure
functions hold the head placement (``sharding.tp_heads``,
``sharding.ssm_heads``) on every configuration of the repo, and a world
of 2 holds the gated norm's statistics against one process.

The module imports no JAX at its top: the ranks import it."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, ShapeConfig, get_arch, reduced
from repro_torch.runtime.sharding import (heads_fall, ssm_heads,
                                          ssm_heads_fall, tp_heads,
                                          tp_pieces)

LR, STEPS = 1e-3, 2
#: tests/test_executor.py's fp32 tolerance (tree_allclose_ulp)
ATOL, RTOL = 5e-7, 5e-4
SEQ = 16

#: name -> (arch, arch fields replaced (``d_model`` through ``reduced``),
#: mesh (data, model), global batch, the port's model options)
SCENARIOS = {
    "mamba2_2x2": ("mamba2_780m", {}, (2, 2), 4,
                   dict(ssd_impl="kernel", loss_chunk=8)),
    "mamba2_1x4": ("mamba2_780m", {}, (1, 4), 4,
                   dict(ssd_impl="chunked", loss_chunk=0)),
    "mamba2_seq_over_data": ("mamba2_780m", {}, (2, 2), 1,
                             dict(ssd_impl="kernel", loss_chunk=0)),
    "hymba_2x2_kv_groups": ("hymba_1_5b", {"num_heads": 10, "num_kv_heads": 5,
                                           "sliding_window": 8}, (2, 2), 4,
                            dict(attn_impl="kernel", ssd_impl="kernel",
                                 loss_chunk=8)),
    "hymba_1x4_d80": ("hymba_1_5b", {"d_model": 80}, (1, 4), 4,
                      dict(attn_impl="naive", ssd_impl="chunked",
                           loss_chunk=0)),
}


def make_arch(arch, kw, reduce=reduced):
    """``reduce(arch)`` at 2 blocks with ``kw`` (``d_model`` given to
    ``reduce``, which derives the head dims from it)."""
    kw = dict(kw)
    return dataclasses.replace(
        reduce(arch, layers=2, d_model=kw.pop("d_model", 64)), **kw)


def port_arch(name, kw):
    return make_arch(get_arch(name), kw)


def opt_config():
    return dict(lr=LR, warmup_steps=0, clip_norm=1.0, weight_decay=0.0)


def _whole_leaves_bytes(arch, model):
    """Bytes of a block's mixer and attention weights the spec keeps
    whole (the model axis does not divide the cut dimension): each is
    taken through *f*, whose backward all-reduces its gradient, tagged
    "tp", once a step."""
    if model == 1:
        return 0
    c = arch.ssm
    d_inner = c.expand * arch.d_model
    heads = d_inner // c.head_dim
    gn = c.n_groups * c.state_size
    conv_dim = d_inner + 2 * gn
    cut = {"in_proj": (arch.d_model * (2 * d_inner + 2 * gn + heads),
                       2 * d_inner + 2 * gn + heads),
           "conv_w": (c.conv_width * conv_dim, conv_dim),
           "conv_b": (conv_dim, conv_dim),
           "dt_bias": (heads, heads), "A_log": (heads, heads),
           "D": (heads, heads)}
    if arch.num_heads:
        q, kv = arch.num_heads * arch.head_dim, arch.num_kv_heads * arch.head_dim
        cut.update(wq=(arch.d_model * q, q), wk=(arch.d_model * kv, kv),
                   wv=(arch.d_model * kv, kv))
    return 4 * sum(n for n, dim in cut.values() if dim % model)


def tp_reduced_bytes(arch, mesh_shape, gb, remat=True):
    """The all-reduce bytes of one step on a rank, by tag.  "tp": per
    block, each *g* in the forward and each *f* in the backward ([rows,
    positions, d] fp32): mamba2's mixer one of each (torch's checkpoint
    stops its recompute at the block's last saved tensor, the input of
    ``out_proj``'s product, so the *g* after it is not rerun); hymba's
    two branches one of each for the pair, their *g* again in remat's
    recompute (the MLP's saved tensors come after it), and the MLP's one
    of each; plus the weights held whole (``_whole_leaves_bytes``).
    "ssm_norm": the gated norm's sum of squares ([rows, positions, 1]
    fp32) forward, again in the recompute, and its cotangent's sum
    backward."""
    data, model = mesh_shape
    if model == 1:
        return {"tp": 0, "ssm_norm": 0}
    rows = gb // data if gb % data == 0 else gb
    positions = SEQ if gb % data == 0 else SEQ // data
    act = rows * positions * arch.d_model * 4
    extra = 1 if remat else 0
    if arch.family == "ssm":
        acts = 2
    else:
        acts = 2 + extra + 2
    tp = arch.num_layers * (acts * act + _whole_leaves_bytes(arch, model))
    norm = arch.num_layers * (2 + extra) * rows * positions * 4
    return {"tp": tp, "ssm_norm": norm}


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
        tp = strategy.tp_context(mesh, model.arch)
        stats, whole, reduced_bytes = [], [], []
        for b in batches[(arch_name, gb)]:
            mesh.transport.reset()
            stats.append(ex.step(b))
            reduced_bytes.append({tag: kinds["reduced"] for tag, kinds in
                                  mesh.transport.tagged.items()
                                  if tag in ("tp", "ssm_norm")})
            # the leaves whose spec does not name the model axis
            whole.append({p: t.detach().numpy().copy() for p, spec, t in
                          spec_leaves(ex.pspecs, ex.params)
                          if "model" not in spec})
        full = gather_tree(ex.pspecs, ex.params, mesh)
        out[name] = {"losses": [float(x["loss"]) for x in stats],
                     "loss_bits": [x["loss"].numpy().tobytes()
                                   for x in stats],
                     "norms": [float(x["grad_norm"]) for x in stats],
                     "params": to_numpy(full), "whole": whole,
                     "reduced": reduced_bytes, "coords": dict(mesh.coords),
                     "heads": tp.heads, "kv_heads": tp.kv_heads,
                     "ssm_heads": tp.ssm_heads,
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
    return (arch, tuple(sorted(kw.items())), gb, opts.get("loss_chunk", 0))


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
        jarch = make_arch(jget_arch(arch), kw, jreduced)
        if (arch, gb) not in batches:
            batches[(arch, gb)] = _batches(jarch.vocab_size, gb, 11 + gb)
        wkey = (arch, tuple(sorted(kw.items())))
        if wkey not in jparams:
            jparams[wkey] = JModel(jarch, dtype=jnp.float32).init(
                jax.random.PRNGKey(7))
        params_np[name] = jax.tree.map(np.asarray, jparams[wkey])
        key = _ref_key(name)
        if key in ref:
            continue
        jmodel = JModel(jarch, dtype=jnp.float32, remat=True,
                        attn_impl="naive", loss_chunk=key[3])
        jex = JSPMDExecutor(jmodel, jparams[wkey],
                            jadamw.AdamWConfig(**opt_config()))
        stats = [jex.step(b) for b in batches[(arch, gb)]]
        ref[key] = ([float(x["loss"]) for x in stats],
                    [float(x["grad_norm"]) for x in stats],
                    [np.asarray(x) for x in jax.tree.leaves(jex.params)])
    world = spawn_world(f"{__name__}:run_scenarios", 4,
                        {"params_np": params_np, "batches": batches,
                         "names": list(SCENARIOS)},
                        device="cpu", timeout=300,
                        paths=[__file__.rsplit("/", 1)[0]])
    return world, ref


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tp_mixer_tracks_the_reference(results, name):
    world, ref = results
    r = world[0][name]
    losses, norms, jleaves = ref[_ref_key(name)]
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
def test_tp_mixer_ranks_agree_bitwise(results, name):
    """Every rank's loss is bitwise rank 0's, and after every step each
    leaf whose spec does not name the model axis is bitwise equal across
    the model group."""
    world, _ = results
    r0 = world[0][name]
    for rank in world[1:]:
        assert rank[name]["loss_bits"] == r0["loss_bits"]
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
def test_tp_mixer_state_builds_and_traffic(results, name):
    """Each rank's state is the dry-run's per-card args less the batch,
    each batch shape builds one program, each rank computes the heads
    ``TPContext`` gives it, and the tagged all-reduce bytes are the
    count from the shapes."""
    world, _ = results
    arch, kw, shape, gb, _ = SCENARIOS[name]
    a = port_arch(arch, kw)
    want = tp_reduced_bytes(a, shape, gb)
    model = shape[1]
    for rank in world:
        r = rank[name]
        m = r["coords"]["model"]
        assert r["held"] == r["want"]
        assert r["compiles"] == 1
        assert r["ssm_heads"] == ssm_heads(a, model, m)
        if a.num_heads:
            assert (r["heads"], r["kv_heads"]) == tp_heads(a, model, m)
        assert r["reduced"] == [want] * STEPS


def test_scenarios_meet_the_layouts_they_name():
    """The reduced scenarios fall where their names say."""
    m = port_arch("mamba2_780m", {})
    assert (m.ssm.expand * m.d_model, m.ssm.expand * m.d_model // 16) == (128, 8)
    # in_proj [z 128 | x 128 | B 16 | C 16 | dt 8]: model 2 cuts it at 148
    # (inside x), model 4 at 74 (inside z)
    assert [ssm_heads(m, 4, r) for r in range(4)] == [(0, 2), (2, 4), (4, 6),
                                                      (6, 8)]
    h = port_arch("hymba_1_5b", SCENARIOS["hymba_2x2_kv_groups"][1])
    assert [tp_heads(h, 2, r) for r in range(2)] == [((0, 6), (0, 3)),
                                                     ((6, 10), (3, 5))]
    d80 = port_arch("hymba_1_5b", {"d_model": 80})
    assert 2 * 160 + 2 * 16 + 10 == 362 and 362 % 4
    assert [ssm_heads(d80, 4, r) for r in range(4)] == [(0, 3), (3, 6), (6, 8),
                                                        (8, 10)]
    # norm_w's 160 columns cut 40 a rank: 2.5 heads of 16
    assert 160 // 4 % 16


# ----------------------------------------------------------------------
# Head placement on every configuration of the repo
# ----------------------------------------------------------------------
def _old_tp_heads(arch, n, r):
    """The placement before heads could fall unevenly (n dividing H, and
    dividing or divided by KV)."""
    H, KV = arch.num_heads, arch.num_kv_heads
    q0, q1 = r * H // n, (r + 1) * H // n
    if KV % n == 0:
        return (q0, q1), (r * KV // n, (r + 1) * KV // n)
    k0 = q0 // (H // KV)
    return (q0, q1), (k0, k0 + 1)


@pytest.mark.parametrize("n", [2, 4, 8, 16])
@pytest.mark.parametrize("name", ARCH_IDS)
def test_heads_fall_whole_on_every_config(name, n):
    arch = get_arch(name)
    H, KV = arch.num_heads, arch.num_kv_heads
    if H:
        old = H % n == 0 and (KV % n == 0 or n % KV == 0)
        places = [tp_heads(arch, n, r) for r in range(n)]
        if old:           # the even ranges, unchanged
            assert places == [_old_tp_heads(arch, n, r) for r in range(n)]
        elif heads_fall(arch, n):   # whole kv groups, the first ranks one more
            assert [p[1][0] for p in places] == [0] + [
                p[1][1] for p in places[:-1]]
            assert places[-1][1][1] == KV
            sizes = [k1 - k0 for _, (k0, k1) in places]
            assert sizes == sorted(sizes, reverse=True)
            assert sizes[0] - sizes[-1] <= 1 and sizes[-1] >= 1
        if heads_fall(arch, n):
            for (q0, q1), (k0, k1) in places:
                # every rank keeps the group size: q heads G a kv head
                assert q0 * KV == k0 * H or KV < n
                assert (q1 - q0) * KV == (k1 - k0) * H or KV < n
                assert len(tp_pieces(arch, (q0, q1))) == 1
        else:
            # query heads as evenly as they fall, the first ranks one
            # more, and every kv head they read
            assert KV < n and not old
            G = H // KV
            assert [p[0][0] for p in places] == [0] + [
                p[0][1] for p in places[:-1]]
            sizes = [q1 - q0 for (q0, q1), _ in places]
            assert sizes == sorted(sizes, reverse=True)
            assert sizes[0] - sizes[-1] <= 1 and sizes[-1] >= 1
            for (q0, q1), (k0, k1) in places:
                assert (k0, k1) == (q0 // G, -(-q1 // G))
                pieces = tp_pieces(arch, (q0, q1))
                assert [p[0][0] for p in pieces] == [q0] + [
                    p[0][1] for p in pieces[:-1]]
                assert pieces[-1][0][1] == q1
                for (a, b), (c, d) in pieces:   # one GQA shape each
                    assert (b - a) == (d - c) * G or (d - c == 1
                                                      and b - a < G)
                    assert c == a // G and d == -(-b // G)
        assert places[-1][0][1] == H
    if arch.ssm is not None:
        h = arch.ssm.expand * arch.d_model // arch.ssm.head_dim
        assert ssm_heads_fall(arch, n) == (h >= n)
        parts = [ssm_heads(arch, n, r) for r in range(n)]
        assert parts[0][0] == 0 and parts[-1][1] == h
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
        sizes = [b - a for a, b in parts]
        assert max(sizes) - min(sizes) <= 1


#: hymba-1.5b's 25 / 5 heads at model 8: 4 query heads on rank 0, 3 on
#: the others; ranks 1, 4 and 6 straddle two kv groups
HYMBA_MODEL8 = [((0, 4), (0, 1)), ((4, 7), (0, 2)), ((7, 10), (1, 2)),
                ((10, 13), (2, 3)), ((13, 16), (2, 4)), ((16, 19), (3, 4)),
                ((19, 22), (3, 5)), ((22, 25), (4, 5))]


def test_hymba_and_mamba2_placements():
    """hymba-1.5b's 25 / 5 heads: 15 / 3 and 10 / 2 at model 2, kv groups
    2 / 1 / 1 / 1 at model 4, query heads 4 / 3 / ... / 3 at model 8
    (``HYMBA_MODEL8``, in pieces where they straddle kv groups); its 50
    Mamba2 heads 13 / 13 / 12 / 12 at model 4; mamba2-780m's 48 heads 24
    a rank at model 2; qwen2.5-32b's 40 / 8 at model 16, 3 query heads on
    ranks 0-7 and 2 on ranks 8-15."""
    hymba, mamba = get_arch("hymba_1_5b"), get_arch("mamba2_780m")
    assert [tp_heads(hymba, 2, r) for r in range(2)] == [
        ((0, 15), (0, 3)), ((15, 25), (3, 5))]
    assert [tp_heads(hymba, 4, r)[1] for r in range(4)] == [
        (0, 2), (2, 3), (3, 4), (4, 5)]
    assert [tp_heads(hymba, 8, r) for r in range(8)] == HYMBA_MODEL8
    assert [tp_pieces(hymba, q) for q, _ in HYMBA_MODEL8[:2]] == [
        (((0, 4), (0, 1)),), (((4, 5), (0, 1)), ((5, 7), (1, 2)))]
    assert tp_pieces(hymba, (13, 16)) == (((13, 15), (2, 3)),
                                          ((15, 16), (3, 4)))
    assert tp_pieces(hymba, (19, 22)) == (((19, 20), (3, 4)),
                                          ((20, 22), (4, 5)))
    assert [ssm_heads(hymba, 4, r) for r in range(4)] == [
        (0, 13), (13, 26), (26, 38), (38, 50)]
    assert ssm_heads(hymba, 8, 7) == (44, 50)
    assert [ssm_heads(mamba, 2, r) for r in range(2)] == [(0, 24), (24, 48)]
    qwen = get_arch("qwen2_5_32b")
    assert [q1 - q0 for (q0, q1), _ in
            (tp_heads(qwen, 16, r) for r in range(16))] == [3] * 8 + [2] * 8
    assert tp_heads(qwen, 16, 1) == ((3, 6), (0, 2))


def test_check_layout_and_the_dry_run_arch():
    """``check_layout`` refuses only what no placement fits; the dry-run
    traces rank 0's heads, the most query heads a rank computes."""
    from repro_torch.launch.dryrun import local_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import ShardingStrategy
    from repro_torch.runtime.spmd import check_layout
    tp = ShardingStrategy(strategy="tp")
    hymba, mamba = get_arch("hymba_1_5b"), get_arch("mamba2_780m")
    qwen = get_arch("qwen2_5_32b")
    for k in (2, 4, 8, 16):
        mesh = make_mesh((1, k), ("data", "model"))
        check_layout(mesh, tp, hymba)
        check_layout(mesh, tp, mamba)
        check_layout(mesh, tp, qwen)
    # 4 query heads over 8 ranks: a rank would compute none
    with pytest.raises(NotImplementedError, match="4 query heads"):
        check_layout(make_mesh((1, 8), ("data", "model")), tp,
                     reduced(hymba, layers=2))
    small = reduced(mamba, layers=2)                 # 8 Mamba2 heads
    with pytest.raises(NotImplementedError, match="Mamba2 heads"):
        check_layout(make_mesh((1, 16), ("data", "model")), tp, small)
    # heads reading several B / C groups: not placed
    groups = dataclasses.replace(mamba, ssm=dataclasses.replace(
        mamba.ssm, n_groups=2))
    with pytest.raises(NotImplementedError, match="2 B / C group"):
        check_layout(make_mesh((1, 2), ("data", "model")), tp, groups)
    two = local_arch(hymba, tp, make_mesh((2, 2), ("data", "model")))
    assert (two.num_heads, two.num_kv_heads, two.ssm.expand) == (15, 3, 1)
    assert two.d_ff == hymba.d_ff // 2
    four = local_arch(hymba, tp, make_mesh((1, 4), ("data", "model")))
    # 13 heads of 64 are not an integer expand of d 1600: whole
    assert (four.num_heads, four.num_kv_heads, four.ssm) == (10, 2, hymba.ssm)
    eight = local_arch(hymba, tp, make_mesh((1, 8), ("data", "model")))
    assert (eight.num_heads, eight.num_kv_heads, eight.head_dim) == (4, 1, 64)
    assert eight.d_ff == hymba.d_ff // 8 and eight.ssm == hymba.ssm
    q16 = local_arch(qwen, tp, make_mesh((1, 16), ("data", "model")))
    assert (q16.num_heads, q16.num_kv_heads, q16.head_dim) == (3, 1, 128)
    # rank 0's query heads are one piece wherever they fall: the most a
    # rank computes starts a group and, with fewer kv heads than ranks,
    # is at most G
    for a in (hymba, qwen):
        for k in (2, 4, 8, 16):
            assert len(tp_pieces(a, tp_heads(a, k, 0)[0])) == 1
    m2 = local_arch(mamba, tp, make_mesh((2, 2), ("data", "model")))
    assert m2.ssm.expand == 1 and m2.vocab_size == mamba.vocab_size // 2


# ----------------------------------------------------------------------
# The gated norm's statistics, in a world of 2
# ----------------------------------------------------------------------
NB, NS, NH, NP = 2, 3, 4, 5           # rows, positions, heads, head dim
EPS = 1e-5


def _norm_inputs():
    g = torch.Generator().manual_seed(5)
    y = torch.randn((NB, NS, NH * NP), generator=g, dtype=torch.float32)
    z = torch.randn((NB, NS, NH * NP), generator=g, dtype=torch.float32)
    w = torch.randn((NH * NP,), generator=g, dtype=torch.float32)
    up = torch.randn((NB, NS, NH * NP), generator=g, dtype=torch.float32)
    return y, z, w, up


def run_norm_units():
    """A rank's part: ``_gated_norm`` on its half of the columns."""
    from repro_torch.launch.mesh import ProcessMesh, init_world
    from repro_torch.models.ssm import _gated_norm
    from repro_torch.runtime.sharding import TPContext
    init_world("cpu")
    mesh = ProcessMesh(("data", "model"), (1, 2))
    arch = port_arch("mamba2_780m", {})
    tp = TPContext.of(mesh, "model", arch)
    r = mesh.axis_index("model")
    y, z, w, up = _norm_inputs()
    lo, hi = r * NH * NP // 2, (r + 1) * NH * NP // 2
    ys, zs, ws = (t[..., lo:hi].clone().requires_grad_(True)
                  for t in (y, z, w))
    out = _gated_norm(ws, ys, zs, EPS, NH * NP, tp)
    (out * up[..., lo:hi]).sum().backward()
    return {"lo": lo, "hi": hi, "out": out.detach(), "dy": ys.grad,
            "dz": zs.grad, "dw": ws.grad,
            "tagged": {k: dict(v) for k, v in mesh.transport.tagged.items()}}


def test_gated_norm_statistics_over_the_model_group():
    """Each rank's columns of the gated norm and their gradients equal
    the whole norm's on one process (fp32 in another summation order);
    the statistic moves [rows, positions] fp32 each way."""
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.models.ssm import _gated_norm
    units = spawn_world(f"{__name__}:run_norm_units", 2, {}, device="cpu",
                        timeout=120, paths=[__file__.rsplit("/", 1)[0]])
    y, z, w, up = (t.clone().requires_grad_(True) for t in _norm_inputs())
    out = _gated_norm(w, y, z, EPS, NH * NP)
    (out * up.detach()).sum().backward()
    for u in units:
        lo, hi = u["lo"], u["hi"]
        torch.testing.assert_close(u["out"], out.detach()[..., lo:hi],
                                   rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(u["dy"], y.grad[..., lo:hi],
                                   rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(u["dz"], z.grad[..., lo:hi],
                                   rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(u["dw"], w.grad[lo:hi], rtol=RTOL,
                                   atol=ATOL)
        # forward sum and the cotangents' sum backward
        assert u["tagged"]["ssm_norm"]["reduced"] == 2 * NB * NS * 4
