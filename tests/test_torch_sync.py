"""The port's bucketed sync plane: with codec none it is BITWISE equal to
its per-layer oracle (the same multiply and add per element, in the same
order), in the reduce, in the update and over whole training steps; the
codecs encode exactly as the JAX package's, and the wire bytes match the
shared accounting."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import compression as jcomp

from repro_torch.configs import get_arch, reduced
from repro_torch.core import EngineConfig, OobleckEngine, build_profile
from repro_torch.data import GlobalBatchDispenser, SyntheticLM
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.runtime import (BucketedSync, HeteroTrainer, ProgramCache,
                                 perlayer_global_sumsq, perlayer_sync)
from repro_torch.runtime import compression
from repro_torch.runtime.executor import avals_of
from repro_torch.runtime.pipeline import split_into_layers
from repro_torch.utils.tree import tree_leaves, tree_map

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

GB, MB, SEQ = 16, 2, 16


def _setup(n_nodes=5, layers=4, policy="replan"):
    arch = reduced(get_arch("gpt3_medium"), layers=layers)
    model = Model(arch, dtype=torch.float32, attn_impl="naive")
    params = model.init(torch.Generator().manual_seed(0))
    engine = OobleckEngine(
        build_profile(arch, microbatch=MB, seq_len=SEQ),
        [f"n{i}" for i in range(n_nodes)],
        EngineConfig(fault_tolerance=1, global_batch=GB, microbatch=MB,
                     gpus_per_node=1, n0_override=2, recovery_policy=policy))
    return arch, model, params, engine


def _random_grads(layers, seed):
    g = torch.Generator().manual_seed(seed)
    return {l: tree_map(lambda t: torch.randn(t.shape, generator=g), lt)
            for l, lt in enumerate(layers)}


@pytest.mark.parametrize("pods", [None, "split"])
def test_bucketed_reduce_and_update_bitwise_equal_perlayer(pods):
    arch, model, params, engine = _setup()
    layers = split_into_layers(model, params)
    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, clip_norm=0.0,
                            weight_decay=0.0)
    bs = BucketedSync(ProgramCache(), cfg, [avals_of(l) for l in layers])
    R = len(engine.instances)
    replica_pods = ([[r for r in range(R)] for _ in engine.sync_plan()]
                    if pods else None)
    plan = bs.exec_plan(engine.sync_plan(), replica_pods)
    grads = [_random_grads(layers, seed=r) for r in range(R)]
    weights = [5, 3][:R]
    red = bs.reduce(plan, grads, weights)
    oracle = perlayer_sync(grads, weights, len(layers))
    for b, flat in zip(plan, red.flats):
        off = 0
        for l in b.lids:
            for leaf in tree_leaves(oracle[l]):
                got = flat[off:off + leaf.numel()].view(leaf.shape)
                if pods:     # one replica per pod: the sum reassociates
                    torch.testing.assert_close(got, leaf, rtol=1e-6, atol=1e-7)
                else:
                    assert torch.equal(got, leaf), l
                off += leaf.numel()
    torch.testing.assert_close(sum(red.sumsqs),
                               perlayer_global_sumsq(oracle, len(layers)),
                               rtol=1e-5, atol=0)
    if pods:
        return
    # the per-bucket update equals the per-layer update bit for bit
    states = {l: {"p": tree_map(torch.clone, lt),
                  "m": tree_map(torch.zeros_like, lt),
                  "v": tree_map(torch.zeros_like, lt)}
              for l, lt in enumerate(layers)}
    step = torch.zeros((), dtype=torch.int32)
    scale = torch.tensor(0.5)
    bucketed = {l: dict(st) for l, st in states.items()}
    bs.update(plan, red.flats, bucketed, scale, step)
    for l, st in states.items():
        g = tree_map(lambda t: t * scale, oracle[l])
        p, s, _ = adamw.update(cfg, st["p"], g, adamw.AdamWState(step, st["m"], st["v"]))
        for a, b in zip(tree_leaves((p, s.m, s.v)),
                        tree_leaves((bucketed[l]["p"], bucketed[l]["m"],
                                     bucketed[l]["v"]))):
            assert torch.equal(a, b), l


def _microbatches(batch, mb):
    n = batch["tokens"].shape[0] // mb
    return [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()
             if not k.startswith("_")} for i in range(n)]


def test_trainer_bucketed_bitwise_equals_perlayer_through_failure():
    out = {}
    for mode in ("bucketed", "perlayer"):
        arch, model, params, engine = _setup()
        tr = HeteroTrainer(model, engine, params, adamw.AdamWConfig(
            lr=1e-3, warmup_steps=0, clip_norm=1.0, weight_decay=0.0),
            sync_mode=mode)
        disp = GlobalBatchDispenser(SyntheticLM(arch.vocab_size, SEQ, seed=4))
        losses = []
        for step in range(3):
            if step == 1:
                tr.recover({engine.instances[0].nodes[-1]})
            batches = disp.next_step(engine.batch.minibatch_sizes())
            losses.append(float(tr.step([_microbatches(b, MB)
                                         for b in batches])["loss"]))
        out[mode] = (losses, tr.full_params())
        assert tr.replica_divergence() == 0.0
    assert out["bucketed"][0] == out["perlayer"][0]
    for a, b in zip(tree_leaves(out["bucketed"][1]),
                    tree_leaves(out["perlayer"][1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_codecs_match_reference_and_wire_accounting(codec):
    flat = np.random.default_rng(1).standard_normal(1000).astype(np.float32)
    enc_t = compression.encode_flat(torch.from_numpy(flat.copy()), codec)
    enc_j = jcomp.encode_flat(jnp.asarray(flat), codec)
    dec_t = compression.decode_flat(enc_t, codec).numpy()
    dec_j = np.asarray(jcomp.decode_flat(enc_j, codec))
    np.testing.assert_array_equal(dec_t, dec_j)
    parts = [enc_t["q"], enc_t["scale"]] if codec == "int8" else [enc_t]
    assert (sum(t.numel() * t.element_size() for t in parts)
            == compression.flat_wire_bytes(flat.size, codec)
            == jcomp.encoded_nbytes(enc_j, codec))


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_lossy_codec_trains_and_drops_stale_residuals(codec):
    arch, model, params, engine = _setup()
    tr = HeteroTrainer(model, engine, params, adamw.AdamWConfig(
        lr=1e-3, warmup_steps=0, weight_decay=0.0), codec=codec)
    disp = GlobalBatchDispenser(SyntheticLM(arch.vocab_size, SEQ, seed=2))
    batches = disp.next_step(engine.batch.minibatch_sizes())
    tr.step([_microbatches(b, MB) for b in batches])
    before = set(tr._bsync.ef.residuals)
    assert before and all(k[2] == codec for k in before)
    tr.recover({engine.instances[0].nodes[-1]})
    valid = {("ef", b.signature, codec, r) for b in tr._bucket_plan()
             for r in range(len(engine.instances))}
    assert set(tr._bsync.ef.residuals) <= valid
    batches = disp.next_step(engine.batch.minibatch_sizes())
    out = tr.step([_microbatches(b, MB) for b in batches])
    assert np.isfinite(float(out["loss"]))
    assert tr.replica_divergence() == 0.0
