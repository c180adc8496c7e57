"""The port's serving plane (``repro_torch/runtime/serve_exec.py``,
``repro_torch/launch/serve.py``) on the CPU, at the reference suite's
sizes (``reduced(qwen3-1.7b, layers=2)``, 2 slots, max_len 16, prompts
of 5).

  1. every test of ``tests/test_serve_exec.py``, ported: no host reads in
     the decode loop, a failure mid-decode builds nothing and keeps the
     streams bitwise at T 0 and 0.8, replay keeps the streamed prefix,
     sampling is a pure function of (request, position), greedy equals
     a plain decode loop, dissolved replicas migrate, overflow replays,
     joins are bitwise, static admission waits, ``submit`` validates;
  2. the port's streams equal the reference ``ServeExecutor``'s on the
     same weights, prompts and sample key at T 0 and 0.8 (reduced qwen3,
     mamba2-780m and hymba-1.5b with a window the ring buffer wraps),
     each sampled position's margin asserted first: the two largest
     perturbed logits more than 1e-4 apart;
  3. the in-place decode equals the functional one bitwise, and the
     admission leaves the other rows' caches alone: a request
     mid-decode on a Mamba arch keeps its stream when another is
     admitted beside it, and the admission stopped at the prompt equals
     the reference's whole-bucket scan bitwise;
  4. the CLI serves through a failure with ``--device cpu`` and raises
     without a card by default.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.launch.serve import build_serving_engine as ref_engine
from repro.models import Model as RefModel
from repro.runtime import ProgramCache as RefProgramCache
from repro.runtime.serve_exec import SamplingParams as RefSampling
from repro.runtime.serve_exec import ServeExecutor as RefExecutor
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.launch.serve import build_serving_engine
from repro_torch.models import Model
from repro_torch.runtime import (ProgramCache, track_compiles,
                                 track_host_transfers)
from repro_torch.runtime import serve_exec
from repro_torch.runtime.serve_exec import SamplingParams, ServeExecutor
from repro_torch.utils import prng
from repro_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

SLOTS = 2
PROMPT = 5
MAX_NEW = 4
MAX_LEN = 16
#: the smallest gap between the two largest perturbed logits at which
#: the two packages' samplers must agree
MARGIN = 1e-4
ARCHS = ("qwen3-1.7b", "mamba2-780m", "hymba-1.5b")


def _arches(name):
    """The reference's and the port's reduced config; hymba's window is
    cut below MAX_LEN so its ring buffer wraps."""
    ref, port = (ref_reduced(ref_get_arch(name), layers=2),
                 reduced(get_arch(name), layers=2))
    if port.sliding_window:
        ref = dataclasses.replace(ref, sliding_window=8)
        port = dataclasses.replace(port, sliding_window=8)
    return ref, port


class Setup:
    """One arch in both packages on the same weights."""

    def __init__(self, name):
        self.ref_arch, self.arch = _arches(name)
        self.ref_model = RefModel(self.ref_arch, dtype=jnp.float32,
                                  remat=False)
        self.ref_params = self.ref_model.init(jax.random.PRNGKey(0))
        self.model = Model(self.arch, dtype=torch.float32, remat=False)
        self.params = params_from_numpy(
            jax.tree.map(np.asarray, self.ref_params), device="cpu")
        self.cache = ProgramCache()
        self.ref_cache = RefProgramCache()


_SETUPS = {}


def _setup(name) -> Setup:
    if name not in _SETUPS:
        _SETUPS[name] = Setup(name)
    return _SETUPS[name]


@pytest.fixture(scope="module")
def setup():
    return _setup("qwen3-1.7b")


def make_executor(s: Setup, *, nodes=6, temperature=0.0, **kw):
    engine = build_serving_engine(
        s.arch, nodes=[f"node{i}" for i in range(nodes)])
    kw.setdefault("cache", s.cache)
    return ServeExecutor(
        s.model, s.params, engine, num_slots=SLOTS, max_len=MAX_LEN,
        max_new_cap=8, sampling=SamplingParams(temperature=temperature),
        sample_key=prng.prng_key(42), **kw)


def make_ref_executor(s: Setup, *, nodes=6, temperature=0.0):
    engine = ref_engine(s.ref_arch,
                        nodes=[f"node{i}" for i in range(nodes)])
    return RefExecutor(
        s.ref_model, s.ref_params, engine, num_slots=SLOTS, max_len=MAX_LEN,
        max_new_cap=8, sampling=RefSampling(temperature=temperature),
        sample_key=jax.random.PRNGKey(42), cache=s.ref_cache)


def prompts(arch, n, plen=PROMPT):
    rng = np.random.default_rng(11)
    return [rng.integers(0, arch.vocab_size, plen).astype(np.int32)
            for _ in range(n)]


def fail_first_node(ex):
    victim = ex.engine.instances[0].nodes[0]
    ex.engine.monitor.inject("fail", [victim])
    ex.engine.monitor.poll(0.0)


def run_trace(ex, arch, n_req, fail_after=None, join_after=None):
    """Submit n_req prompts, optionally fault/join mid-decode, drain,
    and return the token streams keyed by rid."""
    for p in prompts(arch, n_req):
        ex.submit(p, max_new=MAX_NEW)
    ex.tick()
    ex.tick()
    if fail_after is not None:
        fail_first_node(ex)
    if join_after is not None:
        ex.join(join_after)
    ex.drain()
    assert len(ex.completed) == n_req
    return {r.rid: r.tokens for r in ex.completed}


# ----------------------------------------------------------------------
# 1. Steady state: no device->host traffic, no builds
# ----------------------------------------------------------------------
def test_decode_loop_makes_no_host_transfers(setup):
    """8 new tokens a request (the reference's 4 would finish, and read
    back, in the second guarded tick)."""
    arch = setup.arch
    ex = make_executor(setup)
    for p in prompts(arch, 4):
        ex.submit(p, max_new=8)
    ex.tick()                           # admissions settle outside guard

    # control: the instrumentation really does catch a d2h read
    with track_host_transfers() as ctl:
        float(torch.ones(()) + 1)
    assert ctl.device_to_host >= 1

    with track_host_transfers() as log:
        ex.tick()                       # pure decode: no admit, no finish
        ex.tick()
    assert log.device_to_host == 0, \
        f"{log.device_to_host} device->host transfers in the decode loop"
    ex.drain()
    assert len(ex.completed) == 4
    assert all(len(r.tokens) == 8 for r in ex.completed)


# ----------------------------------------------------------------------
# 2. Failure mid-decode: zero builds, bitwise-identical streams
# ----------------------------------------------------------------------
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_failure_mid_decode_is_build_free_and_bitwise(setup, temperature):
    arch = setup.arch
    baseline = run_trace(make_executor(setup, temperature=temperature),
                         arch, 6)

    ex = make_executor(setup, temperature=temperature)
    for p in prompts(arch, 6):
        ex.submit(p, max_new=MAX_NEW)
    ex.tick()
    ex.tick()
    with track_compiles() as log:
        fail_first_node(ex)
        ex.drain()
    assert log.backend_compiles == 0, \
        f"{log.backend_compiles} builds during fail->recover->drain"
    assert ex.last_recovery is not None
    assert ex.last_recovery["policy"] == "replan"
    assert ex.last_recovery["replayed"] >= 1
    assert len(ex.completed) == 6
    streams = {r.rid: r.tokens for r in ex.completed}
    for rid, toks in baseline.items():
        np.testing.assert_array_equal(
            streams[rid], toks,
            f"rid {rid} diverged after failure (T={temperature})")


def test_replayed_requests_keep_streamed_prefix(setup):
    """Tokens already streamed to the client before the failure are
    teacher-forced back in, never regenerated."""
    arch = setup.arch
    ex = make_executor(setup, temperature=0.8)
    for p in prompts(arch, 4):
        ex.submit(p, max_new=MAX_NEW)
    ex.tick()
    ex.tick()                           # every stream has >= 2 tokens out
    # a copy: the port's state is updated in place
    pre = {r.rid: rep.out[slot].numpy()[:int(rep.ngen_h[slot])].copy()
           for rep in ex.replicas
           for slot, r in enumerate(rep.requests) if r is not None}
    fail_first_node(ex)
    replayed = [r for r in list(ex.queue) if r.replays > 0]
    assert replayed and all(len(r.prior) >= 2 for r in replayed)
    ex.drain()
    for r in ex.completed:
        np.testing.assert_array_equal(r.tokens[:len(pre[r.rid])],
                                      pre[r.rid])


# ----------------------------------------------------------------------
# 3. Sampling determinism
# ----------------------------------------------------------------------
def test_sampling_is_a_pure_function_of_request_and_position(setup):
    arch = setup.arch
    ex = make_executor(setup, temperature=0.9)
    p = prompts(arch, 1)[0]
    ex.submit(p, max_new=MAX_NEW, rid=7)
    ex.submit(p, max_new=MAX_NEW, rid=7)    # same identity -> same stream
    ex.submit(p, max_new=MAX_NEW, rid=8)    # new identity  -> fresh stream
    ex.drain()
    by_order = sorted(ex.completed, key=lambda r: r.arrival_s)
    a, b, c = by_order
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert not np.array_equal(a.tokens, c.tokens), \
        "independent requests produced identical samples"


def test_greedy_ignores_rid_and_matches_reference_decode(setup):
    """At temperature 0 the slot machinery must reproduce plain
    token-by-token decode + argmax exactly."""
    arch, model, params = setup.arch, setup.model, setup.params
    ex = make_executor(setup)
    p = prompts(arch, 1)[0]
    ex.submit(p, max_new=MAX_NEW)
    ex.drain()
    got = ex.completed[0].tokens

    cache = model.init_cache(1, MAX_LEN, device="cpu")
    toks = list(p)
    ref = []
    with torch.no_grad():
        for t in range(len(p) + MAX_NEW - 1):
            logits, cache = model.decode_step(
                params, torch.tensor([[toks[t]]], dtype=torch.int32), cache,
                torch.tensor(t, dtype=torch.int32))
            if t >= len(p) - 1:
                nxt = int(torch.argmax(logits[0, 0]))
                ref.append(nxt)
                if t + 1 < len(p) + MAX_NEW:
                    toks.append(nxt)
    np.testing.assert_array_equal(got, np.asarray(ref[:MAX_NEW], np.int32))


# ----------------------------------------------------------------------
# 4. Migration of dissolved-but-intact replicas
# ----------------------------------------------------------------------
def test_dissolved_replica_migrates_cache_rows(setup):
    """When a replan dissolves a replica whose nodes all survive, its
    in-flight rows move via extract/install + CopyTasks on the transfer
    topology — and the streams stay bitwise-identical."""
    arch = setup.arch
    baseline = run_trace(make_executor(setup, temperature=0.8), arch, 2)

    ex = make_executor(setup, temperature=0.8)
    for p in prompts(arch, 2):
        ex.submit(p, max_new=MAX_NEW)
    ex.tick()                           # both land on replica 0
    ex.tick()
    old = ex.replicas
    assert old[0].active_mask().sum() == 2 and not old[1].active_mask().any()
    ex.engine.instances = [ex.engine.instances[1]]   # dissolve replica 0
    with track_compiles() as log:
        info = ex._rebind(old, set())
        ex.drain()
    assert log.backend_compiles == 0
    assert info["migrated"] == 2 and info["replayed"] == 0
    assert info["copy_bytes"] > 0
    assert info["transfer_makespan_s"] > 0
    assert len(ex.completed) == 2
    assert all(r.migrations == 1 for r in ex.completed)
    for r in ex.completed:
        np.testing.assert_array_equal(r.tokens, baseline[r.rid])


def test_migration_overflow_falls_back_to_replay(setup):
    """More in-flight rows than free slots: the overflow replays from the
    host-known prefix instead of being dropped."""
    arch = setup.arch
    ex = make_executor(setup, temperature=0.8)
    for p in prompts(arch, 4):          # fills both replicas
        ex.submit(p, max_new=MAX_NEW)
    ex.tick()
    ex.tick()
    old = ex.replicas
    ex.engine.instances = [ex.engine.instances[1]]
    info = ex._rebind(old, set())
    assert info["migrated"] == 0        # target replica has no free slots
    assert info["replayed"] == 2
    ex.drain()
    assert len(ex.completed) == 4


# ----------------------------------------------------------------------
# 5. Join mid-traffic
# ----------------------------------------------------------------------
def test_join_mid_traffic_is_build_free_and_bitwise(setup):
    arch = setup.arch
    baseline = run_trace(make_executor(setup, temperature=0.8), arch, 6)
    ex = make_executor(setup, temperature=0.8)
    for p in prompts(arch, 6):
        ex.submit(p, max_new=MAX_NEW)
    ex.tick()
    ex.tick()
    before = len(ex.replicas)
    with track_compiles() as log:
        ex.join(["node6", "node7"])
        ex.drain()
    assert log.backend_compiles == 0
    assert ex.last_recovery["policy"] == "join"
    assert len(ex.replicas) > before
    assert len(ex.completed) == 6
    for r in ex.completed:
        np.testing.assert_array_equal(r.tokens, baseline[r.rid])


# ----------------------------------------------------------------------
# 6. Scheduler semantics
# ----------------------------------------------------------------------
def test_static_admission_waits_for_full_drain(setup):
    """The static baseline only refills an empty replica; continuous
    batching backfills freed slots immediately.  With skewed lengths the
    short request's slot sits idle under static admission."""
    arch = setup.arch
    lengths = [2, 8, 2, 8, 2, 2]

    def finish_ticks(mode):
        ex = make_executor(setup, admission=mode)
        for p, n in zip(prompts(arch, len(lengths)), lengths):
            ex.submit(p, max_new=n)
        ex.drain()
        return ex.ticks

    assert finish_ticks("continuous") < finish_ticks("static")


def test_submit_validates_against_built_shapes(setup):
    arch = setup.arch
    ex = make_executor(setup)
    with pytest.raises(ValueError):
        ex.submit(prompts(arch, 1, plen=12)[0], max_new=MAX_LEN)
    with pytest.raises(ValueError):
        ex.submit(prompts(arch, 1)[0], max_new=9)   # > out-ring cap
    snap = ex.snapshot()
    assert snap["in_flight"] == [] and snap["queued"] == []


def test_program_cache_keys_match_the_reference_in_kind_and_count(setup):
    """decode, one admit per prompt bucket, extract, install — and none
    added by traffic or a failure."""
    ex = make_executor(setup, cache=None)
    kinds = sorted(k[:2] if k[0] == "serve_admit" else k[:1]
                   for k in ex.cache._programs)
    assert kinds == sorted([("serve_decode",), ("serve_extract",),
                            ("serve_install",)] +
                           [("serve_admit", b) for b in ex.buckets])
    assert ex.buckets == [8, 16]
    run_trace(ex, setup.arch, 4, fail_after=True)
    assert ex.cache.stats.compiles == len(kinds)


# ----------------------------------------------------------------------
# 7. Parity with the reference ServeExecutor
# ----------------------------------------------------------------------
@pytest.fixture
def margins(monkeypatch):
    """Records, for every (key, position) the port samples, the gap
    between the two largest (perturbed) logits it chose from."""
    seen = {}
    orig = serve_exec._sample_tokens

    def spy(logits, keys, pos, temp, top_k):
        out = orig(logits, keys, pos, temp, top_k)
        folded = prng.fold_in(keys, pos)
        z = logits
        if float(temp) > 0:
            z = prng.gumbel(folded, logits.shape[-1]) + logits / temp
        top = torch.topk(z, 2, dim=-1).values
        gap = (top[:, 0] - top[:, 1]).tolist()
        pos_rows = (pos.tolist() if isinstance(pos, torch.Tensor)
                    else [pos] * len(gap))
        for k, p, g in zip(keys.tolist(), pos_rows, gap):
            seen[(k[0], k[1], p)] = min(g, seen.get((k[0], k[1], p), g))
        return out

    monkeypatch.setattr(serve_exec, "_sample_tokens", spy)

    def check(ex):
        """Every sampled position of every completed request."""
        for r in ex.completed:
            k0, k1 = ex._base_key(r.rid).tolist()
            P = len(r.prompt)
            for n in range(r.max_new):
                gap = seen[(k0, k1, P + n - 1)]
                assert gap > MARGIN, (r.rid, n, gap)
    return check


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("arch_name", ARCHS)
def test_streams_equal_the_reference_executor(arch_name, temperature,
                                              margins):
    """The same weights, prompts and sample key through the reference's
    ServeExecutor and the port's — the port's with a node failure after
    two ticks — give the same streams bitwise."""
    s = _setup(arch_name)
    want = run_trace(make_ref_executor(s, temperature=temperature),
                     s.ref_arch, 6)
    ex = make_executor(s, temperature=temperature)
    got = run_trace(ex, s.arch, 6, fail_after=True)
    margins(ex)
    assert ex.last_recovery["replayed"] + ex.last_recovery["migrated"] >= 1
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      f"rid {rid} (T={temperature})")


# ----------------------------------------------------------------------
# 8. In-place decode and admission
# ----------------------------------------------------------------------
def _equal_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


@pytest.mark.parametrize("arch_name", ARCHS)
def test_in_place_decode_equals_functional_decode(arch_name):
    """decode_step_ writes the cache the functional decode_step returns,
    bitwise, over 12 steps of per-row positions (hymba's ring of 8
    wraps); with a write mask the masked rows keep their cache bitwise
    and the others still match."""
    s = _setup(arch_name)
    model, params = s.model, s.params
    B, T = 3, 12
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(
        rng.integers(0, s.arch.vocab_size, (B, T)).astype(np.int32))
    cache_f = model.init_cache(B, MAX_LEN, device="cpu")
    cache_i = model.init_cache(B, MAX_LEN, device="cpu")
    write = torch.tensor([True, False, True])
    with torch.no_grad():
        for t in range(T):
            pos = torch.tensor([t, t + 2, max(t - 1, 0)], dtype=torch.int32)
            lf, new_f = model.decode_step(params, tokens[:, t:t + 1],
                                          cache_f, pos)
            li = model.decode_step_(params, tokens[:, t:t + 1], cache_i, pos)
            assert torch.equal(lf, li)
            assert _equal_trees(new_f, cache_i)
            cache_f = new_f
        before = [c.clone() for c in tree_leaves(cache_i)]
        lm = model.decode_step_(params, tokens[:, :1], cache_i, pos + 1,
                                write)
        lf, new_f = model.decode_step(params, tokens[:, :1], cache_f,
                                      pos + 1)
    assert torch.equal(lm[write], lf[write])
    for old, c, f in zip(before, tree_leaves(cache_i), tree_leaves(new_f)):
        assert torch.equal(c[:, 1], old[:, 1])
        assert torch.equal(c[:, write], f[:, write])


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("arch_name", ["mamba2-780m", "hymba-1.5b"])
def test_admission_leaves_a_decoding_neighbour_alone(arch_name, temperature):
    """A request mid-decode keeps its stream, bitwise, when another is
    admitted into the next slot of its replica: the admission's
    full-batch ticks write the new slot's cache only (a neighbour's
    Mamba state advanced by them would change its stream)."""
    s = _setup(arch_name)
    a, b = prompts(s.arch, 2)

    def stream_of_a(with_neighbour):
        ex = make_executor(s, temperature=temperature, nodes=4)
        ex.submit(a, max_new=8, rid=0)
        ex.tick()
        ex.tick()
        if with_neighbour:
            ex.submit(b, max_new=4, rid=1)
            ex.tick()                   # admits b beside a, then decodes
            assert ex.replicas[0].requests[1] is not None
        ex.drain()
        return {r.rid: r.tokens for r in ex.completed}[0]

    np.testing.assert_array_equal(stream_of_a(True), stream_of_a(False))


@pytest.mark.parametrize("arch_name", ARCHS)
def test_admission_stopped_at_the_prompt_equals_the_whole_bucket(arch_name):
    """The reference scans the whole prompt bucket; the port stops at the
    prompt's end.  The reference's steps past the prompt (the padding
    token at positions plen..bucket-1, no row kept) leave the port's
    state bitwise as it was, so stopping early changes nothing."""
    s = _setup(arch_name)
    ex = make_executor(s, temperature=0.8)
    for p in prompts(s.arch, 2):
        ex.submit(p, max_new=MAX_NEW)
    rep = ex.replicas[0]
    ex._admit(rep, 0, ex.queue.popleft())
    ex._admit(rep, 1, ex.queue.popleft())
    before = [t.clone() for t in tree_leaves(rep.state())]
    bucket = next(b for b in ex.buckets if b >= PROMPT)
    assert bucket > PROMPT
    frozen = torch.zeros(SLOTS, dtype=torch.bool)
    tok, pos = rep.tok.clone(), rep.pos.clone()
    with torch.no_grad():
        for t in range(PROMPT, bucket):
            tok[1], pos[1] = 0, t
            s.model.decode_step_(s.params, tok[:, None], rep.cache, pos,
                                 frozen)
    assert all(torch.equal(x, y) for x, y in
               zip(before, tree_leaves(rep.state())))


# ----------------------------------------------------------------------
# 9. The CLI
# ----------------------------------------------------------------------
def test_serve_cli_on_cpu_serves_through_a_failure(capsys):
    out = serve.main(["--device", "cpu", "--requests", "8", "--fail-at", "4",
                      "--decode-steps", "8", "--layers", "2",
                      "--temperature", "0.8"])
    text = capsys.readouterr().out
    assert "[serve] killed" in text and "requests=8/8" in text
    assert out["tokens"].shape == (8, 8)
    assert out["recovery"]["policy"] == "replan"
    assert out["recovery"]["cache"]["compiles"] == 6
    assert out["tokens_per_s"] > 0 and out["ttft_p99_ms"] >= \
        out["ttft_p50_ms"] > 0
    unfailed = serve.main(["--device", "cpu", "--requests", "8",
                           "--decode-steps", "8", "--layers", "2",
                           "--temperature", "0.8"])
    np.testing.assert_array_equal(out["tokens"], unfailed["tokens"])


def test_serve_cli_defaults_to_the_card_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--requests", "1", "--decode-steps", "2"])


def test_serve_example_runs_three_families_on_cpu(capsys):
    import importlib.util
    import pathlib
    path = (pathlib.Path(__file__).resolve().parents[1] / "examples" /
            "serve_decode_torch.py")
    spec = importlib.util.spec_from_file_location("serve_decode_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu"])
    text = capsys.readouterr().out
    for arch in ARCHS:
        assert f"=== {arch} ===" in text
    assert text.count("requests=4/4") == 3 and "[serve] killed" in text


def test_serve_throughput_tool_on_cpu(tmp_path):
    """tools/serve_throughput.py: three legs, the failed one bitwise and
    build-free (the script asserts both), JSON out; no device metric
    without a card."""
    import importlib.util
    import json
    import pathlib
    path = (pathlib.Path(__file__).resolve().parents[1] / "tools" /
            "serve_throughput.py")
    spec = importlib.util.spec_from_file_location("serve_throughput", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path / "st.json"
    res = mod.main(["--device", "cpu", "--requests", "16", "--long", "8",
                    "--fail-at", "3", "--json", str(out)])
    assert set(res) >= {"static", "continuous", "continuous+fail",
                        "summary", "decode_tick", "device", "config"}
    assert res["continuous+fail"]["builds_after_failure"] == 0
    assert res["continuous"]["ticks"] < res["static"]["ticks"]
    assert res["decode_tick"].startswith("not measured")
    assert json.loads(out.read_text())["summary"][
        "bitwise_identical_through_failure"] is True
