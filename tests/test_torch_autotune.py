"""The port's block-size autotuner (``repro_torch/kernels/autotune.py``).

The JAX package's autotuner tests (tests/test_kernels.py) ported to the
port's module, with its backends: ``"cpu"`` keeps the reference's
interpreter branch, a card key (``"cuda-sm90-132"``) the choices the
kernels made before the autotuner.  Then parity with the JAX package
(buckets, keys, and ``flash_config`` / ``ssd_config`` on ``"cpu"``), the
card heuristic against the parent's choices written out here, two fresh
processes resolving alike (the spawners drop ``REPRO_AUTOTUNE`` and pass
the table on), and ``ops.ssd`` at its default chunk on the CPU against
the JAX package's ``ops.ssd``.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import autotune, flash, fused, ops, ref, ssd

CARD = "cuda-sm90-132"
f32 = torch.float32


@pytest.fixture
def fresh(tmp_path, monkeypatch):
    """A process cache over an empty file and no tuning, for the port
    (and, where asked, the JAX package)."""
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    path = str(tmp_path / "port.json")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", path)
    monkeypatch.setattr(autotune, "_CACHE", autotune.AutotuneCache(path))
    return path


@pytest.fixture
def empty_table(monkeypatch):
    """No packaged entries: what a card key with an empty table resolves."""
    monkeypatch.setattr(autotune, "_PACKAGED", {})


def _jax_autotune(tmp_path, monkeypatch):
    from repro.kernels import autotune as jat
    monkeypatch.setattr(jat, "_CACHE",
                        jat.AutotuneCache(str(tmp_path / "jax.json")))
    return jat


# ----------------------------------------------------------------------
# The reference's tests, ported
# ----------------------------------------------------------------------
def test_autotune_offline_deterministic(fresh):
    cache = autotune.AutotuneCache()
    a = cache.get("flash", "cpu", f32, (2048, 64))
    b = cache.get("flash", "cpu", f32, (2048, 64))
    assert a == b and a["block_q"] >= 128   # big blocks for the plain path
    assert cache.get("flash", CARD, f32, (1024, 64)) == {
        "block_q": 64, "block_k": 64}        # the kernels' first tile
    assert cache.get("ssd", CARD, f32, (1024, 64, 128)) == {"chunk": 64}
    # tiny shapes never exceed their bucket
    small = cache.get("flash", "cpu", f32, (16, 16))
    assert small["block_q"] <= 16


def test_autotune_ragged_shapes_get_distinct_entries(tmp_path):
    """Ragged lengths keep their own identity under the pow2 roof, and
    head dims are always keyed exactly."""
    assert autotune.shape_bucket(1024) == "1024"
    assert autotune.shape_bucket(1000) == "1024r1000"
    assert autotune.shape_bucket(129) != autotune.shape_bucket(256)
    assert autotune._seq_of("1024r1000") == 1000
    path = str(tmp_path / "a.json")
    c = autotune.AutotuneCache(path)
    c.put("flash", "cpu", f32, (autotune.shape_bucket(1024), 64),
          {"block_q": 512, "block_k": 512})
    # the measured pow2 entry must NOT shadow the ragged length...
    assert c.peek("flash", "cpu", f32,
                  (autotune.shape_bucket(1000), 64)) is None
    # ...which falls back to the offline default instead
    assert c.get("flash", "cpu", f32,
                 (autotune.shape_bucket(1000), 64))["block_q"] >= 128
    # non-pow2 head dims never share an entry with pow2 ones
    c.put("flash", "cpu", f32, ("1024", 80), {"block_q": 64, "block_k": 64})
    assert c.get("flash", "cpu", f32, ("1024", 64)) == {
        "block_q": 512, "block_k": 512}
    assert c.get("flash", "cpu", f32, ("1024", 80)) == {
        "block_q": 64, "block_k": 64}


def test_flash_config_routes_ragged_seq_via_ragged_bucket(fresh, monkeypatch):
    seen = {}
    orig = autotune._CACHE.peek

    def spy(kind, backend, dtype, shape):
        seen["shape"] = shape
        return orig(kind, backend, dtype, shape)

    monkeypatch.setattr(autotune._CACHE, "peek", spy)
    autotune.flash_config("cpu", f32, 1000, 64)
    assert seen["shape"] == ("1024r1000", 64)


def test_offline_heuristic_is_per_backend(empty_table):
    """A card key takes the kernels' own first choices, the cpu key the
    reference's interpreter branch (blocks up to the bucket)."""
    c = autotune.AutotuneCache("/nonexistent/never-loaded.json")
    assert c.get("flash", CARD, f32, (2048, 64)) == {
        "block_q": 64, "block_k": 64}
    assert c.get("flash", "cpu", f32, (2048, 64)) == {
        "block_q": 512, "block_k": 512}
    assert c.get("ssd", CARD, f32, (64, 64, 32)) == {"chunk": 64}
    assert c.get("ssd", "cpu", f32, (64, 64, 32)) == {"chunk": 64}
    assert c.get("ssd", "cpu", f32, (2048, 64, 32)) == {"chunk": 128}
    with pytest.raises(KeyError):
        c.get("nope", CARD, f32, (64, 64))


def test_packaged_offline_table_consulted(monkeypatch):
    """A measured entry in autotune_offline.json wins over the heuristic
    for its exact key (and only that key)."""
    key = autotune._key("flash", CARD, f32, ("2048", 64))
    monkeypatch.setattr(autotune, "_PACKAGED",
                        {key: {"block_q": 128, "block_k": 128}})
    c = autotune.AutotuneCache("/nonexistent/never-loaded.json")
    assert c.get("flash", CARD, f32, ("2048", 64)) == {
        "block_q": 128, "block_k": 128}
    assert c.get("flash", CARD, f32, ("1024", 64)) == {
        "block_q": 64, "block_k": 64}


def test_autotune_persistence_roundtrip(tmp_path):
    path = str(tmp_path / "autotune.json")
    c1 = autotune.AutotuneCache(path)
    c1.put("flash", "cpu", f32, (1024, 64), {"block_q": 256, "block_k": 256})
    c2 = autotune.AutotuneCache(path)         # fresh process simulation
    assert c2.get("flash", "cpu", f32, (1024, 64)) == {
        "block_q": 256, "block_k": 256}
    with open(path) as f:
        table = json.load(f)
    assert any("flash|cpu" in k for k in table)
    c2.put("ssd", CARD, f32, (1024, 64, 128), {"chunk": 32})
    with open(path) as f:                     # merged, not clobbered
        assert set(json.load(f)) == {"flash|cpu|float32|1024x64",
                                     f"ssd|{CARD}|float32|1024x64x128"}


def test_autotune_offline_fallbacks_not_persisted(tmp_path):
    """save() must only write measured entries: a persisted snapshot of
    the offline defaults would shadow future offline-table updates."""
    path = str(tmp_path / "a.json")
    c = autotune.AutotuneCache(path)
    c.get("flash", "cpu", f32, (1024, 64))      # offline fallback
    c.put("ssd", CARD, f32, (1024, 64, 128), {"chunk": 64})
    with open(path) as f:
        table = json.load(f)
    assert list(table) == [f"ssd|{CARD}|float32|1024x64x128"]


def test_autotune_env_triggers_measured_tuning(fresh, monkeypatch):
    """REPRO_AUTOTUNE=1 routes a card key's misses through measured
    tuning; a cpu key has no kernel to time and never tunes."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    called = {}

    def fake_tune(backend, dtype, seq, d, **kw):
        called["args"] = (backend, seq, d)
        return {"block_q": 128, "block_k": 64}

    monkeypatch.setattr(autotune, "tune_flash", fake_tune)
    cfg = autotune.flash_config(CARD, f32, 128, 16)
    assert cfg == {"block_q": 128, "block_k": 64}
    assert called["args"] == (CARD, 128, 16)
    called.clear()
    autotune.flash_config("cpu", f32, 128, 16)
    assert not called
    # without the env var, misses fall back to the offline table
    monkeypatch.delenv("REPRO_AUTOTUNE")
    autotune.flash_config(CARD, f32, 256, 16)
    assert not called
    with pytest.raises(ValueError, match="cpu key"):
        autotune.tune_ssd("cpu", f32, 64, 16, 16)


def test_autotune_config_feeds_ops(fresh, monkeypatch):
    """ops.flash_attention and ops.ssd with default blocks consult the
    autotuner (on the CPU: flash's blocks resolved and unused, the SSD
    chunk the plain version's)."""
    seen = {}
    orig_f, orig_s = autotune.flash_config, autotune.ssd_config

    def spy_f(backend, dtype, seq, d):
        seen["flash"] = (backend, seq, d)
        return orig_f(backend, dtype, seq, d)

    def spy_s(backend, dtype, seq, p, n):
        seen["ssd"] = (backend, seq, p, n)
        return {"chunk": 16}

    monkeypatch.setattr(autotune, "flash_config", spy_f)
    monkeypatch.setattr(autotune, "ssd_config", spy_s)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 32, 2, 8, generator=g) for _ in range(3))
    ops.flash_attention(q, k, v)
    assert seen["flash"] == ("cpu", 32, 8)
    x = torch.randn(1, 40, 2, 8, generator=g)
    dt = torch.rand(1, 40, 2, generator=g)
    A = -torch.rand(2, generator=g)
    B = torch.randn(1, 40, 2, 16, generator=g)
    chunks = []
    orig_ref = ref.ssd_fwd_ref
    monkeypatch.setattr(ref, "ssd_fwd_ref", lambda *a, chunk: (
        chunks.append(chunk), orig_ref(*a, chunk=chunk))[1])
    ops.ssd(x, dt, A, B, B)
    assert seen["ssd"] == ("cpu", 40, 8, 16) and chunks == [16]


# ----------------------------------------------------------------------
# Parity with the JAX package
# ----------------------------------------------------------------------
LENGTHS = [1, 7, 16, 17, 33, 64, 100, 128, 129, 200, 256, 300, 512, 1000,
           1024, 1025, 2000, 2048, 4096, 4099, 8192]


def test_buckets_and_keys_match_the_jax_package():
    import jax.numpy as jnp
    from repro.kernels import autotune as jat
    for n in LENGTHS:
        b = autotune.shape_bucket(n)
        assert b == jat.shape_bucket(n), n
        assert autotune._bucket(n) == jat._bucket(n)
        assert autotune._seq_of(b) == jat._seq_of(b) == n
        for kind, shape in (("flash", (b, 64)), ("ssd", (b, 64, 128))):
            for tdt, jdt in ((torch.float32, jnp.float32),
                             (torch.bfloat16, jnp.bfloat16)):
                assert (autotune._key(kind, "cpu", tdt, shape)
                        == jat._key(kind, "cpu", jdt, shape))


def test_cpu_configs_match_the_jax_package(tmp_path, monkeypatch, fresh):
    """flash_config and ssd_config on "cpu" keys equal the reference's,
    its packaged cpu entries included (which the port's table carries)."""
    import jax.numpy as jnp
    jat = _jax_autotune(tmp_path, monkeypatch)
    with open(os.path.join(os.path.dirname(jat.__file__),
                           "autotune_offline.json")) as f:
        theirs = json.load(f)
    ours = autotune._packaged()
    assert {k: v for k, v in ours.items() if "|cpu|" in k} == theirs
    for n in LENGTHS + [2048, 1024]:
        for d in (16, 64, 80):
            assert (autotune.flash_config("cpu", f32, n, d)
                    == jat.flash_config("cpu", jnp.float32, n, d)), (n, d)
        for p, s in ((64, 32), (32, 32), (16, 8)):
            assert (autotune.ssd_config("cpu", f32, n, p, s)
                    == jat.ssd_config("cpu", jnp.float32, n, p, s)), (n, p)


@pytest.mark.parametrize("S,P,N", [(40, 8, 16), (100, 16, 8), (300, 16, 16)])
def test_ops_ssd_default_chunk_matches_the_jax_package(tmp_path, monkeypatch,
                                                       fresh, S, P, N):
    """kops.ssd at its default chunk (the same on both sides: 64, 128,
    128) against the reference's kops.ssd (its Pallas kernels
    interpreted): y, the state and every gradient within 1e-6 + 1e-5 of
    the value + 1e-5 of the cond (tests/test_torch_ssd.py's tolerance)."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    jat = _jax_autotune(tmp_path, monkeypatch)
    rng = np.random.default_rng(S)
    b, H = 1, 2
    x, gy = (rng.standard_normal((b, S, H, P)).astype(np.float32)
             for _ in range(2))
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    B, C = (rng.standard_normal((b, S, H, N)).astype(np.float32)
            for _ in range(2))
    gs = rng.standard_normal((b, H, P, N)).astype(np.float32)
    chunk = autotune.ssd_config("cpu", f32, S, P, N)["chunk"]
    assert chunk == jat.ssd_config("cpu", jnp.float32, S, P, N)["chunk"]

    def jfn(x, dt, A, B, C):
        return jops.ssd(x, dt, A, B, C)
    (jy, jst), vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (x, dt, A, B, C)))
    jgrads = vjp((jnp.asarray(gy), jnp.asarray(gs)))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, dt, A, B, C)]
    y, st = ops.ssd(*leaves)
    grads = torch.autograd.grad((y, st), leaves, (torch.from_numpy(gy),
                                                  torch.from_numpy(gs)))
    tx, tdt, tA, tB, tC = (torch.from_numpy(a) for a in (x, dt, A, B, C))
    fwd = ref.ssd_fwd_ref(tx.abs(), tdt, tA, tB.abs(), tC.abs(), chunk=chunk)
    bwd = ref.ssd_bwd_ref(tx.abs(), tdt, tA, tB.abs(), tC.abs(), fwd[2],
                          torch.from_numpy(np.abs(gy)),
                          torch.from_numpy(np.abs(gs)), chunk=chunk,
                          magnitudes=True)
    conds = (fwd[0], fwd[1], *bwd)
    for name, got, want, cond in zip(
            ("y", "state", "dx", "ddt", "dA", "dB", "dC"),
            (y, st, *grads), (jy, jst, *jgrads), conds):
        diff = np.abs(got.detach().numpy() - np.asarray(want))
        limit = (1e-6 + 1e-5 * np.abs(np.asarray(want))
                 + 1e-5 * cond.numpy())
        assert (diff <= limit).all(), (name, float(diff.max()))


# ----------------------------------------------------------------------
# A card key with an empty table: the parent's choices, bit for bit
# ----------------------------------------------------------------------
def _parent_gemm_choice(M, N, K, itemsize):
    """The GEMM's (tile, split) as the kernels chose it before the
    autotuner: the planning model's minimum over the built tiles and 1-4
    nonempty splits, ties to the larger tile and the fewer splits.  In
    bf16 the tiles are those of the instance an aligned call runs: the
    wgmma one's 128 x 256 over 64-wide K slices."""
    wgmma = itemsize == 2
    bk = fused.WGMMA_BK if wgmma else fused.GEMM_BK
    tiles = [fused.WGMMA_TILE] if wgmma else fused.MMA_TILES
    best = None
    for bm, bn in tiles:
        for splits in range(1, 5):
            kchunk = fused.gemm_kchunk(K, splits, bk)
            if kchunk * (splits - 1) >= K:
                break
            key = (fused._gemm_seconds(M, N, K, bm, bn, splits, bk), -bm * bn,
                   splits)
            if best is None or key < best[0]:
                best = (key, (bm, bn, splits))
    return best[1]


def _parent_norm_rows(M, d):
    """The norm backward's rows per block before the autotuner."""
    G = -(-d // (32 * 8))
    if G > 16:
        G = min(-(-d // (64 * 8)), 16)
    R = max(1, 4 // G)
    per_sm = -(-16 // (R * G))
    return R * -(-M // (R * 132 * per_sm))


GEMM_GRID = [(M, N, K) for M in (1, 100, 1000, 1024, 2048, 4096, 8192)
             for N, K in ((3072, 1024), (1024, 3072), (2048, 1024),
                          (3000, 999), (64, 64), (6144, 2048))]


@pytest.mark.parametrize("backend", [CARD, "cuda-sm90-114"])
def test_card_heuristic_is_the_parents_choice(fresh, empty_table, backend):
    for M, N, K in GEMM_GRID:
        for itemsize, dt in ((4, "float32"), (2, "bfloat16")):
            want = _parent_gemm_choice(M, N, K, itemsize)
            for layout, (sa, sb) in (("kn", ((K, 1), (N, 1))),
                                     ("kk", ((K, 1), (1, K))),
                                     ("mn", ((1, M), (N, 1)))):
                cfg = autotune.gemm_config_of(backend, dt, M, N, K, layout)
                assert (cfg["block_rows"], cfg["block_cols"],
                        cfg["splits"]) == want, (M, N, K, layout)
                ours = fused.gemm_config(M, N, K, sa, sb, 0, 0, itemsize,
                                         backend)
                if ours.vec:
                    assert (ours.bm, ours.bn, ours.splits) == want
                assert ours == fused.gemm_config(M, N, K, sa, sb, 0, 0,
                                                 itemsize)
    for M in (1, 3, 7, 100, 1000, 1024, 2048, 4096, 4099, 16384):
        for d in (16, 64, 999, 1024, 2048, 5120, 10000):
            assert autotune.norm_config(backend, "float32", M, d) == {
                "rows_per_block": _parent_norm_rows(M, d)}, (M, d)
            for size in (4, 2):
                cfg = fused.norm_bwd_config(M, d, size, (0,) * 5, backend)
                assert cfg == fused.norm_bwd_config(M, d, size, (0,) * 5)
                assert cfg.rows_per_block == _parent_norm_rows(M, d)
    for n in LENGTHS:
        for D in flash.HEAD_DIMS:
            for dt in (torch.float32, torch.bfloat16):
                assert autotune.flash_config(backend, dt, n, D) == {
                    "block_q": 64, "block_k": 64}
        for P, N in ssd.SHAPES:
            assert autotune.ssd_config(backend, f32, n, P, N) == {
                "chunk": ssd.CHUNK} == {"chunk": 64}


def test_resolved_configs_are_legal_and_illegal_ones_raise(fresh):
    """Every packaged card entry names a built tile; a GEMM choice that is
    not a legal candidate, or a norm partition not in whole rounds,
    raises (no fallback)."""
    for key, cfg in autotune._packaged().items():
        kind, backend, dt, shape = key.split("|")
        if backend == "cpu":
            continue
        dims = shape.split("x")
        dtype = getattr(torch, dt)
        if kind == "flash":
            D = int(dims[1])
            assert flash.built("fwd", D, dtype, cfg["block_q"])
            assert flash.built("dq", D, dtype, cfg["block_q"])
            assert flash.built("dkdv", D, dtype, cfg["block_k"])
        elif kind == "ssd":
            assert cfg["chunk"] in ssd.CHUNKS
        elif kind == "gemm":
            K = int(dims[2])
            assert (cfg["block_rows"], cfg["block_cols"], cfg["splits"]) in (
                fused.gemm_candidates(K, dtype.itemsize))
        elif kind == "norm":
            M, d = autotune._seq_of(dims[0]), int(dims[1])
            assert cfg["rows_per_block"] in fused.norm_rows_candidates(M, d)
    with pytest.raises(ValueError, match="not built"):   # bf16: the wgmma
        fused.gemm_config(4096, 3072, 1024, (1024, 1), (3072, 1), 0, 0, 2,
                          choice=(64, 64, 1))
    with pytest.raises(ValueError, match="not built"):   # ... or fused.cu's
        fused.gemm_config(4096, 3072, 999, (999, 1), (3072, 1), 0, 0, 2,
                          choice=(128, 256, 1))
    with pytest.raises(ValueError, match="not built"):
        fused.gemm_config(64, 64, 32, (32, 1), (64, 1), 0, 0, 4,
                          choice=(64, 64, 2))
    with pytest.raises(ValueError, match="not built"):  # element copies
        fused.gemm_config(100, 100, 999, (999, 1), (100, 1), 0, 0, 4,
                          choice=(128, 128, 1))
    with pytest.raises(ValueError, match="whole rounds|multiple"):
        fused.norm_bwd_config(100, 64, 4, (0,) * 5, rows_per_block=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_path_key_resolves_to_a_packaged_h100_entry(fresh, dtype):
    """What phase 16 of chip_smoke.py asserts on the card: with tuning
    off, each path key of the H100 (fp32: phases 7-8, 10, 12; bf16:
    phase 20) resolves to its measured packaged entry."""
    table = autotune._packaged()
    resolved = autotune.resolve_paths(CARD, dtype)
    assert resolved and all(table[k] == v for k, v in resolved.items())


def test_candidates_cover_the_parents_choice():
    for M, N, K in GEMM_GRID:
        for size in (4, 2):
            assert _parent_gemm_choice(M, N, K, size) in (
                fused.gemm_candidates(K, size))
    for M, d in ((4096, 1024), (2048, 1024), (1000, 999), (7, 64)):
        cands = fused.norm_rows_candidates(M, d)
        assert _parent_norm_rows(M, d) in cands
        R = fused.norm_bwd_rows(M, d)[1]
        assert all(n % R == 0 and n > 0 for n in cands)


# ----------------------------------------------------------------------
# Every process of a job resolves alike
# ----------------------------------------------------------------------
def resolve_in_rank(backend):
    """A rank of ``spawn_world``: what it was handed and what it resolves."""
    return {"tune": os.environ.get("REPRO_AUTOTUNE"),
            "cache": os.environ.get("REPRO_AUTOTUNE_CACHE"),
            "configs": autotune.resolve_paths(backend)}


def test_spawned_processes_resolve_identical_configurations(fresh,
                                                            monkeypatch):
    """Two fresh interpreters started by the mesh spawner get no
    REPRO_AUTOTUNE and this process's table: they resolve exactly what
    this process does, a persisted entry included (with tuning on, a
    miss on the card key would try to time kernels and fail here)."""
    from repro_torch.launch.mesh import spawn_world
    autotune._CACHE.put("gemm", CARD, "float32", ("4096", 3072, 1024, "kn"),
                        {"block_rows": 64, "block_cols": 64, "splits": 3})
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    ranks = spawn_world(f"{__name__}:resolve_in_rank", 2,
                        {"backend": CARD}, device="cpu", timeout=300,
                        paths=[os.path.dirname(__file__)])
    monkeypatch.delenv("REPRO_AUTOTUNE")
    here = autotune.resolve_paths(CARD)
    assert here[f"gemm|{CARD}|float32|4096x3072x1024xkn"] == {
        "block_rows": 64, "block_cols": 64, "splits": 3}
    for r in ranks:
        assert r["tune"] is None and r["cache"] == fresh
        assert r["configs"] == here


def test_multihost_workers_get_the_autotune_environment(fresh, monkeypatch):
    from repro_torch.runtime import multihost
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    seen = []

    class FakePopen:
        def __init__(self, cmd, env):
            seen.append(env)

    class Server:
        addr = ("localhost", 1)

    class Coordinator:
        server = Server()
        procs = {}

    monkeypatch.setattr(multihost.subprocess, "Popen", FakePopen)
    multihost.MultiHostExecutor._spawn_workers(Coordinator(), [0, 1],
                                               sys.executable)
    assert len(seen) == 2
    for env in seen:
        assert "REPRO_AUTOTUNE" not in env
        assert env["REPRO_AUTOTUNE_CACHE"] == fresh
    assert autotune.child_env({"REPRO_AUTOTUNE": "1", "X": "y"}) == {
        "X": "y", "REPRO_AUTOTUNE_CACHE": fresh}


def test_a_candidate_displaces_the_heuristic_only_beyond_the_margin():
    """A measured win inside TIE_MARGIN keeps the heuristic's choice (so a
    regenerated table does not flip on noise); a larger one takes it."""
    d, b = (("chunk", 64),), (("chunk", 32),)
    m = autotune.TIE_MARGIN
    assert autotune._winner({d: 1.0, b: 1.0 - m / 2}, d) == d
    assert autotune._winner({d: 1.0, b: 1.0 - 2 * m}, d) == b
    assert autotune._winner({b: 0.5, (("chunk", 16),): 0.4}, d) == (
        ("chunk", 16),)


def test_a_tuned_entry_keeps_the_heuristic_inside_the_margin(fresh):
    """_pick matches the heuristic's configuration whatever the order of
    a candidate's items (the GEMM's rows, cols, splits), and stores it."""
    shape = ("1024", 3072, 2048, "mn")
    want = autotune._heuristic("gemm", CARD, "float32", shape)
    assert want == {"block_rows": 128, "block_cols": 128, "splits": 2}
    times = {(("block_rows", 128), ("block_cols", 128), ("splits", 2)): 1.0,
             (("block_rows", 64), ("block_cols", 64), ("splits", 1)): 0.99}
    cache = autotune.AutotuneCache(os.devnull)
    assert autotune._pick("gemm", CARD, "float32", shape, times, cache,
                          False) == want
    assert cache.peek("gemm", CARD, "float32", shape) == want


def test_packaged_bf16_flash_tiles_name_wgmma_instances(fresh):
    """Phase 20's bf16 flash keys, retuned with the wgmma backward: the
    forward and dq share block_q 128 (each one's fastest q tile, so dq
    keeps no key of its own); dk/dv takes the 64-row kv tile at 2048 x
    128, where qwen2.5-3b's group of 8 query heads fills the card only
    with the smaller tile, and the 128-row one at head dim 64.  Every
    resolved tile is a wgmma instance."""
    want = {"2048x128": (128, 64), "2048x64": (128, 128),
            "4096r2304x64": (128, 128)}
    for bucket, (bq, bk) in want.items():
        cfg = autotune._packaged()[f"flash|{CARD}|bfloat16|{bucket}"]
        assert (cfg["block_q"], cfg["block_k"]) == (bq, bk), bucket
        D = int(bucket.split("x")[-1])
        for kernel, tile in (("fwd", bq), ("dq", bq), ("dkdv", bk)):
            assert (kernel, D, torch.bfloat16, tile) in flash.WGMMA_INSTANCES
