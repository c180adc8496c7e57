"""Block-size autotuner for the port's CUDA kernels.

Every kernel launch needs a tile: flash its q tile (forward, dq) and kv
tile (dk/dv), the SSD scan its chunk length, the GEMM its tile and split
over K, the norm backward its rows per block.  Which one is fastest
depends on the card, the dtype and the shape, so each is resolved
through a cache keyed by

    (kernel kind, backend, dtype, shape bucket)

as the JAX package's ``kernels/autotune.py`` keys its Pallas blocks.
The backend is ``"cpu"`` for a CPU tensor and, for a card, its compute
capability and SM count (``"cuda-sm90-132"``: the H100 SXM; the PCIe
card has 114 SMs and keys apart).  Sequence lengths bucket to powers of
two, EXCEPT ragged (non-pow2) lengths, which keep their own identity
under the pow2 roof (``"<roof>r<n>"``), so every bucket names one
length; head, state and model dims are keyed exactly.  Resolution
order:

  1. the in-memory cache (per process),
  2. the persisted JSON table (``REPRO_AUTOTUNE_CACHE``, default
     ``~/.cache/repro_torch/autotune.json``),
  3. the PACKAGED table (``autotune_offline.json`` next to this module:
     entries measured on a card by ``python -m
     repro_torch.kernels.autotune``, and the JAX package's ``cpu``
     entries),
  4. the deterministic heuristic below: for a card what the kernels ran
     before the autotuner (flash 64 x 64, SSD chunk 64, the GEMM's
     planning model ``fused.gemm_plan``, the norm's ``fused.norm_bwd_rows``);
     for ``"cpu"`` the JAX package's interpreter branch.

Measured tuning (``tune_flash``, ``tune_ssd``, ``tune_gemm``,
``tune_norm``) runs ONLY when called, or on a miss of a card key under
``REPRO_AUTOTUNE=1``: a run without it reads the tables alone, so the
configuration never depends on a clock.  A split over K and the norm's
rows per block change the order of sums, so every process of one job
must resolve alike: the spawners hand their children ``child_env`` (no
tuning, the parent's table).  Each candidate is held against its plain
version before it is timed; one that misses raises.  Flash tiles give
bitwise-equal outputs (``csrc/flash.cuh``).

There is no fallback: a resolved tile that is not built raises in the
wrapper that launches it.
"""
from __future__ import annotations

import functools
import json
import os
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import torch

_ENV_PATH = "REPRO_AUTOTUNE_CACHE"
_ENV_ENABLE = "REPRO_AUTOTUNE"

ShapeEntry = Union[int, str]
Config = Dict[str, int]


def _bucket(n: int, floor: int = 16) -> int:
    """Power-of-two roof for a sequence length."""
    b = floor
    while b < n:
        b *= 2
    return b


def shape_bucket(n: int, floor: int = 16) -> str:
    """Bucket label for a sequence length.  Exact powers of two share
    one entry; RAGGED lengths keep their identity under the pow2 roof
    (``"<roof>r<n>"``) so distinct tilings never share a tuned entry."""
    b = _bucket(n, floor)
    return str(b) if n == b else f"{b}r{n}"


def _seq_of(entry: ShapeEntry) -> int:
    """Actual sequence length from a shape-bucket entry (int or str)."""
    return int(str(entry).rsplit("r", 1)[-1])


def _dtype_name(dtype) -> str:
    """``"float32"`` / ``"bfloat16"`` for a torch dtype or a name."""
    return str(dtype).replace("torch.", "")


def _key(kind: str, backend: str, dtype, shape: Tuple[ShapeEntry, ...]
         ) -> str:
    return "|".join([kind, backend, _dtype_name(dtype),
                     "x".join(str(s) for s in shape)])


@functools.lru_cache(maxsize=None)
def _card_backend(index: int) -> str:
    props = torch.cuda.get_device_properties(index)
    return f"cuda-sm{props.major}{props.minor}-{props.multi_processor_count}"


def backend_of(device) -> str:
    """The backend part of a key: ``"cpu"`` or ``"cuda-sm<cc>-<SMs>"``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"autotune: no kernels for device {dev}")
    return _card_backend(dev.index if dev.index is not None
                         else torch.cuda.current_device())


# ----------------------------------------------------------------------
# Deterministic offline tables (packaged + heuristic)
# ----------------------------------------------------------------------
_PACKAGED_PATH = os.path.join(os.path.dirname(__file__),
                              "autotune_offline.json")
_PACKAGED: Optional[Dict[str, Config]] = None


def _packaged() -> Dict[str, Config]:
    global _PACKAGED
    if _PACKAGED is None:
        try:
            with open(_PACKAGED_PATH) as f:
                _PACKAGED = {k: {a: int(b) for a, b in v.items()}
                             for k, v in json.load(f).items()}
        except (OSError, ValueError):
            _PACKAGED = {}
    return _PACKAGED


def _heuristic(kind: str, backend: str, dtype,
               shape: Tuple[ShapeEntry, ...]) -> Config:
    """The deterministic fallback: for a card key the choices the kernels
    made before the autotuner; for ``"cpu"`` the JAX package's
    interpreter branch (blocks as large as the bucket allows)."""
    from repro_torch.kernels import fused        # lazy: fused imports us
    seq = _seq_of(shape[0])
    card = backend != "cpu"
    if kind == "flash":
        blk = 64 if card else min(512, _bucket(seq))
        return {"block_q": blk, "block_k": blk}
    if kind == "ssd":
        return {"chunk": 64 if card else min(128, _bucket(seq))}
    if kind == "gemm":
        _, N, K, _ = shape
        size = _torch_dtype(dtype).itemsize
        bm, bn, splits = fused.gemm_plan(seq, int(N), int(K), size)
        return {"block_rows": bm, "block_cols": bn, "splits": splits}
    if kind == "norm":
        return {"rows_per_block": fused.norm_bwd_rows(seq, int(shape[1]))[0]}
    raise KeyError(f"unknown kernel kind {kind!r}")


def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(
        torch, _dtype_name(dtype))


def _offline(kind: str, backend: str, dtype,
             shape: Tuple[ShapeEntry, ...]) -> Config:
    """The packaged measured entry for this exact key if one exists, else
    the heuristic: never a clock."""
    pkg = _packaged().get(_key(kind, backend, dtype, shape))
    if pkg is not None:
        return dict(pkg)
    return _heuristic(kind, backend, dtype, shape)


# ----------------------------------------------------------------------
# The cache
# ----------------------------------------------------------------------
class AutotuneCache:
    """(kind, backend, dtype, bucket) -> block config, with a persisted
    JSON table behind the in-memory dict."""

    def __init__(self, path: Optional[str] = None):
        if path is None:
            path = os.environ.get(_ENV_PATH, os.path.join(
                os.path.expanduser("~"), ".cache", "repro_torch",
                "autotune.json"))
        self.path = path
        self._mem: Dict[str, Config] = {}
        self._disk_loaded = False
        # (kind, backend, dtype, call args) -> (config, the packaged table
        # it was resolved against): the wrappers' host time per call
        self._resolved: Dict[Tuple, Tuple[Config, Dict]] = {}

    # -- persistence ---------------------------------------------------
    def _load_disk(self) -> None:
        if self._disk_loaded:
            return
        self._disk_loaded = True
        try:
            with open(self.path) as f:
                table = json.load(f)
            for k, v in table.items():
                self._mem.setdefault(k, {str(a): int(b)
                                         for a, b in v.items()})
        except (OSError, ValueError):
            pass

    def save(self) -> None:
        """Atomically persist the current table (tmp + rename), merged
        over what is already on disk: a fresh process tuning ONE shape
        must not clobber previously persisted entries."""
        self._load_disk()
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = f"{self.path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(self._mem, f, indent=2, sort_keys=True)
        os.replace(tmp, self.path)

    # -- lookup --------------------------------------------------------
    def peek(self, kind: str, backend: str, dtype,
             shape: Tuple[ShapeEntry, ...]) -> Optional[Config]:
        """Tuned entry from memory or disk, or None.  Offline-table
        fallbacks are NOT consulted (and never stored in ``_mem``, so
        ``save()`` persists only measured entries: a stale snapshot of
        the offline defaults would shadow future updates)."""
        key = _key(kind, backend, dtype, shape)
        cfg = self._mem.get(key)
        if cfg is None:
            self._load_disk()
            cfg = self._mem.get(key)
        return cfg

    def get(self, kind: str, backend: str, dtype,
            shape: Tuple[ShapeEntry, ...]) -> Config:
        cfg = self.peek(kind, backend, dtype, shape)
        return cfg if cfg is not None else _offline(kind, backend, dtype,
                                                    shape)

    def put(self, kind: str, backend: str, dtype,
            shape: Tuple[ShapeEntry, ...], cfg: Config,
            persist: bool = True) -> None:
        self._mem[_key(kind, backend, dtype, shape)] = dict(cfg)
        self._resolved.clear()
        if persist:
            try:
                self.save()
            except OSError:
                pass               # read-only FS: stay in-memory


_CACHE = AutotuneCache()


def reset_cache(path: Union[None, str, AutotuneCache] = None
                ) -> AutotuneCache:
    """Make the process's cache a fresh one over ``path`` (default:
    ``REPRO_AUTOTUNE_CACHE`` as it is now), or the given cache; returns
    the one it replaces."""
    global _CACHE
    old = _CACHE
    _CACHE = path if isinstance(path, AutotuneCache) else AutotuneCache(path)
    return old


def tuning_enabled() -> bool:
    return os.environ.get(_ENV_ENABLE, "") == "1"


def child_env(env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The environment of a process spawned into this job: no tuning, and
    this process's persisted table, so every process resolves the same
    configuration (a split over K or another norm partition would change
    the order of sums between them)."""
    env = dict(os.environ if env is None else env)
    env.pop(_ENV_ENABLE, None)
    env[_ENV_PATH] = _CACHE.path
    return env


def _resolve(kind: str, backend: str, dtype, args: Tuple, tune) -> Config:
    """The configuration of one call: ``args`` are its sizes, the first
    bucketed (``shape_bucket``), the rest keyed exactly.  Without tuning
    the answer is remembered per cache (dropped by ``put`` and whenever
    the packaged table is another object), so a wrapper pays a dict
    lookup a call."""
    cache = _CACHE
    tuning = backend != "cpu" and tuning_enabled()
    memo = (kind, backend, dtype, args)
    if not tuning:
        hit = cache._resolved.get(memo)
        if hit is not None and hit[1] is _packaged():
            return hit[0]
    shape = (shape_bucket(args[0]), *args[1:])
    cfg = cache.peek(kind, backend, dtype, shape)
    if cfg is None and tuning:
        cfg = tune()
    if cfg is None:
        cfg = _offline(kind, backend, dtype, shape)
    if not tuning:
        cache._resolved[memo] = (cfg, _packaged())
    return cfg


def flash_config(backend: str, dtype, seq_len: int, head_dim: int) -> Config:
    """``{"block_q", "block_k"}``: the q tile of the forward and dq (their
    kv tiles are 64 rows) and the kv tile of dk/dv (its q tiles are 64)."""
    return _resolve("flash", backend, dtype, (seq_len, head_dim),
                    lambda: tune_flash(backend, dtype, seq_len, head_dim))


def ssd_config(backend: str, dtype, seq_len: int, head_dim: int,
               state: int) -> Config:
    """``{"chunk"}`` of the SSD scan."""
    return _resolve("ssd", backend, dtype, (seq_len, head_dim, state),
                    lambda: tune_ssd(backend, dtype, seq_len, head_dim, state))


def gemm_layout(a_kmajor: bool, b_kmajor: bool) -> str:
    """The operand layout part of a GEMM key: A K- or M-major, B K- or
    N-major (the fused QKV's forward ``kn``, dx ``kk``, dW ``mn``)."""
    return ("k" if a_kmajor else "m") + ("k" if b_kmajor else "n")


def gemm_config_of(backend: str, dtype, M: int, N: int, K: int,
                   layout: str) -> Config:
    """``{"block_rows", "block_cols", "splits"}`` of C[M, N] = A[M, K].B[K,
    N] with 16-byte copies in ``layout`` (``gemm_layout``), keyed by (M
    bucket, N, K, layout)."""
    return _resolve("gemm", backend, dtype, (M, N, K, layout),
                    lambda: tune_gemm(backend, dtype, M, N, K, layout))


def norm_config(backend: str, dtype, rows: int, d: int) -> Config:
    """``{"rows_per_block"}`` of the backward norm over [rows, d]."""
    return _resolve("norm", backend, dtype, (rows, d),
                    lambda: tune_norm(backend, dtype, rows, d))


# ----------------------------------------------------------------------
# Measured tuning (explicit or REPRO_AUTOTUNE=1 on a card key)
# ----------------------------------------------------------------------
#: normwise tolerance of a candidate against its plain version:
#: max |kernel - plain| <= tol * max |plain| over each output (3xTF32
#: holds fp32 near 1e-6 of it; a product that drops the small terms
#: misses 1e-4)
CHECK_TOL = {"float32": 1e-4, "bfloat16": 2e-2}

#: a candidate displaces the heuristic's choice only when it is faster by
#: more than this fraction: between tunings on the H100 the time ratio of
#: two candidates of one key moved by up to 4 % (the flash q tiles
#: 0.988-1.010, the `mn` GEMM's 64 x 64 against 128 x 128 split in two
#: 0.986-1.027), so a smaller win would flip the table between
#: regenerations (PERF.md, section 6)
TIE_MARGIN = 0.03

#: the last tuning's candidate times (ms) per key, for reports
LAST_TIMES: Dict[str, Dict[str, float]] = {}


def _device(backend: str) -> torch.device:
    if backend == "cpu":
        raise ValueError("autotune: tuning times the CUDA kernels; a cpu "
                         "key has no kernel to time")
    dev = torch.device("cuda", torch.cuda.current_device())
    if backend_of(dev) != backend:
        raise ValueError(f"autotune: this card is {backend_of(dev)}, not "
                         f"{backend}")
    return dev


#: GPU cycles (~5 ms on an H100) the card sleeps ahead of each timed
#: window, so the host has queued all ``reps`` calls before the first
#: runs: the events then time the card, not the wrappers' host time (a
#: norm backward at 2048 x 1024 takes less device time than its
#: wrapper's host time, and without the head start its candidates'
#: times were host noise: PERF.md, section 6)
_HEAD_START_CYCLES = 10_000_000


def _time(fn, iters: int = 5, reps: int = 10) -> float:
    """Milliseconds of ``fn()`` on the card: min over ``iters`` repeats of
    the mean of ``reps`` calls between CUDA events, queued behind a sleep
    kernel, after a warm-up call (scheduler hiccups only ever add time,
    so the minimum is the cleanest)."""
    fn()
    best = float("inf")
    for _ in range(iters):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_HEAD_START_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def _hold(what: str, got: Sequence[torch.Tensor],
          want: Sequence[torch.Tensor], dtype) -> None:
    """Raise unless every output is within CHECK_TOL of its plain one."""
    tol = CHECK_TOL[_dtype_name(dtype)]
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.float(), b.float()
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise RuntimeError(f"autotune: {what} output {i} is "
                               f"{tuple(a.shape)} or not finite")
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        if err > tol * scale:
            raise RuntimeError(f"autotune: {what} output {i} misses its "
                               f"plain version: max |diff| {err:.3e} > "
                               f"{tol} x {scale:.3e}")


def _winner(times: Dict, default):
    """The fastest candidate, unless ``default`` (the heuristic's) is
    within ``TIE_MARGIN`` of it."""
    best = min(times, key=lambda c: times[c])
    if default in times and times[default] * (1 - TIE_MARGIN) <= times[best]:
        return default
    return best


def _pick(kind: str, backend: str, dtype, shape, times: Dict, cache,
          persist: bool) -> Config:
    """The winner of ``times`` (candidate: config items -> ms) against
    the heuristic's choice, stored."""
    times = {tuple(sorted(c)): t for c, t in times.items()}
    default = tuple(sorted(_heuristic(kind, backend, dtype, shape).items()))
    cfg = dict(_winner(times, default))
    key = _key(kind, backend, dtype, shape)
    LAST_TIMES[key] = {"x".join(str(v) for _, v in c): t
                       for c, t in times.items()}
    (cache or _CACHE).put(kind, backend, dtype, shape, cfg, persist=persist)
    return cfg


def _randn(gen, shape, dtype, device, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(device=device,
                                                         dtype=dtype)


def tune_flash(backend: str, dtype, seq_len: int, head_dim: int, *,
               shapes: Iterable[Tuple[int, int, int]] = ((1, 2, 2),),
               persist: bool = True, cache: Optional[AutotuneCache] = None
               ) -> Config:
    """Time the built q tiles of the forward + dq (each timed apart) and
    the built kv tiles of dk/dv, each summed over ``shapes`` ((batch,
    heads, kv heads) that share this key); store the winner of each
    (``_winner``)."""
    from repro_torch.kernels import flash, ref
    dev, dt = _device(backend), _torch_dtype(dtype)
    gen = torch.Generator().manual_seed(0)
    qtiles = flash.tiles("fwd", head_dim, dt)
    qtiles = [t for t in qtiles if t in flash.tiles("dq", head_dim, dt)]
    ktiles = flash.tiles("dkdv", head_dim, dt)
    times, per_shape = {}, {}
    for B, H, KV in shapes:
        q, g = (_randn(gen, (B, seq_len, H, head_dim), dt, dev)
                for _ in range(2))
        k, v = (_randn(gen, (B, seq_len, KV, head_dim), dt, dev)
                for _ in range(2))
        out, lse = ref.flash_fwd_ref(q, k, v)
        delta = ref.flash_delta(out, g)
        want = ref.flash_bwd_ref(q, k, v, None, lse, g, delta=delta)
        for bq in qtiles:
            _hold(f"flash_fwd q tile {bq}", flash.flash_fwd(q, k, v, 0, bq),
                  (out, lse), dt)
            _hold(f"flash_bwd_dq q tile {bq}",
                  [flash.flash_bwd_dq(q, k, v, g, lse, delta, 0, bq)],
                  want[:1], dt)
            # the forward and dq apart, so that a q tile that suits one
            # and not the other shows (they share block_q)
            fwd = _time(lambda: flash.flash_fwd(q, k, v, 0, bq))
            dq = _time(lambda: flash.flash_bwd_dq(q, k, v, g, lse, delta, 0,
                                                  bq))
            times[("q", bq)] = times.get(("q", bq), 0.0) + fwd + dq
            per_shape[f"fwd{bq}@{B}x{H}x{KV}"] = fwd
            per_shape[f"dq{bq}@{B}x{H}x{KV}"] = dq
        for bk in ktiles:
            _hold(f"flash_bwd_dkdv kv tile {bk}",
                  flash.flash_bwd_dkdv(q, k, v, g, lse, delta, 0, bk),
                  want[1:], dt)
            ms = _time(lambda: flash.flash_bwd_dkdv(q, k, v, g, lse, delta,
                                                    0, bk))
            times[("k", bk)] = times.get(("k", bk), 0.0) + ms
            per_shape[f"k{bk}@{B}x{H}x{KV}"] = ms
    shape = (shape_bucket(seq_len), head_dim)
    default = _heuristic("flash", backend, dtype, shape)
    cfg = {"block_q": _winner({t: times[("q", t)] for t in qtiles},
                              default["block_q"]),
           "block_k": _winner({t: times[("k", t)] for t in ktiles},
                              default["block_k"])}
    key = _key("flash", backend, dtype, shape)
    LAST_TIMES[key] = {**{f"{side}{t}": ms for (side, t), ms in times.items()},
                       **per_shape}
    (cache or _CACHE).put("flash", backend, dtype, shape, cfg,
                          persist=persist)
    return cfg


def tune_ssd(backend: str, dtype, seq_len: int, head_dim: int, state: int,
             *, batch: int = 1, heads: int = 2, persist: bool = True,
             cache: Optional[AutotuneCache] = None) -> Config:
    """Time forward + backward at each built chunk (B and C one group
    over the heads, as the Mamba2 block hands them over); store the
    fastest."""
    from repro_torch.kernels import ref, ssd
    dev, dt = _device(backend), _torch_dtype(dtype)
    gen = torch.Generator().manual_seed(0)
    b, S, H, P, N = batch, seq_len, heads, head_dim, state
    x, gy = (_randn(gen, (b, S, H, P), dt, dev) for _ in range(2))
    dtv = torch.nn.functional.softplus(
        torch.randn((b, S, H), generator=gen) - 3.0).to(dev)
    A = -torch.exp(torch.randn((H,), generator=gen) * 0.5).to(dev)
    B, C = (_randn(gen, (b, S, 1, N), dt, dev).expand(b, S, H, N)
            for _ in range(2))
    gstate = torch.randn((b, H, P, N), generator=gen).to(dev)
    times = {}
    for chunk in ssd.CHUNKS:
        y, st, cst = ref.ssd_fwd_ref(x, dtv, A, B, C, chunk=chunk)
        got = ssd.ssd_fwd(x, dtv, A, B, C, chunk=chunk)
        _hold(f"ssd_fwd chunk {chunk}", got, (y, st, cst), dt)
        _hold(f"ssd_bwd chunk {chunk}",
              ssd.ssd_bwd(x, dtv, A, B, C, got[2], gy, gstate, chunk=chunk),
              ref.ssd_bwd_ref(x, dtv, A, B, C, cst, gy, gstate, chunk=chunk),
              dt)

        def run(chunk=chunk):
            cst = ssd.ssd_fwd(x, dtv, A, B, C, chunk=chunk)[2]
            return ssd.ssd_bwd(x, dtv, A, B, C, cst, gy, gstate, chunk=chunk)
        times[(("chunk", chunk),)] = _time(run)
    return _pick("ssd", backend, dtype, (shape_bucket(S), P, N), times,
                 cache, persist)


def gemm_operands(M: int, N: int, K: int, layout: str, dtype, device,
                  gen) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contiguous storage viewed as A [M, K] and B [K, N] in ``layout``."""
    a = (_randn(gen, (M, K), dtype, device) if layout[0] == "k"
         else _randn(gen, (K, M), dtype, device).t())
    b = (_randn(gen, (N, K), dtype, device, K ** -0.5).t()
         if layout[1] == "k"
         else _randn(gen, (K, N), dtype, device, K ** -0.5))
    return a, b


def tune_gemm(backend: str, dtype, M: int, N: int, K: int, layout: str, *,
              persist: bool = True, cache: Optional[AutotuneCache] = None
              ) -> Config:
    """Time every legal (tile, split) of C[M, N] = A.B in ``layout`` with
    16-byte copies (bf16: the wgmma instance's, which such calls run);
    store the fastest."""
    from repro_torch.kernels import fused, ref
    dev, dt = _device(backend), _torch_dtype(dtype)
    a, b = gemm_operands(M, N, K, layout, dt, dev,
                         torch.Generator().manual_seed(0))
    want = ref.matmul_bias_ref(a, b)
    times = {}
    for bm, bn, splits in fused.gemm_candidates(K, a.element_size()):
        choice = (bm, bn, splits)
        _hold(f"gemm_bias {bm}x{bn} split {splits}",
              [fused.gemm_bias(a, b, None, choice=choice)], [want], dt)
        times[(("block_rows", bm), ("block_cols", bn), ("splits", splits))] = (
            _time(lambda: fused.gemm_bias(a, b, None, choice=choice)))
    return _pick("gemm", backend, dtype, (shape_bucket(M), N, K, layout),
                 times, cache, persist)


def tune_norm(backend: str, dtype, rows: int, d: int, *,
              persist: bool = True, cache: Optional[AutotuneCache] = None
              ) -> Config:
    """Time the backward norm at each candidate row partition
    (``fused.norm_rows_candidates``); store the fastest."""
    from repro_torch.kernels import fused, ref
    dev, dt = _device(backend), _torch_dtype(dtype)
    gen = torch.Generator().manual_seed(0)
    res, gres, gh = (_randn(gen, (rows, d), dt, dev) for _ in range(3))
    w = _randn(gen, (d,), dt, dev, 0.2) + 1.0
    want = ref.add_rmsnorm_bwd_ref(res, w, gres, gh, eps=1e-6)
    times = {}
    for n in fused.norm_rows_candidates(rows, d):
        _hold(f"add_rmsnorm_bwd rows {n}",
              fused.add_rmsnorm_bwd(res, w, gres, gh, 1e-6, rows_per_block=n),
              want, dt)
        times[(("rows_per_block", n),)] = _time(
            lambda: fused.add_rmsnorm_bwd(res, w, gres, gh, 1e-6,
                                          rows_per_block=n))
    return _pick("norm", backend, dtype, (shape_bucket(rows), d), times,
                 cache, persist)


# ----------------------------------------------------------------------
# Packaged-table regeneration: python -m repro_torch.kernels.autotune
# ----------------------------------------------------------------------
#: the shapes the training paths of chip_smoke.py give each kernel, per
#: dtype.  fp32: flash (S, D, [(batch, heads, kv heads), ...] sharing the
#: key) for gpt3-medium at microbatch 2 and 1 and granite-moe at 1; SSD
#: (S, P, N, batch, heads) for mamba2-780m; the fused QKV's three
#: products (M, N, K, layout) of gpt3-medium at 4096 and 2048 tokens and
#: granite-moe at 2048; the norm (rows, d).  bf16: phase 20's one
#: program over 4 sequences, 8192 tokens (musicgen-large's 9216 with its
#: 256 frame embeddings): flash for qwen3-1.7b and qwen2.5-3b (16 / 8 and
#: 16 / 2 heads of 128), hymba-1.5b (25 / 5 of 64) and musicgen-large (32
#: of 64 at 2304 positions); hymba's SSD (50 heads at state 16); the
#: fused QKV of qwen3 (4096 columns at d 2048), qwen2.5 (2560), hymba
#: (2240 at d 1600) and musicgen (6144); the norms at d 2048 and 1600
PATH_SHAPES = {
    "float32": {
        "flash": [(2048, 64, [(2, 16, 16), (1, 16, 16), (1, 16, 8)])],
        "ssd": [(2048, 64, 128, 1, 48)],
        "gemm": [(4096, 3072, 1024, "kn"), (4096, 1024, 3072, "kk"),
                 (1024, 3072, 4096, "mn"),
                 (2048, 3072, 1024, "kn"), (2048, 1024, 3072, "kk"),
                 (1024, 3072, 2048, "mn"),
                 (2048, 2048, 1024, "kn"), (2048, 1024, 2048, "kk"),
                 (1024, 2048, 2048, "mn")],
        "norm": [(4096, 1024), (2048, 1024)],
    },
    "bfloat16": {
        "flash": [(2048, 128, [(4, 16, 8), (4, 16, 2)]),
                  (2048, 64, [(4, 25, 5)]), (2304, 64, [(4, 32, 32)])],
        "ssd": [(2048, 64, 16, 4, 50)],
        "gemm": [prod for rows, d, cols in ((8192, 2048, 4096),
                                            (8192, 2048, 2560),
                                            (8192, 1600, 2240),
                                            (9216, 2048, 6144))
                 for prod in ((rows, cols, d, "kn"), (rows, d, cols, "kk"),
                              (d, cols, rows, "mn"))],
        "norm": [(8192, 2048), (8192, 1600), (9216, 2048)],
    },
}


def resolve_paths(backend: str, dtype="float32") -> Dict[str, Config]:
    """key -> resolved configuration of every ``PATH_SHAPES`` key of
    ``dtype`` (what the training paths run), through the *_config
    functions."""
    out, shapes = {}, PATH_SHAPES[_dtype_name(dtype)]
    for seq, d, _ in shapes["flash"]:
        out[_key("flash", backend, dtype, (shape_bucket(seq), d))] = (
            flash_config(backend, dtype, seq, d))
    for S, P, N, _, _ in shapes["ssd"]:
        out[_key("ssd", backend, dtype, (shape_bucket(S), P, N))] = (
            ssd_config(backend, dtype, S, P, N))
    for M, N, K, layout in shapes["gemm"]:
        out[_key("gemm", backend, dtype, (shape_bucket(M), N, K, layout))] = (
            gemm_config_of(backend, dtype, M, N, K, layout))
    for rows, d in shapes["norm"]:
        out[_key("norm", backend, dtype, (shape_bucket(rows), d))] = (
            norm_config(backend, dtype, rows, d))
    return out


def tune_paths(backend: str, dtype="float32", *,
               cache: Optional[AutotuneCache] = None,
               persist: bool = False,
               kinds: Optional[Sequence[str]] = None) -> Dict[str, Config]:
    """Tune every ``PATH_SHAPES`` key of ``dtype`` (of ``kinds``, default
    all) on this card; key -> winner (the candidates' times land in
    ``LAST_TIMES``)."""
    out, shapes = {}, PATH_SHAPES[_dtype_name(dtype)]
    shapes = {k: v if kinds is None or k in kinds else []
              for k, v in shapes.items()}
    kw = dict(cache=cache, persist=persist)
    for seq, d, sh in shapes["flash"]:
        out[_key("flash", backend, dtype, (shape_bucket(seq), d))] = (
            tune_flash(backend, dtype, seq, d, shapes=sh, **kw))
    for S, P, N, b, H in shapes["ssd"]:
        out[_key("ssd", backend, dtype, (shape_bucket(S), P, N))] = (
            tune_ssd(backend, dtype, S, P, N, batch=b, heads=H, **kw))
    for M, N, K, layout in shapes["gemm"]:
        out[_key("gemm", backend, dtype, (shape_bucket(M), N, K, layout))] = (
            tune_gemm(backend, dtype, M, N, K, layout, **kw))
    for rows, d in shapes["norm"]:
        out[_key("norm", backend, dtype, (shape_bucket(rows), d))] = (
            tune_norm(backend, dtype, rows, d, **kw))
    return out


def emit_offline(path: str = _PACKAGED_PATH,
                 dtypes: Sequence[str] = tuple(PATH_SHAPES),
                 kinds: Optional[Sequence[str]] = None
                 ) -> Dict[str, Config]:
    """Measure the path shapes of ``dtypes`` (of ``kinds``, default all)
    on THIS card and write the packaged table to ``path``, merged over
    its entries for other backends, dtypes, kinds and keys."""
    backend = backend_of("cuda")
    table: Dict[str, Config] = {}
    for src in (_PACKAGED_PATH, path):
        try:
            with open(src) as f:
                table.update({k: dict(v) for k, v in json.load(f).items()})
        except (OSError, ValueError):
            pass
    for dtype in dtypes:
        table.update(tune_paths(backend, dtype,
                                cache=AutotuneCache(os.devnull),
                                persist=False, kinds=kinds))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(table, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    global _PACKAGED
    _PACKAGED = None                       # force reload
    return table


if __name__ == "__main__":
    import argparse
    from repro_torch.utils.device import strict_fp32_numerics
    ap = argparse.ArgumentParser(description="tune the path shapes on this "
                                 "card into the packaged table")
    ap.add_argument("path", nargs="?", default=_PACKAGED_PATH)
    ap.add_argument("--dtype", action="append", choices=list(PATH_SHAPES),
                    help="tune only these dtypes' keys (default: all)")
    ap.add_argument("--kind", action="append",
                    choices=list(PATH_SHAPES["float32"]),
                    help="tune only these kernels' keys (default: all)")
    args = ap.parse_args()
    strict_fp32_numerics()          # the plain versions in full fp32
    out = emit_offline(args.path, args.dtype or tuple(PATH_SHAPES),
                       args.kind)
    for key, times in LAST_TIMES.items():
        print(f"[tune] {key}: " + ", ".join(
            f"{c} {ms:.4f} ms" for c, ms in times.items())
            + f" -> {out[key]}")
    print(json.dumps(out, indent=2, sort_keys=True))
