"""Resilient serving data plane: continuous batching + template-based
inference fault tolerance (``repro/runtime/serve_exec.py``, DESIGN.md
§14).

Training recovers by table lookup because templates are planned and
programs built up front; this module gives serving the same property.
A ``ServeExecutor`` registers with the engine like the trainers do
(Executor interface: bind / step / recover / join / snapshot), and every
``engine.instances`` entry becomes a decode-pipeline REPLICA with a
fixed-shape slot state on the device:

    cache   model.init_cache(num_slots, max_len)   [L, B, ...] per leaf
    tok     [B] int32    last token per slot (next decode input)
    pos     [B] int32    absolute position per slot
    ngen    [B] int32    generated-token count per slot
    keys    [B, 2] int64 per-request PRNG base key per slot (uint32 words)
    out     [B, cap] i32 generated-token ring (host harvests on finish)
    active  [B] bool     the slots holding a request (kept by fills)

Continuous batching (Orca-style) never changes a program's shapes:
admission teacher-forces a prompt into ONE slot through the very same
full-batch decode tick with the other rows' caches left as they were,
eviction is host bookkeeping, and the decode tick writes the cache in
place (``Model.decode_step_``, the torch form of the reference's donated
cache) and samples on the device — temperature / top-k, per-slot key
folding (``utils/prng.py``, the reference's threefry bitwise) — so the
steady-state loop reads nothing back to the host (the
``track_host_transfers`` contract; on the card under sync debug mode
"error") and builds nothing (ProgramCache keys are (kind,
backend_signature, shapes)).

Sampling determinism is the recovery keystone: the token at generated
index ``n`` of a request with base key ``k`` is sampled with
``fold_in(k, P + n - 1)`` (P = prompt length), a pure function of the
request and the position, never of batch composition or wall clock; and
a row's arithmetic does not depend on the other rows, since every tick
runs at the full ``[num_slots]`` shape.  A mid-decode failure therefore
resumes bitwise-identically:

  fail event -> engine.handle_failure() replans instances from the
  precomputed template set -> surviving replicas inherit their slot
  state (max node-overlap matching) -> requests on dissolved replicas
  MIGRATE their cache rows to free slots (extract / install + CopyTasks
  scheduled through runtime/transfer.py's topology-aware streams) ->
  requests whose layers lost every owner REPLAY by teacher-forcing the
  host-known prefix (prompt + already-streamed tokens) -> decode
  continues, through programs built at bootstrap: ``track_compiles``
  counts 0 across fail -> recover -> drain.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.reconfigure import CopyTask, PipelineInstance
from repro_torch.kernels import ops as kops
from repro_torch.models import Model
from repro_torch.runtime.executor import (Executor, ProgramCache, avals_of,
                                          tree_spec)
from repro_torch.runtime.transfer import schedule_transfers
from repro_torch.utils import prng
from repro_torch.utils.tree import tree_leaves, tree_map


# ----------------------------------------------------------------------
# Requests + sampling
# ----------------------------------------------------------------------
@dataclasses.dataclass
class SamplingParams:
    temperature: float = 0.0
    top_k: int = 0                   # 0 = full vocab


@dataclasses.dataclass
class ServeRequest:
    rid: int
    prompt: np.ndarray               # [P] int32
    max_new: int                     # TOTAL generated tokens requested
    arrival_s: float = 0.0
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None
    tokens: Optional[np.ndarray] = None     # filled on completion
    # tokens already emitted before a replay (streamed to the client;
    # teacher-forced back in, never regenerated)
    prior: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int32))
    replays: int = 0
    migrations: int = 0

    @property
    def remaining(self) -> int:
        return self.max_new - len(self.prior)


def _sample_tokens(logits: torch.Tensor, keys: torch.Tensor, pos,
                   temp: torch.Tensor, top_k: int) -> torch.Tensor:
    """On-device sampling: [B, V] fp32 logits -> [B] int32 tokens.

    Per-row key = fold_in(row base key, row position): a pure function
    of (request, position), so replay and migration reproduce the stream
    at ANY temperature.  ``temp`` is a 0-d device tensor (0: argmax)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    sampled = prng.categorical(prng.fold_in(keys, pos),
                               logits / torch.clamp(temp, min=1e-6))
    return torch.where(temp > 0, sampled.to(torch.int32), greedy)


# ----------------------------------------------------------------------
# Replica: one engine instance + its slot state
# ----------------------------------------------------------------------
class _Replica:
    def __init__(self, instance: PipelineInstance, num_slots: int, state):
        self.instance = instance
        self.cache, self.tok, self.pos, self.ngen, self.keys, self.out = state
        self.requests: List[Optional[ServeRequest]] = [None] * num_slots
        self.ngen_h = np.zeros(num_slots, np.int64)   # host shadow
        # the device twin of active_mask(), kept by place() with fills,
        # so the decode tick uploads nothing
        self.active = torch.zeros(num_slots, dtype=torch.bool,
                                  device=self.tok.device)

    def place(self, slot: int, req: Optional[ServeRequest]) -> None:
        self.requests[slot] = req
        self.active[slot] = req is not None

    def active_mask(self) -> np.ndarray:
        return np.array([r is not None for r in self.requests], bool)

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.requests) if r is None]

    def state(self):
        return (self.cache, self.tok, self.pos, self.ngen, self.keys,
                self.out)

    def lost_layers(self, dead: Set[str]) -> List[int]:
        """Layers whose every serving owner died (cache unrecoverable)."""
        return [l for l in range(self.instance.template.num_layers)
                if set(self.instance.layer_owners(l)) <= dead]


# ----------------------------------------------------------------------
# The executor
# ----------------------------------------------------------------------
class ServeExecutor(Executor):
    """Continuous-batching serving runtime behind the Executor seam.

    ``engine.instances`` are the decode-pipeline replicas; the template
    describes stage placement / ownership for fault tolerance while the
    programs are keyed ONLY by (kind, backend, shapes) — a replan swaps
    bookkeeping, never programs.  Every replica shares ``params``; the
    state lives on their device.
    """

    def __init__(self, model: Model, params: Dict, engine, *,
                 num_slots: int = 4, max_len: int = 64,
                 max_new_cap: int = 32,
                 sampling: Optional[SamplingParams] = None,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 sample_key: Optional[torch.Tensor] = None,
                 admission: str = "continuous",
                 cache: Optional[ProgramCache] = None,
                 clock: Callable[[], float] = time.perf_counter):
        assert admission in ("continuous", "static")
        self.model = model
        self.params = params
        self.device = tree_leaves(params)[0].device
        self.engine = engine
        self.num_slots = num_slots
        self.max_len = max_len
        self.cap = max_new_cap
        self.sampling = sampling or SamplingParams()
        self.admission = admission
        self.cache = cache or ProgramCache()
        self.clock = clock
        self.sample_key = (sample_key.to(self.device)
                           if sample_key is not None
                           else prng.prng_key(0, self.device))
        self._temp = torch.tensor(self.sampling.temperature,
                                  dtype=torch.float32, device=self.device)
        if prompt_buckets is None:
            prompt_buckets, b = [], 8
            while b < max_len:
                prompt_buckets.append(b)
                b *= 2
            prompt_buckets.append(max_len)
        self.buckets = sorted(set(prompt_buckets))
        assert self.buckets[-1] >= max_len, "buckets must cover max_len"

        self.queue: "deque[ServeRequest]" = deque()
        self.completed: List[ServeRequest] = []
        self.replicas: List[_Replica] = []
        self.ticks = 0
        self._next_rid = 0
        self.last_recovery: Optional[Dict] = None
        engine.attach_executor(self)
        self.bind()

    # ------------------------------------------------------------------
    # Executor interface
    # ------------------------------------------------------------------
    def bind(self) -> None:
        """Fresh replicas for the current instance set + build every
        program the serving plane can ever need (§8: build at bootstrap
        so recovery never builds)."""
        self.replicas = [
            _Replica(inst, self.num_slots, self._fresh_state())
            for inst in self.engine.instances]
        self.warm()

    def step(self, batches=None) -> Dict:
        return self.tick()

    def snapshot(self, data_state: Optional[Dict] = None,
                 rng_seed: int = 0):
        return {
            "ticks": self.ticks,
            "completed": [r.rid for r in self.completed],
            "in_flight": [r.rid for rep in self.replicas
                          for r in rep.requests if r is not None],
            "queued": [r.rid for r in self.queue],
            "cache": self.cache.stats.as_dict(),
        }

    # ------------------------------------------------------------------
    # Request lifecycle
    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int,
               rid: Optional[int] = None) -> ServeRequest:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) + max_new > self.max_len:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new({max_new}) exceeds "
                f"max_len({self.max_len})")
        if max_new > self.cap:
            raise ValueError(f"max_new({max_new}) > out cap({self.cap})")
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        req = ServeRequest(rid=rid, prompt=prompt, max_new=max_new,
                           arrival_s=self.clock())
        self.queue.append(req)
        return req

    def tick(self) -> Dict:
        """One scheduler round: admit, one batched decode step per
        replica, harvest finished slots.  The decode inner loop does no
        device->host transfer; completions are detected from host
        shadows and only then is the finished row fetched."""
        admitted = 0
        for rep in self.replicas:
            free = rep.free_slots()
            if self.admission == "static" and len(free) < self.num_slots:
                free = []           # static baseline: drain, then refill
            for slot in free:
                if not self.queue:
                    break
                self._admit(rep, slot, self.queue.popleft())
                admitted += 1
        decoded = 0
        for rep in self.replicas:
            active = rep.active_mask()
            if not active.any():
                continue
            prog = self._decode_program()
            prog(self.params, rep.cache, rep.tok, rep.pos, rep.ngen,
                 rep.keys, rep.active, self._temp, rep.out)
            rep.ngen_h[active] += 1
            decoded += int(active.sum())
        finished = 0
        for rep in self.replicas:
            for slot, req in enumerate(rep.requests):
                if req is not None and rep.ngen_h[slot] >= req.remaining:
                    self._harvest(rep, slot)
                    finished += 1
        self.ticks += 1
        return {"admitted": admitted, "decoded": decoded,
                "finished": finished}

    def drain(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self.queue and not any(r.active_mask().any()
                                          for r in self.replicas):
                return
            self.tick()
        raise RuntimeError(f"not drained after {max_ticks} ticks")

    def _base_key(self, rid: int) -> torch.Tensor:
        return prng.fold_in(self.sample_key, rid & 0xFFFFFFFF)

    def _admit(self, rep: _Replica, slot: int, req: ServeRequest) -> None:
        """Teacher-force prompt + any replay prefix into ``slot`` via the
        bucketed admit program (the same full-batch decode tick, other
        rows' caches kept), then sample the first new token on the
        device."""
        if req.remaining <= 0:      # replayed request already had all
            req.tokens = req.prior  # its tokens streamed pre-failure
            req.done_s = req.done_s or self.clock()
            self.completed.append(req)
            return
        prefix = np.concatenate([req.prompt, req.prior]).astype(np.int32)
        prog = self._admit_program(next(b for b in self.buckets
                                        if b >= len(prefix)))
        prog(self.params, *rep.state(), slot, prefix,
             self._base_key(req.rid), self._temp)
        rep.place(slot, req)
        rep.ngen_h[slot] = 1
        self.synchronize()                   # TTFT is an honest wall time
        if req.first_token_s is None:
            req.first_token_s = self.clock()

    def _harvest(self, rep: _Replica, slot: int) -> None:
        req = rep.requests[slot]
        # admission + the same tick's decode can overshoot remaining by
        # one row entry; the client asked for max_new, slice to it
        n = min(int(rep.ngen_h[slot]), req.remaining)
        row = rep.out[slot].cpu().numpy()    # the ONLY steady-state D2H
        req.tokens = np.concatenate([req.prior, row[:n]])
        req.done_s = self.clock()
        self.completed.append(req)
        rep.place(slot, None)
        rep.ngen_h[slot] = 0

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # Fault tolerance
    # ------------------------------------------------------------------
    def recover(self, dead: Set[str], drained: bool = False) -> Dict:
        """Fail event mid-traffic: replan decode pipelines from the
        template set, migrate live cache rows, replay what died —
        zero builds end to end."""
        t0 = self.clock()
        dead = set(dead)
        old = self.replicas
        self.engine.handle_failure(dead, drained=drained)
        info = self._rebind(old, dead)
        self.synchronize()
        info.update(policy="replan", downtime_s=self.clock() - t0,
                    cache=self.cache.stats.as_dict())
        self.last_recovery = info
        return info

    def join(self, nodes: List[str]) -> Dict:
        t0 = self.clock()
        old = self.replicas
        self.engine.handle_join(list(nodes))
        info = self._rebind(old, set())
        self.synchronize()
        info.update(policy="join", downtime_s=self.clock() - t0)
        self.last_recovery = info
        return info

    def _rebind(self, old: List[_Replica], dead: Set[str]) -> Dict:
        """Map the engine's NEW instance set onto the old replicas by
        max node overlap; inherited replicas keep their slot state
        (shapes never changed, so the programs are the same cache
        entries), dissolved replicas migrate or replay their requests."""
        pairs = sorted(
            ((len(set(inst.nodes) & (set(r.instance.nodes) - dead)), ni, oi)
             for ni, inst in enumerate(self.engine.instances)
             for oi, r in enumerate(old)),
            key=lambda t: (-t[0], t[1], t[2]))
        match: Dict[int, int] = {}
        used: Set[int] = set()
        for score, ni, oi in pairs:
            if score <= 0 or ni in match or oi in used:
                continue
            match[ni] = oi
            used.add(oi)

        copy_tasks: List[CopyTask] = []
        replay: List[ServeRequest] = []
        migrate: List[Tuple[_Replica, int, ServeRequest]] = []
        new_replicas: List[_Replica] = []
        row_bytes = self._row_bytes_per_layer()

        for ni, inst in enumerate(self.engine.instances):
            if ni not in match:
                new_replicas.append(
                    _Replica(inst, self.num_slots, self._fresh_state()))
                continue
            src = old[match[ni]]
            rep = _Replica(inst, self.num_slots, src.state())
            rep.ngen_h = src.ngen_h.copy()
            lost = set(src.lost_layers(dead))
            if lost:
                # some layer's cache has no surviving owner: every
                # in-flight request on this replica must replay
                for slot, req in enumerate(src.requests):
                    if req is not None:
                        replay.append(self._prepare_replay(src, slot, req))
                rep.ngen_h[:] = 0
            else:
                for slot, req in enumerate(src.requests):
                    if req is not None:
                        rep.place(slot, req)
                active = int(rep.active_mask().sum())
                for layer in range(inst.template.num_layers):
                    prev = set(src.instance.layer_owners(layer)) - dead
                    for dst in inst.layer_owners(layer):
                        if dst in prev or not active:
                            continue
                        copy_tasks.append(CopyTask(
                            layer, min(prev), dst, row_bytes * active,
                            sources=tuple(sorted(prev))))
            new_replicas.append(rep)

        for oi, src in enumerate(old):
            if oi in used:
                continue
            # dissolved replica: rows migrate if every layer survives
            # somewhere, else the requests replay from the host prefix
            lost = set(src.lost_layers(dead))
            for slot, req in enumerate(src.requests):
                if req is None:
                    continue
                if lost:
                    replay.append(self._prepare_replay(src, slot, req))
                else:
                    migrate.append((src, slot, req))

        self.replicas = new_replicas
        migrated = 0
        for src, slot, req in migrate:
            target = next(((rep, s) for rep in self.replicas
                           for s in rep.free_slots()), None)
            if target is None:
                replay.append(self._prepare_replay(src, slot, req))
                continue
            rep, dst_slot = target
            self._migrate_row(src, slot, rep, dst_slot, req)
            for layer in range(rep.instance.template.num_layers):
                srcs = tuple(sorted(
                    set(src.instance.layer_owners(layer)) - dead))
                for dst in rep.instance.layer_owners(layer):
                    copy_tasks.append(CopyTask(layer, srcs[0], dst,
                                               row_bytes, sources=srcs))
            req.migrations += 1
            migrated += 1

        # the modeled data plane: the same topology-aware streams the
        # training state copies ride (validated, makespan = max over
        # streams)
        plan = (schedule_transfers(copy_tasks, self.engine.topology,
                                   dead=dead) if copy_tasks else None)
        for req in reversed(replay):        # preserve original order
            req.replays += 1
            self.queue.appendleft(req)
        return {
            "migrated": migrated, "replayed": len(replay),
            "copy_bytes": sum(t.nbytes for t in copy_tasks),
            "transfer_makespan_s": plan.makespan() if plan else 0.0,
            "replicas": len(self.replicas),
        }

    def _prepare_replay(self, rep: _Replica, slot: int,
                        req: ServeRequest) -> ServeRequest:
        """Fold the already-streamed tokens (host-known: they went to the
        client) into the replay prefix; they are teacher-forced back and
        never regenerated, so the stream stays bitwise-identical."""
        n = int(rep.ngen_h[slot])
        if n:
            row = rep.out[slot].cpu().numpy()
            req.prior = np.concatenate([req.prior, row[:n]])
        return req

    def _migrate_row(self, src: _Replica, src_slot: int, dst: _Replica,
                     dst_slot: int, req: ServeRequest) -> None:
        ext = self._extract_program()
        row = ext(*src.state(), src_slot)
        ins = self._install_program()
        ins(*dst.state(), *row, dst_slot)
        dst.place(dst_slot, req)
        dst.ngen_h[dst_slot] = src.ngen_h[src_slot]

    # ------------------------------------------------------------------
    # Programs (built once through the ProgramCache; §8 key discipline)
    # ------------------------------------------------------------------
    def _fresh_state(self):
        B, cap, dev = self.num_slots, self.cap, self.device

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        return (self.model.init_cache(B, self.max_len, device=dev),
                zeros(B), zeros(B), zeros(B), zeros(B, 2, dtype=torch.int64),
                zeros(B, cap))

    def _state_avals(self):
        """The state's shapes as ``meta`` tensors, computed once (static
        config); the cache from a one-slot cache with its batch axis
        widened."""
        if getattr(self, "_state_tpl", None) is not None:
            return self._state_tpl
        B, cap = self.num_slots, self.cap

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")
        cache = tree_map(
            lambda s: meta((s.shape[0], B) + tuple(s.shape[2:]), s.dtype),
            avals_of(self.model.init_cache(1, self.max_len,
                                           device=self.device)))
        self._state_tpl = (cache, meta((B,), torch.int32),
                           meta((B,), torch.int32), meta((B,), torch.int32),
                           meta((B, 2), torch.int64),
                           meta((B, cap), torch.int32))
        return self._state_tpl

    def _key_base(self) -> Tuple:
        if getattr(self, "_kb", None) is None:
            self._kb = (kops.backend_signature(self.device),
                        tree_spec(avals_of(self.params)),
                        tree_spec(self._state_avals()[0]), self.num_slots,
                        self.cap, self.sampling.top_k)
        return self._kb

    def _decode_program(self):
        key = ("serve_decode",) + self._key_base()

        def build():
            model, top_k = self.model, self.sampling.top_k
            cols = torch.arange(self.cap, device=self.device)

            @torch.no_grad()
            def fn(params, cache, tok, pos, ngen, keys, active, temp, out):
                """One decode tick of every row, in place: the cache
                (every row, as the reference's tick), and tok, pos, ngen
                and out of the active rows."""
                logits = model.decode_step_(params, tok[:, None], cache, pos)
                nxt = _sample_tokens(logits[:, 0], keys, pos, temp, top_k)
                nxt = torch.where(active, nxt, tok)
                hit = active[:, None] & (cols[None, :] == ngen[:, None])
                out.copy_(torch.where(hit, nxt[:, None], out))
                inc = active.to(torch.int32)
                tok.copy_(nxt)
                pos.add_(inc)
                ngen.add_(inc)

            return fn

        return self.cache.get_or_build(key, build)

    def _admit_program(self, bucket: int):
        key = ("serve_admit", bucket) + self._key_base()

        def build():
            model, top_k = self.model, self.sampling.top_k
            rows = torch.arange(self.num_slots, device=self.device)

            @torch.no_grad()
            def fn(params, cache, tok, pos, ngen, keys, out, slot: int,
                   prompt: np.ndarray, base_key, temp):
                """Teacher-force ``prompt`` (at most ``bucket`` tokens)
                into row ``slot`` in place, one full-batch decode tick a
                position, then sample the first token.  Only row ``slot``
                writes the cache: the other rows keep theirs (a request
                mid-decode there keeps its Mamba state).  The reference
                scans the whole bucket; its steps past the prompt change
                no row, so the loop stops at the prompt's end."""
                plen = len(prompt)
                # evict the previous occupant: zero the slot's row so
                # stale SSM / conv running state cannot leak into the new
                # request (attention is position-masked, SSM is not)
                for c in tree_leaves(cache):
                    c[:, slot].zero_()
                write = rows == slot
                tok_t, pos_t = tok.clone(), pos.clone()
                for t in range(plen):
                    tok_t[slot] = int(prompt[t])
                    pos_t[slot] = t
                    last = model.decode_step_(params, tok_t[:, None], cache,
                                              pos_t, write)
                first = _sample_tokens(last[slot], base_key[None], plen - 1,
                                       temp, top_k)[0]
                tok[slot] = first
                pos[slot] = plen
                ngen[slot] = 1
                keys[slot] = base_key
                out[slot] = 0
                out[slot, 0] = first

            return fn

        return self.cache.get_or_build(key, build)

    def _extract_program(self):
        key = ("serve_extract",) + self._key_base()

        def build():
            @torch.no_grad()
            def fn(cache, tok, pos, ngen, keys, out, slot: int):
                """Copies of row ``slot``: (cache row [L, 1, ...] per leaf,
                out, tok, pos, ngen, key)."""
                row = tree_map(lambda c: c[:, slot:slot + 1].clone(), cache)
                return (row, out[slot].clone(), tok[slot].clone(),
                        pos[slot].clone(), ngen[slot].clone(),
                        keys[slot].clone())

            return fn

        return self.cache.get_or_build(key, build)

    def _install_program(self):
        key = ("serve_install",) + self._key_base()

        def build():
            @torch.no_grad()
            def fn(cache, tok, pos, ngen, keys, out, row, orow, tok_s, pos_s,
                   ngen_s, key_s, slot: int):
                """Write an extracted row into row ``slot`` in place."""
                tree_map(lambda c, r: c[:, slot:slot + 1].copy_(r), cache,
                         row)
                tok[slot] = tok_s
                pos[slot] = pos_s
                ngen[slot] = ngen_s
                keys[slot] = key_s
                out[slot] = orow

            return fn

        return self.cache.get_or_build(key, build)

    def _row_bytes_per_layer(self) -> int:
        cache_s, *_ = self._state_avals()
        return sum(int(np.prod(s.shape[2:])) * s.element_size()
                   for s in tree_leaves(cache_s))

    # ------------------------------------------------------------------
    def warm(self) -> None:
        """Build every program AND exercise every host-side path (state
        init, key folding, the mask fills, row fetch, extract / install)
        with one synthetic request on a scratch replica, so a later
        failure -> recover -> drain cycle builds nothing."""
        self._decode_program()
        for b in self.buckets:
            self._admit_program(b)
        self._extract_program()
        self._install_program()
        if not self.replicas:
            return
        rep = _Replica(self.replicas[0].instance, self.num_slots,
                       self._fresh_state())
        req = ServeRequest(rid=-1, prompt=np.zeros(1, np.int32), max_new=1)
        clock, self.clock = self.clock, lambda: 0.0
        try:
            self._admit(rep, 0, req)
            self._decode_program()(self.params, rep.cache, rep.tok, rep.pos,
                                   rep.ngen, rep.keys, rep.active,
                                   self._temp, rep.out)
            rep.ngen_h[0] += 1
            self._prepare_replay(rep, 0, req)       # warm the row fetch
            self._harvest(rep, 0)
            self._migrate_row(rep, 0, rep, 1, req)  # warm extract/install
            self._base_key(0)
        finally:
            self.clock = clock
            self.completed = [r for r in self.completed if r.rid != -1]
