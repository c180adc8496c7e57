"""Async sharded checkpointing with content-addressed layer shards
(``repro/ckpt/checkpoint.py``), on the reference's on-disk format.

The checkpoint unit is one LAYER's state (params + both Adam moments) —
the same unit Oobleck copies between replicas during reconfiguration, so
the restart path (used only when < (f+1)*n0 nodes remain, paper §3.4),
the live-copy data plane (runtime/transfer.py) and the storage format
all share a granularity.

Layout:
    <dir>/shards/<hash>.npz           content-addressed layer records
    <dir>/step_<N>/MANIFEST.json      layer index -> shard hash + sizes,
                                      written LAST via atomic rename; a
                                      step without a manifest is garbage

A layer record's keys are ``p``/``m``/``v`` followed by the leaf's path
in ``jax.tree_util.keystr`` spelling (``p['attn']['wq']``); the extra
record holds ``p/embed['table']``-style keys for the embedding, final
norm and head, and ``opt_step`` as a 0-d int32.  ``record_hash`` hashes
each key, ``str(dtype)``, ``str(shape)`` and the raw bytes in sorted key
order, so the same state saved by this package and by the JAX package
gets the same shard names and the same MANIFEST.json: a checkpoint
crosses between the two in both directions.

Properties:

  * **content hashes** — identical layer states are stored once no
    matter how many steps reference them;
  * **incremental saves** — a layer whose hash is already on disk is
    skipped (``stats["skipped_shards"]``);
  * **async** — ``save()`` copies every tensor to host numpy on the
    caller thread (a consistent view: the next step's update cannot tear
    it; on the card this is the one device->host sync that is the point)
    and hands the write to ONE daemon writer thread;
  * **safe GC** — garbage collection runs under the manager lock and
    pins every hash of queued/in-flight saves;
  * **layout-independent restore** — manifests know layers, not
    templates; ``restore`` reassembles the canonical stacked-block tree
    onto a device for ANY template set to rebind against.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import queue
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import flatten_with_path, keystr, tree_map


def _host(leaf: Any) -> np.ndarray:
    """A host copy of one leaf (never a view of a tensor that training
    may later overwrite)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    return {prefix + keystr(path): np.asarray(leaf)
            for path, leaf in flatten_with_path(tree)}


def record_hash(rec: Dict[str, np.ndarray]) -> str:
    """Content hash of one shard: keys, dtypes, shapes and raw bytes.
    (Hashing the LOGICAL content, not the .npz file — zip containers
    embed timestamps and are not byte-stable.)"""
    h = hashlib.sha256()
    for key in sorted(rec):
        a = np.ascontiguousarray(rec[key])
        h.update(key.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:32]


def record_nbytes(rec: Dict[str, np.ndarray]) -> int:
    return sum(int(a.nbytes) for a in rec.values())


def _save_npz(path: str, rec: Dict[str, np.ndarray]) -> None:
    """Single seam for shard writes (tests hook it to stall the writer
    mid-save and prove GC cannot hurt an in-flight step)."""
    np.savez(path, **rec)


def _save_manifest(path: str, meta: Dict) -> None:
    """Seam for the manifest write — the other half of the GC race
    window: shards durable, manifest not yet visible."""
    with open(path, "w") as f:
        json.dump(meta, f)


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    opt_state: Any
    data_state: Dict
    rng_seed: int


class CheckpointError(RuntimeError):
    """A background save failed; surfaced on wait()/the next save."""


def elect_writer(live_ids) -> str:
    """Deterministic manifest-writer election for multi-process saves:
    every process computes the same winner from the same live set, so
    exactly one process commits the per-step MANIFEST while all of them
    write content-addressed shards.  Lowest id wins."""
    ids = sorted(live_ids)
    if not ids:
        raise ValueError("no live processes to elect a writer from")
    return ids[0]


class CheckpointManager:
    def __init__(self, directory: str, num_layers: int,
                 async_mode: bool = True, keep: int = 2,
                 process_id: str = "proc0", manifest_writer: bool = True):
        self.dir = directory
        self.num_layers = num_layers
        self.async_mode = async_mode
        self.keep = keep
        # every process may write shards (content-addressed, so identical
        # concurrent writes are idempotent) but only the ELECTED writer
        # commits the per-step MANIFEST and runs gc
        self.process_id = process_id
        self.manifest_writer = manifest_writer
        self.stats: Dict[str, int] = {"saves": 0, "saved_shards": 0,
                                      "skipped_shards": 0, "gc_shards": 0,
                                      "gc_steps": 0, "manifest_races": 0,
                                      "manifests_skipped": 0}
        #: seconds spent copying to the host and hashing (caller thread)
        #: and writing (writer thread), summed over saves
        self.seconds: Dict[str, float] = {"host_copy": 0.0, "hash": 0.0,
                                          "write": 0.0}
        self._lock = threading.Lock()
        self._pinned: Dict[str, int] = {}      # hash -> pending refcount
        # bounded: each payload is a full host snapshot, so backpressure
        # kicks in only when storage falls 2 saves behind
        self._queue: "queue.Queue[Dict]" = queue.Queue(maxsize=2)
        self._worker: Optional[threading.Thread] = None
        self._errors: List[BaseException] = []
        os.makedirs(self.shard_dir, exist_ok=True)

    @property
    def shard_dir(self) -> str:
        return os.path.join(self.dir, "shards")

    def _shard_path(self, h: str) -> str:
        return os.path.join(self.shard_dir, f"{h}.npz")

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    # ------------------------------------------------------------------
    # Save
    # ------------------------------------------------------------------
    def save(self, state: TrainState, block: bool = False) -> None:
        """Copy to host numpy NOW (consistent view), hash each layer
        shard, and hand the write to the background thread — the caller
        never waits for a previous save to finish."""
        self._raise_pending_errors()
        payload = self._snapshot(state)
        self.stats["saves"] += 1
        if self.async_mode and not block:
            with self._lock:
                for h, _ in payload["shards"]:
                    self._pinned[h] = self._pinned.get(h, 0) + 1
            self._ensure_worker()
            self._queue.put(payload)
        else:
            self.wait()                 # keep manifest order monotonic
            self._write(payload)

    def wait(self) -> None:
        """Block until every queued save is durable; re-raise background
        failures."""
        if self._worker is not None:
            self._queue.join()
        self._raise_pending_errors()

    def _raise_pending_errors(self) -> None:
        with self._lock:
            errors, self._errors = self._errors, []
        if errors:
            raise CheckpointError(
                f"async checkpoint save failed: {errors[0]!r}") from errors[0]

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    def _drain(self) -> None:
        while True:
            payload = self._queue.get()
            try:
                self._write(payload)
            except BaseException as e:      # surfaced on wait()/next save
                with self._lock:
                    self._errors.append(e)
            finally:
                with self._lock:
                    for h, _ in payload["shards"]:
                        n = self._pinned.get(h, 0) - 1
                        if n <= 0:
                            self._pinned.pop(h, None)
                        else:
                            self._pinned[h] = n
                self._queue.task_done()

    def hashes(self, state: TrainState) -> List[str]:
        """The shard hashes a save of ``state`` would reference (one per
        layer, then the extra record), computed without writing: two
        states with equal hashes are bitwise equal."""
        meta = self._snapshot(state)["meta"]
        return [e["hash"] for e in meta["layers"]] + [meta["extra"]["hash"]]

    # ------------------------------------------------------------------
    def _snapshot(self, state: TrainState) -> Dict:
        # one device->host copy per leaf, on the caller thread; the layer
        # records below are views of these host arrays
        t0 = time.perf_counter()
        params = tree_map(_host, state.params)
        m_tree = tree_map(_host, state.opt_state.m)
        v_tree = tree_map(_host, state.opt_state.v)
        t1 = time.perf_counter()
        layer_entries: List[Dict] = []
        shards: List[Tuple[str, Dict[str, np.ndarray]]] = []
        seen: Set[str] = set()

        def add(rec: Dict[str, np.ndarray]) -> Dict:
            h = record_hash(rec)
            if h not in seen:
                seen.add(h)
                shards.append((h, rec))
            return {"hash": h, "nbytes": record_nbytes(rec)}

        def layer(tree, i):
            return tree_map(lambda t: t[i], tree["blocks"])

        for i in range(self.num_layers):
            rec: Dict[str, np.ndarray] = {}
            rec.update(_flatten(layer(params, i), "p"))
            rec.update(_flatten(layer(m_tree, i), "m"))
            rec.update(_flatten(layer(v_tree, i), "v"))
            layer_entries.append(add(rec))
        extra: Dict[str, np.ndarray] = {}
        for part in ("embed", "final_norm", "head"):
            if part in params:
                extra.update(_flatten(params[part], f"p/{part}"))
                extra.update(_flatten(m_tree[part], f"m/{part}"))
                extra.update(_flatten(v_tree[part], f"v/{part}"))
        extra["opt_step"] = _host(state.opt_state.step).astype(np.int32)
        extra_entry = add(extra)
        self.seconds["host_copy"] += t1 - t0
        self.seconds["hash"] += time.perf_counter() - t1
        return {
            "step": state.step,
            "shards": shards,
            "meta": {"step": state.step, "num_layers": self.num_layers,
                     "data_state": state.data_state,
                     "rng_seed": state.rng_seed,
                     "layers": layer_entries,
                     "extra": extra_entry},
        }

    def _write(self, payload: Dict) -> None:
        t0 = time.perf_counter()
        try:
            self._write_payload(payload)
        finally:
            self.seconds["write"] += time.perf_counter() - t0

    def _write_payload(self, payload: Dict) -> None:
        # 1. shards (content-addressed: existing hash == incremental skip)
        for h, rec in payload["shards"]:
            final = self._shard_path(h)
            if os.path.exists(final):
                self.stats["skipped_shards"] += 1
                continue
            fd, tmp = tempfile.mkstemp(dir=self.shard_dir, prefix=".tmp_",
                                       suffix=".npz")
            os.close(fd)
            try:
                _save_npz(tmp, rec)
                os.replace(tmp, final)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            self.stats["saved_shards"] += 1
        # 2. manifest, LAST, via atomic rename of the step dir — writer
        # only; shard-only processes stop here
        if not self.manifest_writer:
            self.stats["manifests_skipped"] += 1
            return
        step = payload["step"]
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
        try:
            _save_manifest(os.path.join(tmp, "MANIFEST.json"),
                           payload["meta"])
            final = self._step_dir(step)
            with self._lock:
                if os.path.exists(final):
                    shutil.rmtree(final)
                try:
                    os.rename(tmp, final)
                except OSError:
                    # another process committed this step between our
                    # exists-check and rename; content addressing makes
                    # the outcome identical: count the race
                    if not os.path.exists(
                            os.path.join(final, "MANIFEST.json")):
                        raise
                    self.stats["manifest_races"] += 1
        finally:
            if os.path.exists(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
        self.gc()

    # ------------------------------------------------------------------
    # GC: never touches a shard an in-flight save references
    # ------------------------------------------------------------------
    def gc(self) -> None:
        with self._lock:
            steps = self._list_steps_locked()
            drop, kept = steps[:-self.keep], steps[-self.keep:]
            referenced: Set[str] = set(self._pinned)
            for s in kept:
                meta = self._read_manifest(s)
                referenced.update(e["hash"] for e in meta["layers"])
                referenced.add(meta["extra"]["hash"])
            for s in drop:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
                self.stats["gc_steps"] += 1
            for name in os.listdir(self.shard_dir):
                if not name.endswith(".npz") or name.startswith(".tmp_"):
                    continue
                if name[:-len(".npz")] not in referenced:
                    try:
                        os.remove(os.path.join(self.shard_dir, name))
                        self.stats["gc_shards"] += 1
                    except OSError:
                        pass

    # ------------------------------------------------------------------
    # Read side
    # ------------------------------------------------------------------
    def _list_steps_locked(self) -> List[int]:
        out = []
        for name in sorted(os.listdir(self.dir)):
            full = os.path.join(self.dir, name)
            if (name.startswith("step_")
                    and os.path.exists(os.path.join(full, "MANIFEST.json"))):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def list_steps(self) -> List[int]:
        return self._list_steps_locked()

    def _read_manifest(self, step: int) -> Dict:
        with open(os.path.join(self._step_dir(step), "MANIFEST.json")) as f:
            return json.load(f)

    def _load_shard(self, h: str) -> Dict[str, np.ndarray]:
        return dict(np.load(self._shard_path(h)))

    def layer_record(self, step: int, layer: int) -> Dict[str, np.ndarray]:
        """One layer's flat state record ('p...'/'m...'/'v...' keys) —
        the same unit the recovery data plane moves between replicas."""
        meta = self._read_manifest(step)
        return self._load_shard(meta["layers"][layer]["hash"])

    def verify(self, step: int) -> bool:
        """Recompute every referenced shard's content hash: True iff the
        step is bit-exact on disk."""
        try:
            meta = self._read_manifest(step)
            hashes = [e["hash"] for e in meta["layers"]]
            hashes.append(meta["extra"]["hash"])
            return all(record_hash(self._load_shard(h)) == h for h in hashes)
        except Exception:
            # the contract is "False on ANY corruption": a truncated .npz
            # raises BadZipFile/EOFError, a mangled manifest
            # JSONDecodeError — none of them may escape
            return False

    def restore(self, template_params: Any, template_opt: Any,
                step: Optional[int] = None, device="cuda") -> TrainState:
        """Restore into the structure of (template_params, template_opt),
        onto ``device``: tensors there, in the templates' dtypes.
        ``device=None`` returns host numpy arrays instead.

        The manifest indexes layers, not pipeline templates: the same
        checkpoint restores under ANY template layout (different node
        counts, stage tilings)."""
        dev = None if device is None else resolve_device(device)
        steps = self.list_steps()
        if not steps:
            raise FileNotFoundError(f"no complete checkpoint in {self.dir}")
        step = steps[-1] if step is None else step
        meta = self._read_manifest(step)

        def load_into(tree, record, prefix):
            def leaf(path, t):
                key = prefix + keystr(path)
                arr = record[key]
                if arr.shape != tuple(t.shape):
                    raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                                     f"template {tuple(t.shape)}")
                return arr
            leaves = [leaf(path, t) for path, t in flatten_with_path(tree)]
            it = iter(leaves)
            return tree_map(lambda _: next(it), tree)

        def place(arr, t):
            if dev is None:
                return arr.astype(_numpy_dtype(t))
            return torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=dev, dtype=t.dtype)

        blocks_t = tree_map(lambda t: t[0], template_params["blocks"])
        p_layers, m_layers, v_layers = [], [], []
        for i in range(meta["num_layers"]):
            rec = self._load_shard(meta["layers"][i]["hash"])
            p_layers.append(load_into(blocks_t, rec, "p"))
            m_layers.append(load_into(blocks_t, rec, "m"))
            v_layers.append(load_into(blocks_t, rec, "v"))
        stacked = template_params["blocks"]

        def stack(layers):
            return tree_map(lambda t, *xs: place(np.stack(xs), t),
                            stacked, *layers)
        extra = self._load_shard(meta["extra"]["hash"])
        params = {"blocks": stack(p_layers)}
        m = {"blocks": stack(m_layers)}
        v = {"blocks": stack(v_layers)}
        for part in ("embed", "final_norm", "head"):
            if part in template_params:
                t = template_params[part]
                for tree, prefix in ((params, "p"), (m, "m"), (v, "v")):
                    tree[part] = tree_map(
                        place, load_into(t, extra, f"{prefix}/{part}"), t)
        opt_step = extra["opt_step"].astype(np.int32)
        if dev is not None:
            opt_step = torch.from_numpy(opt_step).to(dev)
        opt = type(template_opt)(step=opt_step, m=m, v=v)
        return TrainState(step=meta["step"], params=params, opt_state=opt,
                          data_state=meta["data_state"],
                          rng_seed=meta["rng_seed"])


def _numpy_dtype(t: Any) -> np.dtype:
    if isinstance(t, torch.Tensor):
        return torch.empty((), dtype=t.dtype).numpy().dtype
    return np.asarray(t).dtype
