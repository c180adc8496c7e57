"""Out-of-band coordination channel for multi-process training
(``repro/runtime/coordination.py``; DESIGN.md §15).

Oobleck separates the *coordination* plane from the *collective* plane:
per-node agents hold plain TCP connections to a central coordinator, so
a process death is observed as a socket disconnect (instantly) or a
heartbeat timeout (bounded), never as a collective hanging until its own
timeout (§3.3).  This module is that channel for the multi-process
executor (runtime/multihost.py):

  * ``send_msg``/``recv_msg`` — a framed wire format: one length-
    prefixed JSON header plus N length-prefixed binary blobs.  Control
    traffic is all-JSON; tensor payloads ride the blobs untouched (raw
    row-major bytes, so fp32 state crosses the wire bit-exactly);
  * ``CoordinatorServer`` — the coordinator's side: accepts one control
    connection per worker, runs a reader thread per socket that feeds
    heartbeats into a ``core.monitor.HeartbeatTracker`` and routes
    request replies by ``req_id``; socket EOF fences the worker
    immediately (the disconnect-as-failure signal).  Bytes of a frame
    still arriving count as liveness too: a worker's beats queue behind
    its own reply on the shared socket, and a full-width gradient reply
    is over a gigabyte;
  * ``WorkerChannel`` — the worker's side: one control socket, a beat
    thread, and a blocking serve loop dispatching coordinator requests
    to registered handlers;
  * ``DataServer``/``data_call`` — a one-request-per-connection bulk
    channel between workers, used by recovery to pull layer states from
    surviving replicas (runtime/transfer.py CopyTask streams become
    actual cross-process transfers through this).

Everything on the wire is stdlib + numpy; torch appears only at the
edges, where trees of tensors are flattened into blobs and rebuilt.
"""
from __future__ import annotations

import itertools
import json
import queue
import socket
import struct
import threading
import time
import traceback
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.monitor import HeartbeatConfig, HeartbeatTracker
from repro_torch.utils.tree import tree_leaves_with_path, tree_unflatten_like

Header = Dict[str, Any]
Blobs = Sequence[bytes]

_LEN = struct.Struct(">Q")
_MAX_FRAME = 1 << 34        # 16 GiB sanity bound on any one length field
_CHUNK = 1 << 20            # bytes a recv asks for


class WorkerLost(RuntimeError):
    """A control-plane peer died (socket EOF or heartbeat timeout) while
    we were waiting on it.  Carries the ranks involved."""

    def __init__(self, ranks: Iterable[int], why: str = ""):
        self.ranks = sorted(set(ranks))
        super().__init__(f"worker(s) {self.ranks} lost"
                         + (f": {why}" if why else ""))


class EpochMismatch(RuntimeError):
    """Two sides of the reconfiguration protocol disagree on the
    reconfiguration epoch or its plan fingerprint — the agreed-epoch
    invariant would be violated by proceeding."""


# ----------------------------------------------------------------------
# Wire format
# ----------------------------------------------------------------------
def _recv_exact(sock: socket.socket, n: int,
                on_bytes: Optional[Callable[[int], None]] = None
                ) -> bytearray:
    """Exactly ``n`` bytes, read in place; ``on_bytes`` hears of every
    chunk as it arrives."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(n - got, _CHUNK))
        if not k:
            raise ConnectionError("peer closed mid-message")
        got += k
        if on_bytes is not None:
            on_bytes(k)
    return buf


def send_msg(sock: socket.socket, header: Header, blobs: Blobs = (),
             lock: Optional[threading.Lock] = None) -> None:
    """One framed message: [len][json header][nblobs]([len][bytes])*.
    The frame's parts go out back to back under ``lock`` so concurrent
    senders on a shared socket (beat thread vs. reply path) never
    interleave frames; blobs are sent as they are, never concatenated
    into a second copy."""
    payload = json.dumps(header, sort_keys=True).encode()
    parts: List[Any] = [_LEN.pack(len(payload)) + payload
                        + _LEN.pack(len(blobs))]
    for b in blobs:
        parts.append(_LEN.pack(len(b)))
        parts.append(b)

    def send() -> None:
        for p in parts:
            sock.sendall(p)
    if lock is not None:
        with lock:
            send()
    else:
        send()


def recv_msg(sock: socket.socket,
             on_bytes: Optional[Callable[[int], None]] = None
             ) -> Tuple[Header, List[bytearray]]:
    def exact(n):
        return _recv_exact(sock, n, on_bytes)
    n = _LEN.unpack(exact(_LEN.size))[0]
    if n > _MAX_FRAME:
        raise ConnectionError(f"oversized header ({n} bytes)")
    header = json.loads(exact(n))
    k = _LEN.unpack(exact(_LEN.size))[0]
    if k > 1 << 20:
        raise ConnectionError(f"implausible blob count ({k})")
    blobs = []
    for _ in range(k):
        m = _LEN.unpack(exact(_LEN.size))[0]
        if m > _MAX_FRAME:
            raise ConnectionError(f"oversized blob ({m} bytes)")
        blobs.append(exact(m))
    return header, blobs


# ----------------------------------------------------------------------
# Tensor tree <-> (spec, blobs): raw bytes on the wire, bit-exact round trip
# ----------------------------------------------------------------------
def leaf_bytes(t: Any) -> bytes:
    """A leaf's row-major bytes (a tensor is read back to the host)."""
    if isinstance(t, torch.Tensor):
        return t.detach().contiguous().cpu().numpy().tobytes()
    return np.ascontiguousarray(np.asarray(t)).tobytes()


def pack_tree(tree: Any) -> Tuple[List[List], List[bytes]]:
    """Flatten a tree of tensors (or numpy arrays) to ([(keypath, shape,
    dtype)], [raw bytes]) in canonical flatten order — the reference's
    order and ``keystr`` spelling.  The receiving side unpacks against a
    structurally identical skeleton; the spec is carried for
    verification, not reconstruction."""
    spec: List[List] = []
    blobs: List[bytes] = []
    for path, leaf in tree_leaves_with_path(tree):
        raw = leaf_bytes(leaf)
        if isinstance(leaf, torch.Tensor):
            dtype = str(leaf.dtype).replace("torch.", "")
        else:
            dtype = np.asarray(leaf).dtype.name
        spec.append([path, list(leaf.shape), dtype])
        blobs.append(raw)
    return spec, blobs


def unpack_tree(skeleton: Any, spec: Sequence[Sequence],
                blobs: Sequence[bytes], device=None) -> Any:
    """Rebuild a tree of tensors from ``pack_tree`` output.  ``skeleton``
    is any tree with the same structure (tensors, ``meta`` tensors
    included); each leaf's shape and dtype come from the wire spec and
    its key path is cross-checked against the skeleton's.  A leaf lands
    on ``device`` where given, else on its skeleton leaf's device."""
    flat = list(tree_leaves_with_path(skeleton))
    if len(flat) != len(blobs):
        raise ValueError(f"skeleton has {len(flat)} leaves, "
                         f"wire message has {len(blobs)}")
    leaves = []
    for (path, like), (key, shape, dtype), raw in zip(flat, spec, blobs):
        if path != key:
            raise ValueError(f"tree structure mismatch at {key!r} vs "
                             f"{path!r}")
        arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
        if not arr.flags.writeable:
            arr = arr.copy()
        dev = device if device is not None else getattr(like, "device", None)
        t = torch.from_numpy(arr)
        leaves.append(t if dev is None else t.to(dev))
    return tree_unflatten_like(skeleton, leaves)


def pack_batches(per_pipeline: Sequence[Sequence[Dict[str, Any]]]
                 ) -> Tuple[List[List[List]], List[bytes]]:
    """Serialize per-pipeline microbatch lists (the coordinator->worker
    data feed).  Structure rides in the spec — the receiver has no
    skeleton because microbatch counts change every reconfiguration."""
    spec: List[List[List]] = []
    blobs: List[bytes] = []
    for mbs in per_pipeline:
        mspec = []
        for mb in mbs:
            entry = []
            for k in sorted(mb):
                a = np.asarray(mb[k])
                entry.append([k, list(a.shape), a.dtype.name])
                blobs.append(np.ascontiguousarray(a).tobytes())
            mspec.append(entry)
        spec.append(mspec)
    return spec, blobs


def unpack_batches(spec: Sequence[Sequence[Sequence]],
                   blobs: Sequence[bytes]
                   ) -> List[List[Dict[str, np.ndarray]]]:
    it = iter(blobs)
    out: List[List[Dict[str, np.ndarray]]] = []
    for mspec in spec:
        mbs = []
        for entry in mspec:
            mb = {}
            for k, shape, dtype in entry:
                mb[k] = np.frombuffer(next(it), dtype=dtype).reshape(shape)
            mbs.append(mb)
        out.append(mbs)
    return out


# ----------------------------------------------------------------------
# Coordinator side
# ----------------------------------------------------------------------
def member_of(rank: int) -> str:
    return f"proc{rank}"


def rank_of(member: str) -> int:
    assert member.startswith("proc"), member
    return int(member[4:])


class CoordinatorServer:
    """The coordinator's half of the control plane.

    One listening socket; each worker connects once and sends a HELLO.
    Per-worker reader threads then: (a) feed ``beat`` messages — and the
    arrival of any frame's bytes — into the heartbeat tracker, (b) route
    replies to the ``call`` that issued the matching ``req_id``, and (c)
    on socket EOF immediately fence the worker via ``mark_dead`` —
    Oobleck's disconnect-as-failure signal, no timeout needed for a
    SIGKILL.  ``call``/``broadcast_call`` raise ``WorkerLost`` the
    moment a waited-on worker is declared dead, so the training loop
    never hangs on a corpse.  ``slowest_frame[rank]`` keeps the (seconds,
    bytes) of the slowest reply received from each worker.
    """

    def __init__(self, nprocs: int,
                 heartbeat: Optional[HeartbeatConfig] = None,
                 host: str = "127.0.0.1"):
        self.nprocs = nprocs
        self.tracker = HeartbeatTracker(heartbeat or HeartbeatConfig())
        self._listener = socket.create_server((host, 0))
        self.addr: Tuple[str, int] = self._listener.getsockname()[:2]
        self._socks: Dict[int, socket.socket] = {}
        self._send_locks: Dict[int, threading.Lock] = {}
        self._hello: Dict[int, Header] = {}
        self._pending: Dict[str, "queue.Queue"] = {}
        self._req_ids = itertools.count()
        self._closed = False
        self.slowest_frame: Dict[int, Tuple[float, int]] = {}

    # -- bootstrap -----------------------------------------------------
    def accept_workers(self, timeout: float = 120.0) -> Dict[int, Header]:
        """Block until every expected worker has connected and said
        HELLO; returns rank -> hello header (which carries the worker's
        data-server address)."""
        self._listener.settimeout(timeout)
        for _ in range(self.nprocs):
            sock, _ = self._listener.accept()
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            header, _ = recv_msg(sock)
            if header.get("type") != "hello":
                raise ConnectionError(f"expected hello, got {header}")
            rank = int(header["rank"])
            self._socks[rank] = sock
            self._send_locks[rank] = threading.Lock()
            self._hello[rank] = header
            self.tracker.register(member_of(rank))
            threading.Thread(target=self._reader, args=(rank, sock),
                             daemon=True).start()
        return dict(self._hello)

    # -- per-worker reader ---------------------------------------------
    def _reader(self, rank: int, sock: socket.socket) -> None:
        member = member_of(rank)
        started: List[float] = []

        def arriving(n: int) -> None:
            if not started:
                started.append(time.perf_counter())
            self.tracker.beat(member)
        try:
            while True:
                started.clear()
                header, blobs = recv_msg(sock, on_bytes=arriving)
                if header.get("type") == "beat":
                    self.tracker.beat(member)
                    continue
                seconds = time.perf_counter() - started[0]
                if seconds > self.slowest_frame.get(rank, (0.0, 0))[0]:
                    self.slowest_frame[rank] = (
                        seconds, sum(len(b) for b in blobs))
                q = self._pending.get(header.get("req_id"))
                if q is not None:
                    q.put((header, blobs))
        except (ConnectionError, OSError):
            if not self._closed:
                self.tracker.mark_dead(member)

    # -- request/response ----------------------------------------------
    def _new_pending(self) -> Tuple[str, "queue.Queue"]:
        rid = f"c{next(self._req_ids)}"
        q: "queue.Queue" = queue.Queue()
        self._pending[rid] = q
        return rid, q

    def _send(self, rank: int, header: Header, blobs: Blobs) -> None:
        try:
            send_msg(self._socks[rank], header, blobs,
                     lock=self._send_locks[rank])
        except OSError:
            self.tracker.mark_dead(member_of(rank))
            raise WorkerLost([rank], "send failed")

    def _wait(self, rank: int, rid: str, q: "queue.Queue",
              timeout: Optional[float]) -> Tuple[Header, List[bytes]]:
        waited = 0.0
        while True:
            try:
                header, blobs = q.get(timeout=0.1)
                break
            except queue.Empty:
                if self.tracker.status(member_of(rank)) == \
                        HeartbeatTracker.DEAD:
                    raise WorkerLost([rank], "died during call")
                waited += 0.1
                if timeout is not None and waited >= timeout:
                    raise TimeoutError(
                        f"rank {rank} did not answer {rid} "
                        f"within {timeout}s")
        if header.get("status") == "error":
            raise RuntimeError(
                f"rank {rank} raised:\n{header.get('error')}")
        return header, blobs

    def call(self, rank: int, header: Header, blobs: Blobs = (),
             timeout: Optional[float] = None) -> Tuple[Header, List[bytes]]:
        rid, q = self._new_pending()
        try:
            self._send(rank, dict(header, req_id=rid), blobs)
            return self._wait(rank, rid, q, timeout)
        finally:
            self._pending.pop(rid, None)

    def _issue_and_wait(self, requests: Sequence[Tuple[int, Header, Blobs]],
                        timeout: Optional[float]
                        ) -> Tuple[Dict[int, Tuple[Header, List[bytes]]],
                                   List[int]]:
        """All sends first, then all waits: (live replies, lost ranks)."""
        issued: Dict[int, Tuple[str, "queue.Queue"]] = {}
        lost: List[int] = []
        for r, header, blobs in requests:
            rid, q = self._new_pending()
            issued[r] = (rid, q)
            try:
                self._send(r, dict(header, req_id=rid), blobs)
            except WorkerLost:
                lost.append(r)
        results: Dict[int, Tuple[Header, List[bytes]]] = {}
        try:
            for r, (rid, q) in issued.items():
                if r in lost:
                    continue
                try:
                    results[r] = self._wait(r, rid, q, timeout)
                except WorkerLost:
                    lost.append(r)
        finally:
            for rid, _ in issued.values():
                self._pending.pop(rid, None)
        return results, lost

    def broadcast_call(self, header: Header, blobs: Blobs = (),
                       ranks: Optional[Iterable[int]] = None,
                       timeout: Optional[float] = None,
                       strict: bool = True
                       ) -> Dict[int, Tuple[Header, List[bytes]]]:
        """Issue the same request to many workers CONCURRENTLY (all
        sends first, then all waits) — a step's grads phase runs on
        every worker in parallel.  Raises WorkerLost naming every rank
        that died, after collecting all live replies.  With
        ``strict=False`` the live replies are returned instead — the
        step-commit path uses this: survivors that answered HAVE
        committed, so a death mid-commit must not fail the step."""
        ranks = sorted(self._socks) if ranks is None else sorted(ranks)
        results, lost = self._issue_and_wait(
            [(r, header, blobs) for r in ranks], timeout)
        if lost and strict:
            raise WorkerLost(lost, f"during {header.get('type')}")
        return results

    def multi_call(self, requests: Dict[int, Tuple[Header, Blobs]],
                   timeout: Optional[float] = None
                   ) -> Dict[int, Tuple[Header, List[bytes]]]:
        """Like broadcast_call but with a DIFFERENT payload per rank —
        the step's grads phase sends each worker only the microbatches
        of the replicas it leads."""
        results, lost = self._issue_and_wait(
            [(r, h, b) for r, (h, b) in sorted(requests.items())], timeout)
        if lost:
            raise WorkerLost(lost, "during multi_call")
        return results

    def notify(self, rank: int, header: Header, blobs: Blobs = ()) -> None:
        """Fire-and-forget (shutdown etc.); send errors are swallowed —
        a dead worker doesn't need the message."""
        try:
            self._send(rank, header, blobs)
        except WorkerLost:
            pass

    # -- liveness ------------------------------------------------------
    def alive_ranks(self) -> List[int]:
        return sorted(r for r in self._socks
                      if self.tracker.status(member_of(r))
                      != HeartbeatTracker.DEAD)

    def poll_dead(self) -> List[int]:
        """Ranks NEWLY declared dead since the last poll (socket EOF or
        heartbeat silence past the dead_after window)."""
        return sorted(rank_of(m) for m in self.tracker.poll())

    def close(self) -> None:
        self._closed = True
        for sock in self._socks.values():
            try:
                sock.close()
            except OSError:
                pass
        try:
            self._listener.close()
        except OSError:
            pass


# ----------------------------------------------------------------------
# Worker side
# ----------------------------------------------------------------------
class WorkerChannel:
    """The worker's half: one control socket to the coordinator, a beat
    thread (every ``interval`` seconds, under the shared send lock), and
    a blocking ``serve`` loop dispatching coordinator requests to
    handlers.  The serve loop exits on a ``shutdown`` message or socket
    EOF — a worker outliving its coordinator exits instead of spinning."""

    def __init__(self, coordinator: Tuple[str, int], rank: int,
                 hello: Optional[Header] = None,
                 beat_interval: float = 0.5):
        self.rank = rank
        self.sock = socket.create_connection(tuple(coordinator),
                                             timeout=120.0)
        self.sock.settimeout(None)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._send_lock = threading.Lock()
        send_msg(self.sock, dict(hello or {}, type="hello", rank=rank),
                 lock=self._send_lock)
        self._stop = threading.Event()
        threading.Thread(target=self._beat_loop, args=(beat_interval,),
                         daemon=True).start()

    def _beat_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                send_msg(self.sock, {"type": "beat"},
                         lock=self._send_lock)
            except OSError:
                return

    def serve(self, handlers: Dict[str, Callable[[Header, List[bytes]],
                                                 Tuple[Header, Blobs]]]
              ) -> None:
        while True:
            try:
                header, blobs = recv_msg(self.sock)
            except (ConnectionError, OSError):
                return
            kind = header.get("type")
            if kind == "shutdown":
                return
            rid = header.get("req_id")
            try:
                fn = handlers[kind]
                reply, rblobs = fn(header, blobs)
            except Exception:
                reply, rblobs = ({"status": "error",
                                  "error": traceback.format_exc()}, ())
            del header, blobs       # a commit's contributions: free them
            try:
                send_msg(self.sock, dict(reply, req_id=rid), rblobs,
                         lock=self._send_lock)
            except OSError:
                return

    def close(self) -> None:
        self._stop.set()
        try:
            self.sock.close()
        except OSError:
            pass


# ----------------------------------------------------------------------
# Worker <-> worker bulk data plane (recovery state pulls)
# ----------------------------------------------------------------------
class DataServer:
    """Threaded one-request-per-connection TCP server.  Recovery's
    CopyTask streams execute against this: the destination worker
    connects to the source worker's DataServer and pulls the layer
    state as raw bytes.  Runs on its own threads so a worker can SERVE
    state while its control thread is simultaneously PULLING state from
    a peer — the two-phase commit would deadlock otherwise."""

    def __init__(self, handler: Callable[[Header, List[bytes]],
                                         Tuple[Header, Blobs]],
                 host: str = "127.0.0.1"):
        self._handler = handler
        self._listener = socket.create_server((host, 0))
        self.addr: Tuple[str, int] = self._listener.getsockname()[:2]
        self._closed = False
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_one, args=(sock,),
                             daemon=True).start()

    def _serve_one(self, sock: socket.socket) -> None:
        try:
            with sock:
                header, blobs = recv_msg(sock)
                try:
                    reply, rblobs = self._handler(header, blobs)
                except Exception:
                    reply, rblobs = ({"status": "error",
                                      "error": traceback.format_exc()}, ())
                send_msg(sock, reply, rblobs)
        except (ConnectionError, OSError):
            pass

    def close(self) -> None:
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass


def data_call(addr: Sequence, header: Header, blobs: Blobs = (),
              timeout: float = 60.0) -> Tuple[Header, List[bytes]]:
    """One request against a peer's DataServer."""
    host, port = addr[0], int(addr[1])
    with socket.create_connection((host, port), timeout=timeout) as sock:
        send_msg(sock, header, blobs)
        reply, rblobs = recv_msg(sock)
    if reply.get("status") == "error":
        raise RuntimeError(f"data server {host}:{port} raised:\n"
                           f"{reply.get('error')}")
    return reply, rblobs
