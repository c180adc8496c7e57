"""The port's coordination channel (``repro_torch.runtime.coordination``):
every test of tests/test_coordination.py against the port, plus

  * ``pack_tree`` of torch tensors gives the reference's spec and blob
    bytes for the same numpy leaves;
  * a worker whose reply frame takes longer than the dead-after window
    to arrive stays alive while its bytes flow, and is declared dead
    once the channel falls silent.

The wire, the heartbeat state machine and the RPC layer over real
localhost sockets (threads, not processes)."""
import socket
import threading
import time

import numpy as np
import pytest
import torch

from repro.runtime import coordination as jcoord

from repro_torch.ckpt import elect_writer
from repro_torch.core.monitor import HeartbeatConfig, HeartbeatTracker
from repro_torch.runtime.coordination import (CoordinatorServer, DataServer,
                                              WorkerChannel, WorkerLost,
                                              data_call, pack_batches,
                                              pack_tree, recv_msg, send_msg,
                                              unpack_batches, unpack_tree)
from repro_torch.utils.tree import tree_leaves, tree_map


# ----------------------------------------------------------------------
# 1. Wire format
# ----------------------------------------------------------------------
def test_framing_roundtrip_header_and_blobs():
    a, b = socket.socketpair()
    try:
        blobs = [b"", b"x" * 3, np.arange(7, dtype=np.float32).tobytes()]
        send_msg(a, {"type": "t", "k": [1, "two"]}, blobs)
        send_msg(a, {"type": "empty"})
        h1, b1 = recv_msg(b)
        h2, b2 = recv_msg(b)
        assert h1 == {"type": "t", "k": [1, "two"]} and b1 == blobs
        assert h2 == {"type": "empty"} and b2 == []
    finally:
        a.close()
        b.close()


def test_framing_eof_raises_connection_error():
    a, b = socket.socketpair()
    send_msg(a, {"type": "t"})
    a.close()
    h, _ = recv_msg(b)
    assert h["type"] == "t"
    with pytest.raises(ConnectionError):
        recv_msg(b)
    b.close()


def test_pack_tree_roundtrips_bitwise():
    tree = {"p": {"w": torch.linspace(0, 1, 12).reshape(3, 4),
                  "b": torch.arange(3, dtype=torch.int32)},
            "m": {"w": torch.full((3, 4), np.pi),
                  "b": torch.zeros(3)}}
    spec, blobs = pack_tree(tree)
    out = unpack_tree(tree, spec, blobs)
    for x, y in zip(tree_leaves(tree), tree_leaves(out)):
        assert x.numpy().tobytes() == y.numpy().tobytes()
        assert x.dtype == y.dtype and x.device == y.device
    # a meta skeleton (shapes and dtypes only) with an explicit device
    skel = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)
    out = unpack_tree(skel, spec, blobs, device="cpu")
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(tree), tree_leaves(out)))


def test_unpack_tree_rejects_structure_mismatch():
    tree = {"a": torch.zeros(2), "b": torch.ones(2)}
    spec, blobs = pack_tree(tree)
    with pytest.raises(ValueError):
        unpack_tree({"a": tree["a"], "c": tree["b"]}, spec, blobs)
    with pytest.raises(ValueError):
        unpack_tree({"a": tree["a"]}, spec, blobs)


def test_pack_batches_roundtrip():
    per_pipeline = [
        [{"tokens": np.arange(8, dtype=np.int32).reshape(2, 4),
          "labels": np.ones((2, 4), np.int32)} for _ in range(3)],
        [{"tokens": np.zeros((2, 4), np.int32),
          "labels": np.full((2, 4), 7, np.int32)}],
    ]
    spec, blobs = pack_batches(per_pipeline)
    out = unpack_batches(spec, blobs)
    assert len(out) == 2 and [len(p) for p in out] == [3, 1]
    for mbs_in, mbs_out in zip(per_pipeline, out):
        for mi, mo in zip(mbs_in, mbs_out):
            assert sorted(mi) == sorted(mo)
            for k in mi:
                np.testing.assert_array_equal(mi[k], mo[k])


def test_pack_tree_matches_the_jax_package():
    """The same numpy leaves, packed by the reference and (as tensors) by
    the port: the same spec — key paths, shapes, dtype names — and the
    same blob bytes, and each side unpacks the other's message."""
    rng = np.random.default_rng(0)
    leaves = {"p": {"wq": rng.standard_normal((3, 4)).astype(np.float32),
                    "b": np.arange(3, dtype=np.int32)},
              "m": {"wq": rng.standard_normal((3, 4)).astype(np.float32),
                    "b": np.zeros(3, np.float32)},
              "blocks": [rng.standard_normal(5).astype(np.float32),
                         np.float32(2.5)]}
    jspec, jblobs = jcoord.pack_tree(leaves)
    tensors = tree_map(torch.from_numpy, tree_map(np.asarray, leaves))
    spec, blobs = pack_tree(tensors)
    assert spec == jspec
    assert blobs == jblobs
    back = unpack_tree(tensors, jspec, jblobs)
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(tensors), tree_leaves(back)))
    theirs = jcoord.unpack_tree(leaves, spec, blobs)
    import jax
    assert all(np.asarray(x).tobytes() == np.asarray(y).tobytes()
               for x, y in zip(jax.tree.leaves(leaves),
                               jax.tree.leaves(theirs)))


# ----------------------------------------------------------------------
# 2. Heartbeat state machine (injected clock)
# ----------------------------------------------------------------------
def _tracker():
    clock = {"t": 0.0}
    cfg = HeartbeatConfig(interval=0.5, timeout=3.0, backoff=1.0)
    return HeartbeatTracker(cfg, now_fn=lambda: clock["t"]), clock, cfg


def test_heartbeat_alive_suspect_dead_thresholds():
    tr, clock, cfg = _tracker()
    tr.register("w0")
    assert cfg.dead_after == 6.0
    clock["t"] = 3.0
    assert tr.status("w0") == HeartbeatTracker.ALIVE     # silence == timeout
    clock["t"] = 3.01
    assert tr.status("w0") == HeartbeatTracker.SUSPECT
    clock["t"] = 6.0
    assert tr.status("w0") == HeartbeatTracker.SUSPECT   # == dead_after
    clock["t"] = 6.01
    assert tr.status("w0") == HeartbeatTracker.DEAD


def test_heartbeat_beat_resets_silence():
    tr, clock, _ = _tracker()
    tr.register("w0")
    clock["t"] = 2.9
    assert tr.beat("w0")
    clock["t"] = 5.8                        # 2.9s of silence since beat
    assert tr.status("w0") == HeartbeatTracker.ALIVE


def test_heartbeat_poll_reports_each_death_once_and_fences():
    tr, clock, _ = _tracker()
    tr.register("w0")
    tr.register("w1")
    clock["t"] = 1.0
    tr.beat("w1")
    clock["t"] = 6.5                        # w0 silent 6.5s, w1 silent 5.5s
    assert tr.poll() == ["w0"]
    assert tr.poll() == []                  # reported exactly once
    assert tr.beat("w0") is False           # fenced: beat discarded
    assert tr.status("w0") == HeartbeatTracker.DEAD
    clock["t"] = 7.2                        # w1 now past dead_after too
    assert tr.poll() == ["w1"]
    assert tr.alive() == []


def test_heartbeat_mark_dead_is_instant_and_sticky():
    tr, clock, _ = _tracker()
    tr.register("w0")
    tr.mark_dead("w0")                      # socket EOF path: no timeout
    assert tr.status("w0") == HeartbeatTracker.DEAD
    assert tr.beat("w0") is False
    assert tr.poll() == ["w0"]


def test_elect_writer_is_deterministic_min():
    assert elect_writer(["proc2", "proc0", "proc1"]) == "proc0"
    assert elect_writer(["proc1"]) == "proc1"
    with pytest.raises(ValueError):
        elect_writer([])


# ----------------------------------------------------------------------
# 3. RPC over real sockets (threaded workers)
# ----------------------------------------------------------------------
class _ThreadWorker:
    """A WorkerChannel served from a thread — the coordinator cannot
    tell it apart from a real subprocess."""

    def __init__(self, addr, rank, handlers, beat_interval=0.05):
        self.channel = WorkerChannel(addr, rank, hello={"tag": f"w{rank}"},
                                     beat_interval=beat_interval)
        self.thread = threading.Thread(
            target=self.channel.serve, args=(handlers,), daemon=True)
        self.thread.start()


def _echo_handlers(rank):
    def echo(header, blobs):
        return {"rank": rank, "x": header.get("x")}, [b + b"!" for b in blobs]

    def boom(header, blobs):
        raise RuntimeError(f"boom from {rank}")

    return {"echo": echo, "boom": boom}


@pytest.fixture
def cluster():
    server = CoordinatorServer(2, HeartbeatConfig(interval=0.05,
                                                  timeout=0.5, backoff=1.0))
    workers = [_ThreadWorker(server.addr, r, _echo_handlers(r))
               for r in range(2)]
    hellos = server.accept_workers(timeout=10)
    try:
        yield server, workers, hellos
    finally:
        for w in workers:
            w.channel.close()
        server.close()


def test_rpc_call_and_broadcast(cluster):
    server, _, hellos = cluster
    assert {r: h["tag"] for r, h in hellos.items()} == {0: "w0", 1: "w1"}
    h, blobs = server.call(1, {"type": "echo", "x": 5}, [b"ab"], timeout=10)
    assert (h["rank"], h["x"], blobs) == (1, 5, [b"ab!"])
    replies = server.broadcast_call({"type": "echo", "x": 9}, timeout=10)
    assert {r: h["rank"] for r, (h, _) in replies.items()} == {0: 0, 1: 1}


def test_rpc_multi_call_per_rank_payloads(cluster):
    server, _, _ = cluster
    replies = server.multi_call(
        {0: ({"type": "echo", "x": "a"}, [b"0"]),
         1: ({"type": "echo", "x": "b"}, [b"1"])}, timeout=10)
    assert replies[0][0]["x"] == "a" and replies[1][0]["x"] == "b"
    assert replies[0][1] == [b"0!"] and replies[1][1] == [b"1!"]


def test_rpc_remote_exception_carries_traceback(cluster):
    server, _, _ = cluster
    with pytest.raises(RuntimeError, match="boom from 0"):
        server.call(0, {"type": "boom"}, timeout=10)
    # the channel survives a handler error
    h, _ = server.call(0, {"type": "echo", "x": 1}, timeout=10)
    assert h["rank"] == 0


def test_rpc_disconnect_is_instant_failure(cluster):
    server, workers, _ = cluster
    workers[1].channel.close()              # EOF -> mark_dead, no timeout
    with pytest.raises(WorkerLost) as e:
        server.call(1, {"type": "echo"}, timeout=10)
    assert e.value.ranks == [1]
    assert server.poll_dead() == [1]
    assert server.alive_ranks() == [0]
    # strict broadcast names the corpse; lenient returns the survivors
    with pytest.raises(WorkerLost):
        server.broadcast_call({"type": "echo", "x": 2}, timeout=10)
    replies = server.broadcast_call({"type": "echo", "x": 2}, timeout=10,
                                    strict=False)
    assert list(replies) == [0] and replies[0][0]["x"] == 2


def test_data_server_roundtrip_and_error():
    def handler(header, blobs):
        if header.get("x") == "bad":
            raise ValueError("nope")
        return {"ok": True}, [blobs[0] * 2]

    srv = DataServer(handler)
    try:
        h, blobs = data_call(srv.addr, {"type": "get", "x": 1}, [b"ab"])
        assert h["ok"] and blobs == [b"abab"]
        with pytest.raises(RuntimeError, match="nope"):
            data_call(srv.addr, {"type": "get", "x": "bad"}, [b""])
    finally:
        srv.close()


def test_a_slow_reply_frame_is_liveness_and_silence_is_death():
    """A worker's beats queue behind its own reply on the shared socket.
    A raw-socket worker sends no beat at all, only a reply whose bytes
    trickle in over 4x the dead-after window: the call returns it, and
    the worker is declared dead only after the channel falls silent."""
    cfg = HeartbeatConfig(interval=0.05, timeout=0.1, backoff=1.0)
    server = CoordinatorServer(1, cfg)
    sock = socket.create_connection(server.addr)
    try:
        send_msg(sock, {"type": "hello", "rank": 0})
        server.accept_workers(timeout=10)
        blob = bytes(range(256)) * 40

        def slow_reply():
            header, _ = recv_msg(sock)
            frame = socket.socketpair()
            send_msg(frame[0], {"req_id": header["req_id"], "ok": 1}, [blob])
            frame[0].close()
            raw = b""
            while True:
                chunk = frame[1].recv(1 << 16)
                if not chunk:
                    break
                raw += chunk
            frame[1].close()
            pieces = 16
            step = -(-len(raw) // pieces)
            for i in range(0, len(raw), step):      # 16 x 0.05 s = 0.8 s
                sock.sendall(raw[i:i + step])
                time.sleep(0.05)
        t = threading.Thread(target=slow_reply, daemon=True)
        t.start()
        t0 = time.monotonic()
        h, blobs = server.call(0, {"type": "big"}, timeout=10)
        assert time.monotonic() - t0 > 3 * cfg.dead_after    # 0.6 s
        assert h["ok"] == 1 and blobs == [blob]
        assert server.alive_ranks() == [0]
        seconds, nbytes = server.slowest_frame[0]
        assert seconds > 2 * cfg.dead_after and nbytes == len(blob)
        time.sleep(2 * cfg.dead_after)              # silence: no beats
        assert server.poll_dead() == [0]
    finally:
        sock.close()
        server.close()
