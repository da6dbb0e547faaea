"""Cross-process event/cache backend over TCP.

The port's copy of the JAX package's ``srv/broker.py``: host-only, and its
journal lines and wire frames are byte-compatible with the JAX broker's,
so a journal that either broker writes replays in the other.

The in-process ``EventBus``/``SubjectCache`` (srv/events.py, srv/cache.py)
implement the reference's Kafka-topic and Redis-cache ROLES inside one
process.  This module provides the inter-process implementation behind the
same interfaces: a small broker process holds the topic logs (offsets,
replay) and the shared key-value store; workers connect over TCP with
newline-delimited JSON frames.

Mirrors the reference deployment shape (Kafka broker + Redis server as
separate processes, cfg/config.json events.kafka / redis): the HR-scope
rendezvous — request emitted by one process, response produced by another
(reference: src/core/accessController.ts:753-767, src/worker.ts:252-299)
— runs across OS processes (tests/test_torch_broker.py drives it with a
real child process).

Protocol (one JSON object per line):
  {"op": "emit", "topic": t, "event": e, "message": m} -> {"offset": n}
  {"op": "read", "topic": t, "from": n}                -> {"events": [...]}
  {"op": "offset", "topic": t}                          -> {"offset": n}
  {"op": "subscribe", "topic": t, "from": n|null}       -> stream of
      {"topic": t, "event": e, "message": m, "offset": n}   (replay + live)
  {"op": "set"/"get"/"exists"/"evict_prefix", ...}      -> cache ops
  {"op": "offset_commit"/"offset_get", ...}             -> consumer offsets
"""

from __future__ import annotations

import hmac
import json
import os
import queue
import socket
import socketserver
import threading
import time
import zlib
from typing import Any, Callable, Optional

from .faults import REGISTRY as FAULTS


# subscription-stream liveness: how often an idle stream emits a
# heartbeat frame (and thereby notices a dead peer)
HEARTBEAT_INTERVAL = 5.0

# journal line format: "C<crc32 hex8> <json>" — the CRC covers the JSON
# text, so a torn append OR a flipped byte anywhere in the file fails
# closed at replay (the consistent prefix is kept, the rest dropped).
# Bare-JSON lines (pre-CRC journals, seeded journals) replay unchanged.
_CRC_PREFIX_LEN = 10  # "C" + 8 hex + " "


def _journal_line(rec: dict) -> str:
    body = json.dumps(rec)
    return f"C{zlib.crc32(body.encode()) & 0xFFFFFFFF:08x} {body}\n"


def _decode_journal_line(line: str) -> Optional[dict]:
    """One journal line -> record dict, or None when torn/corrupt."""
    if line.startswith("C") and len(line) > _CRC_PREFIX_LEN \
            and line[_CRC_PREFIX_LEN - 1] == " ":
        try:
            want = int(line[1:_CRC_PREFIX_LEN - 1], 16)
        except ValueError:
            return None
        body = line[_CRC_PREFIX_LEN:]
        if zlib.crc32(body.encode()) & 0xFFFFFFFF != want:
            return None
    else:
        body = line
    try:
        rec = json.loads(body)
    except ValueError:
        return None
    return rec if isinstance(rec, dict) else None


def _send(wfile, obj: dict) -> None:
    wfile.write(json.dumps(obj).encode() + b"\n")
    wfile.flush()


class BrokerServer:
    """Topic logs + shared KV + consumer offsets behind one TCP port.

    ``data_dir`` enables durability: every mutation is appended to a
    JSON-lines journal and replayed on construction, so topic logs,
    consumer offsets and the KV store survive broker restarts — the role
    Kafka's commit log and Redis persistence play for the reference
    (src/worker.ts:123,354-361: offsets resumed per topic at subscribe).
    The journal is append-only; it is flushed per record but, by default,
    not fsynced (a broker-process crash loses nothing already flushed;
    only a host-level crash can drop the tail).  ``fsync_interval_s``
    closes that host-crash tail-loss window: when set, the journal is
    additionally fsynced whenever at least that many seconds have passed
    since the last fsync (0 fsyncs every record — Kafka's
    flush.messages=1 posture, at the corresponding write-latency cost).
    None (the default) preserves the flush-only semantics exactly.

    ``secret`` enables authentication: the first frame of every
    connection must be {"op": "auth", "secret": ...} or the connection is
    refused — the deployed-Kafka/Redis auth the reference inherits from
    its infrastructure.  The secret travels as CLEARTEXT JSON over TCP
    (as does all topic/KV traffic): the design assumption is loopback or
    an otherwise-trusted network segment, exactly like an unencrypted
    Kafka/Redis deployment; binding a non-loopback interface logs a
    warning and calls for transport-level protection (TLS tunnel,
    private VPC)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 data_dir: Optional[str] = None,
                 secret: Optional[str] = None,
                 fsync_interval_s: Optional[float] = None,
                 snapshot_every: Optional[int] = None):
        if host not in ("127.0.0.1", "localhost", "::1"):
            import sys as _sys

            print(
                f"WARNING: broker binding non-loopback address {host!r}: "
                "the shared secret and all bus traffic travel as cleartext "
                "TCP — use a TLS tunnel or a trusted network segment",
                file=_sys.stderr,
            )
        self._topics: dict[str, list[tuple[str, Any]]] = {}   # guarded-by: _lock
        self._kv: dict[str, Any] = {}                         # guarded-by: _lock
        self._consumer_offsets: dict[str, int] = {}           # guarded-by: _lock
        self._subscribers: dict[str, list[queue.Queue]] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self.secret = secret
        self._journal = None  # guarded-by: _lock
        self.fsync_interval_s = (
            None if fsync_interval_s is None else float(fsync_interval_s)
        )
        self._last_fsync = 0.0  # guarded-by: _lock
        # snapshot + compaction (docs/FAULTS.md): every `snapshot_every`
        # journaled records the full topic/KV/offset state is written
        # crash-consistently (temp + fsync + rename) at an offset
        # watermark and the journal truncated behind it, so boot-by-
        # replay cost is bounded regardless of churn history.
        self._data_dir = data_dir
        self.snapshot_every = (
            None if not snapshot_every else int(snapshot_every)
        )
        self._watermark = 0       # guarded-by: _lock — records in snapshot
        self._tail_records = 0    # guarded-by: _lock — records since it
        self._snapshot_taken: Optional[float] = None  # guarded-by: _lock
        self.recovered: Optional[dict] = None  # journal-truncation report
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            self._journal_path = os.path.join(data_dir, "broker.journal")
            self._snapshot_path = os.path.join(data_dir, "broker.snapshot")
            self._load_snapshot()
            if os.path.exists(self._journal_path):
                self._replay_journal(self._journal_path)
            self._journal = open(self._journal_path, "a", encoding="utf-8")
        broker = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                authed = broker.secret is None
                for line in self.rfile:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        cmd = json.loads(line)
                    except ValueError:
                        _send(self.wfile, {"error": "bad frame"})
                        continue
                    if not authed:
                        if cmd.get("op") == "auth" and hmac.compare_digest(
                            str(cmd.get("secret") or ""), broker.secret
                        ):
                            authed = True
                            _send(self.wfile, {"ok": True})
                            continue
                        _send(self.wfile, {"error": "auth required"})
                        return
                    if cmd.get("op") == "subscribe":
                        broker._serve_subscription(self, cmd)
                        return  # connection now belongs to the stream
                    try:
                        _send(self.wfile, broker._dispatch(cmd))
                    except (BrokenPipeError, ConnectionResetError):
                        return

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self.address = f"{host}:{self.port}"
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )

    def start(self) -> "BrokerServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        with self._lock:
            if self._journal is not None:
                self._journal.close()
                self._journal = None

    # ----------------------------------------------------------- durability
    # holds: _lock (trivially exclusive: runs in __init__ before the server thread starts)
    def _load_snapshot(self) -> None:
        """Restore topic/KV/offset state from the snapshot file (the
        boot base the journal tail replays on top of).  A corrupt
        snapshot fails closed: ignored, boot falls back to whatever the
        journal holds."""
        path = self._snapshot_path
        if not os.path.exists(path):
            return
        try:
            with open(path, "r", encoding="utf-8") as fh:
                blob = json.load(fh)
            state_json = blob["state"]
            if zlib.crc32(state_json.encode()) & 0xFFFFFFFF != blob["crc"]:
                raise ValueError("snapshot CRC mismatch")
            state = json.loads(state_json)
        except (OSError, ValueError, KeyError, TypeError) as err:
            self.recovered = {"snapshot_error": repr(err)}
            return
        self._topics = {
            t: [(e, m) for e, m in log]
            for t, log in state.get("topics", {}).items()
        }
        self._kv = dict(state.get("kv", {}))
        self._consumer_offsets = dict(state.get("consumer_offsets", {}))
        self._watermark = int(state.get("watermark", 0))
        self._snapshot_taken = time.monotonic()

    # holds: _lock (trivially exclusive: runs in __init__ before the server thread starts)
    def _replay_journal(self, path: str) -> None:
        """Rebuild state from the journal tail (on top of any snapshot).
        The first torn or CRC-corrupt record ends the replay — the
        consistent prefix is kept and the file is truncated there, so a
        crash mid-append or a flipped byte mid-file can never be
        followed by silently re-ordered state."""
        truncate_at: Optional[int] = None
        offset = 0
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line_len = len(line.encode("utf-8"))
                stripped = line.strip()
                if not stripped:
                    offset += line_len
                    continue
                rec = _decode_journal_line(stripped)
                if rec is None or not line.endswith("\n"):
                    truncate_at = offset
                    break
                offset += line_len
                self._apply_record(rec)
                self._tail_records += 1
        if truncate_at is not None:
            size = os.path.getsize(path)
            self.recovered = {
                "truncated_at": truncate_at,
                "dropped_bytes": size - truncate_at,
            }
            with open(path, "r+", encoding="utf-8") as fh:
                fh.truncate(truncate_at)

    def _apply_record(self, rec: dict) -> None:  # holds: _lock
        kind = rec.get("k")
        if kind == "emit":
            self._topics.setdefault(rec["t"], []).append(
                (rec["e"], rec.get("m"))
            )
        elif kind == "set":
            self._kv[rec["key"]] = rec.get("v")
        elif kind == "evict":
            for key in [
                k for k in self._kv if k.startswith(rec["p"])
            ]:
                del self._kv[key]
        elif kind == "co":
            self._consumer_offsets[rec["t"]] = rec["o"]

    def _log(self, rec: dict) -> None:  # holds: _lock
        """Append one journal record; caller holds self._lock."""
        if self._journal is not None:
            payload = _journal_line(rec)
            # failpoints (srv/faults.py): torn truncates the append
            # mid-record (replay CRC catches it); error/delay/hang act
            # as a failing/slow disk
            payload = FAULTS.tear("broker.journal.write", payload)
            self._journal.write(payload)
            self._journal.flush()
            self._tail_records += 1
            if self.fsync_interval_s is not None:
                now = time.monotonic()
                if now - self._last_fsync >= self.fsync_interval_s:
                    FAULTS.fire("broker.journal.fsync")
                    os.fsync(self._journal.fileno())
                    self._last_fsync = now
            if (self.snapshot_every is not None
                    and self._tail_records >= self.snapshot_every):
                self._snapshot_locked()

    def _snapshot_locked(self) -> None:  # holds: _lock
        """Crash-consistent snapshot at the current offset watermark:
        serialize full state, temp + fsync + rename, fsync the
        directory, then truncate the journal behind it.  A crash at ANY
        point leaves either (old snapshot + full journal) or (new
        snapshot + empty-or-newer journal) — never a torn mix."""
        if self._journal is None:
            return
        state = {
            "watermark": self._watermark + self._tail_records,
            "topics": {
                t: [[e, m] for e, m in log]
                for t, log in self._topics.items()
            },
            "kv": self._kv,
            "consumer_offsets": self._consumer_offsets,
        }
        state_json = json.dumps(state, separators=(",", ":"))
        blob = json.dumps({
            "version": 1,
            "crc": zlib.crc32(state_json.encode()) & 0xFFFFFFFF,
            "state": state_json,
        })
        tmp = self._snapshot_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(blob)
            fh.flush()
            # acs-lint: ignore[blocking-under-lock] snapshot atomicity: the
            # journal must stay frozen across the durability point, same
            # trade as the journal fsync itself
            os.fsync(fh.fileno())
        os.replace(tmp, self._snapshot_path)
        try:
            dir_fd = os.open(self._data_dir, os.O_RDONLY)
            try:
                # acs-lint: ignore[blocking-under-lock] see temp-file fsync
                os.fsync(dir_fd)
            finally:
                os.close(dir_fd)
        except OSError:
            pass  # non-POSIX dir-fsync: rename durability is best-effort
        # compaction: the journal restarts empty behind the snapshot
        self._journal.close()
        self._journal = open(self._journal_path, "w", encoding="utf-8")
        self._watermark = state["watermark"]
        self._tail_records = 0
        self._last_fsync = 0.0
        self._snapshot_taken = time.monotonic()

    def snapshot_now(self) -> dict:
        """Force a snapshot (command surface + tests); returns status."""
        with self._lock:
            if self._journal is not None:
                self._snapshot_locked()
        return self.snapshot_status()

    def snapshot_status(self) -> dict:
        with self._lock:
            taken = self._snapshot_taken
            return {
                "exists": bool(
                    self._data_dir
                    and os.path.exists(self._snapshot_path)
                ),
                "watermark": self._watermark,
                "tail_records": self._tail_records,
                "age_s": (None if taken is None
                          else time.monotonic() - taken),
                "recovered": self.recovered,
            }

    # ------------------------------------------------------------- dispatch
    def _dispatch(self, cmd: dict) -> dict:
        op = cmd.get("op")
        if op == "emit":
            topic, event = cmd["topic"], cmd["event"]
            message = cmd.get("message")
            with self._lock:
                log = self._topics.setdefault(topic, [])
                log.append((event, message))
                offset = len(log) - 1
                self._log({"k": "emit", "t": topic, "e": event,
                           "m": message})
                subs = list(self._subscribers.get(topic, []))
            frame = {"topic": topic, "event": event,
                     "message": message, "offset": offset}
            for q in subs:
                q.put(frame)
            return {"offset": offset}
        if op == "read":
            with self._lock:
                log = list(self._topics.get(cmd["topic"], []))
            start = cmd.get("from") or 0
            return {"events": [[e, m] for e, m in log[start:]]}
        if op == "offset":
            with self._lock:
                return {"offset": len(self._topics.get(cmd["topic"], []))}
        if op == "set":
            with self._lock:
                self._kv[cmd["key"]] = cmd.get("value")
                self._log({"k": "set", "key": cmd["key"],
                           "v": cmd.get("value")})
            return {"ok": True}
        if op == "get":
            with self._lock:
                return {"value": self._kv.get(cmd["key"]),
                        "exists": cmd["key"] in self._kv}
        if op == "exists":
            with self._lock:
                return {"exists": cmd["key"] in self._kv}
        if op == "evict_prefix":
            with self._lock:
                keys = [k for k in self._kv if k.startswith(cmd["prefix"])]
                for k in keys:
                    del self._kv[k]
                if keys:
                    self._log({"k": "evict", "p": cmd["prefix"]})
            return {"evicted": len(keys)}
        if op == "offset_commit":
            with self._lock:
                self._consumer_offsets[cmd["topic"]] = cmd["offset"]
                self._log({"k": "co", "t": cmd["topic"],
                           "o": cmd["offset"]})
            return {"ok": True}
        if op == "offset_get":
            with self._lock:
                return {"offset": self._consumer_offsets.get(cmd["topic"])}
        if op == "snapshot_status":
            return self.snapshot_status()
        if op == "snapshot":
            return self.snapshot_now()
        return {"error": f"unknown op {op!r}"}

    def _serve_subscription(self, handler, cmd: dict) -> None:
        """Replay from the requested offset, then stream live frames until
        the client disconnects."""
        topic = cmd["topic"]
        q: queue.Queue = queue.Queue()
        with self._lock:
            log = list(self._topics.get(topic, []))
            self._subscribers.setdefault(topic, []).append(q)
        try:
            start = cmd.get("from")
            if start is not None:
                for offset, (event, message) in list(enumerate(log))[start:]:
                    _send(handler.wfile, {"topic": topic, "event": event,
                                          "message": message,
                                          "offset": offset})
            # live frames for offsets not covered by the replay.  The
            # bounded get + heartbeat keeps dead subscriptions from pinning
            # a thread + queue forever on idle topics: writing the
            # heartbeat to a torn connection raises and the finally block
            # reaps the queue
            replayed_to = len(log)
            while True:
                try:
                    frame = q.get(timeout=HEARTBEAT_INTERVAL)
                except queue.Empty:
                    _send(handler.wfile, {"hb": True})
                    continue
                if frame["offset"] < replayed_to and start is not None:
                    continue  # raced with the replay window
                _send(handler.wfile, frame)
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            with self._lock:
                subs = self._subscribers.get(topic, [])
                if q in subs:
                    subs.remove(q)


class _Rpc:
    """One request/response connection, serialized by a lock."""

    def __init__(self, address: str, secret: Optional[str] = None):
        host, port = address.rsplit(":", 1)
        self._sock = socket.create_connection((host, int(port)), timeout=30)
        self._rfile = self._sock.makefile("rb")
        self._wfile = self._sock.makefile("wb")
        self._lock = threading.Lock()
        if secret is not None:
            resp = self.call({"op": "auth", "secret": secret})
            if not resp.get("ok"):
                self.close()
                raise ConnectionError(
                    f"broker auth failed: {resp.get('error', 'rejected')}"
                )

    def call(self, obj: dict) -> dict:
        with self._lock:
            _send(self._wfile, obj)
            line = self._rfile.readline()
        if not line:
            raise ConnectionError("broker connection closed")
        resp = json.loads(line)
        if resp.get("error") == "auth required":
            raise ConnectionError(
                "broker auth required: configure events:broker:secret"
            )
        return resp

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


# subscription reconnect: jittered exponential backoff bounds (seconds).
# The pump retries forever — a broker restart mid-deployment must never
# silently end a replica's CRUD subscription (the policy-replication feed).
RECONNECT_BACKOFF_MIN = 0.05
RECONNECT_BACKOFF_MAX = 2.0


class SocketTopic:
    """Topic interface (srv/events.py) backed by the broker."""

    def __init__(self, name: str, address: str, rpc: _Rpc,
                 secret: Optional[str] = None):
        self.name = name
        self._address = address
        self._rpc = rpc
        self._secret = secret
        self._streams: list[socket.socket] = []
        self._closed = threading.Event()

    @property
    def offset(self) -> int:
        return self._rpc.call({"op": "offset", "topic": self.name})["offset"]

    def emit(self, event_name: str, message: Any) -> int:
        return self._rpc.call(
            {"op": "emit", "topic": self.name,
             "event": event_name, "message": message}
        )["offset"]

    def _open_stream(self, from_offset: Optional[int]):
        """One subscription connection: auth + subscribe handshake, returns
        (socket, rfile).  Raises on any connection/auth failure."""
        host, port = self._address.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)))
        wfile = sock.makefile("wb")
        rfile = sock.makefile("rb")
        if self._secret is not None:
            _send(wfile, {"op": "auth", "secret": self._secret})
            resp = json.loads(rfile.readline() or b"{}")
            if not resp.get("ok"):
                sock.close()
                raise ConnectionError("broker auth failed for subscription")
        _send(wfile, {"op": "subscribe", "topic": self.name,
                      "from": from_offset})
        return sock, rfile

    def on(
        self,
        listener: Callable[[str, Any, dict], None],
        starting_offset: Optional[int] = None,
    ) -> None:
        """Each listener gets its own streaming connection (replay from
        ``starting_offset``, then live), dispatched from a daemon thread —
        the Kafka-consumer analog of the in-process synchronous fanout.

        The pump survives broker restarts: on a dropped connection it
        reconnects with jittered exponential backoff and resubscribes from
        the offset AFTER the last frame it delivered, so no acked frame is
        redelivered and no frame emitted during the outage is lost (the
        broker's journal preserves the log across restarts).  A listener
        subscribed live-only (``starting_offset=None``) that has not yet
        seen a frame resumes from the topic head at reconnect time."""
        sock, rfile = self._open_stream(starting_offset)
        self._streams.append(sock)
        # mutable last-delivered offset, shared with close(): -1 = nothing
        # delivered yet
        state = {"last": (starting_offset - 1
                          if starting_offset is not None else -1)}

        def pump():
            import random as _random
            import time as _time

            nonlocal sock, rfile
            backoff = RECONNECT_BACKOFF_MIN
            while not self._closed.is_set():
                try:
                    for line in rfile:
                        frame = json.loads(line)
                        if "hb" in frame:  # liveness probe, not an event
                            continue
                        # failpoint: a dropped/slow subscription — error
                        # takes the exact reconnect path a real torn
                        # connection would (OSError below)
                        FAULTS.fire(
                            "broker.topic.pump",
                            exc=lambda: OSError(
                                "fault injected at broker.topic.pump"
                            ),
                        )
                        listener(
                            frame["event"], frame["message"],
                            {"offset": frame["offset"], "topic": self.name},
                        )
                        state["last"] = frame["offset"]
                        backoff = RECONNECT_BACKOFF_MIN
                    # EOF: broker closed the stream (restart/shutdown)
                except (OSError, ValueError):
                    pass
                if self._closed.is_set():
                    return
                # reconnect loop: resume from the frame after the last
                # delivered one (live-only streams that never saw a frame
                # resume live — from=None)
                while not self._closed.is_set():
                    _time.sleep(backoff * (1.0 + _random.random()))
                    backoff = min(backoff * 2.0, RECONNECT_BACKOFF_MAX)
                    try:
                        resume = (state["last"] + 1
                                  if state["last"] >= 0 else starting_offset)
                        new_sock, new_rfile = self._open_stream(resume)
                    except (OSError, ConnectionError, ValueError):
                        continue
                    if sock in self._streams:
                        self._streams.remove(sock)
                    sock, rfile = new_sock, new_rfile
                    self._streams.append(sock)
                    break

        threading.Thread(target=pump, daemon=True).start()

    def read(self, from_offset: int = 0) -> list[tuple[str, Any]]:
        events = self._rpc.call(
            {"op": "read", "topic": self.name, "from": from_offset}
        )["events"]
        return [(e, m) for e, m in events]

    def close(self) -> None:
        # stop pumps from reconnecting before tearing their connections
        self._closed.set()
        for sock in list(self._streams):
            # shutdown, not just close: the pump thread's makefile objects
            # hold fd references (socket._io_refs), so close() alone never
            # tears the connection — the broker would keep heartbeating a
            # zombie stream and the pump thread would block forever
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass


class SocketEventBus:
    """EventBus interface (srv/events.py) backed by a broker process."""

    def __init__(self, address: str, secret: Optional[str] = None):
        self.address = address
        self._secret = secret
        self._rpc = _Rpc(address, secret=secret)
        self._topics: dict[str, SocketTopic] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def topic(self, name: str) -> SocketTopic:
        with self._lock:
            if name not in self._topics:
                self._topics[name] = SocketTopic(
                    name, self.address, self._rpc, secret=self._secret
                )
            return self._topics[name]

    def topics(self) -> dict[str, SocketTopic]:
        with self._lock:
            return dict(self._topics)

    def snapshot_status(self) -> dict:
        return self._rpc.call({"op": "snapshot_status"})

    def snapshot(self) -> dict:
        """Force a broker snapshot + journal compaction now."""
        return self._rpc.call({"op": "snapshot"})

    def close(self) -> None:
        with self._lock:
            topics = list(self._topics.values())
        for topic in topics:
            topic.close()
        self._rpc.close()


class SocketSubjectCache:
    """SubjectCache interface (srv/cache.py) backed by the broker KV —
    the shared-Redis role: every worker process sees the same subject /
    HR-scope entries."""

    def __init__(self, address: str, secret: Optional[str] = None):
        self._rpc = _Rpc(address, secret=secret)

    def get(self, key: str) -> Any:
        return self._rpc.call({"op": "get", "key": key})["value"]

    def set(self, key: str, value: Any) -> None:
        self._rpc.call({"op": "set", "key": key, "value": value})

    def exists(self, key: str) -> bool:
        return self._rpc.call({"op": "exists", "key": key})["exists"]

    def evict_prefix(self, prefix: str) -> int:
        return self._rpc.call(
            {"op": "evict_prefix", "prefix": prefix}
        )["evicted"]

    def close(self) -> None:
        self._rpc.close()


class SocketOffsetStore:
    """OffsetStore interface (srv/events.py) on the broker (the chassis
    Redis DB-0 role)."""

    def __init__(self, address: str, secret: Optional[str] = None):
        self._rpc = _Rpc(address, secret=secret)

    def commit(self, topic: str, offset: int) -> None:
        self._rpc.call(
            {"op": "offset_commit", "topic": topic, "offset": offset}
        )

    def get(self, topic: str) -> Optional[int]:
        return self._rpc.call({"op": "offset_get", "topic": topic})["offset"]

    def close(self) -> None:
        self._rpc.close()
