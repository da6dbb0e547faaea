"""Cluster router: one gRPC front door over N worker replicas.

The port's copy of the JAX package's ``srv/router.py``: it proxies raw
bytes, so it routes port replicas (each answering from its own CUDA
device) as the JAX router routes JAX replicas.

Pod-scale serving tier (docs/CLUSTER.md): each replica is a full Worker
process serving the same policy state (converging through the broker's
journaled CRUD topics + srv/store.PolicyReplicator), and the router
load-balances every unary call AND whole IsAllowedStream streams across
them:

* **Pick**: least-inflight among healthy, non-draining replicas whose
  per-replica circuit breaker (srv/admission.CircuitBreaker) admits the
  call.  No eligible replica -> honest UNAVAILABLE, never a fabricated
  decision.
* **Retry**: a transport failure or a whole-request shed (the replica's
  ``x-acs-shed`` trailer, srv/transport_grpc.stamp_trailers) retries on
  a different replica while deadline budget remains — shed work migrates
  instead of failing, mirroring the admission tier's honest-degradation
  ladder.
* **Streams**: one replica serves a stream; response frame i answers
  request frame i, so on mid-stream failure only the unanswered frame
  tail replays on another replica and the client sees an unbroken
  response sequence.
* **Epochs**: every response trailer carries the replica's policy epoch
  (count of CRUD log frames reflected in its serving tree); the router
  tracks per-replica epochs from live traffic plus a background health
  poll — the cluster's convergence dashboard (``cluster_status``).
* **Drain**: ``cluster_drain`` marks a replica draining (no new calls,
  in-flight finishes); ``cluster_undrain`` reverses it.  Both are
  router-level commands intercepted from the ordinary CommandInterface
  wire surface; every other command forwards to a replica.
"""

from __future__ import annotations

# host only: the router proxies raw bytes between processes and never
# pulls the device runtime into its address space

import json
import threading
import time
from collections import deque
from concurrent import futures
from typing import Optional

import grpc

from .admission import CircuitBreaker
from .faults import REGISTRY as FAULTS
from .gen import access_control_pb2 as pb
from .telemetry import Histogram
from .transport_grpc import (
    _MESSAGE_SIZE_OPTIONS,
    POLICY_EPOCH_METADATA_KEY,
    SHED_METADATA_KEY,
)

# CommandInterface methods intercepted at the router (all other methods
# proxy through untouched)
_COMMAND_METHODS = (
    "/acstpu.CommandInterface/Command",
    "/io.restorecommerce.commandinterface.CommandInterfaceService/Command",
)
_STREAM_SUFFIX = "/IsAllowedStream"

_identity = lambda raw: raw  # noqa: E731 — raw-bytes pass-through


class _InjectedUnavailable(grpc.RpcError):
    """Failpoint stand-in for a replica transport failure: quacks like a
    grpc.RpcError so the router's retry/exclusion path treats it exactly
    like a real wire error."""

    def code(self):
        return grpc.StatusCode.UNAVAILABLE

    def details(self):
        return "fault injected at router.proxy"


def _deadline_budget(context) -> Optional[float]:
    """Seconds left on the caller's deadline, or None when unbounded.
    grpc reports "no deadline" as an int64-max sentinel (the same one
    srv/admission.deadline_from_context guards) — forwarding it as a
    ``timeout=`` overflows grpc's own deadline math into an instant
    DEADLINE_EXCEEDED, so anything implausibly large means None."""
    try:
        remaining = context.time_remaining()
    except Exception:  # noqa: BLE001 — non-grpc test doubles
        return None
    if remaining is None or remaining > 3.15e8:  # ~10 years
        return None
    return remaining


def _trailer_map(trailers) -> dict:
    out = {}
    for key, value in trailers or ():
        out[str(key).lower()] = value
    return out


class ReplicaHandle:
    """Router-side state for one replica: channel, breaker, drain flag,
    inflight gauge, last observed policy epoch."""

    def __init__(self, addr: str, breaker_cfg: dict | None = None):
        self.addr = addr
        self.channel = grpc.insecure_channel(
            addr, options=_MESSAGE_SIZE_OPTIONS
        )
        self.breaker = CircuitBreaker(
            f"replica-{addr}", **(breaker_cfg or {})
        )
        self.healthy = True
        self.draining = False
        self.inflight = 0
        self.policy_epoch = -1
        # pod-sharded replicas (parallel/pod_shard.py) report a combined
        # pod fingerprint through program_identity; the router tracks it
        # per replica so cluster_status exposes shard-level convergence
        self.pod_fingerprint = None
        # multi-tenant replicas (srv/tenancy.py) report a tenancy block
        # through program_identity; the router tracks tenant count and
        # the per-tenant epoch digest so cluster_status exposes
        # tenant-level convergence across replicas
        self.tenancy = None
        self.last_seen = 0.0
        self.calls = 0
        self.failures = 0
        self.sheds = 0
        self.retries_absorbed = 0  # calls this replica served on retry

    def observe_trailers(self, trailers) -> bool:
        """Update epoch from a response's trailing metadata; True when
        the response was a whole-request shed."""
        md = _trailer_map(trailers)
        epoch = md.get(POLICY_EPOCH_METADATA_KEY)
        if epoch is not None:
            try:
                self.policy_epoch = max(self.policy_epoch, int(epoch))
            except (TypeError, ValueError):
                pass
        self.last_seen = time.monotonic()
        return md.get(SHED_METADATA_KEY) == "1"

    def snapshot(self) -> dict:
        return {
            "addr": self.addr,
            "healthy": self.healthy,
            "draining": self.draining,
            "inflight": self.inflight,
            "policy_epoch": self.policy_epoch,
            "pod_fingerprint": self.pod_fingerprint,
            "tenancy": self.tenancy,
            "breaker": self.breaker.state,
            "calls": self.calls,
            "failures": self.failures,
            "sheds": self.sheds,
            "retries_absorbed": self.retries_absorbed,
        }


class ClusterRouter:
    """gRPC server proxying every service the replicas expose.

    ``replica_addrs`` are ``host:port`` strings of running worker
    transports (parallel/cluster.LocalCluster spawns them).  The router
    never parses decision payloads — handlers are raw-bytes in/out, so
    proxy overhead is routing + one extra hop, not re-serialization."""

    def __init__(self, replica_addrs, addr: str = "127.0.0.1:0",
                 cfg: dict | None = None, max_workers: int = 32,
                 logger=None):
        cfg = cfg or {}
        self.logger = logger
        self._lock = threading.Lock()
        breaker_cfg = cfg.get("breaker") or {}
        self.replicas = [  # guarded-by: _lock
            ReplicaHandle(a, breaker_cfg) for a in replica_addrs
        ]
        self.health_interval_s = float(cfg.get("health_interval_s", 1.0))
        self.retry_budget_fraction = float(
            cfg.get("retry_budget_fraction", 0.2)
        )
        self.max_retries = int(cfg.get("max_retries", 1))
        self.overhead = Histogram()  # router-added seconds per unary call
        self.retries = 0     # guarded-by: _lock
        self.unroutable = 0  # guarded-by: _lock
        self._rr = 0  # round-robin cursor for inflight ties  # guarded-by: _lock
        self._stop = threading.Event()
        self._executor = futures.ThreadPoolExecutor(max_workers=max_workers)
        self.server = grpc.server(self._executor,
                                  options=_MESSAGE_SIZE_OPTIONS)
        self.server.add_generic_rpc_handlers((_ProxyHandler(self),))
        self.port = self.server.add_insecure_port(addr)
        self.addr = addr.rsplit(":", 1)[0] + f":{self.port}"
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True
        )

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "ClusterRouter":
        self.server.start()
        self._health_thread.start()
        return self

    def stop(self, grace: float = 0.5) -> None:
        self._stop.set()
        # the server's handler threads end with it (grpc leaves its
        # executor's threads alive otherwise); once every handler has
        # terminated the join is immediate
        stopped = self.server.stop(grace).wait(grace + 5.0)
        self._executor.shutdown(wait=stopped)
        with self._lock:
            replicas = list(self.replicas)
        for replica in replicas:
            try:
                replica.channel.close()
            except Exception:  # noqa: BLE001
                pass
        # a poll in flight ends with its closed channel
        if self._health_thread.is_alive():
            self._health_thread.join(timeout=self.health_interval_s + 5.0)

    def add_replica(self, addr: str,
                    breaker_cfg: dict | None = None) -> ReplicaHandle:
        """Register a replica that joined after router start (a restarted
        chaos victim re-registers under its new port)."""
        handle = ReplicaHandle(addr, breaker_cfg)
        with self._lock:
            self.replicas.append(handle)
        return handle

    def remove_replica(self, addr: str) -> int:
        """Deregister a replica (a killed process whose port will never
        answer again); returns how many handles matched."""
        with self._lock:
            removed = [r for r in self.replicas if r.addr == addr]
            self.replicas = [r for r in self.replicas if r.addr != addr]
        for replica in removed:
            try:
                replica.channel.close()
            except Exception:  # noqa: BLE001
                pass
        return len(removed)

    # -------------------------------------------------------------- health

    def _health_loop(self) -> None:
        while not self._stop.wait(self.health_interval_s):
            # acs-lint: ignore[guarded-by] benign racy snapshot: add/remove
            # REBIND self.replicas (never mutate in place), so list() over
            # the old reference iterates a consistent replica set
            for replica in list(self.replicas):
                self._poll(replica)

    def _poll(self, replica: ReplicaHandle) -> None:
        try:
            raw = pb.CommandRequest(name="program_identity")
            fn = replica.channel.unary_unary(
                "/acstpu.CommandInterface/Command",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=pb.CommandResponse.FromString,
            )
            resp = fn(raw, timeout=max(0.5, self.health_interval_s))
            payload = json.loads(resp.payload or b"{}")
            epoch = payload.get("policy_epoch")
            if isinstance(epoch, int):
                replica.policy_epoch = max(replica.policy_epoch, epoch)
            sharding = payload.get("sharding")
            if isinstance(sharding, dict):
                replica.pod_fingerprint = sharding.get("pod_fingerprint")
            tenancy = payload.get("tenancy")
            if isinstance(tenancy, dict):
                replica.tenancy = tenancy
            replica.last_seen = time.monotonic()
            replica.healthy = True
        except Exception:  # noqa: BLE001 — an unreachable replica
            replica.healthy = False

    # ---------------------------------------------------------------- pick

    def _pick(self, excluded=()) -> Optional[ReplicaHandle]:
        """Least-inflight healthy, non-draining replica whose breaker
        admits the call; ties rotate round-robin so sequential traffic
        (inflight always 0 at pick time) still spreads across replicas.
        Half-open breakers hand out probe slots through ``allow()``, so
        the caller MUST report the outcome."""
        with self._lock:
            candidates = [
                r for r in self.replicas
                if r not in excluded and r.healthy and not r.draining
            ]
            if candidates:
                self._rr = (self._rr + 1) % len(candidates)
                candidates = (
                    candidates[self._rr:] + candidates[:self._rr]
                )
            # stable sort: rotation order survives among inflight ties
            candidates.sort(key=lambda r: r.inflight)
        for replica in candidates:
            if replica.breaker.allow():
                with self._lock:
                    replica.inflight += 1
                    replica.calls += 1
                return replica
        return None

    def _release(self, replica: ReplicaHandle) -> None:
        with self._lock:
            replica.inflight = max(0, replica.inflight - 1)

    # --------------------------------------------------------------- unary

    def _proxy_unary(self, method: str, raw: bytes, context):
        t0 = time.perf_counter()
        deadline_s = _deadline_budget(context)
        metadata = tuple(context.invocation_metadata() or ())
        excluded: list[ReplicaHandle] = []
        attempts = 0
        last_shed_payload = None
        last_error: Optional[grpc.RpcError] = None
        backend_s = 0.0
        while attempts <= self.max_retries:
            attempts += 1
            replica = self._pick(excluded)
            if replica is None:
                break
            remaining = None
            if deadline_s is not None:
                remaining = deadline_s - (time.perf_counter() - t0)
                if remaining <= 0:
                    self._release(replica)
                    replica.breaker.record_success()
                    context.abort(
                        grpc.StatusCode.DEADLINE_EXCEEDED,
                        "deadline exhausted at router",
                    )
            fn = replica.channel.unary_unary(
                method,
                request_serializer=_identity,
                response_deserializer=_identity,
            )
            t_call = time.perf_counter()
            try:
                # failpoint (srv/faults.py): replica hop — error takes the
                # real retry/exclusion path below, like a wire failure
                FAULTS.fire("router.proxy", exc=_InjectedUnavailable)
                payload, call = fn.with_call(
                    raw, metadata=metadata, timeout=remaining
                )
            except grpc.RpcError as err:
                backend_s += time.perf_counter() - t_call
                self._release(replica)
                replica.breaker.record_failure()
                with self._lock:
                    replica.failures += 1
                last_error = err
                excluded.append(replica)
                if not self._retry_ok(t0, deadline_s):
                    break
                with self._lock:
                    self.retries += 1
                continue
            backend_s += time.perf_counter() - t_call
            self._release(replica)
            replica.breaker.record_success()
            trailers = call.trailing_metadata()
            shed = replica.observe_trailers(trailers)
            if shed:
                with self._lock:
                    replica.sheds += 1
                last_shed_payload = (payload, trailers)
                excluded.append(replica)
                if not self._retry_ok(t0, deadline_s):
                    break
                with self._lock:
                    self.retries += 1
                continue
            if attempts > 1:
                with self._lock:
                    replica.retries_absorbed += 1
            try:
                context.set_trailing_metadata(trailers)
            except Exception:  # noqa: BLE001
                pass
            self.overhead.observe(
                time.perf_counter() - t0 - backend_s
            )
            return payload
        # exhausted: an honest shed beats a fabricated failure; a
        # transport error propagates its own status; nothing at all is
        # UNAVAILABLE
        self.overhead.observe(time.perf_counter() - t0 - backend_s)
        if last_shed_payload is not None:
            payload, trailers = last_shed_payload
            try:
                context.set_trailing_metadata(trailers)
            except Exception:  # noqa: BLE001
                pass
            return payload
        with self._lock:
            self.unroutable += 1
        if last_error is not None:
            context.abort(
                last_error.code() or grpc.StatusCode.UNAVAILABLE,
                f"all replicas failed: {last_error.details()}",
            )
        context.abort(
            grpc.StatusCode.UNAVAILABLE,
            "no eligible replica (all draining, unhealthy or "
            "breaker-open)",
        )

    def _retry_ok(self, t0: float, deadline_s: Optional[float]) -> bool:
        if deadline_s is None:
            return True
        remaining = deadline_s - (time.perf_counter() - t0)
        return remaining > deadline_s * self.retry_budget_fraction

    # -------------------------------------------------------------- stream

    def _proxy_stream(self, method: str, request_iterator, context):
        """Proxy one IsAllowedStream: a feeder thread owns the client's
        request iterator and lands frames on a shared deque; per attempt,
        a pump thread moves frames shared -> per-attempt queue, recording
        each frame in ``pending`` BEFORE handing it to grpc — so a frame
        a dying attempt pulled but never answered is still replayed, and
        the dead attempt's grpc consumer thread can never swallow one.
        Response frame i answers request frame i, so after a failure only
        ``pending`` (the unanswered tail, in order) replays elsewhere."""
        import queue as _queue

        metadata = tuple(context.invocation_metadata() or ())
        deadline_s = _deadline_budget(context)
        t0 = time.perf_counter()
        shared: deque = deque()
        shared_cv = threading.Condition()
        feed_done = threading.Event()
        feed_error: list = []

        def feed():
            try:
                for raw in request_iterator:
                    with shared_cv:
                        shared.append(raw)
                        shared_cv.notify_all()
            except BaseException as err:  # noqa: BLE001 — client abort
                feed_error.append(err)
            feed_done.set()
            with shared_cv:
                shared_cv.notify_all()

        threading.Thread(target=feed, daemon=True).start()

        pending: deque = deque()  # sent-but-unanswered frames, in order
        pending_lock = threading.Lock()
        excluded: list[ReplicaHandle] = []

        while True:
            replica = self._pick(excluded)
            if replica is None:
                context.abort(
                    grpc.StatusCode.UNAVAILABLE,
                    "no eligible replica for stream",
                )
            attempt_q: "_queue.Queue" = _queue.Queue()
            stop_pump = threading.Event()

            def pump(q=attempt_q, stop=stop_pump):
                # replay the unanswered tail first, then live frames
                with pending_lock:
                    replay = list(pending)
                for raw in replay:
                    q.put(raw)
                while not stop.is_set():
                    with shared_cv:
                        while not shared and not feed_done.is_set() \
                                and not stop.is_set():
                            shared_cv.wait(0.05)
                        if stop.is_set():
                            return
                        if not shared:
                            if feed_done.is_set():
                                q.put(None)
                                return
                            continue
                        raw = shared.popleft()
                    with pending_lock:
                        pending.append(raw)
                    if stop.is_set():
                        # attempt died between popleft and send: the
                        # frame is in pending, the next attempt replays
                        # it — never lost, never double-answered
                        return
                    q.put(raw)

            pump_thread = threading.Thread(target=pump, daemon=True)
            pump_thread.start()

            def gen(q=attempt_q):
                while True:
                    item = q.get()
                    if item is None:
                        return
                    yield item

            fn = replica.channel.stream_stream(
                method,
                request_serializer=_identity,
                response_deserializer=_identity,
            )
            remaining = None
            if deadline_s is not None:
                remaining = max(
                    0.001, deadline_s - (time.perf_counter() - t0)
                )
            call = fn(gen(), metadata=metadata, timeout=remaining)
            try:
                for payload in call:
                    with pending_lock:
                        if pending:
                            pending.popleft()
                    yield payload
                # backend stream completed: propagate its trailers
                # (policy epoch) and finish
                replica.observe_trailers(call.trailing_metadata())
                replica.breaker.record_success()
                self._release(replica)
                stop_pump.set()
                try:
                    context.set_trailing_metadata(
                        call.trailing_metadata()
                    )
                except Exception:  # noqa: BLE001
                    pass
                if feed_error and not isinstance(
                    feed_error[0], StopIteration
                ):
                    raise feed_error[0]
                return
            except grpc.RpcError:
                stop_pump.set()
                call.cancel()
                self._release(replica)
                replica.breaker.record_failure()
                with self._lock:
                    replica.failures += 1
                    self.retries += 1
                excluded.append(replica)
                pump_thread.join(timeout=1.0)
                # next attempt replays pending then resumes live frames
                continue
            except BaseException:
                # client-side cancellation / generator close: tear down
                # the backend attempt and give up the slot
                stop_pump.set()
                call.cancel()
                self._release(replica)
                replica.breaker.record_success()
                raise

    # ------------------------------------------------------------ commands

    def _proxy_command(self, method: str, raw: bytes, context):
        try:
            request = pb.CommandRequest.FromString(raw)
        except Exception:  # noqa: BLE001 — undecodable: just forward
            return self._proxy_unary(method, raw, context)
        if request.name == "cluster_status":
            return pb.CommandResponse(
                payload=json.dumps(self.status()).encode()
            ).SerializeToString()
        if request.name in ("cluster_drain", "cluster_undrain"):
            payload = {}
            if request.payload:
                try:
                    payload = json.loads(request.payload)
                except ValueError:
                    payload = {}
            result = self.set_drain(
                payload.get("addr"), request.name == "cluster_drain"
            )
            return pb.CommandResponse(
                payload=json.dumps(result).encode()
            ).SerializeToString()
        return self._proxy_unary(method, raw, context)

    def set_drain(self, addr: Optional[str], draining: bool) -> dict:
        matched = []
        with self._lock:
            for replica in self.replicas:
                if addr is None or replica.addr == addr:
                    replica.draining = draining
                    matched.append(replica.addr)
        if not matched:
            return {"error": f"no replica {addr!r}"}
        return {
            "status": "draining" if draining else "serving",
            "replicas": matched,
        }

    def status(self) -> dict:
        with self._lock:
            replicas = [r.snapshot() for r in self.replicas]
            retries = self.retries
            unroutable = self.unroutable
        epochs = [r["policy_epoch"] for r in replicas]
        pod_fps = {
            r["pod_fingerprint"] for r in replicas
            if r.get("pod_fingerprint") is not None
        }
        tenancy_blocks = [
            r["tenancy"] for r in replicas
            if isinstance(r.get("tenancy"), dict)
        ]
        tenant_digests = {
            b.get("epoch_digest") for b in tenancy_blocks
            if b.get("epoch_digest") is not None
        }
        snap = self.overhead.snapshot()
        out = {
            "addr": self.addr,
            "replicas": replicas,
            "converged": len(set(epochs)) <= 1,
            # pod-sharded replicas only: every replica reporting a pod
            # fingerprint holds byte-identical per-shard tables
            "pod_converged": len(pod_fps) <= 1,
            "min_epoch": min(epochs) if epochs else None,
            "max_epoch": max(epochs) if epochs else None,
            "retries": retries,
            "unroutable": unroutable,
            "router_overhead": {
                "count": snap["count"],
                "p50_ms": round(snap["p50_s"] * 1e3, 3)
                if snap["p50_s"] is not None else None,
                "p99_ms": round(snap["p99_s"] * 1e3, 3)
                if snap["p99_s"] is not None else None,
            },
        }
        if tenancy_blocks:
            # tenant-level convergence: every replica reporting a tenancy
            # block holds identical per-tenant epochs (blake2b digest over
            # the sorted tenant->epoch map, srv/tenancy.py epoch_digest)
            out["tenancy"] = {
                "replicas_reporting": len(tenancy_blocks),
                "tenant_count": max(
                    (b.get("tenant_count") or 0) for b in tenancy_blocks
                ),
                "tenant_converged": len(tenant_digests) <= 1,
            }
        return out


class _ProxyHandler(grpc.GenericRpcHandler):
    """Routes every incoming method to the matching proxy path: stream
    methods to the stream proxy, CommandInterface to the intercepting
    command proxy, everything else to the unary proxy — all raw bytes."""

    def __init__(self, router: ClusterRouter):
        self.router = router

    def service(self, handler_call_details):
        method = handler_call_details.method
        if method.endswith(_STREAM_SUFFIX):
            return grpc.stream_stream_rpc_method_handler(
                lambda it, ctx: self.router._proxy_stream(method, it, ctx),
                request_deserializer=_identity,
                response_serializer=_identity,
            )
        if method in _COMMAND_METHODS:
            return grpc.unary_unary_rpc_method_handler(
                lambda raw, ctx: self.router._proxy_command(
                    method, raw, ctx
                ),
                request_deserializer=_identity,
                response_serializer=_identity,
            )
        return grpc.unary_unary_rpc_method_handler(
            lambda raw, ctx: self.router._proxy_unary(method, raw, ctx),
            request_deserializer=_identity,
            response_serializer=_identity,
        )
