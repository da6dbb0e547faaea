"""Identity-service client interface.

The port's copy of the JAX package's ``srv/identity.py`` (host only).
``grpc`` and the generated ``srv/gen/access_control_pb2`` are imported
inside the gRPC classes only, so the rest of this module (and the port)
imports without them.

The reference resolves subject tokens through an external identity service
(``findByToken`` over gRPC, reference: src/worker.ts:135-143,
src/core/accessController.ts:110-117).  The engine only needs the
``find_by_token`` call; deployments plug a transport-backed client, tests
plug a static map (the mock-IDS pattern from
test/microservice_acs_enabled.spec.ts:106-223).
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Optional, Protocol


class IdentityClient(Protocol):
    def find_by_token(self, token: str) -> Optional[dict]:
        """Returns ``{"payload": {"id", "tokens", "role_associations", ...}}``
        or None."""
        ...


class TokenResolutionCache:
    """TTL'd token -> resolution-envelope cache with negative-result caching.

    Entries are whole ``find_by_token`` envelopes (``{"payload", "status"}``).
    Positive resolutions live ``ttl_s``; *definitive* negatives (payload None
    with a non-5xx status, e.g. 404) live ``negative_ttl_s`` so hammering an
    unknown token costs one RPC per window.  Transport-level failures (5xx)
    are never cached — recovery after an identity-service outage must be
    immediate.

    Eviction race: ``lookup`` returns a generation snapshot and ``store``
    refuses to insert when an ``evict``/``evict_subject`` landed in between —
    an in-flight resolution that began before a ``userModified`` eviction can
    never repopulate the cache with its possibly-stale payload.

    ``evict_subject`` uses the subject-id recorded from each positive
    payload, so ``userDeleted`` (which carries only the user id, no tokens)
    still drops every resolution for that subject.

    All access is lock-guarded; entries cross the boundary as deep copies so
    caller mutation cannot corrupt future hits.  ``counter`` is an optional
    Counter-like (``.inc(key, by)``) receiving hits/misses/negative-hits/
    evictions/expirations (srv/telemetry.Telemetry.identity)."""

    def __init__(
        self,
        ttl_s: float = 600.0,
        negative_ttl_s: float = 30.0,
        max_entries: int = 4096,
        counter=None,
        time_fn=time.monotonic,
    ):
        self.ttl_s = float(ttl_s)
        self.negative_ttl_s = float(negative_ttl_s)
        self.max_entries = int(max_entries)
        self._time = time_fn
        self._counter = counter
        # token -> (expires_at, subject_id, envelope); dict order is the LRU
        self._data: dict[str, tuple[float, Optional[str], dict]] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._gen = 0  # guarded-by: _lock
        self._stats = {  # guarded-by: _lock
            "hits": 0, "misses": 0, "negative_hits": 0,
            "evictions": 0, "expirations": 0,
        }

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def _count(self, key: str, by: int = 1) -> None:  # holds: _lock
        self._stats[key] += by
        if self._counter is not None:
            self._counter.inc(key.replace("_", "-"), by)

    @property
    def gen(self) -> int:
        with self._lock:
            return self._gen

    def lookup(self, token: str) -> tuple[Optional[dict], int]:
        """(cached envelope copy or None, generation snapshot for store)."""
        now = self._time()
        with self._lock:
            gen = self._gen
            hit = self._data.get(token)
            if hit is not None and hit[0] <= now:
                del self._data[token]
                self._count("expirations")
                hit = None
            if hit is None:
                self._count("misses")
                return None, gen
            # LRU touch: re-insert at the back of the dict order
            self._data[token] = self._data.pop(token)
            self._count("hits")
            if hit[2].get("payload") is None:
                self._count("negative_hits")
            entry = hit[2]
        # copy outside the lock: hits must not serialize on copy cost
        return copy.deepcopy(entry), gen

    def store(self, token: str, envelope: dict, gen: int) -> bool:
        """Insert a resolution unless an eviction raced it; returns whether
        the entry was cached."""
        payload = envelope.get("payload")
        status = envelope.get("status") or {}
        code = status.get("code")
        if payload is None:
            if not isinstance(code, int) or code >= 500:
                return False  # transport failure: never cached
            ttl = self.negative_ttl_s
        else:
            ttl = self.ttl_s
        if ttl <= 0 or self.max_entries <= 0:
            return False
        subject_id = payload.get("id") if isinstance(payload, dict) else None
        entry = copy.deepcopy(envelope)
        expires_at = self._time() + ttl
        with self._lock:
            if gen != self._gen:
                # an evict() landed while this resolution was in flight —
                # the payload may predate the user mutation that triggered
                # it, so it must not repopulate the cache
                return False
            while self._data and len(self._data) >= self.max_entries:
                self._data.pop(next(iter(self._data)))
                self._count("evictions")
            self._data[token] = (expires_at, subject_id, entry)
        return True

    def evict(self, token: Optional[str] = None) -> int:
        """Drop cached resolutions (all, or one token) on user mutation."""
        with self._lock:
            self._gen += 1
            if token is None:
                n = len(self._data)
                self._data.clear()
            else:
                n = 1 if self._data.pop(token, None) is not None else 0
            self._count("evictions", n)
        return n

    def evict_subject(self, subject_id: str) -> int:
        """Drop every resolution whose payload belongs to ``subject_id``
        (userDeleted carries no token list)."""
        if subject_id is None:
            return 0
        with self._lock:
            self._gen += 1
            stale = [
                tok for tok, (_, sid, _) in self._data.items()
                if sid == subject_id
            ]
            for tok in stale:
                del self._data[tok]
            self._count("evictions", len(stale))
        return len(stale)

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            out["entries"] = len(self._data)
        looked = out["hits"] + out["misses"]
        out["hit_ratio"] = round(out["hits"] / looked, 4) if looked else None
        return out


def _breaker_envelope() -> dict:
    """The fast-fail resolution when the identity breaker is open: a 5xx
    envelope — never cached (TokenResolutionCache refuses >=500), so
    recovery is immediate, and the row degrades per-row to
    ``token-unresolved`` exactly like a timed-out RPC would."""
    return {
        "payload": None,
        "status": {"code": 503, "message": "identity circuit open"},
    }


def _record_envelope(breaker, envelope) -> None:
    """Feed a resolution outcome to the breaker: transport-level failures
    (5xx envelopes, the shape RPC exceptions fold into) count against the
    failure window; definitive answers — hits AND 404s — are successes
    (the upstream answered)."""
    if breaker is None:
        return
    status = (envelope or {}).get("status") or {}
    code = status.get("code")
    if isinstance(code, int) and code >= 500:
        breaker.record_failure()
    else:
        breaker.record_success()


class CachingIdentityClient:
    """TTL'd resolution cache around ANY identity client (the static map in
    tests/benches, custom transports in deployments).  GrpcIdentityClient
    carries the same cache built in — do not stack both.  ``breaker``
    (srv/admission.CircuitBreaker) guards the inner client: an open
    circuit resolves to the 503 envelope immediately — cache hits are
    served regardless (they need no upstream)."""

    def __init__(
        self,
        inner,
        ttl_s: float = 600.0,
        negative_ttl_s: float = 30.0,
        max_entries: int = 4096,
        counter=None,
        breaker=None,
    ):
        self.inner = inner
        self.breaker = breaker
        self.cache = TokenResolutionCache(
            ttl_s=ttl_s, negative_ttl_s=negative_ttl_s,
            max_entries=max_entries, counter=counter,
        )

    def find_by_token(self, token: str) -> Optional[dict]:
        hit, gen = self.cache.lookup(token)
        if hit is not None:
            return hit
        if self.breaker is not None and not self.breaker.allow():
            return _breaker_envelope()
        try:
            # failpoint (srv/faults.py): an injected outage takes the
            # real failure path — breaker failure, row fails closed
            from .faults import REGISTRY as FAULTS

            FAULTS.fire("identity.resolve")
            out = self.inner.find_by_token(token)
        except Exception:
            if self.breaker is not None:
                self.breaker.record_failure()
            raise
        if isinstance(out, dict):
            _record_envelope(self.breaker, out)
            self.cache.store(token, out, gen)
        return out

    def evict(self, token: Optional[str] = None) -> None:
        self.cache.evict(token)
        if hasattr(self.inner, "evict"):
            self.inner.evict(token)

    def evict_subject(self, subject_id: str) -> None:
        self.cache.evict_subject(subject_id)
        if hasattr(self.inner, "evict_subject"):
            self.inner.evict_subject(subject_id)

    def cache_stats(self) -> dict:
        return self.cache.stats()

    def close(self) -> None:
        if hasattr(self.inner, "close"):
            self.inner.close()


class StaticIdentityClient:
    """Token -> subject payload map (test/mock implementation)."""

    def __init__(self, subjects_by_token: dict[str, dict] | None = None):
        self.subjects_by_token = subjects_by_token or {}

    def register(self, token: str, payload: dict) -> None:
        self.subjects_by_token[token] = payload

    def find_by_token(self, token: str) -> Optional[dict]:
        payload = self.subjects_by_token.get(token)
        if payload is None:
            return {"payload": None, "status": {"code": 404, "message": "not found"}}
        return {"payload": payload, "status": {"code": 200, "message": "success"}}


class GrpcIdentityClient:
    """findByToken over a live gRPC channel (reference: src/worker.ts:135-143
    holds the identity-srv channel; resolution happens on the decision hot
    path, accessController.ts:110-117).

    The subject payload travels as JSON bytes in ``SubjectResponse.payload``;
    transport errors and non-200 statuses resolve to ``payload: None`` so
    the engine's token path fails closed (unresolved subjects match no
    role-gated rules).  Resolutions ride a ``TokenResolutionCache`` (TTL +
    negative caching), so repeat tokens inside and across batches cost one
    RPC per TTL window."""

    def __init__(self, address: str, timeout: float = 5.0,
                 cache_size: int = 1024, logger=None,
                 ttl_s: float = 600.0, negative_ttl_s: float = 30.0,
                 counter=None, breaker=None):
        import grpc

        from .gen import access_control_pb2 as pb

        self._pb = pb
        self.address = address
        self.timeout = timeout
        self.logger = logger
        # rate-limited failure warnings: a down identity service fires
        # this once per cache-missing token — unbounded under overload,
        # the masking logger becomes the bottleneck
        from .telemetry import SampledLogger

        self._slog = SampledLogger(logger)
        self.channel = grpc.insecure_channel(address)
        self._call = self.channel.unary_unary(
            "/acstpu.IdentityService/FindByToken",
            request_serializer=pb.FindByTokenRequest.SerializeToString,
            response_deserializer=pb.SubjectResponse.FromString,
        )
        # token -> resolution envelope; TTL'd with negative caching, evicted
        # by the worker's userModified/userDeleted listeners.  gRPC handler
        # threads hit this concurrently — TokenResolutionCache is
        # lock-guarded and its generation counter keeps an in-flight
        # resolution from re-inserting a stale payload after an eviction.
        self._cache = TokenResolutionCache(
            ttl_s=ttl_s, negative_ttl_s=negative_ttl_s,
            max_entries=cache_size, counter=counter,
        )
        # shared circuit breaker (srv/admission.CircuitBreaker): a down
        # identity service fails resolutions fast (rows degrade per-row
        # to token-unresolved) instead of paying `timeout` per request
        self.breaker = breaker

    def find_by_token(self, token: str) -> Optional[dict]:
        import json

        hit, gen = self._cache.lookup(token)
        if hit is not None:
            return hit
        if self.breaker is not None and not self.breaker.allow():
            return _breaker_envelope()
        try:
            # failpoint (srv/faults.py): injected identity-srv outage,
            # resolved to the honest 5xx envelope below (never cached)
            from .faults import REGISTRY as FAULTS

            FAULTS.fire("identity.grpc")
            resp = self._call(
                self._pb.FindByTokenRequest(token=token),
                timeout=self.timeout,
            )
        except Exception as err:
            self._slog.warning(
                "identity-resolution",
                "identity findByToken failed: %s", err,
            )
            if self.breaker is not None:
                self.breaker.record_failure()
            # 5xx: never cached, so recovery after an outage is immediate
            return {"payload": None,
                    "status": {"code": 503, "message": str(err)}}
        payload = None
        if resp.payload and resp.status.code in (0, 200):
            try:
                payload = json.loads(resp.payload)
            except ValueError:
                payload = None
        out = {
            "payload": payload,
            "status": {"code": resp.status.code or 200,
                       "message": resp.status.message},
        }
        _record_envelope(self.breaker, out)
        self._cache.store(token, out, gen)
        return out

    def evict(self, token: str = None) -> None:
        """Drop cached resolutions (all, or one token) on user mutation."""
        self._cache.evict(token)

    def evict_subject(self, subject_id: str) -> None:
        """Drop every cached resolution for one subject (userDeleted)."""
        self._cache.evict_subject(subject_id)

    def cache_stats(self) -> dict:
        return self._cache.stats()

    def close(self) -> None:
        self.channel.close()


class MockIdentityServer:
    """In-process identity service over real TCP: the reference test
    pattern (test/microservice_acs_enabled.spec.ts:106-223 starts a mock
    IDS and drives token resolution over the wire)."""

    def __init__(self, subjects_by_token: dict[str, dict] | None = None,
                 port: int = 0):
        import json
        from concurrent import futures

        import grpc

        from .gen import access_control_pb2 as pb

        self.subjects_by_token = subjects_by_token or {}
        self.calls: list[str] = []  # observed tokens, for test assertions

        def find_by_token(request, context):
            self.calls.append(request.token)
            payload = self.subjects_by_token.get(request.token)
            if payload is None:
                return pb.SubjectResponse(
                    payload=b"",
                    status=pb.OperationStatus(code=404, message="not found"),
                )
            return pb.SubjectResponse(
                payload=json.dumps(payload).encode(),
                status=pb.OperationStatus(code=200, message="success"),
            )

        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        handler = grpc.method_handlers_generic_handler(
            "acstpu.IdentityService",
            {
                "FindByToken": grpc.unary_unary_rpc_method_handler(
                    find_by_token,
                    request_deserializer=pb.FindByTokenRequest.FromString,
                    response_serializer=pb.SubjectResponse.SerializeToString,
                ),
            },
        )
        self.server.add_generic_rpc_handlers((handler,))
        self.port = self.server.add_insecure_port(f"127.0.0.1:{port}")
        self.server.start()

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def register(self, token: str, payload: dict) -> None:
        self.subjects_by_token[token] = payload

    def stop(self) -> None:
        self.server.stop(grace=None)
