"""Resource adapters for rule context queries.

The port's copy of the JAX package's ``srv/adapters.py`` (host only);
``core/engine.create_resource_adapter`` builds its adapters.

Framework analog of the reference's ResourceAdapter + GraphQLAdapter
(reference: src/core/resource_adapters/{adapter,gql}.ts): a rule may carry
a ``context_query`` whose result is pulled before condition evaluation and
grafted onto the request context under ``_queryResult``.

The GraphQL implementation resolves filter property references against the
request's context resources (reference: gql.ts:30-55), POSTs the query and
unwraps the ``details`` payloads (reference: gql.ts:66-89).

Transport: the HTTP layer is injectable (tests pass a transport callable);
production uses a small keep-alive connection pool over stdlib
``http.client`` with a configurable per-request timeout (default 5 s —
the old per-row ``urllib.urlopen`` opened a fresh TCP connection per
query and hung for 30 s on a slow endpoint, stalling whole oracle-fallback
batches).  ``query_many`` fans a batch of context queries out over a
bounded thread pool so N adapter-backed rows stall for ~one timeout, not
N sequential ones (the evaluator drives its concurrent fallback through
the same ``max_concurrency`` bound, srv/evaluator.py).
"""

from __future__ import annotations

import http.client
import json
import random
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional

from ..core.common import get_field as _get
from ..core.errors import (
    ContextQueryTransportError,
    UnexpectedContextQueryResponse,
    UnsupportedResourceAdapter,
)

DEFAULT_TIMEOUT_S = 5.0
DEFAULT_MAX_CONCURRENCY = 8
# transient (5xx) transport failures are retried after a jittered
# backoff before the row falls back to the slow path — a single blip at the
# endpoint must not demote a whole batch slice to the oracle walk.  Both
# knobs are config-driven (adapter block: retry_count / retry_backoff_s);
# the backoff doubles per attempt from the base.
DEFAULT_RETRY_BACKOFF_S = 0.05
DEFAULT_RETRY_COUNT = 1


class ResourceAdapter:
    def query(self, context_query, request) -> Any:
        raise NotImplementedError


class _ConnectionPool:
    """Keep-alive ``http.client`` connections for one endpoint.  Idle
    connections are reused LIFO; a connection that went stale mid-reuse is
    discarded and the request retried once on a fresh one."""

    def __init__(self, url: str, timeout_s: float, max_idle: int = 8):
        self.url = url
        parsed = urllib.parse.urlsplit(url)
        self.scheme = parsed.scheme or "http"
        self.host = parsed.hostname or ""
        self.port = parsed.port
        self.path = parsed.path or "/"
        if parsed.query:
            self.path += f"?{parsed.query}"
        self.timeout_s = timeout_s
        self.max_idle = max_idle
        self._idle: list[http.client.HTTPConnection] = []
        self._lock = threading.Lock()

    def _connect(self) -> http.client.HTTPConnection:
        cls = (
            http.client.HTTPSConnection
            if self.scheme == "https"
            else http.client.HTTPConnection
        )
        return cls(self.host, self.port, timeout=self.timeout_s)

    def _checkout(self) -> tuple[http.client.HTTPConnection, bool]:
        with self._lock:
            if self._idle:
                return self._idle.pop(), True
        return self._connect(), False

    def _checkin(self, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            if len(self._idle) < self.max_idle:
                self._idle.append(conn)
                return
        conn.close()

    def post(self, body: bytes, headers: dict) -> bytes:
        conn, reused = self._checkout()
        try:
            conn.request("POST", self.path, body=body, headers=headers)
            response = conn.getresponse()
            data = response.read()
        except Exception:
            conn.close()
            if not reused:
                raise
            # the pooled connection was closed server-side between uses;
            # one retry on a fresh connection
            conn = self._connect()
            try:
                conn.request("POST", self.path, body=body, headers=headers)
                response = conn.getresponse()
                data = response.read()
            except Exception:
                conn.close()
                raise
        # the body is fully read, so the connection is reusable either way
        self._checkin(conn)
        if not 200 <= response.status < 300:
            # error bodies (often HTML) must never reach GraphQL parsing:
            # surface a clean transport error with the upstream status
            raise ContextQueryTransportError(response.status, response.reason)
        return data

    def close(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
        for conn in idle:
            conn.close()


class GraphQLAdapter(ResourceAdapter):
    def __init__(
        self,
        url: str,
        logger=None,
        client_opts: dict | None = None,
        transport: Optional[Callable[[str, bytes, dict], bytes]] = None,
        timeout_s: float | None = None,
        max_concurrency: int | None = None,
        retry_transient: bool | None = None,
        retry_backoff_s: float | None = None,
        retry_count: int | None = None,
        breaker=None,
    ):
        self.url = url
        self.logger = logger
        # rate-limited retry warnings: a down upstream under overload
        # retries on every context-query row — unbounded, the masking
        # logger becomes the bottleneck (srv/telemetry.SampledLogger)
        from .telemetry import SampledLogger

        self._slog = SampledLogger(logger)
        self.client_opts = client_opts or {}
        self.timeout_s = float(
            timeout_s
            if timeout_s is not None
            else self.client_opts.get("timeout_s", DEFAULT_TIMEOUT_S)
        )
        self.max_concurrency = int(
            max_concurrency
            if max_concurrency is not None
            else self.client_opts.get("max_concurrency",
                                      DEFAULT_MAX_CONCURRENCY)
        )
        self.retry_transient = bool(
            self.client_opts.get("retry_transient", True)
            if retry_transient is None
            else retry_transient
        )
        self.retry_backoff_s = float(
            retry_backoff_s
            if retry_backoff_s is not None
            else self.client_opts.get("retry_backoff_s",
                                      DEFAULT_RETRY_BACKOFF_S)
        )
        self.retry_count = int(
            retry_count
            if retry_count is not None
            else self.client_opts.get("retry_count", DEFAULT_RETRY_COUNT)
        )
        # shared circuit breaker (srv/admission.CircuitBreaker): a down
        # context-query upstream fails rows fast down the existing
        # kernel -> retry -> oracle ladder instead of paying timeout_s
        # per request
        self.breaker = breaker
        self._pool: Optional[_ConnectionPool] = None
        self._pool_lock = threading.Lock()
        self.transport = transport or self._http_post

    def _http_post(self, url: str, body: bytes, headers: dict) -> bytes:
        with self._pool_lock:
            if (
                self._pool is None
                or self._pool.url != url
                or self._pool.timeout_s != self.timeout_s
            ):
                if self._pool is not None:
                    self._pool.close()
                self._pool = _ConnectionPool(url, self.timeout_s)
            pool = self._pool
        return pool.post(body, headers)

    def close(self) -> None:
        with self._pool_lock:
            if self._pool is not None:
                self._pool.close()
                self._pool = None

    def _resolve_filters(self, context_query, request) -> dict:
        """Filter values referencing request resource properties are
        resolved from the context resources (reference: gql.ts:30-55)."""
        variables: dict = {}
        filters = []
        ctx_resources = _get(request.context, "resources") or []
        for filt in getattr(context_query, "filters", None) or []:
            field = _get(filt, "field")
            value = _get(filt, "value")
            operation = _get(filt, "operation") or "eq"
            if isinstance(value, str) and value.startswith("$"):
                prop = value[1:]
                resolved = None
                for res in ctx_resources:
                    node = res
                    found = True
                    for part in prop.split("."):
                        node = _get(node, part)
                        if node is None:
                            found = False
                            break
                    if found:
                        resolved = node
                        break
                value = resolved
            filters.append({"field": field, "operation": operation, "value": value})
        if filters:
            variables["filters"] = filters
        return variables

    def _transport_once(self, body: bytes, headers: dict) -> bytes:
        """One transport call under the circuit breaker: an open circuit
        fails fast with a 503 transport error (no network wait), outcomes
        feed the breaker's failure-rate window.  4xx responses are the
        UPSTREAM answering (definitively) — they count as breaker
        successes; 5xx and connection-level failures count as failures."""
        breaker = self.breaker
        if breaker is not None and not breaker.allow():
            raise ContextQueryTransportError(
                503, "context-query circuit open"
            )
        try:
            # failpoint (srv/faults.py): an injected flap travels the
            # exact transport-error path — breaker bookkeeping, retry
            # with backoff, per-row degraded resolution
            from .faults import REGISTRY as FAULTS

            FAULTS.fire(
                "adapter.http",
                exc=lambda: ContextQueryTransportError(
                    599, "fault injected at adapter.http"
                ),
            )
            data = self.transport(self.url, body, headers)
        except ContextQueryTransportError as err:
            if breaker is not None:
                code = getattr(err, "code", None)
                if isinstance(code, int) and 400 <= code < 500:
                    breaker.record_success()
                else:
                    breaker.record_failure()
            raise
        except Exception:
            if breaker is not None:
                breaker.record_failure()
            raise
        if breaker is not None:
            breaker.record_success()
        return data

    def _transport_with_retry(
        self, body: bytes, headers: dict,
        deadline: Optional[float] = None,
    ) -> bytes:
        """Up to ``retry_count`` jittered, exponentially-backed-off
        retries on transient (5xx) transport failures before the caller's
        deny/oracle degradation; 4xx responses and payload errors are
        definitive and surface immediately.  Deadline-aware: a retry is
        skipped when the row's remaining budget cannot cover the backoff
        plus another transport timeout — the row goes straight to the
        oracle fallback instead of blowing its deadline in a sleep."""
        attempt = 0
        while True:
            try:
                return self._transport_once(body, headers)
            except ContextQueryTransportError as err:
                code = getattr(err, "code", None)
                if (
                    not self.retry_transient
                    or attempt >= self.retry_count
                    or not isinstance(code, int)
                    or not 500 <= code < 600
                ):
                    raise
                delay = (
                    self.retry_backoff_s * (2 ** attempt)
                    * (0.5 + random.random())
                )
                if deadline is not None and (
                    time.monotonic() + delay + self.timeout_s > deadline
                ):
                    # the remaining budget cannot cover backoff + another
                    # attempt: surface the failure now
                    raise
                self._slog.warning(
                    "adapter-retry",
                    "transient context-query failure (%s); retry %d/%d "
                    "in %.0f ms", code, attempt + 1, self.retry_count,
                    delay * 1e3,
                )
                time.sleep(delay)
                attempt += 1

    def query(self, context_query, request) -> Any:
        gql_query = getattr(context_query, "query", "") or ""
        variables = self._resolve_filters(context_query, request)
        body = json.dumps({"query": gql_query, "variables": variables}).encode()
        headers = {"Content-Type": "application/json"}
        headers.update(self.client_opts.get("headers", {}))
        raw = self._transport_with_retry(
            body, headers,
            deadline=getattr(request, "_deadline", None),
        )
        try:
            payload = json.loads(raw)
        except (TypeError, ValueError) as exc:
            raise UnexpectedContextQueryResponse(str(exc)) from exc
        data = payload.get("data")
        if not isinstance(data, dict) or not data:
            raise UnexpectedContextQueryResponse("missing data")
        # unwrap the first operation's details payloads (reference: gql.ts:82-89)
        first = next(iter(data.values()))
        details = _get(first, "details")
        if details is None:
            raise UnexpectedContextQueryResponse("missing details")
        out = []
        for item in details:
            payload_item = _get(item, "payload")
            out.append(payload_item if payload_item is not None else item)
        return out

    def query_many(self, pairs: list[tuple[Any, Any]]) -> list[Any]:
        """Concurrent batch fetch: one ``(context_query, request)`` pair per
        row, answered in order.  Per-row failures come back as the raised
        exception object (callers keep the reference's per-row
        deny-on-error semantics instead of failing the whole batch)."""
        if not pairs:
            return []
        if len(pairs) == 1:
            cq, request = pairs[0]
            try:
                return [self.query(cq, request)]
            except Exception as err:  # noqa: BLE001 — returned, not raised
                return [err]

        def one(pair):
            try:
                return self.query(pair[0], pair[1])
            except Exception as err:  # noqa: BLE001
                return err

        workers = max(1, min(self.max_concurrency, len(pairs)))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(one, pairs))


def create_adapter(adapter_config: dict, logger=None,
                   breaker=None) -> ResourceAdapter:
    """(reference: accessController.ts:943-951)"""
    if adapter_config and adapter_config.get("graphql"):
        opts = adapter_config["graphql"]
        return GraphQLAdapter(
            opts.get("url", ""), logger, opts.get("clientOpts"),
            transport=opts.get("transport"),
            timeout_s=adapter_config.get("timeout_s", opts.get("timeout_s")),
            max_concurrency=adapter_config.get(
                "max_concurrency", opts.get("max_concurrency")
            ),
            retry_transient=adapter_config.get(
                "retry_transient", opts.get("retry_transient")
            ),
            retry_backoff_s=adapter_config.get(
                "retry_backoff_s", opts.get("retry_backoff_s")
            ),
            retry_count=adapter_config.get(
                "retry_count", opts.get("retry_count")
            ),
            breaker=breaker,
        )
    raise UnsupportedResourceAdapter(adapter_config)
