"""Observability: latency histograms, decision counters, secret-masking
structured logging, and the ``torch.profiler`` hook.

The port's copy of the JAX package's ``srv/telemetry.py``.  The
reference's observability is winston structured logs with field masking
of secrets (``maskFields``: password/token, reference: cfg/config.json:10-46)
and no metrics endpoint; this framework adds a profiler hook on the
evaluator and request-latency histograms at the serving shell.  All
collection here is lock-guarded, allocation-free on the hot path (fixed
log2 buckets), and exposed as a plain dict snapshot (`Telemetry.snapshot`)
that the command interface serves from ``health_check``/``metrics``.
"""

from __future__ import annotations

import copy
import logging
import math
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Optional

# histogram buckets: upper bounds in seconds (log-spaced ~x4 from 50us to 50s)
_BUCKETS = [
    50e-6, 200e-6, 800e-6, 3.2e-3, 12.8e-3, 51.2e-3, 0.205, 0.82, 3.3, 13.1,
    52.4, float("inf"),
]

MASK_FIELDS = ("password", "token", "apiKey", "api_key", "authorization")
_LOWERED_MASK_FIELDS = tuple(f.lower() for f in MASK_FIELDS)
_MASK = "***"


def mask_secrets(obj: Any, fields: tuple = MASK_FIELDS) -> Any:
    """Deep-copy ``obj`` with secret-named fields replaced (the winston
    maskFields analog, reference: cfg/config.json:16-24).  Key matching is
    case-insensitive substring on the configured names."""
    lowered = tuple(f.lower() for f in fields)
    if isinstance(obj, dict):
        out = {}
        for key, value in obj.items():
            if isinstance(key, str) and any(f in key.lower() for f in lowered):
                out[key] = _MASK
            else:
                out[key] = mask_secrets(value, fields)
        return out
    if isinstance(obj, tuple):
        items = [mask_secrets(v, fields) for v in obj]
        if hasattr(obj, "_fields"):  # namedtuple: positional ctor
            return type(obj)(*items)
        return tuple(items)
    if isinstance(obj, list):
        return [mask_secrets(v, fields) for v in obj]
    return obj


_STANDARD_RECORD_FIELDS = frozenset(
    logging.LogRecord("", 0, "", 0, "", (), None).__dict__
) | {"message", "asctime", "taskName"}


class MaskingFilter(logging.Filter):
    """Masks secret fields inside dict/list log arguments and inside
    ``extra`` payloads (which land as non-standard LogRecord attributes)
    before they are formatted."""

    def filter(self, record: logging.LogRecord) -> bool:
        if isinstance(record.args, dict):
            record.args = mask_secrets(record.args)
        elif isinstance(record.args, tuple):
            record.args = tuple(
                mask_secrets(a) if isinstance(a, (dict, list)) else a
                for a in record.args
            )
        for key, value in list(record.__dict__.items()):
            if key in _STANDARD_RECORD_FIELDS:
                continue
            if isinstance(value, (dict, list)):
                setattr(record, key, mask_secrets(value))
            elif any(f in key.lower() for f in _LOWERED_MASK_FIELDS):
                # scalar extra under a secret-named key
                setattr(record, key, _MASK)
        return True


class JsonLinesFormatter(logging.Formatter):
    """One JSON object per record: timestamp, level, logger, message and
    every ``extra`` field (secrets already masked by MaskingFilter).  The
    shape log shippers (filebeat/fluent-bit/vector) ingest directly —
    the production log-shipping role the reference fills with a winston
    Elasticsearch transport (cfg/config_production.json:3-10); shipping
    is the collector's job, the service just emits structured lines."""

    def format(self, record: logging.LogRecord) -> str:
        import json

        out = {
            "@timestamp": self.formatTime(record, "%Y-%m-%dT%H:%M:%S%z"),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        for key, value in record.__dict__.items():
            if key in _STANDARD_RECORD_FIELDS or key in out:
                continue
            out[key] = value
        if record.exc_info:
            out["exception"] = self.formatException(record.exc_info)
        # default=repr: one serialization pass; non-JSON values degrade
        # to their repr instead of dropping the record
        return json.dumps(out, default=repr)


def make_logger(name: str = "access-control-srv-tpu",
                level: int = logging.INFO,
                json_sink: Optional[str] = None) -> logging.Logger:
    """``json_sink``: optional path; when set, masked records also append
    as JSON lines for an external shipper to tail (config key
    ``logging:json_sink`` — srv/worker.py)."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not any(isinstance(f, MaskingFilter) for f in logger.filters):
        logger.addFilter(MaskingFilter())
    if json_sink and not any(
        isinstance(h, logging.FileHandler)
        and getattr(h, "_acs_json_sink", None) == json_sink
        for h in logger.handlers
    ):
        handler = logging.FileHandler(json_sink)
        handler.setFormatter(JsonLinesFormatter())
        handler._acs_json_sink = json_sink
        logger.addHandler(handler)
    return logger


def estimate_percentiles(
    bounds: list, counts: list, qs: tuple = (0.5, 0.95, 0.99)
) -> list:
    """Bucket-interpolated percentile estimates: linear interpolation of
    the quantile position inside its bucket, between the previous bound
    and the bucket's own upper bound (0 below the first bucket; the inf
    bucket clamps to the last finite bound — the estimate cannot invent
    mass past what the histogram resolved)."""
    total = sum(counts)
    if total == 0:
        return [None] * len(qs)
    out = []
    for q in qs:
        rank = q * total
        cumulative = 0
        value = None
        for idx, (bound, count) in enumerate(zip(bounds, counts)):
            prev_cum = cumulative
            cumulative += count
            if cumulative >= rank:
                lo = bounds[idx - 1] if idx else 0.0
                hi = bound
                if math.isinf(hi):
                    value = float(lo)
                    break
                frac = (rank - prev_cum) / count if count else 1.0
                value = float(lo + (hi - lo) * frac)
                break
        out.append(value)
    return out


class Histogram:
    """Fixed-bucket latency histogram; thread-safe, O(1) observe."""

    def __init__(self):
        self._counts = [0] * len(_BUCKETS)  # guarded-by: _lock
        self._sum = 0.0  # guarded-by: _lock
        self._n = 0      # guarded-by: _lock
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        idx = 0
        for idx, bound in enumerate(_BUCKETS):  # 12 buckets: linear scan ok
            if seconds <= bound:
                break
        with self._lock:
            self._counts[idx] += 1
            self._sum += seconds
            self._n += 1

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, n = self._sum, self._n
        p50, p95, p99 = estimate_percentiles(_BUCKETS, counts)
        out = {
            "count": n,
            "sum_s": round(total, 6),
            "mean_s": round(total / n, 6) if n else None,
            # bucket-interpolated estimates (operator-facing; raw buckets
            # below remain the ground truth)
            "p50_s": round(p50, 6) if p50 is not None else None,
            "p95_s": round(p95, 6) if p95 is not None else None,
            "p99_s": round(p99, 6) if p99 is not None else None,
            "buckets": {},
        }
        cumulative = 0
        for bound, count in zip(_BUCKETS, counts):
            cumulative += count
            label = "inf" if math.isinf(bound) else f"{bound:g}"
            out["buckets"][label] = cumulative
        return out


class ValueHistogram:
    """Fixed pow2-bucket histogram for dimensionless values (queue
    depths); thread-safe, O(1) observe like ``Histogram``."""

    BOUNDS = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096, 16384,
              65536, float("inf")]

    def __init__(self):
        self._counts = [0] * len(self.BOUNDS)  # guarded-by: _lock
        self._sum = 0.0  # guarded-by: _lock
        self._n = 0      # guarded-by: _lock
        self._max = 0.0  # guarded-by: _lock
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        idx = 0
        for idx, bound in enumerate(self.BOUNDS):
            if value <= bound:
                break
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._n += 1
            if value > self._max:
                self._max = value

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, n, peak = self._sum, self._n, self._max
        p50, p95, p99 = estimate_percentiles(self.BOUNDS, counts)
        out = {
            "count": n,
            "mean": round(total / n, 3) if n else None,
            "max": peak,
            "p50": round(p50, 3) if p50 is not None else None,
            "p95": round(p95, 3) if p95 is not None else None,
            "p99": round(p99, 3) if p99 is not None else None,
            "buckets": {},
        }
        cumulative = 0
        for bound, count in zip(self.BOUNDS, counts):
            cumulative += count
            label = "inf" if math.isinf(bound) else f"{bound:g}"
            out["buckets"][label] = cumulative
        return out


class TenantCounter:
    """Bounded-cardinality per-tenant event counter (srv/tenancy.py).

    Tenant ids arrive from request metadata — attacker-controlled — so a
    naive ``{tenant: count}`` map is an unbounded-cardinality attack on
    the metrics registry (10k distinct ids = 10k Prometheus series).
    Exact counts are kept for at most ``max_tracked`` distinct ids;
    events from ids beyond the bound aggregate under ``__other__``.
    Slots are first-come and never evicted: recycling a slot would make
    an exposed counter non-monotonic, which Prometheus ``rate()``
    misreads as a reset.  ``snapshot`` ranks tenants by traffic so the
    top-K stay visible regardless of arrival order."""

    OTHER = "__other__"

    def __init__(self, max_tracked: int = 64):
        self.max_tracked = int(max_tracked)
        self._tenants: set[str] = set()  # guarded-by: _lock
        # (event, tenant) -> count; at most max_tracked+1 tenant values
        self._values: dict[tuple, int] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def inc(self, kind: str, tenant: str, by: int = 1) -> None:
        kind, tenant = str(kind), str(tenant)
        with self._lock:
            if tenant != self.OTHER and tenant not in self._tenants:
                if len(self._tenants) >= self.max_tracked:
                    tenant = self.OTHER
                else:
                    self._tenants.add(tenant)
            key = (kind, tenant)
            self._values[key] = self._values.get(key, 0) + by

    def tracked(self) -> int:
        with self._lock:
            return len(self._tenants)

    def prom_snapshot(self) -> dict:
        """{(event, tenant): count} — the full tracked (bounded) set,
        for the Prometheus exposition."""
        with self._lock:
            return dict(self._values)

    def snapshot(self, top_k: int = 16) -> dict:
        """{event: {tenant: count}} with at most ``top_k`` tenants per
        event by traffic; trimmed tenants fold into ``__other__`` so the
        per-event totals stay exact."""
        with self._lock:
            items = dict(self._values)
        grouped: dict[str, dict[str, int]] = {}
        for (kind, tenant), count in items.items():
            grouped.setdefault(kind, {})[tenant] = count
        out: dict[str, dict[str, int]] = {}
        for kind, per_tenant in grouped.items():
            other = per_tenant.pop(self.OTHER, 0)
            ranked = sorted(per_tenant.items(),
                            key=lambda kv: (-kv[1], kv[0]))
            trimmed = dict(ranked[:top_k])
            other += sum(count for _, count in ranked[top_k:])
            if other:
                trimmed[self.OTHER] = other
            out[kind] = trimmed
        return out


class Counter:
    def __init__(self):
        self._values: dict[str, int] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def inc(self, key: str, by: int = 1) -> None:
        with self._lock:
            self._values[key] = self._values.get(key, 0) + by

    def get(self, key: str) -> int:
        with self._lock:
            return self._values.get(key, 0)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._values)

    def clear(self) -> None:
        """Every count back to 0 (a measurement window's start)."""
        with self._lock:
            self._values.clear()


class SampledLogger:
    """Rate-limited wrapper for hot-path log sites: at most
    ``max_per_interval`` records per key per ``interval_s`` window; the
    overflow is counted and flushed as ONE summary line when the window
    rolls.  A down upstream under overload turns per-row warnings
    (token-unresolved, oracle fallback, adapter retry) into tens of
    thousands of records per second — enough to make the masking logger
    itself the serving bottleneck; this caps the worst case at
    ``max_per_interval + 1`` records per key per window regardless of
    offered load.  Thread-safe; the fast (suppressed) path is one lock +
    one dict update, no formatting."""

    def __init__(self, logger, max_per_interval: int = 5,
                 interval_s: float = 10.0, time_fn=time.monotonic):
        self.logger = logger
        self.max_per_interval = int(max_per_interval)
        self.interval_s = float(interval_s)
        self._time = time_fn
        self._lock = threading.Lock()
        # key -> [window_start, emitted_in_window, suppressed_in_window]
        self._state: dict[str, list] = {}  # guarded-by: _lock

    def _gate(self, key: str) -> tuple[bool, int]:
        """(emit_now, suppressed_to_report): whether THIS record may log,
        and how many suppressed records the rolled window accumulated."""
        now = self._time()
        with self._lock:
            state = self._state.get(key)
            if state is None or now - state[0] >= self.interval_s:
                rolled = state[2] if state else 0
                self._state[key] = [now, 1, 0]
                return True, rolled
            if state[1] < self.max_per_interval:
                state[1] += 1
                return True, 0
            state[2] += 1
            return False, 0

    def _log(self, level: int, key: str, msg: str, *args, **kwargs) -> None:
        if self.logger is None:
            return
        emit, rolled = self._gate(key)
        if rolled:
            self.logger.log(
                level,
                "suppressed %d '%s' records in the last %.0fs "
                "(rate-limited hot-path logging)",
                rolled, key, self.interval_s,
            )
        if emit:
            self.logger.log(level, msg, *args, **kwargs)

    def warning(self, key: str, msg: str, *args, **kwargs) -> None:
        self._log(logging.WARNING, key, msg, *args, **kwargs)

    def info(self, key: str, msg: str, *args, **kwargs) -> None:
        self._log(logging.INFO, key, msg, *args, **kwargs)

    def suppressed(self, key: str) -> int:
        with self._lock:
            state = self._state.get(key)
            return state[2] if state else 0


# ------------------------------------------------- Prometheus exposition

def _prom_escape(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _prom_bucket_label(bound: float) -> str:
    return "+Inf" if math.isinf(bound) else repr(float(bound))


class MetricsRegistry:
    """Named metric registry rendering the Prometheus text exposition
    format (version 0.0.4).  Entries hold LIVE references to the
    Counter/Histogram objects (or zero-arg callables for gauges and for
    late-bound histogram groups like the stage-tracer taxonomy), so
    ``render()`` always reflects the current state — there is no
    separate scrape-time collection step to keep in sync."""

    CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

    def __init__(self):
        self._entries: list[tuple] = []  # (kind, name, help, payload)

    def counter(self, name: str, help_text: str, counter: Counter,
                label: str = "key") -> None:
        self._entries.append(("counter", name, help_text, (counter, label)))

    def multi_counter(self, name: str, help_text: str,
                      snapshot_fn: Callable[[], dict],
                      labels: tuple) -> None:
        """Counter family with several labels: ``snapshot_fn`` returns
        ``{(value_per_label, ...): count}`` at render time."""
        self._entries.append(("multi_counter", name, help_text,
                              (snapshot_fn, labels)))

    def histogram(self, name: str, help_text: str, histogram) -> None:
        self._entries.append(("histogram", name, help_text,
                              (lambda: {None: histogram}, None)))

    def histogram_group(self, name: str, help_text: str,
                        group_fn: Callable[[], dict], label: str) -> None:
        """A family of histograms under one metric name, one label value
        per histogram (``group_fn`` returns {label_value: Histogram} and
        is consulted at render time — late-bound members appear)."""
        self._entries.append(("histogram", name, help_text,
                              (group_fn, label)))

    def gauge(self, name: str, help_text: str,
              value_fn: Callable[[], float]) -> None:
        self._entries.append(("gauge", name, help_text, value_fn))

    @staticmethod
    def _render_histogram(lines: list, name: str, histogram,
                          label: Optional[str], label_value) -> None:
        bounds = getattr(histogram, "BOUNDS", _BUCKETS)
        with histogram._lock:
            counts = list(histogram._counts)
            total, n = histogram._sum, histogram._n
        prefix = ""
        if label is not None:
            prefix = f'{label}="{_prom_escape(label_value)}",'
        cumulative = 0
        for bound, count in zip(bounds, counts):
            cumulative += count
            lines.append(
                f'{name}_bucket{{{prefix}le="{_prom_bucket_label(bound)}"}}'
                f" {cumulative}"
            )
        suffix = f'{{{label}="{_prom_escape(label_value)}"}}' \
            if label is not None else ""
        lines.append(f"{name}_sum{suffix} {total!r}")
        lines.append(f"{name}_count{suffix} {n}")

    def render(self) -> str:
        lines: list[str] = []
        for kind, name, help_text, payload in self._entries:
            if kind == "counter":
                counter, label = payload
                values = counter.snapshot()
                if not values:
                    continue
                lines.append(f"# HELP {name} {help_text}")
                lines.append(f"# TYPE {name} counter")
                for key in sorted(values):
                    lines.append(
                        f'{name}{{{label}="{_prom_escape(key)}"}} '
                        f"{values[key]}"
                    )
            elif kind == "multi_counter":
                snapshot_fn, labels = payload
                values = snapshot_fn()
                if not values:
                    continue
                lines.append(f"# HELP {name} {help_text}")
                lines.append(f"# TYPE {name} counter")
                for key in sorted(values):
                    pairs = ",".join(
                        f'{lbl}="{_prom_escape(val)}"'
                        for lbl, val in zip(labels, key)
                    )
                    lines.append(f"{name}{{{pairs}}} {values[key]}")
            elif kind == "histogram":
                group_fn, label = payload
                group = group_fn()
                if not group:
                    continue
                lines.append(f"# HELP {name} {help_text}")
                lines.append(f"# TYPE {name} histogram")
                for label_value in sorted(
                    group, key=lambda v: "" if v is None else str(v)
                ):
                    self._render_histogram(
                        lines, name, group[label_value], label, label_value
                    )
            else:  # gauge
                lines.append(f"# HELP {name} {help_text}")
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {payload()!r}")
        return "\n".join(lines) + "\n"


class PrometheusExporter:
    """Optional stdlib /metrics endpoint (observability:metrics_http):
    a daemon ThreadingHTTPServer serving the registry's text exposition
    on GET /metrics — the pull-model counterpart of the command
    interface's ``metrics`` command (same bytes, same registry).  Port 0
    binds an ephemeral port (tests); ``.port`` reports the bound one."""

    def __init__(self, telemetry: "Telemetry", host: str = "127.0.0.1",
                 port: int = 0, logger=None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        registry = telemetry.registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — stdlib API name
                if self.path.split("?", 1)[0] != "/metrics":
                    self.send_error(404)
                    return
                body = registry.render().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 MetricsRegistry.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes are not log traffic
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="acs-metrics-http",
        )
        self._thread.start()
        if logger is not None:
            logger.info("metrics endpoint up",
                        extra={"addr": f"{self.host}:{self.port}"})

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)


class Telemetry:
    """Per-worker metrics facade over a ``MetricsRegistry``: every
    counter/histogram below is registered with a Prometheus name at
    construction, so the full snapshot renders in text exposition format
    (``prometheus()``) without a separate collection step — the
    ``metrics`` command and the optional /metrics endpoint serve the
    same registry."""

    def __init__(self):
        self.is_allowed_latency = Histogram()
        self.what_is_allowed_latency = Histogram()
        self.batch_latency = Histogram()
        self.decisions = Counter()
        self.paths = Counter()  # kernel / oracle / native-wire / cache-hit rows
        self.cache = Counter()  # decision-cache hits / misses / evictions
        # token-resolution cache hits / misses / negative-hits / evictions
        # (srv/identity.TokenResolutionCache — the host eligibility
        # pipeline's identity-RPC amortizer)
        self.identity = Counter()
        # incremental policy-update subsystem (ops/delta.py): delta-patch /
        # full-compile / noop / fallback counts, shard re-slices under the
        # pod-sharded tier (shards_patched, parallel/pod_shard.py), and
        # the mutation-to-visibility latency (CRUD call to kernel swap)
        # per update
        self.delta = Counter()
        self.policy_update_latency = Histogram()
        # admission control (srv/admission.py): admitted / shed /
        # deadline-rejected / breaker-transition counters, the queue-depth
        # distribution at admit and the remaining-deadline-budget
        # distribution (seconds) of deadline-bearing requests
        self.admission = Counter()
        self.admission_queue_depth = ValueHistogram()
        self.admission_budget = Histogram()
        # deterministic fault injection (srv/faults.py): per-site hit
        # counts, fed by the registry's on_hit hook — operators see
        # exactly which failpoints fired and how often
        self.failpoints = Counter()
        # relation-tuple store (srv/relations.py): tuples_created /
        # tuples_deleted / rewrites / replicated-frame counts — the ReBAC
        # churn surface (tuple writes swap no program, so this counter is
        # the only operator-visible trace of relation mutations)
        self.relations = Counter()
        # shadow evaluation (srv/shadow.py): candidate-vs-production
        # decision diffs keyed by transition ("PERMIT->DENY", ...) plus
        # lifecycle events (evaluated/dropped/errors).  Both stay empty —
        # and the snapshot block absent — unless a shadow is loaded.
        self.shadow_diffs = Counter()
        self.shadow = Counter()
        # permission-lattice audit sweeps (srv/audit_sweep.py): job
        # lifecycle (jobs_started/completed/cancelled/failed), progress
        # (chunks/cells), bulk-class shed/retry counts and diff volume.
        # Stays empty — and the snapshot block absent — unless the audit
        # subsystem is enabled and a sweep has run.
        self.audit = Counter()
        # per-tenant serving events (srv/tenancy.py): decision / shed /
        # cache_hit / cache_miss per tenant id, cardinality-bounded —
        # see TenantCounter
        self.tenants = TenantCounter()
        # device-hang watchdog (srv/watchdog.py): attached by the worker
        # when enabled; the degraded/quarantine gauges read 0 without one
        self._watchdog = None
        # per-stage pipeline durations (srv/tracing.StageTracer writes
        # here): stage name -> Histogram.  Empty unless tracing is
        # enabled, so the snapshot/exposition surface only grows when the
        # operator asked for attribution.
        self.stages: dict[str, Histogram] = {}  # guarded-by: _snapshot_lock
        # acs-lint: ignore[wall-clock] human-facing uptime epoch stamp —
        # operators expect a wall-time "since" value; never used in
        # deadline or TTL arithmetic
        self.start_time = time.time()
        self._snapshot_lock = threading.Lock()
        self.registry = MetricsRegistry()
        self._register_all()

    def _register_all(self) -> None:
        reg = self.registry
        reg.gauge("acs_uptime_seconds", "Worker uptime",
                  # acs-lint: ignore[wall-clock] human-facing uptime display
                  lambda: round(time.time() - self.start_time, 3))
        reg.histogram("acs_is_allowed_latency_seconds",
                      "isAllowed end-to-end latency", self.is_allowed_latency)
        reg.histogram("acs_what_is_allowed_latency_seconds",
                      "whatIsAllowed end-to-end latency",
                      self.what_is_allowed_latency)
        reg.histogram("acs_batch_latency_seconds",
                      "Batched isAllowed latency", self.batch_latency)
        reg.counter("acs_decisions_total", "Decisions served by value",
                    self.decisions, label="decision")
        reg.counter("acs_serving_path_rows_total",
                    "Rows served per path (kernel/oracle/native-wire/"
                    "cache-hit/...)", self.paths, label="path")
        reg.counter("acs_decision_cache_events_total",
                    "Decision-cache hits/misses/evictions",
                    self.cache, label="event")
        reg.counter("acs_identity_cache_events_total",
                    "Token-resolution cache events",
                    self.identity, label="event")
        reg.counter("acs_policy_update_events_total",
                    "Incremental policy-update events (ops/delta.py)",
                    self.delta, label="event")
        reg.histogram("acs_policy_update_latency_seconds",
                      "Mutation-to-visibility latency",
                      self.policy_update_latency)
        reg.counter("acs_admission_events_total",
                    "Admission control events (srv/admission.py)",
                    self.admission, label="event")
        reg.histogram("acs_admission_queue_depth",
                      "Queue depth at admit", self.admission_queue_depth)
        reg.histogram("acs_admission_budget_seconds",
                      "Remaining deadline budget at admit",
                      self.admission_budget)
        reg.multi_counter(
            "acs_tenant_events_total",
            "Per-tenant serving events (decision/shed/cache_hit/...; "
            "cardinality-bounded, overflow under __other__)",
            self.tenants.prom_snapshot, labels=("event", "tenant"),
        )
        reg.counter("acs_failpoint_hits_total",
                    "Deterministic fault-injection hits per site "
                    "(srv/faults.py)", self.failpoints, label="site")
        reg.counter("acs_relation_events_total",
                    "Relation-tuple store events (srv/relations.py)",
                    self.relations, label="event")
        reg.counter("acs_shadow_diffs_total",
                    "Candidate-vs-production decision diffs by transition "
                    "(srv/shadow.py)", self.shadow_diffs,
                    label="transition")
        reg.counter("acs_shadow_events_total",
                    "Shadow-evaluation lifecycle events "
                    "(evaluated/dropped/errors)", self.shadow,
                    label="event")
        reg.counter("acs_audit_events_total",
                    "Permission-lattice audit-sweep events "
                    "(srv/audit_sweep.py)", self.audit, label="event")
        reg.gauge("acs_degraded_seconds",
                  "Cumulative seconds the device kernel path has been "
                  "quarantined (srv/watchdog.py)", self._degraded_seconds)
        reg.gauge("acs_device_quarantined",
                  "1 while the device kernel path is quarantined",
                  self._quarantined_gauge)
        reg.histogram_group(
            "acs_stage_duration_seconds",
            "Per-stage pipeline duration (srv/tracing.py taxonomy)",
            self._stages_view, label="stage",
        )

    def set_watchdog(self, watchdog) -> None:
        """Attach the device watchdog so the degraded/quarantine gauges
        and the snapshot's device_watchdog block read live state."""
        self._watchdog = watchdog

    def _degraded_seconds(self) -> float:
        watchdog = self._watchdog
        if watchdog is None:
            return 0.0
        return round(watchdog.degraded_seconds(), 3)

    def _quarantined_gauge(self) -> int:
        watchdog = self._watchdog
        return int(watchdog is not None and watchdog.quarantined)

    def _stages_view(self) -> dict:
        """Consistent copy of the stage-histogram map for render():
        iterating the LIVE dict while stage_histogram inserts a late-bound
        stage raises ``dict changed size during iteration`` mid-scrape."""
        with self._snapshot_lock:
            return dict(self.stages)

    def stage_histogram(self, stage: str) -> Histogram:
        """The (lazily created) histogram for one pipeline stage."""
        # acs-lint: ignore[guarded-by] benign racy fast path: a dict.get
        # miss falls through to the locked setdefault; entries are never
        # removed, so a hit is always the canonical histogram
        hist = self.stages.get(stage)
        if hist is None:
            with self._snapshot_lock:
                hist = self.stages.setdefault(stage, Histogram())
        return hist

    def prometheus(self) -> str:
        """The full snapshot in Prometheus text exposition format."""
        return self.registry.render()

    @contextmanager
    def timed(self, histogram: Histogram):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            histogram.observe(time.perf_counter() - t0)

    def tenant_inc(self, kind: str, tenant: str, by: int = 1) -> None:
        """Per-tenant counter hook (admission sheds, tenant decisions,
        cache events); safe at any cardinality — overflow ids aggregate
        under ``__other__``."""
        self.tenants.inc(kind, tenant, by)

    def record_decision(self, decision: str) -> None:
        self.decisions.inc(decision)

    def record_path(self, path: str, rows: int = 1) -> None:
        self.paths.inc(path, rows)

    def snapshot(self) -> dict:
        # watchdog/failpoint state reads its own locks BEFORE the snapshot
        # lock — no nested lock order between telemetry and the watchdog
        watchdog = self._watchdog
        wd_status = None if watchdog is None else watchdog.status()
        from .faults import REGISTRY as _faults_registry

        failpoint_hits = self.failpoints.snapshot()
        faults_enabled = _faults_registry.enabled
        tenant_events = self.tenants.snapshot()
        # assembled under the snapshot lock and returned as a DEEP copy:
        # concurrent `metrics`/`health_check` readers serialize their own
        # private tree — they can never observe a dict mutating under a
        # concurrent writer mid-json.dumps (each sub-snapshot is already
        # a copy; the deep copy also detaches anything a future metric
        # nests by reference)
        with self._snapshot_lock:
            out = {
                # acs-lint: ignore[wall-clock] human-facing uptime display
                "uptime_s": round(time.time() - self.start_time, 3),
                "is_allowed_latency": self.is_allowed_latency.snapshot(),
                "what_is_allowed_latency":
                    self.what_is_allowed_latency.snapshot(),
                "batch_latency": self.batch_latency.snapshot(),
                "decisions": self.decisions.snapshot(),
                "paths": self.paths.snapshot(),
                "decision_cache": self.cache.snapshot(),
                "identity_cache": self.identity.snapshot(),
                "policy_update": {
                    **self.delta.snapshot(),
                    "latency": self.policy_update_latency.snapshot(),
                },
                "admission": {
                    **self.admission.snapshot(),
                    "queue_depth": self.admission_queue_depth.snapshot(),
                    "budget_s": self.admission_budget.snapshot(),
                },
            }
            if self.stages:
                out["stages"] = {
                    stage: hist.snapshot()
                    for stage, hist in sorted(self.stages.items())
                }
            # fault-injection / device-health blocks only appear when the
            # subsystems are live — snapshots of an untouched worker stay
            # byte-identical to the pre-failpoint shape
            # per-tenant events only appear once a tenant-tagged request
            # was served — untenanted workers keep the exact legacy shape
            if tenant_events:
                out["tenants"] = tenant_events
            relation_events = self.relations.snapshot()
            if relation_events:
                out["relations"] = relation_events
            shadow_events = self.shadow.snapshot()
            shadow_diffs = self.shadow_diffs.snapshot()
            if shadow_events or shadow_diffs:
                out["shadow"] = {**shadow_events, "diffs": shadow_diffs}
            audit_events = self.audit.snapshot()
            if audit_events:
                out["audit"] = audit_events
            if faults_enabled or failpoint_hits:
                out["failpoints"] = {
                    "enabled": faults_enabled,
                    "hits": failpoint_hits,
                }
            if wd_status is not None:
                out["device_watchdog"] = wd_status
            return copy.deepcopy(out)


@contextmanager
def profile_evaluator(out_dir: str, host_tracer_level: int = 2):
    """``torch.profiler`` capture (CPU and, where present, CUDA activity)
    around an evaluation region; the Chrome trace lands in ``out_dir``.
    ``host_tracer_level`` is accepted for the JAX package's signature and
    has no counterpart here."""
    import os

    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(
            os.path.join(out_dir, f"trace-{os.getpid()}-"
                                  f"{time.monotonic_ns()}.json"))
