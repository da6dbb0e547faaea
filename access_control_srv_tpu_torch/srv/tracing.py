"""Stage-span tracing, decision audit log and the observability hub.

The wire-to-kernel gap (ROADMAP: 11.6M dec/s on device vs 60k
wire-to-wire) is a HOST problem, and closing it needs attribution: where
do the microseconds between transport receive and response bytes go?
This module provides the serving shell's answer — a low-overhead,
allocation-light span context created at transport receive and threaded
through the whole pipeline (transport parse -> admission -> micro-batch
queue wait -> prepare (token resolve / context-query prefetch) ->
encode -> device (H2D + eval + D2H) -> decode -> response serialize),
recording per-stage monotonic durations into per-stage histograms
(``Telemetry.stages`` -> Prometheus ``acs_stage_duration_seconds``)
plus an optional per-request trace retained in a bounded ring buffer.

Batch-level stages (prepare/encode/device/decode run once per collected
batch) fan their duration back to every member request's span, so a
sampled request always carries a complete span tree; stage durations
therefore sum to <= the request's wall clock (stages are sequential
within the batch, and every batch stage lies inside each member's
lifetime).

Trace ids propagate from the gRPC metadata key ``x-acs-trace-id`` (an
explicit client id forces sampling — the debugging contract) and are
echoed on the response's trailing metadata.

EXTree (PAPERS.md) argues ABAC decisions must be auditable after the
fact: ``DecisionAuditLog`` emits a sampled JSONL record per decision
(subject/resource/action/decision/serving path/deciding rule id) through
the same masking machinery as the structured logger — secret-named
fields AND secret-named target attributes (token and friends) never
reach the sink.  Oracle rows carry the host walk's provenance; with
explain mode on (``explain:enabled``, srv/explain.py) kernel rows
carry the device-recovered deciding rule id through the identical
``_rule_id`` attribute and the identical masking path.

Everything here is host-only BY CONSTRUCTION: this module imports no
device runtime, and a traced batch launches the same kernels as an
untraced one.  With the
``observability`` config absent the hub is never built and the serving
path is byte-identical to pre-observability behavior
(tests/test_tracing.py differential).
"""

from __future__ import annotations

# host-only: tracing imports no device runtime; a traced batch launches
# the same kernels as an untraced one

import logging
import os
import random
import threading
import time
from collections import deque
from typing import Optional

from .telemetry import (
    JsonLinesFormatter,
    MaskingFilter,
    PrometheusExporter,
    _LOWERED_MASK_FIELDS,
)

# gRPC metadata key carrying (in) / echoing (out) the request trace id
TRACE_ID_METADATA_KEY = "x-acs-trace-id"

# the stage taxonomy (docs/OBSERVABILITY.md).  Stage names are the
# ``stage`` label of acs_stage_duration_seconds and the keys of
# Telemetry.snapshot()["stages"]; keep them stable.
STAGE_TRANSPORT_PARSE = "transport.parse"    # wire bytes -> request model
STAGE_ADMISSION = "admission"                # admission gate at submit
STAGE_QUEUE_WAIT = "queue.wait"              # submit -> batch collection
STAGE_PREPARE = "prepare"                    # token resolve / HR / prefetch
STAGE_CACHE = "cache.lookup"                 # decision-cache consult (hits)
STAGE_ENCODE = "encode"                      # request -> kernel arrays
STAGE_WIRE_ENCODE = "wire.encode"            # native C++ wire encode
STAGE_DEVICE = "device"                      # H2D + device eval + D2H
STAGE_DECODE = "decode"                      # kernel outputs -> responses
STAGE_ORACLE = "oracle"                      # scalar fallback walk
STAGE_SERIALIZE = "serialize"                # responses -> wire bytes

STAGES = (
    STAGE_TRANSPORT_PARSE, STAGE_ADMISSION, STAGE_QUEUE_WAIT, STAGE_PREPARE,
    STAGE_CACHE, STAGE_ENCODE, STAGE_WIRE_ENCODE, STAGE_DEVICE, STAGE_DECODE,
    STAGE_ORACLE, STAGE_SERIALIZE,
)


def trace_id_from_metadata(grpc_context) -> Optional[str]:
    """The client-provided ``x-acs-trace-id`` metadata value, if any."""
    try:
        for key, value in grpc_context.invocation_metadata() or ():
            if str(key).lower() == TRACE_ID_METADATA_KEY:
                return str(value)
    except Exception:  # noqa: BLE001 — non-grpc test doubles
        return None
    return None


def echo_trace_id(grpc_context, trace_id: str) -> None:
    """Echo the trace id on the response's trailing metadata."""
    try:
        grpc_context.set_trailing_metadata(
            ((TRACE_ID_METADATA_KEY, trace_id),)
        )
    except Exception:  # noqa: BLE001 — non-grpc test doubles
        pass


class Span:
    """One request's span tree: a trace id, a start instant and a flat
    list of (stage, duration) pairs.  Allocation-light (slots, one list);
    created only for sampled requests — unsampled requests still feed the
    stage histograms but never allocate a span."""

    __slots__ = ("trace_id", "t0", "stages", "_t_enqueue")

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.t0 = time.perf_counter()
        self.stages: list[tuple[str, float]] = []
        self._t_enqueue: Optional[float] = None

    def add(self, stage: str, duration_s: float) -> None:
        self.stages.append((stage, duration_s))

    def mark_enqueue(self) -> None:
        self._t_enqueue = time.perf_counter()

    def wall_s(self) -> float:
        return time.perf_counter() - self.t0

    def as_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "wall_ms": round(self.wall_s() * 1e3, 4),
            "stages": [
                {"stage": stage, "ms": round(duration * 1e3, 4)}
                for stage, duration in self.stages
            ],
        }


class StageTracer:
    """Per-worker stage tracing: histograms for every request (cheap),
    span retention for the sampled fraction.  All methods are safe to
    call from any serving thread."""

    def __init__(self, telemetry=None, sample_rate: float = 0.0,
                 max_traces: int = 256, rng: Optional[random.Random] = None):
        self.telemetry = telemetry
        self.sample_rate = float(sample_rate)
        self._rng = rng or random.Random()
        self._traces: deque = deque(maxlen=int(max_traces))  # guarded-by: _lock
        self._lock = threading.Lock()
        # local histogram store when no Telemetry is wired (unit tests)
        self._own_stages: dict = {}

    # ----------------------------------------------------------- histograms

    def observe(self, stage: str, duration_s: float) -> None:
        if self.telemetry is not None:
            self.telemetry.stage_histogram(stage).observe(duration_s)
        else:
            from .telemetry import Histogram

            hist = self._own_stages.get(stage)
            if hist is None:
                hist = self._own_stages.setdefault(stage, Histogram())
            hist.observe(duration_s)

    def record(self, span: Optional[Span], stage: str,
               duration_s: float) -> None:
        """Histogram observe + span attribution in one call — the
        instrumentation sites' single entry point."""
        self.observe(stage, duration_s)
        if span is not None:
            span.add(stage, duration_s)

    def fan_out(self, requests, stage: str, duration_s: float) -> None:
        """Batch-level stage: observe once, attribute the duration to
        every DISTINCT span among the member requests (a batch-wide RPC
        span attached to all rows gets the stage once, not B times)."""
        self.observe(stage, duration_s)
        seen = None
        for request in requests:
            span = getattr(request, "_span", None)
            if span is None:
                continue
            if seen is None:
                seen = set()
            if id(span) in seen:
                continue
            seen.add(id(span))
            span.add(stage, duration_s)

    # ---------------------------------------------------------------- spans

    def start_span(self, trace_id: Optional[str] = None) -> Optional[Span]:
        """A new span when sampled, else None.  An explicit client trace
        id always samples (the debugging contract of x-acs-trace-id)."""
        if trace_id is None:
            if self.sample_rate <= 0.0 or self._rng.random() >= self.sample_rate:
                return None
            trace_id = os.urandom(8).hex()
        return Span(trace_id)

    def finish(self, span: Optional[Span], decision: Optional[str] = None,
               code: Optional[int] = None) -> None:
        if span is None:
            return
        trace = span.as_dict()
        if decision is not None:
            trace["decision"] = decision
        if code is not None:
            trace["code"] = code
        with self._lock:
            self._traces.append(trace)

    def traces(self, n: Optional[int] = None) -> list[dict]:
        with self._lock:
            out = list(self._traces)
        return out if n is None else out[-int(n):]


class DecisionAuditLog:
    """Sampled JSONL decision-audit sink riding the masking logger
    machinery: one JSON object per sampled decision with subject /
    resource / action / decision / serving path / deciding rule id
    (oracle rows from the host walk's ``EffectEvaluation.source``;
    kernel rows from the explain-mode kernel output when
    ``explain:enabled`` is on, null otherwise).  Masking is
    double-layered: the record passes MaskingFilter (secret-named dict
    keys) AND target attributes whose ``id`` matches a mask field have
    their VALUE replaced before the record is built — a subject token
    attribute can never reach the sink."""

    def __init__(self, path: str, sample_rate: float = 1.0,
                 logger_name: str = "access-control-srv-tpu.audit",
                 rng: Optional[random.Random] = None):
        self.path = path
        self.sample_rate = float(sample_rate)
        self._rng = rng or random.Random()
        self.logger = logging.getLogger(logger_name)
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        if not any(isinstance(f, MaskingFilter) for f in self.logger.filters):
            self.logger.addFilter(MaskingFilter())
        self._handler = None
        if not any(
            getattr(h, "_acs_audit_sink", None) == path
            for h in self.logger.handlers
        ):
            handler = logging.FileHandler(path)
            handler.setFormatter(JsonLinesFormatter())
            handler._acs_audit_sink = path
            self.logger.addHandler(handler)
            self._handler = handler

    @staticmethod
    def _attrs(attributes) -> list[dict]:
        out = []
        for attr in attributes or []:
            attr_id = getattr(attr, "id", "") or ""
            value = getattr(attr, "value", "") or ""
            if any(f in attr_id.lower() for f in _LOWERED_MASK_FIELDS):
                value = "***"
            out.append({"id": attr_id, "value": value})
        return out

    def sampled(self) -> bool:
        return (self.sample_rate >= 1.0
                or self._rng.random() < self.sample_rate)

    def record(self, request, response,
               trace_id: Optional[str] = None) -> None:
        """Emit one audit record (caller already decided sampling)."""
        target = getattr(request, "target", None)
        subject = None
        context = getattr(request, "context", None)
        if isinstance(context, dict):
            ctx_subject = context.get("subject")
            if isinstance(ctx_subject, dict):
                subject = {"id": ctx_subject.get("id")}
        record = {
            "event": "decision",
            "trace_id": trace_id,
            "decision": response.decision,
            "code": response.operation_status.code,
            "cacheable": response.evaluation_cacheable,
            "path": getattr(response, "_path", None),
            "rule_id": getattr(response, "_rule_id", None),
            "subject": subject,
            "subjects": self._attrs(getattr(target, "subjects", None)),
            "resources": self._attrs(getattr(target, "resources", None)),
            "actions": self._attrs(getattr(target, "actions", None)),
        }
        self.logger.info("decision", extra={"audit": record})

    def maybe_record(self, request, response,
                     trace_id: Optional[str] = None) -> None:
        if self.sampled():
            self.record(request, response, trace_id)

    def close(self) -> None:
        if self._handler is not None:
            self._handler.close()
            self.logger.removeHandler(self._handler)
            self._handler = None


class Observability:
    """The per-worker observability hub: tracer + audit log + optional
    /metrics endpoint, built from the ``observability`` config block.
    ``from_config`` returns None unless the block is present AND
    ``enabled`` — every instrumentation site guards on that None, so an
    absent block leaves the serving path byte-identical to
    pre-observability code (the PR-5 admission pattern)."""

    def __init__(self, tracer: Optional[StageTracer] = None,
                 audit: Optional[DecisionAuditLog] = None,
                 exporter: Optional[PrometheusExporter] = None):
        self.tracer = tracer
        self.audit = audit
        self.exporter = exporter

    @classmethod
    def from_config(cls, cfg, telemetry=None,
                    logger=None) -> Optional["Observability"]:
        block = cfg.get("observability") if hasattr(cfg, "get") else None
        block = block or {}
        if not block.get("enabled"):
            return None
        tracer = None
        tracing = block.get("tracing") or {}
        if tracing.get("enabled", True):
            tracer = StageTracer(
                telemetry=telemetry,
                sample_rate=float(tracing.get("sample_rate", 0.01)),
                max_traces=int(tracing.get("max_traces", 256)),
            )
        audit = None
        audit_cfg = block.get("audit_log") or {}
        if audit_cfg.get("path"):
            audit = DecisionAuditLog(
                audit_cfg["path"],
                sample_rate=float(audit_cfg.get("sample_rate", 0.01)),
            )
        exporter = None
        http_cfg = block.get("metrics_http") or {}
        if http_cfg.get("enabled") and telemetry is not None:
            exporter = PrometheusExporter(
                telemetry,
                host=http_cfg.get("host", "127.0.0.1"),
                port=int(http_cfg.get("port", 9464)),
                logger=logger,
            )
        return cls(tracer=tracer, audit=audit, exporter=exporter)

    def close(self) -> None:
        if self.exporter is not None:
            self.exporter.close()
            self.exporter = None
        if self.audit is not None:
            self.audit.close()
            self.audit = None
