"""Deadline-aware admission control and overload protection.

The PDP sits on the request critical path of every protected service
(reference: src/accessControlService.ts serves one decision per gRPC
call), so overload must turn into CONTROLLED degradation — bounded
queues, early shedding, deadline-aware rejection — never unbounded
queueing and timeout storms.  This module is the host-side brain of that
behavior; it owns ZERO device state and imports no device runtime.

Pieces, all consumed by ``srv/batcher.MicroBatcher`` and the transports:

* **Deadline propagation** — gRPC deadlines (``context.time_remaining``)
  and the ``x-acs-timeout-ms`` metadata key become an absolute monotonic
  deadline attached per request (``request._deadline``); the batcher
  rejects at submit when the remaining budget cannot cover the current
  EWMA batch-latency estimate, and drops already-expired rows at
  dispatch instead of evaluating work nobody is waiting for.

* **Bounded two-class queues + shedding** — interactive (``isAllowed``)
  and bulk (``whatIsAllowed``/reverse) traffic are admitted against
  separate depth bounds.  A shed NEVER fabricates a PERMIT/DENY: the
  caller gets a fast INDETERMINATE whose ``operation_status`` carries the
  overload code (429 shed / 504 deadline / 503 shutdown drain).

* **Adaptive max-batch sizing** — the batch-latency EWMA drives the
  effective collection bound between a floor and the configured max, so
  a slow regime (oracle-heavy traffic, cold compile) shrinks batches
  toward the deadline bound instead of amplifying tail latency.

* **Dependency circuit breakers** — the adapter context-query and
  identity token-resolution clients share ``CircuitBreaker`` instances
  (closed/open/half-open, failure-rate windows, jittered probe) so a
  down upstream trips the existing per-row degradation ladder
  (kernel -> retry -> oracle / ``token-unresolved``) immediately instead
  of paying a transport timeout per request.

Config lives under the ``admission`` block (srv/config.py); everything
is OFF by default — with ``admission.enabled`` false the serving path is
byte-identical to the pre-admission behavior (asserted by
tests/test_admission.py's differential check).
"""

from __future__ import annotations

# host-only: admission decisions stay off the device runtime

import random
import re
import threading
import time
from typing import Optional

from ..models.model import Decision, OperationStatus, Response

# shed/overload operation-status codes: the caller must be able to tell
# "the service refused the work" from a decision — shed responses are
# INDETERMINATE, never a fabricated PERMIT/DENY
OVERLOAD_CODE = 429   # queue full / deadline-infeasible at submit
DEADLINE_CODE = 504   # deadline expired before evaluation (dropped at dispatch)
SHUTDOWN_CODE = 503   # still queued when the drain deadline hit
DEGRADED_CODE = 503   # the device path failed, timed out or is quarantined

INTERACTIVE = "interactive"
BULK = "bulk"

# end-to-end batches a freshly-admitted request can wait behind at the
# LEGACY depth-2 pipeline: its own collection round plus the batcher's
# two in-flight batches.  The live value is per-controller
# (``AdmissionController.pipeline_batches`` = configured
# evaluator:pipeline_depth + 1) so deadline-feasibility math tracks the
# real in-flight count at any depth; this constant remains the default.
PIPELINE_BATCHES = 3

# metadata key carrying a per-request timeout for clients that cannot set
# a native gRPC deadline (the rc-wire analog of grpc-timeout)
TIMEOUT_METADATA_KEY = "x-acs-timeout-ms"

# metadata key carrying the caller's policy domain (srv/tenancy.py).  The
# value is attacker-controlled and flows into cache keys, journal frames
# and Prometheus labels, so only a conservative id shape is accepted —
# anything else is treated as absent (single-tenant path).
TENANT_METADATA_KEY = "x-acs-tenant"
_TENANT_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")


def valid_tenant_id(value) -> Optional[str]:
    """``value`` as a tenant id when it matches the accepted shape."""
    tenant = str(value)
    return tenant if _TENANT_ID_RE.match(tenant) else None


def tenant_from_metadata(grpc_context) -> Optional[str]:
    """The (validated) ``x-acs-tenant`` metadata value, if any."""
    try:
        for key, value in grpc_context.invocation_metadata() or ():
            if str(key).lower() == TENANT_METADATA_KEY:
                return valid_tenant_id(value)
    except Exception:  # noqa: BLE001 — non-grpc test doubles
        return None
    return None


def overload_response(code: int, message: str) -> Response:
    """Fast INDETERMINATE + overload status — the shed envelope.  Never
    cacheable: a shed is a statement about THIS instant's load, not about
    the policy tree."""
    return Response(
        decision=Decision.INDETERMINATE,
        obligations=[],
        evaluation_cacheable=False,
        operation_status=OperationStatus(code=code, message=message),
    )


def degraded_response(message: str = "") -> Response:
    """Honest INDETERMINATE for rows the device path could not evaluate:
    a kernel call that raised or timed out, or a quarantined kernel
    path.  Distinct from the shed envelope: ``degraded`` in the message
    names the cause as a device-health event, not load.  Never
    cacheable, never a fabricated PERMIT/DENY."""
    detail = f"degraded: {message}" if message else "degraded"
    return Response(
        decision=Decision.INDETERMINATE,
        obligations=[],
        evaluation_cacheable=False,
        operation_status=OperationStatus(code=DEGRADED_CODE, message=detail),
    )


def deadline_from_context(grpc_context) -> Optional[float]:
    """Absolute monotonic deadline from a gRPC ServicerContext: the
    native call deadline when the client set one, else the
    ``x-acs-timeout-ms`` metadata key (rc-wire clients that cannot set
    gRPC deadlines).  None when the caller stated no budget."""
    remaining = None
    try:
        remaining = grpc_context.time_remaining()
    except Exception:  # noqa: BLE001 — non-grpc test doubles
        remaining = None
    if remaining is not None and remaining > 3600.0 * 24 * 365:
        # grpc-python reports ~int64-max SECONDS (not None) when the
        # client set no deadline; anything past a year is "unbounded"
        remaining = None
    if remaining is None:
        try:
            for key, value in grpc_context.invocation_metadata() or ():
                if str(key).lower() == TIMEOUT_METADATA_KEY:
                    remaining = float(value) / 1e3
                    break
        except Exception:  # noqa: BLE001
            remaining = None
    if remaining is None:
        return None
    return time.monotonic() + max(0.0, float(remaining))


def remaining_budget(deadline: Optional[float]) -> Optional[float]:
    """Seconds left before ``deadline`` (monotonic); None when unbounded."""
    if deadline is None:
        return None
    return deadline - time.monotonic()


class LatencyEwma:
    """Exponentially-weighted moving average of batch evaluation latency,
    one per traffic class.  ``estimate()`` answers the admission question
    "how long will the NEXT batch take" — before any sample it returns
    ``default_s`` (admit-friendly: an idle service must not shed its
    first request on a fictional estimate).

    Jitter-aware: alongside the mean, the mean absolute deviation is
    tracked TCP-RTO style (Jacobson: SRTT + 4*RTTVAR), and
    ``estimate_high()`` is the pessimistic bound deadline decisions use —
    with a jittery executor (GIL contention, noisy neighbors) the mean
    alone admits rows that then finish late."""

    def __init__(self, alpha: float = 0.2, default_s: float = 0.005):
        self.alpha = float(alpha)
        self.default_s = float(default_s)
        self._value: Optional[float] = None   # guarded-by: _lock
        self._dev = 0.0                       # guarded-by: _lock
        self._per_row: Optional[float] = None  # guarded-by: _lock
        self._lock = threading.Lock()

    def observe(self, seconds: float, rows: int = 1) -> None:
        seconds = max(0.0, float(seconds))
        per_row = seconds / max(1, rows)
        with self._lock:
            if self._value is None:
                self._value = seconds
                self._dev = seconds / 2.0
                self._per_row = per_row
            else:
                self._dev += self.alpha * (
                    abs(seconds - self._value) - self._dev
                )
                self._value += self.alpha * (seconds - self._value)
                self._per_row += self.alpha * (per_row - self._per_row)

    def estimate(self) -> float:
        with self._lock:
            return self.default_s if self._value is None else self._value

    def estimate_high(self) -> float:
        """Pessimistic next-batch estimate: mean + 4 * mean deviation."""
        with self._lock:
            if self._value is None:
                return self.default_s
            return self._value + 4.0 * self._dev

    def estimate_per_row(self) -> Optional[float]:
        with self._lock:
            return self._per_row


class BreakerOpenError(Exception):
    """Raised by callers that want the open-circuit fast failure to flow
    through their existing error ladders as an exception."""


class CircuitBreaker:
    """Closed / open / half-open dependency breaker with a failure-rate
    window and a jittered reopen probe.

    * CLOSED: calls flow; outcomes land in a sliding ``window_s`` window.
      When the window holds at least ``min_volume`` outcomes and the
      failure ratio reaches ``failure_ratio``, the breaker OPENS.
    * OPEN: ``allow()`` is False — callers fail fast down their existing
      degradation ladder (oracle fallback / token-unresolved) without
      paying the transport timeout.  After ``open_s`` (+0..50% jitter so
      a worker fleet does not probe in lockstep) the breaker moves to
      HALF-OPEN.
    * HALF-OPEN: up to ``half_open_probes`` in-flight probe calls are
      admitted; the first success CLOSES the breaker (window reset), the
      first failure re-OPENS it with a fresh cooldown.

    Shared state: one instance guards one upstream and is hit
    concurrently by every serving thread — all transitions are
    lock-guarded, and ``counter`` (Counter-like, ``.inc(key)``) receives
    ``<name>-open``/``<name>-close``/``<name>-fast-fail`` transitions for
    telemetry.admission."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half-open"

    def __init__(
        self,
        name: str,
        window_s: float = 10.0,
        min_volume: int = 8,
        failure_ratio: float = 0.5,
        open_s: float = 2.0,
        half_open_probes: int = 2,
        counter=None,
        time_fn=time.monotonic,
        rng: Optional[random.Random] = None,
    ):
        self.name = name
        self.window_s = float(window_s)
        self.min_volume = int(min_volume)
        self.failure_ratio = float(failure_ratio)
        self.open_s = float(open_s)
        self.half_open_probes = int(half_open_probes)
        self._counter = counter
        self._time = time_fn
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self._state = self.CLOSED  # guarded-by: _lock
        self._outcomes: list[tuple[float, bool]] = []  # (t, ok)  # guarded-by: _lock
        self._opened_at = 0.0      # guarded-by: _lock
        self._reopen_after = 0.0   # guarded-by: _lock
        self._probes_inflight = 0  # guarded-by: _lock
        self._transitions = {"opens": 0, "closes": 0, "fast_fails": 0}  # guarded-by: _lock

    # ------------------------------------------------------------- helpers

    def _count(self, key: str) -> None:  # holds: _lock
        self._transitions[key] = self._transitions.get(key, 0) + 1
        if self._counter is not None:
            self._counter.inc(f"breaker-{self.name}-{key.rstrip('s')}")

    def _prune(self, now: float) -> None:  # holds: _lock
        cutoff = now - self.window_s
        if self._outcomes and self._outcomes[0][0] < cutoff:
            self._outcomes = [o for o in self._outcomes if o[0] >= cutoff]

    def _open(self, now: float) -> None:  # holds: _lock
        self._state = self.OPEN
        self._opened_at = now
        # jittered cooldown: 1.0x..1.5x open_s so replicas don't probe a
        # recovering upstream in lockstep
        self._reopen_after = now + self.open_s * (1.0 + 0.5 * self._rng.random())
        self._probes_inflight = 0
        self._outcomes = []
        self._count("opens")

    # -------------------------------------------------------------- surface

    @property
    def state(self) -> str:
        with self._lock:
            now = self._time()
            if self._state == self.OPEN and now >= self._reopen_after:
                self._state = self.HALF_OPEN
                self._probes_inflight = 0
            return self._state

    def allow(self) -> bool:
        """True when the caller may attempt the upstream call.  In
        half-open, True claims one of the probe slots — the caller MUST
        report the outcome via record_success/record_failure."""
        with self._lock:
            now = self._time()
            if self._state == self.OPEN:
                if now < self._reopen_after:
                    self._count("fast_fails")
                    return False
                self._state = self.HALF_OPEN
                self._probes_inflight = 0
            if self._state == self.HALF_OPEN:
                if self._probes_inflight >= self.half_open_probes:
                    self._count("fast_fails")
                    return False
                self._probes_inflight += 1
                return True
            return True

    def record_success(self) -> None:
        with self._lock:
            now = self._time()
            if self._state == self.HALF_OPEN:
                # one healthy probe closes the circuit; the window restarts
                # empty so stale pre-open failures cannot re-trip it
                self._state = self.CLOSED
                self._outcomes = []
                self._probes_inflight = 0
                self._count("closes")
                return
            self._outcomes.append((now, True))
            self._prune(now)

    def record_failure(self) -> None:
        with self._lock:
            now = self._time()
            if self._state == self.HALF_OPEN:
                self._open(now)
                return
            if self._state == self.OPEN:
                return
            self._outcomes.append((now, False))
            self._prune(now)
            if len(self._outcomes) >= self.min_volume:
                failures = sum(1 for _, ok in self._outcomes if not ok)
                if failures / len(self._outcomes) >= self.failure_ratio:
                    self._open(now)

    def stats(self) -> dict:
        with self._lock:
            window = list(self._outcomes)
            state = self._state
            now = self._time()
            if state == self.OPEN and now >= self._reopen_after:
                state = self.HALF_OPEN
            transitions = dict(self._transitions)
        failures = sum(1 for _, ok in window if not ok)
        return {
            "state": state,
            "window_calls": len(window),
            "window_failures": failures,
            **transitions,
        }


class AdmissionController:
    """Per-worker admission state shared by the batcher, the service
    facade and the transports.  Construct via ``from_config``; a disabled
    controller (``enabled`` False) admits everything unconditionally and
    keeps the serving path byte-identical to pre-admission behavior.

    Depth accounting: ``admit`` increments the class depth, the batcher
    calls ``release`` as it collects rows off the queue — the bound
    covers queued work only, matching "bounded queue", not in-flight
    evaluation (that is the eval pipeline's depth-2 bound)."""

    def __init__(
        self,
        enabled: bool = False,
        max_queue_interactive: int = 8192,
        max_queue_bulk: int = 1024,
        deadline_headroom: float = 1.2,
        ewma_alpha: float = 0.2,
        ewma_default_ms: float = 5.0,
        adaptive_max_batch: bool = True,
        deadline_bound_ms: float = 50.0,
        min_batch: int = 64,
        drain_deadline_s: float = 5.0,
        bulk_interval: int = 4,
        pipeline_depth: int = PIPELINE_BATCHES - 1,
        tenant_enabled: bool = False,
        tenant_max_inflight: int = 256,
        tenant_default_weight: float = 1.0,
        tenant_weights: Optional[dict] = None,
        tenant_contention_ratio: float = 0.5,
        telemetry=None,
        time_fn=time.monotonic,
    ):
        self.enabled = bool(enabled)
        # batches a fresh request can wait behind: its own collection
        # round + the configured in-flight pipeline depth.  Shares the
        # evaluator:pipeline_depth config value with the batcher so the
        # feasibility estimate tracks the real in-flight count.
        self.pipeline_batches = max(1, int(pipeline_depth)) + 1
        self.max_queue = {
            INTERACTIVE: int(max_queue_interactive),
            BULK: int(max_queue_bulk),
        }
        self.deadline_headroom = float(deadline_headroom)
        self.adaptive_max_batch = bool(adaptive_max_batch)
        self.deadline_bound_s = float(deadline_bound_ms) / 1e3
        self.min_batch = int(min_batch)
        self.drain_deadline_s = float(drain_deadline_s)
        self.bulk_interval = max(1, int(bulk_interval))
        self.telemetry = telemetry
        self._time = time_fn
        self._lock = threading.Lock()
        self._depth = {INTERACTIVE: 0, BULK: 0}           # guarded-by: _lock
        self._max_depth_seen = {INTERACTIVE: 0, BULK: 0}  # guarded-by: _lock
        self._ewma = {
            INTERACTIVE: LatencyEwma(ewma_alpha, ewma_default_ms / 1e3),
            BULK: LatencyEwma(ewma_alpha, ewma_default_ms / 1e3),
        }
        self._adaptive_max: Optional[int] = None  # guarded-by: _lock
        self._last_batch_full = False
        self._draining = False  # guarded-by: _lock
        self._stats = {  # guarded-by: _lock
            "admitted": 0, "shed_queue_full": 0, "deadline_rejected": 0,
            "deadline_expired": 0, "shed_shutdown": 0,
            "shed_tenant_quota": 0, "shed_tenant_fair_share": 0,
        }
        # per-tenant quotas: inflight caps + weighted fair sharing over the
        # interactive queue.  All of it is skipped when the request carries
        # no tenant id, keeping the single-tenant path byte-identical.
        self.tenant_enabled = bool(tenant_enabled)
        self.tenant_max_inflight = int(tenant_max_inflight)
        self.tenant_default_weight = float(tenant_default_weight)
        self.tenant_weights = dict(tenant_weights or {})
        self.tenant_contention_ratio = float(tenant_contention_ratio)
        self._tenant_depth: dict[str, int] = {}  # guarded-by: _lock
        self.breakers: dict[str, CircuitBreaker] = {}  # guarded-by: _lock

    # ----------------------------------------------------------- construction

    @classmethod
    def from_config(cls, cfg, telemetry=None) -> "AdmissionController":
        """Build from the ``admission`` config block (srv/config.py); the
        breaker sub-block is consumed by ``breaker()`` below."""
        block = cfg.get("admission") if hasattr(cfg, "get") else None
        block = block or {}
        controller = cls(
            enabled=bool(block.get("enabled", False)),
            max_queue_interactive=block.get("max_queue_interactive", 8192),
            max_queue_bulk=block.get("max_queue_bulk", 1024),
            deadline_headroom=block.get("deadline_headroom", 1.2),
            ewma_alpha=block.get("ewma_alpha", 0.2),
            ewma_default_ms=block.get("ewma_default_ms", 5.0),
            adaptive_max_batch=block.get("adaptive_max_batch", True),
            deadline_bound_ms=block.get("deadline_bound_ms", 50.0),
            min_batch=block.get("min_batch", 64),
            drain_deadline_s=block.get("drain_deadline_s", 5.0),
            bulk_interval=block.get("bulk_interval", 4),
            pipeline_depth=(cfg.get("evaluator") or {}).get(
                "pipeline_depth", PIPELINE_BATCHES - 1
            ) if hasattr(cfg, "get") else PIPELINE_BATCHES - 1,
            tenant_enabled=bool((block.get("tenant") or {}).get(
                "enabled", True
            )),
            tenant_max_inflight=(block.get("tenant") or {}).get(
                "max_inflight_per_tenant", 256
            ),
            tenant_default_weight=(block.get("tenant") or {}).get(
                "default_weight", 1.0
            ),
            tenant_weights=(block.get("tenant") or {}).get("weights"),
            tenant_contention_ratio=(block.get("tenant") or {}).get(
                "contention_ratio", 0.5
            ),
            telemetry=telemetry,
        )
        controller._breaker_cfg = dict(block.get("breakers") or {})
        return controller

    def breaker(self, name: str) -> Optional[CircuitBreaker]:
        """The shared breaker guarding upstream ``name`` (one per
        upstream, created on first ask from the ``admission:breakers``
        config block); None when breakers are disabled."""
        cfg = getattr(self, "_breaker_cfg", {})
        if not self.enabled or not cfg.get("enabled", True):
            return None
        with self._lock:
            if name not in self.breakers:
                counter = (
                    self.telemetry.admission
                    if self.telemetry is not None else None
                )
                self.breakers[name] = CircuitBreaker(
                    name,
                    window_s=cfg.get("window_s", 10.0),
                    min_volume=cfg.get("min_volume", 8),
                    failure_ratio=cfg.get("failure_ratio", 0.5),
                    open_s=cfg.get("open_s", 2.0),
                    half_open_probes=cfg.get("half_open_probes", 2),
                    counter=counter,
                )
            return self.breakers[name]

    # -------------------------------------------------------------- counters

    def _count(self, key: str, by: int = 1) -> None:
        with self._lock:
            self._stats[key] = self._stats.get(key, 0) + by
        if self.telemetry is not None:
            self.telemetry.admission.inc(key.replace("_", "-"), by)

    # -------------------------------------------------------------- admission

    def tenant_weight(self, tenant: str) -> float:
        return float(self.tenant_weights.get(
            tenant, self.tenant_default_weight
        ))

    def _tenant_shed(self, cls: str, tenant: str  # holds: _lock NOT held
                     ) -> Optional[Response]:
        """Per-tenant quota gate: inflight cap always, weighted fair
        share only once the class queue is contended — an uncontended
        queue lets one tenant use the whole depth (work-conserving)."""
        with self._lock:
            mine = self._tenant_depth.get(tenant, 0)
            if mine >= self.tenant_max_inflight:
                verdict = "quota"
            else:
                verdict = None
                total = self._depth[cls]
                contended = total >= (
                    self.max_queue[cls] * self.tenant_contention_ratio
                )
                if contended and cls == INTERACTIVE:
                    # fair bound: this tenant's weight share of the queue
                    # over the weights of every tenant currently holding
                    # slots (including this one)
                    active = set(
                        t for t, d in self._tenant_depth.items() if d > 0
                    )
                    active.add(tenant)
                    total_w = sum(self.tenant_weight(t) for t in active)
                    share = self.tenant_weight(tenant) / max(total_w, 1e-9)
                    bound = max(1, int(self.max_queue[cls] * share))
                    if mine >= bound:
                        verdict = "fair_share"
        if verdict is None:
            return None
        self._count(f"shed_tenant_{verdict}")
        tenant_inc = getattr(self.telemetry, "tenant_inc", None) \
            if self.telemetry is not None else None
        if tenant_inc is not None:
            tenant_inc("shed", tenant)
        reason = (
            f"tenant {tenant} inflight cap ({self.tenant_max_inflight})"
            if verdict == "quota"
            else f"tenant {tenant} over fair share of {cls} queue"
        )
        return overload_response(OVERLOAD_CODE, reason)

    def admit(self, cls: str, deadline: Optional[float] = None,
              tenant: Optional[str] = None) -> Optional[Response]:
        """Admission decision for one request of traffic class ``cls``:
        None admits (depth incremented — pair with ``release``), a
        Response is the shed envelope to resolve the caller with
        immediately.  ``tenant`` engages the per-tenant quota gates; None
        skips them entirely (byte-identical single-tenant path)."""
        if not self.enabled:
            return None
        # acs-lint: ignore[guarded-by] benign racy read of a one-way flag:
        # a request admitted during the begin_drain() window still drains
        # within the batcher's drain deadline
        if self._draining:
            self._count("shed_shutdown")
            return overload_response(SHUTDOWN_CODE, "shutting down")
        if tenant is not None and self.tenant_enabled:
            shed = self._tenant_shed(cls, tenant)
            if shed is not None:
                return shed
        if deadline is not None:
            remaining = deadline - self._time()
            ewma = self._ewma[cls]
            # MEAN estimate here: the pessimistic (mean + 4*dev) bound
            # multiplied across the pipeline would triple-count the
            # jitter margin and collapse to reject-all under load — the
            # eval-time expiry gate (batcher._drop_expired with the
            # estimate_high margin) is what protects the admitted p99
            estimate = ewma.estimate()
            # the wait estimate covers the full path: the queue already
            # ahead of this request, plus the batcher's eval pipeline
            # (own collection round + up to two in-flight batches).
            # Joining a deep queue with a tight budget only to expire at
            # dispatch wastes a slot AND the caller's time — reject NOW
            # instead of evaluating a decision the caller will have
            # abandoned
            per_row = ewma.estimate_per_row() or 0.0
            with self._lock:
                queued_ahead = self._depth[cls]
            estimate = (
                estimate * self.pipeline_batches + queued_ahead * per_row
            )
            if remaining < estimate * self.deadline_headroom:
                self._count("deadline_rejected")
                if self.telemetry is not None:
                    self.telemetry.admission_budget.observe(
                        max(0.0, remaining)
                    )
                return overload_response(
                    OVERLOAD_CODE,
                    f"deadline infeasible: {remaining * 1e3:.1f} ms budget "
                    f"< {estimate * self.deadline_headroom * 1e3:.1f} ms "
                    f"estimated latency ({queued_ahead} queued ahead)",
                )
        with self._lock:
            depth = self._depth[cls]
            if depth >= self.max_queue[cls]:
                shed = True
            else:
                shed = False
                self._depth[cls] = depth + 1
                if self._depth[cls] > self._max_depth_seen[cls]:
                    self._max_depth_seen[cls] = self._depth[cls]
                if tenant is not None and self.tenant_enabled:
                    self._tenant_depth[tenant] = (
                        self._tenant_depth.get(tenant, 0) + 1
                    )
        if shed:
            self._count("shed_queue_full")
            return overload_response(
                OVERLOAD_CODE,
                f"{cls} queue full ({self.max_queue[cls]})",
            )
        self._count("admitted")
        if self.telemetry is not None:
            self.telemetry.admission_queue_depth.observe(depth + 1)
            if deadline is not None:
                self.telemetry.admission_budget.observe(
                    max(0.0, deadline - self._time())
                )
        return None

    def release(self, cls: str, n: int = 1,
                tenant: Optional[str] = None) -> None:
        """The batcher collected ``n`` admitted rows off the queue."""
        if n <= 0:
            return
        with self._lock:
            self._depth[cls] = max(0, self._depth[cls] - n)
            if tenant is not None and tenant in self._tenant_depth:
                left = self._tenant_depth[tenant] - n
                if left > 0:
                    self._tenant_depth[tenant] = left
                else:
                    # drop empty slots so offboarded tenants don't pin
                    # dict entries forever
                    del self._tenant_depth[tenant]

    def expired(self, n: int = 1) -> None:
        """``n`` admitted rows were dropped at dispatch with an expired
        deadline (counted separately from submit-time rejection)."""
        self._count("deadline_expired", n)

    def shed_shutdown(self, n: int = 1) -> None:
        """``n`` already-queued rows were failed with the shutdown status
        at the drain deadline."""
        self._count("shed_shutdown", n)

    def depth(self, cls: str) -> int:
        with self._lock:
            return self._depth[cls]

    # --------------------------------------------------------- batch sizing

    def observe_batch(self, cls: str, seconds: float, rows: int) -> None:
        """Feed the latency EWMA and adapt the effective max-batch.  A
        request's end-to-end wait spans up to ``pipeline_batches`` batch
        evaluations, so the per-batch target is deadline_bound /
        pipeline_batches (with margin: +1): batches overshooting it halve
        the collection cap; comfortable full batches (< half the target)
        grow it back toward the configured max."""
        self._ewma[cls].observe(seconds, rows)
        if cls != INTERACTIVE or not self.adaptive_max_batch:
            return
        target = self.deadline_bound_s / (self.pipeline_batches + 1)
        with self._lock:
            current = self._adaptive_max
            if current is None:
                return  # suggest_max_batch not consulted yet
            if seconds > target and rows >= self.min_batch:
                self._adaptive_max = max(self.min_batch, current // 2)
            elif seconds < target / 2 and rows >= current:
                self._adaptive_max = current * 2

    def suggest_max_batch(self, configured_max: int) -> int:
        if not self.enabled or not self.adaptive_max_batch:
            return configured_max
        with self._lock:
            if self._adaptive_max is None:
                # slow start: begin at the floor and double on comfortable
                # FULL batches (observe_batch) — starting at the
                # configured max would let the first overload batches run
                # far past the deadline bound before halving converges
                self._adaptive_max = max(
                    1, min(int(configured_max), self.min_batch)
                )
            self._adaptive_max = min(self._adaptive_max, int(configured_max))
            return max(1, self._adaptive_max)

    def estimate(self, cls: str = INTERACTIVE) -> float:
        return self._ewma[cls].estimate()

    def estimate_high(self, cls: str = INTERACTIVE) -> float:
        """Jitter-pessimistic batch-latency bound (mean + 4*deviation) —
        what deadline feasibility and the eval-time expiry margin use."""
        return self._ewma[cls].estimate_high()

    # ---------------------------------------------------------------- drain

    def begin_drain(self) -> None:
        """Stop admitting (every subsequent admit sheds with the shutdown
        status); already-admitted work keeps flowing until the batcher's
        drain deadline."""
        with self._lock:
            self._draining = True

    @property
    def draining(self) -> bool:
        # acs-lint: ignore[guarded-by] benign racy read of a one-way flag
        return self._draining

    # ---------------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._lock:
            out = {
                "enabled": self.enabled,
                "pipeline_batches": self.pipeline_batches,
                "draining": self._draining,
                **self._stats,
                "queue_depth": dict(self._depth),
                "max_queue_depth_seen": dict(self._max_depth_seen),
                "max_queue": dict(self.max_queue),
                "adaptive_max_batch": self._adaptive_max,
            }
            if self.tenant_enabled and self._tenant_depth:
                top = sorted(
                    self._tenant_depth.items(),
                    key=lambda kv: kv[1], reverse=True,
                )[:8]
                out["tenant_queue_depth"] = dict(top)
            breakers = dict(self.breakers)
        out["batch_latency_estimate_ms"] = {
            cls: round(ewma.estimate() * 1e3, 3)
            for cls, ewma in self._ewma.items()
        }
        out["breakers"] = {
            name: breaker.stats() for name, breaker in breakers.items()
        }
        return out
