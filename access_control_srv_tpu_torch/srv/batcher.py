"""Micro-batching frontend for isAllowed (and, under admission control,
whatIsAllowed as the bulk traffic class).

The reference evaluates one request per gRPC call
(reference: src/accessControlService.ts:62-81); the device path earns its
throughput by batching.  Concurrent callers submit requests; a collector
drains the queue every ``window_ms`` (or at ``max_batch``) and evaluates
the whole batch through the hybrid evaluator, resolving each caller's
future.  Single outstanding requests skip the device path entirely (the
oracle answers faster than an encode + device round-trip).

Pipelining: evaluation runs on a dedicated single-worker executor while
the collector keeps collecting AND runs the host-side eligibility pipeline
(``evaluator.prepare_batch``: batched token resolution + HR-scope
rendezvous) for batch i+1 — host RPC latency for the next batch overlaps
device execution of the current one.  At most one batch is queued behind
the one evaluating, so backpressure still reaches callers through their
futures.

Admission control (srv/admission.py, config ``admission`` block): with a
controller wired, submits pass a bounded-queue + deadline-feasibility
gate (shed -> fast INDETERMINATE with the overload status, never a
fabricated decision), rows whose deadline expired while queued are
dropped at dispatch, the collection cap adapts to the batch-latency EWMA,
and a second BULK queue carries whatIsAllowed reverse queries with a
fairness guarantee: under interactive saturation a bulk round still runs
every ``bulk_interval`` interactive rounds, so neither class starves the
other.  Without a controller (or with ``admission.enabled`` false) the
serving path is byte-identical to the pre-admission behavior.

Shutdown drains: ``stop()`` stops admitting, flushes already-admitted
batches to completion bounded by a drain deadline, and resolves anything
still queued with a distinct shutdown status instead of leaving caller
futures hanging."""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

from ..models.model import Request, Response, ReverseQuery
from .admission import (
    DEADLINE_CODE,
    SHUTDOWN_CODE,
    AdmissionController,
    BULK,
    INTERACTIVE,
    overload_response,
)


def count_error(evaluator, path: str, rows: int, err: BaseException) -> None:
    """``evaluator.count_error`` where the evaluator has one."""
    hook = getattr(evaluator, "count_error", None)
    if hook is not None:
        hook(path, rows, err)


class MicroBatcher:
    def __init__(
        self,
        evaluator,
        window_ms: float = 2.0,
        max_batch: int = 4096,
        min_kernel_batch: int = 8,
        admission: Optional[AdmissionController] = None,
        observability=None,
        pipeline_depth: int = 2,
    ):
        self.evaluator = evaluator
        self.window_s = window_ms / 1000.0
        self.max_batch = max_batch
        self.min_kernel_batch = min_kernel_batch
        self.admission = admission
        # device pipeline depth (config evaluator:pipeline_depth — the
        # same value admission's feasibility estimate reads).  Depth <= 2
        # is the LEGACY path, byte-identical to pre-pipeline behavior:
        # blocking evaluate on the eval worker, at most depth batches in
        # flight.  Depth > 2 splits evaluation into dispatch (encode +
        # device enqueue, on the eval worker, in collection order) and
        # finalize (materialize + decode + future resolution, on a
        # dedicated worker, FIFO) so H2D/eval of batch i overlaps prep of
        # i+1 and decode of i-1 — requires the evaluator's async split
        # (HybridEvaluator.is_allowed_batch_async).
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._async_pipeline = (
            self.pipeline_depth > 2
            and hasattr(evaluator, "is_allowed_batch_async")
        )
        # observability hub (srv/tracing.Observability): records the
        # admission and queue-wait stages.  None keeps submit/dispatch on
        # the exact pre-observability path.
        self.obs = observability
        # queue items are (request, future, deadline) — deadline is an
        # absolute monotonic instant or None
        self._queue: "queue.Queue[tuple[Request, Future, Optional[float]]]" \
            = queue.Queue()
        self._bulk: "queue.Queue[tuple[Request, Future, Optional[float]]]" \
            = queue.Queue()
        self._stop = threading.Event()
        self._stopping = False  # set before _stop: submits shed immediately
        self._drain_deadline: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._eval_pool: Optional[ThreadPoolExecutor] = None
        self._finalize_pool: Optional[ThreadPoolExecutor] = None
        self._inflight: list = []  # evaluation futures, FIFO
        self._last_batch = 0  # previous round's size (regime detector)
        self._rounds_since_bulk = 0
        # multi-tenant registry (srv/tenancy.TenantRegistry), wired by the
        # worker when the ``tenancy`` config block is enabled.  None keeps
        # every row — tenant-tagged or not — on the default-domain path.
        self.tenancy = None

    def start(self) -> None:
        if self._thread is None:
            self._stopping = False
            self._stop.clear()
            self._eval_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="acs-batch-eval"
            )
            if self._async_pipeline:
                # finalize worker: materializes device results, decodes
                # and resolves caller futures in dispatch order (FIFO)
                self._finalize_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="acs-batch-finalize"
                )
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def stop(self, drain_s: Optional[float] = None) -> None:
        """Graceful drain: stop admitting, flush already-admitted batches
        to completion (bounded by ``drain_s``, default from the admission
        controller or 5 s), then fail anything still queued with the
        shutdown status."""
        if drain_s is None:
            drain_s = (
                self.admission.drain_deadline_s
                if self.admission is not None else 5.0
            )
        self._stopping = True
        if self.admission is not None:
            self.admission.begin_drain()
        self._drain_deadline = time.monotonic() + max(0.0, float(drain_s))
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(5.0, float(drain_s) + 5.0))
            self._thread = None
        if self._eval_pool is not None:
            self._eval_pool.shutdown(wait=True)
            self._eval_pool = None
        if self._finalize_pool is not None:
            self._finalize_pool.shutdown(wait=True)
            self._finalize_pool = None
        self._inflight = []
        # anything the drain loop could not flush before the deadline:
        # resolve with the shutdown status instead of leaving the caller's
        # future hanging forever
        self._fail_queued(self._queue, INTERACTIVE)
        self._fail_queued(self._bulk, BULK)

    def _fail_queued(self, q: "queue.Queue", cls: str) -> None:
        items = []
        while True:
            try:
                items.append(q.get_nowait())
            except queue.Empty:
                break
        for _, future, _ in items:
            if not future.done():
                future.set_result(
                    self._shutdown_result(cls)
                )
        if items and self.admission is not None:
            self._release(cls, items)
            self.admission.shed_shutdown(len(items))

    def _release(self, cls: str, items: list) -> None:
        """Release admission slots for collected rows — grouped per
        tenant so the quota ledger tracks the class ledger exactly."""
        counts: dict = {}
        for req, _, _ in items:
            tenant = getattr(req, "_tenant", None)
            counts[tenant] = counts.get(tenant, 0) + 1
        for tenant, n in counts.items():
            self.admission.release(cls, n, tenant=tenant)

    @staticmethod
    def _shutdown_result(cls: str):
        response = overload_response(
            SHUTDOWN_CODE, "shut down before evaluation"
        )
        if cls == BULK:
            return ReverseQuery(
                policy_sets=[], obligations=[],
                operation_status=response.operation_status,
            )
        return response

    # ---------------------------------------------------------------- submit

    def submit(
        self, request: Request, deadline: Optional[float] = None
    ) -> "Future[Response]":
        future: "Future[Response]" = Future()
        # decision-cache fast path: a warm cacheable request resolves
        # immediately instead of waiting out the collection window (and
        # never occupies a batch slot or an admission slot).  The caller
        # thread already ran prepare_context (srv/service.py), so the
        # fingerprint is stable.
        cache = getattr(self.evaluator, "decision_cache", None)
        if cache is not None and cache.enabled:
            obs_tracer = self.obs.tracer if self.obs is not None else None
            t_cache = time.perf_counter() if obs_tracer is not None else 0.0
            engine = getattr(self.evaluator, "engine", None)
            urns = getattr(engine, "urns", None)
            subject_urn = (urns.get("subjectID") if urns else "") or ""
            hit = cache.get(cache.fingerprint(request, subject_urn))
            if hit is not None:
                count = getattr(self.evaluator, "_count_path", None)
                if count is not None:
                    count("cache-hit", 1)
                if obs_tracer is not None:
                    from .tracing import STAGE_CACHE

                    obs_tracer.record(getattr(request, "_span", None),
                                      STAGE_CACHE,
                                      time.perf_counter() - t_cache)
                    hit._path = "cache-hit"
                future.set_result(hit)
                return future
        if self._stopping:
            future.set_result(self._shutdown_result(INTERACTIVE))
            return future
        tracer = self.obs.tracer if self.obs is not None else None
        if self.admission is not None:
            t0 = time.perf_counter() if tracer is not None else 0.0
            shed = self.admission.admit(
                INTERACTIVE, deadline,
                tenant=getattr(request, "_tenant", None),
            )
            if tracer is not None:
                from .tracing import STAGE_ADMISSION

                tracer.record(getattr(request, "_span", None),
                              STAGE_ADMISSION, time.perf_counter() - t0)
            if shed is not None:
                future.set_result(shed)
                return future
        if tracer is not None:
            # queue-wait start: closed at collection in _dispatch_*
            request._t_enqueue = time.perf_counter()
            span = getattr(request, "_span", None)
            if span is not None:
                span.mark_enqueue()
        self._queue.put((request, future, deadline))
        return future

    def submit_reverse(
        self, request: Request, deadline: Optional[float] = None
    ) -> "Future":
        """Bulk-class submission: a whatIsAllowed reverse query resolved
        with a ReverseQuery.  Only routed here under admission control
        (srv/service.py keeps the direct caller-thread walk otherwise).

        Deliberately NO decision-cache interaction, in either direction
        (contrast ``submit`` above): reverse queries resolve with policy
        trees, not decisions, so there is nothing meaningful to serve
        from — or insert into — the isAllowed cache, and a bulk audit
        sweep (srv/audit_sweep.py) walking a whole permission lattice
        through here must never evict interactive tenants' warm working
        sets.  Regression-pinned: tests/test_audit_sweep.py
        ``test_sweep_never_pollutes_decision_cache``."""
        future: Future = Future()
        if self._stopping:
            future.set_result(self._shutdown_result(BULK))
            return future
        if self.admission is not None:
            shed = self.admission.admit(
                BULK, deadline, tenant=getattr(request, "_tenant", None),
            )
            if shed is not None:
                future.set_result(ReverseQuery(
                    policy_sets=[], obligations=[],
                    operation_status=shed.operation_status,
                ))
                return future
        self._bulk.put((request, future, deadline))
        return future

    def is_allowed(self, request: Request, timeout: float = 30.0) -> Response:
        return self.submit(request).result(timeout=timeout)

    # ----------------------------------------------------------------- loop

    def _effective_max_batch(self) -> int:
        if self.admission is not None:
            return self.admission.suggest_max_batch(self.max_batch)
        return self.max_batch

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                # pending bulk work shortens the idle poll so a lone
                # reverse query is not parked for the full 100 ms
                poll = 0.005 if not self._bulk.empty() else 0.1
                first = self._queue.get(timeout=poll)
            except queue.Empty:
                # idle interactive round: bulk work proceeds immediately
                # instead of waiting out the fairness interval
                if not self._bulk.empty():
                    self._serve_bulk()
                continue
            batch = [first]
            max_batch = self._effective_max_batch()
            # the collection window closes window_s after the FIRST item;
            # later arrivals only get the remaining slice, so a steady
            # trickle cannot stretch collection toward max_batch * window.
            # Adaptive first-item grace: in the IDLE regime (the previous
            # round collected under min_kernel_batch) a lone request only
            # pays a short grace instead of the full window — measured
            # on-chip, single-stream p50 tracks the window ~1:1 (window +
            # ~0.8 ms) while concurrent arrivals land within a fraction
            # of a millisecond.  In the BUSY regime the full window
            # applies from the first item, so sustained traffic with
            # inter-arrivals just above the grace still aggregates into
            # kernel-sized batches instead of degenerating to batch-of-1.
            close_at = time.monotonic() + self.window_s
            busy = self._last_batch >= self.min_kernel_batch
            grace = self.window_s if busy else min(self.window_s, 0.0002)
            try:
                if len(batch) < max_batch:
                    batch.append(self._queue.get(timeout=grace))
                while len(batch) < max_batch:
                    remaining = close_at - time.monotonic()
                    if remaining <= 0:
                        break
                    batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                pass
            self._last_batch = len(batch)
            self._dispatch_interactive(batch)
            # two-class fairness: under interactive saturation, a bulk
            # round still runs every ``bulk_interval`` interactive rounds
            self._rounds_since_bulk += 1
            interval = (
                self.admission.bulk_interval
                if self.admission is not None else 4
            )
            if (
                not self._bulk.empty()
                and self._rounds_since_bulk >= interval
            ):
                self._serve_bulk()
        # ------------------------------------------------------------ drain
        # stop admitting happened in stop(); flush what was already
        # admitted, bounded by the drain deadline, so accepted work is
        # answered rather than abandoned
        drain_until = self._drain_deadline or time.monotonic()
        while time.monotonic() < drain_until:
            batch = []
            max_batch = self._effective_max_batch()
            while len(batch) < max_batch:
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            if batch:
                self._dispatch_interactive(batch)
            elif not self._bulk.empty():
                self._serve_bulk()
            else:
                break
        for fut in self._inflight:
            try:
                fut.result(timeout=max(0.1, drain_until - time.monotonic()))
            except Exception:  # noqa: BLE001 — drain best-effort
                pass
        self._inflight = []

    # ------------------------------------------------------------- dispatch

    def _dispatch_interactive(self, batch: list) -> None:
        if self.admission is not None:
            self._release(INTERACTIVE, batch)
            batch = self._drop_expired(batch)
            if not batch:
                return
        # tenant partition: rows tagged with a tenant id (and a registry
        # to serve them) peel off to their tenant's evaluator — one
        # collection window mixes tenants, the device sees one kernel
        # call per tenant group on the class-shared program.  With no
        # registry or no tags this is a no-op and the batch flows down
        # the exact single-tenant path.
        if self.tenancy is not None:
            groups: dict = {}
            default_rows = []
            for item in batch:
                tenant = getattr(item[0], "_tenant", None)
                if tenant is None:
                    default_rows.append(item)
                else:
                    groups.setdefault(tenant, []).append(item)
            if groups:
                while len(self._inflight) >= self._inflight_bound():
                    self._inflight.pop(0).result()
                self._inflight = [
                    f for f in self._inflight if not f.done()
                ]
                self._inflight.append(
                    self._eval_pool.submit(self._eval_tenants, groups)
                )
                if not default_rows:
                    return
                batch = default_rows
        tracer = self.obs.tracer if self.obs is not None else None
        if tracer is not None:
            from .tracing import STAGE_QUEUE_WAIT

            now = time.perf_counter()
            for request, _, _ in batch:
                t_enqueue = getattr(request, "_t_enqueue", None)
                if t_enqueue is not None:
                    tracer.record(getattr(request, "_span", None),
                                  STAGE_QUEUE_WAIT, now - t_enqueue)
        # host-side eligibility pipeline for THIS batch runs on the
        # collector thread while the PREVIOUS batch is still evaluating
        # on the eval worker — token resolution / HR rendezvous latency
        # overlaps device execution (prepare_batch is idempotent; a
        # failure here just leaves rows unprepared, and the encoder
        # degrades them to the oracle)
        prepare = getattr(self.evaluator, "prepare_batch", None)
        if prepare is not None:
            try:
                prepare([req for req, _, _ in batch])
            except Exception as err:  # noqa: BLE001 — rows stay unprepared
                count_error(self.evaluator, "batch-prepare-error",
                            len(batch), err)
        # bounded pipeline: at most pipeline_depth batches between
        # collection and decode completion (legacy depth 2: one batch
        # evaluating + one queued at most)
        while len(self._inflight) >= self._inflight_bound():
            self._inflight.pop(0).result()
        self._inflight = [f for f in self._inflight if not f.done()]
        if self._async_pipeline:
            # dispatch/finalize split: encode + device enqueue runs on
            # the eval worker in collection order; materialize + decode +
            # future resolution on the finalize worker, FIFO — device
            # execution of batch i overlaps dispatch of i+1 and decode
            # of i-1
            done: Future = Future()
            self._eval_pool.submit(self._dispatch_async, batch, done)
            self._inflight.append(done)
        else:
            self._inflight.append(
                self._eval_pool.submit(self._eval_batch, batch)
            )

    def _inflight_bound(self) -> int:
        """Depth bound on batches between collection and finalize: the
        configured pipeline depth on the async path, the legacy bound
        (at most 2: one evaluating + one queued) otherwise — depth 1
        degenerates to fully synchronous dispatch either way."""
        if self._async_pipeline:
            return self.pipeline_depth
        return min(self.pipeline_depth, 2)

    def _dispatch_async(self, batch: list, done: "Future") -> None:
        """Dispatch stage (eval worker): drop rows that expired while the
        pipeline was full, run the evaluator's dispatch half (prepare /
        cache lookups / encode + device enqueue), then hand the finalize
        half to the finalize worker.  ``done`` resolves when the batch is
        fully finalized — the collector's depth bound waits on it."""
        t0 = time.perf_counter()
        try:
            if self.admission is not None:
                batch = self._drop_expired(
                    batch,
                    margin_s=self.admission.estimate_high(INTERACTIVE),
                )
                if not batch:
                    done.set_result(None)
                    return
            finalize = None
            if len(batch) >= self.min_kernel_batch:
                try:
                    finalize = self.evaluator.is_allowed_batch_async(
                        [req for req, _, _ in batch]
                    )
                except Exception as err:  # noqa: BLE001
                    # poisoned dispatch: row by row at finalize
                    finalize = None
                    count_error(self.evaluator, "batch-dispatch-error",
                                len(batch), err)
            self._finalize_pool.submit(
                self._finalize_batch, batch, finalize, t0, done
            )
        except BaseException:
            if not done.done():
                done.set_result(None)
            raise

    def _finalize_batch(self, batch: list, finalize, t0: float,
                        done: "Future") -> None:
        """Finalize stage (finalize worker, FIFO): materialize the device
        result, decode, resolve caller futures — the async twin of
        ``_eval_batch``'s resolution half."""
        try:
            responses = None
            if finalize is not None:
                try:
                    responses = finalize()
                except Exception as err:  # noqa: BLE001
                    # one poisoned request must not deny the whole batch
                    responses = None
                    count_error(self.evaluator, "batch-finalize-error",
                                len(batch), err)
            if responses is not None:
                for (_, future, _), response in zip(batch, responses):
                    future.set_result(response)
            else:
                self._resolve_each(batch)
            if self.admission is not None:
                self.admission.observe_batch(
                    INTERACTIVE, time.perf_counter() - t0, len(batch)
                )
        finally:
            if not done.done():
                done.set_result(None)

    def _drop_expired(self, batch: list, margin_s: float = 0.0) -> list:
        """Rows whose deadline passed while queued resolve with the
        deadline status NOW — evaluating them would burn a batch slot on
        an answer the caller has already abandoned.  ``margin_s`` extends
        the cut to rows that cannot SURVIVE the work ahead: the eval-time
        pass uses the batch-latency estimate so a row with 1 ms of budget
        never rides a 10 ms batch into a late answer."""
        now = time.monotonic() + margin_s
        live = []
        expired = 0
        for item in batch:
            deadline = item[2]
            if deadline is not None and deadline <= now:
                expired += 1
                if not item[1].done():
                    item[1].set_result(overload_response(
                        DEADLINE_CODE, "deadline expired before evaluation"
                    ))
            else:
                live.append(item)
        if expired and self.admission is not None:
            self.admission.expired(expired)
        return live

    def _drop_expired_bulk(self, items: list) -> list:
        """Bulk-class twin of ``_drop_expired``: expired reverse queries
        resolve with a deadline-status ReverseQuery."""
        now = time.monotonic()
        live = []
        expired = 0
        for item in items:
            deadline = item[2]
            if deadline is not None and deadline <= now:
                expired += 1
                if not item[1].done():
                    item[1].set_result(ReverseQuery(
                        policy_sets=[], obligations=[],
                        operation_status=overload_response(
                            DEADLINE_CODE,
                            "deadline expired before evaluation",
                        ).operation_status,
                    ))
            else:
                live.append(item)
        if expired and self.admission is not None:
            self.admission.expired(expired)
        return live

    def _serve_bulk(self) -> None:
        """Drain one bulk round (bounded by max_batch) onto the eval
        pipeline; reverse queries batch through the device-assisted
        what_is_allowed_batch path."""
        self._rounds_since_bulk = 0
        items = []
        while len(items) < self.max_batch:
            try:
                items.append(self._bulk.get_nowait())
            except queue.Empty:
                break
        if not items:
            return
        if self.admission is not None:
            self._release(BULK, items)
            items = self._drop_expired_bulk(items)
        if not items:
            return
        while len(self._inflight) >= self._inflight_bound():
            self._inflight.pop(0).result()
        self._inflight = [f for f in self._inflight if not f.done()]
        self._inflight.append(
            self._eval_pool.submit(self._eval_bulk, items)
        )

    # ------------------------------------------------------------ evaluation

    def _eval_batch(self, batch: list) -> None:
        """Evaluate one collected batch and resolve its futures; runs on
        the single eval worker so batches complete in submission order."""
        t0 = time.perf_counter()
        if self.admission is not None:
            # second expiry pass: rows can outlive their deadline while
            # waiting behind the in-flight batches of the depth-2 eval
            # pipeline — drop them here, at the last instant before the
            # evaluation actually starts, including rows whose remaining
            # budget cannot cover this batch's estimated duration
            batch = self._drop_expired(
                batch, margin_s=self.admission.estimate_high(INTERACTIVE)
            )
            if not batch:
                return
        requests = [req for req, _, _ in batch]
        responses = None
        if len(batch) >= self.min_kernel_batch:
            try:
                responses = self.evaluator.is_allowed_batch(requests)
            except Exception as err:  # noqa: BLE001
                # one poisoned request must not deny the whole batch;
                # retry each request individually below
                responses = None
                count_error(self.evaluator, "batch-eval-error",
                            len(batch), err)
        if responses is not None:
            for (_, future, _), response in zip(batch, responses):
                future.set_result(response)
        else:
            self._resolve_each(batch)
        if self.admission is not None:
            self.admission.observe_batch(
                INTERACTIVE, time.perf_counter() - t0, len(batch)
            )

    def _resolve_each(self, batch: list) -> None:
        """Resolve ``batch`` one row at a time.  Under
        ``min_kernel_batch`` rows that is the single-request path (the
        oracle, by design for sparse traffic).  After a kernel-sized
        batch raised, each row goes through the batch path alone: a
        poisoned row fails by itself and the others still take the
        kernel.  A failure of the device itself never reaches here (the
        evaluator answers it with the degraded envelope), and the oracle
        never answers in the kernel's place."""
        kernel_sized = len(batch) >= self.min_kernel_batch
        for req, future, _ in batch:
            try:
                if kernel_sized:
                    future.set_result(
                        self.evaluator.is_allowed_batch([req])[0])
                else:
                    future.set_result(self.evaluator.is_allowed(req))
            except Exception as err:
                if not future.done():
                    future.set_exception(err)

    def _eval_tenants(self, groups: dict) -> None:
        """Evaluate tenant-tagged rows group-by-group on the eval worker;
        each group resolves against its own tenant's tables through the
        tenancy registry (class-shared jitted program, per-tenant table
        arguments).  Unknown tenants get an honest INDETERMINATE — never
        a default-domain decision (that would be an isolation leak)."""
        t0 = time.perf_counter()
        total = 0
        tenant_inc = getattr(
            getattr(self.tenancy, "telemetry", None), "tenant_inc", None
        )
        for tenant, items in groups.items():
            if self.admission is not None:
                items = self._drop_expired(
                    items,
                    margin_s=self.admission.estimate_high(INTERACTIVE),
                )
                if not items:
                    continue
            total += len(items)
            try:
                evaluator = self.tenancy.evaluator_for(tenant)
            except Exception:  # noqa: BLE001 — registry must not poison rows
                evaluator = None
            if evaluator is None:
                from .tenancy import unknown_tenant_response

                for _, future, _ in items:
                    if not future.done():
                        future.set_result(unknown_tenant_response(tenant))
                continue
            requests = [req for req, _, _ in items]
            prepare = getattr(evaluator, "prepare_batch", None)
            if prepare is not None:
                try:
                    prepare(requests)
                except Exception:
                    pass
            responses = None
            if len(items) >= self.min_kernel_batch:
                try:
                    responses = evaluator.is_allowed_batch(requests)
                except Exception:
                    responses = None
            if responses is not None:
                for (_, future, _), response in zip(items, responses):
                    future.set_result(response)
            else:
                for req, future, _ in items:
                    try:
                        future.set_result(evaluator.is_allowed(req))
                    except Exception as err:
                        if not future.done():
                            future.set_exception(err)
            if tenant_inc is not None:
                tenant_inc("decision", tenant, len(items))
        if total and self.admission is not None:
            self.admission.observe_batch(
                INTERACTIVE, time.perf_counter() - t0, total
            )

    def _eval_bulk(self, items: list) -> None:
        """Evaluate one bulk (reverse-query) round on the eval worker."""
        t0 = time.perf_counter()
        if self.admission is not None:
            items = self._drop_expired_bulk(items)
            if not items:
                return
        if self.tenancy is not None:
            items = self._serve_tenant_bulk(items)
            if not items:
                return
        requests = [req for req, _, _ in items]
        try:
            results = self.evaluator.what_is_allowed_batch(requests)
        except Exception as err:  # noqa: BLE001 — row by row below
            results = None
            count_error(self.evaluator, "wia-batch-error", len(items), err)
        if results is not None:
            for (_, future, _), rq in zip(items, results):
                future.set_result(rq)
        else:
            # each query alone through the batch path: a poisoned query
            # fails by itself, the others keep the device path
            for req, future, _ in items:
                try:
                    future.set_result(
                        self.evaluator.what_is_allowed_batch([req])[0])
                except Exception as err:
                    if not future.done():
                        future.set_exception(err)
        if self.admission is not None:
            self.admission.observe_batch(
                BULK, time.perf_counter() - t0, len(items)
            )

    def _serve_tenant_bulk(self, items: list) -> list:
        """Resolve tenant-tagged reverse queries against their tenant's
        evaluator; returns the untagged remainder for the default path."""
        default_items = []
        for item in items:
            req, future, _ = item
            tenant = getattr(req, "_tenant", None)
            if tenant is None:
                default_items.append(item)
                continue
            try:
                evaluator = self.tenancy.evaluator_for(tenant)
            except Exception:  # noqa: BLE001
                evaluator = None
            if evaluator is None:
                from .tenancy import unknown_tenant_response

                if not future.done():
                    future.set_result(ReverseQuery(
                        policy_sets=[], obligations=[],
                        operation_status=unknown_tenant_response(
                            tenant
                        ).operation_status,
                    ))
                continue
            try:
                future.set_result(evaluator.what_is_allowed(req))
            except Exception as err:
                if not future.done():
                    future.set_exception(err)
        return default_items
