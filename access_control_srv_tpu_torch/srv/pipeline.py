"""Depth-N device pipeline behind the streaming wire endpoint.

One worker owns ONE device queue; any number of concurrent client
streams (transport_grpc ``IsAllowedStream``) feed it.  Each submitted
frame (a serialized BatchRequest envelope) moves through three stages on
dedicated workers:

  dispatch  — split the envelope, native C++ encode into pooled staging
              buffers, device enqueue (evaluator.is_allowed_batch_wire_async
              with ``reuse=True``); runs on the dispatch worker in
              submission order, so the device queue order is the frame
              submission order.
  finalize  — materialize the device result, decode to pb.Response rows,
              resolve ineligible rows with one batched service call,
              release the staging lease; runs on the finalize worker,
              FIFO.
  serialize — response frames serialize on the shared chunked serializer
              pool (transport_grpc.serialize_batch_response), so frame
              i-1's serialization overlaps frame i's device execution.

A BoundedSemaphore of ``depth`` slots is the backpressure: submit blocks
the feeding stream's thread while ``depth`` frames are between dispatch
and finalize completion — H2D/eval of frame i overlaps encode of frame
i+1 and decode/serialize of frame i-1, with no ``block_until_ready`` on
any hot path (materialize is the only blocking point, on the finalize
worker).

Frames whose envelope the native path cannot serve (no native encoder,
host-assisted conditions, malformed envelope) fall back to the protobuf
parse + service path inside finalize — correctness never depends on the
fast path.  Results are returned as per-frame Futures; per-stream
response ORDER is the transport's job (it queues futures in frame order
and yields them in order, so out-of-order completion inside the pipeline
can never reorder a stream's responses — tests/test_pipeline.py).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional


class DevicePipeline:
    def __init__(self, worker, depth: int = 2):
        self.worker = worker
        self.depth = max(1, int(depth))
        self._slots = threading.BoundedSemaphore(self.depth)
        self._dispatch_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="acs-wire-dispatch"
        )
        self._finalize_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="acs-wire-finalize"
        )
        self._stopping = False

    # ---------------------------------------------------------------- api

    def submit(self, raw: bytes, deadline: Optional[float] = None,
               span=None) -> "Future[bytes]":
        """One BatchRequest envelope in, a Future of the serialized
        BatchResponse payload out.  Blocks while the pipeline holds
        ``depth`` frames — the caller (a stream handler thread) IS the
        backpressure path to the client."""
        out: "Future[bytes]" = Future()
        if self._stopping:
            out.set_exception(RuntimeError("pipeline stopped"))
            return out
        self._slots.acquire()
        try:
            self._dispatch_pool.submit(self._dispatch, raw, deadline,
                                       span, out)
        except BaseException:
            self._slots.release()
            raise
        return out

    def stop(self) -> None:
        self._stopping = True
        self._dispatch_pool.shutdown(wait=True)
        self._finalize_pool.shutdown(wait=True)

    # -------------------------------------------------------------- stages

    def _dispatch(self, raw: bytes, deadline, span, out: Future) -> None:
        from .transport_grpc import split_batch_request

        try:
            messages = split_batch_request(raw)
            finalize = None
            evaluator = self.worker.service.evaluator
            if messages is not None and evaluator is not None:
                try:
                    finalize = evaluator.is_allowed_batch_wire_async(
                        messages, span=span, reuse=True
                    )
                except Exception as err:  # noqa: BLE001
                    finalize = None  # pb fallback below
                    from .batcher import count_error

                    count_error(evaluator, "stream-wire-error",
                                len(messages), err)
            self._finalize_pool.submit(
                self._finalize, raw, messages, finalize, deadline, span,
                out, time.perf_counter(),
            )
        except BaseException as err:  # noqa: BLE001 — never leak a slot
            self._slots.release()
            if not out.done():
                out.set_exception(err)

    def _finalize(self, raw, messages, finalize, deadline, span,
                  out: Future, t0: float) -> None:
        from .transport_grpc import (
            decode_native_rows,
            resolve_fallback_rows,
            serialize_batch_response,
        )

        worker = self.worker
        try:
            result = None
            if finalize is not None:
                from .watchdog import DeviceTimeoutError

                try:
                    result = finalize()
                except DeviceTimeoutError as err:
                    from .batcher import count_error

                    count_error(worker.service.evaluator,
                                "stream-wire-timeout", len(messages), err)
                    # wedged device fetch: the staging lease stays out (the
                    # aliasing rule forbids recycling buffers the device
                    # may still read) and the frame resolves through the
                    # pb path — a quarantined evaluator answers it with
                    # the degraded envelope, never a fabricated decision
                    result = None
            if result is None:
                payload = self._pb_fallback(raw, deadline, span)
            else:
                batch = result[0]
                tracer = None
                obs = getattr(worker, "obs", None)
                if obs is not None:
                    tracer = obs.tracer
                t_stage = time.perf_counter() if tracer is not None else 0.0
                responses, fb_rows, fb_reqs = decode_native_rows(
                    messages, result
                )
                if tracer is not None:
                    from .tracing import STAGE_DECODE

                    tracer.record(span, STAGE_DECODE,
                                  time.perf_counter() - t_stage)
                resolve_fallback_rows(worker, responses, fb_rows, fb_reqs,
                                      deadline, span=span)
                # staging lease: every pooled buffer (row arrays, masks,
                # regex matrices, owner bits) recycles only AFTER the
                # response rows are fully assembled
                batch.release_staging()
                telemetry = getattr(worker, "telemetry", None)
                if telemetry is not None:
                    telemetry.batch_latency.observe(
                        time.perf_counter() - t0
                    )
                if tracer is not None:
                    t_stage = time.perf_counter()
                payload = serialize_batch_response(responses)
                if tracer is not None:
                    from .tracing import STAGE_SERIALIZE

                    tracer.record(span, STAGE_SERIALIZE,
                                  time.perf_counter() - t_stage)
            if not out.done():
                out.set_result(payload)
        except BaseException as err:  # noqa: BLE001
            if not out.done():
                out.set_exception(err)
        finally:
            self._slots.release()

    def _pb_fallback(self, raw: bytes, deadline, span) -> bytes:
        """Full protobuf parse + service path for frames the native wire
        path cannot serve — identical semantics to the unary handler's
        fallback branch."""
        from .gen import access_control_pb2 as pb
        from .transport_grpc import (
            request_from_pb,
            response_to_pb,
            serialize_batch_response,
        )

        request = pb.BatchRequest.FromString(raw)
        reqs = [request_from_pb(r) for r in request.requests]
        if span is not None:
            for req in reqs:
                req._span = span
                req._sampling_done = True
        responses = self.worker.service.is_allowed_batch(
            reqs, deadline=deadline,
        )
        return serialize_batch_response(
            [response_to_pb(r) for r in responses]
        )
