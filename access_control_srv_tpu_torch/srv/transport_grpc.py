"""gRPC transport: protobuf services over the worker.

Exposes the same five-service surface as the reference
(reference: src/worker.ts:161-194 binds access-control, rule / policy /
policy_set CRUD, command interface and health): protobuf messages are
compiled from proto/access_control.proto; service registration uses
generic method handlers (this image ships protoc but not the gRPC python
stub generator).  ``IsAllowedBatch`` is the framework extension feeding
the batched device evaluation path directly.
"""

from __future__ import annotations

import json
import time
from concurrent import futures
from typing import Optional

import grpc

from ..models.model import (
    Attribute,
    ContextQuery,
    Decision,
    Request,
    Response,
    ReverseQuery,
    Target,
)
from ..ops.compile import DECISION_NAMES
from .admission import deadline_from_context, tenant_from_metadata
from .gen import access_control_pb2 as pb
from .tracing import (
    STAGE_DECODE,
    STAGE_ORACLE,
    STAGE_SERIALIZE,
    STAGE_TRANSPORT_PARSE,
    TRACE_ID_METADATA_KEY,
    trace_id_from_metadata,
)


def split_batch_request(data: bytes) -> Optional[list[bytes]]:
    """Split a serialized BatchRequest envelope (field 1: repeated Request)
    into per-request message bytes without protobuf deserialization.
    Returns None on any unexpected field (caller falls back to pb)."""
    messages: list[bytes] = []
    i, n = 0, len(data)
    while i < n:
        key = 0
        shift = 0
        while True:
            if i >= n:
                return None
            byte = data[i]
            i += 1
            key |= (byte & 0x7F) << shift
            shift += 7
            if not byte & 0x80:
                break
        if key >> 3 != 1 or key & 7 != 2:
            return None
        length = 0
        shift = 0
        while True:
            if i >= n:
                return None
            byte = data[i]
            i += 1
            length |= (byte & 0x7F) << shift
            shift += 7
            if not byte & 0x80:
                break
        if i + length > n:
            return None
        messages.append(data[i:i + length])
        i += length
    return messages


DECISION_TO_PB = {
    Decision.PERMIT: pb.PERMIT,
    Decision.DENY: pb.DENY,
    Decision.INDETERMINATE: pb.INDETERMINATE,
}
PB_TO_DECISION = {v: k for k, v in DECISION_TO_PB.items()}


# ------------------------------------------------------------- converters

def attr_to_pb(attr: Attribute) -> pb.Attribute:
    return pb.Attribute(
        id=attr.id or "",
        value=attr.value or "",
        attributes=[attr_to_pb(a) for a in attr.attributes or []],
    )


def attr_from_pb(msg: pb.Attribute) -> Attribute:
    return Attribute(
        id=msg.id,
        value=msg.value,
        attributes=[attr_from_pb(a) for a in msg.attributes],
    )


def target_to_pb(target: Optional[Target]) -> Optional[pb.Target]:
    if target is None:
        return None
    return pb.Target(
        subjects=[attr_to_pb(a) for a in target.subjects],
        resources=[attr_to_pb(a) for a in target.resources],
        actions=[attr_to_pb(a) for a in target.actions],
    )


def target_from_pb(msg: Optional[pb.Target]) -> Optional[Target]:
    if msg is None:
        return None
    return Target(
        subjects=[attr_from_pb(a) for a in msg.subjects],
        resources=[attr_from_pb(a) for a in msg.resources],
        actions=[attr_from_pb(a) for a in msg.actions],
    )


def _ctx_value_from_pb(msg: pb.ContextValue):
    if not msg.value:
        return None
    return {"type_url": msg.type_url, "value": bytes(msg.value)}


def request_from_pb(msg: pb.Request) -> Request:
    context = None
    if msg.HasField("context"):
        context = {}
        if msg.context.HasField("subject"):
            context["subject"] = _ctx_value_from_pb(msg.context.subject)
        context["resources"] = [
            _ctx_value_from_pb(r) for r in msg.context.resources
        ]
        if msg.context.HasField("security"):
            context["security"] = _ctx_value_from_pb(msg.context.security)
    target = target_from_pb(msg.target) if msg.HasField("target") else None
    return Request(target=target, context=context)


def request_to_pb(request: Request) -> pb.Request:
    msg = pb.Request()
    if request.target is not None:
        msg.target.CopyFrom(target_to_pb(request.target))
    context = request.context
    if context is not None:
        subject = context.get("subject")
        if subject is not None:
            msg.context.subject.value = json.dumps(subject).encode()
        for res in context.get("resources") or []:
            entry = msg.context.resources.add()
            entry.value = json.dumps(res).encode()
        security = context.get("security")
        if security is not None:
            msg.context.security.value = json.dumps(security).encode()
    return msg


def response_to_pb(response: Response) -> pb.Response:
    return pb.Response(
        decision=DECISION_TO_PB.get(response.decision, pb.INDETERMINATE),
        obligations=[attr_to_pb(a) for a in response.obligations or []],
        evaluation_cacheable=bool(response.evaluation_cacheable),
        operation_status=pb.OperationStatus(
            code=response.operation_status.code,
            message=response.operation_status.message,
        ),
    )


def reverse_query_to_pb(rq: ReverseQuery) -> pb.ReverseQuery:
    out = pb.ReverseQuery(
        obligations=[attr_to_pb(a) for a in rq.obligations or []],
        operation_status=pb.OperationStatus(
            code=rq.operation_status.code, message=rq.operation_status.message
        ),
    )
    for ps in rq.policy_sets:
        ps_msg = out.policy_sets.add(
            id=ps.id or "",
            effect=ps.effect or "",
            combining_algorithm=ps.combining_algorithm or "",
        )
        if ps.target is not None:
            ps_msg.target.CopyFrom(target_to_pb(ps.target))
        for pol in ps.policies:
            p_msg = ps_msg.policies.add(
                id=pol.id or "",
                effect=pol.effect or "",
                combining_algorithm=pol.combining_algorithm or "",
                evaluation_cacheable=bool(pol.evaluation_cacheable),
                has_rules=bool(pol.has_rules),
            )
            if pol.target is not None:
                p_msg.target.CopyFrom(target_to_pb(pol.target))
            for rule in pol.rules:
                r_msg = p_msg.rules.add(
                    id=rule.id or "",
                    effect=rule.effect or "",
                    condition=rule.condition or "",
                    evaluation_cacheable=bool(rule.evaluation_cacheable),
                )
                if rule.target is not None:
                    r_msg.target.CopyFrom(target_to_pb(rule.target))
                if rule.context_query is not None:
                    r_msg.context_query.query = rule.context_query.query or ""
                    for f in rule.context_query.filters or []:
                        r_msg.context_query.filters.add(
                            field=str(f.get("field") or ""),
                            operation=str(f.get("operation") or ""),
                            value=str(f.get("value") or ""),
                        )
    return out


def _meta_to_dict(msg: pb.Meta) -> dict:
    out = {
        "owners": [_attr_dict(a) for a in msg.owners],
        "acls": [_attr_dict(a) for a in msg.acls],
    }
    if msg.created:
        out["created"] = msg.created
    if msg.modified:
        out["modified"] = msg.modified
    return out


def _attr_dict(msg: pb.Attribute) -> dict:
    return {
        "id": msg.id,
        "value": msg.value,
        "attributes": [_attr_dict(a) for a in msg.attributes],
    }


def _target_dict(msg: pb.Target) -> dict:
    return {
        "subjects": [_attr_dict(a) for a in msg.subjects],
        "resources": [_attr_dict(a) for a in msg.resources],
        "actions": [_attr_dict(a) for a in msg.actions],
    }


def rule_doc_from_pb(msg: pb.Rule) -> dict:
    doc = {
        "id": msg.id,
        "name": msg.name,
        "description": msg.description,
        "effect": msg.effect or None,
        "condition": msg.condition,
        "evaluation_cacheable": msg.evaluation_cacheable,
    }
    if msg.HasField("target"):
        doc["target"] = _target_dict(msg.target)
    if msg.HasField("context_query"):
        doc["context_query"] = {
            "query": msg.context_query.query,
            "filters": [
                {"field": f.field, "operation": f.operation, "value": f.value}
                for f in msg.context_query.filters
            ],
        }
    if msg.HasField("meta"):
        doc["meta"] = _meta_to_dict(msg.meta)
    return doc


def policy_doc_from_pb(msg: pb.Policy) -> dict:
    doc = {
        "id": msg.id,
        "name": msg.name,
        "description": msg.description,
        "effect": msg.effect or None,
        "combining_algorithm": msg.combining_algorithm,
        "rules": list(msg.rules),
        "evaluation_cacheable": msg.evaluation_cacheable,
    }
    if msg.HasField("target"):
        doc["target"] = _target_dict(msg.target)
    if msg.HasField("meta"):
        doc["meta"] = _meta_to_dict(msg.meta)
    return doc


def policy_set_doc_from_pb(msg: pb.PolicySet) -> dict:
    doc = {
        "id": msg.id,
        "name": msg.name,
        "description": msg.description,
        "combining_algorithm": msg.combining_algorithm,
        "policies": list(msg.policies),
    }
    if msg.HasField("target"):
        doc["target"] = _target_dict(msg.target)
    if msg.HasField("meta"):
        doc["meta"] = _meta_to_dict(msg.meta)
    return doc


def _subject_from_pb(msg: pb.Subject) -> Optional[dict]:
    if not (msg.id or msg.token or msg.scope or msg.data):
        return None
    subject = {"id": msg.id or None, "token": msg.token or None,
               "scope": msg.scope or None}
    if msg.data:
        subject.update(json.loads(msg.data))
    return subject


# ----------------------------------------------------------------- server

# batched envelopes exceed gRPC's 4 MB default well before the batcher's
# max_batch (an 8192-row BatchRequest is ~3.9 MB); 64 MB covers the
# largest configured batch with headroom
_MESSAGE_SIZE_OPTIONS = (
    ("grpc.max_receive_message_length", 64 * 1024 * 1024),
    ("grpc.max_send_message_length", 64 * 1024 * 1024),
)

# batch-reply serialization runs on this shared pool, NOT the gRPC
# dispatch thread: an 8192-row BatchResponse costs ~8 ms of protobuf
# SerializeToString, which previously serialized the whole envelope on the
# handler thread after the kernel was already done (part of the
# wire-to-wire gap vs kernel-only throughput).  Chunks serialize
# concurrently and the dispatch thread only joins the length-delimited
# frames — BatchResponse is `repeated Response responses = 1`, so the
# frame concatenation IS the envelope encoding.
_SER_POOL = futures.ThreadPoolExecutor(
    max_workers=4, thread_name_prefix="acs-pb-ser"
)
_SER_CHUNK = 512


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _response_frames(chunk: list) -> bytes:
    parts = []
    for resp in chunk:
        body = resp.SerializeToString()
        parts.append(b"\x0a" + _varint(len(body)) + body)
    return b"".join(parts)


def serialize_batch_response(responses: list) -> bytes:
    """BatchResponse wire bytes from per-row pb.Response messages; chunked
    across the serializer pool for large batches (identical bytes to
    ``pb.BatchResponse(responses=...).SerializeToString()`` — asserted by
    tests/test_grpc_transport.py)."""
    if len(responses) <= _SER_CHUNK:
        return _response_frames(responses)
    chunks = [
        responses[i:i + _SER_CHUNK]
        for i in range(0, len(responses), _SER_CHUNK)
    ]
    return b"".join(_SER_POOL.map(_response_frames, chunks))


def decode_native_rows(messages: list[bytes], out) -> tuple:
    """Per-row pb.Response assembly from a native wire result
    ``(batch, decision, cacheable, status)``.  Ineligible / non-200 rows
    are parsed back to Request models and returned for ONE batched
    fallback call (resolve_fallback_rows) instead of per-row service
    round-trips.  Shared by the unary IsAllowedBatch handler and the
    streaming pipeline (srv/pipeline.py)."""
    batch, decision, cacheable, status = out
    responses: list = [None] * len(messages)
    fallback_rows: list[int] = []
    fallback_reqs: list = []
    for b, message in enumerate(messages):
        if not batch.eligible[b] or status[b] != 200:
            try:
                req = request_from_pb(pb.Request.FromString(message))
            except Exception as err:
                responses[b] = pb.Response(
                    decision=pb.DENY,
                    operation_status=pb.OperationStatus(
                        code=500, message=str(err)
                    ),
                )
                continue
            fallback_rows.append(b)
            fallback_reqs.append(req)
            continue
        cach = (
            False if cacheable[b] < 0 else bool(cacheable[b])
        )
        responses[b] = pb.Response(
            decision=DECISION_TO_PB[
                DECISION_NAMES[int(decision[b])]
            ],
            evaluation_cacheable=cach,
            operation_status=pb.OperationStatus(
                code=200, message="success"
            ),
        )
    return responses, fallback_rows, fallback_reqs


def resolve_fallback_rows(worker, responses: list, fallback_rows: list,
                          fallback_reqs: list, deadline, span=None) -> None:
    """Resolve the rows decode_native_rows could not serve natively with
    one batched service call (observe=False: the caller records
    batch-level telemetry for ALL rows itself)."""
    if not fallback_reqs:
        return
    if span is not None:
        for req in fallback_reqs:
            req._span = span
            req._sampling_done = True
    for b, resp in zip(
        fallback_rows,
        worker.service.is_allowed_batch(
            fallback_reqs, observe=False, deadline=deadline,
        ),
    ):
        responses[b] = response_to_pb(resp)


POLICY_EPOCH_METADATA_KEY = "x-acs-policy-epoch"
SHED_METADATA_KEY = "x-acs-shed"
EXPLAIN_METADATA_KEY = "x-acs-explain"
# admission-control shed statuses (srv/admission.py): 429 queue-full,
# 503 breaker-open, 504 deadline-infeasible
SHED_CODES = frozenset((429, 503, 504))


def explain_trailer(response) -> Optional[str]:
    """Compact JSON of the deciding-node provenance (srv/explain.py)
    when explain mode stamped the response, else None.  The
    io.restorecommerce Response proto has no provenance field, so the
    wire surface is a trailer — additive metadata keeps the response
    bytes identical for every consumer that doesn't opt in."""
    info = getattr(response, "_explain", None)
    if info is None:
        return None
    try:
        return json.dumps(info, separators=(",", ":"), sort_keys=True)
    except Exception:  # noqa: BLE001 — stamping never fails a request
        return None


def stamp_trailers(context, worker, trace_id=None, shed=False,
                   explain=None):
    """Set the response's trailing metadata in ONE call (grpc's
    set_trailing_metadata overwrites, so every stamp merges here):
    ``x-acs-policy-epoch`` — the replica's policy epoch, letting the
    cluster router (srv/router.py) track per-replica convergence from
    live traffic without polling; ``x-acs-shed`` — the whole request
    was shed by admission control, so the router may retry it on
    another replica without parsing response bytes; ``x-acs-explain``
    — deciding-node provenance JSON when explain mode is on
    (docs/EXPLAIN.md); plus the trace-id echo (srv/tracing.py) when
    the request was sampled."""
    md = []
    if explain:
        md.append((EXPLAIN_METADATA_KEY, explain))
    epoch_fn = getattr(worker, "policy_epoch", None)
    if epoch_fn is not None:
        try:
            md.append((POLICY_EPOCH_METADATA_KEY, str(epoch_fn())))
        except Exception:  # noqa: BLE001 — stamping never fails a request
            pass
    if shed:
        md.append((SHED_METADATA_KEY, "1"))
    if trace_id:
        md.append((TRACE_ID_METADATA_KEY, trace_id))
    if not md:
        return
    try:
        context.set_trailing_metadata(tuple(md))
    except Exception:  # noqa: BLE001 — non-grpc test doubles
        pass


def _unary(handler, req_cls, resp_cls):
    return grpc.unary_unary_rpc_method_handler(
        handler,
        request_deserializer=req_cls.FromString,
        response_serializer=resp_cls.SerializeToString,
    )


class GrpcServer:
    """Binds the worker's services to a grpc.Server."""

    def __init__(self, worker, addr: str = "127.0.0.1:0", max_workers: int = 16):
        self.worker = worker
        self._executor = futures.ThreadPoolExecutor(max_workers=max_workers)
        self.server = grpc.server(self._executor,
                                  options=_MESSAGE_SIZE_OPTIONS)
        self._register()
        self.port = self.server.add_insecure_port(addr)
        self.addr = addr.rsplit(":", 1)[0] + f":{self.port}"

    def start(self):
        self.server.start()
        return self

    def stop(self, grace: float = 0.5):
        # the handler threads end with the server (grpc leaves its
        # executor's threads alive otherwise); once every handler has
        # terminated the join is immediate
        stopped = self.server.stop(grace).wait(grace + 5.0)
        self._executor.shutdown(wait=stopped)

    # ------------------------------------------------------------- handlers

    def _register(self):
        worker = self.worker
        # observability hub: None (config absent/disabled) keeps every
        # handler on the exact pre-observability path
        obs = getattr(worker, "obs", None)

        def is_allowed(request, context):
            # deadline propagation (srv/admission.py): the client's gRPC
            # deadline (or x-acs-timeout-ms metadata) becomes the
            # request's budget — rejected at submit when infeasible,
            # dropped at dispatch when expired
            tenant = tenant_from_metadata(context)
            if obs is None or obs.tracer is None:
                req = request_from_pb(request)
                if tenant is not None:
                    req._tenant = tenant
                response = worker.service.is_allowed(
                    req, deadline=deadline_from_context(context),
                )
                stamp_trailers(
                    context, worker,
                    shed=response.operation_status.code in SHED_CODES,
                    explain=explain_trailer(response),
                )
                return response_to_pb(response)
            # traced path: span at transport receive (trace id from the
            # x-acs-trace-id metadata key — an explicit id forces
            # sampling), parse + serialize stages recorded here, the
            # pipeline stages downstream; the id echoes on the trailer
            tracer = obs.tracer
            t0 = time.perf_counter()
            span = tracer.start_span(trace_id_from_metadata(context))
            req = request_from_pb(request)
            if tenant is not None:
                req._tenant = tenant
            tracer.record(span, STAGE_TRANSPORT_PARSE,
                          time.perf_counter() - t0)
            req._sampling_done = True
            if span is not None:
                req._span = span
            response = worker.service.is_allowed(
                req, deadline=deadline_from_context(context)
            )
            t_ser = time.perf_counter()
            msg = response_to_pb(response)
            tracer.record(span, STAGE_SERIALIZE,
                          time.perf_counter() - t_ser)
            stamp_trailers(
                context, worker,
                trace_id=span.trace_id if span is not None else None,
                shed=response.operation_status.code in SHED_CODES,
                explain=explain_trailer(response),
            )
            if span is not None:
                tracer.finish(span, decision=response.decision,
                              code=response.operation_status.code)
            return msg

        def is_allowed_batch(raw, context):
            # raw BatchRequest bytes: try the native wire fast path (C++
            # encoder + kernel, no python deserialization for eligible
            # rows); fall back to full pb parse + service path
            import time as _time

            t0 = _time.perf_counter()
            deadline = deadline_from_context(context)
            tenant = tenant_from_metadata(context)
            tracer = obs.tracer if obs is not None else None
            span = None
            t_stage = t0
            if tracer is not None:
                # one RPC-level span for the whole batch: batch stages
                # fan into it once (srv/tracing.StageTracer.fan_out)
                span = tracer.start_span(trace_id_from_metadata(context))
            messages = split_batch_request(raw)
            if tracer is not None:
                now = _time.perf_counter()
                tracer.record(span, STAGE_TRANSPORT_PARSE, now - t_stage)
                t_stage = now

            def _shed_all(resps) -> bool:
                # whole-batch shed (every row an admission status):
                # stamped so the router may retry the batch elsewhere
                return bool(resps) and all(
                    r.operation_status.code in SHED_CODES for r in resps
                )

            def finish_rpc(payload: bytes, shed: bool = False) -> bytes:
                stamp_trailers(
                    context, worker,
                    trace_id=span.trace_id if span is not None else None,
                    shed=shed,
                )
                if tracer is not None and span is not None:
                    tracer.finish(span, code=200)
                return payload

            evaluator = worker.service.evaluator
            # tenanted batches must resolve against the tenant's own
            # tables (srv/tenancy.py) — the native wire fast path binds
            # the default-domain program, so route through the service
            # path where the batcher partitions by tenant
            if tenant is not None:
                messages = None
            if messages is not None and evaluator is not None:
                out = None
                try:
                    out = evaluator.is_allowed_batch_wire(
                        messages, span=span
                    )
                except Exception as err:  # noqa: BLE001 — pb path below
                    out = None
                    from .batcher import count_error

                    count_error(evaluator, "native-wire-error",
                                len(messages), err)
                if out is not None:
                    if tracer is not None:
                        t_stage = _time.perf_counter()
                    # per-row assembly + ONE batched fallback call for
                    # ineligible rows (per-row service.is_allowed would
                    # wait out a micro-batch window each); observe=False
                    # on the fallback: this handler records batch_latency
                    # and decision counts for ALL rows below
                    responses, fallback_rows, fallback_reqs = \
                        decode_native_rows(messages, out)
                    if tracer is not None:
                        now = _time.perf_counter()
                        tracer.record(span, STAGE_DECODE, now - t_stage)
                        t_stage = now
                    resolve_fallback_rows(
                        worker, responses, fallback_rows, fallback_reqs,
                        deadline, span=span,
                    )
                    telemetry = getattr(worker, "telemetry", None)
                    if telemetry is not None:
                        telemetry.batch_latency.observe(
                            _time.perf_counter() - t0
                        )
                        for resp in responses:
                            telemetry.decisions.inc(
                                PB_TO_DECISION.get(resp.decision, "DENY")
                            )
                    if tracer is None:
                        stamp_trailers(context, worker,
                                       shed=_shed_all(responses))
                        return serialize_batch_response(responses)
                    t_stage = _time.perf_counter()
                    payload = serialize_batch_response(responses)
                    tracer.record(span, STAGE_SERIALIZE,
                                  _time.perf_counter() - t_stage)
                    return finish_rpc(payload, shed=_shed_all(responses))
            if tracer is not None:
                t_stage = _time.perf_counter()
            request = pb.BatchRequest.FromString(raw)
            reqs = [request_from_pb(r) for r in request.requests]
            if tenant is not None:
                for req in reqs:
                    req._tenant = tenant
            if tracer is not None:
                now = _time.perf_counter()
                tracer.record(span, STAGE_TRANSPORT_PARSE, now - t_stage)
                if span is not None:
                    for req in reqs:
                        req._span = span
                        req._sampling_done = True
            responses = worker.service.is_allowed_batch(
                reqs, deadline=deadline,
            )
            if tracer is None:
                stamp_trailers(context, worker, shed=_shed_all(responses))
                return serialize_batch_response(
                    [response_to_pb(r) for r in responses]
                )
            t_stage = _time.perf_counter()
            payload = serialize_batch_response(
                [response_to_pb(r) for r in responses]
            )
            tracer.record(span, STAGE_SERIALIZE,
                          _time.perf_counter() - t_stage)
            return finish_rpc(payload, shed=_shed_all(responses))

        def is_allowed_stream(request_iterator, context):
            """Streaming batch endpoint: a stream of BatchRequest
            envelopes in, a stream of BatchResponse frames out — one
            response frame per request frame, IN FRAME ORDER per stream,
            while frames from ALL streams share one depth-bounded device
            pipeline (srv/pipeline.py).  A feeder thread consumes the
            request iterator (submit's backpressure bounds it at the
            pipeline depth) so response frames flush the moment they
            complete instead of waiting for the next request frame —
            a client that awaits response i before sending i+1 cannot
            deadlock."""
            import queue as _queue
            import threading as _threading

            pipeline = getattr(worker, "wire_pipeline", None)
            deadline = deadline_from_context(context)
            tracer = obs.tracer if obs is not None else None
            if pipeline is None:
                for raw in request_iterator:
                    yield is_allowed_batch(raw, context)
                stamp_trailers(context, worker)
                return
            frames: "_queue.Queue" = _queue.Queue()

            def feed():
                try:
                    for raw in request_iterator:
                        span = None
                        if tracer is not None:
                            span = tracer.start_span(
                                trace_id_from_metadata(context)
                            )
                        frames.put(
                            (pipeline.submit(raw, deadline, span=span),
                             span)
                        )
                except BaseException as err:  # noqa: BLE001
                    frames.put(err)
                frames.put(None)

            _threading.Thread(target=feed, daemon=True).start()
            while True:
                item = frames.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                future, span = item
                payload = future.result()
                if tracer is not None and span is not None:
                    tracer.finish(span, code=200)
                yield payload
            # stream-level trailer: the epoch as of stream completion
            # (per-frame epochs would need in-band stamping; the router
            # refreshes epochs from unary traffic and health polls)
            stamp_trailers(context, worker)

        def what_is_allowed(request, context):
            req = request_from_pb(request)
            tenant = tenant_from_metadata(context)
            if tenant is not None:
                req._tenant = tenant
            rq = worker.service.what_is_allowed(
                req, deadline=deadline_from_context(context),
            )
            return reverse_query_to_pb(rq)

        def what_is_allowed_batch(request, context):
            reqs = [request_from_pb(m) for m in request.requests]
            tenant = tenant_from_metadata(context)
            if tenant is not None:
                for req in reqs:
                    req._tenant = tenant
            rqs = worker.service.what_is_allowed_batch(
                reqs, deadline=deadline_from_context(context),
            )
            return pb.BatchReverseQuery(
                responses=[reverse_query_to_pb(rq) for rq in rqs]
            )

        ac_handlers = {
            "IsAllowed": _unary(is_allowed, pb.Request, pb.Response),
            # raw-bytes deserializer AND serializer: the handler splits
            # the envelope itself so eligible rows never touch python
            # protobuf, and replies arrive pre-serialized off-thread
            # (serialize_batch_response)
            "IsAllowedBatch": grpc.unary_unary_rpc_method_handler(
                is_allowed_batch,
                request_deserializer=lambda raw: raw,
                response_serializer=lambda msg: (
                    msg if isinstance(msg, bytes)
                    else msg.SerializeToString()
                ),
            ),
            # streaming twin of IsAllowedBatch: raw frames in/out, one
            # shared device pipeline behind every stream
            "IsAllowedStream": grpc.stream_stream_rpc_method_handler(
                is_allowed_stream,
                request_deserializer=lambda raw: raw,
                response_serializer=lambda msg: (
                    msg if isinstance(msg, bytes)
                    else msg.SerializeToString()
                ),
            ),
            "WhatIsAllowed": _unary(what_is_allowed, pb.Request, pb.ReverseQuery),
            # framework extension: batched reverse query through the
            # device-assisted path (ops/reverse.py)
            "WhatIsAllowedBatch": _unary(
                what_is_allowed_batch, pb.BatchRequest, pb.BatchReverseQuery
            ),
        }
        self.server.add_generic_rpc_handlers(
            (
                grpc.method_handlers_generic_handler(
                    "acstpu.AccessControlService", ac_handlers
                ),
            )
        )

        for kind, doc_from, list_cls, list_resp_cls, fill in (
            ("rule", rule_doc_from_pb, pb.RuleList, pb.RuleListResponse,
             self._fill_rule),
            ("policy", policy_doc_from_pb, pb.PolicyList,
             pb.PolicyListResponse, self._fill_policy),
            ("policy_set", policy_set_doc_from_pb, pb.PolicySetList,
             pb.PolicySetListResponse, self._fill_policy_set),
        ):
            handlers = self._crud_handlers(kind, doc_from, list_cls,
                                           list_resp_cls, fill)
            name = {
                "rule": "acstpu.RuleService",
                "policy": "acstpu.PolicyService",
                "policy_set": "acstpu.PolicySetService",
            }[kind]
            self.server.add_generic_rpc_handlers(
                (grpc.method_handlers_generic_handler(name, handlers),)
            )

        def command(request, context):
            payload = json.loads(request.payload) if request.payload else {}
            result = worker.command_interface.command(request.name, payload)
            return pb.CommandResponse(payload=json.dumps(result).encode())

        self.server.add_generic_rpc_handlers(
            (
                grpc.method_handlers_generic_handler(
                    "acstpu.CommandInterface",
                    {"Command": _unary(command, pb.CommandRequest,
                                       pb.CommandResponse)},
                ),
            )
        )

        def health(request, context):
            result = worker.command_interface.command("health_check")
            return pb.HealthCheckResponse(status=result["status"])

        self.server.add_generic_rpc_handlers(
            (
                grpc.method_handlers_generic_handler(
                    "acstpu.Health",
                    {"Check": _unary(health, pb.HealthCheckRequest,
                                     pb.HealthCheckResponse)},
                ),
            )
        )

        # reference-wire aliases: the same handlers under the
        # restorecommerce service names + message shapes, so stock
        # restorecommerce clients (acs-client et al.) call this service
        # unmodified (srv/transport_rc.py)
        from .transport_rc import register_rc_services

        register_rc_services(self.server, worker)

    def _crud_handlers(self, kind, doc_from_pb, list_cls, list_resp_cls, fill):
        service = self.worker.store.get_resource_service(kind)

        def create(request, context):
            return self._mutation_response(
                service.create([doc_from_pb(i) for i in request.items],
                               subject=_subject_from_pb(request.subject))
            )

        def update(request, context):
            return self._mutation_response(
                service.update([doc_from_pb(i) for i in request.items],
                               subject=_subject_from_pb(request.subject))
            )

        def upsert(request, context):
            return self._mutation_response(
                service.upsert([doc_from_pb(i) for i in request.items],
                               subject=_subject_from_pb(request.subject))
            )

        def delete(request, context):
            return self._mutation_response(
                service.delete(ids=list(request.ids),
                               collection=request.collection,
                               subject=_subject_from_pb(request.subject))
            )

        def read(request, context):
            filters = None
            if request.ids:
                filters = {"ids": list(request.ids)}
            elif request.filters:
                filters = {"filters": [
                    {
                        "operator": group.operator or "and",
                        "filters": [
                            {"field": f.field, "operation": f.operation,
                             "value": f.value}
                            for f in group.filters
                        ],
                    }
                    for group in request.filters
                ]}
            result = service.read(filters)
            resp = list_resp_cls()
            for item in result.get("items", []):
                payload = item.get("payload")
                if payload is not None:
                    fill(resp.items.add(), payload)
            status = result["operation_status"]
            resp.operation_status.code = status["code"]
            resp.operation_status.message = status["message"]
            return resp

        return {
            "Create": _unary(create, list_cls, pb.MutationResponse),
            "Update": _unary(update, list_cls, pb.MutationResponse),
            "Upsert": _unary(upsert, list_cls, pb.MutationResponse),
            "Delete": _unary(delete, pb.DeleteRequest, pb.MutationResponse),
            "Read": _unary(read, pb.ReadRequest, list_resp_cls),
        }

    # ---------------------------------------------------- doc -> pb fillers

    @staticmethod
    def _fill_attr(msg: pb.Attribute, doc: dict):
        msg.id = doc.get("id") or ""
        msg.value = str(doc.get("value") or "")
        for child in doc.get("attributes") or []:
            GrpcServer._fill_attr(msg.attributes.add(), child)

    @staticmethod
    def _fill_target(msg: pb.Target, doc: dict):
        for key, field in (("subjects", msg.subjects),
                           ("resources", msg.resources),
                           ("actions", msg.actions)):
            for attr in doc.get(key) or []:
                GrpcServer._fill_attr(field.add(), attr)

    @staticmethod
    def _fill_meta(msg: pb.Meta, doc: dict):
        for owner in doc.get("owners") or []:
            GrpcServer._fill_attr(msg.owners.add(), owner)
        for acl in doc.get("acls") or []:
            GrpcServer._fill_attr(msg.acls.add(), acl)
        msg.created = float(doc.get("created") or 0.0)
        msg.modified = float(doc.get("modified") or 0.0)

    @classmethod
    def _fill_rule(cls, msg: pb.Rule, doc: dict):
        msg.id = doc.get("id") or ""
        msg.name = doc.get("name") or ""
        msg.description = doc.get("description") or ""
        msg.effect = doc.get("effect") or ""
        msg.condition = doc.get("condition") or ""
        msg.evaluation_cacheable = bool(doc.get("evaluation_cacheable"))
        if doc.get("target"):
            cls._fill_target(msg.target, doc["target"])
        if doc.get("context_query"):
            cq = doc["context_query"]
            msg.context_query.query = cq.get("query") or ""
            for f in cq.get("filters") or []:
                msg.context_query.filters.add(
                    field=str(f.get("field") or ""),
                    operation=str(f.get("operation") or ""),
                    value=str(f.get("value") or ""),
                )
        if doc.get("meta"):
            cls._fill_meta(msg.meta, doc["meta"])

    @classmethod
    def _fill_policy(cls, msg: pb.Policy, doc: dict):
        msg.id = doc.get("id") or ""
        msg.name = doc.get("name") or ""
        msg.description = doc.get("description") or ""
        msg.effect = doc.get("effect") or ""
        msg.combining_algorithm = doc.get("combining_algorithm") or ""
        msg.evaluation_cacheable = bool(doc.get("evaluation_cacheable"))
        msg.rules.extend(doc.get("rules") or [])
        if doc.get("target"):
            cls._fill_target(msg.target, doc["target"])
        if doc.get("meta"):
            cls._fill_meta(msg.meta, doc["meta"])

    @classmethod
    def _fill_policy_set(cls, msg: pb.PolicySet, doc: dict):
        msg.id = doc.get("id") or ""
        msg.name = doc.get("name") or ""
        msg.description = doc.get("description") or ""
        msg.combining_algorithm = doc.get("combining_algorithm") or ""
        msg.policies.extend(doc.get("policies") or [])
        if doc.get("target"):
            cls._fill_target(msg.target, doc["target"])
        if doc.get("meta"):
            cls._fill_meta(msg.meta, doc["meta"])

    @staticmethod
    def _mutation_response(result: dict) -> pb.MutationResponse:
        resp = pb.MutationResponse()
        for item in result.get("items", []):
            status = item.get("status", {})
            payload = item.get("payload") or {}
            resp.statuses.add(
                id=payload.get("id", ""),
                code=status.get("code", 200),
                message=status.get("message", "success"),
            )
        op = result.get("operation_status", {})
        resp.operation_status.code = op.get("code", 200)
        resp.operation_status.message = op.get("message", "success")
        return resp


# ----------------------------------------------------------------- client

class GrpcClient:
    """Typed client over the generic channel (test + SDK use)."""

    def __init__(self, addr: str):
        self.channel = grpc.insecure_channel(
            addr, options=_MESSAGE_SIZE_OPTIONS
        )

    def close(self):
        self.channel.close()

    def _call(self, service: str, method: str, request, resp_cls):
        fn = self.channel.unary_unary(
            f"/{service}/{method}",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=resp_cls.FromString,
        )
        return fn(request)

    def is_allowed(self, request: pb.Request) -> pb.Response:
        return self._call("acstpu.AccessControlService", "IsAllowed",
                          request, pb.Response)

    def is_allowed_batch(self, request: pb.BatchRequest) -> pb.BatchResponse:
        return self._call("acstpu.AccessControlService", "IsAllowedBatch",
                          request, pb.BatchResponse)

    def is_allowed_stream(self, batches, timeout=None):
        """Streaming batch call: ``batches`` is an iterable of
        pb.BatchRequest messages (or pre-serialized envelope bytes);
        yields one pb.BatchResponse per frame, in frame order."""
        fn = self.channel.stream_stream(
            "/acstpu.AccessControlService/IsAllowedStream",
            request_serializer=lambda m: (
                m if isinstance(m, (bytes, bytearray))
                else m.SerializeToString()
            ),
            response_deserializer=pb.BatchResponse.FromString,
        )
        return fn(batches, timeout=timeout)

    def what_is_allowed(self, request: pb.Request) -> pb.ReverseQuery:
        return self._call("acstpu.AccessControlService", "WhatIsAllowed",
                          request, pb.ReverseQuery)

    def crud(self, kind: str, method: str, request, resp_cls=None):
        service = {
            "rule": "acstpu.RuleService",
            "policy": "acstpu.PolicyService",
            "policy_set": "acstpu.PolicySetService",
        }[kind]
        if resp_cls is None:
            resp_cls = pb.MutationResponse
        return self._call(service, method, request, resp_cls)

    def command(self, name: str, payload: dict | None = None) -> dict:
        resp = self._call(
            "acstpu.CommandInterface",
            "Command",
            pb.CommandRequest(
                name=name, payload=json.dumps(payload or {}).encode()
            ),
            pb.CommandResponse,
        )
        return json.loads(resp.payload)

    def health(self) -> str:
        resp = self._call("acstpu.Health", "Check", pb.HealthCheckRequest(),
                          pb.HealthCheckResponse)
        return resp.status
