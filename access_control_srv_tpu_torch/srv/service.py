"""The PDP service facade: isAllowed / whatIsAllowed endpoints.

Framework analog of the reference's AccessControlService
(reference: src/accessControlService.ts): deny-on-exception envelopes,
wire-context unmarshalling (the gRPC layer carries context values as
protobuf-Any-style ``{"value": <json bytes>}``), and policy loading in
``local`` (YAML files) vs ``database`` (store) mode.
"""

from __future__ import annotations

import json
import time
from typing import Any, Optional

from ..core.engine import AccessController
from ..core.loader import load_policy_sets_from_file
from ..models.model import (
    Attribute,
    Decision,
    OperationStatus,
    Request,
    Response,
    ReverseQuery,
    Target,
    coerce_target,
)


def unmarshall_any(value: Any) -> Any:
    """protobuf-Any-ish -> JSON (reference: accessControlService.ts:103-125)."""
    if isinstance(value, dict) and "value" in value and set(value) <= {
        "type_url",
        "value",
    }:
        raw = value["value"]
        if isinstance(raw, (bytes, bytearray)):
            raw = raw.decode()
        return json.loads(raw)
    return value


def unmarshall_context(context: Optional[dict]) -> Optional[dict]:
    if context is None:
        return None
    out = dict(context)
    if "subject" in out and out["subject"] is not None:
        out["subject"] = unmarshall_any(out["subject"])
    if "resources" in out and out["resources"] is not None:
        out["resources"] = [unmarshall_any(r) for r in out["resources"]]
    if "security" in out and out["security"] is not None:
        out["security"] = unmarshall_any(out["security"])
    return out


def coerce_request(request: Any) -> Request:
    if isinstance(request, Request):
        if isinstance(request.context, dict):
            request.context = unmarshall_context(request.context)
        return request
    target = coerce_target(request.get("target"))
    context = unmarshall_context(request.get("context"))
    return Request(target=target, context=context)


class AccessControlService:
    def __init__(self, cfg, engine: AccessController, evaluator=None,
                 store=None, logger=None, telemetry=None,
                 observability=None):
        self.cfg = cfg
        self.engine = engine
        self.evaluator = evaluator
        self.store = store
        self.logger = logger
        self.telemetry = telemetry
        # observability hub (srv/tracing.Observability): span fallback
        # creation for non-transport callers + the sampled decision-audit
        # log.  None keeps the facade byte-identical to pre-observability.
        self.obs = observability
        # when set (Worker wires it), concurrent single isAllowed calls are
        # coalesced into kernel batches instead of hitting the oracle 1-by-1
        self.batcher = None
        # shadow evaluator (srv/shadow.py): when set, served decisions
        # mirror onto the candidate tree AFTER response assembly.  None
        # (the default) keeps both endpoints byte-identical — the taps
        # are one attribute test each.
        self.shadow = None

    def _shadow_tap(self, requests: list, responses: list) -> None:
        """Mirror served rows to the shadow.  Post-decision, non-blocking
        (bounded drop-queue inside), and exception-proofed twice over —
        nothing here can alter or delay what was already decided."""
        shadow = self.shadow
        if shadow is None:
            return
        try:
            shadow.submit(requests, responses)
        except Exception:  # noqa: BLE001 — shadow must never fail serving
            if self.logger:
                self.logger.exception("shadow mirror failed")

    def _observed_request(self, req):
        """(span, own_span): the transport-attached span if any, else a
        freshly sampled one owned (and finished) by this facade — so
        non-gRPC callers trace too."""
        obs = self.obs
        if obs is None or obs.tracer is None:
            return None, False
        span = getattr(req, "_span", None)
        if span is not None:
            return span, False
        if getattr(req, "_sampling_done", False):
            # the transport already rolled the sampling dice for this
            # request — re-rolling here would skew the effective rate
            return None, False
        span = obs.tracer.start_span()
        if span is not None:
            req._span = span
            return span, True
        return None, False

    def _finish_observed(self, req, response, span, own_span) -> None:
        """Audit-log the decision (sampled) and finish a facade-owned
        span; transport-owned spans finish at the transport after the
        serialize stage."""
        obs = self.obs
        if obs is None:
            return
        if obs.audit is not None:
            try:
                obs.audit.maybe_record(
                    req, response,
                    span.trace_id if span is not None else None,
                )
            except Exception:  # noqa: BLE001 — audit must never fail serving
                if self.logger:
                    self.logger.exception("decision audit record failed")
        if own_span and obs.tracer is not None:
            obs.tracer.finish(span, decision=response.decision,
                              code=response.operation_status.code)

    def _observe(self, histogram_name, t0, decisions=()):
        """One helper for success AND deny-on-exception paths so served
        responses always match the counters."""
        telemetry = self.telemetry
        if telemetry is None:
            return
        getattr(telemetry, histogram_name).observe(time.perf_counter() - t0)
        for decision in decisions:
            telemetry.decisions.inc(decision)

    # ------------------------------------------------------------- endpoints

    def is_allowed(self, request: Any,
                   deadline: Optional[float] = None) -> Response:
        """Deny-by-default on any evaluation exception
        (reference: accessControlService.ts:62-81).  ``deadline`` is an
        absolute monotonic instant propagated from the transport (gRPC
        deadline / x-acs-timeout-ms metadata, srv/admission.py): it rides
        the request as ``_deadline`` for deadline-aware adapter retries
        and, with admission enabled, gates the batcher submit."""
        t0 = time.perf_counter()
        req = request
        span = None
        own_span = False
        try:
            req = coerce_request(request)
            span, own_span = self._observed_request(req)
            if deadline is not None:
                req._deadline = deadline
            if self.batcher is not None:
                # resolve token subject + HR scopes in THIS thread: the
                # rendezvous can block for up to hrReqTimeout, which must
                # never happen on the batcher's collector thread
                self.engine.prepare_context(req)
                timeout = 30.0
                if deadline is not None:
                    timeout = min(
                        timeout, max(0.1, deadline - time.monotonic()) + 5.0
                    )
                response = self.batcher.submit(
                    req, deadline=deadline
                ).result(timeout=timeout)
            elif self.evaluator is not None:
                response = self.evaluator.is_allowed(req)
            else:
                response = self.engine.is_allowed(req)
            self._observe("is_allowed_latency", t0, (response.decision,))
            self._finish_observed(req, response, span, own_span)
            self._shadow_tap([req], [response])
            return response
        except Exception as err:
            if self.logger:
                self.logger.exception("isAllowed failed")
            self._observe("is_allowed_latency", t0, (Decision.DENY,))
            code = getattr(err, "code", 500)
            response = Response(
                decision=Decision.DENY,
                obligations=[],
                evaluation_cacheable=False,
                operation_status=OperationStatus(
                    code=code if isinstance(code, int) else 500,
                    message=str(err) or "Unknown Error!",
                ),
            )
            self._finish_observed(req, response, span, own_span)
            return response

    def is_allowed_batch(
        self, requests: list, observe: bool = True,
        deadline: Optional[float] = None,
    ) -> list[Response]:
        # observe=False lets a caller that does its own per-RPC telemetry
        # (the raw-bytes gRPC fast path serving fallback rows through here)
        # suppress this layer's histogram/counter updates so no request is
        # double-counted
        t0 = time.perf_counter()
        _observe = self._observe if observe else (lambda *a, **k: None)
        try:
            reqs = [coerce_request(r) for r in requests]
        except Exception as err:
            _observe("batch_latency", t0,
                     [Decision.DENY] * len(requests))
            code = getattr(err, "code", 500)
            status = OperationStatus(
                code=code if isinstance(code, int) else 500, message=str(err)
            )
            return [
                Response(decision=Decision.DENY, operation_status=status)
                for _ in requests
            ]
        if deadline is not None:
            for req in reqs:
                req._deadline = deadline
        try:
            if self.evaluator is not None:
                responses = self.evaluator.is_allowed_batch(reqs)
            else:
                responses = [self.engine.is_allowed(r) for r in reqs]
            _observe("batch_latency", t0,
                     [r.decision for r in responses])
            if self.obs is not None and self.obs.audit is not None:
                for row_req, row_resp in zip(reqs, responses):
                    row_span = getattr(row_req, "_span", None)
                    try:
                        self.obs.audit.maybe_record(
                            row_req, row_resp,
                            row_span.trace_id if row_span else None,
                        )
                    except Exception:  # noqa: BLE001 — never fail serving
                        pass
            self._shadow_tap(reqs, responses)
            return responses
        except Exception as err:
            # same deny-on-exception contract as the single-request path
            if self.logger:
                self.logger.exception("isAllowedBatch failed")
            _observe("batch_latency", t0, [Decision.DENY] * len(reqs))
            code = getattr(err, "code", 500)
            status = OperationStatus(
                code=code if isinstance(code, int) else 500,
                message=str(err) or "Unknown Error!",
            )
            return [
                Response(decision=Decision.DENY, operation_status=status)
                for _ in reqs
            ]

    def _admission(self):
        """The admission controller when one is wired AND enabled (via
        the batcher — srv/worker.py), else None."""
        batcher = self.batcher
        admission = getattr(batcher, "admission", None)
        if admission is not None and admission.enabled:
            return admission
        return None

    def what_is_allowed_batch(
        self, requests: list, deadline: Optional[float] = None
    ) -> list[ReverseQuery]:
        """Batched reverse query through the device-assisted path
        (framework extension; single-request semantics per row with the
        same deny-on-exception error shape).  Under admission control the
        whole batch is one BULK-class admission unit: saturation sheds it
        with the overload status instead of queueing unboundedly."""
        t0 = time.perf_counter()
        admission = self._admission()
        released = True
        try:
            reqs = [coerce_request(r) for r in requests]
            if deadline is not None:
                for req in reqs:
                    req._deadline = deadline
            if admission is not None:
                from .admission import BULK

                shed = admission.admit(BULK, deadline)
                if shed is not None:
                    self._observe("what_is_allowed_latency", t0)
                    return [
                        ReverseQuery(policy_sets=[], obligations=[],
                                     operation_status=shed.operation_status)
                        for _ in reqs
                    ]
                released = False
            if self.evaluator is not None:
                out = self.evaluator.what_is_allowed_batch(reqs)
            else:
                out = [self.engine.what_is_allowed(r) for r in reqs]
            self._observe("what_is_allowed_latency", t0)
            return out
        except Exception as err:
            if self.logger:
                self.logger.exception("whatIsAllowedBatch failed")
            self._observe("what_is_allowed_latency", t0)
            code = getattr(err, "code", 500)
            status = OperationStatus(
                code=code if isinstance(code, int) else 500,
                message=str(err) or "Unknown Error!",
            )
            return [
                ReverseQuery(policy_sets=[], obligations=[],
                             operation_status=status)
                for _ in requests
            ]
        finally:
            if admission is not None and not released:
                from .admission import BULK

                admission.release(BULK, 1)

    def what_is_allowed(self, request: Any,
                        deadline: Optional[float] = None) -> ReverseQuery:
        """(reference: accessControlService.ts:83-101)

        With admission enabled, reverse queries are the BULK traffic
        class: they ride the batcher's bounded bulk queue (shed with the
        overload status when saturated) so interactive isAllowed traffic
        keeps its latency bound under a reverse-query flood — and vice
        versa, the fairness interval keeps bulk progressing."""
        t0 = time.perf_counter()
        try:
            req = coerce_request(request)
            if deadline is not None:
                req._deadline = deadline
            if self._admission() is not None:
                self.engine.prepare_context(req)
                timeout = 30.0
                if deadline is not None:
                    timeout = min(
                        timeout, max(0.1, deadline - time.monotonic()) + 5.0
                    )
                rq = self.batcher.submit_reverse(
                    req, deadline=deadline
                ).result(timeout=timeout)
            else:
                rq = self.engine.what_is_allowed(req)
            self._observe("what_is_allowed_latency", t0)
            return rq
        except Exception as err:
            if self.logger:
                self.logger.exception("whatIsAllowed failed")
            self._observe("what_is_allowed_latency", t0)
            code = getattr(err, "code", 500)
            return ReverseQuery(
                policy_sets=[],
                obligations=[],
                operation_status=OperationStatus(
                    code=code if isinstance(code, int) else 500,
                    message=str(err) or "Unknown Error!",
                ),
            )

    # --------------------------------------------------------------- loading

    def load_policies(self) -> None:
        """local-YAML vs database policy source
        (reference: accessControlService.ts:36-54)."""
        policies_cfg = self.cfg.get("policies", {}) or {}
        kind = policies_cfg.get("type", "local")
        if kind == "local":
            for path in policies_cfg.get("paths", []) or []:
                for policy_set in load_policy_sets_from_file(path):
                    self.engine.update_policy_set(policy_set)
            if self.evaluator is not None:
                self.evaluator.refresh()
        elif kind == "database":
            if self.store is None:
                raise ValueError("database policy source requires a store")
            self.store.load()
        else:
            raise ValueError(f"unknown policies.type {kind!r}")
