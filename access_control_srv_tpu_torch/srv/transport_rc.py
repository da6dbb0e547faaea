"""Reference-wire compatibility layer.

Registers the worker's services under the RESTORECOMMERCE wire names —
``io.restorecommerce.access_control.AccessControlService`` (IsAllowed /
WhatIsAllowed), the three CRUD services
(``io.restorecommerce.rule.RuleService`` et al.),
``io.restorecommerce.commandinterface.CommandInterfaceService`` and
``grpc.health.v1.Health`` — with the message shapes of the public
restorecommerce protos, so a stock restorecommerce client (e.g.
acs-client) can call this service unmodified.  The reference binds
exactly these definitions (reference: src/worker.ts:160-194,
RuleServiceDefinition / PolicyServiceDefinition /
PolicySetServiceDefinition / AccessControlServiceDefinition /
CommandInterfaceServiceDefinition / HealthDefinition).

The proto files under proto/rc/ are a RECONSTRUCTION of the public
``@restorecommerce/protos`` package (github.com/restorecommerce/libs,
packages/protos/io/restorecommerce/*.proto): this environment has no
network access to vendor the originals, so field numbers follow the
public protos' declaration order and the subset covers the surface this
service binds.  docs/WIRE_COMPAT.md records the reconstruction status
per message.

Known proto3 semantic edge: ``Effect`` has no presence, so an unset
policy effect is indistinguishable from PERMIT(0) on the wire.  Rules
always carry an effect; for policies the ambiguity is harmless when the
policy has rules (the engine only consults policy effect when its rule
list is empty — reference: accessController.ts:198-200), and a no-rules
policy maps PERMIT(0) to an explicit PERMIT effect.
"""

from __future__ import annotations

import json
import time

import grpc

from ..models.model import Attribute, Request, Target
from .admission import deadline_from_context, tenant_from_metadata
from .tracing import (
    STAGE_SERIALIZE,
    STAGE_TRANSPORT_PARSE,
    echo_trace_id,
    trace_id_from_metadata,
)
from .gen.rc import access_control_pb2 as rc_ac
from .gen.rc import attribute_pb2 as rc_attr
from .gen.rc import commandinterface_pb2 as rc_ci
from .gen.rc import health_pb2 as rc_health
from .gen.rc import policy_pb2 as rc_policy
from .gen.rc import policy_set_pb2 as rc_policy_set
from .gen.rc import resource_base_pb2 as rc_rb
from .gen.rc import rule_pb2 as rc_rule
from .gen.rc import status_pb2 as rc_status
from .transport_grpc import _ctx_value_from_pb, _unary

# rc Decision enum: PERMIT=0, DENY=1, INDETERMINATE=2 (Response.Decision)
_DECISION_TO_RC = {
    "PERMIT": rc_ac.Response.PERMIT,
    "DENY": rc_ac.Response.DENY,
    "INDETERMINATE": rc_ac.Response.INDETERMINATE,
}
_EFFECT_TO_RC = {"PERMIT": rc_rule.PERMIT, "DENY": rc_rule.DENY}
_RC_TO_EFFECT = {rc_rule.PERMIT: "PERMIT", rc_rule.DENY: "DENY"}


# ------------------------------------------------------------- converters

def _attr_from_rc(msg) -> Attribute:
    return Attribute(
        id=msg.id, value=msg.value,
        attributes=[_attr_from_rc(a) for a in msg.attributes],
    )


def _attr_to_rc(attr: Attribute):
    return rc_attr.Attribute(
        id=attr.id or "", value=attr.value or "",
        attributes=[_attr_to_rc(a) for a in attr.attributes or []],
    )


def _target_from_rc(msg) -> Target:
    return Target(
        subjects=[_attr_from_rc(a) for a in msg.subjects],
        resources=[_attr_from_rc(a) for a in msg.resources],
        actions=[_attr_from_rc(a) for a in msg.actions],
    )


def _target_to_rc(target: Target):
    return rc_rule.Target(
        subjects=[_attr_to_rc(a) for a in target.subjects or []],
        resources=[_attr_to_rc(a) for a in target.resources or []],
        actions=[_attr_to_rc(a) for a in target.actions or []],
    )


# google.protobuf.Any carrying JSON bytes — the reference unmarshals
# context Any values as JSON (accessControlService.ts:103-125); the
# field shape matches the internal ContextValue so the acstpu converter
# is shared
_any_from_rc = _ctx_value_from_pb


def request_from_rc(msg) -> Request:
    context = None
    if msg.HasField("context"):
        context = {}
        if msg.context.HasField("subject"):
            context["subject"] = _any_from_rc(msg.context.subject)
        context["resources"] = [
            _any_from_rc(r) for r in msg.context.resources
        ]
        if msg.context.HasField("security"):
            context["security"] = _any_from_rc(msg.context.security)
    target = _target_from_rc(msg.target) if msg.HasField("target") else None
    return Request(target=target, context=context)


def response_to_rc(response):
    return rc_ac.Response(
        decision=_DECISION_TO_RC.get(
            response.decision, rc_ac.Response.INDETERMINATE
        ),
        obligations=[_attr_to_rc(a) for a in response.obligations or []],
        evaluation_cacheable=bool(response.evaluation_cacheable),
        operation_status=rc_status.OperationStatus(
            code=response.operation_status.code,
            message=response.operation_status.message,
        ),
    )


def reverse_query_to_rc(rq):
    out = rc_ac.ReverseQuery(
        obligations=[_attr_to_rc(a) for a in rq.obligations or []],
        operation_status=rc_status.OperationStatus(
            code=rq.operation_status.code,
            message=rq.operation_status.message,
        ),
    )
    for ps in rq.policy_sets:
        ps_msg = out.policy_sets.add(
            id=ps.id or "",
            combining_algorithm=ps.combining_algorithm or "",
        )
        if ps.effect:
            ps_msg.effect = _EFFECT_TO_RC.get(ps.effect, rc_rule.PERMIT)
        if ps.target is not None:
            ps_msg.target.CopyFrom(_target_to_rc(ps.target))
        for pol in ps.policies:
            p_msg = ps_msg.policies.add(
                id=pol.id or "",
                combining_algorithm=pol.combining_algorithm or "",
                evaluation_cacheable=bool(pol.evaluation_cacheable),
                has_rules=bool(pol.has_rules),
            )
            if pol.effect:
                p_msg.effect = _EFFECT_TO_RC.get(pol.effect, rc_rule.PERMIT)
            if pol.target is not None:
                p_msg.target.CopyFrom(_target_to_rc(pol.target))
            for rule in pol.rules:
                r_msg = p_msg.rules.add(
                    id=rule.id or "",
                    effect=_EFFECT_TO_RC.get(rule.effect, rc_rule.PERMIT),
                    condition=rule.condition or "",
                    evaluation_cacheable=bool(rule.evaluation_cacheable),
                )
                if rule.target is not None:
                    r_msg.target.CopyFrom(_target_to_rc(rule.target))
                if rule.context_query is not None:
                    r_msg.context_query.query = rule.context_query.query or ""
                    if rule.context_query.filters:
                        flt = r_msg.context_query.filters.add()
                        for f in rule.context_query.filters:
                            flt.filters.add(
                                field=str(f.get("field") or ""),
                                operation=str(f.get("operation") or ""),
                                value=str(f.get("value") or ""),
                            )
    return out


def _attr_dict_from_rc(msg) -> dict:
    return {
        "id": msg.id,
        "value": msg.value,
        "attributes": [_attr_dict_from_rc(a) for a in msg.attributes],
    }


def _target_dict_from_rc(msg) -> dict:
    return {
        "subjects": [_attr_dict_from_rc(a) for a in msg.subjects],
        "resources": [_attr_dict_from_rc(a) for a in msg.resources],
        "actions": [_attr_dict_from_rc(a) for a in msg.actions],
    }


def _meta_dict_from_rc(msg) -> dict:
    out = {
        "owners": [_attr_dict_from_rc(a) for a in msg.owners],
        "acls": [_attr_dict_from_rc(a) for a in msg.acls],
    }
    if msg.created:
        out["created"] = msg.created
    if msg.modified:
        out["modified"] = msg.modified
    return out


def rule_doc_from_rc(msg) -> dict:
    doc = {
        "id": msg.id,
        "name": msg.name,
        "description": msg.description,
        "effect": _RC_TO_EFFECT.get(msg.effect, "PERMIT"),
        "condition": msg.condition,
        "evaluation_cacheable": msg.evaluation_cacheable,
    }
    if msg.HasField("target"):
        doc["target"] = _target_dict_from_rc(msg.target)
    if msg.HasField("context_query"):
        # the internal model keeps one flat filter list (the adapter
        # resolves filters as a set, srv/adapters.py); multi-group
        # grouping flattens on ingest — re-emission uses a single group
        filters = []
        for group in msg.context_query.filters:
            for f in group.filters:
                filters.append({"field": f.field, "operation": f.operation,
                                "value": f.value})
        doc["context_query"] = {
            "query": msg.context_query.query, "filters": filters,
        }
    if msg.HasField("meta"):
        doc["meta"] = _meta_dict_from_rc(msg.meta)
    return doc


def policy_doc_from_rc(msg) -> dict:
    rules = list(msg.rules)
    if msg.effect == rc_rule.DENY:
        effect = "DENY"
    elif not rules:
        effect = "PERMIT"
    else:
        # proto3 presence gap: PERMIT(0) on a rules-bearing policy is
        # indistinguishable from unset; rules dominate either way (see
        # module docstring)
        effect = None
    doc = {
        "id": msg.id,
        "name": msg.name,
        "description": msg.description,
        "effect": effect,
        "combining_algorithm": msg.combining_algorithm,
        "rules": rules,
        "evaluation_cacheable": msg.evaluation_cacheable,
    }
    if msg.HasField("target"):
        doc["target"] = _target_dict_from_rc(msg.target)
    if msg.HasField("meta"):
        doc["meta"] = _meta_dict_from_rc(msg.meta)
    return doc


def policy_set_doc_from_rc(msg) -> dict:
    doc = {
        "id": msg.id,
        "name": msg.name,
        "description": msg.description,
        "combining_algorithm": msg.combining_algorithm,
        "policies": list(msg.policies),
    }
    if msg.HasField("target"):
        doc["target"] = _target_dict_from_rc(msg.target)
    if msg.HasField("meta"):
        doc["meta"] = _meta_dict_from_rc(msg.meta)
    return doc


def _attr_rc_from_dict(d: dict):
    return rc_attr.Attribute(
        id=str(d.get("id") or ""), value=str(d.get("value") or ""),
        attributes=[_attr_rc_from_dict(a) for a in d.get("attributes") or []],
    )


def _fill_common_rc(msg, doc: dict) -> None:
    msg.id = doc.get("id") or ""
    msg.name = doc.get("name") or ""
    msg.description = doc.get("description") or ""
    target = doc.get("target")
    if target:
        msg.target.subjects.extend(
            _attr_rc_from_dict(a) for a in target.get("subjects") or []
        )
        msg.target.resources.extend(
            _attr_rc_from_dict(a) for a in target.get("resources") or []
        )
        msg.target.actions.extend(
            _attr_rc_from_dict(a) for a in target.get("actions") or []
        )
    meta = doc.get("meta")
    if meta:
        msg.meta.owners.extend(
            _attr_rc_from_dict(a) for a in meta.get("owners") or []
        )
        msg.meta.acls.extend(
            _attr_rc_from_dict(a) for a in meta.get("acls") or []
        )
        if meta.get("created"):
            msg.meta.created = float(meta["created"])
        if meta.get("modified"):
            msg.meta.modified = float(meta["modified"])


def rule_doc_to_rc(doc: dict):
    msg = rc_rule.Rule()
    _fill_common_rc(msg, doc)
    if doc.get("effect"):
        msg.effect = _EFFECT_TO_RC.get(doc["effect"], rc_rule.PERMIT)
    if doc.get("condition"):
        msg.condition = doc["condition"]
    msg.evaluation_cacheable = bool(doc.get("evaluation_cacheable"))
    cq = doc.get("context_query")
    if cq:
        msg.context_query.query = cq.get("query") or ""
        if cq.get("filters"):
            flt = msg.context_query.filters.add()
            for f in cq["filters"]:
                flt.filters.add(
                    field=str(f.get("field") or ""),
                    operation=str(f.get("operation") or ""),
                    value=str(f.get("value") or ""),
                )
    return msg


def policy_doc_to_rc(doc: dict):
    msg = rc_policy.Policy()
    _fill_common_rc(msg, doc)
    if doc.get("effect"):
        msg.effect = _EFFECT_TO_RC.get(doc["effect"], rc_rule.PERMIT)
    msg.rules.extend(doc.get("rules") or [])
    msg.combining_algorithm = doc.get("combining_algorithm") or ""
    msg.evaluation_cacheable = bool(doc.get("evaluation_cacheable"))
    return msg


def policy_set_doc_to_rc(doc: dict):
    msg = rc_policy_set.PolicySet()
    _fill_common_rc(msg, doc)
    msg.policies.extend(doc.get("policies") or [])
    msg.combining_algorithm = doc.get("combining_algorithm") or ""
    return msg


def _subject_from_rc(msg) -> dict | None:
    if not (msg.id or msg.token or msg.scope):
        return None
    subject = {"id": msg.id or None, "token": msg.token or None,
               "scope": msg.scope or None}
    if msg.role_associations:
        subject["role_associations"] = [
            {"role": ra.role,
             "attributes": [_attr_dict_from_rc(a) for a in ra.attributes]}
            for ra in msg.role_associations
        ]
    if msg.hierarchical_scopes:
        def hs(node):
            return {"id": node.id, "role": node.role,
                    "children": [hs(c) for c in node.children]}

        subject["hierarchical_scopes"] = [
            hs(n) for n in msg.hierarchical_scopes
        ]
    return subject


def _read_filters_from_rc(msg) -> dict | None:
    """ReadRequest ids shorthand + FilterOp groups -> the store's filter
    DSL (groups AND together, predicates combine with the group
    operator — reference resource-base-interface semantics)."""
    or_op = rc_rb.FilterOp.Operator.Value("or")
    groups = []
    for group in msg.filters:
        groups.append({
            "operator": "or" if group.operator == or_op else "and",
            "filters": [
                {"field": f.field,
                 "operation": rc_rb.Filter.Operation.Name(f.operation),
                 "value": f.value}
                for f in group.filters
            ],
        })
    return {"filters": groups} if groups else None


# ----------------------------------------------------------------- server

def register_rc_services(server, worker) -> None:
    """Add the restorecommerce-wire generic handlers to a grpc server
    (called by GrpcServer alongside the acstpu services)."""
    obs = getattr(worker, "obs", None)

    def is_allowed(request, context):
        # rc-wire deadline propagation: native gRPC deadlines and the
        # x-acs-timeout-ms metadata key both become the request budget
        # (srv/admission.deadline_from_context)
        tenant = tenant_from_metadata(context)
        if obs is None or obs.tracer is None:
            req = request_from_rc(request)
            if tenant is not None:
                req._tenant = tenant
            return response_to_rc(
                worker.service.is_allowed(
                    req, deadline=deadline_from_context(context),
                )
            )
        # traced path: same span/trace-id contract as the acstpu-wire
        # handler (srv/transport_grpc.py) — reference-wire clients get
        # the identical observability surface
        tracer = obs.tracer
        t0 = time.perf_counter()
        span = tracer.start_span(trace_id_from_metadata(context))
        req = request_from_rc(request)
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
        msg = response_to_rc(response)
        tracer.record(span, STAGE_SERIALIZE, time.perf_counter() - t_ser)
        if span is not None:
            echo_trace_id(context, span.trace_id)
            tracer.finish(span, decision=response.decision,
                          code=response.operation_status.code)
        return msg

    def what_is_allowed(request, context):
        req = request_from_rc(request)
        tenant = tenant_from_metadata(context)
        if tenant is not None:
            req._tenant = tenant
        return reverse_query_to_rc(
            worker.service.what_is_allowed(
                req, deadline=deadline_from_context(context),
            )
        )

    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler(
            "io.restorecommerce.access_control.AccessControlService",
            {
                "IsAllowed": _unary(is_allowed, rc_ac.Request, rc_ac.Response),
                "WhatIsAllowed": _unary(
                    what_is_allowed, rc_ac.Request, rc_ac.ReverseQuery
                ),
            },
        ),
    ))

    for kind, service_name, doc_from, doc_to, list_cls, resp_cls in (
        ("rule", "io.restorecommerce.rule.RuleService",
         rule_doc_from_rc, rule_doc_to_rc,
         rc_rule.RuleList, rc_rule.RuleListResponse),
        ("policy", "io.restorecommerce.policy.PolicyService",
         policy_doc_from_rc, policy_doc_to_rc,
         rc_policy.PolicyList, rc_policy.PolicyListResponse),
        ("policy_set", "io.restorecommerce.policy_set.PolicySetService",
         policy_set_doc_from_rc, policy_set_doc_to_rc,
         rc_policy_set.PolicySetList, rc_policy_set.PolicySetListResponse),
    ):
        handlers = _crud_handlers_rc(
            worker, kind, doc_from, doc_to, resp_cls
        )
        server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(service_name, {
                "Read": _unary(handlers["read"], rc_rb.ReadRequest, resp_cls),
                "Create": _unary(handlers["create"], list_cls, resp_cls),
                "Update": _unary(handlers["update"], list_cls, resp_cls),
                "Upsert": _unary(handlers["upsert"], list_cls, resp_cls),
                "Delete": _unary(handlers["delete"], rc_rb.DeleteRequest,
                                 rc_rb.DeleteResponse),
            }),
        ))

    def command(request, context):
        payload = {}
        if request.HasField("payload") and request.payload.value:
            try:
                payload = json.loads(request.payload.value)
            except ValueError:
                payload = {}
        result = worker.command_interface.command(request.name, payload)
        resp = rc_ci.CommandResponse()
        resp.result.value = json.dumps(result).encode()
        return resp

    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler(
            "io.restorecommerce.commandinterface.CommandInterfaceService",
            {"Command": _unary(command, rc_ci.CommandRequest,
                               rc_ci.CommandResponse)},
        ),
    ))

    def health_check(request, context):
        result = worker.command_interface.command("health_check")
        serving = result.get("status") in ("SERVING", "ok", "healthy")
        return rc_health.HealthCheckResponse(
            status=rc_health.HealthCheckResponse.SERVING if serving
            else rc_health.HealthCheckResponse.NOT_SERVING
        )

    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler(
            "grpc.health.v1.Health",
            {"Check": _unary(health_check, rc_health.HealthCheckRequest,
                             rc_health.HealthCheckResponse)},
        ),
    ))


def _crud_handlers_rc(worker, kind, doc_from, doc_to, resp_cls):
    service = worker.store.get_resource_service(kind)

    def to_response(result) -> object:
        resp = resp_cls()
        for item in result.get("items") or []:
            entry = resp.items.add()
            if item.get("payload"):
                entry.payload.CopyFrom(doc_to(item["payload"]))
            status = item.get("status") or {}
            entry.status.code = status.get("code", 200)
            entry.status.message = status.get("message", "success")
            entry.status.id = (item.get("payload") or {}).get("id") or ""
        resp.total_count = len(result.get("items") or [])
        op = result.get("operation_status") or {}
        resp.operation_status.code = op.get("code", 200)
        resp.operation_status.message = op.get("message", "success")
        return resp

    def create(request, context):
        return to_response(service.create(
            [doc_from(i) for i in request.items],
            subject=_subject_from_rc(request.subject),
        ))

    def update(request, context):
        return to_response(service.update(
            [doc_from(i) for i in request.items],
            subject=_subject_from_rc(request.subject),
        ))

    def upsert(request, context):
        return to_response(service.upsert(
            [doc_from(i) for i in request.items],
            subject=_subject_from_rc(request.subject),
        ))

    def read(request, context):
        result = service.read(_read_filters_from_rc(request))
        items = result.get("items")
        if items is not None:
            for sort in reversed(request.sorts):
                if not sort.field:
                    continue
                items.sort(
                    key=lambda it, f=sort.field: str(
                        (it.get("payload") or {}).get(f) or ""
                    ),
                    reverse=sort.order == rc_rb.Sort.DESCENDING,
                )
            offset = request.offset or 0
            if offset:
                items = items[offset:]
            if request.limit:
                items = items[: request.limit]
            result = dict(result, items=items)
        return to_response(result)

    def delete(request, context):
        result = service.delete(
            ids=list(request.ids), collection=request.collection,
            subject=_subject_from_rc(request.subject),
        )
        resp = rc_rb.DeleteResponse()
        op = result.get("operation_status") or {}
        resp.operation_status.code = op.get("code", 200)
        resp.operation_status.message = op.get("message", "success")
        return resp

    return {"create": create, "update": update, "upsert": upsert,
            "read": read, "delete": delete}
