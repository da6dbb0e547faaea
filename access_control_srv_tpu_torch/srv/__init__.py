"""Serving layer of the port: the composition-root worker, the policy
store with CRUD and hot recompile, the service facade, the micro-batcher,
admission control, the command interface, stage tracing and telemetry,
the device watchdog, the hybrid kernel/oracle evaluator (with its
decision cache, token / HR-scope preparation and native wire path), the
identity clients, the subject and HR-scope caches, the resource adapters,
the failpoint registry, the relation-tuple store it serves ReBAC trees
from (with its event bus), the permission-lattice audit sweep, and the
cluster tier's broker (``broker``) and router (``router``).  The gRPC
transports (``transport_grpc``, ``transport_rc``), the router and the
stream pipeline import ``grpc`` and protobuf, so they are imported only
where they are used.

The names below load their module on first use (PEP 562), so a process
that needs one module (the broker process imports ``srv.broker`` alone)
does not import the evaluator, ``torch`` and the rest."""

import importlib

# exported name -> its module
_EXPORTS = {
    "AdmissionController": "admission", "CircuitBreaker": "admission",
    "HRScopeProvider": "cache", "SubjectCache": "cache",
    "CommandInterface": "command", "Config": "config",
    "HybridEvaluator": "evaluator", "EventBus": "events", "Topic": "events",
    "GrpcIdentityClient": "identity", "IdentityClient": "identity",
    "MockIdentityServer": "identity", "StaticIdentityClient": "identity",
    "RelationTupleStore": "relations",
    "AccessControlService": "service",
    "PolicyStore": "store", "ResourceService": "store",
    "Observability": "tracing", "Span": "tracing", "StageTracer": "tracing",
    "Worker": "worker",
}


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{module}", __name__), name)
    globals()[name] = value
    return value


__all__ = [
    "AccessControlService",
    "AdmissionController",
    "CircuitBreaker",
    "CommandInterface",
    "Config",
    "EventBus",
    "GrpcIdentityClient",
    "HRScopeProvider",
    "HybridEvaluator",
    "IdentityClient",
    "MockIdentityServer",
    "Observability",
    "PolicyStore",
    "RelationTupleStore",
    "ResourceService",
    "Span",
    "StageTracer",
    "StaticIdentityClient",
    "SubjectCache",
    "Worker",
]
