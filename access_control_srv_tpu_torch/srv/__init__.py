"""Serving layer of the port: the composition-root worker, the policy
store with CRUD and hot recompile, the service facade, the micro-batcher,
admission control, the command interface, stage tracing and telemetry,
the device watchdog, the hybrid kernel/oracle evaluator (with its
decision cache, token / HR-scope preparation and native wire path), the
identity clients, the subject and HR-scope caches, the resource adapters,
the failpoint registry, the relation-tuple store it serves ReBAC trees
from (with its event bus) and the direct-mode permission-lattice audit
sweep.  The gRPC transports (``transport_grpc``, ``transport_rc``) and
the stream pipeline import ``grpc`` and protobuf, so they are imported
only where they are used."""

from .admission import AdmissionController, CircuitBreaker
from .cache import HRScopeProvider, SubjectCache
from .command import CommandInterface
from .config import Config
from .evaluator import HybridEvaluator
from .events import EventBus, Topic
from .identity import (
    GrpcIdentityClient,
    IdentityClient,
    MockIdentityServer,
    StaticIdentityClient,
)
from .relations import RelationTupleStore
from .service import AccessControlService
from .store import PolicyStore, ResourceService
from .tracing import Observability, Span, StageTracer
from .worker import Worker

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
