"""Serving layer of the port: the hybrid kernel/oracle evaluator (with its
decision cache, token / HR-scope preparation and native wire path), the
identity clients, the subject and HR-scope caches, the resource adapters,
the failpoint registry, the relation-tuple store it serves ReBAC trees
from (with its event bus) and the direct-mode permission-lattice audit
sweep."""

from .evaluator import HybridEvaluator
from .events import EventBus
from .relations import RelationTupleStore

__all__ = ["EventBus", "HybridEvaluator", "RelationTupleStore"]
