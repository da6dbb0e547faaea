"""Compiler, encoder, host-to-device carry, the device kernels, the reverse
query and the permission lattice."""

from .interner import StringInterner
from .compile import CompiledPolicies, compile_policies
from .encode import RequestBatch, encode_requests
from .kernel import DecisionKernel
from .prefilter import MIN_RULES, PrefilteredKernel, compact_rules
from .reverse import ReverseQueryKernel, what_is_allowed_batch
from .lattice import (
    CellVerdict,
    LatticeSpec,
    SnapshotWriter,
    diff_snapshots,
    fold_reverse_query,
    load_snapshot,
)

__all__ = [
    "CellVerdict",
    "CompiledPolicies",
    "DecisionKernel",
    "LatticeSpec",
    "MIN_RULES",
    "PrefilteredKernel",
    "RequestBatch",
    "ReverseQueryKernel",
    "SnapshotWriter",
    "StringInterner",
    "compact_rules",
    "compile_policies",
    "diff_snapshots",
    "encode_requests",
    "fold_reverse_query",
    "load_snapshot",
    "what_is_allowed_batch",
]
