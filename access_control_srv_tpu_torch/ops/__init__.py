"""Compiler, encoder, host-to-device carry and the decision kernels."""

from .interner import StringInterner
from .compile import CompiledPolicies, compile_policies
from .encode import RequestBatch, encode_requests
from .kernel import DecisionKernel
from .prefilter import MIN_RULES, PrefilteredKernel, compact_rules

__all__ = [
    "CompiledPolicies",
    "DecisionKernel",
    "MIN_RULES",
    "PrefilteredKernel",
    "RequestBatch",
    "StringInterner",
    "compact_rules",
    "compile_policies",
    "encode_requests",
]
