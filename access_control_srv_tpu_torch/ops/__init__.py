"""Compiler, encoder, host-to-device carry and the dense decision kernel."""

from .interner import StringInterner
from .compile import CompiledPolicies, compile_policies
from .encode import RequestBatch, encode_requests
from .kernel import DecisionKernel

__all__ = [
    "CompiledPolicies",
    "DecisionKernel",
    "RequestBatch",
    "StringInterner",
    "compile_policies",
    "encode_requests",
]
