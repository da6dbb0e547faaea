"""Serving layer of the port: the hybrid kernel/oracle evaluator."""

from .evaluator import HybridEvaluator

__all__ = ["HybridEvaluator"]
