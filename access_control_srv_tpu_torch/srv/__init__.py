"""Serving layer of the port: the hybrid kernel/oracle evaluator and the
direct-mode permission-lattice audit sweep."""

from .evaluator import HybridEvaluator

__all__ = ["HybridEvaluator"]
