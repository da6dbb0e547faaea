"""Scalar policy-decision oracle (the normative engine)."""

from .engine import AccessController, DEFAULT_COMBINING_ALGORITHMS
from .loader import (
    load_policy_sets,
    load_policy_sets_from_file,
    load_seed_files,
    populate,
)
from .conditions import condition_matches
from .hierarchical_scope import check_hierarchical_scope
from .verify_acl import verify_acl_list
from . import errors

__all__ = [
    "AccessController",
    "DEFAULT_COMBINING_ALGORITHMS",
    "load_policy_sets",
    "load_policy_sets_from_file",
    "load_seed_files",
    "populate",
    "condition_matches",
    "check_hierarchical_scope",
    "verify_acl_list",
    "errors",
]
