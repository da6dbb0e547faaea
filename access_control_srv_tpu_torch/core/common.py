"""Shared helpers for the core evaluation modules.

The lookup order in ``find_ctx_resource`` is normative reference behavior
(wrapped ``instance.id`` first, then direct ``id``; reference:
src/core/hierarchicalScope.ts:106-112 and src/core/verifyACL.ts:40-48) and
must stay identical between the HR-scope and ACL paths.
"""

from __future__ import annotations

from typing import Any, Optional


def get_field(obj: Any, key: str, default=None):
    """Uniform field access over dicts and objects (context data is
    JSON-like; model nodes are dataclasses)."""
    if obj is None:
        return default
    if isinstance(obj, dict):
        return obj.get(key, default)
    return getattr(obj, key, default)


def find_ctx_resource(ctx_resources: list, instance_id: str) -> Optional[dict]:
    """Find a context resource by wrapped instance id, else by direct id."""
    for res in ctx_resources or []:
        inst = get_field(res, "instance")
        if inst is not None and get_field(inst, "id") == instance_id:
            return inst
    for res in ctx_resources or []:
        if get_field(res, "id") == instance_id:
            return res
    return None
