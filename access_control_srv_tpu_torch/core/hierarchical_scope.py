"""Hierarchical role-scope / owner-tree matching.

Faithful re-implementation of the reference semantics
(reference: src/core/hierarchicalScope.ts:10-259), including its quirks:

- a rule with an *empty* subject list passes immediately; a rule without a
  roleScopingEntity attribute passes immediately (lines 21-42);
- the entity-match flag is sticky across request resource attributes and is
  only reset by a namespace mismatch in the regex branch (lines 64-102);
- missing context resources / missing owner metadata fail the check
  (lines 113-123);
- direct owner-vs-role-association matching happens before hierarchical
  (HR-tree) matching, and HR matching can be disabled per rule via the
  hierarchicalRoleScoping attribute string value 'false' (lines 165-245).
"""

from __future__ import annotations

import re
from typing import Optional

from ..models.model import Request, Target
from .common import find_ctx_resource as _find_ctx_resource
from .common import get_field as _get


_SPLIT_CACHE: dict[str, tuple[Optional[str], str, str]] = {}


def split_entity_urn(value: str) -> tuple[Optional[str], str, str]:
    """Split an entity URN into (namespace-or-None, regex/entity tail,
    urn-prefix-before-last-colon).

    Given ``urn:...:ns.Entity``: the tail after the last ':' is split on '.';
    the first element is a namespace iff it differs (case-insensitively)
    from the last element (reference: hierarchicalScope.ts:66-76).

    Memoized: the same entity URNs recur on every request (the batch
    encoder was spending ~15% of encode time re-splitting them)."""
    value = value or ""
    hit = _SPLIT_CACHE.get(value)
    if hit is not None:
        return hit
    prefix = value[: value.rfind(":")] if ":" in value else ""
    pattern = value[value.rfind(":") + 1:] if ":" in value else value
    parts = pattern.split(".")
    ns_or_entity = parts[0]
    entity_value = parts[-1]
    ns = None
    if (ns_or_entity or "").upper() != (entity_value or "").upper():
        ns = (ns_or_entity or "").upper()
    out = (ns, entity_value, prefix)
    if len(_SPLIT_CACHE) < 65536:
        _SPLIT_CACHE[value] = out
    return out


_REGEX_CMP_CACHE: dict[tuple[str, str], tuple[bool, bool]] = {}


def regex_entity_compare(rule_value: str, req_value: str) -> tuple[bool, bool]:
    """The reference's regex-branch entity comparison, shared by the
    matcher, the HR-scope check and the batch encoder (reference:
    accessController.ts:526-566 / hierarchicalScope.ts:64-102).

    Returns ``(set_flag, prefix_mismatch)``: the caller updates its sticky
    entity-match state as ``set_flag ? True : (prefix_mismatch ? False :
    state)`` — a regex hit wins over the prefix reset, mirroring the
    reference statement order.  Invalid regex patterns propagate (the
    reference's ``new RegExp`` throws; the service layer denies).

    Memoized per (rule, request) value pair: outcomes are deterministic
    and the batch encoder re-evaluates the same vocab-x-entity grid every
    batch (errors are not cached so an invalid pattern keeps raising)."""
    key = (rule_value, req_value)
    hit = _REGEX_CMP_CACHE.get(key)
    if hit is not None:
        return hit
    rule_ns, rule_regex, rule_prefix = split_entity_urn(rule_value)
    req_ns, req_entity, req_prefix = split_entity_urn(req_value or "")
    matched = False
    if (req_ns and rule_ns and req_ns == rule_ns) or (not req_ns and not rule_ns):
        matched = req_entity is not None and bool(re.search(rule_regex, req_entity))
    out = (matched, req_prefix != rule_prefix)
    if len(_REGEX_CMP_CACHE) < 65536:
        _REGEX_CMP_CACHE[key] = out
    return out


def check_hierarchical_scope(
    rule_target: Target,
    request: Request,
    urns,
    access_controller,
    logger=None,
) -> bool:
    resource_id_owners_map: dict[str, list] = {}

    subjects = rule_target.subjects if rule_target else None
    if subjects is not None and len(subjects) == 0:
        return True  # no scoping entities specified in rule

    hierarchical_role_scope_check = "true"
    rule_role: Optional[str] = None
    rule_role_scoping_entity: Optional[str] = None
    role_urn = urns.get("role")
    for subject_attr in subjects or []:
        if subject_attr.id == role_urn:
            rule_role = subject_attr.value
        elif subject_attr.id == urns.get("hierarchicalRoleScoping"):
            hierarchical_role_scope_check = subject_attr.value
        elif subject_attr.id == urns.get("roleScopingEntity"):
            rule_role_scoping_entity = subject_attr.value

    if not rule_role_scoping_entity:
        return True  # no scoping entity in rule, request ignored

    context = request.context
    if not context:
        return False  # no context provided, evaluation fails

    ctx_resources = _get(context, "resources") or []
    req_target = request.target
    entity_or_operation: Optional[str] = None

    for attribute in (rule_target.resources or []):
        if attribute.id == urns.get("entity"):
            entity_or_operation = attribute.value
            entities_match = False
            for request_attribute in (req_target.resources or []):
                if (
                    request_attribute.id == attribute.id
                    and request_attribute.value == entity_or_operation
                ):
                    entities_match = True
                elif request_attribute.id == attribute.id:
                    set_flag, prefix_mismatch = regex_entity_compare(
                        entity_or_operation, request_attribute.value
                    )
                    if prefix_mismatch:
                        entities_match = False
                    if set_flag:
                        entities_match = True
                elif (
                    request_attribute.id == urns.get("resourceID")
                    and entities_match
                ):
                    instance_id = request_attribute.value
                    ctx_resource = _find_ctx_resource(ctx_resources, instance_id)
                    if ctx_resource is not None:
                        meta = _get(ctx_resource, "meta")
                        owners = _get(meta, "owners") if meta else None
                        if not meta or not owners:
                            return False  # no ownership was passed
                        resource_id_owners_map[instance_id] = owners
                    else:
                        return False  # resource not provided in context
        elif attribute.id == urns.get("operation"):
            entity_or_operation = attribute.value
            for req_attribute in (req_target.resources or []):
                if (
                    req_attribute.id == attribute.id
                    and req_attribute.value == attribute.value
                ):
                    ctx_resource = None
                    for res in ctx_resources:
                        if _get(res, "id") == entity_or_operation:
                            ctx_resource = res
                            break
                    if ctx_resource is not None:
                        meta = _get(ctx_resource, "meta")
                        owners = _get(meta, "owners") if meta else None
                        if not meta or not owners:
                            return False
                        resource_id_owners_map[entity_or_operation] = owners
                    else:
                        return False  # operation name not provided in context

    role_associations = _get(_get(context, "subject") or {}, "role_associations")
    if not role_associations:
        return False  # impossible to evaluate context

    reduced_user_role_assocs = [
        ra for ra in role_associations if _get(ra, "role") == rule_role
    ]

    role_scoping_entity_urn = urns.get("roleScopingEntity")
    role_scoping_instance_urn = urns.get("roleScopingInstance")
    owner_entity_urn = urns.get("ownerEntity")
    owner_instance_urn = urns.get("ownerInstance")

    # 1) direct owner-instance vs role-association-instance match
    delete_entries = []
    for resource_id, owners in resource_id_owners_map.items():
        matched = any(
            any(
                any(
                    _get(role_attr, "id") == role_scoping_entity_urn
                    and _get(owner, "id") == owner_entity_urn
                    and _get(owner, "value") == rule_role_scoping_entity
                    and _get(owner, "value") == _get(role_attr, "value")
                    and any(
                        _get(role_inst, "id") == role_scoping_instance_urn
                        and any(
                            _get(owner_inst, "value") == _get(role_inst, "value")
                            for owner_inst in (_get(owner, "attributes") or [])
                        )
                        for role_inst in (_get(role_attr, "attributes") or [])
                    )
                    for role_attr in (_get(role_obj, "attributes") or [])
                )
                for role_obj in reduced_user_role_assocs
            )
            for owner in (owners or [])
        )
        if matched:
            delete_entries.append(resource_id)
    for entry in delete_entries:
        resource_id_owners_map.pop(entry, None)

    if len(resource_id_owners_map) == 0:
        return True  # role scoping entities and instances matched

    # 2) hierarchical match against the flattened HR-scope subtree
    if len(resource_id_owners_map) > 0 and hierarchical_role_scope_check == "true":
        delete_entries = []
        subject = _get(context, "subject") or {}
        if _get(subject, "token") and not _get(subject, "hierarchical_scopes"):
            context = access_controller.create_hr_scope(context)
            subject = _get(context, "subject") or {}

        hierarchical_scopes = _get(subject, "hierarchical_scopes")
        if hierarchical_scopes is None:
            # the reference iterates an undefined list here and throws
            # (hierarchicalScope.ts:209-220); surface the same failure as a
            # typed error the service layer denies on
            from .errors import InvalidRequestContext

            raise InvalidRequestContext("subject.hierarchical_scopes missing")
        reduced_hr_scopes = [
            h for h in hierarchical_scopes if _get(h, "role") == rule_role
        ]
        flat_org_list: list[str] = []

        def collect(nodes):
            for hr_obj in nodes or []:
                hr_id = _get(hr_obj, "id")
                if hr_id and hr_id not in flat_org_list:
                    flat_org_list.append(hr_id)
                children = _get(hr_obj, "children") or []
                if len(children) > 0:
                    collect(children)

        collect(reduced_hr_scopes)

        for resource_id, owners in resource_id_owners_map.items():
            owner_instances = [
                _get(attr, "value")
                for owner in (owners or [])
                if any(
                    any(
                        _get(role_attr, "id") == role_scoping_entity_urn
                        and _get(owner, "id") == owner_entity_urn
                        and _get(owner, "value") == rule_role_scoping_entity
                        and _get(owner, "value") == _get(role_attr, "value")
                        for role_attr in (_get(role_obj, "attributes") or [])
                    )
                    for role_obj in reduced_user_role_assocs
                )
                for attr in (_get(owner, "attributes") or [])
                if _get(attr, "id") == owner_instance_urn
            ]
            if any(org_id in owner_instances for org_id in flat_org_list):
                delete_entries.append(resource_id)

        for entry in delete_entries:
            resource_id_owners_map.pop(entry, None)

    if len(resource_id_owners_map) == 0:
        return True  # matched from HR scopes

    return False  # subject not in HR scope
