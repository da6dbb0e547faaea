"""Per-resource ACL verification.

Faithful re-implementation of the reference semantics
(reference: src/core/verifyACL.ts:11-251), including its quirks:

- a rule subject carrying the skipACL attribute passes immediately (:21-24);
- the *first* request resource whose context resource carries no ACL metadata
  makes the whole check pass (:56-59);
- for ``create`` actions every target ACL instance must lie inside the
  subject's HR org scopes for a shared role; ``user.User`` scoping entities
  are exempt (:148-205);
- for ``read``/``modify``/``delete`` at least one subject scope instance (or
  the subject id itself for user-entity ACLs) must appear in the ACL
  (:207-248);
- any other action falls through to a failing result (:250).
"""

from __future__ import annotations

from typing import Optional

from ..models.model import Request, Target
from .common import find_ctx_resource as _find_ctx_resource
from .common import get_field as _get
from .errors import InvalidRequestContext


def verify_acl_list(
    rule_target: Target,
    request: Request,
    urns,
    access_controller,
    logger=None,
) -> bool:
    scoped_roles: list[str] = []
    for attr in (rule_target.subjects or []):
        if attr.id == urns.get("role"):
            scoped_roles.append(attr.value)
        elif attr.id == urns.get("skipACL"):
            return True  # skipACL attribute set on rule

    context = request.context
    if not context:
        context = {}

    ctx_resources = _get(context, "resources") or []
    req_target = request.target

    # collect scoping-entity -> ACL instances from targeted resources
    target_scope_ent_instances: dict[str, list[str]] = {}
    for req_attribute in (req_target.resources or []):
        if req_attribute.id == urns.get("resourceID") or req_attribute.id == urns.get(
            "operation"
        ):
            instance_id = req_attribute.value
            ctx_resource = _find_ctx_resource(ctx_resources, instance_id)
            acl_list = None
            if ctx_resource is not None:
                meta = _get(ctx_resource, "meta")
                acls = _get(meta, "acls") if meta else None
                if acls and len(acls) > 0:
                    acl_list = acls

            if not acl_list:
                return True  # no ACL meta data set, no verification needed

            for acl in acl_list:
                if _get(acl, "id") == urns.get("aclIndicatoryEntity"):
                    scoping_entity = _get(acl, "value")
                    target_scope_ent_instances.setdefault(scoping_entity, [])
                    acl_attrs = _get(acl, "attributes")
                    if not acl_attrs:
                        return False  # missing ACL instances
                    for attribute in acl_attrs:
                        if _get(attribute, "id") == urns.get("aclInstance"):
                            target_scope_ent_instances[scoping_entity].append(
                                _get(attribute, "value")
                            )
                        else:
                            return False  # missing ACL instance value
                else:
                    return False  # missing ACL indicatory entity

    subject = _get(context, "subject")
    if subject is not None and _get(subject, "token") and not _get(
        subject, "hierarchical_scopes"
    ):
        context = access_controller.create_hr_scope(context)
        subject = _get(context, "subject")

    if subject is None:
        # quirk-faithful: the reference dereferences
        # context.subject.role_associations without a guard
        # (verifyACL.ts:112) — a missing subject THROWS, and the service
        # envelope turns it into DENY, not a silent rule skip
        raise InvalidRequestContext(
            "cannot read role_associations: request context has no subject"
        )
    role_associations = _get(subject, "role_associations")
    if not role_associations:
        return False  # impossible to evaluate context

    # collect subject's scoping-entity -> role-scope instances for rule roles
    subject_scoped_entity_instances: dict[str, list[str]] = {}
    target_scoping_entities = list(target_scope_ent_instances.keys())
    for role_assoc in role_associations:
        role = _get(role_assoc, "role")
        attributes = _get(role_assoc, "attributes") or []
        if role in scoped_roles:
            for role_attr in attributes:
                if (
                    _get(role_attr, "id") == urns.get("roleScopingEntity")
                    and _get(role_attr, "value") in target_scoping_entities
                ):
                    role_scoping_entity = _get(role_attr, "value")
                    subject_scoped_entity_instances.setdefault(role_scoping_entity, [])
                    nested = _get(role_attr, "attributes") or []
                    for role_inst in nested:
                        if _get(role_inst, "id") == urns.get("roleScopingInstance"):
                            subject_scoped_entity_instances[role_scoping_entity].append(
                                _get(role_inst, "value")
                            )

    action_obj = req_target.actions

    # role -> flattened eligible org scopes from the HR tree
    role_with_org_scopes: dict[Optional[str], list[str]] = {}

    def get_role_org_mapping(nodes, role=None):
        for hr_obj in nodes:
            role_map_key = _get(hr_obj, "role")
            if role_map_key is None:
                role_map_key = role
            hr_id = _get(hr_obj, "id")
            if hr_id:
                role_with_org_scopes.setdefault(role_map_key, []).append(hr_id)
            children = _get(hr_obj, "children") or []
            if len(children) > 0:
                get_role_org_mapping(children, role_map_key)

    hierarchical_scopes = _get(subject, "hierarchical_scopes")
    if hierarchical_scopes is None:
        # the reference iterates an undefined list and throws; surface the
        # same failure as a typed error the service layer denies on
        raise InvalidRequestContext("subject.hierarchical_scopes missing")
    get_role_org_mapping(hierarchical_scopes)

    action_id_urn = urns.get("actionID")
    first_action = action_obj[0] if action_obj else None

    if (
        first_action is not None
        and first_action.id == action_id_urn
        and first_action.value == urns.get("create")
    ):
        valid_target_instances = False
        if not target_scoping_entities:
            return True  # no ACL data in meta, no check done
        for scoping_entity in target_scoping_entities:
            if scoping_entity == urns.get("user"):
                # ACL indicatory entity is the subject entity: exempt
                valid_target_instances = True
                continue
            target_instances = target_scope_ent_instances.get(scoping_entity)
            subject_instances = subject_scoped_entity_instances.get(scoping_entity)
            if subject_instances is None:
                return False  # impossible to evaluate context

            validated_acl_instances: list[str] = []
            hr_scoped_roles = list(role_with_org_scopes.keys())
            for role in hr_scoped_roles:
                if role in scoped_roles:
                    eligible_org_scopes = role_with_org_scopes.get(role) or []
                    for target_instance in target_instances:
                        if target_instance in eligible_org_scopes:
                            valid_target_instances = True
                            validated_acl_instances.append(target_instance)
                            continue
                        elif target_instance not in validated_acl_instances:
                            valid_target_instances = False
                            break
            if not valid_target_instances:
                return False
        if valid_target_instances:
            return True

    if (
        first_action is not None
        and first_action.id == action_id_urn
        and first_action.value
        in (urns.get("read"), urns.get("modify"), urns.get("delete"))
    ):
        valid_subject_instance = False
        if not target_scoping_entities:
            return True  # no ACL data in meta, no check done
        for scoping_entity in target_scoping_entities:
            target_instances = target_scope_ent_instances.get(scoping_entity) or []
            subject_instances = subject_scoped_entity_instances.get(scoping_entity)

            if scoping_entity == urns.get("user"):
                if _get(subject, "id") in target_instances:
                    valid_subject_instance = True
                    break

            if subject_instances and len(subject_instances) > 0:
                for subject_instance in subject_instances:
                    if subject_instance in target_instances:
                        valid_subject_instance = True
                        break
        return valid_subject_instance

    return False
