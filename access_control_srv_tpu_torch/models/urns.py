"""URN vocabulary.

The engine is driven entirely by a configurable URN vocabulary
(reference: cfg/config.json `policies.options.urns` + `authorization.urns`,
consumed via `this.urns` in src/core/accessController.ts:64-67).  The
defaults below reproduce the reference vocabulary so fixture policies are
interoperable; deployments may override any entry.
"""

from __future__ import annotations

DEFAULT_URNS: dict[str, str] = {
    "entity": "urn:restorecommerce:acs:names:model:entity",
    "user": "urn:restorecommerce:acs:model:user.User",
    "model": "urn:restorecommerce:acs:model",
    "role": "urn:restorecommerce:acs:names:role",
    "roleScopingEntity": "urn:restorecommerce:acs:names:roleScopingEntity",
    "roleScopingInstance": "urn:restorecommerce:acs:names:roleScopingInstance",
    "hierarchicalRoleScoping": "urn:restorecommerce:acs:names:hierarchicalRoleScoping",
    "unauthenticated_user": "urn:restorecommerce:acs:names:unauthenticated-user",
    "property": "urn:restorecommerce:acs:names:model:property",
    "ownerEntity": "urn:restorecommerce:acs:names:ownerIndicatoryEntity",
    "ownerIndicatoryEntity": "urn:restorecommerce:acs:names:ownerIndicatoryEntity",
    "ownerInstance": "urn:restorecommerce:acs:names:ownerInstance",
    "orgScope": "urn:restorecommerce:acs:model:organization.Organization",
    "subjectID": "urn:oasis:names:tc:xacml:1.0:subject:subject-id",
    "resourceID": "urn:oasis:names:tc:xacml:1.0:resource:resource-id",
    "actionID": "urn:oasis:names:tc:xacml:1.0:action:action-id",
    "action": "urn:restorecommerce:acs:names:action",
    "operation": "urn:restorecommerce:acs:names:operation",
    "execute": "urn:restorecommerce:acs:names:action:execute",
    "create": "urn:restorecommerce:acs:names:action:create",
    "read": "urn:restorecommerce:acs:names:action:read",
    "modify": "urn:restorecommerce:acs:names:action:modify",
    "delete": "urn:restorecommerce:acs:names:action:delete",
    "organization": "urn:restorecommerce:acs:model:organization.Organization",
    "relation": "urn:restorecommerce:acs:names:relation",
    "aclIndicatoryEntity": "urn:restorecommerce:acs:names:aclIndicatoryEntity",
    "aclInstance": "urn:restorecommerce:acs:names:aclInstance",
    "skipACL": "urn:restorecommerce:acs:names:skipACL",
    "maskedProperty": "urn:restorecommerce:acs:names:obligation:maskedProperty",
    "permitOverrides": "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:permit-overrides",
    "denyOverrides": "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:deny-overrides",
    "firstApplicable": "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:first-applicable",
}


class Urns:
    """Mapping of symbolic names -> URNs with reference defaults."""

    def __init__(self, overrides: dict[str, str] | None = None):
        self._map = dict(DEFAULT_URNS)
        if overrides:
            self._map.update(overrides)

    def get(self, name: str) -> str | None:
        return self._map.get(name)

    def __getitem__(self, name: str) -> str:
        return self._map[name]

    def as_dict(self) -> dict[str, str]:
        return dict(self._map)
