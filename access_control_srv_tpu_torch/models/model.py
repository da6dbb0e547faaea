"""Core data model for the ABAC framework.

The model mirrors the *shape* of the reference's protobuf messages
(reference: src/core/interfaces.ts and the @restorecommerce proto types used
throughout src/core/accessController.ts) but is a fresh, framework-native
design: plain dataclasses with insertion-ordered dict children, since
insertion order is normative for the ``first-applicable`` combining
algorithm (reference: src/core/accessController.ts:891-893 with Map
iteration order).

Request ``context`` is JSON-like (nested dicts/lists), matching the
protobuf-Any unmarshalled wire format the reference receives
(reference: src/accessControlService.ts:103-125).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


class Effect:
    """String-valued effect constants (the reference uses ts-proto string
    enums; YAML carries 'PERMIT' / 'DENY' literals)."""

    PERMIT = "PERMIT"
    DENY = "DENY"


class Decision:
    """isAllowed decision values (reference Response_Decision)."""

    PERMIT = "PERMIT"
    DENY = "DENY"
    INDETERMINATE = "INDETERMINATE"

    @staticmethod
    def from_effect(effect: Optional[str]) -> str:
        # Reference: `Response_Decision[effect.effect] || INDETERMINATE`
        # (src/core/accessController.ts:312) -- unknown/absent effects fold
        # to INDETERMINATE.
        if effect in (Decision.PERMIT, Decision.DENY):
            return effect
        return Decision.INDETERMINATE


@dataclass
class Attribute:
    """A (urn-id, value) pair with optional nested attributes.

    Used uniformly for target subjects/resources/actions, role-association
    scoping attributes, resource owners and ACL entries (reference:
    io/restorecommerce/attribute.proto usage across src/core)."""

    id: str = ""
    value: str = ""
    attributes: list["Attribute"] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "value": self.value,
            "attributes": [a.to_dict() for a in self.attributes],
        }


def _coerce_scalar(value: Any) -> str:
    """Attribute ids/values are strings on the wire; YAML authors may write
    bare scalars (``value: true`` / ``value: 42``) which safe_load turns
    into Python types — normalize them back to their YAML spelling."""
    if value is None:
        return ""
    if isinstance(value, bool):
        return "true" if value else "false"
    return value if isinstance(value, str) else str(value)


def attribute(obj: Any) -> Attribute:
    """Coerce a dict (or Attribute) into an Attribute."""
    if isinstance(obj, Attribute):
        return obj
    if obj is None:
        return Attribute()
    return Attribute(
        id=_coerce_scalar(obj.get("id")),
        value=_coerce_scalar(obj.get("value")),
        attributes=[attribute(a) for a in (obj.get("attributes") or [])],
    )


def coerce_attributes(items: Any) -> list[Attribute]:
    return [attribute(i) for i in (items or [])]


@dataclass
class Target:
    """A rule/policy/policy-set target: three attribute lists.

    ``None`` targets (absent in YAML) are represented as ``None`` on the
    owning node, mirroring the reference's ``formatTarget`` returning null
    (reference: src/core/utils.ts:35-45)."""

    subjects: list[Attribute] = field(default_factory=list)
    resources: list[Attribute] = field(default_factory=list)
    actions: list[Attribute] = field(default_factory=list)


def coerce_target(obj: Any) -> Optional[Target]:
    if obj is None:
        return None
    if isinstance(obj, Target):
        return obj
    return Target(
        subjects=coerce_attributes(obj.get("subjects")),
        resources=coerce_attributes(obj.get("resources")),
        actions=coerce_attributes(obj.get("actions")),
    )


@dataclass
class ContextQuery:
    """A context query a rule may carry (reference: rule.proto ContextQuery);
    resolved by a resource adapter before condition evaluation."""

    filters: list[dict] = field(default_factory=list)
    query: str = ""


@dataclass
class Rule:
    id: str = ""
    name: str = ""
    description: str = ""
    target: Optional[Target] = None
    effect: Optional[str] = None
    condition: str = ""
    context_query: Optional[ContextQuery] = None
    evaluation_cacheable: bool = False
    meta: Optional[dict] = None


@dataclass
class Policy:
    id: str = ""
    name: str = ""
    description: str = ""
    target: Optional[Target] = None
    effect: Optional[str] = None
    combining_algorithm: str = ""
    # insertion-ordered children; order is normative for first-applicable
    combinables: dict[str, Optional[Rule]] = field(default_factory=dict)
    evaluation_cacheable: bool = False
    meta: Optional[dict] = None


@dataclass
class PolicySet:
    id: str = ""
    name: str = ""
    description: str = ""
    target: Optional[Target] = None
    combining_algorithm: str = ""
    combinables: dict[str, Optional[Policy]] = field(default_factory=dict)
    meta: Optional[dict] = None


@dataclass
class Request:
    """An access request: a target plus a JSON-like context.

    context shape (reference: test/utils.ts buildRequest + the protobuf-Any
    unmarshalling in src/accessControlService.ts:103-125)::

        {
          "subject": {"id": ..., "token": ..., "role_associations": [...],
                       "hierarchical_scopes": [...]},
          "resources": [{"id": ..., "meta": {"owners": [...], "acls": [...]}}],
          "security": {...},
        }
    """

    target: Optional[Target] = None
    context: Optional[dict] = None


@dataclass
class EffectEvaluation:
    """A collected effect + cacheability marker
    (reference: src/core/interfaces.ts EffectEvaluation).

    ``source`` carries the id of the rule (or no-rules policy) that
    produced the effect; the combining algorithms propagate the winning
    evaluation's source so the decision-audit log can name the deciding
    rule on the host path.  It never influences the decision itself."""

    effect: Optional[str] = None
    evaluation_cacheable: Optional[bool] = None
    source: Optional[str] = None


@dataclass
class OperationStatus:
    code: int = 200
    message: str = "success"


@dataclass
class Response:
    """isAllowed response (reference: access_control.proto Response)."""

    decision: str = Decision.INDETERMINATE
    obligations: list[Attribute] = field(default_factory=list)
    evaluation_cacheable: Optional[bool] = None
    operation_status: OperationStatus = field(default_factory=OperationStatus)


@dataclass
class RuleRQ:
    id: str = ""
    target: Optional[Target] = None
    effect: Optional[str] = None
    condition: str = ""
    context_query: Optional[ContextQuery] = None
    evaluation_cacheable: bool = False


@dataclass
class PolicyRQ:
    id: str = ""
    target: Optional[Target] = None
    effect: Optional[str] = None
    combining_algorithm: str = ""
    evaluation_cacheable: bool = False
    has_rules: bool = False
    rules: list[RuleRQ] = field(default_factory=list)


@dataclass
class PolicySetRQ:
    id: str = ""
    target: Optional[Target] = None
    effect: Optional[str] = None
    combining_algorithm: str = ""
    policies: list[PolicyRQ] = field(default_factory=list)


@dataclass
class ReverseQuery:
    """whatIsAllowed response: the applicable policy tree + masking
    obligations (reference: src/core/accessController.ts:326-427)."""

    policy_sets: list[PolicySetRQ] = field(default_factory=list)
    obligations: list[Attribute] = field(default_factory=list)
    operation_status: OperationStatus = field(default_factory=OperationStatus)
