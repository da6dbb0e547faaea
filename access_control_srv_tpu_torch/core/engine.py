"""The scalar policy-decision engine (the normative oracle).

A fresh Python implementation of the reference decision semantics
(reference: src/core/accessController.ts).  This engine is the source of
truth the device evaluator is differentially tested against, and the fallback
path for requests outside the tensor kernel's representable subset.

Reference quirks deliberately preserved (each is load-bearing for
bit-identical decisions):

- ``policyEffect`` is only ever derived from ``policy.effect`` and *carries
  over* across the policy loop; the combining-algorithm branch in the
  reference compares a function against a string and never fires
  (reference: accessController.ts:141-148 — dead code).
- ``targetMatches`` defaults an absent effect to PERMIT, but the *direct*
  ``resourceAttributesMatch`` call in the multi-entity recheck passes the
  raw (possibly absent) effect through (reference: :451 vs :663).
- the final decision comes from the *last* policy set that produced any
  effects (``effect`` is overwritten per set, reference: :293-295).
- policy-level subject HR-scope matching gates only rule effects, not the
  no-rules policy-effect shortcut (reference: :188-200).
- ``evaluation_cacheable`` uses prefix semantics: once a non-cacheable rule
  is seen in a policy, every later collected rule effect in that policy is
  marked non-cacheable (reference: :202-211, 277-282).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Optional

from ..models.model import (
    Attribute,
    Decision,
    Effect,
    EffectEvaluation,
    OperationStatus,
    Policy,
    PolicyRQ,
    PolicySet,
    PolicySetRQ,
    Request,
    Response,
    ReverseQuery,
    Rule,
    RuleRQ,
    Target,
)
from ..models.urns import Urns
from . import errors
from .common import get_field as _get
from .conditions import condition_matches
from .hierarchical_scope import (
    check_hierarchical_scope,
    regex_entity_compare,
    split_entity_urn,
)
from .relation_path import check_target_relations
from .verify_acl import verify_acl_list

DEFAULT_COMBINING_ALGORITHMS = [
    {
        "urn": "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:deny-overrides",
        "method": "deny_overrides",
    },
    {
        "urn": "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:permit-overrides",
        "method": "permit_overrides",
    },
    {
        "urn": "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:first-applicable",
        "method": "first_applicable",
    },
]

_METHOD_ALIASES = {
    "denyOverrides": "deny_overrides",
    "permitOverrides": "permit_overrides",
    "firstApplicable": "first_applicable",
}


def apply_resolved_subject(subject, payload) -> None:
    """Graft a resolved identity payload onto a token-bearing subject —
    the exact field set the reference copies (accessController.ts:110-117).
    Shared by the per-request resolution above and the batched host
    pipeline (srv/evaluator.HybridEvaluator.prepare_batch)."""
    subject["id"] = _get(payload, "id")
    subject["tokens"] = _get(payload, "tokens")
    subject["role_associations"] = _get(payload, "role_associations")




class AccessController:
    """PDP engine: policy-set tree + isAllowed / whatIsAllowed evaluation
    (reference: src/core/accessController.ts:31-966)."""

    def __init__(
        self,
        urns: Urns | dict | None = None,
        combining_algorithms: list[dict] | None = None,
        logger=None,
        identity_client=None,
        hr_scope_provider=None,
        resource_adapter=None,
    ):
        self.logger = logger
        self.urns = urns if isinstance(urns, Urns) else Urns(urns)
        self.policy_sets: dict[str, PolicySet] = {}
        self.identity_client = identity_client
        self.hr_scope_provider = hr_scope_provider
        self.resource_adapter = resource_adapter
        # Zanzibar-style tuple store (srv/relations.RelationTupleStore);
        # None means no ReBAC workload — relation-bearing targets then
        # fail closed, matching the kernel's empty-table planes.
        self.relation_store = None

        self.combining_algorithms: dict[str, Callable] = {}
        for ca in combining_algorithms or DEFAULT_COMBINING_ALGORITHMS:
            method_name = _METHOD_ALIASES.get(ca["method"], ca["method"])
            method = getattr(self, method_name, None)
            if method is None:
                raise errors.InvalidCombiningAlgorithm(ca["urn"])
            self.combining_algorithms[ca["urn"]] = method

    # ------------------------------------------------------------------ PDP

    def clear_policies(self) -> None:
        self.policy_sets = {}

    def _relation_graph(self):
        """The live tuple graph, or None (fail-closed) when no store is
        attached."""
        store = self.relation_store
        return store.graph if store is not None else None

    def replace_policy_sets(self, policy_sets: dict[str, "PolicySet"]) -> None:
        """Swap the whole tree atomically (single reference assignment):
        serving threads mid-iteration finish on the old snapshot instead of
        racing an in-place clear+rebuild."""
        self.policy_sets = policy_sets

    def prepare_context(self, request: Request) -> None:
        """Resolve a token subject and its hierarchical scopes host-side.
        Idempotent; called from is_allowed/what_is_allowed, and by the
        serving shell BEFORE a request enters the micro-batcher so the
        collector thread never blocks on the HR-scope rendezvous
        (reference: accessController.ts:110-123).  Attempted at most once
        per request: a timed-out rendezvous must not re-block a later
        evaluation of the same request on another thread."""
        if getattr(request, "_context_prepared", False):
            return
        request._context_prepared = True
        context = request.context or {}
        if _get(_get(context, "subject"), "token"):
            request._token_resolved = self._resolve_subject(context)
            if not _get(_get(context, "subject"), "hierarchical_scopes"):
                context = self.create_hr_scope(context)
            request.context = context

    def _resolve_subject(self, context) -> bool:
        """Token -> subject resolution via the identity client, mutating the
        subject in place (reference: accessController.ts:110-117).  Returns
        whether a payload was applied — the encoder keeps resolved
        token-bearing rows kernel-eligible (``request._token_resolved``)
        and degrades unresolved ones to the oracle exactly as before."""
        subject = _get(context, "subject")
        token = _get(subject, "token")
        if token and self.identity_client is not None:
            resolved = self.identity_client.find_by_token(token)
            payload = _get(resolved, "payload")
            if payload:
                apply_resolved_subject(subject, payload)
                return True
        return False

    def create_hr_scope(self, context):
        """Resolve hierarchical scopes for a token-bearing subject via the
        injected provider (cache + request/response rendezvous in the
        serving shell; reference: accessController.ts:735-783)."""
        if self.hr_scope_provider is not None:
            return self.hr_scope_provider.create_hr_scope(context)
        return context

    def is_allowed(self, request: Request,
                   candidate_rules=None) -> Response:
        """Evaluate an access request (reference: accessController.ts:88-324).

        ``candidate_rules``: optional set of rule object ids (from
        core.candidate_index.CandidateIndex) — targeted rules outside it
        provably cannot target-match and are skipped without evaluation.
        Skipping happens AFTER the per-rule evaluation_cacheable
        aggregation (the reference clears the policy-level cacheable flag
        for every non-cacheable rule, matched or not — :207-210), so
        filtered decisions are bit-identical to the full walk."""
        if not request.target:
            return Response(
                decision=Decision.DENY,
                evaluation_cacheable=False,
                obligations=[],
                operation_status=OperationStatus(
                    code=400,
                    message="Access request had no target. Skipping request",
                ),
            )

        effect: Optional[EffectEvaluation] = None
        obligations: list[Attribute] = []
        self.prepare_context(request)
        context = request.context or {}

        entity_urn = self.urns.get("entity")

        for policy_set in self.policy_sets.values():
            policy_effects: list[EffectEvaluation] = []
            policy_effect: Optional[str] = None  # carries over across policies

            if not policy_set.target or self._target_matches(
                policy_set.target, request, "isAllowed", obligations
            ):
                exact_match = False
                for policy in policy_set.combinables.values():
                    if policy is None:
                        continue
                    if policy.effect:
                        policy_effect = policy.effect
                    if policy.target and self._target_matches(
                        policy.target, request, "isAllowed", obligations, policy_effect
                    ):
                        exact_match = True
                        break

                req_entity_count = len(
                    [
                        a
                        for a in (request.target.resources or [])
                        if a and a.id == entity_urn
                    ]
                )
                if exact_match and req_entity_count > 1:
                    exact_match = self._check_multiple_entities_match(
                        policy_set, request, obligations
                    )

                for policy in policy_set.combinables.values():
                    if policy is None:
                        continue
                    rule_effects: list[EffectEvaluation] = []
                    if (
                        not policy.target
                        or (
                            exact_match
                            and self._target_matches(
                                policy.target,
                                request,
                                "isAllowed",
                                obligations,
                                policy_effect,
                            )
                        )
                        or (
                            not exact_match
                            and self._target_matches(
                                policy.target,
                                request,
                                "isAllowed",
                                obligations,
                                policy_effect,
                                True,
                            )
                        )
                    ):
                        rules = policy.combinables
                        if policy.target and policy.target.subjects:
                            policy_subject_match = check_hierarchical_scope(
                                policy.target, request, self.urns, self, self.logger
                            ) and check_target_relations(
                                policy.target, request,
                                self._relation_graph(), self.urns,
                            )
                        else:
                            policy_subject_match = True

                        if len(rules) == 0 and policy.effect:
                            policy_effects.append(
                                EffectEvaluation(
                                    effect=policy.effect,
                                    evaluation_cacheable=policy.evaluation_cacheable,
                                    source=policy.id,
                                )
                            )
                        else:
                            evaluation_cacheable_rule = True
                            for rule in rules.values():
                                if rule is None:
                                    continue
                                evaluation_cacheable = rule.evaluation_cacheable
                                if not evaluation_cacheable:
                                    evaluation_cacheable_rule = False
                                if (
                                    candidate_rules is not None
                                    and rule.target is not None
                                    and id(rule) not in candidate_rules
                                ):
                                    continue  # provably cannot target-match

                                matches = not rule.target or self._target_matches(
                                    rule.target,
                                    request,
                                    "isAllowed",
                                    obligations,
                                    rule.effect,
                                )
                                if not matches:
                                    matches = self._target_matches(
                                        rule.target,
                                        request,
                                        "isAllowed",
                                        obligations,
                                        rule.effect,
                                        True,
                                    )

                                if matches:
                                    if rule.target:
                                        matches = check_hierarchical_scope(
                                            rule.target,
                                            request,
                                            self.urns,
                                            self,
                                            self.logger,
                                        ) and check_target_relations(
                                            rule.target,
                                            request,
                                            self._relation_graph(),
                                            self.urns,
                                        )
                                    try:
                                        if matches and rule.condition:
                                            pulled = None
                                            cq = rule.context_query
                                            if self.resource_adapter is not None and cq and (
                                                (cq.filters and len(cq.filters))
                                                or (cq.query and len(cq.query))
                                            ):
                                                # always a merged object, even
                                                # for empty adapter results —
                                                # the reference's nil-check deny
                                                # branch (:240-251) is dead code
                                                # because merge() never yields
                                                # nil (:959-965); adapter errors
                                                # surface as exceptions below
                                                pulled = self.pull_context_resources(
                                                    cq, request
                                                )
                                            if pulled is not None:
                                                request.context = pulled
                                            matches = condition_matches(
                                                rule.condition, request
                                            )
                                    except Exception as err:
                                        code = getattr(err, "code", 500)
                                        if not isinstance(code, int):
                                            code = 500
                                        return Response(
                                            decision=Decision.DENY,
                                            obligations=obligations,
                                            evaluation_cacheable=evaluation_cacheable,
                                            operation_status=OperationStatus(
                                                code=code,
                                                message=str(err) or "Unknown Error!",
                                            ),
                                        )

                                    if matches and rule.target:
                                        matches = verify_acl_list(
                                            rule.target,
                                            request,
                                            self.urns,
                                            self,
                                            self.logger,
                                        )

                                    if matches and policy_subject_match:
                                        if not evaluation_cacheable_rule:
                                            evaluation_cacheable = (
                                                evaluation_cacheable_rule
                                            )
                                        rule_effects.append(
                                            EffectEvaluation(
                                                effect=rule.effect,
                                                evaluation_cacheable=evaluation_cacheable,
                                                source=rule.id,
                                            )
                                        )

                            if len(rule_effects) > 0:
                                policy_effects.append(
                                    self.decide(policy.combining_algorithm, rule_effects)
                                )

                if len(policy_effects) > 0:
                    effect = self.decide(policy_set.combining_algorithm, policy_effects)

        if effect is None:
            return Response(
                decision=Decision.INDETERMINATE,
                obligations=obligations,
                evaluation_cacheable=None,
                operation_status=OperationStatus(),
            )

        response = Response(
            decision=Decision.from_effect(effect.effect),
            obligations=obligations,
            evaluation_cacheable=effect.evaluation_cacheable,
            operation_status=OperationStatus(),
        )
        # deciding-rule provenance for the decision-audit log (an
        # out-of-band attribute, never serialized to the wire)
        response._rule_id = effect.source
        return response

    def what_is_allowed(self, request: Request) -> ReverseQuery:
        """Reverse query: applicable policy tree + masking obligations
        (reference: accessController.ts:326-427)."""
        policy_sets_rq: list[PolicySetRQ] = []
        obligations: list[Attribute] = []
        self.prepare_context(request)
        context = request.context or {}

        entity_urn = self.urns.get("entity")

        for policy_set in self.policy_sets.values():
            if policy_set.target is None or self._target_matches(
                policy_set.target, request, "whatIsAllowed", obligations
            ):
                pset = PolicySetRQ(
                    id=policy_set.id,
                    target=policy_set.target,
                    combining_algorithm=policy_set.combining_algorithm,
                )

                exact_match = False
                policy_effect: Optional[str] = None
                for policy in policy_set.combinables.values():
                    if policy is None:
                        continue
                    if policy.effect:
                        policy_effect = policy.effect
                    if policy.target and self._target_matches(
                        policy.target,
                        request,
                        "whatIsAllowed",
                        obligations,
                        policy_effect,
                    ):
                        exact_match = True
                        break

                req_entity_count = len(
                    [
                        a
                        for a in (request.target.resources or [])
                        if a and a.id == entity_urn
                    ]
                )
                if exact_match and req_entity_count > 1:
                    exact_match = self._check_multiple_entities_match(
                        policy_set, request, obligations
                    )

                for policy in policy_set.combinables.values():
                    if policy is None:
                        continue
                    if (
                        policy.target is None
                        or (
                            exact_match
                            and self._target_matches(
                                policy.target,
                                request,
                                "whatIsAllowed",
                                obligations,
                                policy_effect,
                            )
                        )
                        or (
                            not exact_match
                            and self._target_matches(
                                policy.target,
                                request,
                                "whatIsAllowed",
                                obligations,
                                policy_effect,
                                True,
                            )
                        )
                    ):
                        policy_rq = PolicyRQ(
                            id=policy.id,
                            target=policy.target,
                            effect=policy.effect,
                            evaluation_cacheable=policy.evaluation_cacheable,
                            combining_algorithm=policy.combining_algorithm,
                            has_rules=bool(policy.combinables),
                        )
                        for rule in policy.combinables.values():
                            if rule is None:
                                continue
                            matches = rule.target is None or self._target_matches(
                                rule.target,
                                request,
                                "whatIsAllowed",
                                obligations,
                                rule.effect,
                            )
                            if not matches:
                                matches = self._target_matches(
                                    rule.target,
                                    request,
                                    "whatIsAllowed",
                                    obligations,
                                    rule.effect,
                                    True,
                                )
                            if rule.target is None or matches:
                                policy_rq.rules.append(
                                    RuleRQ(
                                        id=rule.id,
                                        target=rule.target,
                                        effect=rule.effect,
                                        condition=rule.condition,
                                        context_query=rule.context_query,
                                        evaluation_cacheable=rule.evaluation_cacheable,
                                    )
                                )
                        if policy_rq.effect or (
                            not policy_rq.effect and policy_rq.rules
                        ):
                            pset.policies.append(policy_rq)

                if pset.policies:
                    policy_sets_rq.append(pset)

        return ReverseQuery(
            policy_sets=policy_sets_rq,
            obligations=obligations,
            operation_status=OperationStatus(),
        )

    # ------------------------------------------------------------- matchers

    def _check_multiple_entities_match(
        self, policy_set: PolicySet, request: Request, obligation: list[Attribute]
    ) -> bool:
        """Every requested entity must exactly match some policy's resources
        (reference: accessController.ts:429-463)."""
        entity_urn = self.urns.get("entity")
        for request_attribute in (request.target.resources or []):
            if request_attribute.id != entity_urn:
                continue
            multiple_entities_match = False
            for policy in policy_set.combinables.values():
                if policy is None:
                    continue
                policy_effect = policy.effect if policy.effect else None
                resources = policy.target.resources if policy.target else None
                if resources and len(resources) > 0:
                    # direct call: absent effect stays absent (no PERMIT
                    # default here, unlike _target_matches; ref :451)
                    if self._resource_attributes_match(
                        resources,
                        [request_attribute],
                        "isAllowed",
                        obligation,
                        policy_effect,
                    ):
                        multiple_entities_match = True
            if not multiple_entities_match:
                return False
        return True

    def _target_matches(
        self,
        rule_target: Target,
        request: Request,
        operation: str = "isAllowed",
        mask_property_list: Optional[list[Attribute]] = None,
        effect: Optional[str] = None,
        regex_match: bool = False,
    ) -> bool:
        """Subjects AND actions AND resources
        (reference: accessController.ts:661-672)."""
        if effect is None:
            effect = Effect.PERMIT  # TS default-parameter semantics
        request_target = request.target
        sub_match = self._check_subject_matches(
            rule_target.subjects, request_target.subjects, request
        )
        if not (
            sub_match
            and self._attributes_match(rule_target.actions, request_target.actions)
        ):
            return False
        return self._resource_attributes_match(
            rule_target.resources,
            request_target.resources,
            operation,
            mask_property_list,
            effect,
            regex_match,
        )

    def _attributes_match(
        self,
        rule_attributes: Optional[list[Attribute]],
        request_attributes: Optional[list[Attribute]],
    ) -> bool:
        """Every rule attribute must have an exact id+value match in the
        request (reference: accessController.ts:681-699)."""
        for attribute in rule_attributes or []:
            if not any(
                req is not None
                and req.id == attribute.id
                and req.value == attribute.value
                for req in (request_attributes or [])
            ):
                return False
        return True

    def _check_subject_matches(
        self,
        rule_sub_attributes: Optional[list[Attribute]],
        request_sub_attributes: Optional[list[Attribute]],
        request: Request,
    ) -> bool:
        """Role-based or user-targeted subject matching
        (reference: accessController.ts:793-823)."""
        context = request.context
        role_urn = self.urns.get("role")
        relation_urn = self.urns.get("relation")
        # relation-path attributes are matched by the tuple-store gate
        # (check_target_relations), never by id+value equality against the
        # request — a target whose subjects are ALL relation paths is
        # user-unconstrained here
        rule_sub_attributes = [
            a for a in (rule_sub_attributes or [])
            if a is None or a.id != relation_urn
        ]
        if not rule_sub_attributes or len(rule_sub_attributes) == 0:
            return True
        rule_role = None
        for subject_attr in rule_sub_attributes:
            if subject_attr is not None and subject_attr.id == role_urn:
                rule_role = subject_attr.value

        if not rule_role and self._attributes_match(
            rule_sub_attributes, request_sub_attributes
        ):
            return True  # rule subject targeted to specific user
        if not rule_role:
            return False
        role_associations = _get(_get(context, "subject"), "role_associations")
        if not role_associations:
            return False
        return any(_get(ra, "role") == rule_role for ra in role_associations)

    def _resource_attributes_match(
        self,
        rule_attributes: Optional[list[Attribute]],
        request_attributes: Optional[list[Attribute]],
        operation: str,
        mask_property_list: Optional[list[Attribute]],
        effect: Optional[str],
        regex_match: bool = False,
    ) -> bool:
        """The property/entity/operation matcher, including regex entity
        matching with namespace comparison and property-masking obligation
        accumulation (reference: accessController.ts:465-654).

        This is a deliberately literal port: the flag updates are stateful
        across the request-attribute loop and asymmetric between operations
        and effects; see the reference lines cited inline."""
        entity_urn = self.urns.get("entity")
        property_urn = self.urns.get("property")
        masked_property_urn = self.urns.get("maskedProperty")
        operation_urn = self.urns.get("operation")

        entity_match = False
        property_match = False
        rule_properties_exist = False
        request_properties_exist = False
        operation_match = False
        request_entity_urn = ""
        skip_deny_rule = True
        rule_property_value = ""

        if not rule_attributes or len(rule_attributes) == 0:
            return True
        if mask_property_list is None:
            mask_property_list = []

        for req_attr in request_attributes or []:
            if req_attr is not None and req_attr.id == property_urn:
                request_properties_exist = True

        for request_attribute in request_attributes or []:
            property_match = False
            for rule_attribute in rule_attributes or []:
                if rule_attribute.id == property_urn:
                    rule_properties_exist = True
                    rule_property_value = rule_attribute.value

                if not regex_match:
                    if (
                        request_attribute.id == entity_urn
                        and rule_attribute.id == entity_urn
                        and request_attribute.value == rule_attribute.value
                    ):
                        entity_match = True
                        request_entity_urn = request_attribute.value
                    elif (
                        request_attribute.id == operation_urn
                        and rule_attribute.id == operation_urn
                        and request_attribute.value == rule_attribute.value
                    ):
                        operation_match = True
                    elif (
                        entity_match
                        and request_attribute.id == property_urn
                        and rule_attribute.id == property_urn
                    ):
                        # does the request property belong to the matched
                        # entity?  (ref :509-525)
                        entity_name = (request_entity_urn or "").rsplit(":", 1)[-1]
                        if entity_name in (request_attribute.value or ""):
                            if rule_attribute.value == request_attribute.value:
                                property_match = True
                        elif effect == Effect.PERMIT:
                            # property of another entity: not this rule's
                            # concern for PERMIT rules
                            property_match = True
                else:
                    if (
                        request_attribute.id == entity_urn
                        and rule_attribute.id == entity_urn
                    ):
                        # regex entity matching with namespace verification
                        # (ref :526-566)
                        request_entity_urn = request_attribute.value or ""
                        set_flag, prefix_mismatch = regex_entity_compare(
                            rule_attribute.value, request_attribute.value
                        )
                        if prefix_mismatch:
                            entity_match = False
                        if set_flag:
                            entity_match = True
                    elif (
                        entity_match
                        and request_attribute.id == property_urn
                        and rule_attribute.id == property_urn
                    ):
                        rule_prop = (rule_attribute.value or "").rsplit("#", 1)[-1]
                        req_prop = (request_attribute.value or "").rsplit("#", 1)[-1]
                        if rule_prop == req_prop:
                            property_match = True

            is_prop_or_no_props = (
                request_attribute.id == property_urn or not request_properties_exist
            )

            # DENY rule applies only if some property matched (ref :578-581)
            if (
                operation == "isAllowed"
                and effect == Effect.DENY
                and is_prop_or_no_props
                and entity_match
                and rule_properties_exist
                and property_match
            ):
                skip_deny_rule = False

            # PERMIT rule with an unmatched request property: no match
            # (ref :585-588)
            if (
                operation == "isAllowed"
                and effect == Effect.PERMIT
                and is_prop_or_no_props
                and entity_match
                and rule_properties_exist
                and not property_match
            ):
                return False

            # whatIsAllowed PERMIT: extra requested properties get masked
            # (ref :592-615)
            if (
                operation == "whatIsAllowed"
                and effect == Effect.PERMIT
                and is_prop_or_no_props
                and entity_match
                and rule_properties_exist
                and not property_match
            ):
                if not request_properties_exist:
                    return False  # cannot evaluate what would be read
                mask_prop_exists = next(
                    (m for m in mask_property_list if m.value == request_entity_urn),
                    None,
                )
                mask_property = None
                if request_properties_exist and request_attribute.value:
                    mask_property = request_attribute.value
                elif not request_properties_exist:
                    mask_property = rule_property_value
                if mask_property is not None and "#" not in mask_property:
                    continue
                self._append_mask(
                    mask_property_list,
                    mask_prop_exists,
                    entity_urn,
                    request_entity_urn,
                    masked_property_urn,
                    mask_property,
                )

            # whatIsAllowed DENY: denied properties get masked (ref :620-640)
            if (
                operation == "whatIsAllowed"
                and effect == Effect.DENY
                and is_prop_or_no_props
                and entity_match
                and rule_properties_exist
                and (property_match or not request_properties_exist)
            ):
                mask_prop_exists = next(
                    (m for m in mask_property_list if m.value == request_entity_urn),
                    None,
                )
                mask_property = None
                if request_properties_exist and request_attribute.value:
                    mask_property = request_attribute.value
                elif not request_properties_exist:
                    mask_property = rule_property_value
                if mask_property is not None and "#" not in mask_property:
                    continue
                self._append_mask(
                    mask_property_list,
                    mask_prop_exists,
                    entity_urn,
                    request_entity_urn,
                    masked_property_urn,
                    mask_property,
                )

        # deny rule skipped when no property matched at all (ref :644-647)
        if (
            skip_deny_rule
            and rule_properties_exist
            and request_properties_exist
            and effect == Effect.DENY
            and operation == "isAllowed"
            and not property_match
        ):
            return False

        if not entity_match and not operation_match:
            return False
        return True

    @staticmethod
    def _append_mask(
        mask_property_list: list[Attribute],
        mask_prop_exists: Optional[Attribute],
        entity_urn: str,
        request_entity_urn: str,
        masked_property_urn: str,
        mask_property: Optional[str],
    ) -> None:
        masked = Attribute(
            id=masked_property_urn, value=mask_property or "", attributes=[]
        )
        if mask_prop_exists is None:
            mask_property_list.append(
                Attribute(
                    id=entity_urn, value=request_entity_urn, attributes=[masked]
                )
            )
        else:
            mask_prop_exists.attributes.append(masked)

    # ------------------------------------------------- combining algorithms

    def decide(
        self, combining_algorithm: str, effects: list[EffectEvaluation]
    ) -> EffectEvaluation:
        method = self.combining_algorithms.get(combining_algorithm)
        if method is None:
            raise errors.InvalidCombiningAlgorithm(combining_algorithm)
        return method(effects)

    @staticmethod
    def deny_overrides(effects: list[EffectEvaluation]) -> EffectEvaluation:
        """First DENY wins, else the last effect (reference: :846-862)."""
        effect = None
        evaluation_cacheable = None
        source = None
        for e in effects or []:
            effect = e.effect
            evaluation_cacheable = e.evaluation_cacheable
            source = e.source
            if e.effect == Effect.DENY:
                break
        return EffectEvaluation(effect=effect,
                                evaluation_cacheable=evaluation_cacheable,
                                source=source)

    @staticmethod
    def permit_overrides(effects: list[EffectEvaluation]) -> EffectEvaluation:
        """First PERMIT wins, else the last effect (reference: :868-884)."""
        effect = None
        evaluation_cacheable = None
        source = None
        for e in effects or []:
            effect = e.effect
            evaluation_cacheable = e.evaluation_cacheable
            source = e.source
            if e.effect == Effect.PERMIT:
                break
        return EffectEvaluation(effect=effect,
                                evaluation_cacheable=evaluation_cacheable,
                                source=source)

    @staticmethod
    def first_applicable(effects: list[EffectEvaluation]) -> EffectEvaluation:
        """The first collected effect wins (reference: :891-893)."""
        return effects[0]

    # ------------------------------------------------ in-memory tree ops

    def update_policy_set(self, policy_set: PolicySet) -> None:
        self.policy_sets[policy_set.id] = policy_set

    def remove_policy_set(self, policy_set_id: str) -> None:
        self.policy_sets.pop(policy_set_id, None)

    def update_policy(self, policy_set_id: str, policy: Policy) -> None:
        policy_set = self.policy_sets.get(policy_set_id)
        if policy_set is not None:
            policy_set.combinables[policy.id] = policy

    def remove_policy(self, policy_set_id: str, policy_id: str) -> None:
        policy_set = self.policy_sets.get(policy_set_id)
        if policy_set is not None:
            policy_set.combinables.pop(policy_id, None)

    def update_rule(self, policy_set_id: str, policy_id: str, rule: Rule) -> None:
        policy_set = self.policy_sets.get(policy_set_id)
        if policy_set is not None:
            policy = policy_set.combinables.get(policy_id)
            if policy is not None:
                policy.combinables[rule.id] = rule

    def remove_rule(self, policy_set_id: str, policy_id: str, rule_id: str) -> None:
        policy_set = self.policy_sets.get(policy_set_id)
        if policy_set is not None:
            policy = policy_set.combinables.get(policy_id)
            if policy is not None:
                policy.combinables.pop(rule_id, None)

    # ------------------------------------------------- context queries

    def create_resource_adapter(self, adapter_config: dict,
                                breaker=None) -> None:
        """(reference: accessController.ts:943-951); ``breaker`` is the
        shared context-query circuit breaker when admission control is
        active (srv/admission.py — wired by srv/worker.py)."""
        try:
            from ..srv.adapters import create_adapter
        except ImportError as exc:
            raise errors.UnsupportedResourceAdapter(adapter_config) from exc

        self.resource_adapter = create_adapter(
            adapter_config, self.logger, breaker=breaker
        )

    def pull_context_resources(self, context_query, request: Request):
        """Query the resource adapter and graft the result onto a merged
        request view under ``_queryResult`` (reference: :959-965 — the
        reference assigns the *merged request* into ``request.context`` and
        the merge never yields nil, even for empty adapter results)."""
        result = self.resource_adapter.query(context_query, request)
        return {
            "target": request.target,
            "context": request.context,
            "_queryResult": result,
        }
