"""Policy document loading.

Builds the in-memory PolicySet -> Policy -> Rule tree from YAML documents.
Mirrors the reference's production loader semantics
(reference: src/core/utils.ts:58-155): absent targets stay ``None``, absent
effects stay ``None`` (no enum defaulting), children keep document order.

Two document shapes are supported:

- nested: ``{policy_sets: [{..., policies: [{..., rules: [...]}]}]}``
  (the fixture shape, reference: test/fixtures/*.yml);
- flat seed lists: separate policy_set / policy / rule documents joined by
  id references (reference: data/seed_data/*.yaml loaded via superUpsert,
  src/worker.ts:200-242).
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

import yaml

from ..models.model import (
    ContextQuery,
    Policy,
    PolicySet,
    Rule,
    coerce_target,
)


def _coerce_context_query(obj: Any) -> Optional[ContextQuery]:
    if not obj:
        return None
    # the reference proto nests filter groups (ContextQuery.filters ->
    # repeated Filters -> repeated Filter; fixture
    # test/fixtures/context_query.yml); the internal model keeps one
    # flat predicate list, so nested groups flatten on load
    filters = []
    for entry in obj.get("filters") or []:
        if isinstance(entry, dict) and isinstance(entry.get("filters"), list):
            filters.extend(entry["filters"])
        else:
            filters.append(entry)
    return ContextQuery(filters=filters, query=obj.get("query") or "")


def rule_from_dict(doc: dict) -> Rule:
    return Rule(
        id=doc.get("id", ""),
        name=doc.get("name", ""),
        description=doc.get("description", ""),
        target=coerce_target(doc.get("target")),
        effect=doc.get("effect"),
        condition=doc.get("condition") or "",
        context_query=_coerce_context_query(doc.get("context_query")),
        evaluation_cacheable=bool(doc.get("evaluation_cacheable", False)),
        meta=doc.get("meta"),
    )


def policy_from_dict(doc: dict, rules: Iterable[Rule] = ()) -> Policy:
    return Policy(
        id=doc.get("id", ""),
        name=doc.get("name", ""),
        description=doc.get("description", ""),
        target=coerce_target(doc.get("target")),
        effect=doc.get("effect"),
        combining_algorithm=doc.get("combining_algorithm", ""),
        combinables={r.id: r for r in rules},
        evaluation_cacheable=bool(doc.get("evaluation_cacheable", False)),
        meta=doc.get("meta"),
    )


def policy_set_from_dict(doc: dict, policies: Iterable[Policy] = ()) -> PolicySet:
    return PolicySet(
        id=doc.get("id", ""),
        name=doc.get("name", ""),
        description=doc.get("description", ""),
        target=coerce_target(doc.get("target")),
        combining_algorithm=doc.get("combining_algorithm", ""),
        combinables={p.id: p for p in policies},
        meta=doc.get("meta"),
    )


def load_policy_sets(document: dict) -> list[PolicySet]:
    """Load the nested ``policy_sets`` document shape."""
    out: list[PolicySet] = []
    for ps_doc in (document or {}).get("policy_sets") or []:
        policies = []
        for p_doc in ps_doc.get("policies") or []:
            rules = [rule_from_dict(r) for r in (p_doc.get("rules") or [])]
            policies.append(policy_from_dict(p_doc, rules))
        out.append(policy_set_from_dict(ps_doc, policies))
    return out


def load_policy_sets_from_file(filepath: str) -> list[PolicySet]:
    """Load one or more YAML documents from ``filepath`` (multi-doc files
    supported, mirroring ``yaml.loadAll`` in the reference loader)."""
    with open(filepath) as fh:
        docs = list(yaml.safe_load_all(fh))
    out: list[PolicySet] = []
    for doc in docs:
        if doc:
            out.extend(load_policy_sets(doc))
    return out


def join_seed_documents(
    policy_set_docs: list[dict], policy_docs: list[dict], rule_docs: list[dict]
) -> list[PolicySet]:
    """Join flat seed lists (ids referencing children) into the tree."""
    rules_by_id = {r["id"]: rule_from_dict(r) for r in rule_docs or []}
    policies_by_id = {}
    for p_doc in policy_docs or []:
        child_rules = [
            rules_by_id[rid] for rid in (p_doc.get("rules") or []) if rid in rules_by_id
        ]
        policies_by_id[p_doc["id"]] = policy_from_dict(p_doc, child_rules)
    out = []
    for ps_doc in policy_set_docs or []:
        child_policies = [
            policies_by_id[pid]
            for pid in (ps_doc.get("policies") or [])
            if pid in policies_by_id
        ]
        out.append(policy_set_from_dict(ps_doc, child_policies))
    return out


def load_seed_files(
    policy_sets_path: str, policies_path: str, rules_path: str
) -> list[PolicySet]:
    def _load_list(path):
        with open(path) as fh:
            docs = list(yaml.safe_load_all(fh))
        items: list[dict] = []
        for doc in docs:
            if isinstance(doc, list):
                items.extend(doc)
            elif doc:
                items.append(doc)
        return items

    return join_seed_documents(
        _load_list(policy_sets_path), _load_list(policies_path), _load_list(rules_path)
    )


def populate(access_controller, filepath: str) -> None:
    """Load a fixture file straight into an engine (the unit-test path,
    reference: test/utils.ts populate)."""
    for policy_set in load_policy_sets_from_file(filepath):
        access_controller.update_policy_set(policy_set)
