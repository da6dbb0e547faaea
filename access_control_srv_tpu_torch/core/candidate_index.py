"""Candidate-rule index for the scalar oracle.

The oracle walks every rule of every policy per request (the reference
architecture, src/core/accessController.ts:125-297).  On large trees
that walk dominates every fallback-served request even though a rule
whose target names entity X can never match a request that only names
entity Y.

A copy of the JAX package's ``core/candidate_index.py``.  This index is
the OBJECT-level analog of the kernel's candidate pre-filter
(ops/prefilter.candidate_rows, same normative reasoning): a
rule with a resource-bearing target can only match via an exact entity
hit, a regex entity hit, or an operation hit, and every target action
value must appear among the request's action values.  Skipping a
non-candidate rule is exactly equivalent to its target failing to match
— the isAllowed walk has no side effects for unmatched rules (condition
evaluation, HR checks and ACL checks all run only after a target
match; masking obligations exist only in whatIsAllowed mode, reference
:592-640) — so candidate-filtered decisions are bit-identical
(differential: tests/test_candidate_index.py).

Over-approximation is always safe: a kept rule that cannot match just
costs one scalar target evaluation.  Regex candidacy reuses the
memoized regex_entity_compare, so steady-state per-request work is
dict lookups.
"""

from __future__ import annotations

import threading
from typing import Optional

from .hierarchical_scope import regex_entity_compare, split_entity_urn


class CandidateIndex:
    """Immutable per-tree-snapshot index: request -> set of rule object
    ids whose targets could match.  Built once per compile (cheap: one
    pass over the rules); safe to share across threads."""

    def __init__(self, policy_sets, urns):
        entity_urn = urns.get("entity")
        operation_urn = urns.get("operation")
        self._exact: dict[str, set[int]] = {}
        self._ops: dict[str, set[int]] = {}
        # DISTINCT pattern value -> rule ids: the oracle's regex fallback
        # treats every target entity value as a pattern (even literals
        # can substring-match other entities — reference :526-566), but
        # the per-request sweep only needs one memoized compare per
        # distinct value, not per rule
        self._regex_by_value: dict[str, set[int]] = {}
        self._always: set[int] = set()
        self._req_cache: dict[tuple, frozenset] = {}
        self._cache_ids = 0  # total cached ids: bounds MEMORY, not entries
        self._cache_lock = threading.Lock()
        # rule id -> tuple of target action values (must all appear among
        # the request's action values; value-only check mirrors the
        # kernel's conservative act_compat)
        self._act_vals: dict[int, tuple] = {}
        self.n_rules = 0

        sets = (policy_sets.values()
                if isinstance(policy_sets, dict) else policy_sets)
        for policy_set in sets:
            if policy_set is None:
                continue
            for policy in policy_set.combinables.values():
                if policy is None:
                    continue
                for rule in policy.combinables.values():
                    if rule is None:
                        continue
                    self.n_rules += 1
                    rid = id(rule)
                    target = rule.target
                    if target is None:
                        self._always.add(rid)
                        continue
                    acts = tuple(
                        a.value for a in (target.actions or [])
                        if a.value is not None
                    )
                    if acts:
                        self._act_vals[rid] = acts
                    ents = [a.value for a in (target.resources or [])
                            if a.id == entity_urn and a.value is not None]
                    ops = [a.value for a in (target.resources or [])
                           if a.id == operation_urn and a.value is not None]
                    if not (target.resources or []):
                        self._always.add(rid)
                        continue
                    if not ents and not ops:
                        # resource-bearing target with neither entity nor
                        # operation: no-entity-and-no-operation => never
                        # matches (reference :650-653) UNLESS the rule
                        # has only property attrs — still unmatchable.
                        # Conservatively keep rules whose resources are
                        # all non-entity/op/property ids (they match
                        # nothing in the kernel too, but the oracle walk
                        # decides) — cheap: treat as always-candidates.
                        self._always.add(rid)
                        continue
                    for value in ents:
                        self._exact.setdefault(value, set()).add(rid)
                        self._regex_by_value.setdefault(value, set()).add(rid)
                    for value in ops:
                        self._ops.setdefault(value, set()).add(rid)

    def candidates(self, request, urns) -> Optional[frozenset]:
        """Rule object ids whose targets could match ``request``; None
        when the request has no target (caller handles the 400 path).
        The returned set is shared via an internal cache — treat it as
        immutable."""
        target = request.target
        if target is None:
            return None
        entity_urn = urns.get("entity")
        operation_urn = urns.get("operation")
        ents = tuple(sorted({
            a.value for a in (target.resources or [])
            if a.id == entity_urn and a.value is not None
        }))
        ops = tuple(sorted({
            a.value for a in (target.resources or [])
            if a.id == operation_urn and a.value is not None
        }))
        req_acts = frozenset(
            a.value for a in (target.actions or []) if a.value is not None
        )
        key = (ents, ops, req_acts)
        hit = self._req_cache.get(key)
        if hit is not None:
            return hit
        out = set(self._always)
        for value in ents:
            out |= self._exact.get(value, set())
            for pattern, rids in self._regex_by_value.items():
                if rids <= out:
                    continue
                try:
                    matched, _ = regex_entity_compare(pattern, value)
                except Exception:  # invalid pattern: let the oracle
                    matched = True  # surface the reference's error
                if matched:
                    out |= rids
        for value in ops:
            out |= self._ops.get(value, set())
        # action-value compatibility (conservative: ids ignored)
        result = frozenset(
            rid for rid in out
            if all(v in req_acts for v in self._act_vals.get(rid, ()))
        )
        with self._cache_lock:
            # bound by total cached ids, not entry count: each entry is
            # O(candidates) and broad trees would otherwise let request-
            # shaped input pin gigabytes (4096 x ~n_rules ids)
            while self._req_cache and self._cache_ids + len(result) > 2_000_000:
                _, evicted = self._req_cache.popitem()
                self._cache_ids -= len(evicted)
            self._req_cache[key] = result
            self._cache_ids += len(result)
        return result


__all__ = ["CandidateIndex", "split_entity_urn"]
