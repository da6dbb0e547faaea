"""The pieces of the JAX package's ``ops/delta.py`` that the port runs:

- the capacity bucket and the pad fills of the set, policy and rule array
  families, which the pod-sharded kernel (``parallel/pod_shard.py``)
  reads;
- the CRUD-event half: ``CrudEvent`` (the old / new doc pair the policy
  store captures at mutation time), ``event_is_noop`` and the scoped
  invalidation footprint (``footprint_from_events``), which the store
  (``srv/store.py``) uses to scope its pre-swap decision-cache bump.

The rest of that module (capacity-bucketed compiles, the delta encoder
``apply_events``, the patch ledger) is the delta slice and is not ported
yet: every refresh recompiles the whole tree, the JAX evaluator's
``delta_enabled=False`` path.

Host-only (model objects; no device code).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..core.hierarchical_scope import regex_entity_compare
from ..core.loader import policy_from_dict, policy_set_from_dict, rule_from_dict
from ..models.model import Target, coerce_target
from ..models.urns import Urns
from .interner import ABSENT


def _bucket(n: int, headroom: float, floor: int) -> int:
    need = max(floor, int(-(-n * headroom // 1)))
    return 1 << max(0, (need - 1).bit_length())


# pad fills per array family (axis layout in ops/compile.py)
_SET_FILLS = {"set_valid": False, "set_ca": ABSENT,
              "set_has_target": False, "set_target": 0}
_POL_FILLS = {"pol_valid": False, "pol_ca": ABSENT, "pol_effect": 0,
              "pol_cacheable": False, "pol_has_target": False,
              "pol_target": 0, "pol_has_subjects": False, "pol_n_rules": 0,
              "pol_eff_ctx": 0, "pol_has_props": False,
              "pol_ent_vals": ABSENT}
_RULE_FILLS = {"rule_valid": False, "rule_effect": 0,
               "rule_cacheable_raw": False, "rule_cacheable_eff": False,
               "rule_has_target": False, "rule_target": 0,
               "rule_cond": ABSENT}


# -------------------------------------------------------------- CRUD events


@dataclass
class CrudEvent:
    """One captured CRUD mutation: the stored doc before and after.  The
    store emits these at mutation time (srv/store.py) so neither the delta
    encoder nor the cache footprint needs a deepcopied old tree."""

    kind: str                 # rule | policy | policy_set
    op: str                   # create | update | upsert | delete | delete_all
    doc_id: str
    old_doc: Optional[dict] = None
    new_doc: Optional[dict] = None


_COMPOSERS = {
    "rule": rule_from_dict,
    "policy": policy_from_dict,
    "policy_set": policy_set_from_dict,
}


def _semantic(kind: str, doc: Optional[dict]):
    """Evaluation-relevant content of a doc: the composed model object with
    cosmetic fields (meta/name/description) blanked, plus the ordered
    child-id list (which the composer itself does not read)."""
    if doc is None:
        return None
    obj = _COMPOSERS[kind](doc)
    obj.meta = None
    obj.name = ""
    obj.description = ""
    if kind == "policy":
        children = tuple(doc.get("rules") or [])
    elif kind == "policy_set":
        children = tuple(doc.get("policies") or [])
    else:
        children = ()
    return obj, children


def event_is_noop(event: CrudEvent) -> bool:
    """True when the mutation left the doc's evaluation-relevant content
    unchanged (e.g. a CRUD payload identical to the stored resource, or a
    metadata-only restamp) — certified empty diffs skip the decision-cache
    flush and the recompile entirely."""
    if event.op == "delete_all":
        return False
    try:
        return _semantic(event.kind, event.old_doc) == _semantic(
            event.kind, event.new_doc
        )
    except Exception:  # malformed doc: let the full path decide
        return False


# ----------------------------------------------------- invalidation footprint


@dataclass(frozen=True)
class RuleScope:
    """Candidate-signature projection of one rule target (the doc-level
    analog of core/candidate_index.py's per-rule features): a request can
    be affected only if its resource features hit the entity/op side AND
    carry every required action value."""

    entities: tuple = ()      # exact values; doubled as regex patterns
    ops: tuple = ()
    acts: tuple = ()          # required action values (all must be present)
    res_any: bool = False     # target matches resource-free / any resource

    def affects(self, features) -> bool:
        if self.acts and not all(v in features.actions for v in self.acts):
            return False
        if self.res_any:
            return True
        for value in self.ops:
            if value in features.ops:
                return True
        for pattern in self.entities:
            if pattern in features.entities:
                return True
            for value in features.entities:
                try:
                    matched, _ = regex_entity_compare(pattern, value)
                except Exception:  # invalid pattern: conservative
                    matched = True
                if matched:
                    return True
        return False


@dataclass
class Footprint:
    """The affected target-signature set of one tree delta.  ``global_``
    forces the pre-delta behavior (every entry flushed); ``scopes`` empty
    with ``global_`` False certifies an empty diff."""

    scopes: list = field(default_factory=list)
    global_: bool = False

    @property
    def empty(self) -> bool:
        return not self.global_ and not self.scopes

    def affects(self, features) -> bool:
        if self.global_:
            return True
        return any(scope.affects(features) for scope in self.scopes)

    def merge(self, other: "Footprint") -> None:
        self.global_ = self.global_ or other.global_
        self.scopes.extend(other.scopes)


def scope_from_target(target, urns: Urns) -> RuleScope:
    """RuleScope of a target (dict or Target or None), mirroring
    candidate_rows / CandidateIndex candidacy: no target or no resources
    -> matches anything; resource-bearing with neither entity nor op ->
    conservatively anything (candidate_index keeps such rules too)."""
    if target is not None and not isinstance(target, Target):
        target = coerce_target(target)
    if target is None:
        return RuleScope(res_any=True)
    entity_urn = urns.get("entity")
    operation_urn = urns.get("operation")
    acts = tuple(
        a.value for a in (target.actions or []) if a.value is not None
    )
    resources = target.resources or []
    if not resources:
        return RuleScope(acts=acts, res_any=True)
    ents = tuple(a.value for a in resources
                 if a.id == entity_urn and a.value is not None)
    ops = tuple(a.value for a in resources
                if a.id == operation_urn and a.value is not None)
    if not ents and not ops:
        return RuleScope(acts=acts, res_any=True)
    return RuleScope(entities=ents, ops=ops, acts=acts)


def _policy_gate_scope(doc: Optional[dict], urns: Urns, out: Footprint
                       ) -> None:
    """A policy/set-level gate change affects every request that can pass
    the node's target; a target-less (or resource-less) gate passes all."""
    target = (doc or {}).get("target")
    scope = scope_from_target(target, urns)
    if scope.res_any and not scope.acts:
        out.global_ = True
    else:
        out.scopes.append(scope)


def footprint_from_events(
    events: list[CrudEvent],
    urns: Urns,
    get_doc: Callable[[str, str], Optional[dict]],
    all_docs: Callable[[str], list],
) -> Footprint:
    """Project a CRUD event list onto the affected target-signature set.

    Conservative by construction (docs/HOT_UPDATE.md states the proof
    obligation): every request whose decision, obligations or
    ``evaluation_cacheable`` flag could differ between the old and new
    tree is covered by the returned footprint.  ``get_doc(kind, id)`` and
    ``all_docs(kind)`` read the store collections (already containing the
    post-mutation state)."""
    out = Footprint()
    policy_docs: Optional[list] = None

    def rule_scope(rule_id: str) -> None:
        doc = get_doc("rule", rule_id)
        if doc is not None:
            out.scopes.append(scope_from_target(doc.get("target"), urns))

    def whole_policy(p_doc: dict) -> None:
        # prefix-AND cacheable ripple / ordering ripple: every rule of the
        # policy is in scope, plus the policy gate itself
        for rid in p_doc.get("rules") or []:
            rule_scope(rid)
        _policy_gate_scope(p_doc, urns, out)

    for event in events:
        if out.global_:
            break
        if event_is_noop(event):
            continue
        if event.op == "delete_all":
            out.global_ = True
            break
        old, new = event.old_doc, event.new_doc
        if event.kind == "rule":
            for doc in (old, new):
                if doc is not None:
                    out.scopes.append(
                        scope_from_target(doc.get("target"), urns)
                    )
            cacheable_changed = bool((old or {}).get(
                "evaluation_cacheable", False
            )) != bool((new or {}).get("evaluation_cacheable", False))
            if cacheable_changed or old is None or new is None:
                # membership/cacheable changes ripple through the owning
                # policies' prefix-AND chain
                if policy_docs is None:
                    policy_docs = all_docs("policy")
                for p_doc in policy_docs:
                    if event.doc_id in (p_doc.get("rules") or []):
                        whole_policy(p_doc)
        elif event.kind == "policy":
            old_rules = list((old or {}).get("rules") or [])
            new_rules = list((new or {}).get("rules") or [])
            old_sem = _semantic("policy", old)
            new_sem = _semantic("policy", new)
            gate_changed = (
                old is None or new is None
                or old_sem is None or new_sem is None
                or old_sem[0] != new_sem[0]
            )
            if (new or {}).get("effect") != (old or {}).get("effect"):
                # carried-policyEffect ripple crosses policy boundaries
                out.global_ = True
                break
            if old_rules != new_rules or gate_changed:
                for rid in dict.fromkeys(old_rules + new_rules):
                    rule_scope(rid)
            if gate_changed:
                for doc in (old, new):
                    if doc is not None:
                        _policy_gate_scope(doc, urns, out)
        else:  # policy_set
            old_pols = list((old or {}).get("policies") or [])
            new_pols = list((new or {}).get("policies") or [])
            old_sem = _semantic("policy_set", old)
            new_sem = _semantic("policy_set", new)
            gate_changed = (
                old is None or new is None
                or old_sem is None or new_sem is None
                or old_sem[0] != new_sem[0]
            )
            if gate_changed or old_pols != new_pols:
                if old is None or new is None or gate_changed:
                    # set create/delete/gate change: last-set-wins ordering
                    # and the set gate both shift — conservative global
                    out.global_ = True
                    break
                for pid in dict.fromkeys(
                    set(old_pols).symmetric_difference(new_pols)
                ):
                    p_doc = get_doc("policy", pid)
                    if p_doc is not None:
                        whole_policy(p_doc)
                if [p for p in old_pols if p in new_pols] != [
                    p for p in new_pols if p in old_pols
                ]:
                    out.global_ = True  # reorder: combining order shifts
                    break
    if out.global_:
        out.scopes = []
    return out
