"""Incremental policy updates: capacity-bucketed compiled tables and a
delta encoder that turns CRUD diffs into row-level patches.

The port's copy of the JAX package's ``ops/delta.py``.  The reference is
a PAP as much as a PDP: policies mutate at runtime over gRPC CRUD and are
hot-applied to the evaluation tree.  A full recompile per mutation costs
a ``copy.deepcopy`` of the tree, a from-scratch ``compile_policies``, a
new kernel object with all its tables uploaded and a whole decision-cache
flush.  This module makes sustained policy churn cheaper, in three
pieces:

1. **Capacity buckets** (:func:`capacities_for` / :func:`pad_compiled`):
   the rule (S/KP/KR), target-table (T), role-scope-vocab (RV),
   entity-regex-vocab (W) and relation-vocab (RELV) dims of
   :class:`CompiledPolicies` are padded to the next power of two at
   >= ``headroom`` x the live size.  Every shape the kernels see derives
   from these dims, so an in-capacity mutation keeps every table shape,
   and the kernels' libraries, launch sizing and runners
   (``shared_jits``, ops/kernel.py) are reused: no ``nvcc`` build and no
   library load per patch.  Pad slots are inert by their fills (valid
   False, ABSENT ids); entity-vocab pad slots hold ``(?!)``-prefixed
   sentinel patterns, valid regexes that never match any entity, with
   pairwise-distinct tails so the encoder's ``tails_ambiguous``
   property-relevance guard is unaffected.

2. **Delta encoder** (:func:`apply_events`): CRUD events (old/new doc
   pairs captured by srv/store.py) are diffed semantically; each affected
   set slot is relowered IN PLACE by the same
   :func:`ops.compile.lower_set_into` loop the from-scratch compiler
   runs, with target-table rows owned by node identity (free-list reuse
   for deleted rules) and condition slots owned by rule identity.
   Anything the prover cannot certify raises :class:`DeltaIneligible`
   and the caller falls back to the full recompile:

   - capacity overflow (policies/rules/target rows/vocab entries),
   - combining-algorithm changes on surviving nodes,
   - condition-set changes (added/removed/edited conditions move the
     [C, B] condition shapes),
   - policy-set list or order changes (ops/reverse.py maps tree position
     to set slot positionally),
   - kernel-variant flips (``tree_needs_hr`` / ``tree_needs_rel`` select
     another kernel variant), prefilter activation-threshold crossings
     (``MIN_RULES`` of ops/prefilter.py),
   - restore / reset / collection drops (no event stream to diff).

3. **Scoped invalidation footprints** (:func:`footprint_from_events`):
   the doc-level delta is projected onto the candidate-signature space of
   core/candidate_index.py (exact entity values, regex entity patterns,
   operation values, required action values): a cached decision whose
   request features are disjoint from every touched rule's footprint is
   provably unaffected by the mutation, so srv/decision_cache.py keeps it
   live across the scoped epoch bump.  ``evaluation_cacheable`` edits
   widen the footprint to the whole owning policy (the prefix-AND
   ripple), policy/set-level gate changes widen to the node's own target
   (or to a global flush when the gate is target-less).

Host-only (numpy + model objects; no torch import), so the decision-cache
path stays device-free and the patcher can run on the CRUD thread.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import numpy as np

from ..core.hierarchical_scope import regex_entity_compare
from ..core.loader import policy_from_dict, policy_set_from_dict, rule_from_dict
from ..models.model import ContextQuery, Target, coerce_target
from ..models.urns import Urns
from .compile import (
    CompiledPolicies,
    TARGET_COLUMNS,
    lower_set_into,
    lower_target,
)
from .interner import ABSENT


class DeltaIneligible(Exception):
    """The delta prover cannot certify this mutation as an in-place patch;
    the caller must take the full-recompile path.  ``reason`` is a short
    taxonomy key (docs/HOT_UPDATE.md)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


# ----------------------------------------------------------- capacity buckets


@dataclass(frozen=True)
class Capacities:
    """Padded table dims; every kernel-visible shape derives from these."""

    S: int   # policy-set slots
    KP: int  # policy slots per set
    KR: int  # rule slots per policy
    T: int   # target-table rows
    RV: int  # (role, scoping) vocab entries (set the owner-bitplane width)
    W: int   # entity regex-vocab rows (rgx_set leading dim)
    # relation-path vocab entries (set the ReBAC bitplane width,
    # ops/relation.py); appended with a default so pre-ReBAC callers and
    # persisted size classes stay valid
    RELV: int = 4

    def as_dict(self) -> dict:
        return {"S": self.S, "KP": self.KP, "KR": self.KR,
                "T": self.T, "RV": self.RV, "W": self.W,
                "RELV": self.RELV}


def _bucket(n: int, headroom: float, floor: int) -> int:
    need = max(floor, int(-(-n * headroom // 1)))
    return 1 << max(0, (need - 1).bit_length())


def capacities_for(
    compiled: CompiledPolicies,
    headroom: float = 1.25,
    prev: Optional[Capacities] = None,
) -> Capacities:
    """Headroom buckets for a freshly compiled (unpadded) tree: the next
    power of two >= ``headroom`` x each live size.  When ``prev`` still
    fits the live sizes and is not more than one bucket oversized, it is
    reused so consecutive full recompiles keep the same table shapes
    (and therefore the same launch sizing and runners)."""
    live = Capacities(
        S=compiled.S, KP=compiled.KP, KR=compiled.KR, T=compiled.T,
        RV=int(np.asarray(compiled.arrays["hrv_role"]).shape[0]),
        W=max(len(compiled.entity_vocab), 1),
        RELV=max(len(compiled.rel_vocab), 1),
    )
    fresh = Capacities(
        S=_bucket(live.S, headroom, 2),
        KP=_bucket(live.KP, headroom, 2),
        KR=_bucket(live.KR, headroom, 4),
        T=_bucket(live.T, headroom, 8),
        RV=_bucket(live.RV, headroom, 4),
        W=_bucket(live.W, headroom, 4),
        RELV=_bucket(live.RELV, headroom, 4),
    )
    if prev is not None:
        dims = ("S", "KP", "KR", "T", "RV", "W", "RELV")
        fits = all(getattr(prev, d) >= getattr(live, d) for d in dims)
        tight = all(
            getattr(prev, d) <= 2 * getattr(fresh, d) for d in dims
        )
        if fits and tight:
            return prev
    return fresh


def vocab_pad_value(row: int) -> str:
    """Entity-vocab pad sentinel for row ``row``: ``(?!)`` never matches
    (empty negative lookahead fails at every position), the numeric suffix
    keeps pad tails pairwise distinct so the encoder's ambiguous-tails
    guard (ops/encode.py) sees no duplicates."""
    return f"(?!)__cap{row}"


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
_T_FILLS = {"t_n_subjects": 0, "t_role": ABSENT, "t_has_role": False,
            "t_scoping": ABSENT, "t_has_scoping": False,
            "t_hr_check": False, "t_skip_acl": False, "t_sub_ids": ABSENT,
            "t_sub_vals": ABSENT, "t_act_ids": ABSENT, "t_act_vals": ABSENT,
            "t_ent_vals": ABSENT, "t_ent_w": ABSENT, "t_ent_tails": ABSENT,
            "t_op_vals": ABSENT, "t_prop_vals": ABSENT, "t_prop_sfx": ABSENT,
            "t_has_props": False, "t_n_res": 0, "t_rs_idx": 0,
            # ABSENT (not 0): pad rows must stay relation-trivial so the
            # tree_needs_rel program selector never flips on padding
            "t_rel_path": ABSENT, "t_rel_idx": ABSENT,
            "t_rel_direct": False}


def _pad_axis(arr: np.ndarray, axis: int, size: int, fill) -> np.ndarray:
    if arr.shape[axis] >= size:
        return arr
    pad_shape = list(arr.shape)
    pad_shape[axis] = size - arr.shape[axis]
    return np.concatenate(
        [arr, np.full(pad_shape, fill, arr.dtype)], axis=axis
    )


def pad_compiled(compiled: CompiledPolicies, caps: Capacities
                 ) -> CompiledPolicies:
    """Pad a freshly compiled tree out to capacity buckets.  Pad slots are
    inert by construction: valid masks are False, pad target rows are
    never referenced by any live node index, pad vocab entries can never
    regex-match, and pad rs-vocab entries carry ABSENT pairs the owner-
    verdict packer masks out.  Returns a NEW CompiledPolicies sharing the
    interner; conditions are re-homed to capacity-based flat indices."""
    a = dict(compiled.arrays)
    for name, fill in _SET_FILLS.items():
        a[name] = _pad_axis(a[name], 0, caps.S, fill)
    for name, fill in _POL_FILLS.items():
        arr = _pad_axis(a[name], 1, caps.KP, fill)
        a[name] = _pad_axis(arr, 0, caps.S, fill)
    for name, fill in _RULE_FILLS.items():
        arr = _pad_axis(a[name], 2, caps.KR, fill)
        arr = _pad_axis(arr, 1, caps.KP, fill)
        a[name] = _pad_axis(arr, 0, caps.S, fill)
    for name, fill in _T_FILLS.items():
        a[name] = _pad_axis(a[name], 0, caps.T, fill)
    a["hrv_role"] = _pad_axis(a["hrv_role"], 0, caps.RV, ABSENT)
    a["hrv_scope"] = _pad_axis(a["hrv_scope"], 0, caps.RV, ABSENT)
    # pad relation-vocab rows are ABSENT and unreferenced by any live
    # t_rel_idx; the store's verdict tables carry empty segments for them
    a["relv_path"] = _pad_axis(a["relv_path"], 0, caps.RELV, ABSENT)

    vocab = list(compiled.entity_vocab)
    while len(vocab) < caps.W:
        vocab.append(vocab_pad_value(len(vocab)))

    conditions = []
    for cond in compiled.conditions:
        s, rem = divmod(cond.rule_flat_index, compiled.KP * compiled.KR)
        kp, kr = divmod(rem, compiled.KR)
        conditions.append(replace(
            cond, rule_flat_index=(s * caps.KP + kp) * caps.KR + kr
        ))

    return replace(
        compiled,
        arrays=a,
        conditions=conditions,
        entity_vocab=vocab,
        entity_vocab_ids=dict(compiled.entity_vocab_ids),
        rel_vocab=list(compiled.rel_vocab),
        rel_vocab_ids=dict(compiled.rel_vocab_ids),
        S=caps.S, KP=caps.KP, KR=caps.KR, T=caps.T,
        target_owners=dict(compiled.target_owners),
    )


def clear_set_slot(a: dict, s: int) -> None:
    """Reset slot ``s`` across every set/policy/rule-level plane to the
    pad fills (relowering writes only the live prefix of each row)."""
    for name, fill in _SET_FILLS.items():
        a[name][s] = fill
    for name, fill in _POL_FILLS.items():
        a[name][s] = fill
    for name, fill in _RULE_FILLS.items():
        a[name][s] = fill


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


# --------------------------------------------------------------- delta state


@dataclass
class SetState:
    """Per-set ownership ledger: what the current slot content was lowered
    from, keyed by node identity so relowering reuses rows/slots."""

    slot: int
    ca: str
    pol_ca: dict = field(default_factory=dict)    # pol_key -> CA urn
    rows: dict = field(default_factory=dict)      # owner tuple -> target row
    conds: dict = field(default_factory=dict)     # rule owner -> cond index


@dataclass
class DeltaState:
    """Mutable companion of one published bucketed CompiledPolicies: slot
    maps, target-row free list, vocab live sizes and the condition ledger.
    Cloned-and-published together with the patched arrays, never mutated
    in place (srv/evaluator.py swaps both under its publish lock)."""

    caps: Capacities
    sets: dict = field(default_factory=dict)       # set_id -> SetState
    set_order: list = field(default_factory=list)
    t_live: int = 0
    free_rows: list = field(default_factory=list)
    w_live: int = 0
    rv_live: int = 0
    rs_map: dict = field(default_factory=dict)     # (role, scope) id -> row
    cond_content: dict = field(default_factory=dict)  # idx -> (cond, query)
    rule_refs: dict = field(default_factory=dict)  # rule id -> set ids
    pol_refs: dict = field(default_factory=dict)   # policy id -> set ids
    needs_hr: bool = False
    needs_rel: bool = False
    prefilter_active: bool = False
    relv_live: int = 0
    rel_map: dict = field(default_factory=dict)    # interned path id -> row

    def clone(self) -> "DeltaState":
        return DeltaState(
            caps=self.caps,
            sets={
                sid: SetState(
                    slot=st.slot, ca=st.ca, pol_ca=dict(st.pol_ca),
                    rows=dict(st.rows), conds=dict(st.conds),
                )
                for sid, st in self.sets.items()
            },
            set_order=list(self.set_order),
            t_live=self.t_live,
            free_rows=list(self.free_rows),
            w_live=self.w_live,
            rv_live=self.rv_live,
            rs_map=dict(self.rs_map),
            cond_content=dict(self.cond_content),
            rule_refs={k: set(v) for k, v in self.rule_refs.items()},
            pol_refs={k: set(v) for k, v in self.pol_refs.items()},
            needs_hr=self.needs_hr,
            needs_rel=self.needs_rel,
            prefilter_active=self.prefilter_active,
            relv_live=self.relv_live,
            rel_map=dict(self.rel_map),
        )


def _tree_refs(tree) -> tuple[dict, dict]:
    rule_refs: dict = {}
    pol_refs: dict = {}
    for sid, ps in tree.items():
        if ps is None:
            continue
        for pol in ps.combinables.values():
            if pol is None:
                continue
            pol_refs.setdefault(pol.id, set()).add(sid)
            for rule in pol.combinables.values():
                if rule is None:
                    continue
                rule_refs.setdefault(rule.id, set()).add(sid)
    return rule_refs, pol_refs


def _needs_hr(arrays: dict) -> bool:
    # mirrors ops/kernel.tree_needs_hr without importing torch
    return bool(
        (np.asarray(arrays["t_has_scoping"])
         & (np.asarray(arrays["t_n_subjects"]) > 0)).any()
    )


def _needs_rel(arrays: dict) -> bool:
    # mirrors ops/kernel.tree_needs_rel without importing torch
    t = arrays.get("t_rel_idx")
    return t is not None and bool((np.asarray(t) >= 0).any())


def _prefilter_threshold() -> int:
    # lazy: ops/prefilter imports torch; only the constant is needed here
    from .prefilter import MIN_RULES

    return MIN_RULES


def build_state(
    padded: CompiledPolicies,
    raw: CompiledPolicies,
    tree,
    caps: Capacities,
) -> DeltaState:
    """Ownership ledger for a freshly published bucketed compile.  ``raw``
    is the pre-padding compile (live sizes); ``padded`` the published
    tables whose ``target_owners`` / condition owners seed the maps."""
    state = DeltaState(caps=caps)
    state.t_live = raw.T
    state.w_live = len(raw.entity_vocab)
    state.rv_live = int(np.asarray(raw.arrays["hrv_role"]).shape[0])
    hrv_role = np.asarray(padded.arrays["hrv_role"])[: state.rv_live]
    hrv_scope = np.asarray(padded.arrays["hrv_scope"])[: state.rv_live]
    state.rs_map = {
        (int(r), int(sc)): i
        for i, (r, sc) in enumerate(zip(hrv_role, hrv_scope))
    }
    state.rule_refs, state.pol_refs = _tree_refs(tree)
    state.needs_hr = _needs_hr(padded.arrays)
    state.needs_rel = _needs_rel(padded.arrays)
    state.prefilter_active = raw.n_rules >= _prefilter_threshold()
    state.relv_live = len(raw.rel_vocab)
    state.rel_map = dict(padded.rel_vocab_ids)

    sets = [ps for ps in tree.values() if ps is not None]
    for s, ps in enumerate(sets):
        st = SetState(slot=s, ca=ps.combining_algorithm)
        for pol_key, pol in ps.combinables.items():
            if pol is not None:
                st.pol_ca[pol_key] = pol.combining_algorithm
        state.sets[ps.id] = st
        state.set_order.append(ps.id)
    for owner, row in padded.target_owners.items():
        sid = owner[1]
        if sid in state.sets:
            state.sets[sid].rows[owner] = int(row)
    for idx, cond in enumerate(padded.conditions):
        state.cond_content[idx] = (
            cond.condition, _query_key(cond.context_query)
        )
        if cond.owner is not None and cond.owner[1] in state.sets:
            state.sets[cond.owner[1]].conds[cond.owner] = idx
    return state


def _query_key(context_query) -> tuple:
    if context_query is None:
        return ()
    if isinstance(context_query, ContextQuery):
        return (repr(context_query.filters), context_query.query)
    return (repr(context_query),)


def full_bucketed_compile(
    tree,
    urns: Urns,
    version: int = 0,
    prev_caps: Optional[Capacities] = None,
    headroom: float = 1.25,
):
    """The full-recompile path with capacity bucketing: compile from
    scratch, pad to (possibly reused) capacity buckets, and build the
    ownership state for subsequent patches.  Unsupported trees come back
    unpadded with ``state None`` (no kernel exists to patch)."""
    from .compile import compile_policies

    raw = compile_policies(tree, urns, version=version)
    if not raw.supported:
        return raw, None, None
    caps = capacities_for(raw, headroom=headroom, prev=prev_caps)
    padded = pad_compiled(raw, caps)
    state = build_state(padded, raw, tree, caps)
    return padded, caps, state


def live_capacities(compiled: CompiledPolicies) -> Capacities:
    """Unpadded live sizes of a fresh compile — what size-class selection
    (srv/tenancy.py) measures a tenant tree against."""
    return Capacities(
        S=compiled.S, KP=compiled.KP, KR=compiled.KR, T=compiled.T,
        RV=int(np.asarray(compiled.arrays["hrv_role"]).shape[0]),
        W=max(len(compiled.entity_vocab), 1),
        RELV=max(len(compiled.rel_vocab), 1),
    )


def fixed_caps_compile(tree, urns: Urns, caps: Capacities,
                       version: int = 0):
    """Compile a tree directly into a FIXED capacity class, bypassing
    ``capacities_for``'s tightness preference.  This is the multi-tenant
    packing primitive (the JAX package's srv/tenancy.py): every tenant in
    one size class publishes tables with byte-identical shapes, so the
    class shares one ``shared_jits`` registry of runners and per-tenant
    tables enter as launch arguments.  Raises DeltaIneligible(``capacity-class-<dim>``) when the
    live tree overflows the class on any dimension — the caller promotes
    the tenant to the next class and recompiles there."""
    from .compile import compile_policies

    raw = compile_policies(tree, urns, version=version)
    if not raw.supported:
        return raw, None, None
    live = live_capacities(raw)
    for dim in ("S", "KP", "KR", "T", "RV", "W", "RELV"):
        if getattr(live, dim) > getattr(caps, dim):
            raise DeltaIneligible(f"capacity-class-{dim}")
    padded = pad_compiled(raw, caps)
    state = build_state(padded, raw, tree, caps)
    return padded, caps, state


# ------------------------------------------------------------- delta patcher


class _DeltaTargetTable:
    """Duck-typed stand-in for compile._TargetTable that writes target rows
    IN PLACE: rows are owned by node identity (reused across relowers),
    freed rows go to the free list, and the entity/rs vocabs grow only
    within their capacity buckets."""

    def __init__(self, arrays: dict, state: DeltaState, set_state: SetState,
                 old_rows: dict, interner, urns: Urns,
                 entity_vocab: list, entity_vocab_ids: dict,
                 rel_vocab: Optional[list] = None,
                 rel_vocab_ids: Optional[dict] = None):
        self.arrays = arrays
        self.state = state
        self.set_state = set_state
        self.old_rows = old_rows        # previous owner -> row map
        self.claimed: set = set()
        self.interner = interner
        self.urns = urns
        self.entity_vocab = entity_vocab
        self.entity_vocab_ids = entity_vocab_ids
        self.rel_vocab = rel_vocab if rel_vocab is not None else []
        self.rel_vocab_ids = rel_vocab_ids if rel_vocab_ids is not None else {}
        self.unsupported: Optional[str] = None
        self.rows_written = 0

    # --- vocab allocation inside the capacity bucket
    def _vocab_row(self, value: str) -> int:
        vid = self.interner.intern(value)
        row = self.entity_vocab_ids.get(vid)
        if row is None:
            if self.state.w_live >= self.state.caps.W:
                raise DeltaIneligible("capacity-entity-vocab")
            row = self.state.w_live
            self.entity_vocab[row] = value
            self.entity_vocab_ids[vid] = row
            self.state.w_live += 1
        return row

    def _rel_row(self, value: str) -> int:
        vid = self.interner.intern(value)
        row = self.rel_vocab_ids.get(vid)
        if row is None:
            if self.state.relv_live >= self.state.caps.RELV:
                raise DeltaIneligible("capacity-rel-vocab")
            row = self.state.relv_live
            if row < len(self.rel_vocab):
                self.rel_vocab[row] = value
            else:
                self.rel_vocab.append(value)
            self.rel_vocab_ids[vid] = row
            self.arrays["relv_path"][row] = vid
            self.state.rel_map[vid] = row
            self.state.relv_live += 1
        return row

    def _rs_row(self, role: int, scope: int) -> int:
        key = (int(role), int(scope))
        idx = self.state.rs_map.get(key)
        if idx is None:
            if self.state.rv_live >= self.state.caps.RV:
                raise DeltaIneligible("capacity-rs-vocab")
            idx = self.state.rv_live
            self.arrays["hrv_role"][idx] = role
            self.arrays["hrv_scope"][idx] = scope
            self.state.rs_map[key] = idx
            self.state.rv_live += 1
        return idx

    def _alloc_row(self, owner: tuple) -> int:
        row = self.old_rows.get(owner)
        if row is None:
            if self.state.free_rows:
                row = self.state.free_rows.pop()
            elif self.state.t_live < self.state.caps.T:
                row = self.state.t_live
                self.state.t_live += 1
            else:
                raise DeltaIneligible("capacity-target-rows")
        return row

    def add(self, target, owner: Optional[tuple] = None) -> int:
        row_dict, unsupported = lower_target(
            target, self.interner, self.urns, self._vocab_row, self._rel_row
        )
        if unsupported:
            self.unsupported = unsupported
        idx = self._alloc_row(owner)
        a = self.arrays
        for name, key, _dtype in TARGET_COLUMNS:
            a[name][idx] = row_dict[key]
        a["t_rs_idx"][idx] = self._rs_row(
            row_dict["role"], row_dict["scoping"]
        )
        self.set_state.rows[owner] = idx
        self.claimed.add(owner)
        self.rows_written += 1
        self._row_info = (row_dict["has_props"], row_dict["ent_vals"])
        self._last_idx = idx
        return idx

    def row_info(self, idx: int) -> tuple[bool, list[int]]:
        assert idx == self._last_idx
        return self._row_info


class _DeltaConditionSink:
    """Identity-checked condition slot reuse: patched trees may neither
    add, remove nor edit conditions (the [C, B] device shapes and the
    prefetch plan's flat indices hang off the list), only re-home the
    surviving rules' flat indices."""

    def __init__(self, state: DeltaState, set_state: SetState,
                 old_conds: dict, conditions: list):
        self.state = state
        self.set_state = set_state
        self.old_conds = old_conds
        self.conditions = conditions
        self.claimed: set = set()

    def add(self, owner: tuple, flat_index: int, condition: str,
            context_query) -> int:
        idx = self.old_conds.get(owner)
        if idx is None:
            raise DeltaIneligible("condition-added")
        if self.state.cond_content.get(idx) != (
            condition, _query_key(context_query)
        ):
            raise DeltaIneligible("condition-changed")
        self.conditions[idx] = replace(
            self.conditions[idx], rule_flat_index=flat_index, owner=owner
        )
        self.set_state.conds[owner] = idx
        self.claimed.add(owner)
        return idx


def apply_events(
    state: DeltaState,
    compiled: CompiledPolicies,
    tree,
    events: list[CrudEvent],
    urns: Urns,
):
    """Turn a CRUD event list into an in-place patch of the bucketed
    tables.

    Returns ``("noop", None, None, stats)`` when every event is
    semantically empty or touches nothing the tree references, or
    ``("patch", new_compiled, new_state, stats)`` with copy-on-write
    arrays (the input ``compiled``/``state`` are never mutated, so a
    version race can drop the result safely).  Raises
    :class:`DeltaIneligible` for everything the prover cannot certify —
    the caller falls back to the full recompile."""
    if not compiled.supported:
        raise DeltaIneligible("unsupported-tree")
    caps = state.caps

    non_noop = [ev for ev in events if not event_is_noop(ev)]
    stats = {"events": len(events), "events_effective": len(non_noop)}
    if not non_noop:
        return "noop", None, None, stats
    if any(ev.op == "delete_all" for ev in non_noop):
        raise DeltaIneligible("collection-drop")

    new_order = [sid for sid, ps in tree.items() if ps is not None]
    if new_order != state.set_order:
        # ops/reverse.py (and the set-slot maps) rely on positional
        # tree <-> slot correspondence; set membership/order changes take
        # the full path (rare next to rule/policy churn)
        raise DeltaIneligible("set-list-changed")

    new_rule_refs, new_pol_refs = _tree_refs(tree)
    affected: set = set()
    for ev in non_noop:
        if ev.kind == "rule":
            affected |= state.rule_refs.get(ev.doc_id, set())
            affected |= new_rule_refs.get(ev.doc_id, set())
        elif ev.kind == "policy":
            affected |= state.pol_refs.get(ev.doc_id, set())
            affected |= new_pol_refs.get(ev.doc_id, set())
        else:
            affected.add(ev.doc_id)
    affected &= set(new_order)
    if not affected:
        # e.g. a rule created before any policy references it
        new_state = state.clone()
        new_state.rule_refs, new_state.pol_refs = new_rule_refs, new_pol_refs
        return "noop", None, new_state, stats

    # ---- copy-on-write working set
    a = {k: np.array(v) for k, v in compiled.arrays.items()}
    vocab = list(compiled.entity_vocab)
    vocab_ids = dict(compiled.entity_vocab_ids)
    rvocab = list(compiled.rel_vocab)
    rvocab_ids = dict(compiled.rel_vocab_ids)
    conditions = list(compiled.conditions)
    owners = dict(compiled.target_owners)
    ns = state.clone()
    ns.rule_refs, ns.pol_refs = new_rule_refs, new_pol_refs

    rows_written = 0
    for sid in sorted(affected, key=new_order.index):
        ps = tree[sid]
        old_set = ns.sets[sid]
        if ps.combining_algorithm != old_set.ca:
            raise DeltaIneligible("combining-algorithm-changed")
        for pol_key, pol in ps.combinables.items():
            if pol is None:
                continue
            prev_ca = old_set.pol_ca.get(pol_key)
            if prev_ca is not None and prev_ca != pol.combining_algorithm:
                raise DeltaIneligible("combining-algorithm-changed")
        if len(ps.combinables) > caps.KP:
            raise DeltaIneligible("capacity-policies")
        for pol in ps.combinables.values():
            if pol is not None and len(pol.combinables) > caps.KR:
                raise DeltaIneligible("capacity-rules")

        s = old_set.slot
        old_rows = dict(old_set.rows)
        old_conds = dict(old_set.conds)
        new_set = SetState(slot=s, ca=ps.combining_algorithm)
        ns.sets[sid] = new_set
        table = _DeltaTargetTable(
            a, ns, new_set, old_rows, compiled.interner, urns,
            vocab, vocab_ids, rvocab, rvocab_ids,
        )
        cond_sink = _DeltaConditionSink(ns, new_set, old_conds, conditions)
        clear_set_slot(a, s)
        reason = lower_set_into(a, s, ps, table, cond_sink, caps.KP, caps.KR)
        if reason or table.unsupported:
            raise DeltaIneligible(
                f"unsupported:{reason or table.unsupported}"
            )
        for pol_key, pol in ps.combinables.items():
            if pol is not None:
                new_set.pol_ca[pol_key] = pol.combining_algorithm
        # free rows of deleted/target-less nodes; deleted conditioned rules
        # would shrink the condition list -> ineligible
        for owner, row in old_rows.items():
            if owner not in table.claimed:
                ns.free_rows.append(row)
                owners.pop(owner, None)
        for owner in old_conds:
            if owner not in cond_sink.claimed:
                raise DeltaIneligible("condition-removed")
        for owner, row in new_set.rows.items():
            owners[owner] = row
        rows_written += table.rows_written

    # ---- post-patch topology guards: the compiled program variant must
    # not change (with_hr selection, prefilter activation threshold)
    if _needs_hr(a) != state.needs_hr:
        raise DeltaIneligible("hr-topology-changed")
    if _needs_rel(a) != state.needs_rel:
        # with_rel selects a different program variant (tree_needs_rel)
        raise DeltaIneligible("rel-topology-changed")
    n_rules = int(a["rule_valid"].sum())
    if (n_rules >= _prefilter_threshold()) != state.prefilter_active:
        raise DeltaIneligible("prefilter-threshold-crossed")

    stats["sets_patched"] = len(affected)
    stats["target_rows_written"] = rows_written
    # the set SLOTS this patch rewrote: the pod-sharded kernel
    # (parallel/pod_shard.py) maps slots to owning shards and re-slices
    # only those, leaving every other shard's host tables untouched
    stats["patched_slots"] = sorted(ns.sets[sid].slot for sid in affected)
    new_compiled = replace(
        compiled,
        arrays=a,
        conditions=conditions,
        entity_vocab=vocab,
        entity_vocab_ids=vocab_ids,
        rel_vocab=rvocab,
        rel_vocab_ids=rvocab_ids,
        target_owners=owners,
    )
    return "patch", new_compiled, ns, stats


# ------------------------------------------------------------ canonical form

_T_BOOL = {"t_has_role", "t_has_scoping", "t_hr_check", "t_skip_acl",
           "t_has_props"}
_T_INT = {"t_n_subjects", "t_n_res"}
_T_VOCAB = {"t_ent_w"}


def _canon_target_row(compiled: CompiledPolicies, idx: int) -> tuple:
    a = compiled.arrays
    interner = compiled.interner

    def s(i):
        i = int(i)
        return None if i < 0 else interner.string(i)

    out = {}
    for name, key, _dtype in TARGET_COLUMNS:
        v = np.asarray(a[name][int(idx)])
        if name in _T_BOOL:
            out[key] = bool(v)
        elif name in _T_INT:
            out[key] = int(v)
        elif name in _T_VOCAB:
            out[key] = tuple(
                None if int(w) < 0 else compiled.entity_vocab[int(w)]
                for w in v
            )
        elif v.ndim:
            out[key] = tuple(s(x) for x in v)
        else:
            out[key] = s(v)
    rs = int(a["t_rs_idx"][int(idx)])
    out["rs"] = (s(a["hrv_role"][rs]), s(a["hrv_scope"][rs]))
    return tuple(sorted(out.items()))


def _rstrip_none(items: list) -> tuple:
    while items and items[-1] is None:
        items.pop()
    return tuple(items)


def canonical_tables(compiled: CompiledPolicies) -> tuple:
    """Representation-free decode of compiled tables: slot layout, intern
    ids, target-row numbering, vocab ordering and padding are erased;
    everything the kernels can observe is kept.  Patched tables equal a
    fresh compile of the same tree in this form (the JAX package's
    ``tests/test_delta.canonical_tables``)."""
    a = compiled.arrays
    out = []
    for s in range(compiled.S):
        if not a["set_valid"][s]:
            continue
        pols = []
        for kp in range(compiled.KP):
            if not a["pol_valid"][s, kp]:
                pols.append(None)
                continue
            rules = []
            for kr in range(compiled.KR):
                if not a["rule_valid"][s, kp, kr]:
                    rules.append(None)
                    continue
                cond = None
                ci = int(a["rule_cond"][s, kp, kr])
                if ci >= 0:
                    cc = compiled.conditions[ci]
                    cond = (cc.condition, repr(cc.context_query))
                rules.append((
                    int(a["rule_effect"][s, kp, kr]),
                    bool(a["rule_cacheable_raw"][s, kp, kr]),
                    bool(a["rule_cacheable_eff"][s, kp, kr]),
                    _canon_target_row(compiled, a["rule_target"][s, kp, kr])
                    if a["rule_has_target"][s, kp, kr] else None,
                    cond,
                ))
            pols.append((
                int(a["pol_ca"][s, kp]),
                int(a["pol_effect"][s, kp]),
                int(a["pol_eff_ctx"][s, kp]),
                bool(a["pol_cacheable"][s, kp]),
                bool(a["pol_has_subjects"][s, kp]),
                bool(a["pol_has_props"][s, kp]),
                int(a["pol_n_rules"][s, kp]),
                _canon_target_row(compiled, a["pol_target"][s, kp])
                if a["pol_has_target"][s, kp] else None,
                _rstrip_none(rules),
            ))
        out.append((
            int(a["set_ca"][s]),
            _canon_target_row(compiled, a["set_target"][s])
            if a["set_has_target"][s] else None,
            _rstrip_none(pols),
        ))
    return tuple(out)
