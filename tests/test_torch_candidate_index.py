"""The port's candidate index against the JAX package's.

The same randomized trees (exact entities, regex-ish entities with the
literal-substring quirk, operations, property-only and resource-less
targets, no-target rules) are loaded into both packages' engines.  For
every request the two indexes must name the same candidate rules (by rule
id), the port's candidate-filtered oracle walk must equal its unfiltered
walk, and the port evaluator's oracle rows on such a tree must equal the
JAX evaluator's.
"""

import copy

import numpy as np
import pytest

import access_control_srv_tpu.core as jcore
import access_control_srv_tpu_torch.core as tcore
import access_control_srv_tpu_torch.models as tmodels
from access_control_srv_tpu import models as jmodels
from access_control_srv_tpu.core.candidate_index import CandidateIndex as JaxIndex
from access_control_srv_tpu.srv.evaluator import HybridEvaluator as JaxEvaluator
from access_control_srv_tpu_torch.core.candidate_index import CandidateIndex
from access_control_srv_tpu_torch.srv import evaluator as tev_mod
from access_control_srv_tpu_torch.srv.evaluator import HybridEvaluator

from .test_torch_carryover import build_request, make_engines, request_spec
from .test_torch_evaluator import oracle_specs, response_key
from .test_torch_kernel import engines_from_doc
from .utils import URNS

DO = "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:deny-overrides"
PO = "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:permit-overrides"
FA = "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:first-applicable"
ENTS = [f"urn:restorecommerce:acs:model:v{k}.V{k}" for k in range(9)]


def tree_doc(seed: int) -> dict:
    """The randomized tree of the JAX package's candidate-index
    differential (tests/test_candidate_index.build_engine), as a doc."""
    rng = np.random.default_rng(seed)
    policies = []
    rid = 0
    for p in range(30):
        rules = []
        for _ in range(int(rng.integers(1, 25))):
            kind = int(rng.integers(10))
            resources = []
            if kind < 6:
                resources = [{"id": URNS["entity"], "value": ENTS[rid % 9]}]
            elif kind == 6:
                resources = [{"id": URNS["entity"],
                              "value": "urn:restorecommerce:acs:model:V[0-4]"}]
            elif kind == 7:
                resources = [{"id": URNS["operation"],
                              "value": f"op-{rid % 5}"}]
            elif kind == 8:
                resources = [{"id": URNS["property"],
                              "value": ENTS[rid % 9] + "#f"}]
            target = {
                "resources": resources,
                "actions": (
                    [{"id": URNS["actionID"],
                      "value": [URNS["read"], URNS["modify"]][rid % 2]}]
                    if rng.integers(3) else []
                ),
            }
            if rng.integers(2):
                target["subjects"] = [
                    {"id": URNS["role"], "value": f"role-{rid % 6}"}
                ]
            rules.append({
                "id": f"r{rid}",
                "target": target if (resources or target["actions"]
                                     or target.get("subjects")) else None,
                "effect": ["PERMIT", "DENY"][int(rng.integers(2))],
                "evaluation_cacheable": bool(rng.integers(2)),
            })
            rid += 1
        policies.append({"id": f"p{p}",
                         "combining_algorithm": [DO, PO, FA][p % 3],
                         "rules": rules})
    return {"policy_sets": [
        {"id": "s", "combining_algorithm": DO, "policies": policies}
    ]}


def request_specs(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        role = f"role-{int(rng.integers(8))}"
        resources = []
        if rng.integers(4):
            resources.append({"id": URNS["entity"],
                              "value": ENTS[int(rng.integers(9))],
                              "attributes": []})
            resources.append({"id": URNS["resourceID"], "value": "res-1",
                              "attributes": []})
        if not rng.integers(3):
            resources.append({"id": URNS["operation"],
                              "value": f"op-{int(rng.integers(6))}",
                              "attributes": []})
        act = [URNS["read"], URNS["modify"], URNS["create"]][
            int(rng.integers(3))]
        out.append({
            "target": {
                "subjects": [
                    {"id": URNS["role"], "value": role, "attributes": []},
                    {"id": URNS["subjectID"], "value": "u1",
                     "attributes": []}],
                "resources": resources,
                "actions": [{"id": URNS["actionID"], "value": act,
                             "attributes": []}],
            },
            "context": {"resources": [], "subject": {
                "id": "u1",
                "role_associations": [{"role": role, "attributes": []}],
                "hierarchical_scopes": [],
            }},
        })
    return out


def rule_ids(engine) -> dict[int, str]:
    return {
        id(rule): rule.id
        for ps in engine.policy_sets.values() if ps is not None
        for p in ps.combinables.values() if p is not None
        for rule in p.combinables.values() if rule is not None
    }


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_candidates_equal_jax_index(seed):
    jeng, teng = engines_from_doc(tree_doc(seed))
    jidx = JaxIndex(jeng.policy_sets, jeng.urns)
    tidx = CandidateIndex(teng.policy_sets, teng.urns)
    assert jidx.n_rules == tidx.n_rules
    jnames, tnames = rule_ids(jeng), rule_ids(teng)
    skipped = 0
    for spec in request_specs(seed + 100, 150):
        want = jidx.candidates(build_request(spec, jmodels), jeng.urns)
        got = tidx.candidates(build_request(spec, tmodels), teng.urns)
        assert {tnames[i] for i in got} == {jnames[i] for i in want}
        # a repeat is served from the request cache, unchanged
        again = tidx.candidates(build_request(spec, tmodels), teng.urns)
        assert again is got
        skipped += tidx.n_rules - len(got)
    assert skipped > 0, "the index never skipped a rule"
    no_target = tmodels.Request(target=None, context={})
    assert tidx.candidates(no_target, teng.urns) is None


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_filtered_walk_bit_identical(seed):
    _, teng = engines_from_doc(tree_doc(seed))
    index = CandidateIndex(teng.policy_sets, teng.urns)
    for spec in request_specs(seed + 200, 150):
        request = build_request(spec, tmodels)
        cands = index.candidates(request, teng.urns)
        full = teng.is_allowed(copy.deepcopy(request))
        filtered = teng.is_allowed(copy.deepcopy(request),
                                   candidate_rules=cands)
        assert response_key(filtered) == response_key(full)


def test_request_cache_memory_bound(monkeypatch):
    """The request cache is bounded by the total ids it holds: entries
    are evicted before the bound would be crossed."""
    _, teng = engines_from_doc(tree_doc(4))
    index = CandidateIndex(teng.policy_sets, teng.urns)
    for spec in request_specs(5, 60):
        index.candidates(build_request(spec, tmodels), teng.urns)
    assert index._cache_ids == sum(len(v) for v in index._req_cache.values())
    assert index._cache_ids <= 2_000_000


def test_evaluator_oracle_rows_match_jax():
    """On a tree of 256 rules or more the evaluator builds the index and
    its oracle rows (unrepresentable requests) walk the candidates only;
    responses equal the JAX evaluator's."""
    jeng, teng = engines_from_doc(tree_doc(7))
    tev = HybridEvaluator(teng, device="cpu")
    assert tev._cand is not None and tev._cand[0] is teng.policy_sets
    specs = request_specs(11, 48) + oracle_specs()
    jev = JaxEvaluator(jeng, delta_enabled=False)
    want = jev.is_allowed_batch([build_request(s, jmodels) for s in specs])
    got = tev.is_allowed_batch([build_request(s, tmodels) for s in specs])
    assert [response_key(g) for g in got] == [response_key(w) for w in want]


def test_evaluator_survives_hot_swap_and_refresh():
    _, teng = engines_from_doc(tree_doc(7))
    tev = HybridEvaluator(teng, device="cpu")
    request = build_request(request_specs(11, 1)[0], tmodels)
    expected = teng.is_allowed(copy.deepcopy(request))
    assert response_key(tev.is_allowed(copy.deepcopy(request))) == \
        response_key(expected)
    # a tree swap fails the identity guard at once (unfiltered walk) and
    # refresh() rebuilds the index over the new tree
    teng.replace_policy_sets(copy.deepcopy(teng.policy_sets))
    assert tev._cand[0] is not teng.policy_sets
    assert response_key(tev.is_allowed(copy.deepcopy(request))) == \
        response_key(expected)
    tev.refresh(wait=True)
    assert tev._cand[0] is teng.policy_sets
    assert response_key(tev.is_allowed(copy.deepcopy(request))) == \
        response_key(expected)


def test_small_trees_skip_the_index():
    _, teng = make_engines("basic_policies.yml")
    tev = HybridEvaluator(teng, device="cpu")
    assert tev._cand is None
    n = sum(len(p.combinables) for ps in teng.policy_sets.values()
            for p in ps.combinables.values())
    assert n < tev_mod.CANDIDATE_MIN_RULES


def test_unsupported_tree_oracle_path_uses_the_index(monkeypatch):
    """With no kernel (here: the compiler's verdict forced to
    unsupported) every row is an oracle row, candidate-filtered."""
    _, teng = engines_from_doc(tree_doc(8))
    tev = HybridEvaluator(teng, device="cpu")
    tev._kernel = None
    calls = []
    orig = teng.is_allowed

    def spy(request, candidate_rules=None):
        calls.append(candidate_rules)
        return orig(request, candidate_rules=candidate_rules)

    monkeypatch.setattr(teng, "is_allowed", spy)
    specs = request_specs(9, 8)
    got = tev.is_allowed_batch([build_request(s, tmodels) for s in specs])
    assert len(got) == 8 and all(c is not None for c in calls)
    monkeypatch.setattr(teng, "is_allowed", orig)
    want = [teng.is_allowed(build_request(s, tmodels)) for s in specs]
    assert [response_key(g) for g in got] == [response_key(w) for w in want]
