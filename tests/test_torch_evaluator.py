"""The port's HybridEvaluator against the JAX package's HybridEvaluator.

Both evaluators run without a decision cache, and the JAX one with
``delta_enabled=False`` (a full compile per refresh, the only refresh path
the port has).  The port runs on ``device="cpu"``.  Every response must
agree in decision, ``evaluation_cacheable``, operation status code and
message, and obligations, for kernel rows and oracle-served rows alike.
"""

import random

import pytest
import torch

import access_control_srv_tpu_torch.models as tmodels
from access_control_srv_tpu import models as jmodels
from access_control_srv_tpu.srv.evaluator import HybridEvaluator as JaxEvaluator
from access_control_srv_tpu_torch.ops import PrefilteredKernel
from access_control_srv_tpu_torch.ops import kernel as tkernel
from access_control_srv_tpu_torch.srv.evaluator import HybridEvaluator

from .test_torch_kernel import engines_from_doc
from .test_torch_carryover import (
    build_request,
    make_engines,
    request_spec,
    spec_grid,
)
from .utils import URNS, build_request as jax_build_request

EVAL_FIXTURES = [
    "basic_policies.yml", "policy_targets.yml", "policy_set_targets.yml",
    "role_scopes.yml", "hr_disabled.yml", "conditions.yml",
    "acl_policies.yml", "props_single.yml", "props_rules_noprop.yml",
    "props_multi_rules.yml", "props_multi_rules_entities.yml",
    "ops_multi.yml", "default_policies.yml", "seed_data",
]


def _base_spec(**kw):
    org = "urn:restorecommerce:acs:model:organization.Organization"
    base = dict(subject_id="ada", subject_role="member",
                role_scoping_entity=org, role_scoping_instance="Org1",
                resource_type=org, resource_id="id-0",
                action_type=URNS["read"], owner_indicatory_entity=org,
                owner_instance="Org1")
    base.update(kw)
    return request_spec(jax_build_request(**base))


def oracle_specs() -> list[dict]:
    """Rows the kernel cannot represent, served by the oracle: no target,
    an unresolved token subject, role associations without HR scopes."""
    specs = [{"target": None, "context": {"subject": {"id": "ada"}}}]
    tok = _base_spec()
    tok["context"]["subject"]["token"] = "opaque-token"
    noscope = _base_spec()
    del noscope["context"]["subject"]["hierarchical_scopes"]
    return specs + [tok, noscope]


def wide_specs() -> list[dict]:
    """Rows beyond the floor caps, which the evaluator splits into a second,
    wider batch: one past every cap (oracle-served), one with six entity
    runs (kernel-eligible at the wider shape)."""
    org = "urn:restorecommerce:acs:model:organization.Organization"
    user = "urn:restorecommerce:acs:model:user.User"
    wide = _base_spec()
    wide["target"]["subjects"] += [
        {"id": URNS["subjectID"], "value": f"x{i}", "attributes": []}
        for i in range(40)
    ]
    deep = _base_spec(resource_type=[org, user] * 3,
                      resource_id=[f"id-{i}" for i in range(6)])
    return [wide, deep]


def response_key(resp):
    st = resp.operation_status
    return (resp.decision, resp.evaluation_cacheable, st.code, st.message,
            [o.to_dict() for o in resp.obligations or []])


def compare(name, specs, engines=None):
    jeng, teng = engines or make_engines(name)
    jev = JaxEvaluator(jeng, delta_enabled=False)
    tev = HybridEvaluator(teng, device="cpu")
    want = jev.is_allowed_batch([build_request(s, jmodels) for s in specs])
    got = tev.is_allowed_batch([build_request(s, tmodels) for s in specs])
    assert len(got) == len(want) == len(specs)
    for i, (w, g) in enumerate(zip(want, got)):
        assert response_key(g) == response_key(w), (name, i)
    return tev, got


@pytest.mark.parametrize("name", EVAL_FIXTURES)
def test_is_allowed_batch_matches_jax(name):
    specs = spec_grid(n=64) + oracle_specs()
    random.Random(5).shuffle(specs)
    tev, _ = compare(name, specs)
    assert tev.kernel_active


@pytest.mark.parametrize("name", ["role_scopes.yml", "acl_policies.yml"])
def test_mixed_traffic_split_matches_jax(name):
    """Floor-fitting rows and wide rows go in two batches; responses come
    back in request order and equal the JAX evaluator's."""
    specs = spec_grid(n=32, seed=13) + oracle_specs() + wide_specs()
    random.Random(6).shuffle(specs)
    compare(name, specs)


def abort_doc():
    """A tree whose first rule's condition raises for members reading: the
    row aborts with an error status in flat rule order."""
    ca = "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:"
    member_rule = {
        "subjects": [{"id": URNS["role"], "value": "member"}],
        "actions": [{"id": URNS["actionID"], "value": URNS["read"]}],
    }
    return {"policy_sets": [{
        "id": "abort", "combining_algorithm": ca + "deny-overrides",
        "policies": [{
            "id": "abort-p", "combining_algorithm": ca + "first-applicable",
            "rules": [
                {"id": "raises", "effect": "PERMIT", "target": member_rule,
                 "condition": "context.subject.nonexistent_field == 1"},
                {"id": "plain", "effect": "PERMIT"},
            ],
        }],
    }]}


def test_condition_abort_messages_match():
    """A rule whose condition raises aborts with an error status: kernel
    rows recover the message from the encoder's cached condition error,
    and must equal the JAX evaluator."""
    specs = spec_grid(n=96, seed=11)
    _, got = compare("abort", specs, engines_from_doc(abort_doc()))
    aborted = [r for r in got if r.operation_status.code != 200]
    assert aborted and all(r.operation_status.message for r in aborted)


def test_single_request_path():
    jeng, teng = make_engines("role_scopes.yml")
    jev = JaxEvaluator(jeng, delta_enabled=False)
    tev = HybridEvaluator(teng, device="cpu")
    for spec in spec_grid(n=12):
        w = jev.is_allowed(build_request(spec, jmodels))
        g = tev.is_allowed(build_request(spec, tmodels))
        assert response_key(g) == response_key(w)


def test_refresh_after_mutation():
    jeng, teng = make_engines("basic_policies.yml")
    jev = JaxEvaluator(jeng, delta_enabled=False)
    tev = HybridEvaluator(teng, device="cpu")
    for eng in (jeng, teng):
        ps = next(iter(eng.policy_sets.values()))
        pol = next(iter(ps.combinables.values()))
        rule = next(iter(pol.combinables.values()))
        rule.effect = "DENY" if rule.effect == "PERMIT" else "PERMIT"
    jev.refresh(wait=True)
    tev.refresh(wait=True)
    specs = spec_grid(n=64, seed=21)
    want = jev.is_allowed_batch([build_request(s, jmodels) for s in specs])
    got = tev.is_allowed_batch([build_request(s, tmodels) for s in specs])
    assert [response_key(g) for g in got] == [response_key(w) for w in want]


def engines_512():
    """The 511-rule scoped tree plus one rule: the smallest tree on the
    signature path, in both packages."""
    engines = make_engines("scoped_511")
    for eng in engines:
        ps = next(iter(eng.policy_sets.values()))
        pol = next(iter(ps.combinables.values()))
        pol.combinables["extra-rule"] = next(iter(pol.combinables.values()))
    return engines


def test_refusals():
    # relation-path trees, refused before the ReBAC slice, are served and
    # equal the JAX evaluator with a tuple store attached to each
    from access_control_srv_tpu.srv.relations import (
        RelationTupleStore as JaxStore,
    )
    from access_control_srv_tpu_torch.srv.relations import RelationTupleStore

    doc = "urn:restorecommerce:acs:model:document.Document"
    jeng, teng = make_engines("relation_policies.yml")
    jev = JaxEvaluator(jeng, delta_enabled=False)
    tev = HybridEvaluator(teng, device="cpu")
    for ev, store in ((jev, JaxStore()), (tev, RelationTupleStore())):
        ev.attach_relation_store(store)
        store.create([(doc, "doc1", "viewer", "alice")])
    specs = [request_spec(jax_build_request(
        subject_id=s, resource_type=doc, resource_id=d,
        action_type=URNS["read"]))
        for s in ("alice", "bob") for d in ("doc1", "doc2")]
    want = jev.is_allowed_batch([build_request(s, jmodels) for s in specs])
    got = tev.is_allowed_batch([build_request(s, tmodels) for s in specs])
    assert [response_key(g) for g in got] == [response_key(w) for w in want]
    assert [g.decision for g in got] == ["PERMIT", "DENY", "DENY", "DENY"]
    # the 512-rule tree is served now, through the signature path, and
    # equals the JAX evaluator
    specs = spec_grid(n=16, seed=4)
    tev, _ = compare("scoped_512", specs, engines_512())
    assert isinstance(tev._kernel, PrefilteredKernel) and tev._kernel.active
    # explain, refused before the explain slice, is served: every row's
    # _rule_id equals the JAX evaluator's
    jeng, teng = make_engines("basic_policies.yml")
    specs = spec_grid(n=32, seed=8)
    jev = JaxEvaluator(jeng, delta_enabled=False, explain=True)
    tev = HybridEvaluator(teng, device="cpu", explain=True)
    want = jev.is_allowed_batch([build_request(s, jmodels) for s in specs])
    got = tev.is_allowed_batch([build_request(s, tmodels) for s in specs])
    assert [getattr(g, "_rule_id", None) for g in got] == \
        [getattr(w, "_rule_id", None) for w in want]
    assert any(getattr(g, "_rule_id", None) for g in got)
    # a mesh, refused before the multi-device slice, is served: on a
    # 1-rank mesh the evaluator equals the JAX evaluator on a 1-device
    # mesh (multi-rank meshes: tests/test_torch_mesh.py)
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from access_control_srv_tpu_torch.parallel import make_mesh

    jeng, teng = make_engines("role_scopes.yml")
    jev = JaxEvaluator(jeng, delta_enabled=False,
                       mesh=Mesh(np.array(jax.devices()[:1]), ("data",)))
    tev = HybridEvaluator(teng, mesh=make_mesh(device="cpu"))
    assert isinstance(tev._kernel, PrefilteredKernel)
    assert tev._kernel.mesh is tev.mesh
    specs = spec_grid(n=32, seed=4)
    want = jev.is_allowed_batch([build_request(s, jmodels) for s in specs])
    got = tev.is_allowed_batch([build_request(s, tmodels) for s in specs])
    assert [response_key(g) for g in got] == [response_key(w) for w in want]


def test_device_none_raises_without_cuda(monkeypatch):
    _, teng = make_engines("basic_policies.yml")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        HybridEvaluator(teng)


def test_scoped_tree_main_path_exact():
    """The 511-rule scoped tree (the card's main-path tree) at a small
    batch: the port's evaluator against the JAX evaluator."""
    rng = random.Random(9)
    specs = spec_grid(n=24, seed=9) + oracle_specs() + wide_specs()
    rng.shuffle(specs)
    tev, _ = compare("scoped_511", specs)
    assert tev._compiled.n_rules == 511
    assert tkernel.tree_needs_hr(tev._compiled.arrays)


def test_large_tree_mixed_traffic_matches_jax():
    """A tree above MIN_RULES with mixed traffic: signature batches (no
    ACL pairs, no properties), batches with ACL rows (the per-row
    kernel), oracle-served and wide rows, and a second pass over warm
    caches.  Every response equals the JAX evaluator's."""
    import chip_smoke

    jeng, teng = engines_512()
    jev = JaxEvaluator(jeng, delta_enabled=False)
    tev = HybridEvaluator(teng, device="cpu")
    rng = random.Random(31)
    sig = [request_spec(r) for r in chip_smoke.grid_requests(
        rng, 24, stress=True, acl=False)]
    mixed = [request_spec(r) for r in chip_smoke.grid_requests(
        rng, 24, stress=True)] + oracle_specs() + wide_specs()
    for specs in (sig, mixed, sig):
        want = jev.is_allowed_batch([build_request(s, jmodels) for s in specs])
        got = tev.is_allowed_batch([build_request(s, tmodels) for s in specs])
        assert [response_key(g) for g in got] == [response_key(w)
                                                  for w in want]
    kern = tev._kernel
    assert kern.active and len(kern._bits) >= 1 and kern._stacks
