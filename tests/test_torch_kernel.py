"""The port's DecisionKernel against the JAX package's DecisionKernel.

The same requests (built from one dict spec in both packages) are compiled
and encoded by each package and decided by each kernel; the port runs on
``device="cpu"``, i.e. its plain PyTorch version (``ops/kernel_ref.py``).
Outputs are int32 codes and must be exactly equal (tolerance 0).  The
CUDA kernel itself runs only on a card: ``chip_smoke.py`` holds it
against the plain version there.
"""

import random

import numpy as np
import pytest
import torch

import access_control_srv_tpu_torch.models as tmodels
from access_control_srv_tpu import core as jcore
from access_control_srv_tpu import models as jmodels
from access_control_srv_tpu.ops import DecisionKernel as JaxKernel
from access_control_srv_tpu.ops import compile_policies as jcompile
from access_control_srv_tpu.ops import encode_requests as jencode
from access_control_srv_tpu_torch import core as tcore
from access_control_srv_tpu_torch.ops import DecisionKernel
from access_control_srv_tpu_torch.ops import compile_policies as tcompile
from access_control_srv_tpu_torch.ops import encode_requests as tencode
from access_control_srv_tpu_torch.ops import kernel as tkernel
from access_control_srv_tpu_torch.ops.carry import batch_from_numpy, tables_from_numpy
from access_control_srv_tpu_torch.ops.kernel_ref import decide_dense_ref

from .test_fuzz_extended import _extended_requests, _extended_tree
from .test_kernel_differential import (
    _owner_bit_requests,
    _random_policy_tree,
    _scoped_role_tree,
)
from .test_torch_carryover import (
    build_request,
    make_engines,
    request_spec,
    spec_grid,
)
from .utils import URNS, fixture
from .utils import build_request as jax_build_request

ORG = "urn:restorecommerce:acs:model:organization.Organization"
USER = "urn:restorecommerce:acs:model:user.User"
BUCKET = "urn:restorecommerce:acs:model:bucket.Bucket"

KERNEL_FIXTURES = [
    "basic_policies.yml", "policy_targets.yml", "policy_set_targets.yml",
    "role_scopes.yml", "hr_disabled.yml", "conditions.yml",
    "acl_policies.yml", "props_single.yml", "props_rules_noprop.yml",
    "props_multi_rules.yml", "props_multi_rules_entities.yml",
    "ops_multi.yml",
]


def engines_from_doc(doc):
    out = []
    for core in (jcore, tcore):
        engine = core.AccessController()
        for ps in core.load_policy_sets(doc):
            engine.update_policy_set(ps)
        out.append(engine)
    return out


def acl_heavy_specs(rng: random.Random, n: int) -> list[dict]:
    """verifyACL-heavy traffic for acl_policies.yml: every action kind,
    org and user ACL entities, instance sets, and HR trees whose nodes
    override the role (the create-path scan's validated / broken state)."""
    owners = ["SuperOrg1", "Org1", "Org2", "Org3", "otherOrg", "OrgX"]
    subjects = ["Alice", "Bob"]

    def random_tree():
        if rng.random() < 0.5:
            return None  # the request builder's default chain

        def node(d, idx):
            out = {"id": rng.choice(owners)
                   + (f"-{idx}" if rng.random() < 0.3 else "")}
            if rng.random() < 0.4:
                out["role"] = rng.choice(["Admin", "SimpleUser", "Other"])
            if d < 3 and rng.random() < 0.6:
                out["children"] = [node(d + 1, i)
                                   for i in range(rng.randint(1, 2))]
            return out

        top = node(0, 0)
        top.setdefault("role", rng.choice(["Admin", "SimpleUser"]))
        return [top]

    specs = []
    for i in range(n):
        kw = dict(
            subject_id=rng.choice(subjects),
            subject_role=rng.choice(["Admin", "SimpleUser"]),
            role_scoping_entity=ORG,
            role_scoping_instance=rng.choice(owners),
            resource_type=BUCKET, resource_id=f"res-{i % 7}",
            action_type=URNS[rng.choice(
                ["create", "read", "modify", "delete", "execute"])],
            owner_indicatory_entity=ORG,
            owner_instance=rng.choice(owners),
            hierarchical_scopes=random_tree(),
        )
        mode = rng.random()
        if mode < 0.5:
            kw.update(acl_indicatory_entity=rng.choice([ORG, USER]),
                      acl_instances=rng.sample(owners + subjects,
                                               rng.randint(1, 4)))
        elif mode < 0.7:
            kw.update(multiple_acl_indicatory_entity=[ORG, USER],
                      org_instances=rng.sample(owners, rng.randint(1, 2)),
                      subject_instances=rng.sample(subjects,
                                                   rng.randint(1, 2)))
        specs.append(request_spec(jax_build_request(**kw)))
    return specs


def regex_reset_case():
    """(tree doc, request specs) where only the regex mode matches: the rule
    entity ``organization.Org`` regex-hits ``organization.OrgUnit`` without
    an exact match, and a later run from a foreign URN prefix resets the
    sticky state (reference: accessController.ts:545-566)."""
    pa = "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:"
    org_re = "urn:restorecommerce:acs:model:organization.Org"
    unit = "urn:restorecommerce:acs:model:organization.OrgUnit"
    foreign = "urn:acme:models:gadget.Gadget"
    doc = {"policy_sets": [{
        "id": "rx", "combining_algorithm": pa + "permit-overrides",
        "policies": [{
            "id": "rx-p", "combining_algorithm": pa + "permit-overrides",
            "rules": [{
                "id": "rx-r", "effect": "PERMIT",
                "target": {"resources": [
                    {"id": URNS["entity"], "value": org_re}]},
            }],
        }],
    }]}
    runs = [[unit], [unit, foreign], [foreign, unit], [unit, USER],
            [foreign], [unit, foreign, unit]]
    specs = [
        request_spec(jax_build_request(
            subject_id="ada", subject_role="member", resource_type=rt,
            resource_id=[f"id-{i}" for i in range(len(rt))],
            action_type=URNS["read"]))
        for rt in runs
    ]
    return doc, specs


def combining_case():
    """(tree doc, request specs) where every first / last choice of the
    combining algorithms shows in the outputs.  One policy set per
    (level, algorithm), selected by the request's action: at the rule
    level one policy whose rules (no targets) both apply, at the set level
    two one-rule policies; the first and the last candidate differ in
    effect or in ``evaluation_cacheable``.  A rule-less policy carrying
    its own effect and a role-targeted rule complete the set."""
    pa = "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:"
    algos = {"DO": pa + "deny-overrides", "PO": pa + "permit-overrides",
             "FA": pa + "first-applicable"}
    pairs = {"DO": [("DENY", True), ("DENY", False)],
             "PO": [("PERMIT", True), ("PERMIT", False)],
             "FA": [("PERMIT", True), ("DENY", False)]}

    def rule(rid, eff, cach, role=None):
        out = {"id": rid, "effect": eff, "evaluation_cacheable": cach}
        if role:
            out["target"] = {"subjects": [{"id": URNS["role"],
                                           "value": role}]}
        return out

    sets, actions = [], []
    for level in ("rule", "set"):
        for name, ca in algos.items():
            action = f"urn:test:action:{level}-{name}"
            actions.append(action)
            sid = f"{level}-{name}"
            if level == "rule":
                policies = [{
                    "id": f"{sid}-p", "combining_algorithm": ca,
                    "rules": [rule(f"{sid}-r{j}", e, c)
                              for j, (e, c) in enumerate(pairs[name])]
                    + [rule(f"{sid}-rm", "PERMIT", True, "manager")],
                }]
            else:
                policies = [
                    {"id": f"{sid}-p{j}", "combining_algorithm": algos["FA"],
                     "rules": [rule(f"{sid}-p{j}-r", e, c)]}
                    for j, (e, c) in enumerate(pairs[name])
                ] + [{"id": f"{sid}-norules", "combining_algorithm": ca,
                      "effect": "PERMIT", "evaluation_cacheable": True}]
            sets.append({
                "id": sid, "combining_algorithm": ca,
                "target": {"actions": [{"id": URNS["actionID"],
                                        "value": action}]},
                "policies": policies,
            })
    specs = [
        request_spec(jax_build_request(
            subject_id="ada", subject_role=role, role_scoping_entity=ORG,
            role_scoping_instance="Org1", resource_type=ORG,
            resource_id="id-0", action_type=action))
        for role in ("member", "manager")
        for action in actions + [URNS["read"]]
    ]
    return {"policy_sets": sets}, specs


def run_both(jeng, teng, specs):
    """(JAX outputs, port outputs, JAX batch) for one request list."""
    jc = jcompile(jeng.policy_sets, jeng.urns)
    tc = tcompile(teng.policy_sets, teng.urns)
    assert jc.supported, jc.unsupported_reason
    jb = jencode([build_request(s, jmodels) for s in specs], jc)
    tb = tencode([build_request(s, tmodels) for s in specs], tc)
    want = JaxKernel(jc).evaluate(jb)
    got = DecisionKernel(tc, device="cpu").evaluate(tb)
    return want, got, jb


def assert_exact(want, got, what=""):
    for name, w, g in zip(("decision", "cacheable", "status"), want, got):
        assert g.dtype == np.int32, (what, name)
        assert np.array_equal(np.asarray(w), g), (what, name)


@pytest.mark.parametrize("name", KERNEL_FIXTURES)
def test_fixture_grid_exact(name):
    jeng, teng = make_engines(name)
    want, got, jb = run_both(jeng, teng, spec_grid())
    assert_exact(want, got, name)
    assert jb.eligible.sum() > 100


def test_multi_fixture_tree_exact():
    """Several fixtures in one engine: multiple sets, last-set-wins."""
    engines = []
    for core in (jcore, tcore):
        engine = core.AccessController()
        for name in ("basic_policies.yml", "policy_targets.yml",
                     "role_scopes.yml"):
            for ps in core.load_policy_sets_from_file(fixture(name)):
                engine.update_policy_set(ps)
        engines.append(engine)
    want, got, _ = run_both(*engines, spec_grid(seed=11))
    assert_exact(want, got)


def test_randomized_trees_exact():
    """The 12 randomized trees of the JAX package's randomized
    differential, with the same request sweeps."""
    rng = random.Random(1234)
    rounds = 0
    for round_ in range(12):
        jeng, teng = engines_from_doc(_random_policy_tree(rng))
        if not jcompile(jeng.policy_sets, jeng.urns).supported:
            continue
        want, got, _ = run_both(jeng, teng, spec_grid(n=60, seed=1000 + round_))
        assert_exact(want, got, f"round {round_}")
        rounds += 1
    assert rounds >= 8


def test_acl_heavy_exact():
    """The verifyACL create / read-modify-delete scans on ACL-heavy
    traffic."""
    jeng, teng = make_engines("acl_policies.yml")
    want, got, jb = run_both(jeng, teng, acl_heavy_specs(random.Random(17), 200))
    assert_exact(want, got)
    assert jb.eligible.mean() > 0.9


def test_foreign_namespace_trees_exact():
    """Entities from foreign URN namespaces: the regex mode's
    prefix-mismatch reset of the sticky entity state."""
    rng = random.Random(9000)
    for round_ in range(4):
        jeng, teng = engines_from_doc(_extended_tree(rng))
        if not jcompile(jeng.policy_sets, jeng.urns).supported:
            continue
        specs = [request_spec(r) for r in _extended_requests(rng, 48)]
        want, got, jb = run_both(jeng, teng, specs)
        assert_exact(want, got, f"round {round_}")
        assert jb.pfx_neq.any()


def test_combining_algorithms_exact():
    doc, specs = combining_case()
    jeng, teng = engines_from_doc(doc)
    want, got, jb = run_both(jeng, teng, specs)
    assert_exact(want, got)
    assert jb.eligible.all()
    # the first candidate wins everywhere, and it is the cacheable one
    assert list(got[0]) == [2, 1, 1, 2, 1, 1, 0] * 2
    assert list(got[1]) == [1, 1, 1, 1, 1, 1, -1] * 2


def test_regex_prefix_reset_exact():
    doc, specs = regex_reset_case()
    jeng, teng = engines_from_doc(doc)
    want, got, jb = run_both(jeng, teng, specs)
    assert_exact(want, got)
    assert jb.eligible.all()
    # the reset decides: a foreign run after the hit clears it, before
    # the hit it does not
    assert list(got[0]) == [1, 0, 1, 1, 0, 1]


@pytest.mark.parametrize("n_roles", [3, 4, 5, 7, 8, 9, 15, 16, 17])
def test_owner_bitplane_vocab_boundaries_exact(n_roles):
    """Role-scope vocab sizes straddling the owner-bitplane word-packing
    boundaries (several entries per int32 word and entries spanning
    words)."""
    jeng, teng = engines_from_doc(_scoped_role_tree(n_roles))
    rng = random.Random(4000 + n_roles)
    specs = [request_spec(r) for r in _owner_bit_requests(rng, 48)]
    want, got, jb = run_both(jeng, teng, specs)
    assert_exact(want, got, f"n_roles={n_roles}")
    assert tkernel.tree_needs_hr(jcompile(jeng.policy_sets, jeng.urns).arrays)


@pytest.mark.parametrize("with_acl", [False, True])
@pytest.mark.parametrize("name,with_hr", [("basic_policies.yml", False),
                                          ("role_scopes.yml", True)])
def test_variants_exact(name, with_hr, with_acl):
    """Each with_acl x with_hr variant runs and matches: with_hr is the
    tree's, with_acl the batch's (rows with ACL pairs or none)."""
    jeng, teng = make_engines(name)
    jc = jcompile(jeng.policy_sets, jeng.urns)
    assert tkernel.tree_needs_hr(jc.arrays) == with_hr
    specs = []
    for s in spec_grid(n=120, seed=3):
        has_pairs = any(
            (res.get("meta") or {}).get("acls")
            for res in s["context"]["resources"]
        )
        if with_acl or not has_pairs:
            specs.append(s)
    want, got, jb = run_both(jeng, teng, specs)
    assert bool((jb.arrays["r_acl_ent"] >= 0).any()) == with_acl
    assert_exact(want, got)


def test_jax_compiled_arrays_carry_over():
    """The JAX package's compiled tables and encoded batch, carried to the
    port's tensors (ops/carry.py), give the JAX kernel's outputs."""
    jeng, _ = make_engines("role_scopes.yml")
    jc = jcompile(jeng.policy_sets, jeng.urns)
    jb = jencode([build_request(s, jmodels) for s in spec_grid()], jc)
    want = JaxKernel(jc).evaluate(jb)
    got = DecisionKernel(jc, device="cpu").evaluate(jb)
    assert_exact(want, got)
    c = tables_from_numpy(jc.arrays, "cpu")
    b, r = batch_from_numpy(jb, "cpu")
    assert r["r_n_ra"].shape[0] == tkernel.pow2_bucket(b)
    assert all(t.is_contiguous() for t in c.values())
    out = decide_dense_ref(c, r, True, tkernel.tree_needs_hr(jc.arrays))
    for w, g in zip(want, out):
        assert np.array_equal(np.asarray(w), g[:b].numpy())


def test_padding_rows_do_not_change_real_rows():
    jeng, teng = make_engines("acl_policies.yml")
    tc = tcompile(teng.policy_sets, teng.urns)
    kernel = DecisionKernel(tc, device="cpu")
    specs = spec_grid(n=40)
    full = kernel.evaluate(tencode([build_request(s, tmodels) for s in specs], tc))
    for n in (1, 5, 9, 33):
        part = kernel.evaluate(
            tencode([build_request(s, tmodels) for s in specs[:n]], tc))
        for f, p in zip(full, part):
            assert p.shape == (n,)
            # the encoder's adaptive caps may differ per batch; decisions
            # must not
            assert np.array_equal(f[:n], p)


def test_async_thunk_matches_evaluate():
    _, teng = make_engines("conditions.yml")
    tc = tcompile(teng.policy_sets, teng.urns)
    kernel = DecisionKernel(tc, device="cpu")
    batch = tencode([build_request(s, tmodels) for s in spec_grid(n=24)], tc)
    thunk = kernel.evaluate_async(batch)
    assert_exact(kernel.evaluate(batch), thunk())


def test_device_none_raises_without_cuda(monkeypatch):
    _, teng = make_engines("basic_policies.yml")
    tc = tcompile(teng.policy_sets, teng.urns)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        DecisionKernel(tc)
    with pytest.raises(RuntimeError, match="is_available"):
        DecisionKernel(tc, device="cuda")


def test_refusals():
    _, teng = make_engines("basic_policies.yml")
    tc = tcompile(teng.policy_sets, teng.urns)
    with pytest.raises(NotImplementedError, match="explain"):
        DecisionKernel(tc, device="cpu", explain=True)
    _, reng = make_engines("relation_policies.yml")
    rc = tcompile(reng.policy_sets, reng.urns)
    assert rc.supported and tkernel.tree_needs_rel(rc.arrays)
    with pytest.raises(NotImplementedError, match="relation"):
        DecisionKernel(rc, device="cpu")


def test_rule_key_round_trip():
    pos = torch.arange(6, dtype=torch.int32)
    eff = torch.tensor([0, 1, 2, 1, 2, 0], dtype=torch.int32)
    cach = torch.tensor([True, False, True, True, False, False])
    key = tkernel.pack_rule_key(pos, eff, cach)
    e, c = tkernel.unpack_rule_key(key)
    assert torch.equal(e, eff) and torch.equal(c, cach.to(torch.int32))
    assert torch.equal(key >> 3, pos)
    assert int(key.max()) < tkernel.BIG
