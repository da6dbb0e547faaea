"""Explain mode of the port against the JAX package's.

The provenance code ``(flat_pos << 2) | kind`` (``srv/explain.py``) is the
fourth int32 output of every kernel the JAX package runs with
``explain=True``.  Here the same compiled tables and encoded batch, made by
the JAX package, go through the JAX kernel on the CPU and the port's kernel
on ``device="cpu"`` (its plain PyTorch versions; the CUDA kernels are held
against those on the card by ``chip_smoke.py`` and on the CPU by the
``*_cuda_source`` tests): all four outputs must be exactly equal
(tolerance 0).  The raw codes are compared, not only their decoding, on
trees edited to reach the recovery's edge paths: an unknown (ABSENT)
combining algorithm at either level, a winning set whose selected policy
did not contribute, no-rules policies.  The decoded provenance is held
against the oracle's ``_rule_id`` as ``tests/test_explain.py`` holds the
JAX kernels.

The sharded kernels (K6-K8) run in one 4-rank gloo world on the CPU
(``tests/torch_world.py``) against the JAX kernels on the conftest's
virtual devices.  The serving evaluator's ``_rule_id`` / ``_explain`` (and
the relation witnesses) are compared with the JAX evaluator's and the
oracle's.
"""

import copy
import random
from dataclasses import replace

import numpy as np
import pytest

import access_control_srv_tpu_torch.models as tmodels
from access_control_srv_tpu import models as jmodels
from access_control_srv_tpu.ops import DecisionKernel as JaxDense
from access_control_srv_tpu.ops import PrefilteredKernel as JaxPrefiltered
from access_control_srv_tpu.ops import compile_policies as jcompile
from access_control_srv_tpu.ops import encode_requests as jencode
from access_control_srv_tpu.parallel.mesh import (
    ShardedDecisionKernel as JaxMeshDense,
)
from access_control_srv_tpu.parallel.pod_shard import (
    PodShardedKernel as JaxPodSharded,
)
from access_control_srv_tpu.parallel.rule_shard import (
    RuleShardedKernel as JaxRuleSharded,
)
from access_control_srv_tpu.srv.evaluator import HybridEvaluator as JaxEvaluator
from access_control_srv_tpu.srv.explain import ExplainDecoder as JaxDecoder
from access_control_srv_tpu_torch.ops import DecisionKernel, PrefilteredKernel
from access_control_srv_tpu_torch.ops import compile_policies as tcompile
from access_control_srv_tpu_torch.parallel import (
    PodShardedKernel,
    RuleShardedKernel,
    ShardedDecisionKernel,
    make_mesh2,
)
from access_control_srv_tpu_torch.srv.evaluator import HybridEvaluator
from access_control_srv_tpu_torch.srv.explain import (
    KIND_ABORT,
    KIND_POLICY,
    KIND_RULE,
    ExplainDecoder,
    explain_capacity_ok,
)

from .test_explain import FIXTURES, assert_explain_parity, fixture_requests
from .test_prefilter import _stress_doc, force_active
from .test_torch_carryover import build_request, make_engines, request_spec
from .test_torch_evaluator import engines_512, response_key
from .test_torch_kernel import combining_case, engines_from_doc
from .test_torch_pod_shard import MIXED_SPECS, mixed_ca_doc
from .test_torch_prefilter import engine_of, stress_requests
from .test_torch_rule_shard import jax_mesh, jax_tree, two_shard_abort_doc
from .torch_world import run_world
from .utils import URNS, make_engine
from .utils import build_request as jax_build_request

ORG = "urn:restorecommerce:acs:model:organization.Organization"

# the unknown-combining-algorithm code (ops/interner.ABSENT)
ABSENT = -1


def assert_codes_equal(want, got, what=""):
    """All four outputs exactly equal, int32."""
    assert len(want) == len(got) == 4, what
    for name, w, g in zip(("decision", "cacheable", "status", "explain"),
                          want, got):
        assert g.dtype == np.int32, (what, name)
        assert np.array_equal(np.asarray(w), g), (what, name)


def port_prefiltered(compiled, **kw):
    """The port's PrefilteredKernel forced onto the signature machinery,
    as ``force_active`` forces the JAX one."""
    kern = PrefilteredKernel(compiled, device="cpu", explain=True, **kw)
    kern.active = True
    kern._dense = None
    return kern


def sig_rows(requests, compiled):
    """The requests without ACL pairs or request properties (the rows the
    signature kernel K3 decides; the rest take K4)."""
    batch = jencode(requests, compiled)
    acl = (batch.arrays["r_acl_ent"] >= 0).any(1)
    props = batch.arrays["r_has_props"]
    return [r for r, a, p in zip(requests, acl, props) if not a and not p]


# ------------------------------------------------------- dense (K1) + K3/K4


@pytest.mark.parametrize("name", FIXTURES)
def test_dense_codes_equal_jax(name):
    engine = make_engine(name)
    compiled = jcompile(engine.policy_sets, engine.urns)
    requests = fixture_requests(name)
    batch = jencode(requests, compiled)
    kern = DecisionKernel(compiled, device="cpu", explain=True)
    assert kern.explain_strides == (compiled.KP, compiled.KR)
    assert_codes_equal(JaxDense(compiled, explain=True).evaluate(batch),
                       kern.evaluate(batch), name)
    assert assert_explain_parity(engine, requests, kern) > 0


@pytest.mark.parametrize("name", FIXTURES)
def test_prefilter_codes_equal_jax(name):
    """The forced signature path: the grid's ACL and property rows take
    K4, the other rows K3; compacted slots map back through
    ``rule_orig_flat`` to the JAX codes exactly."""
    engine = make_engine(name)
    compiled = jcompile(engine.policy_sets, engine.urns)
    requests = fixture_requests(name, seed=11)
    jk = force_active(JaxPrefiltered(compiled, explain=True))
    tk = port_prefiltered(compiled)
    for reqs in (requests, sig_rows(requests, compiled)):
        batch = jencode(reqs, compiled)
        assert_codes_equal(jk.evaluate(batch), tk.evaluate(batch), name)
    assert assert_explain_parity(engine, requests, tk) > 0


def test_stress_tree_signature_path():
    """The ~720-rule stress tree above MIN_RULES, unforced: many
    signature groups, compacted subtrees of different widths."""
    doc, entities, actions = _stress_doc()
    engine = engine_of(doc)
    compiled = jcompile(engine.policy_sets, engine.urns)
    batch = jencode(stress_requests(entities, actions, n=96), compiled)
    tk = PrefilteredKernel(compiled, device="cpu", explain=True)
    assert tk.active
    want = JaxPrefiltered(compiled, explain=True).evaluate(batch)
    got = tk.evaluate(batch)
    assert_codes_equal(want, got)
    assert set((got[3] & 3).tolist()) >= {KIND_RULE}


def edge_case():
    """(tree doc, request specs) for the recovery's edge paths: a set
    whose only policy has no rules but an effect (kind 2 codes); a set
    whose first policy (first-applicable, one manager-only rule) does not
    contribute for members while the second (three rules, so KR is 3)
    does; each set selected by the request's action."""
    pa = "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:"

    def rule(rid, eff, role=None):
        out = {"id": rid, "effect": eff}
        if role:
            out["target"] = {"subjects": [{"id": URNS["role"],
                                           "value": role}]}
        return out

    def target(action):
        return {"actions": [{"id": URNS["actionID"], "value": action}]}

    sets = [
        {"id": "norules", "combining_algorithm": pa + "permit-overrides",
         "target": target("urn:test:action:norules"),
         "policies": [{"id": "np", "combining_algorithm": pa + "deny-overrides",
                       "effect": "PERMIT"}]},
        {"id": "skip0", "combining_algorithm": pa + "first-applicable",
         "target": target("urn:test:action:skip0"),
         "policies": [
             {"id": "m0", "combining_algorithm": pa + "first-applicable",
              "rules": [rule("m0-r", "DENY", "manager")]},
             {"id": "p1", "combining_algorithm": pa + "deny-overrides",
              "rules": [rule("p1-r0", "DENY", "manager"),
                        rule("p1-r1", "PERMIT"), rule("p1-r2", "DENY",
                                                      "guest")]}]},
    ]
    specs = [
        request_spec(jax_build_request(
            subject_id="ada", subject_role=role, resource_type=ORG,
            resource_id="id-0", action_type=action))
        for role in ("member", "manager", "guest")
        for action in ("urn:test:action:norules", "urn:test:action:skip0",
                       URNS["read"])
    ]
    return {"policy_sets": sets}, specs


def edited(compiled, set_ca=False, pol_ca=False):
    """The compile with every set's and/or every policy's combining
    algorithm made unknown (ABSENT): the compiler refuses those on
    populated nodes, so only edited tables reach the selections' default
    branch."""
    arrays = dict(compiled.arrays)
    if set_ca:
        arrays["set_ca"] = np.full_like(arrays["set_ca"], ABSENT)
    if pol_ca:
        arrays["pol_ca"] = np.where(arrays["pol_n_rules"] > 0, ABSENT,
                                    arrays["pol_ca"]).astype(np.int32)
    return replace(compiled, arrays=arrays)


@pytest.mark.parametrize("tree", ["edge", "combining"])
@pytest.mark.parametrize("edit", ["none", "set", "policy", "both"])
def test_edge_codes_equal_jax(edit, tree):
    """Raw codes on the edge paths of both recoveries: the 3-D one clips
    the selected rule slot, the flat one shifts the packed key (a -1
    "last" stays -1) and clips only the ``rule_orig_flat`` lookup.  With
    the set algorithm unknown, policy 0 is selected whether or not it
    contributed; with the policy algorithm unknown, rule slot 0."""
    doc, specs = edge_case() if tree == "edge" else combining_case()
    jeng, _ = engines_from_doc(doc)
    compiled = edited(jcompile(jeng.policy_sets, jeng.urns),
                      set_ca=edit in ("set", "both"),
                      pol_ca=edit in ("policy", "both"))
    requests = [build_request(s, jmodels) for s in specs]
    batch = jencode(requests, compiled)
    dense = DecisionKernel(compiled, device="cpu", explain=True)
    got = dense.evaluate(batch)
    assert_codes_equal(JaxDense(compiled, explain=True).evaluate(batch), got,
                       edit)
    jk = force_active(JaxPrefiltered(compiled, explain=True))
    tk = port_prefiltered(compiled)
    assert_codes_equal(jk.evaluate(batch), tk.evaluate(batch), edit)
    if tree != "edge":
        return
    decoder = ExplainDecoder(jeng.policy_sets, dense.explain_strides)
    kinds = {int(c) & 3 for c in got[3]}
    if edit == "none":
        # the rule-less policy decides some rows, and every code decodes
        assert {KIND_RULE, KIND_POLICY} <= kinds
        assert all(decoder.decode(c) is not None for c in got[3] if c)
    if edit == "set":
        # the first-applicable policy 0 selected without a collected rule:
        # its slot clips to KR - 1, where it has no rule
        assert any(int(c) & 3 == KIND_RULE and decoder.decode(c) is None
                   for c in got[3])


# ------------------------------------------------- sharded kernels (K6-K8)

SHARD_FIXTURES = ["role_scopes.yml", "props_multi_rules_entities.yml",
                  "conditions.yml"]
MERGE4 = [(2, 2), (1, 4)]


def world_cases():
    """The explain cases of the module's 4-rank world: K7 and K8 on the
    fixture trees, the tree whose first abort lies on either shard and
    (K8) the mixed-algorithm stack; K6 at (4, 1); the evaluator with
    ``model_axis`` and ``pod_shards``."""
    from .test_torch_carryover import spec_grid

    def specs_of(name, n, seed):
        return [request_spec(r) for r in fixture_requests(name, n, seed)]

    specs = spec_grid(n=64, seed=31)
    trees = [(name, {"fixture": name}, specs_of(name, 64, 31))
             for name in SHARD_FIXTURES]
    trees.append(("aborts", {"doc": two_shard_abort_doc()},
                  spec_grid(n=48, seed=29)))
    cases = []
    for kind in ("k7", "k8"):
        for tid, tree, sp in trees:
            cases.append({"id": f"{kind}:{tid}", "kind": kind, "tree": tree,
                          "specs": sp, "layouts": MERGE4,
                          "kernel_kw": {"explain": True}})
    cases.append({"id": "k8:mixed", "kind": "k8",
                  "tree": {"doc": mixed_ca_doc()}, "specs": MIXED_SPECS,
                  "layouts": [(1, 4)], "kernel_kw": {"explain": True}})
    cases.append({"id": "k6:role_scopes.yml", "kind": "k6",
                  "tree": {"fixture": "role_scopes.yml"}, "specs": specs,
                  "layouts": [(4, 1)], "kernel_kw": {"explain": True}})
    for tag, kw in (("model_axis", {"model_axis": "model"}),
                    ("pod_shards", {"model_axis": "model", "pod_shards": 4})):
        cases.append({"id": f"ev:{tag}", "kind": "evaluator",
                      "tree": {"fixture": "conditions.yml"},
                      "specs": specs_of("conditions.yml", 48, 17),
                      "layouts": [(1, 4)],
                      "ev_kw": {"explain": True, **kw}})
    return cases


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    cases = world_cases()
    return cases, run_world(tmp_path_factory.mktemp("explain4"), 4,
                            cases)[0]


JAX_KERNEL = {"k6": lambda c, m: JaxMeshDense(c, m, "data", explain=True),
              "k7": lambda c, m: JaxRuleSharded(c, m, explain=True),
              "k8": lambda c, m: JaxPodSharded(c, m, explain=True)}


@pytest.mark.parametrize("cid", [
    f"{kind}:{t}" for kind in ("k7", "k8")
    for t in SHARD_FIXTURES + ["aborts"]] + ["k8:mixed", "k6:role_scopes.yml"])
def test_sharded_codes_equal_jax(world4, cid):
    """Every layout's four outputs equal the JAX kernel's at the same
    (data, model) layout on the eligible rows; every rank holds them.
    K7's codes use the padded global rule extent, K8's the pod tables'."""
    cases, results = world4
    case = next(c for c in cases if c["id"] == cid)
    engine = jax_tree(case["tree"])
    compiled = jcompile(engine.policy_sets, engine.urns)
    batch = jencode([build_request(s, jmodels) for s in case["specs"]],
                    compiled)
    el = batch.eligible
    kinds = set()
    for layout in case["layouts"]:
        jk = JAX_KERNEL[case["kind"]](compiled, jax_mesh(*layout))
        want = jk.evaluate(batch)
        got = results[(cid, tuple(layout))]["out"]
        assert len(want) == len(got) == 4
        for w, g in zip(want, got):
            assert g.dtype == np.int32
            assert np.array_equal(g[el], np.asarray(w)[el]), (cid, layout)
        kinds |= {int(c) & 3 for c in got[3][el]}
        decoder = JaxDecoder(engine.policy_sets, jk.explain_strides)
        for b in np.flatnonzero(el)[:16]:
            want_src = engine.is_allowed(
                build_request(case["specs"][b], jmodels))
            if int(got[2][b]) == 200:
                assert decoder.source(got[3][b]) == getattr(
                    want_src, "_rule_id", None), (cid, layout, b)
    assert (KIND_ABORT if cid.endswith("aborts") else KIND_RULE) in kinds


@pytest.mark.parametrize("tag", ["model_axis", "pod_shards"])
def test_sharded_evaluator_equals_jax(world4, tag):
    """``HybridEvaluator(explain=True)`` with ``model_axis`` (K7) and
    ``pod_shards`` (K8): every rank's ``_rule_id`` / ``_explain`` equal the
    JAX evaluator's at the same layout (its pod path compiles
    capacity-bucketed tables, so the raw codes differ; the decoding does
    not) and the oracle's ``_rule_id``."""
    cases, results = world4
    case = next(c for c in cases if c["id"] == f"ev:{tag}")
    got = results[(case["id"], (1, 4))]
    assert got["kernel"] == {"model_axis": "RuleShardedKernel",
                             "pod_shards": "PodShardedKernel"}[tag]
    engine = jax_tree(case["tree"])
    kw = {k: v for k, v in case["ev_kw"].items() if k != "explain"}
    jev = JaxEvaluator(engine, mesh=jax_mesh(1, 4), explain=True, **kw)
    try:
        requests = [build_request(s, jmodels) for s in case["specs"]]
        want = jev.is_allowed_batch(requests)
    finally:
        jev.shutdown()
    assert got["responses"] == [response_key(w) for w in want]
    assert got["explain"] == [(getattr(w, "_rule_id", None),
                               getattr(w, "_explain", None)) for w in want]
    oracle = [getattr(engine.is_allowed(build_request(s, jmodels)),
                      "_rule_id", None) for s in case["specs"]]
    assert [rid for rid, _ in got["explain"]] == oracle
    assert any(rid is not None for rid, _ in got["explain"])


def test_single_rank_meshes():
    """On a 1-rank mesh each sharded kernel is the single-device program
    with its merge and tail: codes equal the JAX kernels' on a
    1-device mesh."""
    engine = make_engine("conditions.yml")
    compiled = jcompile(engine.policy_sets, engine.urns)
    batch = jencode(fixture_requests("conditions.yml", n=48), compiled)
    mesh = make_mesh2(1, 1, device="cpu")
    for port, jax_kind in ((ShardedDecisionKernel(compiled, mesh, "data",
                                                  explain=True), "k6"),
                           (RuleShardedKernel(compiled, mesh, explain=True),
                            "k7"),
                           (PodShardedKernel(compiled, mesh, explain=True),
                            "k8")):
        want = JAX_KERNEL[jax_kind](compiled, jax_mesh(1, 1)).evaluate(batch)
        assert_codes_equal(want, port.evaluate(batch), jax_kind)


# --------------------------------------------------------- the evaluator


def explain_pairs(responses):
    return [(getattr(r, "_rule_id", None), getattr(r, "_explain", None))
            for r in responses]


@pytest.mark.parametrize("name", ["role_scopes.yml", "basic_policies.yml",
                                  "conditions.yml"])
def test_evaluator_equals_jax_and_oracle(name):
    """Through ``is_allowed_batch``: every row's ``_rule_id`` and
    ``_explain`` equal the JAX evaluator's (kernel backend, explain on),
    and ``_rule_id`` the oracle's; abort rows name the aborting rule in
    ``_explain`` and carry no ``_rule_id``."""
    jeng, teng = make_engines(name)
    specs = [request_spec(r) for r in fixture_requests(name, n=64,
                                                       seed=17)]
    jev = JaxEvaluator(jeng, backend="kernel", explain=True)
    tev = HybridEvaluator(teng, device="cpu", explain=True)
    try:
        want = jev.is_allowed_batch([build_request(s, jmodels)
                                     for s in specs])
    finally:
        jev.shutdown()
    got = tev.is_allowed_batch([build_request(s, tmodels) for s in specs])
    assert [response_key(g) for g in got] == [response_key(w) for w in want]
    assert explain_pairs(got) == explain_pairs(want)
    n_source = 0
    for spec, resp in zip(specs, got):
        expected = teng.is_allowed(build_request(spec, tmodels))
        rid = getattr(resp, "_rule_id", None)
        assert rid == getattr(expected, "_rule_id", None)
        info = getattr(resp, "_explain", None)
        if rid is not None:
            n_source += 1
            assert info is not None and rid in (info["rule"], info["policy"])
        if resp.operation_status.code not in (0, 200) and info is not None:
            assert info["kind"] == "condition_abort" and rid is None
    assert n_source > 0


def test_evaluator_signature_path_equals_jax():
    """The 512-rule tree above MIN_RULES, unforced: signature batches
    (K3) and a batch with ACL rows (K4) through the evaluator, explain
    on, equal to the JAX evaluator's provenance."""
    import chip_smoke

    jeng, teng = engines_512()
    rng = random.Random(41)
    jev = JaxEvaluator(jeng, delta_enabled=False, explain=True)
    tev = HybridEvaluator(teng, device="cpu", explain=True)
    try:
        for acl in (False, True):
            specs = [request_spec(r) for r in chip_smoke.grid_requests(
                rng, 24, stress=True, acl=acl)]
            want = jev.is_allowed_batch([build_request(s, jmodels)
                                         for s in specs])
            got = tev.is_allowed_batch([build_request(s, tmodels)
                                        for s in specs])
            assert [response_key(g) for g in got] == \
                [response_key(w) for w in want]
            assert explain_pairs(got) == explain_pairs(want)
    finally:
        jev.shutdown()
    assert tev._kernel.active and tev._kernel.explain


def test_relation_witnesses_equal_jax():
    """A relation tree with a tuple store: relation-decided rows carry the
    tuple-path witnesses under ``_explain["relation"]``, equal to the JAX
    evaluator's."""
    from .test_torch_relations import (
        VARIANT_OPS,
        VARIANT_SPECS,
        both_stores,
        rel_engines,
    )

    jeng, teng = rel_engines()
    jstore, tstore = both_stores(*VARIANT_OPS)
    jev = JaxEvaluator(jeng, delta_enabled=False, explain=True)
    tev = HybridEvaluator(teng, device="cpu", explain=True)
    jev.attach_relation_store(jstore)
    tev.attach_relation_store(tstore)
    try:
        want = jev.is_allowed_batch([build_request(s, jmodels)
                                     for s in VARIANT_SPECS])
    finally:
        jev.shutdown()
    got = tev.is_allowed_batch([build_request(s, tmodels)
                                for s in VARIANT_SPECS])
    assert [response_key(g) for g in got] == [response_key(w) for w in want]
    assert explain_pairs(got) == explain_pairs(want)
    assert any("relation" in (getattr(g, "_explain", None) or {})
               for g in got)


# ------------------------------------------------------------ fuzz + misc


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_fuzz_random_grids(seed):
    """Randomized grids over three fixtures: the dense codes equal the
    JAX kernel's and decode to the oracle's source."""
    rng = random.Random(seed)
    for name in rng.sample(FIXTURES, 3):
        engine = make_engine(name)
        compiled = jcompile(engine.policy_sets, engine.urns)
        requests = fixture_requests(name, n=48, seed=rng.randrange(1 << 16))
        batch = jencode(copy.deepcopy(requests), compiled)
        kern = DecisionKernel(compiled, device="cpu", explain=True)
        assert_codes_equal(JaxDense(compiled, explain=True).evaluate(batch),
                           kern.evaluate(batch), name)
        assert_explain_parity(engine, requests, kern)


def test_capacity_bound():
    assert explain_capacity_ok(2, 4, 8)
    assert explain_capacity_ok(1024, 64, 64)
    assert not explain_capacity_ok(1 << 14, 1 << 7, 1 << 7)


def test_decoder_defensive_and_equal_to_jax():
    """Corrupt codes decode to None and never raise; every code decodes
    as the JAX package's decoder decodes it."""
    _, teng = make_engines("role_scopes.yml")
    jeng, _ = make_engines("role_scopes.yml")
    compiled = tcompile(teng.policy_sets, teng.urns)
    strides = (compiled.KP, compiled.KR)
    port = ExplainDecoder(teng.policy_sets, strides)
    jax_dec = JaxDecoder(jeng.policy_sets, strides)
    garbage = (0, -1, (1 << 30) | KIND_RULE, (1 << 30) | KIND_POLICY,
               (997 << 2) | KIND_ABORT)
    for code in garbage + tuple(range(0, 4 * compiled.S * compiled.KP
                                      * compiled.KR + 8)):
        assert port.decode(code) == jax_dec.decode(code)
        assert port.source(code) == jax_dec.source(code)
    assert port.decode(0) is None
    assert port.source((1 << 30) | KIND_RULE) is None


def test_explain_off_keeps_three_outputs():
    engine = make_engine("role_scopes.yml")
    compiled = jcompile(engine.policy_sets, engine.urns)
    batch = jencode(fixture_requests("role_scopes.yml", n=16), compiled)
    assert len(DecisionKernel(compiled, device="cpu").evaluate(batch)) == 3
    assert len(DecisionKernel(compiled, device="cpu",
                              explain=True).evaluate(batch)) == 4
    forced = PrefilteredKernel(compiled, device="cpu")
    forced.active, forced._dense = True, None
    assert len(forced.evaluate(batch)) == 3
    assert len(port_prefiltered(compiled).evaluate(batch)) == 4
