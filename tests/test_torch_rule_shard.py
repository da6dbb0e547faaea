"""The port's rule-sharded kernel (K7) against the JAX package's.

``access_control_srv_tpu_torch.parallel.RuleShardedKernel`` runs one rank
per mesh position: ``rule_chunk`` on the rank's rule chunk, one MIN
``all_reduce`` over the ``model`` group, ``shard_tail``, and an all-gather
over ``data``.  Here the ranks are a gloo world on the CPU
(``tests/torch_world.py``; the kernels take their plain versions), and
the JAX kernel runs on the conftest's virtual CPU devices at the same
(data, model) layout: decision, cacheable and status must be equal on the
eligible rows (tolerance 0, integer outputs), and every rank must hold
the whole batch.  Layouts (2, 2), (1, 4) and (4, 1) share one 4-rank
world; (1, 8), where the tail shards hold only padding on the fixture
trees, runs in an 8-rank world.

``partition_rules`` is held byte-equal to the JAX package's.
"""

import numpy as np
import pytest
from jax.sharding import Mesh

from access_control_srv_tpu import models as jmodels
from access_control_srv_tpu.ops import compile_policies as jcompile
from access_control_srv_tpu.ops import encode_requests as jencode
from access_control_srv_tpu.parallel.rule_shard import (
    RuleShardedKernel as JaxRuleSharded,
)
from access_control_srv_tpu.parallel.rule_shard import (
    partition_rules as jax_partition,
)
from access_control_srv_tpu.srv.evaluator import HybridEvaluator as JaxEvaluator
from access_control_srv_tpu.srv.relations import RelationTupleStore as JaxStore
from access_control_srv_tpu_torch.ops import compile_policies as tcompile
from access_control_srv_tpu_torch.parallel.rule_shard import (
    partition_rules as port_partition,
)

from .test_torch_carryover import (
    assert_arrays_equal,
    build_request,
    make_engines,
    spec_grid,
)
from .test_torch_evaluator import response_key
from .test_torch_kernel import engines_from_doc
from .test_torch_relations import NS, rel_specs
from .torch_world import run_world
from .utils import URNS, fixture

FIXTURES = ["role_scopes.yml", "props_multi_rules_entities.yml",
            "conditions.yml"]
LAYOUTS4 = [(2, 2), (1, 4), (4, 1)]
# the layouts with a cross-shard merge (model axis of two ranks or more)
MERGE4 = [(2, 2), (1, 4)]
# the relation fixture's store (tests/test_relations.py
# test_kernel_variants_agree)
REL_OPS = [
    ("set_rewrite", NS, "viewer", [("this",), ("computed_userset", "owner")]),
    ("create", [
        (NS, "doc1", "owner", "alice"),
        (NS, "doc2", "viewer", "bob"),
        (NS, "doc3", "viewer", {"object": {"entity": "group", "id": "g"},
                                "relation": "member"}),
        ("group", "g", "member", "carol"),
    ]),
]
REL_SPECS = rel_specs(["alice", "bob", "carol", "mallory"],
                      ["doc1", "doc2", "doc3", ["doc1", "doc3"]])


def two_shard_abort_doc():
    """Two policy sets of one 8-rule policy each, the first on reads, the
    second on modifies; in each, rules 1 and 5 raise in their condition
    (rule 1 only for members, with the other cacheable flag), so the first
    aborting rule lies in either half of a policy's rules and in either
    set: on different shards of a 2-way split of the rule axis and of the
    set axis."""
    ca = "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:"
    raising = "context.subject.nonexistent_field == 1"
    sets = []
    for s, action in enumerate(("read", "modify")):
        rules = []
        for k in range(8):
            rule = {"id": f"s{s}r{k}", "effect": "DENY" if k % 3 else "PERMIT",
                    "evaluation_cacheable": (k == 1) != bool(s),
                    "target": {"actions": [{"id": URNS["actionID"],
                                            "value": URNS[action]}]}}
            if k == 1:
                rule["target"]["subjects"] = [{"id": URNS["role"],
                                               "value": "member"}]
            if k in (1, 5):
                rule["condition"] = raising
            rules.append(rule)
        sets.append({"id": f"set{s}", "combining_algorithm": ca + "deny-overrides",
                     "policies": [{"id": f"p{s}",
                                   "combining_algorithm": ca + "first-applicable",
                                   "rules": rules}]})
    return {"policy_sets": sets}


def jax_mesh(data: int, model: int) -> Mesh:
    import jax

    devices = np.array(jax.devices()[: data * model]).reshape(data, model)
    return Mesh(devices, ("data", "model"))


def jax_tree(tree: dict):
    """The JAX engine of a world case's tree."""
    if "doc" in tree:
        return engines_from_doc(tree["doc"])[0]
    return make_engines(tree["fixture"])[0]


def world_cases(kind: str, layouts, extra: bool):
    """The kernel cases of one world: the three fixture trees on the grid
    traffic; with ``extra`` also the two-shard abort tree and the
    relation fixture with its store."""
    specs = spec_grid(n=96, seed=53)
    cases = [{"id": name, "kind": kind, "tree": {"fixture": name},
              "specs": specs, "layouts": layouts} for name in FIXTURES]
    if extra:
        cases.append({"id": "aborts", "kind": kind,
                      "tree": {"doc": two_shard_abort_doc()},
                      "specs": spec_grid(n=48, seed=29),
                      "layouts": MERGE4})
        cases.append({"id": "relation", "kind": kind,
                      "tree": {"fixture": "relation_policies.yml"},
                      "specs": REL_SPECS, "store_ops": REL_OPS,
                      "layouts": MERGE4})
    return cases


def jax_outputs(kernel_cls, case, layout):
    """The JAX kernel's outputs on a case at ``layout`` -> (outputs,
    eligible)."""
    engine = jax_tree(case["tree"])
    compiled = jcompile(engine.policy_sets, engine.urns)
    tables = None
    if case.get("store_ops"):
        store = JaxStore()
        for name, *args in case["store_ops"]:
            getattr(store, name)(*args)
        tables = store.tables_for(compiled)
    batch = jencode([build_request(s, jmodels) for s in case["specs"]],
                    compiled, relation_tables=tables)
    return kernel_cls(compiled, jax_mesh(*layout)).evaluate(batch), batch


def assert_world_equal(kernel_cls, results, case, layout):
    want, batch = jax_outputs(kernel_cls, case, layout)
    got = results[(case["id"], tuple(layout))]
    el = batch.eligible
    assert np.array_equal(got["eligible"], el)
    for w, g in zip(want, got["out"]):
        assert g.dtype == np.int32 and g.shape == w.shape
        assert np.array_equal(g[el], w[el])
    return got, want, el


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    cases = world_cases("k7", LAYOUTS4, extra=True)
    cases.append({"id": "evaluator", "kind": "evaluator",
                  "tree": {"doc": multi_set_doc()},
                  "specs": spec_grid(n=80, seed=99), "layouts": [(2, 2)],
                  "ev_kw": {"model_axis": "model"}})
    return cases, run_world(tmp_path_factory.mktemp("rule4"), 4, cases)[0]


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    cases = world_cases("k7", [(1, 8)], extra=False)
    return cases, run_world(tmp_path_factory.mktemp("rule8"), 8, cases)[0]


def multi_set_doc():
    """The multi-set tree as one document: the three fixture files'
    policy sets, in load order."""
    import yaml

    sets = []
    for name in ("basic_policies.yml", "policy_targets.yml",
                 "role_scopes.yml"):
        with open(fixture(name)) as fh:
            sets += yaml.safe_load(fh)["policy_sets"]
    return {"policy_sets": sets}


@pytest.mark.parametrize("layout", LAYOUTS4)
@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_trees_4_ranks(world4, name, layout):
    cases, results = world4
    case = next(c for c in cases if c["id"] == name)
    got, _, _ = assert_world_equal(JaxRuleSharded, results, case, layout)
    # one MIN over model (when it has two ranks or more), one gather over
    # data (likewise) per batch
    nd, nm = layout
    assert got["collectives"]["all_reduce"] == int(nm > 1)
    assert got["collectives"]["all_gather"] == int(nd > 1)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_trees_8_ranks(world8, name):
    """(1, 8): more shards than rule columns, the tail shards hold only
    padding (``partition_rules``' clamp)."""
    cases, results = world8
    case = next(c for c in cases if c["id"] == name)
    engine = jax_tree(case["tree"])
    assert jcompile(engine.policy_sets, engine.urns).KR < 8
    assert_world_equal(JaxRuleSharded, results, case, (1, 8))


@pytest.mark.parametrize("layout", MERGE4)
def test_aborts_in_two_shards(world4, layout):
    """The first aborting rule is found across shards in global flat
    order over the padded rule extent: rows abort on either shard."""
    cases, results = world4
    case = next(c for c in cases if c["id"] == "aborts")
    got, _, el = assert_world_equal(JaxRuleSharded, results, case, layout)
    status = got["out"][2][el]
    assert (status != 200).sum() >= 2
    assert len(set(got["out"][1][el][status != 200].tolist())) == 2


@pytest.mark.parametrize("layout", MERGE4)
def test_relation_fixture(world4, layout):
    """``with_rel`` on shards: ``t_rel_idx`` stays a global vocab index,
    the closure planes follow the data slice."""
    cases, results = world4
    case = next(c for c in cases if c["id"] == "relation")
    got, _, el = assert_world_equal(JaxRuleSharded, results, case, layout)
    assert (got["out"][0][el] == 1).any()


def test_evaluator_model_axis(world4):
    """``HybridEvaluator(mesh, model_axis="model")`` serves through the
    rule-sharded kernel; every response equals the JAX evaluator's on
    the same layout."""
    cases, results = world4
    case = next(c for c in cases if c["id"] == "evaluator")
    got = results[("evaluator", (2, 2))]
    assert got["kernel"] == "RuleShardedKernel"
    engine = jax_tree(case["tree"])
    jev = JaxEvaluator(engine, delta_enabled=False, mesh=jax_mesh(2, 2),
                       model_axis="model")
    want = jev.is_allowed_batch([build_request(s, jmodels)
                                 for s in case["specs"]])
    assert got["responses"] == [response_key(w) for w in want]


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("name", FIXTURES + ["seed_data"])
def test_partition_byte_equal(name, n_shards):
    jeng, teng = make_engines(name)
    jp = jax_partition(jcompile(jeng.policy_sets, jeng.urns), n_shards)
    tp = port_partition(tcompile(teng.policy_sets, teng.urns), n_shards)
    assert_arrays_equal(jp.arrays, tp.arrays, name)
    assert tp.kr_local == jp.kr_local
    assert tp.kr_offsets.tobytes() == jp.kr_offsets.tobytes()


def test_explain_matches_jax_single_rank():
    """Explain mode, refused before the explain slice: on a 1-rank mesh
    the four outputs equal the JAX kernel's on a 1-device mesh, the codes
    in the strides (KP, kr_total).  (Multi-rank layouts:
    tests/test_torch_explain.py.)"""
    from access_control_srv_tpu_torch.parallel import RuleShardedKernel
    from access_control_srv_tpu_torch.parallel.mesh import make_mesh2

    jeng, _ = make_engines("role_scopes.yml")
    jc = jcompile(jeng.policy_sets, jeng.urns)
    batch = jencode([build_request(s, jmodels)
                     for s in spec_grid(n=32, seed=7)], jc)
    jk = JaxRuleSharded(jc, jax_mesh(1, 1), explain=True)
    tk = RuleShardedKernel(jc, make_mesh2(1, 1, device="cpu"), explain=True)
    assert tk.explain_strides == jk.explain_strides
    want, got = jk.evaluate(batch), tk.evaluate(batch)
    assert len(got) == 4
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g)
