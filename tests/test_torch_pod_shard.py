"""The port's pod-sharded kernel (K8) against the JAX package's.

``access_control_srv_tpu_torch.parallel.PodShardedKernel`` runs one rank
per mesh position: ``set_chunk`` on the rank's set slots, one MIN
``all_reduce`` over ``model``, ``shard_tail``, and an all-gather over
``data``.  The ranks are a gloo world on the CPU (``tests/torch_world.py``,
plain versions of the kernels) and the JAX kernel runs on the conftest's
virtual CPU devices at the same layout: decision, cacheable and status
equal on the eligible rows (tolerance 0), every rank holding the whole
batch.  Layouts (2, 2), (1, 4) and (4, 1) share a 4-rank world, (1, 8) and
(2, 4) an 8-rank world.  The trees: the JAX suite's fixtures, its
mixed-combining-algorithm stack at model 2/4/8, the relation fixture with
its tuple store, and a tree whose first aborting rule lies on either
shard.

Host pieces are held byte-equal to the JAX package's: ``partition_sets``
/ ``slice_shard`` tables and fingerprints, and ``PodShardedKernel.
patched`` fed the JAX delta patcher's compiles (the same owner shards
re-sliced, the others reused by reference, ``shard_identity`` equal).
"""

import numpy as np
import pytest

from access_control_srv_tpu import models as jmodels
from access_control_srv_tpu.ops import compile_policies as jcompile
from access_control_srv_tpu.ops import encode_requests as jencode
from access_control_srv_tpu.parallel.pod_shard import (
    PodShardedKernel as JaxPodSharded,
)
from access_control_srv_tpu.parallel.pod_shard import (
    partition_sets as jax_partition,
)
from access_control_srv_tpu.srv.evaluator import HybridEvaluator as JaxEvaluator
from access_control_srv_tpu_torch.ops import compile_policies as tcompile
from access_control_srv_tpu_torch.parallel.pod_shard import (
    partition_sets as port_partition,
)
from access_control_srv_tpu_torch.parallel.pod_shard import (
    slice_shard as port_slice,
)

from .test_delta import DO, FA, PO, make_request, rule_doc
from .test_torch_carryover import (
    assert_arrays_equal,
    build_request,
    make_engines,
    request_spec,
    spec_grid,
)
from .test_torch_evaluator import response_key
from .test_torch_rule_shard import (
    FIXTURES,
    LAYOUTS4,
    MERGE4,
    assert_world_equal,
    jax_mesh,
    jax_tree,
    world_cases,
)
from .torch_world import run_world


def mixed_ca_doc(n_sets=6, pols_per_set=2, rules_per_pol=3):
    """The JAX suite's mixed-combining-algorithm stack
    (tests/test_pod_shard.py ``_mixed_ca_stack``) as one document: the
    algorithms cycle per set and per policy, so every shard boundary of a
    2/4/8-way split separates sets with different algorithms."""
    cas = [DO, PO, FA]
    sets = []
    rid = 0
    for s in range(n_sets):
        pols = []
        for p in range(pols_per_set):
            rules = []
            for _ in range(rules_per_pol):
                effect = "DENY" if rid % 3 == 0 else "PERMIT"
                rules.append(rule_doc(f"r{rid}", rid % 8, effect=effect,
                                      cacheable=bool(rid % 2)))
                rid += 1
            pols.append({"id": f"p{s}_{p}",
                         "combining_algorithm": cas[(s + p) % 3],
                         "rules": rules})
        sets.append({"id": f"s{s}", "combining_algorithm": cas[s % 3],
                     "policies": pols})
    return {"policy_sets": sets}


MIXED_SPECS = [request_spec(make_request(k, who)) for k in range(8)
               for who in ("u1", "u2")]


def mixed_case(layouts):
    return {"id": "mixed", "kind": "k8", "tree": {"doc": mixed_ca_doc()},
            "specs": MIXED_SPECS, "layouts": layouts}


def _carry(compiled) -> dict:
    return {"arrays": dict(compiled.arrays), "S": compiled.S,
            "KP": compiled.KP, "KR": compiled.KR, "T": compiled.T}


@pytest.fixture(scope="module")
def jax_patch():
    """One CRUD event through the JAX package's pod-sharded delta path
    (tests/test_pod_shard.py ``_pod_stack``, data 2 x model 4): the
    compile before, the patched compile and its patched slots, the JAX
    kernels before and after, and a batch on the patched tree."""
    from .test_pod_shard import _pod_stack

    calls = []
    orig = JaxPodSharded.patched

    def spy(self, new_compiled, patched_slots):
        kernel = orig(self, new_compiled, patched_slots)
        calls.append((self, new_compiled, list(patched_slots), kernel))
        return kernel

    JaxPodSharded.patched = spy
    try:
        _engine, ev, store, n_rules = _pod_stack()
        store.get_resource_service("rule").update(
            [rule_doc("r2", 2, effect="DENY")])
    finally:
        JaxPodSharded.patched = orig
    assert len(calls) == 1
    k0, c1, slots, k1 = calls[0]
    requests = [make_request(k, who) for k in range(n_rules)
                for who in ("u1", "u2")]
    batch = jencode(requests, c1)
    fields = ("B", "arrays", "rgx_set", "pfx_neq", "cond_true",
              "cond_abort", "cond_code", "eligible")
    return {"k0": k0, "k1": k1, "batch": batch, "case": {
        "id": "patch", "kind": "patch", "layouts": [(2, 4)],
        "c0": _carry(k0.compiled), "c1": _carry(c1), "slots": slots,
        "batch": {f: getattr(batch, f) for f in fields}}}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    cases = world_cases("k8", LAYOUTS4, extra=True)
    cases.append(mixed_case([(2, 2), (1, 4)]))
    for delta in (True, False):
        cases.append({"id": f"evaluator delta={delta}", "kind": "evaluator",
                      "tree": {"fixture": "role_scopes.yml"},
                      "specs": spec_grid(n=64, seed=21), "layouts": [(2, 2)],
                      "ev_kw": {"model_axis": "model", "pod_shards": 2,
                                "delta_enabled": delta}})
    return cases, run_world(tmp_path_factory.mktemp("pod4"), 4, cases)[0]


@pytest.fixture(scope="module")
def world8(tmp_path_factory, jax_patch):
    cases = world_cases("k8", [(1, 8)], extra=False)
    cases.append(mixed_case([(1, 8)]))
    cases.append(jax_patch["case"])
    return cases, run_world(tmp_path_factory.mktemp("pod8"), 8, cases)


@pytest.mark.parametrize("layout", LAYOUTS4)
@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_trees_4_ranks(world4, name, layout):
    cases, results = world4
    case = next(c for c in cases if c["id"] == name)
    got, _, _ = assert_world_equal(JaxPodSharded, results, case, layout)
    nd, nm = layout
    assert got["collectives"]["all_reduce"] == int(nm > 1)
    assert got["collectives"]["all_gather"] == int(nd > 1)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_trees_8_ranks(world8, name):
    cases, ranks = world8
    case = next(c for c in cases if c["id"] == name)
    assert_world_equal(JaxPodSharded, ranks[0], case, (1, 8))


@pytest.mark.parametrize("layout", [(2, 2), (1, 4), (1, 8)])
def test_combining_mix_across_shard_boundaries(world4, world8, layout):
    cases, results = world4 if layout[1] < 8 else (world8[0], world8[1][0])
    case = next(c for c in cases if c["id"] == "mixed")
    got, _, _ = assert_world_equal(JaxPodSharded, results, case, layout)
    assert len(got["out"][0]) == len(MIXED_SPECS)


@pytest.mark.parametrize("layout", MERGE4)
def test_aborts_in_two_shards(world4, layout):
    cases, results = world4
    case = next(c for c in cases if c["id"] == "aborts")
    got, _, el = assert_world_equal(JaxPodSharded, results, case, layout)
    status = got["out"][2][el]
    assert len(set(got["out"][1][el][status != 200].tolist())) == 2


@pytest.mark.parametrize("layout", MERGE4)
def test_relation_fixture(world4, layout):
    cases, results = world4
    case = next(c for c in cases if c["id"] == "relation")
    got, _, el = assert_world_equal(JaxPodSharded, results, case, layout)
    assert (got["out"][0][el] == 1).any()


@pytest.mark.parametrize("delta_enabled", [True, False])
def test_evaluator_pod_shards(world4, delta_enabled):
    """``HybridEvaluator(mesh, pod_shards=2)`` serves through the
    pod-sharded kernel: responses and ``shard_identity`` equal the JAX
    evaluator's on the same layout, both at ``delta_enabled`` (True, the
    default: ``full_bucketed_compile``; False: ``compile_policies``)."""
    cases, results = world4
    cid = f"evaluator delta={delta_enabled}"
    case = next(c for c in cases if c["id"] == cid)
    got = results[(cid, (2, 2))]
    assert got["kernel"] == "PodShardedKernel"
    jev = JaxEvaluator(jax_tree(case["tree"]), delta_enabled=delta_enabled,
                       mesh=jax_mesh(2, 2), model_axis="model", pod_shards=2)
    want = jev.is_allowed_batch([build_request(s, jmodels)
                                 for s in case["specs"]])
    assert got["responses"] == [response_key(w) for w in want]
    assert got["identity"] == jev.shard_identity()


def test_patch_relowers_exactly_the_owner_shard(world8, jax_patch):
    """The JAX delta patcher's compiles through the port's ``patched``:
    the owner shard is re-sliced, every other shard's host tables are
    reused by reference, ``shard_identity`` before and after equals the
    JAX kernels', a rank whose shard did not change keeps its device
    tables, no library is built, and the patched kernel decides as the
    JAX patched kernel does."""
    _, ranks = world8
    k0, k1 = jax_patch["k0"], jax_patch["k1"]
    want = k1.evaluate(jax_patch["batch"])
    owners = {min(s // k0.s_local, k0.n_shards - 1)
              for s in jax_patch["case"]["slots"]}
    assert len(owners) == 1
    for rank, results in enumerate(ranks):
        got = results[("patch", (2, 4))]
        assert got["identity0"] == k0.shard_identity()
        assert got["identity1"] == k1.shard_identity()
        assert got["reused"] == [d not in owners for d in range(4)]
        assert got["device_reused"] == (rank % 4 not in owners)
        assert got["new_builds"] == []
        for w, g in zip(want, got["out"]):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("name", FIXTURES + ["seed_data", "acl_policies.yml"])
def test_partition_byte_equal(name, n_shards):
    """Every shard's tables, ``t_live``, ``s_lo`` and fingerprint equal
    the JAX package's (the blank anchor row, the tail shards' inert
    slots)."""
    jeng, teng = make_engines(name)
    jc = jcompile(jeng.policy_sets, jeng.urns)
    tc = tcompile(teng.policy_sets, teng.urns)
    jshards, js = jax_partition(jc, n_shards)
    tshards, ts = port_partition(tc, n_shards)
    assert ts == js and len(tshards) == len(jshards)
    for j, t in zip(jshards, tshards):
        assert (t.index, t.s_lo, t.t_live) == (j.index, j.s_lo, j.t_live)
        assert t.fingerprint == j.fingerprint
        assert_arrays_equal(j.arrays, t.arrays, f"{name}/{t.index}")
    assert port_slice(tc, n_shards - 1, ts).fingerprint == \
        jshards[-1].fingerprint


def test_explain_matches_jax_single_rank():
    """Explain mode, refused before the explain slice: on a 1-rank mesh
    the four outputs equal the JAX kernel's on a 1-device mesh, and a
    ``patched`` kernel keeps the flag.  (Multi-rank layouts:
    tests/test_torch_explain.py.)"""
    from access_control_srv_tpu_torch.parallel import PodShardedKernel
    from access_control_srv_tpu_torch.parallel.mesh import make_mesh2

    jeng, _ = make_engines("role_scopes.yml")
    jc = jcompile(jeng.policy_sets, jeng.urns)
    batch = jencode([build_request(s, jmodels)
                     for s in spec_grid(n=32, seed=7)], jc)
    tk = PodShardedKernel(jc, make_mesh2(1, 1, device="cpu"), explain=True)
    want = JaxPodSharded(jc, jax_mesh(1, 1), explain=True).evaluate(batch)
    got = tk.evaluate(batch)
    assert len(got) == 4
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g)
    assert tk.patched(jc, [0]).explain
