"""The port's ReBAC path against the JAX package.

Relation-path trees (targets carrying ``urns['relation']`` subjects) are
decided by the kernels' ``with_rel`` variants, which read the per-batch
relation-closure bitplanes packed from a ``RelationTupleStore``'s flat
verdict tables.  Each case here gives the same JAX-compiled tree and the
same encoded batch (packed from the JAX store's tables) to the JAX kernel
and to the port's (on ``device="cpu"``, i.e. the plain PyTorch versions),
and asserts:

- decision, cacheable and status exactly equal (tolerance 0);
- every eligible row equal to the port's oracle walking the port's store;
- the port store's ``tables_for`` arrays byte-equal to the JAX store's
  for the same tuples, so the port packs the same planes.

The cases are those of ``tests/test_relations.py``: the three rewrite
kinds, path depths 1-6, the kernel variants (with an ACL batch, which
takes ``decide_grouped``), fail-closed without a store, the store's
incremental closure under churn (fuzz seeds 7 and 1201), cycle safety,
tenant isolation and boot replay on the port's ``EventBus``, and tuple
churn through the port's ``HybridEvaluator``.  Beyond them, a 550-rule
relation tree runs the signature path unforced, with and without HR
scoping.  The CUDA kernels themselves are held against these plain
versions by ``tests/test_torch_cuda_source.py``,
``tests/test_torch_sig_cuda_source.py`` (on the CPU) and
``chip_smoke.py`` (on the card).
"""

import random

import pytest

import access_control_srv_tpu_torch.models as tmodels
from access_control_srv_tpu import core as jcore
from access_control_srv_tpu import models as jmodels
from access_control_srv_tpu.ops import DecisionKernel as JaxDense
from access_control_srv_tpu.ops import PrefilteredKernel as JaxPrefiltered
from access_control_srv_tpu.ops import compile_policies as jcompile
from access_control_srv_tpu.ops import encode_requests as jencode
from access_control_srv_tpu.srv.evaluator import HybridEvaluator as JaxEvaluator
from access_control_srv_tpu.srv.relations import RelationTupleStore as JaxStore
from access_control_srv_tpu_torch import core as tcore
from access_control_srv_tpu_torch.core.relation_path import (
    RelationGraph,
    check_relation_path,
    parse_path,
)
from access_control_srv_tpu_torch.ops import DecisionKernel, MIN_RULES
from access_control_srv_tpu_torch.ops import PrefilteredKernel
from access_control_srv_tpu_torch.ops import cuda_build
from access_control_srv_tpu_torch.ops import kernel as tkernel
from access_control_srv_tpu_torch.ops import prefilter as tprefilter
from access_control_srv_tpu_torch.srv.evaluator import HybridEvaluator
from access_control_srv_tpu_torch.srv.events import EventBus
from access_control_srv_tpu_torch.srv.relations import RelationTupleStore

from .test_kernel_differential import DEC_CODE
from .test_prefilter import _stress_doc, force_active
from .test_torch_prefilter import port_kernel
from .test_torch_carryover import build_request, make_engines, request_spec
from .test_torch_evaluator import response_key
from .test_torch_kernel import assert_exact, engines_from_doc
from .utils import URNS, fixture
from .utils import build_request as jax_build_request

NS = "urn:restorecommerce:acs:model:document.Document"
FOLDER = "urn:restorecommerce:acs:model:folder.Folder"
ORG = "urn:restorecommerce:acs:model:organization.Organization"
READ = "urn:restorecommerce:acs:names:action:read"


# ------------------------------------------------------------ shared helpers


def rel_engines(tmp_path=None, value="viewer"):
    """(JAX engine, port engine) on ``relation_policies.yml`` with its
    relation path replaced by ``value``."""
    if value == "viewer":
        return make_engines("relation_policies.yml")
    text = open(fixture("relation_policies.yml")).read()
    assert text.count("value: viewer") == 1
    path = tmp_path / "rebac.yml"
    path.write_text(text.replace("value: viewer", f"value: {value}"))
    engines = []
    for core in (jcore, tcore):
        engine = core.AccessController()
        for ps in core.load_policy_sets_from_file(str(path)):
            engine.update_policy_set(ps)
        engines.append(engine)
    return engines


def both_stores(*ops):
    """(JAX store, port store) after the same operations, each
    ``(method name, argument)``."""
    stores = (JaxStore(), RelationTupleStore())
    for store in stores:
        for name, *args in ops:
            getattr(store, name)(*args)
    return stores


def rel_specs(subjects, resource_ids, **kw):
    """Read requests of every subject on every document (a list id is a
    multi-resource request)."""
    return [
        request_spec(jax_build_request(
            subject_id=s, resource_type=[NS] * len(r) if isinstance(r, list)
            else NS, resource_id=r, action_type=READ, **kw))
        for s in subjects for r in resource_ids
    ]


def assert_tables_equal(want: dict, got: dict):
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        assert want[k].tobytes() == got[k].tobytes(), k


def oracle_check(teng, tstore, specs, batch, out) -> int:
    """Every eligible row equal to the port's oracle walking the port's
    store: (decision, cacheable, status).  Returns the rows checked."""
    teng.relation_store = tstore
    n = 0
    for b, spec in enumerate(specs):
        if not batch.eligible[b]:
            continue
        resp = teng.is_allowed(build_request(spec, tmodels))
        cach = resp.evaluation_cacheable
        want = (DEC_CODE[resp.decision], -1 if cach is None else int(cach),
                resp.operation_status.code)
        assert tuple(int(o[b]) for o in out) == want, b
        n += 1
    return n


def differential(engines, stores, specs, kernels=("dense", "forced")):
    """The JAX and the port kernels on one JAX-compiled tree and one batch
    packed from the JAX store's tables; the port store's tables byte-equal
    to the JAX store's; eligible rows equal to the port oracle.  Returns
    (the port outputs per kernel, the batch)."""
    jeng, teng = engines
    jstore, tstore = stores
    compiled = jcompile(jeng.policy_sets, jeng.urns)
    assert compiled.supported and tkernel.tree_needs_rel(compiled.arrays)
    tables = None
    if jstore is not None:
        tables = jstore.tables_for(compiled)
        assert_tables_equal(tables, tstore.tables_for(compiled))
    batch = jencode([build_request(s, jmodels) for s in specs], compiled,
                    relation_tables=tables)
    pairs = {
        "dense": (JaxDense(compiled), DecisionKernel(compiled, device="cpu")),
        "forced": (force_active(JaxPrefiltered(compiled)),
                   port_kernel(compiled, force=True)),
        "prefiltered": (JaxPrefiltered(compiled),
                        PrefilteredKernel(compiled, device="cpu")),
    }
    outs = {}
    for name in kernels:
        jk, tk = pairs[name]
        want = jk.evaluate(batch)
        got = tk.evaluate(batch)
        assert_exact(want, got, name)
        outs[name] = got
    assert oracle_check(teng, tstore, specs, batch,
                        next(iter(outs.values()))) > 0
    return outs, batch


# ------------------------------------------------------- rewrite kinds


REWRITE_CASES = {
    "direct": (("create", [(NS, "doc1", "viewer", "alice")]),),
    "computed_userset": (
        ("set_rewrite", NS, "viewer",
         [("this",), ("computed_userset", "owner")]),
        ("create", [(NS, "doc1", "owner", "alice")]),
    ),
    "tuple_to_userset": (
        ("set_rewrite", NS, "viewer",
         [("this",), ("tuple_to_userset", "parent", "viewer")]),
        ("create", [
            (NS, "doc1", "parent", {"object": {"entity": FOLDER,
                                               "id": "f1"}}),
            (FOLDER, "f1", "viewer", "alice"),
        ]),
    ),
}


@pytest.mark.parametrize("kind", sorted(REWRITE_CASES))
def test_rewrite_kinds(kind):
    engines = rel_engines()
    stores = both_stores(*REWRITE_CASES[kind])
    specs = rel_specs(["alice", "bob"], ["doc1", "doc2"])
    outs, _ = differential(engines, stores, specs)
    # alice reads doc1 through every rewrite kind; bob never does
    assert outs["dense"][0].tolist() == [1, 2, 2, 2]


# ----------------------------------------------------------- path depth


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5, 6])
def test_depth_chains(depth, tmp_path):
    """parent....owner paths against a folder chain of the same depth; a
    second document's chain stops one folder short."""
    path = ".".join(["parent"] * (depth - 1) + ["owner"])
    engines = rel_engines(tmp_path, path)
    if depth == 1:
        chain = [(NS, "doc1", "owner", "alice")]
    else:
        chain = [(NS, "doc1", "parent",
                  {"object": {"entity": FOLDER, "id": "f1"}})]
        for i in range(1, depth - 1):
            chain.append((FOLDER, f"f{i}", "parent",
                          {"object": {"entity": FOLDER, "id": f"f{i + 1}"}}))
        chain.append((FOLDER, f"f{depth - 1}", "owner", "alice"))
        chain.append((NS, "doc2", "parent",
                      {"object": {"entity": FOLDER, "id": f"f{depth - 1}"}}))
    stores = both_stores(("create", chain))
    outs, _ = differential(engines, stores,
                           rel_specs(["alice", "bob"], ["doc1", "doc2"]))
    dec = outs["dense"][0].tolist()
    assert dec[0] == 1 and dec[2:] == [2, 2]
    assert dec[1] == (1 if depth == 2 else 2)  # f1 is doc1's folder too
    assert stores[1].check(path, NS, "doc1", "alice")
    assert not stores[1].check(path, NS, "doc1", "bob")


# ------------------------------------------------------ kernel variants


VARIANT_OPS = (
    ("set_rewrite", NS, "viewer", [("this",), ("computed_userset", "owner")]),
    ("create", [
        (NS, "doc1", "owner", "alice"),
        (NS, "doc2", "viewer", "bob"),
        (NS, "doc3", "viewer", {"object": {"entity": "group", "id": "g"},
                                "relation": "member"}),
        ("group", "g", "member", "carol"),
    ]),
)
VARIANT_SPECS = rel_specs(["alice", "bob", "carol", "mallory"],
                          ["doc1", "doc2", "doc3", ["doc1", "doc3"]])


def test_kernel_variants():
    """Dense and forced-signature kernels of both packages read the same
    relation planes to the same decisions; a batch with ACL pairs takes
    the per-row grouped kernel (decide_grouped) on the signature path."""
    engines = rel_engines()
    outs, batch = differential(engines, both_stores(*VARIANT_OPS),
                               VARIANT_SPECS)
    assert_exact(outs["dense"], outs["forced"])
    assert set(outs["dense"][0].tolist()) == {1, 2}
    acl = rel_specs(["alice", "bob", "carol"], ["doc1", "doc2", "doc3"],
                    acl_indicatory_entity=ORG, acl_instances=["Org1"])
    _, acl_batch = differential(engines, both_stores(*VARIANT_OPS),
                                VARIANT_SPECS[:6] + acl)
    assert (acl_batch.arrays["r_acl_ent"] >= 0).any()


def grouped_doc():
    """A role rule on organizations, then the fixture's relation rule on
    documents: an organization request's compacted subtree keeps no
    relation row (target row 0, always kept, is the role rule's)."""
    def rule(rid, subject, entity):
        return {"id": rid, "effect": "PERMIT", "target": {
            "subjects": [subject],
            "resources": [{"id": URNS["entity"], "value": entity}],
            "actions": [{"id": URNS["actionID"], "value": READ}]}}

    rules = [rule("r_org", {"id": URNS["role"], "value": "member"}, ORG),
             rule("r_doc", {"id": URNS["relation"], "value": "viewer"}, NS)]
    fa = ("urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:"
          "first-applicable")
    return {"policy_sets": [{"id": "ps", "combining_algorithm": fa,
                             "policies": [{"id": "p", "rules": rules,
                                           "combining_algorithm": fa}]}]}


def test_grouped_variant_follows_the_stack(monkeypatch):
    """decide_grouped takes the relation variant from the stacked
    subtrees, not the tree: a batch whose groups keep relation rows runs
    with_rel, one whose compacted groups hold none runs without it."""
    jeng, teng = engines_from_doc(grouped_doc())
    compiled = jcompile(jeng.policy_sets, jeng.urns)
    assert tkernel.tree_needs_rel(compiled.arrays)
    jstore, tstore = both_stores(*VARIANT_OPS)
    calls = []
    orig = tprefilter.decide_grouped

    def spy(*args):
        calls.append(args[-1])
        return orig(*args)

    monkeypatch.setattr(tprefilter, "decide_grouped", spy)
    kern = port_kernel(compiled, force=True)
    for resource_type in (NS, ORG):
        specs = rel_specs(["alice", "bob"], ["doc1"],
                          acl_indicatory_entity=ORG, acl_instances=["Org1"])
        for spec in specs:
            spec["target"]["resources"][0]["value"] = resource_type
        batch = jencode([build_request(s, jmodels) for s in specs],
                        compiled, relation_tables=jstore.tables_for(compiled))
        out = kern.evaluate(batch)
        assert_exact(JaxDense(compiled).evaluate(batch), out)
        assert oracle_check(teng, tstore, specs, batch, out) == 2
    assert calls == [True, False]


def test_skip_relation_bits_batch():
    """A batch encoded with skip_relation_bits carries 1-wide dummy planes
    (no run is ever collected against them); both packages read them to
    the same outputs."""
    jeng, _ = rel_engines()
    compiled = jcompile(jeng.policy_sets, jeng.urns)
    batch = jencode([build_request(s, jmodels) for s in VARIANT_SPECS],
                    compiled, skip_relation_bits=True)
    assert batch.arrays["r_rel_bits"].shape[1] == 1
    for jk, tk in ((JaxDense(compiled), DecisionKernel(compiled, device="cpu")),
                   (force_active(JaxPrefiltered(compiled)),
                    port_kernel(compiled, force=True))):
        assert_exact(jk.evaluate(batch), tk.evaluate(batch))


def test_tables_follow_the_compile():
    """Tables are cached per generation and per id source: a second
    compile of the same tree (a refresh; its interner met other strings
    first, so the tuples' ids differ) gets tables in its own ids, equal to
    a fresh store's, and its decisions equal the oracle."""
    jeng, teng = rel_engines()
    _, store = both_stores(*VARIANT_OPS)
    first = jcompile(jeng.policy_sets, jeng.urns)
    store.tables_for(first)
    second = jcompile(jeng.policy_sets, jeng.urns)
    for name in ("u-new", "doc3", "carol"):
        second.interner.intern(name)
    tables = store.tables_for(second)
    assert store.tables_for(second) is tables
    assert_tables_equal(both_stores(*VARIANT_OPS)[1].tables_for(second),
                        tables)
    batch = jencode([build_request(s, jmodels) for s in VARIANT_SPECS],
                    second, relation_tables=tables)
    out = DecisionKernel(second, device="cpu").evaluate(batch)
    assert oracle_check(teng, store, VARIANT_SPECS, batch, out) == 16


def test_fail_closed_without_store():
    """No store: relation-bearing targets deny on the kernels and the
    oracle alike, never PERMIT by omission."""
    outs, _ = differential(rel_engines(), (None, None),
                           rel_specs(["alice"], ["doc1", "doc2"]))
    assert outs["dense"][0].tolist() == [2, 2]


# --------------------------------------------------- incremental closure


_FUZZ_RELS = ["viewer", "owner", "editor", "parent"]
_FUZZ_USERS = [f"u{i}" for i in range(6)]
_FUZZ_OBJS = [(NS, f"doc{i}") for i in range(4)] + [
    (FOLDER, f"f{i}") for i in range(3)
]


def _random_tuple(rng):
    ns, oid = rng.choice(_FUZZ_OBJS)
    rel = rng.choice(_FUZZ_RELS)
    kind = rng.random()
    if kind < 0.6:
        subj = rng.choice(_FUZZ_USERS)
    elif kind < 0.85:
        ons, ooid = rng.choice(_FUZZ_OBJS)
        subj = {"object": {"entity": ons, "id": ooid}}
    else:
        ons, ooid = rng.choice(_FUZZ_OBJS)
        subj = {"object": {"entity": ons, "id": ooid},
                "relation": rng.choice(_FUZZ_RELS)}
    return (ns, oid, rel, subj)


@pytest.mark.parametrize("seed", [7, 1201])
def test_fuzz_tables_equal(seed, tmp_path):
    """Random create / delete / rewrite churn applied to the JAX and the
    port store alike: their tables_for arrays and fingerprints are
    byte-equal, mid-churn and at the end; the port's patched closure
    equals a port store rebuilt from scratch, and its cached verdicts the
    uncached oracle walk."""
    jeng, _ = rel_engines(tmp_path, "viewer|parent.owner")
    compiled = jcompile(jeng.policy_sets, jeng.urns)
    rng = random.Random(seed)
    stores = (JaxStore(), RelationTupleStore())
    live: list[tuple] = []
    for step in range(120):
        op = rng.random()
        if op < 0.15 and live:
            victim = rng.choice(live)
            for store in stores:
                store.delete([victim])
            live.remove(victim)
        elif op < 0.25:
            ns, _ = rng.choice(_FUZZ_OBJS)
            rel = rng.choice(_FUZZ_RELS)
            rules = [("this",)]
            if rng.random() < 0.5:
                rules.append(("computed_userset", rng.choice(_FUZZ_RELS)))
            if rng.random() < 0.3:
                rules.append(("tuple_to_userset", "parent",
                              rng.choice(_FUZZ_RELS)))
            for store in stores:
                store.set_rewrite(ns, rel, rules)
        else:
            t = _random_tuple(rng)
            if [store.create([t]) for store in stores][1]:
                live.append(t)
        if step % 40 == 17:
            assert_tables_equal(stores[0].tables_for(compiled),
                                stores[1].tables_for(compiled))
    jstore, store = stores
    assert store.fingerprint() == jstore.fingerprint()
    assert store.generation == jstore.generation
    patched = store.tables_for(compiled)
    assert_tables_equal(jstore.tables_for(compiled), patched)

    fresh = RelationTupleStore()
    for (ns, rel), rules in store.graph.rewrites.items():
        fresh.set_rewrite(ns, rel, rules)
    fresh.create(live)
    assert store.fingerprint() == fresh.fingerprint()
    assert_tables_equal(fresh.tables_for(compiled), patched)
    for expr in ("viewer", "parent.owner", "owner!direct",
                 "viewer|parent.owner"):
        path = parse_path(expr)
        for ns, oid in _FUZZ_OBJS:
            for user in _FUZZ_USERS:
                assert store.check(expr, ns, oid, user) == \
                    check_relation_path(path, ns, oid, user, store.graph), \
                    (expr, ns, oid, user)


def test_cycle_safe_closure():
    """Mutually recursive usersets terminate and stay correct."""
    g = RelationGraph()
    cycle = [
        ("group", "a", "member",
         {"object": {"entity": "group", "id": "b"}, "relation": "member"}),
        ("group", "b", "member",
         {"object": {"entity": "group", "id": "a"}, "relation": "member"}),
        ("group", "b", "member", "alice"),
    ]
    for t in cycle:
        g.add(*t)
    path = parse_path("member")
    assert check_relation_path(path, "group", "a", "alice", g)
    assert not check_relation_path(path, "group", "a", "bob", g)
    store = RelationTupleStore()
    store.create(cycle)
    assert store.check("member", "group", "a", "alice")
    assert store.witness("member", "group", "a", "alice") is not None
    assert not store.check("member", "group", "a", "bob")
    assert store.witness("member", "group", "a", "bob") is None


# ---------------------------------------------------- bus + replication


def test_tenant_isolation_on_shared_bus():
    """Tenant-tagged frames on the port's shared bus apply only to the
    matching tenant's store; the writer skips its own frame."""
    bus = EventBus()
    a1 = RelationTupleStore(bus=bus, tenant="acme")
    a2 = RelationTupleStore(bus=bus, tenant="acme")
    b = RelationTupleStore(bus=bus, tenant="globex")
    for s in (a2, b):
        s.start_replication()
    a1.create([(NS, "doc1", "viewer", "alice")])
    assert a2.check("viewer", NS, "doc1", "alice")
    assert not b.check("viewer", NS, "doc1", "alice")
    assert a1.fingerprint() == a2.fingerprint() != b.fingerprint()
    assert a1.generation == 1


def test_boot_replay_converges():
    """A store attached after the churn replays the topic to the same
    fingerprint, equal to the JAX store's after the same operations."""
    bus = EventBus()
    first = RelationTupleStore(bus=bus)
    ops = (
        ("set_rewrite", NS, "viewer",
         [("this",), ("computed_userset", "owner")]),
        ("create", [(NS, "doc1", "owner", "alice"),
                    (NS, "doc2", "viewer", "bob")]),
        ("delete", [(NS, "doc2", "viewer", "bob")]),
    )
    for name, *args in ops:
        getattr(first, name)(*args)
    late = RelationTupleStore(bus=bus)
    assert late.replay() == 4
    assert late.fingerprint() == first.fingerprint()
    assert late.fingerprint() == both_stores(*ops)[0].fingerprint()
    assert late.check("viewer", NS, "doc1", "alice")
    assert not late.check("viewer", NS, "doc2", "bob")


# ------------------------------------------------- serving invariants


def test_tuple_churn_swaps_no_build():
    """Tuple CRUD through the port's evaluator flips the decision with the
    compiled tree, the kernel object and the built libraries unchanged,
    and every response equals the JAX evaluator's under the same churn."""
    jeng, teng = rel_engines()
    jev = JaxEvaluator(jeng, delta_enabled=False)
    tev = HybridEvaluator(teng, device="cpu")
    jstore, tstore = both_stores()
    jev.attach_relation_store(jstore)
    tev.attach_relation_store(tstore)
    spec = rel_specs(["bob"], ["doc1"])[0]
    version, kernel = tev._compiled.version, tev._kernel
    libs, loaded = dict(cuda_build._libs), dict(tkernel._libs)
    grant = [(NS, "doc1", "viewer", "bob")]
    seen = []
    for op in (None, "create", "delete"):
        if op is not None:
            getattr(jstore, op)(grant)
            getattr(tstore, op)(grant)
        want = jev.is_allowed_batch([build_request(spec, jmodels)])[0]
        got = tev.is_allowed_batch([build_request(spec, tmodels)])[0]
        assert response_key(got) == response_key(want), op
        assert response_key(tev.is_allowed(build_request(spec, tmodels))) \
            == response_key(got), op
        seen.append(got.decision)
    assert seen == ["DENY", "PERMIT", "DENY"]
    assert tev._compiled.version == version and tev._kernel is kernel
    assert cuda_build._libs == libs and tkernel._libs == loaded
    assert tev.relation_churn == 2


def test_evaluator_without_store_fails_closed():
    """No store attached: the evaluator's kernel rows deny, as the JAX
    evaluator's do."""
    jeng, teng = rel_engines()
    specs = rel_specs(["alice", "bob"], ["doc1", ["doc1", "doc2"]])
    want = JaxEvaluator(jeng, delta_enabled=False).is_allowed_batch(
        [build_request(s, jmodels) for s in specs])
    got = HybridEvaluator(teng, device="cpu").is_allowed_batch(
        [build_request(s, tmodels) for s in specs])
    assert [response_key(g) for g in got] == [response_key(w) for w in want]
    assert {g.decision for g in got} == {"DENY"}


# ---------------------------------- a relation tree on the signature path


REL_PATHS = ("viewer", "owner", "parent.owner", "viewer|parent.owner",
             "owner!direct")
STRESS_DOCS = [f"doc{i}" for i in range(6)]
STRESS_USERS = [f"u{i}" for i in range(12)]


def rel_stress_doc(scoped: bool):
    """The JAX prefilter tests' stress tree cut to 550 rules (5 policies
    of 110, above MIN_RULES) with a relation-path subject on three rules
    in four (five path shapes in turn); ``scoped`` adds a
    roleScopingEntity to every rule, so HR and relation folds stack."""
    doc, entities, actions = _stress_doc(n_policies=5, per_policy=110)
    for pol in doc["policy_sets"][0]["policies"]:
        for rule in pol["rules"]:
            rid = int(rule["id"][1:])
            subjects = rule["target"]["subjects"]
            if scoped:
                subjects.append({"id": URNS["roleScopingEntity"],
                                 "value": ORG})
            if rid % 4 != 3:
                subjects.append({"id": URNS["relation"],
                                 "value": REL_PATHS[rid % len(REL_PATHS)]})
    return doc, entities, actions


def stress_stores(entities, seed: int = 3):
    """Both stores over the stress entities' documents: viewer and owner
    grants, parent links to folders with owners, a viewer rewrite."""
    return both_stores(*stress_store_ops(entities, seed))


def stress_store_ops(entities, seed: int = 3):
    """The operations of ``stress_stores``."""
    rng = random.Random(seed)
    tuples = []
    for ent in entities:
        for d in STRESS_DOCS:
            if rng.random() < 0.5:
                tuples.append((ent, d, "viewer", rng.choice(STRESS_USERS)))
            if rng.random() < 0.4:
                tuples.append((ent, d, "owner", rng.choice(STRESS_USERS)))
            if rng.random() < 0.4:
                tuples.append((ent, d, "parent", {"object": {
                    "entity": FOLDER, "id": f"f{rng.randrange(4)}"}}))
    for f in range(4):
        tuples.append((FOLDER, f"f{f}", "owner", rng.choice(STRESS_USERS)))
    return [
        ("set_rewrite", entities[0], "viewer",
         [("this",), ("computed_userset", "owner")]),
        ("create", tuples),
    ]


def rel_stress_specs(entities, actions, n: int, seed: int, scoped: bool):
    rng = random.Random(seed)
    orgs = [f"org-{j}" for j in range(6)]
    specs = []
    for i in range(n):
        role = f"role-{i % 23}"
        kw = {}
        if scoped:
            kw = dict(role_scoping_entity=ORG, role_scoping_instance=orgs[0],
                      owner_indicatory_entity=ORG,
                      owner_instance=rng.choice(orgs),
                      hierarchical_scopes=[{
                          "id": orgs[0], "role": role,
                          "children": [{"id": o} for o in orgs[1:4]]}])
        spec = request_spec(jax_build_request(
            subject_id=rng.choice(STRESS_USERS), subject_role=role,
            resource_type=rng.choice(entities),
            resource_id=rng.choice(STRESS_DOCS),
            action_type=rng.choice(actions), **kw))
        if not scoped:  # the role association verifyACL's short path needs
            spec["context"]["subject"]["role_associations"] = [
                {"role": role, "attributes": []}]
        specs.append(spec)
    return specs


@pytest.mark.parametrize("scoped", [False, True])
def test_relation_tree_on_the_signature_path(scoped, monkeypatch):
    """550 relation-bearing rules, above MIN_RULES: both packages'
    PrefilteredKernels take the signature path unforced and agree; the
    port ran sig_planes and sig_decide in their relation variant."""
    doc, entities, actions = rel_stress_doc(scoped)
    engines = engines_from_doc(doc)
    calls = []
    for name in ("sig_planes", "sig_decide"):
        orig = getattr(tprefilter, name)

        def spy(*args, _orig=orig, _name=name):
            calls.append((_name, args[-2], args[-1]))
            return _orig(*args)

        monkeypatch.setattr(tprefilter, name, spy)
    specs = rel_stress_specs(entities, actions, 96, 11, scoped)
    outs, batch = differential(engines, stress_stores(entities), specs,
                               kernels=("prefiltered",))
    compiled = jcompile(engines[0].policy_sets, engines[0].urns)
    assert compiled.n_rules >= MIN_RULES
    assert sorted(calls) == [("sig_decide", scoped, True),
                             ("sig_planes", scoped, True)]
    assert {1, 2} <= set(outs["prefiltered"][0][batch.eligible].tolist())
