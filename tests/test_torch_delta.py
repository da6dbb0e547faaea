"""The port's delta patcher (``ops/delta.py``) and the evaluator's hot-update
path against the JAX package's, on the same trees and seeds.

- Capacity buckets and padding: ``capacities_for``, ``pad_compiled``,
  ``full_bucketed_compile`` and ``fixed_caps_compile`` give arrays equal
  name by name (dtype, shape, bytes) to the JAX functions'.
- The random CRUD fuzz of ``tests/test_delta.py`` (seeds 11, 29, 47 and
  the capacity-growth case) runs through a port ``PolicyStore`` +
  ``HybridEvaluator(device="cpu")`` beside the JAX pair; after every step
  the published tables, ``table_fingerprint()``, ``delta_stats()`` (its
  timing excepted) and the ``is_allowed_batch`` responses are equal.
- Each reason of the fallback taxonomy is the JAX reason.
- An in-capacity patch adds no runner to ``shared_jits`` (the same runner
  objects serve it) and no build or library load.
- A tree of 600 rules serves patched tables through the plain versions of
  K2-K4.

``patched_compile`` (a bucketed compile and one ``apply_events`` patch of
a tree) gives the CUDA-source stand-in tests their patched tables.
"""

import copy
import random

import numpy as np
import pytest

import access_control_srv_tpu_torch.models as tmodels
from access_control_srv_tpu import models as jmodels
from access_control_srv_tpu.core.engine import AccessController as JaxController
from access_control_srv_tpu.ops import compile_policies as jcompile
from access_control_srv_tpu.ops import delta as jdelta
from access_control_srv_tpu.srv.decision_cache import DecisionCache as JaxCache
from access_control_srv_tpu.srv.evaluator import HybridEvaluator as JaxEvaluator
from access_control_srv_tpu.srv.store import PolicyStore as JaxStore
from access_control_srv_tpu_torch.core.engine import AccessController
from access_control_srv_tpu_torch.ops import compile_policies as tcompile
from access_control_srv_tpu_torch.ops import cuda_build
from access_control_srv_tpu_torch.ops import delta as tdelta
from access_control_srv_tpu_torch.ops import kernel as tkernel
from access_control_srv_tpu_torch.ops import prefilter as tprefilter
from access_control_srv_tpu_torch.srv.decision_cache import DecisionCache
from access_control_srv_tpu_torch.srv.evaluator import HybridEvaluator
from access_control_srv_tpu_torch.srv.store import PolicyStore

from .test_delta import DO, FA, PO, _apply_random_op, entity, rule_doc
from .test_torch_carryover import make_engines
from .utils import URNS


# ------------------------------------------------------------------ helpers


def make_request(models, k: int, who: str = "u1", prop: bool = False):
    """``tests/test_delta.make_request`` in ``models`` (JAX or port); with
    ``prop`` the resource carries a property, which sends its batch to
    the per-row kernel (K4) on the signature path."""
    role = f"role-{k % 5}"
    resources = [models.Attribute(id=URNS["entity"], value=entity(k))]
    if prop:
        resources.append(models.Attribute(id=URNS["property"],
                                          value=entity(k) + "#name"))
    return models.Request(
        target=models.Target(
            subjects=[models.Attribute(id=URNS["role"], value=role),
                      models.Attribute(id=URNS["subjectID"], value=who)],
            resources=resources,
            actions=[models.Attribute(id=URNS["actionID"],
                                      value=URNS["read"])],
        ),
        context={"resources": [], "subject": {
            "id": who,
            "role_associations": [{"role": role, "attributes": []}],
            "hierarchical_scopes": [],
        }},
    )


def stack_docs(n_rules: int, n_policies: int):
    """``tests/test_delta.build_stack``'s seed documents."""
    rules = [rule_doc(f"r{i}", i) for i in range(n_rules)]
    per = max(1, n_rules // n_policies)
    pols = [{"id": f"p{p}", "combining_algorithm": PO,
             "rules": [f"r{i}" for i in range(p * per,
                                              min((p + 1) * per, n_rules))]}
            for p in range(n_policies)]
    sets_ = [{"id": "s0", "combining_algorithm": DO,
              "policies": [p["id"] for p in pols]}]
    return sets_, pols, rules


class Side:
    """One engine + evaluator + store (+ decision cache)."""

    def __init__(self, kind: str, docs, cache: bool, **kw):
        if kind == "jax":
            self.engine = JaxController()
            self.cache = JaxCache() if cache else None
            self.ev = JaxEvaluator(self.engine, decision_cache=self.cache,
                                   **kw)
            self.store = JaxStore(self.engine, evaluator=self.ev)
            self.models = jmodels
        else:
            self.engine = AccessController()
            self.cache = DecisionCache() if cache else None
            self.ev = HybridEvaluator(self.engine, decision_cache=self.cache,
                                      device="cpu", **kw)
            self.store = PolicyStore(self.engine, evaluator=self.ev)
            self.models = tmodels
        self.store.seed(*copy.deepcopy(docs))

    def answers(self, keys, prop: bool = False) -> list:
        out = self.ev.is_allowed_batch([
            make_request(self.models, k, who, prop)
            for k in keys for who in ("u1", "u2")])
        return [(r.decision, r.evaluation_cacheable,
                 r.operation_status.code, r.operation_status.message)
                for r in out]


def assert_same_arrays(want, got, what="") -> None:
    """Two CompiledPolicies' arrays equal name by name (dtype, shape,
    bytes), and their vocabularies, conditions and dims."""
    assert sorted(got.arrays) == sorted(want.arrays), what
    for name, arr in want.arrays.items():
        a, b = np.asarray(arr), np.asarray(got.arrays[name])
        assert (b.dtype, b.shape) == (a.dtype, a.shape), (what, name)
        assert b.tobytes() == a.tobytes(), (what, name)
    assert got.entity_vocab == want.entity_vocab, what
    assert got.rel_vocab == want.rel_vocab, what
    assert [(c.rule_flat_index, c.condition, c.owner)
            for c in got.conditions] == [
        (c.rule_flat_index, c.condition, c.owner)
        for c in want.conditions], what
    assert (got.S, got.KP, got.KR, got.T, got.n_rules) == \
        (want.S, want.KP, want.KR, want.T, want.n_rules), what


def stats_of(ev) -> dict:
    out = ev.delta_stats()
    out.pop("last_visibility_ms")
    return out


class Pair:
    """The JAX side and the port side on the same seed documents."""

    def __init__(self, n_rules: int = 12, n_policies: int = 2,
                 cache: bool = True, **kw):
        docs = stack_docs(n_rules, n_policies)
        self.jax = Side("jax", docs, cache, **kw)
        self.port = Side("port", docs, cache, **kw)

    def check(self, keys=range(16), what: str = "") -> None:
        jev, tev = self.jax.ev, self.port.ev
        assert_same_arrays(jev._compiled, tev._compiled, what)
        assert tev.table_fingerprint() == jev.table_fingerprint(), what
        assert stats_of(tev) == stats_of(jev), what
        assert self.port.answers(keys) == self.jax.answers(keys), what

    def close(self) -> None:
        for side in (self.jax, self.port):
            side.ev.shutdown()


def patched_compile(engine, delta, seed: int = 0):
    """``engine``'s tree compiled by ``delta.full_bucketed_compile``, then
    patched by one ``delta.apply_events`` (``delta`` is the package's
    module of ``engine``): a rule takes another rule's target and the
    other effect, and, where the tree's side of ``MIN_RULES`` (512) holds,
    a copy of the donor rule under a new id is inserted at the front of
    the same policy.  The tree is edited in place.  Returns (patched
    compile, apply_events's stats)."""
    tree = engine.policy_sets
    padded, caps, state = delta.full_bucketed_compile(tree, engine.urns)
    assert state is not None, "tree unsupported"
    rng = random.Random(seed)
    rules = [(ps, pol, rule) for ps in tree.values() if ps is not None
             for pol in ps.combinables.values() if pol is not None
             for rule in pol.combinables.values() if rule is not None]
    ps, pol, rule = rules[rng.randrange(len(rules))]
    donor = rules[rng.randrange(len(rules))][2]
    flip = "DENY" if rule.effect == "PERMIT" else "PERMIT"
    events = [delta.CrudEvent("rule", "update", rule.id,
                              {"id": rule.id, "effect": rule.effect},
                              {"id": rule.id, "effect": flip})]
    rule.effect = flip
    rule.target = copy.deepcopy(donor.target)
    n_rules = len(rules)
    if (n_rules + 1 >= 512) == (n_rules >= 512) \
            and len(pol.combinables) < caps.KR:
        extra = copy.deepcopy(donor)
        extra.id = f"{donor.id}__patched"
        pol.combinables = {extra.id: extra, **pol.combinables}
        events.append(delta.CrudEvent("rule", "create", extra.id, None,
                                      {"id": extra.id, "effect": "DENY"}))
    result, patched, _state, stats = delta.apply_events(
        state, padded, tree, events, engine.urns)
    assert result == "patch", result
    return patched, stats


# ------------------------------------------------------- buckets and padding

TREES = ["basic_policies.yml", "role_scopes.yml", "conditions.yml",
         "acl_policies.yml", "props_multi_rules_entities.yml",
         "scoped_511", "seed_data"]


@pytest.mark.parametrize("name", TREES)
def test_bucketed_compiles_match_jax(name):
    jeng, teng = make_engines(name)
    jraw = jcompile(jeng.policy_sets, jeng.urns)
    traw = tcompile(teng.policy_sets, teng.urns)
    jcaps, tcaps = jdelta.capacities_for(jraw), tdelta.capacities_for(traw)
    assert tcaps.as_dict() == jcaps.as_dict()
    assert tdelta.live_capacities(traw).as_dict() == \
        jdelta.live_capacities(jraw).as_dict()
    # a previous bucket is reused while it fits and is not oversized
    prev = tdelta.Capacities(**{k: 2 * v for k, v in tcaps.as_dict().items()})
    assert tdelta.capacities_for(traw, prev=prev) == prev
    assert jdelta.capacities_for(jraw, prev=jdelta.Capacities(
        **prev.as_dict())).as_dict() == prev.as_dict()
    assert_same_arrays(jdelta.pad_compiled(jraw, jcaps),
                       tdelta.pad_compiled(traw, tcaps), "pad_compiled")
    jfull, jc, jst = jdelta.full_bucketed_compile(jeng.policy_sets, jeng.urns)
    tfull, tc, tst = tdelta.full_bucketed_compile(teng.policy_sets, teng.urns)
    assert tc.as_dict() == jc.as_dict()
    assert_same_arrays(jfull, tfull, "full_bucketed_compile")
    assert (tst.t_live, tst.w_live, tst.rv_live, tst.set_order,
            tst.prefilter_active) == (jst.t_live, jst.w_live, jst.rv_live,
                                      jst.set_order, jst.prefilter_active)
    big = jdelta.Capacities(**{k: 2 * v for k, v in jc.as_dict().items()})
    jfix = jdelta.fixed_caps_compile(jeng.policy_sets, jeng.urns, big)[0]
    tfix = tdelta.fixed_caps_compile(teng.policy_sets, teng.urns,
                                     tdelta.Capacities(**big.as_dict()))[0]
    assert_same_arrays(jfix, tfix, "fixed_caps_compile")
    # pad entity-vocab rows are the never-matching sentinels
    assert tfull.entity_vocab[len(traw.entity_vocab):] == [
        tdelta.vocab_pad_value(i)
        for i in range(len(traw.entity_vocab), tc.W)]


def test_fixed_caps_overflow_names_the_dimension():
    _, teng = make_engines("basic_policies.yml")
    raw = tcompile(teng.policy_sets, teng.urns)
    caps = tdelta.live_capacities(raw)
    small = tdelta.Capacities(**{**caps.as_dict(), "T": caps.T - 1})
    with pytest.raises(tdelta.DeltaIneligible) as err:
        tdelta.fixed_caps_compile(teng.policy_sets, teng.urns, small)
    assert err.value.reason == "capacity-class-T"


@pytest.mark.parametrize("name", ["basic_policies.yml", "scoped_511",
                                  "seed_data"])
def test_patched_compile_matches_jax(name):
    """The same edit through both packages' patchers: equal arrays, and
    canonically equal to a fresh compile of the edited tree."""
    from .test_delta import canonical_tables

    jeng, teng = make_engines(name)
    jp, jstats = patched_compile(jeng, jdelta, seed=5)
    tp, tstats = patched_compile(teng, tdelta, seed=5)
    assert tstats == jstats
    assert_same_arrays(jp, tp, name)
    fresh = tcompile(teng.policy_sets, teng.urns)
    assert tdelta.canonical_tables(tp) == tdelta.canonical_tables(fresh)
    # the port's canonicalizer is the JAX tests' on both
    assert tdelta.canonical_tables(tp) == canonical_tables(tp)
    assert tdelta.canonical_tables(fresh) == canonical_tables(fresh)


# --------------------------------------------------------------- the fuzz


@pytest.mark.parametrize("seed", [11, 29, 47])
def test_differential_fuzz_random_crud_sequences(seed):
    pair = Pair(n_rules=10, n_policies=2)
    try:
        pair.check(what="seeded")
        rngs = [random.Random(seed), random.Random(seed)]
        next_ids = [[0], [0]]
        for step in range(14):
            _apply_random_op(rngs[0], pair.jax.store, next_ids[0])
            _apply_random_op(rngs[1], pair.port.store, next_ids[1])
            pair.check(what=f"step {step}")
        assert pair.port.ev.delta_stats()["patches"] >= 5
    finally:
        pair.close()


def test_differential_fuzz_with_capacity_growth():
    pair = Pair(n_rules=6, n_policies=1)
    try:
        rngs = [random.Random(7), random.Random(7)]
        next_ids = [[1000], [1000]]
        for burst in range(3):
            grow = pair.port.ev._caps.KR
            assert grow == pair.jax.ev._caps.KR
            for i, side in enumerate((pair.jax, pair.port)):
                docs = [rule_doc(f"g{next_ids[i][0] + j}", j % 16,
                                 effect=rngs[i].choice(["PERMIT", "DENY"]))
                        for j in range(grow)]
                next_ids[i][0] += grow
                side.store.get_resource_service("rule").create(docs)
                p0 = side.store.collections["policy"].get("p0")
                p0["rules"] = p0["rules"] + [d["id"] for d in docs]
                side.store.get_resource_service("policy").update([p0])
            pair.check(what=f"burst {burst}")
            for step in range(3):
                _apply_random_op(rngs[0], pair.jax.store, next_ids[0])
                _apply_random_op(rngs[1], pair.port.store, next_ids[1])
                pair.check(what=f"burst {burst} step {step}")
        stats = pair.port.ev.delta_stats()
        assert stats["fallbacks"] >= 1 and stats["patches"] >= 1, stats
        assert "capacity-rules" in stats["fallback_reasons"]
    finally:
        pair.close()


# ------------------------------------------------------ a pinned size class


@pytest.mark.parametrize("in_class", [True, False])
def test_fixed_caps_evaluator_matches_jax(in_class):
    """``HybridEvaluator(fixed_caps=...)``, the size class tenancy pins,
    beside the JAX evaluator with the same class.  In the class every
    compile publishes the class's shapes; a tree that overflows it (KR 4
    for 6 rules a policy) is served from its own capacity buckets.  After
    the seed, an in-capacity patch and a growth past the rule capacity
    (a full recompile), both sides publish equal arrays, capacities,
    ``table_fingerprint``, ``delta_stats`` and responses."""
    cls = {"S": 4, "KP": 4, "KR": 32 if in_class else 4, "T": 128,
           "RV": 16, "W": 32, "RELV": 4}
    docs = stack_docs(12, 2)
    pair = Pair.__new__(Pair)
    pair.jax = Side("jax", docs, True, fixed_caps=jdelta.Capacities(**cls))
    pair.port = Side("port", docs, True,
                     fixed_caps=tdelta.Capacities(**cls))
    try:
        pair.check(what="seeded")
        caps = pair.port.ev._caps
        assert caps.as_dict() == pair.jax.ev._caps.as_dict()
        assert (caps.as_dict() == cls) == in_class
        for side in (pair.jax, pair.port):
            side.store.get_resource_service("rule").update(
                [rule_doc("r3", 3, effect="DENY")])
        pair.check(what="patched")
        assert pair.port.ev.delta_stats()["patches"] == 1
        for side in (pair.jax, pair.port):
            _grow_past_kr(side.store, side.ev._caps)
        pair.check(what="grown")
        assert pair.port.ev._caps.as_dict() == \
            pair.jax.ev._caps.as_dict() != cls
        assert pair.port.ev.delta_stats()["fallbacks"] >= 1
    finally:
        pair.close()


# ------------------------------------------------------ the reason taxonomy


def _grow_past_kr(store, caps):
    extra = [rule_doc(f"ov{i}", i, effect="DENY")
             for i in range(caps.KR + 4)]
    store.get_resource_service("rule").create(extra)
    p0 = store.collections["policy"].get("p0")
    p0["rules"] = p0["rules"] + [r["id"] for r in extra]
    store.get_resource_service("policy").update([p0])


def _change_ca(store, _caps):
    p0 = store.collections["policy"].get("p0")
    p0["combining_algorithm"] = FA
    store.get_resource_service("policy").update([p0])


def _add_condition(store, _caps):
    doc = rule_doc("r2", 2)
    doc["condition"] = "True"
    store.get_resource_service("rule").update([doc])


def _add_set(store, _caps):
    store.get_resource_service("policy_set").create([{
        "id": "s1", "combining_algorithm": DO, "policies": ["p1"]}])


def _same_doc(store, _caps):
    store.get_resource_service("rule").update([rule_doc("r0", 0)])


def _cross_threshold(store, _caps):
    store.get_resource_service("rule").create([rule_doc("x512", 3)])
    p0 = store.collections["policy"].get("p0")
    p0["rules"] = p0["rules"] + ["x512"]
    store.get_resource_service("policy").update([p0])


# (mutation, seed rules, seed policies, the reason; None: a noop)
REASONS = {
    "capacity": (_grow_past_kr, 8, 1, "capacity-rules"),
    "combining-algorithm": (_change_ca, 12, 2, "combining-algorithm-changed"),
    "condition": (_add_condition, 12, 2, "condition-added"),
    "set-list": (_add_set, 12, 2, "set-list-changed"),
    "noop": (_same_doc, 12, 2, None),
    "prefilter-threshold": (_cross_threshold, 511, 1,
                            "prefilter-threshold-crossed"),
}


@pytest.mark.parametrize("case", sorted(REASONS))
def test_fallback_reason_matches_jax(case):
    mutate, n_rules, n_policies, reason = REASONS[case]
    pair = Pair(n_rules=n_rules, n_policies=n_policies)
    try:
        before = stats_of(pair.port.ev)
        caps = pair.port.ev._caps
        mutate(pair.jax.store, caps)
        mutate(pair.port.store, caps)
        got = stats_of(pair.port.ev)
        assert got == stats_of(pair.jax.ev)
        if reason is None:
            assert got["noops"] == before["noops"] + 1
            assert got["full_compiles"] == before["full_compiles"]
            assert got["fallback_reasons"] == {}
        else:
            assert got["fallback_reasons"] == {reason: 1}
            assert got["full_compiles"] == before["full_compiles"] + 1
        pair.check(range(8), what=case)
    finally:
        pair.close()


# ----------------------------------------------------------- program reuse


@pytest.mark.parametrize("n_rules", [12, 600])
def test_in_capacity_patch_adds_no_runner_and_no_build(n_rules):
    """After ``TestProgramReuse``: a warm kernel, one in-capacity patch,
    the same traffic again.  The kernel object is new; the runner
    registry (the same runner objects under the same keys), the builds
    and the loaded libraries are not (the 600-rule tree runs the
    signature path's runners, the 12-rule tree the dense kernel's)."""
    side = Side("port", stack_docs(n_rules, 2), cache=False)
    try:
        traffic = list(range(12))
        side.answers(traffic)
        shared = side.ev._shared_jits
        assert shared, "delta mode must register shared runners"
        runners = dict(shared)
        builds = (dict(cuda_build.BUILD_LOG), set(cuda_build._libs),
                  set(tkernel._libs))
        kernel = side.ev._kernel
        side.store.get_resource_service("rule").update(
            [rule_doc("r3", 3, effect="DENY")])
        assert side.ev.delta_stats()["patches"] == 1
        assert side.ev._kernel is not kernel
        side.answers(traffic)
        assert side.ev._shared_jits is shared
        assert shared.keys() == runners.keys()
        assert all(shared[k] is run for k, run in runners.items())
        assert (dict(cuda_build.BUILD_LOG), set(cuda_build._libs),
                set(tkernel._libs)) == builds
    finally:
        side.ev.shutdown()


def test_signature_kernels_serve_patched_tables(monkeypatch):
    """600 rules (above MIN_RULES): after a patch the batch takes
    sig_planes and sig_decide, a batch with property rows
    decide_grouped, on the patched, bucketed tables; the answers equal
    the JAX evaluator's and the oracle's."""
    called: list = []
    for name in ("sig_planes", "sig_decide", "decide_grouped"):
        orig = getattr(tprefilter, name)

        def spy(*args, _orig=orig, _name=name, **kw):
            called.append(_name)
            return _orig(*args, **kw)

        monkeypatch.setattr(tprefilter, name, spy)
    pair = Pair(n_rules=600, n_policies=2, cache=False)
    try:
        assert pair.port.ev._compiled.KR == 512
        assert pair.port.ev._kernel.active
        for side in (pair.jax, pair.port):
            side.store.get_resource_service("rule").update(
                [rule_doc("r7", 9, effect="DENY")])
        assert pair.port.ev.delta_stats()["patches"] == 1
        called.clear()
        keys = range(16)
        pair.check(keys, what="patched")
        assert {"sig_planes", "sig_decide"} <= set(called)
        called.clear()
        got = pair.port.answers(keys, prop=True)
        assert called == ["decide_grouped"]
        assert got == pair.jax.answers(keys, prop=True)
        oracle = [pair.port.engine.is_allowed(make_request(tmodels, k, who,
                                                           True))
                  for k in keys for who in ("u1", "u2")]
        assert [g[0] for g in got] == [o.decision for o in oracle]
    finally:
        pair.close()


def test_delta_disabled_recompiles_in_full():
    side = Side("port", stack_docs(12, 2), cache=True, delta_enabled=False)
    try:
        base = side.ev.delta_stats()
        assert base["enabled"] is False and "capacities" not in base
        side.store.get_resource_service("rule").update(
            [rule_doc("r0", 0, effect="DENY")])
        stats = side.ev.delta_stats()
        assert stats["patches"] == 0
        assert stats["full_compiles"] == base["full_compiles"] + 1
        assert side.ev._compiled.KR == 6  # unpadded
        assert side.answers([0])[0][0] == "DENY"
    finally:
        side.ev.shutdown()


def test_scoped_post_swap_bump_keeps_disjoint_entries():
    """The scoped bumps (the store's before the swap, the evaluator's
    after it) keep the entries of untouched entities, as in JAX."""
    pair = Pair()
    try:
        keys = [0, 1, 6]
        for side in (pair.jax, pair.port):
            side.answers(keys)
            side.store.get_resource_service("rule").update(
                [rule_doc("r0", 0, effect="DENY")])
        answers = pair.port.answers(keys)
        assert answers == pair.jax.answers(keys)
        assert answers[0][0] == "DENY"
        want, got = pair.jax.cache.stats(), pair.port.cache.stats()
        assert got["scoped_survivors"] >= 4
        for key in ("epoch", "scoped_bumps", "scoped_survivors", "hits",
                    "stores"):
            assert got[key] == want[key], key
    finally:
        pair.close()
