"""The port's PrefilteredKernel against the JAX package's PrefilteredKernel.

Both kernels are handed the same JAX-compiled tables and encoded batches
(the port accepts either package's numpy objects).  The port runs on
``device="cpu"``, i.e. the plain PyTorch versions of its three kernels
(``ops/prefilter_ref.py``); the JAX kernel is jitted on the CPU, as
``tests/test_prefilter.py`` and ``tests/test_sig_kernel.py`` run it.
Outputs are int32 codes and the signature planes bools and int32s: every
comparison is exact (tolerance 0).  The cases mirror those two files:
fixtures forced onto the signature machinery, the stress differential,
cache reuse and counters, a batch larger than the cache, the
``max_groups`` guard split, an HR tree, conditions and aborts, property
and ACL rows on the per-row path, and the 511/512-rule boundary.
"""

import random

import numpy as np
import pytest
import torch

from access_control_srv_tpu.core import AccessController
from access_control_srv_tpu.core.loader import load_policy_sets
from access_control_srv_tpu.models import Attribute, Request, Target, Urns
from access_control_srv_tpu.ops import PrefilteredKernel as JaxPrefiltered
from access_control_srv_tpu.ops import compile_policies as jcompile
from access_control_srv_tpu.ops import encode_requests as jencode
from access_control_srv_tpu.ops import prefilter as jprefilter
from access_control_srv_tpu.srv.telemetry import Telemetry
from access_control_srv_tpu_torch.ops import MIN_RULES, PrefilteredKernel
from access_control_srv_tpu_torch.ops import prefilter as tprefilter
from access_control_srv_tpu_torch.ops.carry import half_pow2_bucket
from access_control_srv_tpu_torch.ops.staging import HostBufferPool

from .test_fuzz_extended import FOREIGN
from .test_kernel_differential import (
    ACTIONS,
    DEC_CODE,
    ENTITIES,
    ROLES,
    SUBJECTS,
    grid_requests,
)
from .test_prefilter import _stress_doc, force_active
from .test_sig_kernel import _sig_requests, _sig_tree
from .utils import URNS, build_request, make_engine

ORG = "urn:restorecommerce:acs:model:organization.Organization"
USER = "urn:restorecommerce:acs:model:user.User"
LOC = "urn:restorecommerce:acs:model:location.Location"

PREFILTER_FIXTURES = [
    "basic_policies.yml", "policy_targets.yml", "policy_set_targets.yml",
    "role_scopes.yml", "conditions.yml", "acl_policies.yml",
    "props_multi_rules_entities.yml", "ops_multi.yml",
]


class Paths:
    """The counter surface both kernels report to (``.paths.inc``)."""

    def __init__(self):
        self.counts: dict[str, int] = {}
        self.paths = self

    def inc(self, key, n=1):
        self.counts[key] = self.counts.get(key, 0) + n

    def get(self, key):
        return self.counts.get(key, 0)


def port_kernel(compiled, force=False, **kw):
    kern = PrefilteredKernel(compiled, device="cpu", **kw)
    if force and not kern.active:
        kern.active = True
        kern._dense = None
    return kern


def assert_same(want, got, what=""):
    for name, w, g in zip(("decision", "cacheable", "status"), want, got):
        assert g.dtype == np.int32, (what, name)
        assert np.array_equal(np.asarray(w), g), (what, name)


def engine_of(doc):
    engine = AccessController()
    for ps in load_policy_sets(doc):
        engine.update_policy_set(ps)
    return engine


def stress_requests(entities, actions, n=200, seed=5, roles=29):
    urns = Urns()
    rng = random.Random(seed)
    out = []
    for i in range(n):
        role = f"role-{i % roles}"
        out.append(Request(
            target=Target(
                subjects=[Attribute(id=urns["role"], value=role),
                          Attribute(id=urns["subjectID"], value=f"u{i}")],
                resources=[
                    Attribute(id=urns["entity"], value=rng.choice(entities)),
                    Attribute(id=urns["resourceID"], value=f"id-{i}"),
                ],
                actions=[Attribute(id=urns["actionID"],
                                   value=rng.choice(actions))],
            ),
            context={"resources": [], "subject": {
                "id": f"u{i}",
                "role_associations": [{"role": role, "attributes": []}],
                "hierarchical_scopes": []}},
        ))
    return out


def assert_planes_equal(jk, tk):
    """The port's cached K2 planes equal the JAX kernel's ``_bits`` dict
    key for key (same signature-set keys, same plane names, dtypes and
    values)."""
    assert jk._bits and list(jk._bits) == list(tk._bits)
    for key, jbits in jk._bits.items():
        tbits = tk._bits[key]
        assert sorted(jbits) == sorted(tbits)
        for name, j in jbits.items():
            j = np.asarray(j)
            t = tbits[name].numpy()
            assert t.dtype == j.dtype and np.array_equal(j, t), name


@pytest.fixture(scope="module")
def stress():
    doc, entities, actions = _stress_doc()
    compiled = jcompile(engine_of(doc).policy_sets, engine_of(doc).urns)
    assert compiled.supported and compiled.n_rules >= MIN_RULES
    return doc, entities, actions, compiled


# ------------------------------------------------------------ host pieces


@pytest.mark.parametrize("name", ["stress", "role_scopes.yml", "acl_policies.yml",
                                  "ops_multi.yml"])
def test_compact_rules_byte_equal(name, stress):
    """``compact_rules`` and ``_pad_sub`` are copies: the same candidate
    rows give byte-equal subtrees."""
    if name == "stress":
        compiled = stress[3]
    else:
        engine = make_engine(name)
        compiled = jcompile(engine.policy_sets, engine.urns)
    rng = np.random.default_rng(3)
    for _ in range(4):
        cand = rng.random(compiled.T) < 0.5
        j = jprefilter.compact_rules(compiled, cand)
        t = tprefilter.compact_rules(compiled, cand)
        assert (j.KR, j.T) == (t.KR, t.T)
        assert sorted(j.arrays) == sorted(t.arrays)
        krp, tp = 2 * j.KR, j.T + 5
        for k, v in j.arrays.items():
            assert np.array_equal(v, t.arrays[k]) and v.dtype == t.arrays[k].dtype
            if jprefilter._is_varying(k):
                assert tprefilter._is_varying(k)
                assert np.array_equal(jprefilter._pad_sub(v, k, krp, tp),
                                      tprefilter._pad_sub(v, k, krp, tp))


def test_buckets_match():
    from access_control_srv_tpu.ops.kernel import half_pow2_bucket as jb

    for n in list(range(0, 80)) + [767, 768, 769, 1023, 1025, 16384, 12289]:
        for floor in (1, 8):
            assert half_pow2_bucket(n, floor) == jb(n, floor), (n, floor)


def test_staging_pool_leases():
    """Lease and release discipline: recycled buffers come back by
    (shape, dtype), double release raises, the tensor view shares the
    buffer's memory."""
    pool = HostBufferPool(max_per_key=2)
    a = pool.acquire((4, 3))
    pool.tensor(a).fill_(7)
    assert (a == 7).all() and a.dtype == np.int32
    pool.release(a)
    with pytest.raises(ValueError):
        pool.release(a)
    b = pool.acquire((4, 3))
    assert b is a and pool.stats()["hits"] == 1
    c = pool.acquire((4, 3), np.bool_)
    assert c.dtype == np.bool_ and pool.leased_count() == 2
    pool.release_all([b, c])
    assert pool.leased_count() == 0


# ------------------------------------------------------ kernel against JAX


@pytest.mark.parametrize("name", PREFILTER_FIXTURES)
def test_fixtures_forced_active(name):
    """Fixture trees sit under MIN_RULES: both kernels are forced onto
    the signature machinery (ACL and property rows in the grid take the
    per-row kernel, the rest the signature kernel)."""
    engine = make_engine(name)
    compiled = jcompile(engine.policy_sets, engine.urns)
    jk = force_active(JaxPrefiltered(compiled))
    tk = port_kernel(compiled, force=True)
    specs = grid_requests(n=96, seed=53)
    batch = jencode(specs, compiled)
    assert_same(jk.evaluate(batch), tk.evaluate(batch), name)
    sig_only = [r for r, acl, props in zip(
        specs, batch.arrays["r_acl_ent"].max(axis=1) >= 0,
        batch.arrays["r_has_props"]) if not acl and not props]
    sig_batch = jencode(sig_only, compiled)
    assert_same(jk.evaluate(sig_batch), tk.evaluate(sig_batch), name)
    assert_planes_equal(jk, tk)


def test_stress_differential(stress):
    """The ~720-rule stress tree (above MIN_RULES): equal to the JAX
    kernel and, on a sample, to the oracle; compaction really happened."""
    doc, entities, actions, compiled = stress
    engine = engine_of(doc)
    requests = stress_requests(entities, actions)
    batch = jencode(requests, compiled)
    assert batch.eligible.all()
    jk = JaxPrefiltered(compiled)
    tk = port_kernel(compiled)
    assert tk.active
    got = tk.evaluate(batch)
    assert_same(jk.evaluate(batch), got)
    assert_planes_equal(jk, tk)
    for b in (0, 7, 63, 199):
        assert got[0][b] == DEC_CODE[engine.is_allowed(requests[b]).decision]
    sub = next(iter(tk._subs.values()))
    assert sub.KR < compiled.KR / 2 and sub.T < compiled.T / 2


def test_cache_reuse_and_counters(stress):
    """Signature subtrees, stacks and planes are cached; the port counts
    the same hits and misses as the JAX kernel on the same traffic."""
    doc, entities, actions, compiled = stress
    jt, tt = Telemetry(), Paths()
    jk = JaxPrefiltered(compiled, telemetry=jt)
    tk = port_kernel(compiled, telemetry=tt)
    urns = Urns()

    def mk(ent):
        return Request(
            target=Target(
                subjects=[Attribute(id=urns["subjectID"], value="u")],
                resources=[Attribute(id=urns["entity"], value=ent)],
                actions=[Attribute(id=urns["actionID"], value=urns["read"])],
            ),
            context={"resources": [], "subject": {"id": "u"}},
        )

    for order in ((0, 1), (1, 0), (0, 1)):
        batch = jencode([mk(entities[i]) for i in order], compiled)
        assert_same(jk.evaluate(batch), tk.evaluate(batch))
    assert len(tk._subs) == 2
    for key in ("prefilter-sub-miss", "prefilter-sub-hit",
                "prefilter-stack-miss", "prefilter-stack-hit"):
        assert tt.get(key) == jt.paths.get(key), key
    assert tt.get("prefilter-sub-hit") == 4
    assert list(jk._stacks) == list(tk._stacks)
    assert list(jk._bits) == list(tk._bits)


def test_batch_larger_than_cache(stress):
    """One batch with more signatures than ``cache_size`` keeps its own
    subtrees while it runs."""
    doc, entities, actions, compiled = stress
    urns = Urns()
    reqs = [Request(
        target=Target(
            subjects=[Attribute(id=urns["subjectID"], value="u")],
            resources=[Attribute(id=urns["entity"], value=entities[i % 8])],
            actions=[Attribute(id=urns["actionID"], value=actions[i % 4])],
        ),
        context={"resources": [], "subject": {"id": "u"}},
    ) for i in range(32)]
    batch = jencode(reqs, compiled)
    tk = port_kernel(compiled, cache_size=2)
    assert_same(JaxPrefiltered(compiled, cache_size=2).evaluate(batch),
                tk.evaluate(batch))
    assert len(tk._subs) <= 2


def test_guard_split():
    """Every request a novel entity pair: with ``max_groups=4`` the batch
    is split into segments of at most 4 signatures; outputs, counters and
    stack sizes match the JAX kernel's."""
    rng = random.Random(42)
    engine = engine_of(_sig_tree(rng))
    compiled = jcompile(engine.policy_sets, engine.urns)
    assert compiled.supported
    pool = ENTITIES + FOREIGN
    requests = [build_request(
        subject_id=SUBJECTS[i % len(SUBJECTS)],
        subject_role=ROLES[i % len(ROLES)],
        resource_type=[pool[i % len(pool)], pool[(i * 7 + 1) % len(pool)]],
        resource_id=[f"id-{i}-0", f"id-{i}-1"],
        action_type=ACTIONS[i % len(ACTIONS)],
    ) for i in range(40)]
    batch = jencode(requests, compiled)
    jt, tt = Telemetry(), Paths()
    jk = force_active(JaxPrefiltered(compiled, max_groups=4, telemetry=jt))
    tk = port_kernel(compiled, force=True, max_groups=4, telemetry=tt)
    assert_same(jk.evaluate(batch), tk.evaluate(batch))
    assert tt.get("prefilter-guard-splits") == 1
    for key in ("prefilter-guard-splits", "prefilter-sub-miss",
                "prefilter-stack-miss"):
        assert tt.get(key) == jt.paths.get(key), key
    for stack in tk._stacks.values():
        assert all(v.shape[0] <= 4 for v in stack.tables.values())


def test_sig_trees_randomized():
    """Randomized HR-trivial trees with foreign-namespace entities
    (regex prefix resets), multi-entity ordered runs and operations on
    the signature path: outputs and planes equal the JAX kernel's."""
    rng = random.Random(1234)
    n_trees = 0
    for _ in range(4):
        engine = engine_of(_sig_tree(rng))
        compiled = jcompile(engine.policy_sets, engine.urns)
        requests = _sig_requests(rng, 48)
        if not compiled.supported:
            continue
        jk = force_active(JaxPrefiltered(compiled))
        tk = port_kernel(compiled, force=True)
        batch = jencode(requests, compiled)
        assert_same(jk.evaluate(batch), tk.evaluate(batch))
        assert_planes_equal(jk, tk)
        n_trees += 1
    assert n_trees >= 3


def hr_requests(n, seed):
    rng = random.Random(seed)
    owners = ["Org1", "Org2", "Org3", "SuperOrg1", "otherOrg"]
    return [build_request(
        subject_id=f"user-{i % 16}",
        subject_role=["member", "manager", "guest"][i % 3],
        role_scoping_entity=ORG,
        role_scoping_instance=rng.choice(owners),
        resource_type=LOC if i % 2 else ORG,
        resource_id=f"L{i}",
        action_type=URNS["read"] if i % 3 else URNS["modify"],
        owner_indicatory_entity=ORG,
        owner_instance=rng.choice(owners),
    ) for i in range(n)]


def test_hr_tree_on_signature_path():
    """An HR-bearing tree: collection state and op hits ride the planes,
    the owner side the packed row; equal to the JAX kernel and, on
    eligible rows, to the oracle."""
    engine = make_engine("role_scopes.yml")
    compiled = jcompile(engine.policy_sets, engine.urns)
    requests = hr_requests(48, 21)
    batch = jencode(requests, compiled)
    jk = force_active(JaxPrefiltered(compiled))
    tk = port_kernel(compiled, force=True)
    assert tk.needs_hr
    got = tk.evaluate(batch)
    assert_same(jk.evaluate(batch), got)
    assert_planes_equal(jk, tk)
    assert "rl_collect" in next(iter(tk._bits.values()))
    n = 0
    for b, req in enumerate(requests):
        if batch.eligible[b]:
            assert got[0][b] == DEC_CODE[engine.is_allowed(req).decision]
            n += 1
    assert n > 30


def test_conditions_and_aborts():
    """Condition-bearing rules (true / false / abort) through the
    signature kernel: exact status codes and cacheable bits."""
    engine = make_engine("conditions.yml")
    compiled = jcompile(engine.policy_sets, engine.urns)
    requests = _sig_requests(random.Random(3), 48)
    requests.append(Request(
        target=Target(
            subjects=[Attribute(id=URNS["role"], value="member")],
            resources=[Attribute(id=URNS["entity"], value=USER)],
            actions=[Attribute(id=URNS["actionID"], value=URNS["modify"])],
        ),
        context={"resources": [{"id": "someone-else"}],
                 "subject": {"role_associations": [
                     {"role": "member", "attributes": []}],
                     "hierarchical_scopes": []}},
    ))
    batch = jencode(requests, compiled)
    jk = force_active(JaxPrefiltered(compiled))
    tk = port_kernel(compiled, force=True)
    got = tk.evaluate(batch)
    assert_same(jk.evaluate(batch), got)
    assert tk._bits and (got[2] != 200).any()


def test_combining_algorithms():
    """Every first / last choice of the combining algorithms shows in the
    outputs: the signature path and the per-row path against JAX."""
    from access_control_srv_tpu import models as jmodels

    from .test_torch_carryover import build_request as spec_request
    from .test_torch_kernel import combining_case

    doc, specs = combining_case()
    engine = engine_of(doc)
    compiled = jcompile(engine.policy_sets, engine.urns)
    jk = force_active(JaxPrefiltered(compiled))
    tk = port_kernel(compiled, force=True)
    batch = jencode([spec_request(s, jmodels) for s in specs], compiled)
    got = tk.evaluate(batch)
    assert_same(jk.evaluate(batch), got)
    assert tk._bits


def test_property_and_acl_rows_take_the_row_path():
    """One property row or one ACL row sends the whole batch to the
    per-row kernel (no new planes), with outputs equal to JAX's."""
    engine = make_engine("acl_policies.yml")
    compiled = jcompile(engine.policy_sets, engine.urns)
    jk = force_active(JaxPrefiltered(compiled))
    tk = port_kernel(compiled, force=True)
    base = _sig_requests(random.Random(9), 16)
    prop = build_request(
        subject_id=SUBJECTS[0], subject_role=ROLES[0],
        resource_type=ENTITIES[0], resource_id="id-p",
        action_type=URNS["read"],
        resource_property=[LOC + "#name"],
    )
    acl = build_request(
        subject_id="ada", subject_role="member", role_scoping_entity=ORG,
        role_scoping_instance="Org1", resource_type=ORG, resource_id="id-a",
        action_type=URNS["create"], acl_indicatory_entity=ORG,
        acl_instances=["Org1", "Org2"],
    )
    for extra in (prop, acl):
        batch = jencode(base + [extra], compiled)
        assert (batch.arrays["r_has_props"].any()
                or (batch.arrays["r_acl_ent"] >= 0).any())
        n_bits = len(tk._bits)
        assert_same(jk.evaluate(batch), tk.evaluate(batch))
        assert len(tk._bits) == n_bits


@pytest.mark.parametrize("extra_rules", [0, 1])
def test_min_rules_boundary(extra_rules):
    """511 rules delegate to the dense kernel, 512 take the signature
    machinery; both equal the JAX kernel on signature and ACL traffic of
    the HR-scoped stress tree."""
    import chip_smoke

    doc = chip_smoke.stress_doc(511, scoped=True)
    rules = doc["policy_sets"][0]["policies"][0]["rules"]
    for i in range(extra_rules):
        rules.append({**rules[0], "id": f"extra-{i}"})
    engine = engine_of(doc)
    compiled = jcompile(engine.policy_sets, engine.urns)
    assert compiled.n_rules == 511 + extra_rules
    jk = JaxPrefiltered(compiled)
    tk = port_kernel(compiled)
    assert tk.active == jk.active == (extra_rules == 1)
    rng = random.Random(23)
    reqs = chip_smoke.grid_requests(rng, 24, stress=True)
    sig = chip_smoke.grid_requests(rng, 24, stress=True, acl=False)
    for requests in (reqs, sig):
        batch = jencode(requests, compiled)
        assert_same(jk.evaluate(batch), tk.evaluate(batch))
    if tk.active:
        assert_planes_equal(jk, tk)


def test_async_materialize_releases_leases(stress):
    """The staging leases stay out until ``materialize`` and come back
    after it; a second batch reuses them."""
    doc, entities, actions, compiled = stress
    pool = HostBufferPool()
    tk = port_kernel(compiled, staging=pool)
    batch = jencode(stress_requests(entities, actions, n=40), compiled)
    thunk = tk.evaluate_async(batch)
    assert pool.leased_count() == 5
    first = thunk()
    assert pool.leased_count() == 0
    assert_same(first, tk.evaluate(batch))
    assert pool.stats()["hits"] == 5


def test_refusals(stress):
    doc, entities, actions, compiled = stress
    # ``dynamic_policies`` / ``shared_jits``, refused before the delta
    # slice, are served: the outputs equal the JAX kernel's in the same
    # mode, and a second kernel on the same registry adds no runner
    batch = jencode(stress_requests(entities, actions, n=40), compiled)
    want = JaxPrefiltered(compiled, dynamic_policies=True,
                          shared_jits={}).evaluate(batch)
    shared: dict = {}
    for _ in range(2):
        got = PrefilteredKernel(compiled, device="cpu", dynamic_policies=True,
                                shared_jits=shared).evaluate(batch)
        for w, g in zip(want, got):
            assert np.array_equal(np.asarray(w), g)
        if _ == 0:
            keys = sorted(shared, key=repr)
    assert keys and sorted(shared, key=repr) == keys
    assert {k[0] for k in shared} == {"bits", "sig"}
    # explain, refused before the explain slice, is served: the four
    # outputs equal the JAX kernel's on the stress tree's signature path
    batch = jencode(stress_requests(entities, actions, n=40), compiled)
    want = JaxPrefiltered(compiled, explain=True).evaluate(batch)
    got = port_kernel(compiled, explain=True).evaluate(batch)
    assert len(got) == 4
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g)
    # ``mesh`` and ``axis``, refused before the multi-device slice, are
    # served: a 1-rank mesh and an explicit axis equal the JAX kernel on
    # a 1-device mesh (multi-rank meshes: tests/test_torch_mesh.py)
    import jax
    from jax.sharding import Mesh

    from access_control_srv_tpu_torch.parallel import make_mesh

    batch = jencode(stress_requests(entities, actions, n=40), compiled)
    want = JaxPrefiltered(compiled, mesh=Mesh(np.array(jax.devices()[:1]),
                                              ("data",))).evaluate(batch)
    for kw in (dict(mesh=make_mesh(device="cpu")), dict(axis="data")):
        tk = PrefilteredKernel(compiled, device="cpu", **kw)
        assert tk.active
        assert_same(want, tk.evaluate(batch))
    # relation-path trees, refused before the ReBAC slice, are decided by
    # the dense delegate and, forced, by the signature path, both equal
    # to the JAX kernel's
    from access_control_srv_tpu.srv.relations import RelationTupleStore

    doc = "urn:restorecommerce:acs:model:document.Document"
    engine = make_engine("relation_policies.yml")
    rc = jcompile(engine.policy_sets, engine.urns)
    store = RelationTupleStore()
    store.create([(doc, "doc1", "viewer", "alice")])
    reqs = [build_request(subject_id=s, resource_type=doc, resource_id=d,
                          action_type=URNS["read"])
            for s in ("alice", "bob") for d in ("doc1", "doc2")]
    batch = jencode(reqs, rc, relation_tables=store.tables_for(rc))
    for force in (False, True):
        tk = port_kernel(rc, force=force)
        assert tk.needs_rel and tk.active == force
        jk = JaxPrefiltered(rc)
        if force:
            force_active(jk)
        got = tk.evaluate(batch)
        assert_same(jk.evaluate(batch), got)
        assert got[0].tolist() == [1, 2, 2, 2]


def test_device_none_raises_without_cuda(stress, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        PrefilteredKernel(stress[3])
