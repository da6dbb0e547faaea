"""The port's decision cache against the JAX package's.

``srv/decision_cache.py`` is a host-only copy: the same request must give
the same fingerprint and features in both packages, one scripted sequence
of puts, gets, epoch bumps, evictions, flushes and TTL expiries (with an
injected clock) the same results and ``stats()``, and the evaluators' cold
and warm batch passes the same responses and hit counts.  Relation-tuple
churn and ``refresh`` turn a hit into a miss.
"""

import copy

import pytest

import access_control_srv_tpu_torch.models as tmodels
import access_control_srv_tpu_torch.models.model as tmodel
import chip_smoke
from access_control_srv_tpu import models as jmodels
from access_control_srv_tpu.models import model as jmodel
from access_control_srv_tpu.core import AccessController as JaxController
from access_control_srv_tpu.core.loader import load_policy_sets as jax_load
from access_control_srv_tpu.srv import decision_cache as jdc
from access_control_srv_tpu.srv.evaluator import HybridEvaluator as JaxEvaluator
from access_control_srv_tpu.srv.relations import (
    RelationTupleStore as JaxStore,
)
from access_control_srv_tpu_torch.srv import decision_cache as tdc
from access_control_srv_tpu_torch.srv.evaluator import HybridEvaluator
from access_control_srv_tpu_torch.srv.relations import RelationTupleStore

from .test_kernel_differential import grid_requests
from .test_torch_carryover import build_request, request_spec
from .test_torch_evaluator import oracle_specs, response_key
from .utils import URNS

SUBJECT = URNS["subjectID"]


def twin_specs() -> list[dict]:
    specs = [request_spec(r) for r in grid_requests(n=64, seed=11)]
    specs += oracle_specs()
    # a reordered target keeps its key; a changed context changes it
    reordered = copy.deepcopy(specs[0])
    reordered["target"]["subjects"].reverse()
    scoped = copy.deepcopy(specs[1])
    scoped["context"]["subject"]["hierarchical_scopes"] = [{"id": "o"}]
    return specs + [reordered, scoped]


def test_fingerprints_and_features_match_jax():
    keys = set()
    for i, spec in enumerate(twin_specs()):
        j = build_request(spec, jmodels)
        t = build_request(spec, tmodels)
        jk = jdc.request_fingerprint(j, SUBJECT)
        tk = tdc.request_fingerprint(t, SUBJECT)
        assert tk == jk, i
        keys.add(tk)
        want = jdc.request_features(j, URNS["entity"], URNS["operation"])
        got = tdc.request_features(t, URNS["entity"], URNS["operation"])
        assert got == want, i
    assert len(keys) > 40


class Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def _response(models, decision="PERMIT", cacheable=True, code=200):
    return models.Response(
        decision=getattr(models.Decision, decision), obligations=[],
        evaluation_cacheable=cacheable,
        operation_status=models.OperationStatus(code=code, message="success"),
    )


def run_script(dc, models):
    """One scripted sequence; returns every call's result (responses by
    their key) and the stats after each step."""
    clock = Clock()
    cache = dc.DecisionCache(ttl_s=10.0, max_entries=8, shards=2,
                             time_fn=clock)
    out = []

    def get(key):
        resp = cache.get(key)
        out.append(None if resp is None else response_key(resp))

    def step(result):
        out.append(result)
        out.append(cache.stats())

    for i in range(6):
        step(cache.put(f"u{i % 3}\x1fk{i}", _response(models)))
    step(cache.put("u9\x1fno", _response(models, cacheable=False)))
    step(cache.put("u9\x1ferr", _response(models, code=500)))
    for i in range(6):
        get(f"u{i % 3}\x1fk{i}")
    for i in range(6, 14):  # past the LRU bound
        step(cache.put(f"v\x1fk{i}", _response(models, "DENY")))
    get("u0\x1fk0")
    get("v\x1fk13")
    epoch = cache.epoch
    step(cache.bump_epoch())
    get("v\x1fk13")
    step(cache.put("v\x1fstale", _response(models), epoch=epoch))
    step(cache.put("v\x1ffresh", _response(models), epoch=cache.epoch))
    clock.now += 5.0
    get("v\x1ffresh")
    clock.now += 6.0  # past the TTL
    get("v\x1ffresh")
    for i in range(4):
        step(cache.put(f"alice\x1fk{i}", _response(models)))
        step(cache.put(f"alina\x1fk{i}", _response(models)))
    step(cache.evict_subject("alice"))
    step(cache.evict_pattern("ali"))
    step(cache.put("bob\x1fk", _response(models)))
    step(cache.flush())
    get("bob\x1fk")
    return out


def test_scripted_sequence_matches_jax():
    assert run_script(tdc, tmodel) == run_script(jdc, jmodel)


def cacheable_engines(n_rules: int = 300):
    """(JAX engine, port engine) over a cacheable stress tree (dense
    path)."""
    doc = chip_smoke.stress_doc(n_rules, cacheable=True)
    jeng = JaxController()
    for ps in jax_load(copy.deepcopy(doc)):
        jeng.update_policy_set(ps)
    teng = chip_smoke.engine_from_doc(doc)
    return jeng, teng


def traffic():
    return [request_spec(r) for r in chip_smoke.stress_traffic(96, seed=5)]


def test_cold_then_warm_passes_match_jax():
    jeng, teng = cacheable_engines()
    jcache, tcache = jdc.DecisionCache(), tdc.DecisionCache()
    jev = JaxEvaluator(jeng, delta_enabled=False, decision_cache=jcache)
    tev = HybridEvaluator(teng, device="cpu", decision_cache=tcache)
    specs = traffic()
    for _ in ("cold", "warm"):
        want = jev.is_allowed_batch([build_request(s, jmodels)
                                     for s in specs])
        got = tev.is_allowed_batch([build_request(s, tmodels)
                                    for s in specs])
        assert [response_key(r) for r in got] == \
            [response_key(r) for r in want]
        assert tcache.stats() == jcache.stats()
    stats = tcache.stats()
    assert stats["hits"] > 0 and stats["stores"] == stats["hits"]
    # the single-request path reads and writes the same cache
    spec = specs[0]
    assert response_key(tev.is_allowed(build_request(spec, tmodels))) == \
        response_key(jev.is_allowed(build_request(spec, jmodels)))
    assert tcache.stats() == jcache.stats()


@pytest.mark.parametrize("bump", ["relation_churn", "refresh"])
def test_bump_turns_hit_into_miss(bump):
    jeng, teng = cacheable_engines()
    jcache, tcache = jdc.DecisionCache(), tdc.DecisionCache()
    jev = JaxEvaluator(jeng, delta_enabled=False, decision_cache=jcache)
    tev = HybridEvaluator(teng, device="cpu", decision_cache=tcache)
    jstore, tstore = JaxStore(), RelationTupleStore()
    jev.attach_relation_store(jstore)
    tev.attach_relation_store(tstore)
    specs = traffic()

    def run():
        jev.is_allowed_batch([build_request(s, jmodels) for s in specs])
        tev.is_allowed_batch([build_request(s, tmodels) for s in specs])
        assert tcache.stats() == jcache.stats()
        return tcache.stats()

    run()
    warm = run()
    assert warm["hits"] > 0
    if bump == "relation_churn":
        for store in (jstore, tstore):
            store.create([("doc", "d1", "viewer", "ada")])
        assert tev.relation_churn == 1
    else:
        jev.refresh(wait=True)
        tev.refresh(wait=True)
    after = run()
    assert after["hits"] == warm["hits"]  # every lookup missed
    assert after["epoch"] == warm["epoch"] + 1
    assert run()["hits"] > after["hits"]  # and warms again
