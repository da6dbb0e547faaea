"""Token / HR-scope preparation and the identity clients, port against JAX.

``HybridEvaluator.prepare_batch`` resolves every distinct subject token
through the engine's identity client and runs one HR-scope rendezvous per
distinct cache key; the port must produce the JAX evaluator's responses,
``_token_resolved`` flags and encode eligibility.  ``CachingIdentityClient``
(TTL, negative caching, evictions) is scripted on both sides, and the
port's ``GrpcIdentityClient`` is driven against its ``MockIdentityServer``
over loopback.
"""

import pytest

import access_control_srv_tpu_torch.models as tmodels
from access_control_srv_tpu import models as jmodels
from access_control_srv_tpu.ops import encode_requests as jencode
from access_control_srv_tpu.srv import cache as jcache
from access_control_srv_tpu.srv import identity as jids
from access_control_srv_tpu.srv.evaluator import HybridEvaluator as JaxEvaluator
from access_control_srv_tpu_torch.core import AccessController
from access_control_srv_tpu_torch.core.loader import load_policy_sets
from access_control_srv_tpu_torch.ops import encode_requests as tencode
from access_control_srv_tpu_torch.srv import cache as tcache
from access_control_srv_tpu_torch.srv import identity as tids
from access_control_srv_tpu_torch.srv.evaluator import HybridEvaluator
from access_control_srv_tpu_torch.srv.faults import REGISTRY

from .test_token_pipeline import payload_for, role_tree, token_request
from .test_token_pipeline import wired_engine as jax_wired_engine
from .test_torch_carryover import build_request, request_spec
from .test_torch_evaluator import response_key


def port_wired_engine(scopes=()):
    """The port's twin of ``test_token_pipeline.wired_engine``."""
    engine = AccessController()
    for ps in load_policy_sets(role_tree()):
        engine.update_policy_set(ps)
    ids = tids.StaticIdentityClient()
    for i in range(8):
        ids.register(f"tok-{i}", payload_for(i))
    engine.identity_client = tids.CachingIdentityClient(ids)
    cache = tcache.SubjectCache()
    for i in range(8):
        cache.set(f"cache:user-{i}:hrScopes", list(scopes))
    engine.hr_scope_provider = tcache.HRScopeProvider(cache)
    return engine


def token_specs() -> list[dict]:
    """Resolved tokens, unknown tokens, plain subjects, no target."""
    specs = []
    for i in range(24):
        kind = i % 4
        r = token_request(i, f"tok-{i % 8}" if kind != 1 else "unknown")
        if kind == 2:
            r.context["subject"] = {
                "id": f"user-{i % 8}", "hierarchical_scopes": [],
                "role_associations": [{"role": f"role-{i % 6}",
                                       "attributes": []}]}
        spec = request_spec(r)
        if kind == 3 and i % 8 == 7:
            spec["target"] = None
        specs.append(spec)
    return specs


def flags(requests):
    return [(getattr(r, "_context_prepared", None),
             getattr(r, "_token_resolved", None)) for r in requests]


@pytest.mark.parametrize("scopes", [(), ({"id": "org-0"},)])
def test_prepare_batch_matches_jax(scopes):
    jev = JaxEvaluator(jax_wired_engine(scopes=scopes), delta_enabled=False)
    tev = HybridEvaluator(port_wired_engine(scopes=scopes), device="cpu")
    specs = token_specs()
    jreq = [build_request(s, jmodels) for s in specs]
    treq = [build_request(s, tmodels) for s in specs]
    jev.prepare_batch(jreq)
    assert tev.prepare_batch(treq) is True  # token rows were prepared
    assert flags(treq) == flags(jreq)
    assert [r.context for r in treq] == [r.context for r in jreq]
    assert tev.prepare_batch(treq) is False  # idempotent
    tb = tencode(treq, tev._compiled)
    jb = jencode(jreq, jev._compiled)
    assert tb.eligible.tolist() == jb.eligible.tolist()
    assert tb.ineligible_reasons == jb.ineligible_reasons
    assert tb.eligible.sum() >= 12  # resolved token rows ride the kernel
    # the batch path prepares on its own: fresh requests, same responses
    want = jev.is_allowed_batch([build_request(s, jmodels) for s in specs])
    got = tev.is_allowed_batch([build_request(s, tmodels) for s in specs])
    assert [response_key(r) for r in got] == [response_key(r) for r in want]


class LoopbackTopic:
    """An auth topic whose responder answers each HR-scope request at
    once, with the scopes of the token's subject."""

    def __init__(self, provider, subjects):
        self.provider, self.subjects, self.emitted = provider, subjects, []

    def emit(self, name, message):
        self.emitted.append(name)
        token = message["token"].split(":", 1)[0]
        self.provider.handle_hr_scopes_response({
            "token": message["token"], "subject_id": self.subjects[token],
            "interactive": True,
            "hierarchical_scopes": [{"id": f"org-of-{token}"}]})


def _grouping(ids_mod, cache_mod, models, evaluator, engine):
    provider = cache_mod.HRScopeProvider(cache_mod.SubjectCache())
    provider.auth_topic = LoopbackTopic(
        provider, {f"tok-{i}": f"user-{i}" for i in range(8)})
    engine.hr_scope_provider = provider
    reqs = [build_request(request_spec(token_request(i, f"tok-{i % 4}")),
                          models) for i in range(32)]
    evaluator.prepare_batch(reqs)
    return (len(provider.auth_topic.emitted),
            [r.context["subject"].get("hierarchical_scopes") for r in reqs])


def test_hr_scope_grouping_matches_jax():
    """32 rows over 4 interactive tokens: one rendezvous per distinct
    cache key, every row of a group reading the written cache."""
    jeng, teng = jax_wired_engine(), port_wired_engine()
    want = _grouping(jids, jcache, jmodels,
                     JaxEvaluator(jeng, delta_enabled=False), jeng)
    got = _grouping(tids, tcache, tmodels,
                    HybridEvaluator(teng, device="cpu"), teng)
    assert got == want
    assert got[0] == 4 and all(s for s in got[1])


class Clock:
    def __init__(self):
        self.now = 50.0

    def __call__(self):
        return self.now


def _identity_script(ids_mod):
    calls = []
    inner = ids_mod.StaticIdentityClient()
    for i in range(4):
        inner.register(f"tok-{i}", payload_for(i))
    orig = inner.find_by_token

    def counting(token):
        calls.append(token)
        return orig(token)

    inner.find_by_token = counting
    client = ids_mod.CachingIdentityClient(inner)
    clock = Clock()
    client.cache = ids_mod.TokenResolutionCache(
        ttl_s=10.0, negative_ttl_s=2.0, max_entries=3, time_fn=clock)
    out = []

    def find(token):
        res = client.find_by_token(token)
        out.append((token, res["payload"] is not None,
                    res["status"]["code"]))

    for token in ("tok-0", "tok-1", "tok-0", "nope", "nope"):
        find(token)
    clock.now += 3.0  # the negative entry expires, the positives do not
    for token in ("nope", "tok-1"):
        find(token)
    find("tok-2")
    find("tok-3")  # past max_entries: the oldest goes
    client.evict("tok-2")
    client.evict_subject("user-3")
    clock.now += 11.0  # every positive entry expires
    for token in ("tok-0", "tok-2", "tok-3", "tok-0"):
        find(token)
    return out, calls, client.cache_stats()


def test_caching_identity_client_matches_jax():
    got, want = _identity_script(tids), _identity_script(jids)
    assert got == want
    assert got[2]["hits"] > 0 and got[2]["evictions"] > 0


def test_grpc_identity_client_against_mock_server():
    server = tids.MockIdentityServer({"tok-0": payload_for(0)})
    clients = [tids.GrpcIdentityClient(server.address, timeout=5.0),
               jids.GrpcIdentityClient(server.address, timeout=5.0)]
    try:
        for client in clients:
            hit = client.find_by_token("tok-0")
            assert hit["payload"] == payload_for(0)
            assert hit["status"]["code"] == 200
            miss = client.find_by_token("nope")
            assert miss["payload"] is None and miss["status"]["code"] == 404
            client.find_by_token("tok-0")  # the TTL cache answers
        # one call per client per token: repeats never reach the server
        assert server.calls == ["tok-0", "nope"] * 2
        assert clients[0].cache_stats() == clients[1].cache_stats()
        # an injected identity outage resolves to the 5xx envelope
        with REGISTRY.arm([{"site": "identity.grpc", "action": "error"}]):
            down = clients[0].find_by_token("tok-9")
        assert down["payload"] is None and down["status"]["code"] == 503
        assert REGISTRY.hits("identity.grpc") == 1 and not REGISTRY.enabled
    finally:
        for client in clients:
            client.close()
        server.stop()
