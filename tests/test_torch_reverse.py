"""The port's whatIsAllowed against the JAX package's.

Same trees, same requests (made from seeds), through the JAX
``ReverseQueryKernel`` / ``what_is_allowed_batch`` / ``HybridEvaluator``
and the port's on ``device="cpu"`` (the plain version of K5,
``ops/reverse_ref.wia_planes_ref``).  Tolerance is exact: the planes
compare byte-equal, and the ReverseQuery trees and obligations equal
under ``rq_shape`` (ids, structure, masked obligations, element by
element).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import access_control_srv_tpu.core as jcore
import access_control_srv_tpu_torch.core as tcore
import access_control_srv_tpu_torch.models as tmodels
import bench_all
import chip_smoke
from access_control_srv_tpu import models as jmodels
from access_control_srv_tpu.ops import ReverseQueryKernel as JaxReverseKernel
from access_control_srv_tpu.ops import compile_policies as jcompile
from access_control_srv_tpu.ops import encode_requests as jencode
from access_control_srv_tpu.ops import reverse as jreverse
from access_control_srv_tpu.ops.kernel import _match_targets as jax_match_targets
from access_control_srv_tpu.srv.evaluator import HybridEvaluator as JaxEvaluator
from access_control_srv_tpu_torch.ops import compile_policies as tcompile
from access_control_srv_tpu_torch.ops import reverse as treverse
from access_control_srv_tpu_torch.ops.carry import lead_padding, pad_cols, pow2_bucket
from access_control_srv_tpu_torch.ops.reverse_ref import PLANE_KEYS, wia_planes_ref
from access_control_srv_tpu_torch.srv.evaluator import HybridEvaluator

from .test_kernel_differential import grid_requests
from .test_reverse import rq_shape
from .test_torch_carryover import build_request, make_engines, request_spec
from .test_torch_evaluator import oracle_specs
from .test_torch_kernel import engines_from_doc
from .utils import fixture

REVERSE_FIXTURES = [
    "basic_policies.yml", "policy_targets.yml", "policy_set_targets.yml",
    "role_scopes.yml", "conditions.yml", "acl_policies.yml",
    "props_single.yml", "props_rules_noprop.yml", "props_multi_rules.yml",
    "props_multi_rules_entities.yml", "ops_multi.yml",
]


def grid_specs(n, seed):
    return [request_spec(r) for r in grid_requests(n=n, seed=seed)]


def requests_of(specs, models):
    return [build_request(s, models) for s in specs]


def multi_set_engines():
    out = []
    for core in (jcore, tcore):
        engine = core.AccessController()
        for name in ["basic_policies.yml", "policy_targets.yml",
                     "props_multi_rules.yml"]:
            core.populate(engine, fixture(name))
        out.append(engine)
    return out


def wia_large_specs(n):
    return [request_spec(r) for r in chip_smoke.wia_large_requests(n)]


def assert_same(got, want):
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        assert rq_shape(g) == rq_shape(w), b


def jax_planes(compiled, batch, rows, n_pad):
    """The JAX ``_match_targets(components=True, wia=True,
    with_hr=False)`` vmapped over ``rows`` of ``batch`` (zero pad rows out
    to ``n_pad``) -> bool [n_pad, 7, T]."""
    c = {k: jnp.asarray(v) for k, v in compiled.arrays.items()}
    _, _, e_bucket, _ = lead_padding(batch)
    rgx = jnp.asarray(pad_cols(batch.rgx_set, e_bucket))
    pfx = jnp.asarray(pad_cols(batch.pfx_neq, e_bucket))
    sub = {}
    for k, v in batch.arrays.items():
        a = np.asarray(v)[rows]
        pad = np.zeros((n_pad - len(rows),) + a.shape[1:], a.dtype)
        sub[k] = jnp.asarray(np.concatenate([a, pad]))

    def one(r):
        rr = dict(r, rgx_set=rgx, pfx_neq=pfx)
        m = jax_match_targets(c, rr, with_hr=False, wia=True,
                              components=True)
        return jnp.stack([m[k] for k in PLANE_KEYS])

    return np.asarray(jax.vmap(one)(sub))


@pytest.mark.parametrize("name", REVERSE_FIXTURES)
def test_wia_planes_ref_matches_jax(name):
    """K5's plain version against the JAX program on the representative
    rows of the grid traffic, pad rows included."""
    jeng, teng = make_engines(name)
    compiled = jcompile(jeng.policy_sets, jeng.urns)
    batch = jencode(requests_of(grid_specs(100, 211), jmodels), compiled)
    kern = treverse.ReverseQueryKernel(compiled, teng.policy_sets,
                                       device="cpu")
    _, first_idx, _ = kern.signatures(batch)
    n_pad = pow2_bucket(len(first_idx), floor=8)
    mega, schedule = kern.pack_rows(batch, first_idx, n_pad)
    try:
        _, _, e_bucket, _ = lead_padding(batch)
        got = wia_planes_ref(
            kern._c, torch.from_numpy(mega.copy()), schedule,
            torch.from_numpy(pad_cols(batch.rgx_set, e_bucket)),
            torch.from_numpy(pad_cols(batch.pfx_neq, e_bucket)),
        )
    finally:
        kern.staging.release(mega)
    want = jax_planes(compiled, batch, first_idx, n_pad)
    assert got.dtype == torch.bool and tuple(got.shape) == want.shape
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("name", ["basic_policies.yml", "props_single.yml",
                                  "props_multi_rules_entities.yml"])
def test_full_mode_wia_planes_match_jax(name):
    """The full-mode (subject-folded) whatIsAllowed vectors of the plain
    ``_match_targets`` against the JAX ones, row for row."""
    from access_control_srv_tpu_torch.ops.carry import batch_from_numpy, tables_from_numpy
    from access_control_srv_tpu_torch.ops.kernel_ref import _match_targets

    jeng, _ = make_engines(name)
    compiled = jcompile(jeng.policy_sets, jeng.urns)
    batch = jencode(requests_of(grid_specs(40, 17), jmodels), compiled)
    B = len(batch.eligible)
    keys = ("tm_wia_ex_p", "tm_wia_ex_d", "tm_wia_rg_p", "tm_wia_rg_d",
            "maybe_mask_ex", "maybe_mask_rg")
    _, r = batch_from_numpy(batch, "cpu")
    got = _match_targets(tables_from_numpy(compiled.arrays, "cpu"), r,
                         with_hr=False, wia=True)
    c = {k: jnp.asarray(v) for k, v in compiled.arrays.items()}
    rgx, pfx = jnp.asarray(r["rgx_set"].numpy()), jnp.asarray(
        r["pfx_neq"].numpy())
    rows = {k: jnp.asarray(np.asarray(v)) for k, v in batch.arrays.items()}
    want = jax.vmap(lambda row: jax_match_targets(
        c, dict(row, rgx_set=rgx, pfx_neq=pfx), with_hr=False,
        wia=True))(rows)
    for k in keys:
        assert got[k][:B].numpy().tobytes() == np.asarray(want[k]).tobytes(), k


@pytest.mark.parametrize("name", REVERSE_FIXTURES)
def test_reverse_differential(name):
    """The port's what_is_allowed_batch against the JAX one on the 11
    fixtures of the JAX package's reverse differential."""
    jeng, teng = make_engines(name)
    specs = grid_specs(100, 211)
    jc = jcompile(jeng.policy_sets, jeng.urns)
    tc = tcompile(teng.policy_sets, teng.urns)
    assert tc.supported
    want = jreverse.what_is_allowed_batch(
        jeng, jc, JaxReverseKernel(jc, jeng.policy_sets),
        requests_of(specs, jmodels))
    kern = treverse.ReverseQueryKernel(tc, teng.policy_sets, device="cpu")
    treqs = requests_of(specs, tmodels)
    batch = treverse.encode_requests(copy.deepcopy(treqs), tc)
    got = treverse.what_is_allowed_batch(teng, tc, kern, treqs, batch)
    assert_same(got, want)
    assert int(batch.eligible.sum()) > 60  # the planes path must run
    assert kern._plane_cache


def test_reverse_multi_set_tree():
    jeng, teng = multi_set_engines()
    specs = grid_specs(80, 97)
    jc = jcompile(jeng.policy_sets, jeng.urns)
    tc = tcompile(teng.policy_sets, teng.urns)
    want = jreverse.what_is_allowed_batch(
        jeng, jc, JaxReverseKernel(jc, jeng.policy_sets),
        requests_of(specs, jmodels))
    got = treverse.what_is_allowed_batch(
        teng, tc, treverse.ReverseQueryKernel(tc, teng.policy_sets,
                                              device="cpu"),
        requests_of(specs, tmodels))
    assert_same(got, want)


def test_wia_large_stress_tree():
    """The 1,000-rule stress tree with 64 ``wia-large`` queries; a second
    batch is served from the plane cache."""
    doc, _ = bench_all._stress_doc(1000)
    assert doc == chip_smoke.stress_doc(1000)
    jeng, teng = engines_from_doc(doc)
    specs = wia_large_specs(64)
    jc = jcompile(jeng.policy_sets, jeng.urns)
    tc = tcompile(teng.policy_sets, teng.urns)
    assert tc.n_rules >= treverse.REVERSE_MIN_RULES
    want = jreverse.what_is_allowed_batch(
        jeng, jc, JaxReverseKernel(jc, jeng.policy_sets),
        requests_of(specs, jmodels))
    kern = treverse.ReverseQueryKernel(tc, teng.policy_sets, device="cpu")
    got = treverse.what_is_allowed_batch(teng, tc, kern,
                                         requests_of(specs, tmodels))
    assert_same(got, want)
    n_cached = len(kern._plane_cache)
    again = treverse.what_is_allowed_batch(teng, tc, kern,
                                           requests_of(specs, tmodels))
    assert_same(again, want)
    assert len(kern._plane_cache) == n_cached


def test_wia_large_generator_matches_bench():
    """chip_smoke's copy of the ``bench_wia_large`` traffic: roles
    ``i % 97``, subjects ``u{i}``, entities from random.Random(3), actions
    in turn."""
    import random

    reqs = chip_smoke.wia_large_requests(2048)
    rng = random.Random(3)
    acts = ["read", "modify", "create", "delete"]
    for i, r in enumerate(reqs):
        k = rng.randint(0, 63)
        assert [a.value for a in r.target.subjects] == [f"role-{i % 97}",
                                                        f"u{i}"]
        assert r.target.resources[0].value == (
            f"urn:restorecommerce:acs:model:stress{k}.Stress{k}")
        assert r.target.actions[0].value == chip_smoke.URNS[acts[i % 4]]
    assert len({r.target.resources[0].value for r in reqs}) == 64


def test_evaluator_wia_batch_and_hot_mutation(monkeypatch):
    """The port evaluator's what_is_allowed_batch, the kernel path forced
    (REVERSE_MIN_RULES = 0 in both packages), against the JAX evaluator,
    across a hot mutation and refresh."""
    from access_control_srv_tpu.ops import reverse as jrev_mod

    monkeypatch.setattr(treverse, "REVERSE_MIN_RULES", 0)
    monkeypatch.setattr(jrev_mod, "REVERSE_MIN_RULES", 0)
    jeng, teng = make_engines("policy_targets.yml")
    jev = JaxEvaluator(jeng, delta_enabled=False)
    tev = HybridEvaluator(teng, device="cpu")
    specs = grid_specs(30, 311)
    assert_same(tev.what_is_allowed_batch(requests_of(specs, tmodels)),
                jev.what_is_allowed_batch(requests_of(specs, jmodels)))
    kern = tev._rq_kernel
    assert kern is not None and kern._plane_cache

    for eng, core in ((jeng, jcore), (teng, tcore)):
        for ps in core.load_policy_sets_from_file(
                fixture("basic_policies.yml")):
            eng.update_policy_set(ps)
    jev.refresh(wait=True)
    tev.refresh(wait=True)
    got = tev.what_is_allowed_batch(requests_of(specs, tmodels))
    assert_same(got, jev.what_is_allowed_batch(requests_of(specs, jmodels)))
    assert tev._rq_kernel is not kern
    assert tev._rq_kernel.compiled.version == tev._compiled.version
    oracle = [teng.what_is_allowed(r) for r in requests_of(specs, tmodels)]
    assert_same(got, oracle)


def test_adaptive_wia_dispatch():
    """Below REVERSE_MIN_RULES the scalar walk serves every request and
    no ReverseQueryKernel is built."""
    jeng, teng = make_engines("policy_targets.yml")
    tev = HybridEvaluator(teng, device="cpu")
    assert tev._compiled.n_rules < treverse.REVERSE_MIN_RULES
    specs = grid_specs(12, 5)
    got = tev.what_is_allowed_batch(requests_of(specs, tmodels))
    assert tev._rq_kernel is None
    assert_same(got, [jeng.what_is_allowed(r)
                      for r in requests_of(specs, jmodels)])


def test_token_and_oracle_rows(monkeypatch):
    """Rows the encoder cannot represent (no target, an unresolved token
    subject, role associations without HR scopes) reach the oracle as
    ineligible rows, in the port and the JAX evaluator alike."""
    from access_control_srv_tpu.ops import reverse as jrev_mod

    monkeypatch.setattr(treverse, "REVERSE_MIN_RULES", 0)
    monkeypatch.setattr(jrev_mod, "REVERSE_MIN_RULES", 0)
    specs = oracle_specs()[1:] + grid_specs(16, 3)
    assert any(s["context"]["subject"].get("token") for s in specs)
    jeng, teng = make_engines("role_scopes.yml")
    jev = JaxEvaluator(jeng, delta_enabled=False)
    tev = HybridEvaluator(teng, device="cpu")
    got = tev.what_is_allowed_batch(requests_of(specs, tmodels))
    assert_same(got, jev.what_is_allowed_batch(requests_of(specs, jmodels)))
    batch = treverse.encode_requests(requests_of(specs, tmodels),
                                     tev._compiled, skip_conditions=True)
    assert not batch.eligible[0]


def test_kernel_needs_a_card_unless_asked_for_the_cpu():
    _, teng = make_engines("basic_policies.yml")
    tc = tcompile(teng.policy_sets, teng.urns)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        treverse.ReverseQueryKernel(tc, teng.policy_sets)
