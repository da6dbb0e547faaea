"""The port's native wire encoder against the JAX package's.

``access_control_srv_tpu_torch.native.NativeBatchEncoder`` (the port's
copy of ``native/host_encoder.cpp``, built by g++ into the port's
``_build/``) must fill exactly the arrays the JAX package's encoder fills
from the same wire bytes, and exactly what the port's Python encoder fills
from the deserialized requests at the floor caps: every row array,
``eligible``, ``rgx_set``, ``pfx_neq`` and ``overcap``.  The owner-bit and
relation-bit packers are fuzzed port against JAX.  The wire bytes come
from the JAX package's ``transport_grpc.request_to_pb``, as in
``tests/test_native_encoder.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import access_control_srv_tpu_torch.models as tmodels
from access_control_srv_tpu import native as jnative
from access_control_srv_tpu.ops import compile_policies as jcompile
from access_control_srv_tpu.srv.gen import access_control_pb2 as pb
from access_control_srv_tpu_torch import native as tnative
from access_control_srv_tpu_torch.ops import compile_policies as tcompile
from access_control_srv_tpu_torch.ops import encode_requests as tencode
from access_control_srv_tpu_torch.ops.encode import (
    _CAPS_CEIL,
    _CAPS_FLOOR,
    alloc_row_arrays,
)

from .test_kernel_differential import grid_requests
from .test_native_encoder import _deep_hr_request, wire_roundtrip
from .test_torch_carryover import build_request, make_engines, request_spec
from .utils import URNS

WIRE_FIXTURES = [
    "basic_policies.yml", "policy_targets.yml", "policy_set_targets.yml",
    "role_scopes.yml", "acl_policies.yml", "props_single.yml",
    "props_multi_rules_entities.yml", "ops_multi.yml",
]
ORG = "urn:restorecommerce:acs:model:organization.Organization"
USER = "urn:restorecommerce:acs:model:user.User"


def encoders(name: str):
    """(JAX encoder, port encoder, port compile) over one fixture tree."""
    jeng, teng = make_engines(name)
    jc = jcompile(jeng.policy_sets, jeng.urns)
    tc = tcompile(teng.policy_sets, teng.urns)
    return jnative.NativeBatchEncoder(jc), tnative.NativeBatchEncoder(tc), tc


def port_twins(twins):
    """The port's Request objects for the JAX package's deserialized
    twins (one dict spec builds both)."""
    return [build_request(request_spec(t), tmodels) for t in twins]


def assert_batches_equal(got, want, what):
    assert sorted(got.arrays) == sorted(want.arrays), what
    for name in want.arrays:
        x, y = np.asarray(got.arrays[name]), np.asarray(want.arrays[name])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, name)
        assert np.array_equal(x, y), (what, name)
    for field in ("eligible", "rgx_set", "pfx_neq"):
        assert np.array_equal(getattr(got, field), getattr(want, field)), \
            (what, field)


@pytest.mark.parametrize("name", WIRE_FIXTURES)
def test_wire_arrays_match_jax_and_python_encoder(name):
    jenc, tenc, tc = encoders(name)
    messages, twins = wire_roundtrip(grid_requests(n=120, seed=31))
    got = tenc.encode_wire(messages)
    assert_batches_equal(got, jenc.encode_wire(messages), (name, "jax"))
    assert np.array_equal(got.overcap,
                          jenc.encode_wire(messages).overcap), name
    py = tencode(port_twins(twins), tc, caps=_CAPS_FLOOR)
    assert_batches_equal(got, py, (name, "python"))
    assert got.eligible.sum() > 60  # the grid must exercise kernel rows


def _good_message() -> bytes:
    return wire_roundtrip(grid_requests(n=1, seed=5))[0][0]


def _with_subject(payloads) -> list[bytes]:
    good = _good_message()
    out = []
    for payload in payloads:
        msg = pb.Request.FromString(good)
        msg.context.subject.value = payload
        out.append(msg.SerializeToString())
    return out


def _acl_request(acls):
    from access_control_srv_tpu.models import Attribute, Request, Target

    return Request(
        target=Target(
            subjects=[Attribute(id=URNS["role"], value="member"),
                      Attribute(id=URNS["subjectID"], value="ada")],
            resources=[Attribute(id=URNS["entity"], value=ORG),
                       Attribute(id=URNS["resourceID"], value="res-1")],
            actions=[Attribute(id=URNS["actionID"], value=URNS["create"])],
        ),
        context={
            "resources": [{"id": "res-1",
                           "meta": {"owners": [], "acls": acls}}],
            "subject": {"id": "ada", "role_associations": [
                {"role": "member", "attributes": []}],
                "hierarchical_scopes": []},
        },
    )


def _acl(entity, instance):
    return [{"id": URNS["aclIndicatoryEntity"], "value": entity,
             "attributes": [{"id": URNS["aclInstance"], "value": instance}]}]


def edge_case(case: str):
    """(fixture, wire messages, expected eligible pattern) of one edge
    case of ``tests/test_native_encoder.py``."""
    if case == "malformed":
        good = _good_message()
        msg = pb.Request.FromString(good)
        msg.context.subject.value = b'{"id": "u", "role_assoc'
        return ("basic_policies.yml",
                [good, good + b"\xff\xff\xff", msg.SerializeToString()],
                [True, False, False])
    if case == "trailing_garbage":
        return ("basic_policies.yml", _with_subject(
            [b'{"id": "u"}garbage', b'{"n": +5}', b'{"n": -}', b'{"n": 5.}']),
            [False] * 4)
    if case == "deep_nesting":
        bombs = [b"[" * d + b"]" * d for d in (30, 63, 64, 200_000)]
        return ("basic_policies.yml",
                _with_subject([b'{"id": ' + b + b"}" for b in bombs]),
                [True, True, False, False])
    if case == "strict_strings":
        bad = [b'{"id": "unterminated', b'{"id": "trunc\\u12"}',
               b'{"id": "bad\\uzzzz"}', b'{"id": "esc\\x41"}',
               b'{"id": "ctl\x01char"}', b'{"id": "end\\',
               b'{"id": "pair\\ud83d\\ude00"}', b'{"id": "lone\\ud800"}']
        ok = [b'{"id": "fine\\u0041\\n\\"q\\\\"}', b'{"id": "slash\\/ok"}']
        return ("basic_policies.yml", _with_subject(bad + ok),
                [False] * len(bad) + [True] * len(ok))
    if case == "acl_absent":
        messages, _ = wire_roundtrip([
            _acl_request(_acl(None, "ada")), _acl_request(_acl(USER, None)),
            _acl_request(_acl(USER, "ada"))])
        return "acl_policies.yml", messages, [False, False, True]
    assert case == "overcap"
    messages, _ = wire_roundtrip([_deep_hr_request(64, owner="org-40-n"),
                                  _deep_hr_request(3, owner="org-1-n")])
    return "role_scopes.yml", messages, [False, True]


@pytest.mark.parametrize("case", [
    "malformed", "trailing_garbage", "deep_nesting", "strict_strings",
    "acl_absent", "overcap",
])
def test_edge_cases_match_jax(case):
    name, messages, expect = edge_case(case)
    jenc, tenc, _ = encoders(name)
    got, want = tenc.encode_wire(messages), jenc.encode_wire(messages)
    assert_batches_equal(got, want, case)
    assert np.array_equal(got.overcap, want.overcap), case
    assert got.eligible.tolist() == expect, case
    if case == "overcap":
        assert got.overcap.tolist() == [True, False]
        ceil = tenc.encode_wire(messages, caps=dict(_CAPS_CEIL))
        assert_batches_equal(
            ceil, jenc.encode_wire(messages, caps=dict(_CAPS_CEIL)), case)
        assert ceil.eligible.all()


def test_pooled_staging_matches_fresh_buffers():
    """``reuse=True`` batches carry the fresh batch's arrays (the regex
    matrices padded to the pow2 entity bucket) and recycle on release."""
    _, tenc, _ = encoders("role_scopes.yml")
    messages, _ = wire_roundtrip(grid_requests(n=40, seed=9))
    fresh = tenc.encode_wire(messages)
    for _ in range(2):
        pooled = tenc.encode_wire(messages, reuse=True)
        for name in fresh.arrays:
            assert np.array_equal(pooled.arrays[name], fresh.arrays[name])
        E = fresh.rgx_set.shape[1]
        assert np.array_equal(pooled.rgx_set[:, :E], fresh.rgx_set)
        assert not pooled.rgx_set[:, E:].any()
        assert np.array_equal(pooled.eligible, fresh.eligible)
        pooled.release_staging()
    assert tenc.arena_stats()["hits"] >= 1


def _random_rows(rng, B, caps):
    a = alloc_row_arrays(B, caps)
    for name in ("r_inst_owner_ent", "r_inst_owner_inst", "r_op_vals",
                 "r_op_owner_ent", "r_op_owner_inst", "r_ra3", "r_ra2",
                 "r_hr", "r_ent_vals", "r_inst_id", "r_subject_id"):
        a[name][...] = rng.integers(-1, 12, size=a[name].shape)
    a["r_inst_run"][...] = rng.integers(-1, caps["NR"],
                                        size=a["r_inst_run"].shape)
    for name in ("r_inst_valid", "r_inst_present", "r_inst_has_owners",
                 "r_op_present", "r_op_has_owners"):
        a[name][...] = rng.integers(0, 2, size=a[name].shape).astype(bool)
    return a


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_owner_bits_fuzz_matches_jax(seed):
    """Random raw row arrays and a random role-scope vocab (wide entry
    layouts included): the port's C++ owner-bit packer equals the JAX
    package's."""
    jenc, tenc, _ = encoders("role_scopes.yml")
    rng = np.random.default_rng(seed)
    B = int(rng.integers(1, 24))
    caps = dict(_CAPS_FLOOR, NI=int(rng.integers(1, 6)),
                NOP=int(rng.integers(1, 4)), NOWN=int(rng.integers(1, 5)),
                NRA=int(rng.integers(1, 10)), NHR=int(rng.integers(1, 34)))
    a = _random_rows(rng, B, caps)
    RV = int(rng.integers(1, 40))
    role = rng.integers(-1, 12, size=RV).astype(np.int32)
    scope = rng.integers(0, 12, size=RV).astype(np.int32)
    for enc in (jenc, tenc):
        enc._hrv_role, enc._hrv_scope = role.copy(), scope.copy()
    got, want = tenc.owner_bits_native(a, B), jenc.owner_bits_native(a, B)
    for k in ("r_own_runs", "r_own_bits"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 2])
def test_relation_bits_fuzz_matches_jax(seed):
    """Random raw row arrays and random valid flat verdict tables (seed 2
    the multi-word layout): the port's C++ relation packer equals the JAX
    package's."""
    jenc, tenc, _ = encoders("relation_policies.yml")
    assert tenc.needs_relation_bits
    rng = np.random.default_rng(seed)
    wide = seed >= 2
    B = int(rng.integers(8, 24))
    caps = dict(_CAPS_FLOOR, NR=34 if wide else 4, NI=48 if wide else 4,
                NOWN=2, NRA=2, NHR=2, NACLE=2, NACLI=2, NHRR=2)
    a = _random_rows(rng, B, caps)
    RELV = int(rng.integers(1, 7))
    segs = [np.unique((rng.integers(0, 12, size=int(rng.integers(0, 5)))
                       .astype(np.int64) << 32)
                      | rng.integers(0, 12, size=1).astype(np.int64))
            for _ in range(2 * RELV)]
    obj_offs = np.zeros((2 * RELV + 1,), np.int64)
    obj_offs[1:] = np.cumsum([s.shape[0] for s in segs])
    obj_keys = np.concatenate(segs).astype(np.int64)
    pairs = sorted({(row << 32) | int(s) for row in range(len(obj_keys))
                    for s in rng.integers(0, 12, size=2)})
    tables = {"obj_offs": obj_offs, "obj_keys": obj_keys,
              "pairs": np.array(pairs, np.int64).reshape(-1)}
    fake = SimpleNamespace(arrays={"relv_path": np.zeros((RELV,), np.int32),
                                   "t_rel_idx": np.array([0], np.int32)})
    jenc.compiled = tenc.compiled = fake
    got = tenc.relation_bits_native(a, B, tables=tables)
    want = jenc.relation_bits_native(a, B, tables=tables)
    for k in ("r_rel_runs", "r_rel_bits"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_conditions_tree_raises():
    _, teng = make_engines("conditions.yml")
    tc = tcompile(teng.policy_sets, teng.urns)
    assert tc.conditions
    with pytest.raises(RuntimeError, match="conditions"):
        tnative.NativeBatchEncoder(tc)


def test_library_lands_in_the_port_build_dir():
    lib = tnative.library_path()
    port = tnative.SRC.parent.parent
    assert lib.parent == port / "_build"
    assert lib.name.startswith("libacs_host-") and lib.suffix == ".so"
    tnative.load()
    assert lib.exists()
    # never next to the JAX package's own library
    assert lib.parent != jnative._DIR and lib != jnative._LIB
