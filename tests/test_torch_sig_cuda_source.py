"""The CUDA sources of the signature path's kernels, run on the CPU.

``ops/csrc/sig_planes.cu``, ``sig_decide.cu`` and ``decide_grouped.cu``
(with the shared ``decide_core.cuh``) are compiled as C++ with g++ against
the threaded stand-in for ``cuda_runtime.h`` of ``test_torch_cuda_source``
(one ``std::thread`` per CUDA thread, barriers for ``__syncthreads`` and
the warp shuffles).  The port's ``PrefilteredKernel(device="cpu")`` runs a
batch through the plain versions while every kernel call is recorded;
each recorded call is then packed by the port's own packing functions and
replayed through the emulated kernel, whose outputs must equal the plain
version's exactly.  This checks the kernels' logic and argument layouts;
that nvcc accepts them for ``sm_90a``, and the timing, are checked on the
card by ``chip_smoke.py``.
"""

import ctypes
import random

import numpy as np
import pytest
import torch

from access_control_srv_tpu import models as jmodels
from access_control_srv_tpu.ops import compile_policies as jcompile
from access_control_srv_tpu.ops import delta as jdelta
from access_control_srv_tpu.ops import encode_requests as jencode
from access_control_srv_tpu_torch.ops import cuda_build
from access_control_srv_tpu_torch.ops import kernel as tkernel
from access_control_srv_tpu_torch.ops import prefilter as tprefilter

from .test_kernel_differential import grid_requests
from .test_sig_kernel import _sig_requests, _sig_tree
from .test_torch_carryover import build_request, request_spec
from .test_torch_delta import patched_compile
from .test_torch_cuda_source import build_emulated
from .test_torch_kernel import (
    BUCKET,
    ORG,
    URNS,
    acl_heavy_specs,
    combining_case,
    jax_build_request,
)
from .test_torch_prefilter import engine_of, hr_requests, stress_requests
from .test_prefilter import _stress_doc
from .utils import make_engine

ENTRY = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = {}
    for name, flags in (("sig_planes", 2), ("sig_decide", 3),
                        ("decide_grouped", 4)):
        lib = build_emulated(name, tmp_path_factory.mktemp(f"{name}_emu"))
        getattr(lib, f"acs_{name}_layout").restype = ctypes.c_char_p
        entry = getattr(lib, f"acs_{name}")
        entry.restype = ctypes.c_int
        entry.argtypes = ENTRY + [ctypes.c_int] * (flags + 1) + [
            ctypes.c_void_p]
        out[name] = lib
    grouped = out["decide_grouped"]
    grouped.acs_decide_grouped_smem.restype = ctypes.c_longlong
    grouped.acs_decide_grouped_smem.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    grouped.acs_decide_grouped_occupancy.restype = ctypes.c_int
    grouped.acs_decide_grouped_occupancy.argtypes = [
        ctypes.c_void_p, ctypes.c_int] + [ctypes.c_int] * 5
    planes = out["sig_planes"]
    for fn, (restype, argtypes) in tkernel._SIZING["sig_planes"].items():
        getattr(planes, fn).restype = restype
        getattr(planes, fn).argtypes = argtypes
    sig = out["sig_decide"]
    sig.acs_sig_decide_smem.restype = ctypes.c_longlong
    sig.acs_sig_decide_smem.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int]
    sig.acs_sig_decide_occupancy.restype = ctypes.c_int
    sig.acs_sig_decide_occupancy.argtypes = ENTRY + [ctypes.c_int] * 4
    return out


def _snapshot(x):
    """A copy of a recorded argument: the packed rows and slot maps live
    in pooled staging buffers that the next batch overwrites (a host
    array, K4's row groups, copied into a tensor as the plain versions
    take it)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x.copy())
    if isinstance(x, dict):
        return {k: _snapshot(v) for k, v in x.items()}
    return x


def record(monkeypatch):
    """Wrap the three kernel entry points the prefilter calls; each call
    is recorded with (a copy of) its arguments, the explain flag folded
    in as a last argument (always False for sig_planes, which has no
    explain variant), and its plain version's output."""
    calls = []
    for name in ("sig_planes", "sig_decide", "decide_grouped"):
        orig = getattr(tprefilter, name)

        def wrapped(*args, _orig=orig, _name=name, **kw):
            out = _orig(*args, **kw)
            calls.append((_name, tuple(_snapshot(a) for a in args)
                          + (kw.get("explain", False),), out))
            return out

        monkeypatch.setattr(tprefilter, name, wrapped)
    return calls


def replay_grouped(lib, args, want):
    """One ``decide_grouped`` call through the emulated kernel, over the
    slot layout of its rows, held against ``want``."""
    inv, cs, g_idx, r, with_acl, with_hr, with_rel, explain = args
    layout = tkernel.grouped_layout(np.asarray(g_idx),
                                    cs["t_role"].shape[0], "cpu")
    packed = tkernel.pack_grouped(inv, cs, r, layout, explain)
    packed.out.fill_(-7)
    smem = lib.acs_decide_grouped_smem(
        ctypes.addressof(packed.dims), len(packed.dims), int(with_acl),
        int(explain), packed.threads)
    assert 0 < smem <= 232448
    code = lib.acs_decide_grouped(
        ctypes.addressof(packed.ptrs), len(packed.ptrs),
        ctypes.addressof(packed.dims), len(packed.dims),
        int(with_acl), int(with_hr), int(with_rel), int(explain),
        packed.threads, None)
    assert code == 0
    assert torch.equal(packed.out, want)
    return packed.shape


def replay_sig(lib, args, want):
    """One ``sig_decide`` call through the emulated kernel, held against
    ``want``."""
    (inv, cs, planes, slot_g, rows, g2r, gp, n_rows, schedule,
     needs_pairs, with_hr, with_rel, explain) = args
    got, ptrs, dims = tkernel.pack_sig_decide(
        inv, cs, planes, slot_g, rows, g2r, gp, schedule,
        needs_pairs, with_hr, with_rel, explain)
    assert 0 < lib.acs_sig_decide_smem(ctypes.addressof(dims), len(dims),
                                       tkernel.SIG_DECIDE_THREADS) <= 232448
    code = lib.acs_sig_decide(
        ctypes.addressof(ptrs), len(ptrs), ctypes.addressof(dims),
        len(dims), int(with_hr), int(with_rel), int(explain),
        tkernel.SIG_DECIDE_THREADS, None)
    assert code == 0
    assert torch.equal(got, want)


def replay(libs, calls):
    """Every recorded call through its emulated kernel -> the names of
    the kernels replayed."""
    seen = set()
    for name, args, want in calls:
        lib = libs[name]
        if name == "sig_planes":
            got, scratch, ptrs, dims, threads = tkernel.pack_sig_planes(
                *args[:-1])
            for t in got.values():
                t.view(torch.uint8).fill_(0xCD)
            code = lib.acs_sig_planes(
                ctypes.addressof(ptrs), len(ptrs), ctypes.addressof(dims),
                len(dims), int(args[3]), int(args[4]), threads, None)
            assert code == 0
            assert sorted(got) == sorted(want)
            for k in got:
                assert torch.equal(got[k], want[k]), k
        elif name == "sig_decide":
            replay_sig(lib, args, want)
        else:
            replay_grouped(lib, args, want)
        seen.add(name)
    return seen


def run(compiled, requests, force=True, relation_tables=None, **kw):
    kern = tprefilter.PrefilteredKernel(compiled, device="cpu", **kw)
    if force:
        kern.active = True
        kern._dense = None
    batch = jencode(requests, compiled, relation_tables=relation_tables)
    kern.evaluate(batch)
    return kern


def test_layouts_match_host(libs):
    want = {
        "sig_planes": (tkernel.SIG_PLANES_PTRS, tkernel.SIG_PLANES_DIMS),
        "sig_decide": (tkernel.SIG_DECIDE_PTRS, tkernel.SIG_DECIDE_DIMS),
        "decide_grouped": (tkernel.TABLE_ARRAYS + ("rule_orig_flat",)
                           + tkernel.ROW_ARRAYS + tkernel.BATCH_ARRAYS
                           + tkernel.OUTPUTS
                           + ("slot_g", "grid2row", "gp_orig"),
                           tkernel.DIMS + ("NSLOT", "R", "RT", "PT")),
    }
    assert "rule_orig_flat" in tkernel.SIG_DECIDE_PTRS
    assert tkernel.OUTPUTS[-1] == "out_explain"
    for name, (ptrs, dims) in want.items():
        have = getattr(libs[name], f"acs_{name}_layout")().decode()
        assert have == ",".join(ptrs) + ",|" + ",".join(dims) + ","


def test_argument_count_mismatch_is_refused(libs):
    ptrs = (ctypes.c_int64 * 3)()
    dims = (ctypes.c_int32 * 3)()
    args = (ctypes.addressof(ptrs), 3, ctypes.addressof(dims), 3)
    assert libs["sig_planes"].acs_sig_planes(*args, 0, 0, 64, None) == -1
    assert libs["sig_decide"].acs_sig_decide(*args, 0, 0, 0, 128,
                                             None) == -1
    assert libs["decide_grouped"].acs_decide_grouped(
        *args, 0, 0, 0, 0, 64, None) == -1


@pytest.mark.parametrize("name", ["basic_policies.yml", "conditions.yml",
                                  "acl_policies.yml",
                                  "props_multi_rules_entities.yml",
                                  "ops_multi.yml"])
def test_fixture_trees(libs, monkeypatch, name):
    """Fixtures forced onto the signature machinery: the grid's ACL and
    property rows take decide_grouped, the rest sig_planes + sig_decide."""
    engine = make_engine(name)
    compiled = jcompile(engine.policy_sets, engine.urns)
    calls = record(monkeypatch)
    specs = grid_requests(n=40, seed=17)
    run(compiled, specs)
    batch = jencode(specs, compiled)
    sig_only = [r for r, a, p in zip(specs,
                                     (batch.arrays["r_acl_ent"] >= 0).any(1),
                                     batch.arrays["r_has_props"])
                if not a and not p]
    run(compiled, sig_only)
    seen = replay(libs, calls)
    assert {"sig_planes", "sig_decide"} <= seen


def test_stress_tree(libs, monkeypatch):
    """The ~720-rule stress tree, above MIN_RULES: many groups, compacted
    subtrees, every row on the signature path."""
    doc, entities, actions = _stress_doc()
    engine = engine_of(doc)
    compiled = jcompile(engine.policy_sets, engine.urns)
    calls = record(monkeypatch)
    run(compiled, stress_requests(entities, actions, n=96), force=False)
    assert replay(libs, calls) == {"sig_planes", "sig_decide"}


@pytest.mark.parametrize("name", ["acl_policies.yml",
                                  "props_multi_rules_entities.yml",
                                  "stress"])
def test_patched_bucketed_tables(libs, monkeypatch, name):
    """Tables from ``full_bucketed_compile`` and one ``apply_events``
    patch: fixtures forced onto the signature machinery (the grid's ACL
    and property rows take decide_grouped, the rest sig_planes +
    sig_decide) and the ~720-rule stress tree unforced; every call of
    the three kernels equals its plain version."""
    if name == "stress":
        doc, entities, actions = _stress_doc()
        engine = engine_of(doc)
        compiled, _ = patched_compile(engine, jdelta, seed=9)
        assert not compiled.arrays["rule_valid"].all()  # pad rule slots
        calls = record(monkeypatch)
        run(compiled, stress_requests(entities, actions, n=64), force=False)
        assert replay(libs, calls) == {"sig_planes", "sig_decide"}
        return
    engine = make_engine(name)
    compiled, _ = patched_compile(engine, jdelta, seed=9)
    calls = record(monkeypatch)
    specs = grid_requests(n=40, seed=19)
    run(compiled, specs)
    batch = jencode(specs, compiled)
    sig_only = [r for r, a, p in zip(specs,
                                     (batch.arrays["r_acl_ent"] >= 0).any(1),
                                     batch.arrays["r_has_props"])
                if not a and not p]
    run(compiled, sig_only)
    assert replay(libs, calls) == {"sig_planes", "sig_decide",
                                   "decide_grouped"}


def test_hr_tree(libs, monkeypatch):
    """Owner bitplanes and collection planes (with_hr) in both the
    signature kernels and, with an ACL row, the per-row kernel."""
    engine = make_engine("role_scopes.yml")
    compiled = jcompile(engine.policy_sets, engine.urns)
    calls = record(monkeypatch)
    run(compiled, hr_requests(32, 21))
    run(compiled, hr_requests(16, 22) + grid_requests(n=16, seed=3))
    seen = replay(libs, calls)
    assert seen == {"sig_planes", "sig_decide", "decide_grouped"}
    assert any(name == "sig_decide" and args[-3] for name, args, _ in calls)


def test_regex_signature_trees(libs, monkeypatch):
    """Foreign-namespace entities (regex prefix resets) and multi-entity
    ordered runs on the signature path."""
    rng = random.Random(77)
    calls = record(monkeypatch)
    for _ in range(2):
        engine = engine_of(_sig_tree(rng))
        compiled = jcompile(engine.policy_sets, engine.urns)
        requests = _sig_requests(rng, 32)
        if compiled.supported:
            run(compiled, requests)
    assert replay(libs, calls) == {"sig_planes", "sig_decide"}


def test_combining_algorithms(libs, monkeypatch):
    """Every first / last choice of the three combining algorithms shows
    in the outputs (the candidates differ in effect or cacheable), at the
    rule and the policy level, with a rule-less policy."""
    doc, specs = combining_case()
    engine = engine_of(doc)
    compiled = jcompile(engine.policy_sets, engine.urns)
    calls = record(monkeypatch)
    run(compiled, [build_request(s, jmodels) for s in specs])
    assert replay(libs, calls) == {"sig_planes", "sig_decide"}


def test_relation_fixture(libs, monkeypatch):
    """The relation variants, forced onto the signature machinery: K2's
    relation and collection planes, K3's closure-bitplane fold, and with
    an ACL row K4's with_acl + with_rel program."""
    from .test_torch_relations import (
        ORG,
        VARIANT_OPS,
        VARIANT_SPECS,
        both_stores,
        rel_specs,
    )

    engine = make_engine("relation_policies.yml")
    compiled = jcompile(engine.policy_sets, engine.urns)
    tables = both_stores(*VARIANT_OPS)[1].tables_for(compiled)
    calls = record(monkeypatch)
    acl = rel_specs(["alice"], ["doc1"], acl_indicatory_entity=ORG,
                    acl_instances=["Org1"])
    for specs in (VARIANT_SPECS, VARIANT_SPECS[:4] + acl):
        run(compiled, [build_request(s, jmodels) for s in specs],
            relation_tables=tables)
    assert replay(libs, calls) == {"sig_planes", "sig_decide",
                                   "decide_grouped"}
    assert all(args[-2] for _, args, _ in calls)


@pytest.mark.parametrize("scoped", [False, True])
def test_relation_stress_tree(libs, monkeypatch, scoped):
    """The 550-rule relation tree, above MIN_RULES, unforced: the
    relation variants of K2 and K3 (stacked on the HR ones when
    scoped)."""
    from .test_torch_relations import (
        rel_stress_doc,
        rel_stress_specs,
        stress_stores,
    )

    doc, entities, actions = rel_stress_doc(scoped)
    engine = engine_of(doc)
    compiled = jcompile(engine.policy_sets, engine.urns)
    tables = stress_stores(entities)[1].tables_for(compiled)
    calls = record(monkeypatch)
    specs = rel_stress_specs(entities, actions, 48, 9, scoped)
    run(compiled, [build_request(s, jmodels) for s in specs], force=False,
        relation_tables=tables)
    assert replay(libs, calls) == {"sig_planes", "sig_decide"}
    assert all(args[-2] and args[-3] == scoped for _, args, _ in calls)


def test_library_path_covers_headers(tmp_path):
    """Editing a shared header in a copy of ``csrc/`` changes every
    library's name, so a stale library is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in cuda_build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    names = ("decide_dense", "decide_grouped", "sig_planes", "sig_decide",
             "wia_planes")
    before = {n: cuda_build._library_path(n, csrc) for n in names}
    assert before == {n: cuda_build._library_path(n) for n in names}
    header = csrc / "decide_core.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: cuda_build._library_path(n, csrc) for n in names}
    assert all(before[n] != after[n] for n in names)


# ------------------------------------------------------------- explain


@pytest.mark.parametrize("name", ["conditions.yml", "acl_policies.yml",
                                  "props_multi_rules_entities.yml",
                                  "role_scopes.yml"])
def test_explain_fixture_trees(libs, monkeypatch, name):
    """The explain variants of K3 and K4 (four outputs, the stacked
    ``rule_orig_flat`` mapping compacted slots back) on fixture trees
    forced onto the signature machinery, each call equal to its plain
    version."""
    engine = make_engine(name)
    compiled = jcompile(engine.policy_sets, engine.urns)
    from .test_explain import fixture_requests

    calls = record(monkeypatch)
    specs = fixture_requests(name, n=32, seed=23)
    run(compiled, specs, explain=True)
    batch = jencode(specs, compiled)
    run(compiled, [r for r, a, p in zip(
        specs, (batch.arrays["r_acl_ent"] >= 0).any(1),
        batch.arrays["r_has_props"]) if not a and not p], explain=True)
    assert {"sig_decide", "decide_grouped"} <= replay(libs, calls)
    assert all(args[-1] for n, args, _ in calls if n != "sig_planes")
    assert all(out.shape[0] == 4 for n, _, out in calls if n != "sig_planes")
    if name == "conditions.yml":
        codes = torch.cat([out[3] for n, _, out in calls
                           if n != "sig_planes"])
        assert 3 in set((codes & 3).tolist())


def test_explain_edge_paths(libs, monkeypatch):
    """K3's flat recovery where it shifts a -1 "last" and clips the
    ``rule_orig_flat`` lookup, and K4's where it clips the rule slot: the
    edge trees of ``test_torch_explain`` with unknown combining
    algorithms, forced onto the signature machinery."""
    from .test_torch_explain import edge_case, edited

    calls = record(monkeypatch)
    for doc, specs in (edge_case(), combining_case()):
        engine = engine_of(doc)
        base = jcompile(engine.policy_sets, engine.urns)
        requests = [build_request(s, jmodels) for s in specs]
        for edit in ("none", "set", "policy"):
            compiled = edited(base, set_ca=edit == "set",
                              pol_ca=edit == "policy")
            run(compiled, requests, explain=True)
    assert replay(libs, calls) == {"sig_planes", "sig_decide"}
    codes = torch.cat([out[3] for n, _, out in calls if n == "sig_decide"])
    assert set((codes & 3).tolist()) >= {0, 1, 2}


def test_explain_stress_tree(libs, monkeypatch):
    """The ~720-rule stress tree, unforced, with conditions on every
    seventh rule: compacted subtrees of different widths, the codes
    mapped through ``rule_orig_flat``."""
    import chip_smoke

    engine = engine_of(chip_smoke.small_stress_doc(conditions=True))
    compiled = jcompile(engine.policy_sets, engine.urns)
    requests = chip_smoke.grid_requests(random.Random(8), 48, stress=True,
                                        acl=False)
    for r in requests[::3]:
        r.context["subject"].pop("id", None)
    calls = record(monkeypatch)
    run(compiled, [build_request(request_spec(r), jmodels)
                   for r in requests], force=False, explain=True)
    assert replay(libs, calls) == {"sig_planes", "sig_decide"}
    codes = torch.cat([out[3] for n, _, out in calls if n == "sig_decide"])
    assert set((codes & 3).tolist()) >= {0, 1}


# --------------------------------------------- the redesigned K3 and K4


def stacked_grouped(compiled, batch, g_rows, explain=False, seed=0):
    """``decide_grouped``'s arguments for a port-encoded ``batch`` over G
    stacked copies of the port compile's dense tables (group g > 0 with a
    seeded share of its rules invalidated, so groups differ; with
    ``explain`` a seeded permutation as each group's ``rule_orig_flat``),
    rows assigned to groups by ``g_rows`` -> (args without the explain
    flag, the flag)."""
    from access_control_srv_tpu_torch.ops.carry import (
        batch_from_numpy,
        tables_from_numpy,
    )
    from access_control_srv_tpu_torch.ops.prefilter import (
        INVARIANT_TABLES,
        VARYING_TABLES,
    )

    c = tables_from_numpy(compiled.arrays, "cpu")
    _, r = batch_from_numpy(batch, "cpu", keys=tkernel.ROW_ARRAYS)
    B = r["r_n_ra"].shape[0]
    g_idx = torch.tensor((list(g_rows) * B)[:B], dtype=torch.int32)
    G = int(g_idx.max()) + 1
    rng = np.random.default_rng(seed)
    cs = {}
    for k in VARYING_TABLES:
        reps = [c[k].clone() for _ in range(G)]
        if k == "rule_valid":
            for t in reps[1:]:
                t &= torch.from_numpy(rng.random(tuple(t.shape)) < 0.7)
        cs[k] = torch.stack(reps)
    if explain:
        S, KP, KR = c["rule_valid"].shape
        cs[tkernel.ORIG_TABLE] = torch.stack([torch.from_numpy(
            rng.permutation(S * KP * KR).astype(np.int32)).reshape(
                S, KP, KR) for _ in range(G)])
    inv = {k: c[k] for k in INVARIANT_TABLES}
    flags = (bool((batch.arrays["r_acl_ent"] >= 0).any()),
             tkernel.tree_needs_hr(compiled.arrays),
             tkernel.tree_needs_rel(compiled.arrays))
    return (inv, cs, g_idx, r) + flags, explain


def grouped_vs_plain(libs, args, explain):
    """The emulated K4 against its plain version on ``args`` -> the block
    shape ints of the launch."""
    from access_control_srv_tpu_torch.ops.prefilter_ref import (
        decide_grouped_ref,
    )

    want = decide_grouped_ref(*args, explain=explain)
    return replay_grouped(libs["decide_grouped"], args + (explain,), want)


def with_rule_width(d: dict, kr: int) -> dict:
    """The rule-axis tables of ``d`` (``rule_*``, ``rl_*`` and
    ``rule_orig_flat``, [G, S, KP, KR, ...]) at ``kr`` slots: cut, or
    widened by repeating each policy's rules (so every 32-wide chunk of a
    wide policy holds real rules); other entries as they are."""
    out = dict(d)
    for k, t in d.items():
        if k.startswith("rule_") or k.startswith("rl_"):
            idx = torch.arange(kr) % t.shape[3]
            out[k] = t[:, :, :, idx].contiguous()
    return out


def stress_hits(seed: int, n: int, acl: bool = True, no_id: int = 3):
    """``n`` requests that hit chip_smoke's 720-rule stress tree (its 23
    roles, 16 entities, 4 actions; every ``no_id``-th row without a
    subject id, which aborts the conditioned rules), a quarter of them with
    ACL instances when ``acl`` (the verifyACL create / read paths)."""
    import chip_smoke

    rng = random.Random(seed)
    out = []
    for i in range(n):
        kw = {}
        if acl and rng.random() < 0.25:
            kw = dict(acl_indicatory_entity=chip_smoke.ORG,
                      acl_instances=rng.sample(chip_smoke.OWNERS,
                                               rng.randint(1, 3)))
        req = chip_smoke.build_request(
            subject_id=rng.choice(["u1", "ada", "ben"]),
            subject_role=f"role-{rng.randrange(23)}",
            role_scoping_entity=chip_smoke.ORG,
            role_scoping_instance=rng.choice(chip_smoke.OWNERS),
            resource_type=chip_smoke.STRESS_ENTITIES[rng.randrange(16)],
            resource_id="id-0",
            action_type=chip_smoke.ACTIONS[rng.randrange(4)],
            owner_indicatory_entity=chip_smoke.ORG,
            owner_instance=rng.choice(chip_smoke.OWNERS), **kw)
        if i % no_id == 0:
            req.context["subject"].pop("id", None)
        out.append(req)
    return out


def acl_batch(n, seed, specs=None):
    """A port compile of acl_policies.yml and ``n`` rows of ACL-heavy
    traffic (or the request specs ``specs``), about half of them carrying
    ACL instances."""
    from access_control_srv_tpu_torch import models as tmodels
    from access_control_srv_tpu_torch.ops import (
        compile_policies,
        encode_requests,
    )

    from .test_torch_carryover import make_engines

    _, teng = make_engines("acl_policies.yml")
    tc = compile_policies(teng.policy_sets, teng.urns)
    if specs is None:
        specs = acl_heavy_specs(random.Random(seed), n)
    batch = encode_requests([build_request(s, tmodels) for s in specs], tc)
    return tc, batch


def acl_instances(specs) -> list:
    """Whether each request spec carries ACL instances."""
    _, batch = acl_batch(0, 0, specs)
    return ((batch.arrays["r_acl_inst"] >= 0)
            .reshape(len(specs), -1).any(1).tolist())


def test_grouped_slot_edges(libs, monkeypatch):
    """K4 over its slot layout: a group whose rows span several slots
    (each split over blocks of 3 rows), pad positions in the last slot of
    every group, a one-row group, and rows with and without ACL
    instances in one launch, explain off and on."""
    monkeypatch.setitem(tkernel.GROUPED_STAGE, "rows", 3)
    tc, batch = acl_batch(64, 5)
    inst = (batch.arrays["r_acl_inst"] >= 0).reshape(64, -1).any(1)
    assert 0 < inst.sum() < 64
    g_rows = [0] * 50 + [1] + [2] * 5 + [3] * 5 + [4] * 3
    for explain in (False, True):
        args, flag = stacked_grouped(tc, batch, g_rows, explain)
        assert args[4]  # the ACL variant
        layout = tkernel.grouped_layout(np.asarray(args[2]), 5, "cpu")
        real = layout.gp_orig[layout.grid2row.reshape(-1).long()] == \
            torch.arange(layout.grid2row.numel())
        assert int((layout.slot_g == 0).sum()) >= 3  # 50 rows, R = 16
        assert not bool(real.all())  # pad positions
        shape = grouped_vs_plain(libs, args, flag)
        assert shape["RT"] == 3 and shape["R"] == 16
    # blocks of ACL-instance rows only: each row's own masks
    monkeypatch.setitem(tkernel.GROUPED_STAGE, "rows", 16)
    specs = [s for s in acl_heavy_specs(random.Random(8), 160)]
    rows = [s for s, has in zip(specs, acl_instances(specs)) if has][:32]
    tc, batch = acl_batch(0, 0, rows)
    args, flag = stacked_grouped(tc, batch, [0], False)
    grouped_vs_plain(libs, args, flag)


def test_grouped_rounds_and_rule_tiles(libs, monkeypatch):
    """The stress tree (hundreds of targets, many policies) with the rule
    arrays staged one policy at a time, with and without explain: rows x
    targets span several rounds of the stages A-C work list."""
    from access_control_srv_tpu_torch import models as tmodels
    from access_control_srv_tpu_torch.ops import (
        compile_policies,
        encode_requests,
    )

    import chip_smoke

    from .test_torch_kernel import engines_from_doc

    monkeypatch.setitem(tkernel.GROUPED_STAGE, "rules", 1)
    _, teng = engines_from_doc(chip_smoke.small_stress_doc(conditions=True))
    tc = compile_policies(teng.policy_sets, teng.urns)
    batch = encode_requests([build_request(request_spec(r), tmodels)
                             for r in stress_hits(4, 12)], tc)
    for explain in (False, True):
        args, flag = stacked_grouped(tc, batch, [0, 1, 1, 0], explain)
        shape = grouped_vs_plain(libs, args, flag)
        assert shape["PT"] == 1 and shape["T"] * 8 > 4096
    from access_control_srv_tpu_torch.ops.prefilter_ref import (
        decide_grouped_ref,
    )
    assert set(decide_grouped_ref(*args)[0].tolist()) == {0, 1, 2}
    # one group: 16 rows x 720 targets, three rounds
    args, flag = stacked_grouped(tc, batch, [0], False)
    shape = grouped_vs_plain(libs, args, flag)
    assert shape["RT"] >= 16 and 16 * shape["T"] > 2 * 4096


@pytest.mark.parametrize("name", ["policy_set_targets.yml", "edge",
                                  "combining"])
def test_grouped_sets_and_edges(libs, name):
    """S > 1 (three policy sets, last-set-wins across them) and the
    explain recovery's edges (rule-less policies, unknown combining
    algorithms at either level: slot 0 selected, the rule slot clipped)
    through K4, each group's rule_orig_flat a permutation."""
    from access_control_srv_tpu_torch import models as tmodels
    from access_control_srv_tpu_torch.ops import (
        compile_policies,
        encode_requests,
    )
    from access_control_srv_tpu_torch.ops.prefilter_ref import (
        decide_grouped_ref,
    )

    from .test_torch_carryover import make_engines, spec_grid
    from .test_torch_explain import edge_case, edited
    from .test_torch_kernel import engines_from_doc

    if name == "policy_set_targets.yml":
        _, teng = make_engines(name)
        specs = spec_grid(n=24, seed=31)
    else:
        doc, specs = edge_case() if name == "edge" else combining_case()
        _, teng = engines_from_doc(doc)
    base = compile_policies(teng.policy_sets, teng.urns)
    batch = encode_requests([build_request(s, tmodels) for s in specs], base)
    kinds = set()
    for edit in ("none", "set", "policy"):
        tc = edited(base, set_ca=edit == "set", pol_ca=edit == "policy")
        args, flag = stacked_grouped(tc, batch, [0, 1, 2], True, seed=3)
        grouped_vs_plain(libs, args, flag)
        kinds |= set((decide_grouped_ref(*args, explain=True)[3] & 3)
                     .tolist())
    assert {"policy_set_targets.yml": base.S == 3, "edge": kinds >= {1, 2},
            "combining": kinds >= {0, 1}}[name]


@pytest.mark.parametrize("kr", [1, 5, 16, 33])
def test_rule_widths(libs, monkeypatch, kr):
    """K3 and K4 at KR of 1 (32 policies per warp step), 5 (segments that
    do not divide the warp), 16 and 33 (two 32-wide chunks per policy):
    the recorded calls of a stress batch with ACL rows, their rule axes
    cut or widened with repeated rules, explain off and on, each against
    its plain version on the same arguments."""
    from access_control_srv_tpu_torch.ops.prefilter_ref import (
        decide_grouped_ref,
        sig_decide_ref,
    )

    import chip_smoke

    engine = engine_of(chip_smoke.small_stress_doc(conditions=True))
    compiled = jcompile(engine.policy_sets, engine.urns)
    requests = stress_hits(9, 8) + stress_hits(10, 8, acl=False)
    calls = record(monkeypatch)
    jreqs = [build_request(request_spec(r), jmodels) for r in requests]
    for part in (jreqs[:8], jreqs[8:]):
        run(compiled, part, force=False)
        run(compiled, part, force=False, explain=True)
    seen = set()
    decisions = set()
    for name, args, _ in calls:
        if name == "sig_planes":
            continue
        explain = args[-1]
        if name == "sig_decide":
            a = (args[0], with_rule_width(args[1], kr),
                 with_rule_width(args[2], kr)) + args[3:-1]
            want = sig_decide_ref(*a, explain=explain)
            replay_sig(libs["sig_decide"], a + (explain,), want)
        else:
            a = (args[0], with_rule_width(args[1], kr)) + args[2:-1]
            want = decide_grouped_ref(*a, explain=explain)
            replay_grouped(libs["decide_grouped"], a + (explain,), want)
        seen.add((name, explain))
        decisions |= {(name, d) for d in want[0].tolist()}
    assert seen == {(n, e) for n in ("sig_decide", "decide_grouped")
                    for e in (False, True)}
    for name in ("sig_decide", "decide_grouped"):
        assert len({d for n, d in decisions if n == name}) >= 2


def test_sig_tiled_and_sets(libs, monkeypatch):
    """K3 with its rule positions staged one policy at a time and blocks
    of 3 rows (a slot split over blocks), on the stress tree and on a
    fixture of three policy sets forced onto the signature machinery,
    explain off and on."""
    import chip_smoke

    monkeypatch.setitem(tkernel.SIG_STAGE, "rules", 1)
    monkeypatch.setitem(tkernel.SIG_STAGE, "rows", 3)
    calls = record(monkeypatch)
    engine = engine_of(chip_smoke.small_stress_doc(conditions=True))
    compiled = jcompile(engine.policy_sets, engine.urns)
    run(compiled, [build_request(request_spec(r), jmodels)
                   for r in stress_hits(6, 12, acl=False)], force=False,
        explain=True)
    engine = make_engine("policy_set_targets.yml")
    sets = jcompile(engine.policy_sets, engine.urns)
    assert sets.S == 3
    specs = [r for r in grid_requests(n=24, seed=12)]
    batch = jencode(specs, sets)
    plain_rows = [r for r, a, p in zip(
        specs, (batch.arrays["r_acl_ent"] >= 0).any(1),
        batch.arrays["r_has_props"]) if not a and not p]
    run(sets, plain_rows)
    run(sets, plain_rows, explain=True)
    assert replay(libs, calls) == {"sig_planes", "sig_decide"}
    assert {args[2]["rl_ex"].shape[1] for n, args, _ in calls
            if n == "sig_decide"} >= {3}
    assert {d for n, _, out in calls if n == "sig_decide"
            for d in out[0].tolist()} >= {1, 2}


def test_occupancy_exports(libs, monkeypatch):
    """Both libraries export the resident blocks per SM of a variant
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; the stand-in's
    SM holds 2,048 threads and 232,448 bytes)."""
    tc, batch = acl_batch(16, 2)
    args, _ = stacked_grouped(tc, batch, [0, 1])
    layout = tkernel.grouped_layout(np.asarray(args[2]), 2, "cpu")
    packed = tkernel.pack_grouped(args[0], args[1], args[3], layout)
    blocks = libs["decide_grouped"].acs_decide_grouped_occupancy(
        ctypes.addressof(packed.dims), len(packed.dims), 1, 0, 0, 0,
        packed.threads)
    smem = libs["decide_grouped"].acs_decide_grouped_smem(
        ctypes.addressof(packed.dims), len(packed.dims), 1, 0,
        packed.threads)
    assert blocks == min(2048 // packed.threads, 232448 // smem)
    calls = record(monkeypatch)
    engine = make_engine("basic_policies.yml")
    compiled = jcompile(engine.policy_sets, engine.urns)
    run(compiled, grid_requests(n=16, seed=4, acl=False, props=False)
        if False else [r for r in grid_requests(n=16, seed=4)])
    for name, a, _ in calls:
        if name != "sig_decide":
            continue
        _, ptrs, dims = tkernel.pack_sig_decide(*a[:7], *a[8:12])
        smem = libs["sig_decide"].acs_sig_decide_smem(
            ctypes.addressof(dims), len(dims), tkernel.SIG_DECIDE_THREADS)
        assert libs["sig_decide"].acs_sig_decide_occupancy(
            ctypes.addressof(ptrs), len(ptrs), ctypes.addressof(dims),
            len(dims), 0, 0, 0, tkernel.SIG_DECIDE_THREADS) == min(
                2048 // tkernel.SIG_DECIDE_THREADS, 232448 // smem)


def randomized(d: dict, rng, spec: dict) -> dict:
    """``d`` with the entries named in ``spec`` replaced by seeded random
    contents of the same shape and dtype: ("bool", p) draws True with
    probability p, ("int", lo, hi) integers in [lo, hi), ("choice", xs) from
    xs."""
    out = dict(d)
    for k, how in spec.items():
        if k not in d or d[k] is None:
            continue
        shape, dtype = tuple(d[k].shape), d[k].dtype
        if how[0] == "bool":
            a = rng.random(shape) < how[1]
        elif how[0] == "int":
            a = rng.integers(how[1], how[2], size=shape)
        else:
            a = rng.choice(np.asarray(how[1]), size=shape)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    return out


# valid ranges of the policy and rule tables and the set algorithms
# (unknown combining algorithms included; effects 0-2; one rule in four
# with a condition below C); the set gates stay the tree's, since one set
# gated off would decide nothing
def table_spec(C: int) -> dict:
    return {
        "set_ca": ("choice", [0, 1, 2, 5]), "pol_valid": ("bool", 0.85),
        "pol_ca": ("choice", [0, 1, 2, 2, 5]), "pol_effect": ("int", 0, 3),
        "pol_cacheable": ("bool", 0.5), "pol_has_target": ("bool", 0.6),
        "pol_has_subjects": ("bool", 0.5), "pol_n_rules": ("choice", [0, 3]),
        "pol_eff_ctx": ("int", 1, 3), "rule_valid": ("bool", 0.8),
        "rule_effect": ("int", 0, 3), "rule_cacheable_raw": ("bool", 0.5),
        "rule_cacheable_eff": ("bool", 0.5),
        "rule_has_target": ("bool", 0.8),
        "rule_cond": ("choice", [-1, -1, -1] + [min(c, C - 1) for c in
                                                 range(max(C, 1))]
                      if C else [-1]),
    }


def random_call(name: str, args: tuple, kr: int, rng) -> tuple:
    """A recorded K3 / K4 call (its explain flag last) with the rule axis
    at ``kr`` slots and seeded random tables (``table_spec``; K3 also its
    planes and packed rows, with subject pairs on) -> the kernel's
    arguments without the flag."""
    if name == "decide_grouped":
        inv, cs, g_idx, r = args[:4]
        spec = table_spec(r["cond_true"].shape[0])
        return (randomized(inv, rng, spec),
                randomized(with_rule_width(cs, kr), rng, spec), g_idx,
                r) + args[4:7]
    (inv, cs, planes, slot_g, rows, g2r, gp, n_rows, schedule, _, with_hr,
     with_rel, _) = args
    C = dict((k, w) for k, w, _ in schedule)["cond_true"]
    spec = table_spec(C)
    planes = randomized(with_rule_width(planes, kr), rng, {
        **{k: ("bool", 0.7) for k in planes if planes[k].dtype == torch.bool},
        **{k: ("int", 0, 4) for k in ("rl_role", "pl_role", "sl_role")},
        **{k: ("int", 0, 2) for k in ("rl_n_sub", "pl_n_sub", "sl_n_sub")},
        **{k: ("int", -1, 3) for k in planes
           if k.endswith("_sub_ids") or k.endswith("_sub_vals")},
    })
    rows = rows.clone()
    off = 0
    for col, w, _ in schedule:
        lo, hi = {"r_roles": (-1, 4), "r_sub_ids": (-1, 3),
                  "r_sub_vals": (-1, 3), "r_n_entity_attrs": (1, 3),
                  "r_n_ra": (0, 2), "r_acl_short": (0, 3),
                  "cond_true": (0, 2), "cond_code": (400, 403),
                  }.get(col, (None, None))
        if col == "cond_abort":
            rows[:, off:off + w] = torch.from_numpy(
                (rng.random((rows.shape[0], w)) < 0.05).astype(np.int32))
        elif lo is not None:
            rows[:, off:off + w] = torch.from_numpy(
                rng.integers(lo, hi, (rows.shape[0], w)).astype(np.int32))
        off += w
    return (randomized(inv, rng, spec),
            randomized(with_rule_width(cs, kr), rng, spec), planes, slot_g,
            rows, g2r, gp, n_rows, schedule, True, with_hr, with_rel)


@pytest.mark.parametrize("kr", [5, 16, 33])
def test_random_tables(libs, monkeypatch, kr):
    """K3 and K4 against their plain versions on recorded calls whose
    rule and policy tables and set algorithms (and K3's planes and packed
    rows) are replaced by seeded random contents in their valid ranges,
    the rule axis at ``kr`` slots and policies staged three at a time:
    every combining algorithm (unknown ones too), rule-less policies,
    aborts anywhere in a policy's window, windows across bitset words,
    subject pairs, explain off and on."""
    from access_control_srv_tpu_torch.ops.prefilter_ref import (
        decide_grouped_ref,
        sig_decide_ref,
    )

    import chip_smoke

    monkeypatch.setitem(tkernel.SIG_STAGE, "rules", 10 * 3 * kr)
    monkeypatch.setitem(tkernel.GROUPED_STAGE, "rules", 9 * 3 * kr)
    engine = engine_of(chip_smoke.small_stress_doc(conditions=True))
    compiled = jcompile(engine.policy_sets, engine.urns)
    calls = record(monkeypatch)
    jreqs = [build_request(request_spec(r), jmodels)
             for r in stress_hits(11, 16) + stress_hits(12, 16, acl=False)]
    run(compiled, jreqs[:16], force=False, explain=True)
    run(compiled, jreqs[16:], force=False, explain=True)
    rng = np.random.default_rng(kr)
    kinds = set()
    for name, args, _ in calls:
        if name == "sig_planes" or not args[-1]:
            continue
        # every draw is held against the plain version; draws go on until
        # the call's rows show rule-decided and aborted codes (at most 6)
        for _ in range(6):
            a = random_call(name, args, kr, rng)
            for explain in (False, True):
                if name == "sig_decide":
                    want = sig_decide_ref(*a, explain=explain)
                    replay_sig(libs["sig_decide"], a + (explain,), want)
                else:
                    want = decide_grouped_ref(*a, explain=explain)
                    replay_grouped(libs["decide_grouped"], a + (explain,),
                                   want)
            got = {(name, c & 3) for c in want[3].tolist()}
            kinds |= got
            if {(name, 1), (name, 3)} <= got:
                break
    assert kinds >= {(n, k) for n in ("sig_decide", "decide_grouped")
                     for k in (1, 3)}


def test_grouped_acl_rows_own_masks(libs):
    """K4 blocks of 16 rows that all carry ACL instances, one subject and
    action to every 8 rows with 8 distinct instance sets between them, so
    that rows of a block decide differently by their instances alone:
    each row's target bits come from its own instance masks, explain off
    and on."""
    from access_control_srv_tpu_torch.ops.prefilter_ref import (
        decide_grouped_ref,
    )

    sets = [["Org1"], ["OrgX"], ["Org1", "Org2"], ["otherOrg"], ["Org2"],
            ["SuperOrg1"], ["Org3", "OrgX"], ["Org1", "OrgX"]]
    specs = [request_spec(jax_build_request(
        subject_id="Alice", subject_role=role, role_scoping_entity=ORG,
        role_scoping_instance="Org1", resource_type=BUCKET,
        resource_id="res-1", action_type=URNS[act],
        owner_indicatory_entity=ORG, owner_instance="Org1",
        acl_indicatory_entity=ORG, acl_instances=inst))
        for role in ("Admin", "SimpleUser")
        for act in ("create", "modify", "read") for inst in sets]
    assert all(acl_instances(specs))
    tc, batch = acl_batch(0, 0, specs)
    for explain in (False, True):
        args, flag = stacked_grouped(tc, batch, [0], explain)
        shape = grouped_vs_plain(libs, args, flag)
        assert shape["RT"] == 16
    dec = decide_grouped_ref(*args)[0].reshape(-1, 16)
    assert all(len(set(b.tolist())) == 2 for b in dec[:3])


@pytest.mark.parametrize("slots", [(32,), (0, 32)])
def test_second_rule_chunk(libs, monkeypatch, slots):
    """K3 and K4 at KR 33 on recorded calls with seeded random tables,
    every policy's valid rules cut to ``slots`` (slot 32 alone in the
    second 32-wide chunk, or slots 0 and 32) and ``rule_orig_flat`` the
    identity: rows decided by slot 32 where it is the first rule the
    policy's algorithm selects (found at its own position in the second
    chunk), aborting at slot 32, and decided by slot 0 where slot 32
    would be selected too (a later chunk's rule never taken over the
    first chunk's), explain off and on."""
    import chip_smoke

    engine = engine_of(chip_smoke.small_stress_doc(conditions=True))
    compiled = jcompile(engine.policy_sets, engine.urns)
    calls = record(monkeypatch)
    jreqs = [build_request(request_spec(r), jmodels)
             for r in stress_hits(11, 16) + stress_hits(12, 16, acl=False)]
    run(compiled, jreqs[:16], force=False, explain=True)
    run(compiled, jreqs[16:], force=False, explain=True)
    rng = np.random.default_rng(33)
    # (kind, slot, slot 0 selectable, slot 32 selectable); None where
    # slot 0 is not valid or the code is an abort
    wanted = ({(1, 32, None, True), (3, 32, None, None)} if slots == (32,)
              else {(1, 32, False, True), (1, 0, True, True)})
    seen = set()
    for name, args, _ in calls:
        if name == "sig_planes" or not args[-1]:
            continue
        # draws go on until the call's rows show the wanted codes (at
        # most 6), every draw held against the plain version
        got = set()
        for _ in range(6):
            got |= second_chunk_draw(libs, name, random_call(
                name, args, 33, rng), slots, rng)
            if wanted <= got:
                break
        seen |= {(name,) + t for t in got}
    assert seen >= {(n,) + t for n in ("sig_decide", "decide_grouped")
                    for t in wanted}


def second_chunk_draw(libs, name: str, a: tuple, slots: tuple,
                      rng) -> set:
    """One K3 / K4 call ``a`` at KR 33 with only the rule ``slots`` valid
    and ``rule_orig_flat`` the identity (every policy valid and with
    rules, the set algorithms known), held against its plain version
    explain off and on.  Slot 32's effect is the one its policy's
    algorithm selects (deny- / permit-overrides), slot 0's drawn per
    policy -> (kind, slot, slot 0 selectable, slot 32 selectable) of its
    rule-decided and aborted codes."""
    from access_control_srv_tpu_torch.ops.prefilter_ref import (
        decide_grouped_ref,
        sig_decide_ref,
    )

    # every policy valid and with rules, and the set algorithms known, so
    # that the policies' selected rules decide
    set_ca = a[0]["set_ca"]
    inv = {**a[0], "pol_valid": torch.ones_like(a[0]["pol_valid"]),
           "pol_n_rules": torch.full_like(a[0]["pol_n_rules"], 3),
           "set_ca": torch.where(set_ca > 2, torch.ones_like(set_ca),
                                 set_ca)}
    cs = dict(a[1])
    kept = torch.zeros(33, dtype=torch.bool)
    kept[list(slots)] = True
    cs["rule_valid"] = kept.expand(cs["rule_valid"].shape).contiguous()
    ca = inv["pol_ca"].long()
    e32 = torch.from_numpy(rng.integers(1, 3, tuple(ca.shape)))
    e0 = torch.from_numpy(rng.integers(1, 3, tuple(ca.shape)))
    e32 = torch.where(ca == 0, 2, torch.where(ca == 1, 1, e32))
    if slots == (32,):
        e0 = 3 - e32
    eff = cs["rule_effect"].clone()
    eff[..., 0] = e0.to(eff.dtype)
    eff[..., 32] = e32.to(eff.dtype)
    cs["rule_effect"] = eff
    G, S, KP = eff.shape[:3]
    cs[tkernel.ORIG_TABLE] = torch.arange(
        S * KP * 33, dtype=torch.int32).reshape(S, KP, 33).expand(
            G, S, KP, 33).contiguous()
    a = (inv, cs) + a[2:]
    for explain in (False, True):
        if name == "sig_decide":
            want = sig_decide_ref(*a, explain=explain)
            replay_sig(libs["sig_decide"], a + (explain,), want)
        else:
            want = decide_grouped_ref(*a, explain=explain)
            replay_grouped(libs["decide_grouped"], a + (explain,), want)

    def selectable(e, p):
        c = int(ca.flatten()[p])
        return c == 2 or (c, int(e.flatten()[p])) in ((0, 2), (1, 1))

    out = set()
    for c in want[3].tolist():
        pos, kind = c >> 2, c & 3
        if kind == 3:
            out.add((3, pos % 33, None, None))
        elif kind == 1:
            p = pos // 33
            out.add((1, pos % 33, selectable(e0, p) if 0 in slots else None,
                     selectable(e32, p)))
    return out


# ------------------------------------- K2's tiling on seeded random tables


def random_planes_call(rng, G, T, S, KP, KR, KS, NR, NOP, KE=2, KA=2, KO=2,
                       KPR=2, NACT=3, NP=2, W=4) -> tuple:
    """One ``sig_planes`` call's arguments (without the variant flags) at
    the given shapes, every table, policy array and pseudo-request drawn
    by ``rng`` in its valid range (the pseudo-requests with properties,
    which the planes path never sends, to reach every gate of stage A)."""
    E = max(NR, 1)

    def ints(shape, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, size=shape)
                                .astype(np.int32))

    def bools(shape, p):
        return torch.from_numpy(rng.random(shape) < p)

    tabs = {
        "t_n_subjects": ints((G, T), 0, 3), "t_role": ints((G, T), -1, 5),
        "t_has_role": bools((G, T), 0.5), "t_has_scoping": bools((G, T), 0.5),
        "t_hr_check": bools((G, T), 0.5), "t_skip_acl": bools((G, T), 0.3),
        "t_sub_ids": ints((G, T, KS), -1, 4),
        "t_sub_vals": ints((G, T, KS), -1, 4),
        "t_act_ids": ints((G, T, KA), -1, 2),
        "t_act_vals": ints((G, T, KA), 0, 2),
        "t_ent_vals": ints((G, T, KE), -1, 5),
        "t_ent_w": ints((G, T, KE), -1, W),
        "t_ent_tails": ints((G, T, KE), -1, 3),
        "t_op_vals": ints((G, T, KO), -1, 4),
        "t_prop_vals": ints((G, T, KPR), -1, 4),
        "t_prop_sfx": ints((G, T, KPR), -1, 3),
        "t_has_props": bools((G, T), 0.3), "t_n_res": ints((G, T), 0, 3),
        "t_rs_idx": ints((G, T), 0, 6), "t_rel_idx": ints((G, T), -1, 6),
        "t_rel_direct": bools((G, T), 0.5),
        "rule_effect": ints((G, S, KP, KR), 0, 3),
        "rule_target": ints((G, S, KP, KR), 0, T),
        "pol_target": ints((G, S, KP), 0, T),
        "set_target": ints((G, S), 0, T),
    }
    inv = {"pol_valid": bools((S, KP), 0.8),
           "pol_effect": ints((S, KP), 0, 3),
           "pol_has_props": bools((S, KP), 0.3),
           "pol_ent_vals": ints((S, KP, KE), -1, 5)}
    pseudo = {
        "r_act_ids": ints((G, NACT), -1, 2),
        "r_act_vals": ints((G, NACT), 0, 2),
        "r_ent_vals": ints((G, NR), -1, 5), "r_ent_e": ints((G, NR), 0, E),
        "r_ent_valid": bools((G, NR), 0.6),
        "r_prop_vals": ints((G, NP), -1, 4), "r_prop_sfx": ints((G, NP), -1, 3),
        "r_prop_run": ints((G, NP), -1, NR), "r_prop_tail": ints((G, NP), -1, 3),
        "r_op_vals": ints((G, NOP), -1, 4),
        "r_has_props": bools((G,), 0.5),
        "rgx_set": bools((G, W, E), 0.3), "pfx_neq": bools((G, W, E), 0.3),
    }
    return tabs, inv, pseudo


def planes_vs_plain(lib, args: tuple, with_hr: bool, with_rel: bool):
    """One call through the emulated kernel (its allocation dirty first),
    every plane against the plain version's."""
    from access_control_srv_tpu_torch.ops.prefilter_ref import (
        sig_planes_ref,
    )

    want = sig_planes_ref(*args, with_hr, with_rel)
    got, buf, ptrs, dims, threads = tkernel.pack_sig_planes(
        *args, with_hr, with_rel)
    buf.fill_(0xCD)
    code = lib.acs_sig_planes(
        ctypes.addressof(ptrs), len(ptrs), ctypes.addressof(dims),
        len(dims), int(with_hr), int(with_rel), threads, None)
    assert code == 0
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    return want


# (G, T, S, KP, KR, KS, NR, NOP, threads): one group and 15 rule positions
# (no whole quad at the end); groups whose positions straddle quads and
# blocks (126 a group, blocks of 128); 33 policies (two lane chunks of the
# set warp) with KS 2 and NR 32; more sets than warps, NR 5 (the collection
# rows as words) and NOP 0
PLANES_SHAPES = [
    (1, 8, 1, 3, 5, 1, 1, 0, 32),
    (5, 8, 2, 7, 9, 3, 16, 3, 32),
    (3, 16, 1, 33, 3, 2, 32, 8, 64),
    (9, 8, 2, 3, 2, 1, 5, 5, 32),
]


@pytest.mark.parametrize("shape", PLANES_SHAPES)
def test_planes_tiling(libs, monkeypatch, shape):
    """K2 on seeded random tables at shapes that reach its tile edges, in
    all four (with_hr, with_rel) variants: each plane equal to the plain
    version's, with positions and groups not whole quads or blocks and
    every subject and collection width path."""
    G, T, S, KP, KR, KS, NR, NOP, threads = shape
    monkeypatch.setattr(tkernel, "SIG_PLANES_THREADS", threads)
    rng = np.random.default_rng(sum(shape))
    args = random_planes_call(rng, G, T, S, KP, KR, KS, NR, NOP)
    seen = set()
    for with_hr in (False, True):
        for with_rel in (False, True):
            want = planes_vs_plain(libs["sig_planes"], args, with_hr,
                                   with_rel)
            seen |= {(k, v) for k in ("rl_ex", "rl_has_role")
                     for v in want[k].flatten().tolist()}
    # the draws reach both values of the match and byte planes
    assert seen >= {(k, v) for k in ("rl_ex", "rl_has_role")
                    for v in (False, True)}


def test_planes_recheck_chunks(libs, monkeypatch):
    """The multi-entity recheck of a set whose only matching policy sits
    in the second 32-lane chunk, and one where no policy matches."""
    monkeypatch.setattr(tkernel, "SIG_PLANES_THREADS", 64)
    rng = np.random.default_rng(5)
    tabs, inv, pseudo = random_planes_call(rng, 2, 8, 1, 40, 2, 1, 4, 2)
    pseudo["r_ent_valid"][:] = torch.tensor([True, False, False, False])
    pseudo["r_ent_vals"][:, 0] = torch.tensor([3, 4], dtype=torch.int32)
    inv["pol_valid"][:] = True
    inv["pol_has_props"][:] = False
    inv["pol_ent_vals"][:] = -1
    inv["pol_ent_vals"][0, 37, 1] = 3
    want = planes_vs_plain(libs["sig_planes"], (tabs, inv, pseudo), False,
                           False)
    assert want["multi_ok"].flatten().tolist() == [True, False]


def test_planes_floor_and_occupancy(libs, monkeypatch):
    """The library's launch floor (an empty kernel over both launches'
    grids) takes the shape ints of a call and refuses a bad block shape;
    its occupancy export counts blocks of the planes pass (no shared
    memory: the stand-in's 2,048 threads an SM)."""
    lib = libs["sig_planes"]
    args = random_planes_call(np.random.default_rng(2), 2, 8, 1, 3, 5, 1, 4,
                              2)
    _, _, _, dims, threads = tkernel.pack_sig_planes(*args, False, False)
    assert lib.acs_sig_planes_floor(ctypes.addressof(dims), len(dims),
                                    threads, None) == 0
    assert lib.acs_sig_planes_floor(ctypes.addressof(dims), len(dims), 48,
                                    None) == -1
    assert lib.acs_sig_planes_floor(ctypes.addressof(dims), len(dims) - 1,
                                    threads, None) == -1
    for hr in (0, 1):
        for rel in (0, 1):
            assert lib.acs_sig_planes_occupancy(hr, rel, 256) == 8
    assert lib.acs_sig_planes_occupancy(0, 0, 512) == -1
