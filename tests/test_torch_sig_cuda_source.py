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

import pytest
import torch

from access_control_srv_tpu import models as jmodels
from access_control_srv_tpu.ops import compile_policies as jcompile
from access_control_srv_tpu.ops import encode_requests as jencode
from access_control_srv_tpu_torch.ops import cuda_build
from access_control_srv_tpu_torch.ops import kernel as tkernel
from access_control_srv_tpu_torch.ops import prefilter as tprefilter

from .test_kernel_differential import grid_requests
from .test_sig_kernel import _sig_requests, _sig_tree
from .test_torch_carryover import build_request, request_spec
from .test_torch_cuda_source import build_emulated
from .test_torch_kernel import combining_case
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
    out["decide_grouped"].acs_decide_grouped_smem.restype = ctypes.c_longlong
    out["decide_grouped"].acs_decide_grouped_smem.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    return out


def _snapshot(x):
    """A copy of a recorded argument: the packed rows and slot maps live
    in pooled staging buffers that the next batch overwrites."""
    if isinstance(x, torch.Tensor):
        return x.clone()
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
            (inv, cs, planes, slot_g, rows, g2r, gp, n_rows, schedule,
             needs_pairs, with_hr, with_rel, explain) = args
            got, ptrs, dims = tkernel.pack_sig_decide(
                inv, cs, planes, slot_g, rows, g2r, gp, schedule,
                needs_pairs, with_hr, with_rel, explain)
            code = lib.acs_sig_decide(
                ctypes.addressof(ptrs), len(ptrs), ctypes.addressof(dims),
                len(dims), int(with_hr), int(with_rel), int(explain),
                tkernel.SIG_DECIDE_THREADS, None)
            assert code == 0
            assert torch.equal(got, want)
        else:
            inv, cs, g_idx, r, with_acl, with_hr, with_rel, explain = args
            packed = tkernel.pack_args({**inv, **cs}, r,
                                       extra=(("g_idx", g_idx),),
                                       name="decide_grouped",
                                       explain=explain)
            packed.out.fill_(-7)
            code = lib.acs_decide_grouped(
                ctypes.addressof(packed.ptrs), len(packed.ptrs),
                ctypes.addressof(packed.dims), len(packed.dims),
                int(with_acl), int(with_hr), int(with_rel), int(explain),
                packed.threads, None)
            assert code == 0
            assert torch.equal(packed.out, want)
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
                           + tkernel.OUTPUTS + ("g_idx",), tkernel.DIMS),
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
