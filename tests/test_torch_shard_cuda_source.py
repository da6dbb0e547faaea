"""The CUDA sources of the sharded programs' kernels, run on the CPU.

``ops/csrc/shard_chunk.cu`` (``rule_chunk`` and ``set_chunk``, its two
modes) and ``shard_tail.cu`` (with the shared ``decide_core.cuh``) are
compiled as C++ with g++ against the
threaded stand-in for ``cuda_runtime.h`` of ``test_torch_cuda_source``
(one ``std::thread`` per CUDA thread, barriers for ``__syncthreads`` and
the warp shuffles).  Every shard of a 2- or 4-way partition
(``partition_rules`` / ``partition_sets``) runs its shard kernel on the
whole batch; the shards' merge rows are merged with ``amin`` (what the
MIN ``all_reduce`` computes) and the tail kernel decides.  Each kernel's
output must equal its plain version (``ops/shard_ref.py``) exactly,
and the merged decisions must equal the dense plain version's.
Both shard kernels run the rows program (``rule_chunk`` in its
rule-chunk mode, ``set_chunk`` in its set-chunk mode) with 64-thread
blocks of 3 rows unless a test asks for another block shape; the tail
runs in the library's block shape (a row per warp in the rule-sharded
mode, a row per thread in the pod-sharded one) unless a test passes
other thread counts.  That nvcc accepts the
sources for ``sm_90a``, and their timing, are checked on the card by
``chip_smoke.py``.
"""

import ctypes

import numpy as np
import pytest
import torch

import access_control_srv_tpu_torch.models as tmodels
from access_control_srv_tpu_torch.ops import compile_policies, encode_requests
from access_control_srv_tpu_torch.ops import delta as tdelta
from access_control_srv_tpu_torch.ops import kernel as tkernel
from access_control_srv_tpu_torch.ops.carry import tables_from_numpy
from access_control_srv_tpu_torch.ops.kernel_ref import decide_dense_ref
from access_control_srv_tpu_torch.ops import shard_ref
from access_control_srv_tpu_torch.parallel import pod_shard, rule_shard
from access_control_srv_tpu_torch.parallel.mesh import row_slice

from .test_torch_carryover import (
    build_request,
    make_engines,
    request_spec,
    spec_grid,
)
from .test_torch_cuda_source import (
    build_emulated,
    set_rows_stage,
    window_batch,
    window_doc,
)
from .test_torch_delta import patched_compile
from .test_torch_kernel import engines_from_doc
from .test_torch_pod_shard import MIXED_SPECS, mixed_ca_doc
from .test_torch_rule_shard import REL_OPS, REL_SPECS, two_shard_abort_doc
from .torch_world import port_store

ENTRY = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
# each kernel's library, and the ints between its shape ints and its
# threads (the mode, then the variant flags)
LIBRARY = {"rule_chunk": "shard_chunk", "set_chunk": "shard_chunk",
           "shard_tail": "shard_tail"}
MODE = {"rule_chunk": tkernel.MODE_RULE, "set_chunk": tkernel.MODE_SET}
FLAGS = {"shard_chunk": 5, "shard_tail": 2}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = {}
    for name, flags in FLAGS.items():
        lib = build_emulated(name, tmp_path_factory.mktemp(f"{name}_emu"))
        getattr(lib, f"acs_{name}_layout").restype = ctypes.c_char_p
        entry = getattr(lib, f"acs_{name}")
        entry.restype = ctypes.c_int
        entry.argtypes = ENTRY + [ctypes.c_int] * (flags + 1) + [
            ctypes.c_void_p]
        out[name] = lib
    smem = out["shard_chunk"].acs_shard_chunk_smem
    smem.restype = ctypes.c_longlong
    smem.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_int] * 3
    for lib_name, sizing in tkernel._SIZING.items():
        if lib_name in out:
            for fn, (restype, argtypes) in sizing.items():
                getattr(out[lib_name], fn).restype = restype
                getattr(out[lib_name], fn).argtypes = argtypes
    return {name: out[lib] for name, lib in LIBRARY.items()}


@pytest.fixture(autouse=True)
def rows_stage(monkeypatch):
    """rule_chunk and set_chunk in two-warp blocks of three rows."""
    set_rows_stage(monkeypatch, 3)


def run_chunk(lib, name, mode, c, r, offset, kr_total, n_model, rank, flags,
              explain=False):
    args = tkernel.pack_chunk_args(name, mode, c, r, offset, kr_total,
                                   n_model, rank, explain, lib=lib)
    args.out.fill_(-7)
    code = lib.acs_shard_chunk(
        ctypes.addressof(args.ptrs), len(args.ptrs),
        ctypes.addressof(args.dims), len(args.dims), mode, *map(int, flags),
        int(explain), args.threads, None)
    assert code == 0
    return args.out


def run_tail(lib, merge, n_model, tabs, explain=False, kr_stride=0,
             threads=None):
    """The tail on the stand-in, in the library's block shape unless
    ``threads`` is given."""
    out, ptrs, dims, mode = tkernel.pack_shard_tail(merge, n_model, tabs,
                                                    explain, kr_stride)
    out.fill_(-7)
    if threads is None:
        threads = tkernel.tail_block(lib, mode)["threads"]
    assert lib.acs_shard_tail(ctypes.addressof(ptrs), len(ptrs),
                              ctypes.addressof(dims), len(dims), mode,
                              int(explain), threads, None) == 0
    return out


def to_kr_stride(code, KR, kr_total):
    """Dense provenance codes (strides (KP, KR)) in the rule-sharded
    strides (KP, kr_total): rule and abort positions re-based, no-rules
    policy positions as they are."""
    kind, pos = code & 3, code >> 2
    rebased = ((pos // KR * kr_total + pos % KR) << 2) | kind
    return torch.where((kind == 1) | (kind == 3), rebased, code)


def tree_inputs(compiled, batch, explain: bool = False):
    """(variant flags, rows, dense plain outputs, eligible rows) of a
    compiled tree and batch on the CPU."""
    flags = (bool((batch.arrays["r_acl_ent"] >= 0).any()),
             tkernel.tree_needs_hr(compiled.arrays),
             tkernel.tree_needs_rel(compiled.arrays))
    _, r = row_slice(batch, "cpu", tkernel.ROW_ARRAYS, 1, 0)
    c = tables_from_numpy(compiled.arrays, "cpu", keys=tkernel.TABLE_ARRAYS)
    dense = torch.stack(decide_dense_ref(c, r, *flags, explain=explain))
    el = torch.from_numpy(np.asarray(batch.eligible))
    return flags, r, dense, el


def check_set_shards(libs, compiled, batch, n_model: int,
                     explain: bool = False) -> torch.Tensor:
    """``set_chunk`` on every shard of an ``n_model``-way set partition,
    each shard's tables padded past its live rows as ``PodShardedKernel``
    places them and cut back at ``t_live``: equal to its plain version on
    the uncut tables; the merged decisions (``amin``, the tail) equal to
    the dense plain version's; returns the tail's outputs [3, B] ([4,
    B])."""
    flags, r, dense, el = tree_inputs(compiled, batch, explain)
    n = batch.B
    shards, _ = pod_shard.partition_sets(compiled, n_model)
    merges = []
    for d, sh in enumerate(shards):
        cd = tables_from_numpy(padded_shard(sh, 2 * sh.t_live), "cpu")
        want = shard_ref.set_chunk_ref(cd, r, sh.s_lo, n_model, d, *flags,
                                       explain=explain)
        got = run_chunk(libs["set_chunk"], "set_chunk", tkernel.MODE_SET,
                        tkernel.live_rows(cd, sh.t_live), r, sh.s_lo,
                        cd["rule_valid"].shape[2], n_model, d, flags,
                        explain)
        assert torch.equal(got, want), ("set_chunk", d)
        merges.append(got)
    merged = torch.stack(merges).amin(dim=0)
    want = shard_ref.shard_tail_ref(merged, n_model, explain=explain,
                                    kr_stride=compiled.KR)
    got8 = run_tail(libs["shard_tail"], merged, n_model, None, explain,
                    compiled.KR)
    assert torch.equal(got8, want)
    assert torch.equal(got8[:, :n][:, el], dense[:, :n][:, el])
    return got8[:, :n]


def padded_shard(sh, t_cap: int) -> dict:
    """A shard's kernel tables with the target subtable padded to
    ``t_cap`` rows by repeating row 0, as ``PodShardedKernel`` places
    them."""
    out = {}
    for name in tkernel.TABLE_ARRAYS:
        v = sh.arrays[name]
        if name.startswith("t_"):
            v = np.concatenate([v, np.repeat(v[:1], t_cap - len(v), 0)])
        out[name] = v
    return out


def check_tree(libs, compiled, batch, n_model: int, explain: bool = False,
               k7_codes: bool = True) -> torch.Tensor:
    """Both sharded programs on every shard of an ``n_model``-way split:
    each kernel equal to its plain version, the merged decisions equal to
    the dense plain version's (with ``explain`` the provenance codes too:
    K8's in the dense strides, K7's re-based to ``kr_total`` unless
    ``k7_codes`` is off: where the winning policy collected no rule, K7
    reads slot 0 from its merged key as JAX's rule-sharded program does,
    the dense program the clipped selection); returns the outputs [3, B]
    ([4, B])."""
    got7, _, _ = check_rule_shards(libs, compiled, batch, n_model, explain,
                                   k7_codes)
    check_set_shards(libs, compiled, batch, n_model, explain)
    return got7


def rule_merges(libs, compiled, batch, n_model: int):
    """``rule_chunk`` on every shard of an ``n_model``-way rule partition,
    each equal to its plain version -> (the shards' merge rows, the
    padded global rule extent ``kr_total``)."""
    flags, r, _, _ = tree_inputs(compiled, batch)
    part = rule_shard.partition_rules(compiled, n_model)
    kr_total = part.kr_local * n_model
    merges = []
    for d in range(n_model):
        cd = tables_from_numpy({k: part.arrays[k][d]
                                for k in tkernel.TABLE_ARRAYS}, "cpu")
        off = int(part.kr_offsets[d])
        want = shard_ref.rule_chunk_ref(cd, r, off, kr_total, n_model, d,
                                        *flags)
        got = run_chunk(libs["rule_chunk"], "rule_chunk", tkernel.MODE_RULE,
                        cd, r, off, kr_total, n_model, d, flags)
        assert torch.equal(got, want), ("rule_chunk", d)
        merges.append(got)
    return merges, kr_total


def check_rule_shards(libs, compiled, batch, n_model: int,
                      explain: bool = False, k7_codes: bool = True):
    """The rule-sharded program on every shard of an ``n_model``-way rule
    partition (``rule_merges``), merged with ``amin``; the tail equal to
    its plain version and, on the eligible rows, to the dense plain
    version (``check_tree`` says how explain codes compare); returns the
    tail's outputs [3, B] ([4, B]), the shards' merge rows and
    ``kr_total``."""
    _, _, dense, el = tree_inputs(compiled, batch, explain)
    c = tables_from_numpy(compiled.arrays, "cpu", keys=tkernel.TABLE_ARRAYS)
    n = batch.B
    merges, kr_total = rule_merges(libs, compiled, batch, n_model)
    merged = torch.stack(merges).amin(dim=0)
    tabs = {k: c[k] for k in tkernel.TAIL_TABLES}
    want = shard_ref.shard_tail_ref(merged, n_model, tabs, explain=explain,
                                    kr_stride=kr_total)
    got7 = run_tail(libs["shard_tail"], merged, n_model, tabs, explain,
                    kr_total)
    assert torch.equal(got7, want)
    want7 = dense.clone()
    if explain:
        want7[3] = (to_kr_stride(dense[3], compiled.KR, kr_total)
                    if k7_codes else got7[3])
    assert torch.equal(got7[:, :n][:, el], want7[:, :n][:, el])
    return got7[:, :n], merges, kr_total


def port_batch(teng, specs, store_ops=None):
    tc = compile_policies(teng.policy_sets, teng.urns)
    tables = None if store_ops is None else port_store(store_ops).tables_for(
        tc)
    return tc, encode_requests([build_request(s, tmodels) for s in specs],
                               tc, relation_tables=tables)


@pytest.mark.parametrize("name", ["rule_chunk", "set_chunk", "shard_tail"])
def test_layout_matches_host(libs, name):
    if name == "shard_tail":
        ptrs, dims = tkernel.TAIL_PTRS, tkernel.TAIL_DIMS
    else:
        ptrs = tkernel.CHUNK_PTRS
        dims = tkernel.DIMS + tkernel.CHUNK_DIMS + tkernel.ROWS_DIMS
    lib = LIBRARY[name]
    assert getattr(libs[name], f"acs_{lib}_layout")().decode() == \
        ",".join(ptrs) + ",|" + ",".join(dims) + ","


@pytest.mark.parametrize("name", ["rule_chunk", "set_chunk", "shard_tail"])
def test_argument_count_mismatch_is_refused(libs, name):
    ptrs = (ctypes.c_int64 * 3)()
    dims = (ctypes.c_int32 * 3)()
    lib = LIBRARY[name]
    extra = [MODE.get(name, 1)] + [0] * (FLAGS[lib] - 1)
    assert getattr(libs[name], f"acs_{lib}")(
        ctypes.addressof(ptrs), 3, ctypes.addressof(dims), 3, *extra, 64,
        None) == -1
    if name == "rule_chunk":
        # the rule-chunk mode has no explain variant
        _, teng = make_engines("role_scopes.yml")
        tc, batch = port_batch(teng, spec_grid(n=4, seed=1))
        _, r = row_slice(batch, "cpu", tkernel.ROW_ARRAYS, 1, 0)
        c = tables_from_numpy(tc.arrays, "cpu", keys=tkernel.TABLE_ARRAYS)
        args = tkernel.pack_chunk_args(name, tkernel.MODE_RULE, c, r, 0,
                                       tc.KR, 1, 0, lib=libs[name])
        assert libs[name].acs_shard_chunk(
            ctypes.addressof(args.ptrs), len(args.ptrs),
            ctypes.addressof(args.dims), len(args.dims), tkernel.MODE_RULE,
            0, 0, 0, 1, args.threads, None) == -1


@pytest.mark.parametrize("name,n_model", [
    ("role_scopes.yml", 4), ("conditions.yml", 2), ("acl_policies.yml", 2),
    ("props_multi_rules_entities.yml", 2)])
def test_fixture_trees(libs, name, n_model):
    _, teng = make_engines(name)
    tc, batch = port_batch(teng, spec_grid(n=8, seed=53))
    check_tree(libs, tc, batch, n_model)


@pytest.mark.parametrize("name,n_model", [("role_scopes.yml", 4),
                                          ("acl_policies.yml", 2)])
def test_set_chunk_patched_bucketed_tables(libs, name, n_model):
    """A pod partition of tables from ``full_bucketed_compile`` and one
    ``apply_events`` patch (pad set slots in the tail shard, pad target
    rows left out of every shard's compacted subtable): each shard's
    ``set_chunk`` on its live rows equals the plain version, the merge
    the dense plain version."""
    _, teng = make_engines(name)
    patched, stats = patched_compile(teng, tdelta, seed=13)
    assert stats["patched_slots"]
    batch = encode_requests([build_request(s, tmodels)
                             for s in spec_grid(n=8, seed=59)], patched)
    check_set_shards(libs, patched, batch, n_model)


@pytest.mark.parametrize("n_model", [2])
def test_aborts_on_either_shard(libs, n_model):
    _, teng = engines_from_doc(two_shard_abort_doc())
    tc, batch = port_batch(teng, spec_grid(n=24, seed=29))
    out = check_tree(libs, tc, batch, n_model)
    assert len(set(out[1][out[2] != 200].tolist())) == 2


def test_relation_fixture(libs):
    _, teng = make_engines("relation_policies.yml")
    tc, batch = port_batch(teng, REL_SPECS, REL_OPS)
    out = check_tree(libs, tc, batch, 2)
    assert (out[0] == 1).any()


@pytest.mark.parametrize("n_model", [4])
def test_mixed_combining_algorithms(libs, n_model):
    _, teng = engines_from_doc(mixed_ca_doc())
    tc, batch = port_batch(teng, MIXED_SPECS)
    check_tree(libs, tc, batch, n_model)


# ------------------------------------------------------------- explain


@pytest.mark.parametrize("name,n_model", [
    ("role_scopes.yml", 4), ("conditions.yml", 2),
    ("props_multi_rules_entities.yml", 2)])
def test_explain_fixture_trees(libs, name, n_model):
    """The explain variants: ``set_chunk``'s provenance column and both
    tail modes' fourth output equal their plain versions; merged, the
    codes equal the dense program's."""
    from .test_explain import fixture_requests

    _, teng = make_engines(name)
    specs = [request_spec(q) for q in fixture_requests(name, n=8, seed=41)]
    tc, batch = port_batch(teng, specs)
    out = check_tree(libs, tc, batch, n_model, explain=True)
    assert out.shape[0] == 4 and (out[3] != 0).any()


def test_explain_aborts_and_mixed_algorithms(libs):
    """Kind-3 codes from an abort on either shard; the owner shard's code
    wins across sets of mixed combining algorithms, kind-2 (no-rules)
    positions scaled through the merge and back."""
    _, teng = engines_from_doc(two_shard_abort_doc())
    tc, batch = port_batch(teng, spec_grid(n=16, seed=29))
    out = check_tree(libs, tc, batch, 2, explain=True)
    assert 3 in set((out[3] & 3).tolist())
    _, teng = engines_from_doc(mixed_ca_doc())
    tc, batch = port_batch(teng, MIXED_SPECS)
    check_tree(libs, tc, batch, 4, explain=True)


def test_explain_edge_trees(libs):
    """The edge tree of ``test_torch_explain`` (a no-rules policy, a set
    whose first policy does not contribute) with unknown set algorithms:
    kind-2 keys scaled by KR in the merge, clipped rule slots."""
    from .test_torch_explain import edge_case, edited

    doc, specs = edge_case()
    _, teng = engines_from_doc(doc)
    tc, batch = port_batch(teng, specs)
    kinds = set()
    for edit in ("none", "set"):
        out = check_tree(libs, edited(tc, set_ca=edit == "set"), batch, 2,
                         explain=True, k7_codes=edit == "none")
        kinds |= set((out[3] & 3).tolist())
    assert {1, 2} <= kinds


# ------------------------------------- set_chunk: block shapes, live rows


@pytest.mark.parametrize("kr,rt", [(5, 1), (33, 2), (33, 5), (511, 3)])
def test_set_chunk_windows(libs, monkeypatch, kr, rt):
    """``set_chunk`` on both shards of a 2-way split of trees with several
    policies of KR 5, 33 and 511 rules (windows across words), in blocks
    of 1, 2, 5 (not a divisor of the batch) and 3 rows, ACL and non-ACL
    rows in the same blocks, aborts, explain off and on."""
    set_rows_stage(monkeypatch, rt)
    n_policies = {5: 9, 33: 5, 511: 2}[kr]
    tc, batch = window_batch(n_policies, kr, 24, seed=kr + rt)
    for explain in (False, True):
        out = check_set_shards(libs, tc, batch, 2, explain)
        assert (out[2] != 200).any() and set(out[0].tolist()) >= {1, 2}


def test_set_chunk_live_rows(libs):
    """``PodShardedKernel`` on each model coordinate of a 1 x 4 layout
    (one process, no collectives): every shard's device tables padded to
    the sticky ``t_cap`` past its ``t_live`` rows, the kernel on the live
    prefix equal to the plain version on the whole padded table, the
    shards merged equal to the JAX package's pod-sharded kernel on the
    same compile and batch; then again after a ``patched`` re-slice that
    takes a rule out of the last set (its shard's ``t_live`` one lower,
    the same ``t_cap``)."""
    from access_control_srv_tpu import models as jmodels
    from access_control_srv_tpu.ops import compile_policies as jcompile
    from access_control_srv_tpu.ops import encode_requests as jencode
    from access_control_srv_tpu.parallel.pod_shard import (
        PodShardedKernel as JaxPodSharded,
    )
    from access_control_srv_tpu_torch.parallel.mesh import Mesh

    from .test_torch_rule_shard import jax_mesh

    n = 4
    doc = mixed_ca_doc()
    jcs = []
    for _ in range(2):
        jeng, _ = engines_from_doc(doc)
        jcs.append(jcompile(jeng.policy_sets, jeng.urns))
        doc["policy_sets"][-1]["policies"][-1]["rules"].pop()
    meshes = [Mesh(axis_names=("data", "model"),
                   shape={"data": 1, "model": n},
                   coords={"data": 0, "model": d},
                   groups={"data": None, "model": None}, backend=None,
                   device=torch.device("cpu")) for d in range(n)]
    kernels = [pod_shard.PodShardedKernel(jcs[0], m) for m in meshes]
    last = len(doc["policy_sets"]) - 1
    for step in range(2):
        jc = jcs[step]
        batch = jencode([build_request(s, jmodels) for s in MIXED_SPECS], jc)
        _, r = row_slice(batch, "cpu", tkernel.ROW_ARRAYS, 1, 0)
        flags = (False, False, False)
        merges = []
        for d, k in enumerate(kernels):
            t_live = k._own.t_live
            assert k._c["t_role"].shape[0] == k.t_cap > t_live
            args = (k._c, r, k._own.s_lo, n, d) + flags
            want = shard_ref.set_chunk_ref(*args)
            assert torch.equal(shard_ref.set_chunk_ref(*args, t_live=t_live),
                               want)
            got = run_chunk(libs["set_chunk"], "set_chunk", tkernel.MODE_SET,
                            tkernel.live_rows(k._c, t_live), r, k._own.s_lo,
                            jc.KR, n, d, flags)
            assert torch.equal(got, want), (step, d)
            merges.append(got)
        out = shard_ref.shard_tail_ref(torch.stack(merges).amin(dim=0), n)
        jout = JaxPodSharded(jc, jax_mesh(1, n)).evaluate(batch)
        el = np.asarray(batch.eligible)
        assert el.any()
        for w, g in zip(jout, out):
            assert np.array_equal(np.asarray(w)[el], g[:batch.B][el].numpy())
        if step == 0:
            owner = last // kernels[0].s_local
            before = [k._own.t_live for k in kernels]
            kernels = [k.patched(jcs[1], [last]) for k in kernels]
            after = [k._own.t_live for k in kernels]
            assert after == [t - (d == owner) for d, t in enumerate(before)]
            assert len({k.t_cap for k in kernels}) == 1


# ------------------------- rule_chunk: windows, rows per block; the tail


def rule_keys(merge, S: int, KP: int) -> torch.Tensor:
    """The keys of a rule chunk's merge rows -> int64 [B, S, KP, 5]."""
    B = merge.shape[0]
    return merge[:, :S * KP * shard_ref.KEY_COLS].long().reshape(
        B, S, KP, shard_ref.KEY_COLS)


@pytest.mark.parametrize("rt", [1, 2, 5])
@pytest.mark.parametrize("kr_local", [5, 33, 100])
def test_rule_chunk_windows(libs, monkeypatch, kr_local, rt):
    """``rule_chunk`` on both shards of a 2-way rule split of trees whose
    policies hold 10, 66 and 200 rules (KR_local 5, 33, 100; several
    policies per staged tile, so their windows cross bitset words), in
    blocks of 1, 2 and 5 rows: every key equal to the plain version's,
    the first and last keys inside the shard's chunk
    ([OFFSET, OFFSET + KR_local) at the second shard's offset), at
    KR_local 33 and 100 some policy's first collected rule in the second
    32-bit word of its window; aborts on both shards; merged, the tail equal to
    the dense plain version."""
    set_rows_stage(monkeypatch, rt)
    n_policies = {5: 9, 33: 5, 100: 2}[kr_local]
    tc, batch = window_batch(n_policies, 2 * kr_local, 24,
                             seed=kr_local + rt)
    out, merges, kr_total = check_rule_shards(libs, tc, batch, 2)
    assert kr_total == 2 * kr_local and (out[2] != 200).any()
    n = batch.B
    second_word = False
    for d, merge in enumerate(merges):
        off = d * kr_local
        keys = rule_keys(merge[:n], tc.S, tc.KP)
        first, last = keys[..., 2], -keys[..., 3]
        have = first < shard_ref.BIGKEY
        assert have.any() and torch.equal(have, last > 0)
        kr_first = (first[have] >> 3) - off
        kr_last = (last[have] >> 3) - 1 - off
        assert (kr_first >= 0).all() and (kr_last < kr_local).all()
        assert (kr_first <= kr_last).all()
        second_word |= bool((kr_first >= 32).any())
        # the shard's own abort slot, in the padded global order
        slot = merge[:n, tc.S * tc.KP * shard_ref.KEY_COLS + 3 * d]
        assert (slot < shard_ref.BIG).any()
        pos = slot[slot < shard_ref.BIG].long() % kr_total - off
        assert ((pos >= 0) & (pos < kr_local)).all()
    assert second_word == (kr_local > 32)


def role_specs(roles: list) -> list:
    """One request spec per role of ``roles``, in order, over
    ``window_doc``'s entities and actions (the i-th row on entity i % 3
    and action i % 4), with subject ids."""
    import chip_smoke

    return [request_spec(chip_smoke.build_request(
        subject_id="u1", subject_role=role,
        role_scoping_entity=chip_smoke.ORG, role_scoping_instance="Org1",
        resource_type=chip_smoke.STRESS_ENTITIES[i % 3], resource_id="id-0",
        action_type=chip_smoke.ACTIONS[i % 4],
        owner_indicatory_entity=chip_smoke.ORG, owner_instance="Org1"))
        for i, role in enumerate(roles)]


def test_rule_chunk_rows_per_block(libs, monkeypatch):
    """Blocks of 5 rows over 13 rows padded to 16 (three full blocks, a
    last one of one row): the first block's rows hold four different roles
    (each row's keys its own), the second block's only a role no target
    of the tree has (the role filter drops every target: no collected
    rule on any shard), the third mixed; every key equal to the plain
    version's, merged decisions equal to the dense plain version's."""
    set_rows_stage(monkeypatch, 5)
    roles = ([f"role-{k}" for k in (0, 1, 2, 3, 0)] + ["role-9"] * 5
             + [f"role-{k}" for k in (3, 9, 1)])
    _, teng = engines_from_doc(window_doc(5, 66))
    tc, batch = port_batch(teng, role_specs(roles))
    _, r = row_slice(batch, "cpu", tkernel.ROW_ARRAYS, 1, 0)
    c = tables_from_numpy(tc.arrays, "cpu", keys=tkernel.TABLE_ARRAYS)
    shape = tkernel.pack_chunk_args("rule_chunk", tkernel.MODE_RULE, c, r, 0,
                                    tc.KR, 1, 0, lib=libs["rule_chunk"]).shape
    assert shape["RT"] == 5 and shape["B"] % 5 == 1
    out, merges, _ = check_rule_shards(libs, tc, batch, 2)
    keys = torch.stack([rule_keys(m, tc.S, tc.KP) for m in merges])
    collected = (keys[..., 2] < shard_ref.BIGKEY).flatten(2).any(2).any(0)
    assert collected[:4].all() and not collected[5:10].any()
    assert (out[0, 5:10] == 0).all()
    firsts = [tuple(keys[:, j, ..., 2].flatten().tolist()) for j in range(4)]
    assert len(set(firsts)) == 4


@pytest.mark.parametrize("n_model", [1, 2, 4, 8])
def test_tail_rows_per_block(libs, n_model):
    """Both tail modes, explain off and on, on merged rows made from the
    plain chunk versions of every shard of ``n_model``-way rule and set
    partitions (MIN-reduced here) of a tree with aborts, ACL rows and
    mixed algorithms: its first 61 rows (a multiple of no block's rows)
    in blocks of 32 and 96 threads (rule-sharded: 1 and 3 rows a block,
    pod-sharded: 32 and 96) and in the library's shape, equal to the
    plain tail."""
    tc, batch = window_batch(5, 33, 64, seed=n_model)
    flags, r, _, _ = tree_inputs(tc, batch)
    c = tables_from_numpy(tc.arrays, "cpu", keys=tkernel.TABLE_ARRAYS)
    tabs = tkernel.TailTables(c)
    part = rule_shard.partition_rules(tc, n_model)
    kr_total = part.kr_local * n_model
    rule_merged = torch.stack([shard_ref.rule_chunk_ref(
        tables_from_numpy({k: part.arrays[k][d]
                           for k in tkernel.TABLE_ARRAYS}, "cpu"),
        r, int(part.kr_offsets[d]), kr_total, n_model, d, *flags)
        for d in range(n_model)]).amin(dim=0)[:61]
    shards, _ = pod_shard.partition_sets(tc, n_model)
    for explain in (False, True):
        set_merged = torch.stack([shard_ref.set_chunk_ref(
            tables_from_numpy({k: sh.arrays[k]
                               for k in tkernel.TABLE_ARRAYS}, "cpu"),
            r, sh.s_lo, n_model, d, *flags, explain=explain)
            for d, sh in enumerate(shards)]).amin(dim=0)[:61]
        cases = ((rule_merged, tabs, kr_total), (set_merged, None, tc.KR))
        for merged, t, stride in cases:
            want = shard_ref.shard_tail_ref(merged, n_model, t,
                                            explain=explain,
                                            kr_stride=stride)
            assert (want[2] != 200).any() and (want[0] == 1).any()
            for threads in (32, 96, None):
                got = run_tail(libs["shard_tail"], merged.contiguous(),
                               n_model, t, explain, stride, threads)
                assert torch.equal(got, want), (t is None, explain, threads)


def test_tail_block_shape(libs):
    """The tail library's block shape (a warp per row in the
    rule-sharded mode, a thread per row in the pod-sharded one, at least
    128 rows a block there), its refusal of block shapes that are not
    whole warps, and its launch floor and occupancy exports."""
    lib = libs["shard_tail"]
    k7 = tkernel.tail_block(lib, tkernel.MODE_RULE)
    k8 = tkernel.tail_block(lib, tkernel.MODE_SET)
    assert k7["rows"] * 32 == k7["threads"] and k7["rows"] > 1
    assert k8["rows"] == k8["threads"] >= 128
    out = (ctypes.c_int32 * 2)()
    assert lib.acs_shard_tail_block(0, out) == -1
    for mode, shape in ((tkernel.MODE_RULE, k7), (tkernel.MODE_SET, k8)):
        assert lib.acs_shard_tail_floor(mode, 61, shape["threads"],
                                        None) == 0
        assert lib.acs_shard_tail_floor(mode, 61, 48, None) == -1
        assert lib.acs_shard_tail_occupancy(mode, 0, shape["threads"]) == \
            2048 // shape["threads"]
    ptrs = (ctypes.c_int64 * len(tkernel.TAIL_PTRS))()
    dims = (ctypes.c_int32 * len(tkernel.TAIL_DIMS))(1, 1, 1, 1, 1)
    assert lib.acs_shard_tail(ctypes.addressof(ptrs), len(ptrs),
                              ctypes.addressof(dims), len(dims),
                              tkernel.MODE_SET, 0, 100, None) == -1
