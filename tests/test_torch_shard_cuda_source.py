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
``set_chunk`` runs the rows program with 64-thread blocks of 3 rows
unless a test asks for another block shape.  That nvcc accepts the
sources for ``sm_90a``, and their timing, are checked on the card by
``chip_smoke.py``.
"""

import ctypes

import numpy as np
import pytest
import torch

import access_control_srv_tpu_torch.models as tmodels
from access_control_srv_tpu_torch.ops import compile_policies, encode_requests
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
)
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
    return {name: out[lib] for name, lib in LIBRARY.items()}


@pytest.fixture(autouse=True)
def rows_stage(monkeypatch):
    """set_chunk in two-warp blocks of three rows."""
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


def run_tail(lib, merge, n_model, tabs, explain=False, kr_stride=0):
    out, ptrs, dims, mode = tkernel.pack_shard_tail(merge, n_model, tabs,
                                                    explain, kr_stride)
    out.fill_(-7)
    assert lib.acs_shard_tail(ctypes.addressof(ptrs), len(ptrs),
                              ctypes.addressof(dims), len(dims), mode,
                              int(explain), tkernel.TAIL_THREADS[mode],
                              None) == 0
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
    flags, r, dense, el = tree_inputs(compiled, batch, explain)
    c = tables_from_numpy(compiled.arrays, "cpu", keys=tkernel.TABLE_ARRAYS)
    n = batch.B

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
    check_set_shards(libs, compiled, batch, n_model, explain)
    return got7[:, :n]


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
                                       tc.KR, 1, 0)
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
