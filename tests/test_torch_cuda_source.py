"""The CUDA source of the dense decision kernel, run on the CPU.

The test suite runs without nvcc or a card, so ``ops/csrc/decide_dense.cu``
is compiled as C++ with g++ against a small stand-in for ``cuda_runtime.h``
that runs each thread block with one ``std::thread`` per CUDA thread
(``std::barrier`` for ``__syncthreads``, ``__syncwarp`` and the warp
shuffles and ballots, real atomics for ``atomicMin`` / ``atomicMax`` /
``atomicAdd`` / ``atomicOr``).  The launch arguments are
packed by the port's own ``pack_args``, and the outputs must equal the
plain PyTorch version exactly; each intrinsic of the stand-in has a test
of its own semantics here.  The rows program runs with 64-thread blocks
of 3 rows (``rows_stage``) unless a test asks for another block shape.  This checks the kernel's logic and its argument
layout; that nvcc accepts it for ``sm_90a`` and the timing are checked on
the card by ``chip_smoke.py``.
"""

import ctypes
import random
import re
import shutil
import subprocess

import pytest
import torch

import access_control_srv_tpu_torch.models as tmodels
from access_control_srv_tpu_torch.ops import compile_policies, encode_requests
from access_control_srv_tpu_torch.ops import delta as tdelta
from access_control_srv_tpu_torch.ops import kernel as tkernel
from access_control_srv_tpu_torch.ops.carry import batch_from_numpy, tables_from_numpy
from access_control_srv_tpu_torch.ops.cuda_build import CSRC
from access_control_srv_tpu_torch.ops.kernel_ref import decide_dense_ref

from .test_fuzz_extended import _extended_requests, _extended_tree
from .test_kernel_differential import (
    _owner_bit_requests,
    _random_policy_tree,
    _scoped_role_tree,
)
from .test_torch_carryover import build_request, make_engines, request_spec, spec_grid
from .test_torch_delta import patched_compile
from .test_torch_evaluator import abort_doc
from .test_torch_kernel import (
    KERNEL_FIXTURES,
    acl_heavy_specs,
    combining_case,
    engines_from_doc,
    regex_reset_case,
)

SHIM = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __align__(x)
#define __launch_bounds__(...)
struct dim3 { unsigned x, y, z; };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim;
inline unsigned char* g_smem;
inline std::barrier<>* g_block;
inline std::vector<std::unique_ptr<std::barrier<>>> g_warps;
inline unsigned g_lanes[64][32];
inline unsigned long long g_lanes64[64][32];
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
inline unsigned shfl_xor(unsigned v, int o) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_lanes[w][l] = v;
  g_warps[w]->arrive_and_wait();
  const unsigned r = g_lanes[w][l ^ o];
  g_warps[w]->arrive_and_wait();
  return r;
}
inline unsigned long long shfl_xor64(unsigned long long v, int o) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_lanes64[w][l] = v;
  g_warps[w]->arrive_and_wait();
  const unsigned long long r = g_lanes64[w][l ^ o];
  g_warps[w]->arrive_and_wait();
  return r;
}
inline int __shfl_xor_sync(unsigned, int v, int o) { return (int)shfl_xor((unsigned)v, o); }
inline unsigned __shfl_xor_sync(unsigned, unsigned v, int o) { return shfl_xor(v, o); }
inline long long __shfl_xor_sync(unsigned, long long v, int o) {
  return (long long)shfl_xor64((unsigned long long)v, o);
}
inline unsigned long long __shfl_xor_sync(unsigned, unsigned long long v, int o) {
  return shfl_xor64(v, o);
}
// every lane of the warp takes part (as the kernels call it, with the full
// mask); bits outside `mask` read 0
inline unsigned __ballot_sync(unsigned mask, int pred) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_lanes[w][l] = pred != 0;
  g_warps[w]->arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= g_lanes[w][i] << i;
  g_warps[w]->arrive_and_wait();
  return r & mask;
}
// every lane of the warp arrives (as the kernels call it, unmasked);
// writes before it are visible to the warp's lanes after it
inline void __syncwarp(unsigned = 0xffffffffu) {
  g_warps[threadIdx.x / 32]->arrive_and_wait();
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz((unsigned)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline void __syncthreads() { g_block->arrive_and_wait(); }
inline int atomicMin(int* p, int v) {
  int o = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v < o && !__atomic_compare_exchange_n(p, &o, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {}
  return o;
}
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline unsigned atomicOr(unsigned* p, unsigned v) { return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST); }
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
inline int atomicMax(int* p, int v) {
  int o = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v > o && !__atomic_compare_exchange_n(p, &o, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {}
  return o;
}
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 232448; return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
// blocks of `threads` threads and `smem` bytes that fit the stand-in's SM
// (2,048 threads, 232,448 bytes of shared memory)
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int threads,
                                                          size_t smem) {
  int by_threads = 2048 / threads;
  int by_smem = smem ? (int)(232448 / smem) : by_threads;
  *n = std::min(by_threads, by_smem);
  return 0;
}
template <class K, class A>
void emulate_launch(K kernel, int grid, int threads, size_t smem, const A& a) {
  if (grid <= 0) return;
  std::vector<unsigned char> buf(smem + 16);
  blockDim = {(unsigned)threads, 1, 1};
  for (int b = 0; b < grid; ++b) {
    std::memset(buf.data(), 0xcd, buf.size());  // shared memory starts dirty
    g_smem = buf.data();
    std::barrier<> block(threads);
    g_block = &block;
    g_warps.clear();
    for (int w = 0; w < threads / 32; ++w)
      g_warps.emplace_back(new std::barrier<>(32));
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t, b] {
        threadIdx = {(unsigned)t, 0, 0};
        blockIdx = {(unsigned)b, 0, 0};
        kernel(a);
      });
    for (auto& th : ts) th.join();
  }
}
"""

# the port's rows-program block shape, before any test changes it
ROWS_STAGE = dict(tkernel.ROWS_STAGE)

LAUNCH = re.compile(r"kernel<<<(.+?), (.+?), (.+?), stream>>>\((\w+)\);")
SHARED = "extern __shared__ __align__(16) unsigned char smem[];"


def build_emulated(name: str, out_dir, src: str | None = None
                   ) -> ctypes.CDLL:
    """``csrc/<name>.cu`` (or the source text ``src``, with every
    ``csrc/*.cuh`` it may include) built with g++ against the threaded
    stand-in: the one launch line becomes an ``emulate_launch`` call, the
    dynamic shared memory a pointer into the emulator's per-block
    buffer."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA source as C++")
    if src is None:
        src = (CSRC / f"{name}.cu").read_text()
    assert len(LAUNCH.findall(src)) == 1 and src.count(SHARED) <= 1
    src = LAUNCH.sub(
        r"(void)stream; emulate_launch(kernel, \1, \2, \3, \4);", src
    ).replace(SHARED, "unsigned char* smem = g_smem;")
    (out_dir / "cuda_runtime.h").write_text(SHIM)
    for header in CSRC.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())
    (out_dir / f"{name}.cpp").write_text(src)
    lib_path = out_dir / f"lib{name}_emu.so"
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-I", str(out_dir),
         str(out_dir / f"{name}.cpp"), "-o", str(lib_path), "-lpthread"],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(lib_path))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel source built with g++ against the threaded stand-in."""
    lib = build_emulated("decide_dense",
                         tmp_path_factory.mktemp("decide_dense_emu"))
    lib.acs_decide_dense_layout.restype = ctypes.c_char_p
    lib.acs_decide_dense.restype = ctypes.c_int
    lib.acs_decide_dense.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.acs_decide_dense_smem.restype = ctypes.c_longlong
    lib.acs_decide_dense_smem.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.acs_decide_dense_occupancy.restype = ctypes.c_int
    lib.acs_decide_dense_occupancy.argtypes = [
        ctypes.c_void_p, ctypes.c_int] + [ctypes.c_int] * 5
    return lib


def set_rows_stage(monkeypatch, rows: int, threads: int = 64) -> None:
    """Blocks of ``rows`` request rows (wherever a batch has that many)
    and ``threads`` threads for the rows program on the stand-in."""
    monkeypatch.setitem(tkernel.ROWS_STAGE, "threads", threads)
    monkeypatch.setitem(tkernel.ROWS_STAGE, "rows", rows)
    monkeypatch.setattr(tkernel, "HOST_SM_COUNT", 1)


@pytest.fixture(autouse=True)
def rows_stage(monkeypatch):
    """Two warps and three rows per block: multi-row blocks, a block
    shape that does not divide the pow2 batches, and every per-warp loop
    strided."""
    set_rows_stage(monkeypatch, 3)


def run_emulated(lib, compiled, batch, explain=False):
    """(emulated kernel out, plain version out), int32 [3, bucket] (the
    explain variant: [4, bucket])."""
    c = tables_from_numpy(compiled.arrays, "cpu")
    _, r = batch_from_numpy(batch, "cpu", keys=tkernel.ROW_ARRAYS)
    with_acl = bool((batch.arrays["r_acl_ent"] >= 0).any())
    with_hr = tkernel.tree_needs_hr(compiled.arrays)
    with_rel = tkernel.tree_needs_rel(compiled.arrays)
    args = tkernel.pack_args(c, r, explain=explain, lib=lib)
    args.out.fill_(-7)
    code = lib.acs_decide_dense(
        ctypes.addressof(args.ptrs), len(args.ptrs),
        ctypes.addressof(args.dims), len(args.dims), int(with_acl),
        int(with_hr), int(with_rel), int(explain), args.threads, None,
    )
    assert code == 0
    want = torch.stack(decide_dense_ref(c, r, with_acl, with_hr, with_rel,
                                        explain=explain))
    return args.out, want


def port_batch(teng, specs):
    tc = compile_policies(teng.policy_sets, teng.urns)
    assert tc.supported, tc.unsupported_reason
    return tc, encode_requests([build_request(s, tmodels) for s in specs], tc)


def test_layout_matches_host(emulated):
    names = (tkernel.TABLE_ARRAYS + ("rule_orig_flat",) + tkernel.ROW_ARRAYS
             + tkernel.BATCH_ARRAYS + tkernel.OUTPUTS)
    assert names == tkernel.DENSE_PTRS and names[-1] == "out_explain"
    assert emulated.acs_decide_dense_layout().decode() == \
        ",".join(names) + ",|" + ",".join(tkernel.DIMS + tkernel.ROWS_DIMS) \
        + ","


def test_shared_memory_layout(emulated):
    """Per block: each row's staged fields, abort and winner slots, tile
    bitsets, set and policy bytes (4 per policy in explain mode, and the
    picked policy per set) and target bits, its role and action masks,
    the work list, the mask of the rows' roles, and the rule tile (three
    bitsets, 9 bytes a rule position); the ACL variant adds each row's
    eligibility and equality masks (8 bytes each)."""
    _, teng = make_engines("acl_policies.yml")
    tc, batch = port_batch(teng, spec_grid(n=16))
    c = tables_from_numpy(tc.arrays, "cpu")
    _, r = batch_from_numpy(batch, "cpu", keys=tkernel.ROW_ARRAYS)
    for explain in (False, True):
        args = tkernel.pack_args(c, r, explain=explain, lib=emulated)
        d = args.shape
        assert (d["RT"], d["PT"]) == (3, d["KP"])

        def smem(with_acl):
            return emulated.acs_decide_dense_smem(
                ctypes.addressof(args.dims), len(args.dims), with_acl,
                int(explain))

        def up(x, k=16):
            return -(-x // k) * k

        words = -(-(d["PT"] * d["KR"]) // 32) + 1
        sets = d["RT"] * d["S"]
        head = 8 * d["RT"] + 8 * d["RT"] * words + 4 + 4 * 2048
        head = up(head, 4) + 128 + 8 * d["RT"] + 4 * d["RT"] * (
            d["NROLE"] + 2 * d["NSUB"] + 2 * d["NACT"])
        head += (4 * sets + 4 * sets * d["KP"] if explain
                 else sets * d["KP"])
        head = up(head + d["RT"] + 2 * sets) + up(d["RT"] * d["T"])
        tile = 12 * words + 9 * d["PT"] * d["KR"]

        def total(acl):
            return up(up(head + acl) + tile)

        assert smem(0) == total(0)
        assert smem(1) == total(8 * d["RT"] * d["NACLE"]
                                * (d["NHRR"] + d["NACLI"]))


def test_argument_count_mismatch_is_refused(emulated):
    ptrs = (ctypes.c_int64 * 3)()
    dims = (ctypes.c_int32 * 3)()
    assert emulated.acs_decide_dense(
        ctypes.addressof(ptrs), 3, ctypes.addressof(dims), 3, 0, 0, 0, 0, 64,
        None) == -1
    # the explain variant without an explain output is refused
    _, teng = make_engines("basic_policies.yml")
    tc, batch = port_batch(teng, spec_grid(n=8))
    c = tables_from_numpy(tc.arrays, "cpu")
    _, r = batch_from_numpy(batch, "cpu", keys=tkernel.ROW_ARRAYS)
    args = tkernel.pack_args(c, r, lib=emulated)
    assert emulated.acs_decide_dense(
        ctypes.addressof(args.ptrs), len(args.ptrs),
        ctypes.addressof(args.dims), len(args.dims), 0, 0, 0, 1,
        args.threads, None) == -1
    # and the shape ints without the block shape
    assert emulated.acs_decide_dense(
        ctypes.addressof(args.ptrs), len(args.ptrs),
        ctypes.addressof(args.dims), len(args.dims) - 2, 0, 0, 0, 0,
        args.threads, None) == -1


@pytest.mark.parametrize("name", KERNEL_FIXTURES + ["seed_data"])
def test_fixture_trees(emulated, name):
    _, teng = make_engines(name)
    for acl in (True, False):
        specs = [s for s in spec_grid(n=40, seed=17)
                 if acl or not any((res.get("meta") or {}).get("acls")
                                   for res in s["context"]["resources"])]
        tc, batch = port_batch(teng, specs)
        got, want = run_emulated(emulated, tc, batch)
        assert torch.equal(got, want), (name, acl)


def test_randomized_trees(emulated):
    rng = random.Random(1234)
    for round_ in range(12):
        _, teng = engines_from_doc(_random_policy_tree(rng))
        tc = compile_policies(teng.policy_sets, teng.urns)
        if not tc.supported:
            continue
        tc, batch = port_batch(teng, spec_grid(n=24, seed=1000 + round_))
        got, want = run_emulated(emulated, tc, batch)
        assert torch.equal(got, want), round_


def test_acl_heavy(emulated):
    _, teng = make_engines("acl_policies.yml")
    tc, batch = port_batch(teng, acl_heavy_specs(random.Random(17), 96))
    got, want = run_emulated(emulated, tc, batch)
    assert torch.equal(got, want)


def test_combining_algorithms(emulated):
    doc, specs = combining_case()
    _, teng = engines_from_doc(doc)
    tc, batch = port_batch(teng, specs)
    got, want = run_emulated(emulated, tc, batch)
    assert torch.equal(got, want)


def test_regex_prefix_reset(emulated):
    doc, specs = regex_reset_case()
    _, teng = engines_from_doc(doc)
    tc, batch = port_batch(teng, specs)
    got, want = run_emulated(emulated, tc, batch)
    assert torch.equal(got, want)
    assert got[0, :len(specs)].tolist() == [1, 0, 1, 1, 0, 1]


def test_foreign_namespace_trees(emulated):
    rng = random.Random(9000)
    for round_ in range(4):
        _, teng = engines_from_doc(_extended_tree(rng))
        specs = [request_spec(r) for r in _extended_requests(rng, 32)]
        tc = compile_policies(teng.policy_sets, teng.urns)
        if not tc.supported:
            continue
        tc, batch = port_batch(teng, specs)
        got, want = run_emulated(emulated, tc, batch)
        assert torch.equal(got, want), round_


@pytest.mark.parametrize("n_roles", [3, 9, 17])
def test_owner_bitplane_boundaries(emulated, n_roles):
    _, teng = engines_from_doc(_scoped_role_tree(n_roles))
    rng = random.Random(4000 + n_roles)
    specs = [request_spec(r) for r in _owner_bit_requests(rng, 24)]
    tc, batch = port_batch(teng, specs)
    got, want = run_emulated(emulated, tc, batch)
    assert torch.equal(got, want)


def test_scoped_511_tree(emulated):
    """The main path's tree: 511 target rows, one policy of 511 rules (a
    16-word window read by one thread per row)."""
    _, teng = make_engines("scoped_511")
    tc, batch = port_batch(teng, spec_grid(n=12, seed=23))
    assert tc.KR == 511
    got, want = run_emulated(emulated, tc, batch)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,n", [("scoped_511", 12),
                                    ("role_scopes.yml", 32),
                                    ("acl_policies.yml", 32)])
def test_patched_bucketed_tables(emulated, name, n):
    """Tables from ``full_bucketed_compile`` and one ``apply_events``
    patch (pad target rows, pad set / policy / rule slots, the sentinel
    entity-vocab rows; at scoped_511 KR 1,024 for 511 live rules): the
    kernel equals the plain version, whose decisions equal the plain
    version's on a fresh unpadded compile of the edited tree."""
    _, teng = make_engines(name)
    patched, _ = patched_compile(teng, tdelta, seed=3)
    assert not patched.arrays["rule_valid"].all()  # pad rule slots
    specs = spec_grid(n=n, seed=29)
    batch = encode_requests([build_request(s, tmodels) for s in specs],
                            patched)
    got, want = run_emulated(emulated, patched, batch)
    assert torch.equal(got, want)
    fresh, fbatch = port_batch(teng, specs)
    _, plain = run_emulated(emulated, fresh, fbatch)
    assert torch.equal(want[:3, :n], plain[:3, :n])


def test_condition_aborts(emulated):
    """Condition columns ([C, B]) and the flat-order abort: status and
    cacheable come from the aborting rule."""
    _, teng = engines_from_doc(abort_doc())
    tc, batch = port_batch(teng, spec_grid(n=48, seed=29))
    assert batch.cond_abort.any()
    got, want = run_emulated(emulated, tc, batch)
    assert torch.equal(got, want)
    assert (got[2] != 200).any()


def relation_batch(teng, specs, case="store", value_ops=None):
    """A port-compiled relation tree and a batch packed from a port tuple
    store's tables (``case`` "no_store": fail-closed empty tables;
    "skip_bits": the 1-wide dummy planes)."""
    from .test_torch_relations import VARIANT_OPS, both_stores

    tc = compile_policies(teng.policy_sets, teng.urns)
    assert tkernel.tree_needs_rel(tc.arrays)
    store = both_stores(*(value_ops or VARIANT_OPS))[1]
    tables = None if case == "no_store" else store.tables_for(tc)
    batch = encode_requests([build_request(s, tmodels) for s in specs], tc,
                            relation_tables=tables,
                            skip_relation_bits=case == "skip_bits")
    return tc, batch


@pytest.mark.parametrize("case", ["store", "no_store", "skip_bits", "acl"])
def test_relation_fixture(emulated, case):
    """The with_rel variants (and with ACL pairs, with_acl + with_rel) on
    the relation fixture: closure planes, fail-closed planes and dummy
    planes."""
    from .test_torch_relations import ORG, VARIANT_SPECS, rel_specs

    _, teng = make_engines("relation_policies.yml")
    specs = list(VARIANT_SPECS)
    if case == "acl":
        specs += rel_specs(["alice", "bob"], ["doc1", "doc3"],
                           acl_indicatory_entity=ORG, acl_instances=["Org1"])
    tc, batch = relation_batch(teng, specs, case)
    got, want = run_emulated(emulated, tc, batch)
    assert torch.equal(got, want)
    assert (got[0, :len(specs)] == 1).any() == (case in ("store", "acl",
                                                         "skip_bits"))


def test_relation_depth_chain(emulated, tmp_path):
    """The rebac-serve path shape, viewer|parent.parent.owner, over a
    folder chain, with a multi-resource row (two collected runs)."""
    from .test_torch_relations import FOLDER, NS, rel_engines, rel_specs

    _, teng = rel_engines(tmp_path, "viewer|parent.parent.owner")
    ops = (("create", [
        (NS, "doc1", "parent", {"object": {"entity": FOLDER, "id": "f0"}}),
        (FOLDER, "f0", "parent", {"object": {"entity": FOLDER, "id": "f1"}}),
        (FOLDER, "f1", "owner", "alice"),
        (NS, "doc2", "viewer", "bob"),
    ]),)
    specs = rel_specs(["alice", "bob", "eve"],
                      ["doc1", "doc2", ["doc1", "doc2"]])
    tc, batch = relation_batch(teng, specs, value_ops=ops)
    got, want = run_emulated(emulated, tc, batch)
    assert torch.equal(got, want)
    assert got[0, :len(specs)].tolist() == [1, 2, 2, 2, 1, 2, 2, 2, 2]


@pytest.mark.parametrize("scoped", [False, True])
def test_relation_stress_tree(emulated, scoped):
    """The 550-rule relation tree of test_torch_relations, densely: 550
    target rows over 256-thread blocks, HR and relation folds stacked
    when scoped."""
    from .test_torch_relations import (
        rel_stress_doc,
        rel_stress_specs,
        stress_stores,
    )

    doc, entities, actions = rel_stress_doc(scoped)
    _, teng = engines_from_doc(doc)
    tc = compile_policies(teng.policy_sets, teng.urns)
    tables = stress_stores(entities)[1].tables_for(tc)
    specs = rel_stress_specs(entities, actions, 12, 5, scoped)
    batch = encode_requests([build_request(s, tmodels) for s in specs], tc,
                            relation_tables=tables)
    assert tkernel.tree_needs_hr(tc.arrays) == scoped
    got, want = run_emulated(emulated, tc, batch)
    assert torch.equal(got, want)


# ------------------------------------------------- block shapes, windows

DO3 = "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:deny-overrides"
PO3 = "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:permit-overrides"
FA3 = "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:first-applicable"


def window_doc(n_policies: int, kr: int) -> dict:
    """``n_policies`` policies of ``kr`` rules over two sets (deny-overrides,
    first-applicable), the policies' algorithms cycling deny-overrides /
    permit-overrides / first-applicable: each policy's rules are a window
    of ``kr`` bits in the flat rule order, across 32-bit words unless
    ``kr`` divides 32.  Rules over 4 roles, 3 entities and 4 actions
    (every third one DENY; the role-1 rules on the first entity with a
    condition that aborts for requests without a subject id), so most
    policies of a request collect a few rules."""
    import chip_smoke

    cas = [DO3, PO3, FA3]
    sets = [[], []]
    rid = 0
    for p in range(n_policies):
        rules = []
        for _ in range(kr):
            rule = {
                "id": f"r{rid}",
                "target": {
                    "subjects": [{"id": chip_smoke.URNS["role"],
                                  "value": f"role-{rid % 4}"}],
                    "resources": [{"id": chip_smoke.URNS["entity"],
                                   "value": chip_smoke.STRESS_ENTITIES[
                                       (rid // 4) % 3]}],
                    "actions": [{"id": chip_smoke.URNS["actionID"],
                                 "value": chip_smoke.ACTIONS[
                                     (rid // 12) % 4]}],
                },
                "effect": "PERMIT" if rid % 3 else "DENY",
                "evaluation_cacheable": bool(rid % 2),
            }
            if rid % 4 == 1 and (rid // 4) % 3 == 0:
                rule["condition"] = "context.subject.id.startswith('u')"
            rules.append(rule)
            rid += 1
        sets[p % 2].append({"id": f"p{p}", "combining_algorithm": cas[p % 3],
                            "rules": rules})
    return {"policy_sets": [
        {"id": f"s{k}", "combining_algorithm": (DO3, FA3)[k],
         "policies": pols} for k, pols in enumerate(sets) if pols]}


def window_specs(seed: int, n: int) -> list:
    """``n`` request specs over the roles, entities and actions of
    ``window_doc`` (one role in five and one entity in four outside it),
    every fourth with ACL instances, every third without a subject id (and
    every sixth of those role-1 on the first entity: they abort)."""
    import chip_smoke

    rng = random.Random(seed)
    out = []
    for i in range(n):
        kw = {}
        if i % 4 == 1:
            kw = dict(acl_indicatory_entity=chip_smoke.ORG,
                      acl_instances=rng.sample(chip_smoke.OWNERS,
                                               rng.randint(1, 3)))
        role, ent = rng.randrange(5), rng.randrange(4)
        if i % 6 == 0:
            role, ent = 1, 0
        req = chip_smoke.build_request(
            subject_id=rng.choice(["u1", "ada"]),
            subject_role=f"role-{role}",
            role_scoping_entity=chip_smoke.ORG,
            role_scoping_instance=rng.choice(chip_smoke.OWNERS),
            resource_type=chip_smoke.STRESS_ENTITIES[ent],
            resource_id="id-0",
            action_type=chip_smoke.ACTIONS[rng.randrange(4)],
            owner_indicatory_entity=chip_smoke.ORG,
            owner_instance=rng.choice(chip_smoke.OWNERS), **kw)
        if i % 3 == 0:
            req.context["subject"].pop("id", None)
        out.append(request_spec(req))
    return out


def window_batch(n_policies: int, kr: int, n: int, seed: int):
    """(port compile, batch) of ``window_doc`` with ``window_specs``."""
    _, teng = engines_from_doc(window_doc(n_policies, kr))
    return port_batch(teng, window_specs(seed, n))


@pytest.mark.parametrize("kr", [5, 33, 511])
def test_rule_windows(emulated, kr):
    """Several policies of KR 5, 33 and 511 rules in two sets: every
    policy's first selected, last collected and first aborting rule read
    from its window of the row's bitsets, windows crossing words, explain
    off and on; ACL and non-ACL rows in the same blocks."""
    n_policies = {5: 9, 33: 5, 511: 2}[kr]
    tc, batch = window_batch(n_policies, kr, 24, seed=kr)
    assert (tc.KR, tc.S) == (kr, 2)
    inst = (batch.arrays["r_acl_inst"] >= 0).reshape(batch.B, -1).any(1)
    assert 0 < inst[:24].sum() < 24
    for explain in (False, True):
        got, want = run_emulated(emulated, tc, batch, explain=explain)
        assert torch.equal(got, want), explain
    assert set(want[0, :24].tolist()) >= {1, 2}
    assert (want[2, :24] != 200).any()
    if explain:
        assert {1, 3} <= set((want[3, :24] & 3).tolist())


@pytest.mark.parametrize("rt", [1, 2, 5, 16])
def test_rows_per_block(emulated, monkeypatch, rt):
    """Blocks of 1, 2, 5 (not a divisor of the 32-row batch: a short last
    block) and 16 rows, 64 threads (fewer warps than rows) and 256:
    every row's outputs its own, explain off and on."""
    tc, batch = window_batch(5, 33, 30, seed=rt)
    for threads in (64, 256):
        set_rows_stage(monkeypatch, rt, threads)
        for explain in (False, True):
            got, want = run_emulated(emulated, tc, batch, explain=explain)
            assert torch.equal(got, want), (threads, explain)
    c = tables_from_numpy(tc.arrays, "cpu")
    _, r = batch_from_numpy(batch, "cpu", keys=tkernel.ROW_ARRAYS)
    shape = tkernel.pack_args(c, r, lib=emulated).shape
    assert shape["RT"] == rt and (shape["B"] % rt != 0) == (rt == 5)


def test_work_list_overflow(emulated, monkeypatch):
    """A tree whose rules target resources only (no subject, no action):
    every (row, target) pair of a 16-row block needs the fold, more pairs
    than the work list holds, so the pairs past it fold where they are
    found; explain off and on."""
    import chip_smoke

    set_rows_stage(monkeypatch, 16)
    policies = [{"id": f"p{p}", "combining_algorithm": (DO3, PO3, FA3)[p],
                 "rules": [{"id": f"r{p}_{q}", "target": {"resources": [
                     {"id": chip_smoke.URNS["entity"],
                      "value": chip_smoke.STRESS_ENTITIES[q % 3]}]},
                            "effect": "PERMIT" if q % 3 else "DENY"}
                           for q in range(60)]}
                for p in range(3)]
    _, teng = engines_from_doc({"policy_sets": [
        {"id": "s0", "combining_algorithm": DO3, "policies": policies}]})
    tc, batch = port_batch(teng, window_specs(3, 32))
    assert tc.T * 16 > 2048
    for explain in (False, True):
        got, want = run_emulated(emulated, tc, batch, explain=explain)
        assert torch.equal(got, want), explain
    assert set(want[0, :32].tolist()) >= {1, 2}


def test_rows_follow_the_batch(emulated, monkeypatch):
    """``rows_tiles`` at the port's block shape: one row per block until
    the batch gives every SM ``blocks_per_sm`` blocks, then more rows per
    block up to ``rows``, and no more than the block's shared bytes (the
    library's own ``acs_decide_dense_smem``, ACL variant) allow."""
    monkeypatch.setattr(tkernel, "ROWS_STAGE", dict(ROWS_STAGE))
    st = tkernel.ROWS_STAGE
    _, teng = make_engines("acl_policies.yml")
    tc, batch = port_batch(teng, spec_grid(n=16))
    c = tables_from_numpy(tc.arrays, "cpu")
    _, r = batch_from_numpy(batch, "cpu", keys=tkernel.ROW_ARRAYS)
    base = {**tkernel._dims(c, r), "T": 511, "S": 1, "KP": 1, "KR": 511,
            "NROLE": 4, "NSUB": 2, "NACT": 2, "NACLE": 4, "NACLI": 8,
            "NHRR": 8}

    def tile(d):
        return tkernel.rows_tiles(emulated, d, False, 132)

    def smem(d, rt, pt):
        vals = [d[k] for k in tkernel.DIMS] + [rt, pt]
        return emulated.acs_decide_dense_smem(
            (ctypes.c_int32 * len(vals))(*vals), len(vals), 1, 0)

    fill = st["blocks_per_sm"] * 132
    tiles = {B: tile({**base, "B": B})["RT"]
             for B in (8, 512, fill, fill + 1, 4096, 1 << 16)}
    assert tiles == {8: 1, 512: 2, fill: 1, fill + 1: 2, 4096: 16,
                     1 << 16: st["rows"]}
    # K8's stress shard: 8,001 live target rows, 20 policies of 400 rules
    shard = {**base, "B": 2048, "T": 8001, "KP": 20, "KR": 400}
    got = tile(shard)
    assert got["PT"] == st["rules"] // (9 * 400) == 4
    assert got["RT"] == 8
    assert smem(shard, 8, 4) <= st["block_bytes"]
    # a wider table: as many rows as the block's bytes hold
    wide = {**shard, "T": 20000}
    got = tile(wide)
    assert 1 < got["RT"] < 8
    assert smem(wide, got["RT"], 4) <= st["block_bytes"] \
        < smem(wide, got["RT"] + 1, 4)
    # cached: the same shapes give the same tile without a second call
    assert tile(wide) is got


# ------------------------------------------------------------- explain


def edge_trees():
    """(label, compile, batch) of the explain recovery's edge paths: the
    edge and combining trees of ``test_torch_explain`` with unknown
    combining algorithms at either level, and the condition-abort tree."""
    from .test_torch_explain import edge_case, edited

    out = []
    for label, (doc, specs) in (("edge", edge_case()),
                                ("combining", combining_case())):
        _, teng = engines_from_doc(doc)
        tc, batch = port_batch(teng, specs)
        for edit in ("none", "set", "policy"):
            out.append((f"{label}/{edit}",
                        edited(tc, set_ca=edit == "set",
                               pol_ca=edit == "policy"), batch))
    _, teng = engines_from_doc(abort_doc())
    out.append(("aborts", *port_batch(teng, spec_grid(n=24, seed=29))))
    return out


@pytest.mark.parametrize("name", ["role_scopes.yml", "conditions.yml",
                                  "acl_policies.yml", "policy_targets.yml",
                                  "props_multi_rules_entities.yml"])
def test_explain_fixture_trees(emulated, name):
    """The explain variant (four outputs) equals the plain version's on
    fixture trees, with and without ACL pairs."""
    _, teng = make_engines(name)
    for acl in (True, False):
        specs = [s for s in spec_grid(n=32, seed=19)
                 if acl or not any((res.get("meta") or {}).get("acls")
                                   for res in s["context"]["resources"])]
        tc, batch = port_batch(teng, specs)
        got, want = run_emulated(emulated, tc, batch, explain=True)
        assert got.shape[0] == 4
        assert torch.equal(got, want), (name, acl)


def test_explain_edge_paths(emulated):
    """Raw codes where the recovery clips: a winning set whose selected
    policy did not contribute, unknown algorithms selecting slot 0,
    no-rules policies and condition aborts."""
    kinds = set()
    for label, tc, batch in edge_trees():
        got, want = run_emulated(emulated, tc, batch, explain=True)
        assert torch.equal(got, want), label
        kinds |= set((got[3] & 3).tolist())
    assert kinds == {0, 1, 2, 3}


# ------------------------------------------------- the stand-in itself

PROBE = r"""
#include <cstdint>
#include <cuda_runtime.h>

struct ProbeArgs { int32_t* out; };
#define PROBE_INTS 12

// PROBE_INTS ints per thread: ballot (full mask, partial mask), a 64-bit
// xor shuffle (high, low word), __ffs, __clz, after __syncwarp the value
// the next lane of the warp wrote, a shared atomicAdd's total and
// returned ticket, a shared atomicOr's result, the word a uint4 store of
// make_uint4 left at the thread's index, and __popc
__global__ void __launch_bounds__(64, 1) probe_kernel(const ProbeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  int32_t* o = a.out + tid * PROBE_INTS;
  o[0] = (int)__ballot_sync(0xffffffffu, lane % 3 == 0);
  o[1] = (int)__ballot_sync(0x0000ffffu, 1);
  const long long v = ((long long)lane << 40) | (0x1000 + lane);
  const long long w = __shfl_xor_sync(0xffffffffu, v, 5);
  o[2] = (int)(w >> 40);
  o[3] = (int)(w & 0xffffffff);
  o[4] = __ffs(lane << 3);
  o[5] = __clz(lane);
  int32_t* sh = reinterpret_cast<int32_t*>(smem);
  sh[tid] = 7 * tid;
  __syncwarp();
  o[6] = sh[(tid & ~31) + ((lane + 1) & 31)];
  int32_t* counter = sh + 100;
  if (tid == 0) *counter = 0;
  __syncthreads();
  const int ticket = atomicAdd(counter, tid % 3);
  uint32_t* bits = reinterpret_cast<uint32_t*>(sh + 104);
  if (tid < 2) bits[tid] = 0;
  __syncthreads();
  o[7] = *counter;
  o[8] = ticket;
  atomicOr(&bits[tid & 1], 1u << (tid >> 1));
  uint4* quads = reinterpret_cast<uint4*>(sh + 112);
  quads[tid] = make_uint4(tid, tid + 1, tid + 2, tid + 3);
  __syncthreads();
  o[9] = (int)bits[tid & 1];
  o[10] = reinterpret_cast<int32_t*>(quads)[tid];
  o[11] = __popc((unsigned)tid * 0x9e3779b9u);
}

extern "C" int run_probe(int32_t* out, int* occupancy) {
  ProbeArgs args{out};
  cudaStream_t stream = nullptr;
  auto kernel = probe_kernel;
  kernel<<<1, 64, 4096, stream>>>(args);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel, 256,
                                                65536);
  return (int)cudaGetLastError();
}
"""


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    """The probe kernel through the stand-in -> (out [64, PROBE_INTS],
    occupancy)."""
    lib = build_emulated("probe", tmp_path_factory.mktemp("probe_emu"),
                         src=PROBE)
    out = torch.zeros((64, 12), dtype=torch.int32)
    occ = ctypes.c_int(0)
    lib.run_probe.restype = ctypes.c_int
    assert lib.run_probe(ctypes.c_void_p(out.data_ptr()),
                         ctypes.byref(occ)) == 0
    return out, occ.value


def _signed(x: int) -> int:
    return x - (1 << 32) if x >= 1 << 31 else x


def test_standin_ballot(probe):
    """__ballot_sync: bit l set where lane l's predicate holds; bits
    outside the mask read 0."""
    out = probe[0]
    want = sum(1 << lane for lane in range(0, 32, 3))
    assert out[:, 0].tolist() == [_signed(want)] * 64
    assert out[:, 1].tolist() == [0xFFFF] * 64


def test_standin_shfl_xor_64(probe):
    """The 64-bit __shfl_xor_sync reads lane ``l ^ o``'s whole value."""
    out = probe[0]
    lanes = [t % 32 for t in range(64)]
    assert out[:, 2].tolist() == [lane ^ 5 for lane in lanes]
    assert out[:, 3].tolist() == [0x1000 + (lane ^ 5) for lane in lanes]


def test_standin_ffs_clz(probe):
    """__ffs: 1-based lowest set bit, 0 for 0; __clz: leading zeros, 32
    for 0."""
    out = probe[0]
    for t in range(64):
        lane = t % 32
        x = lane << 3
        assert out[t, 4] == ((x & -x).bit_length() if x else 0)
        assert out[t, 5] == 32 - lane.bit_length()


def test_standin_syncwarp(probe):
    """__syncwarp: a lane's shared-memory write before it is read by the
    warp's other lanes after it."""
    out = probe[0]
    want = [7 * ((t & ~31) + ((t % 32 + 1) % 32)) for t in range(64)]
    assert out[:, 6].tolist() == want


def test_standin_atomic_add(probe):
    """atomicAdd on shared memory: the old value back, every thread's
    addend in the total, distinct tickets where the addend is not 0."""
    out = probe[0]
    adds = [t % 3 for t in range(64)]
    assert out[:, 7].tolist() == [sum(adds)] * 64
    tickets = [int(v) for v, a in zip(out[:, 8].tolist(), adds) if a]
    assert len(set(tickets)) == len(tickets)
    assert all(0 <= v <= sum(adds) - 1 for v in tickets)


def test_standin_atomic_or(probe):
    """atomicOr on shared memory: every thread's bit in the word."""
    out = probe[0]
    assert out[:, 9].tolist() == [-1] * 64


def test_standin_uint4(probe):
    """``uint4`` stores of ``make_uint4``: four words each, in order."""
    out = probe[0]
    assert out[:, 10].tolist() == [t // 4 + t % 4 for t in range(64)]


def test_standin_popc(probe):
    """__popc: the set bits of a 32-bit word."""
    out = probe[0]
    assert out[:, 11].tolist() == [
        bin(t * 0x9E3779B9 & 0xFFFFFFFF).count("1") for t in range(64)]


def test_standin_occupancy(probe):
    """The occupancy stub: blocks of 256 threads and 64 KB that fit the
    stand-in's SM (2,048 threads, 232,448 bytes)."""
    assert probe[1] == min(2048 // 256, 232448 // 65536)
