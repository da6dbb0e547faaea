"""The CUDA source of the dense decision kernel, run on the CPU.

The test suite runs without nvcc or a card, so ``ops/csrc/decide_dense.cu``
is compiled as C++ with g++ against a small stand-in for ``cuda_runtime.h``
that runs each thread block with one ``std::thread`` per CUDA thread
(``std::barrier`` for ``__syncthreads`` and for the warp shuffles, real
atomics for ``atomicMin``/``atomicMax``).  The launch arguments are packed
by the port's own ``pack_args``, and the outputs must equal the plain
PyTorch version exactly.  This checks the kernel's logic and its argument
layout; that nvcc accepts it for ``sm_90a`` and the timing are checked on
the card by ``chip_smoke.py``.
"""

import ctypes
import random
import shutil
import subprocess

import pytest
import torch

import access_control_srv_tpu_torch.models as tmodels
from access_control_srv_tpu_torch.ops import compile_policies, encode_requests
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
struct dim3 { unsigned x, y, z; };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim;
inline unsigned char* g_smem;
inline std::barrier<>* g_block;
inline std::vector<std::unique_ptr<std::barrier<>>> g_warps;
inline unsigned g_lanes[64][32];
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
inline int __shfl_xor_sync(unsigned, int v, int o) { return (int)shfl_xor((unsigned)v, o); }
inline unsigned __shfl_xor_sync(unsigned, unsigned v, int o) { return shfl_xor(v, o); }
inline void __syncthreads() { g_block->arrive_and_wait(); }
inline int atomicMin(int* p, int v) {
  int o = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v < o && !__atomic_compare_exchange_n(p, &o, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {}
  return o;
}
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
template <class K, class A>
void emulate_launch(K kernel, int grid, int threads, size_t smem, const A& a) {
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

LAUNCH = "kernel<<<a.B, threads, smem, stream>>>(a);"
SHARED = "extern __shared__ __align__(16) unsigned char smem[];"


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel source built with g++ against the threaded stand-in."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA source as C++")
    src = (CSRC / "decide_dense.cu").read_text()
    assert src.count(LAUNCH) == 1 and src.count(SHARED) == 1
    src = src.replace(
        LAUNCH, "(void)stream; emulate_launch(kernel, a.B, threads, smem, a);"
    ).replace(SHARED, "unsigned char* smem = g_smem;")
    d = tmp_path_factory.mktemp("decide_dense_emu")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "decide_dense.cpp").write_text(src)
    lib_path = d / "libdecide_dense_emu.so"
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-I", str(d),
         str(d / "decide_dense.cpp"), "-o", str(lib_path), "-lpthread"],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(lib_path))
    lib.acs_decide_dense_layout.restype = ctypes.c_char_p
    lib.acs_decide_dense.restype = ctypes.c_int
    lib.acs_decide_dense.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.acs_decide_dense_smem.restype = ctypes.c_longlong
    lib.acs_decide_dense_smem.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    return lib


def run_emulated(lib, compiled, batch):
    """(emulated kernel out, plain version out), int32 [3, bucket]."""
    c = tables_from_numpy(compiled.arrays, "cpu")
    _, r = batch_from_numpy(batch, "cpu", keys=tkernel.ROW_ARRAYS)
    with_acl = bool((batch.arrays["r_acl_ent"] >= 0).any())
    with_hr = tkernel.tree_needs_hr(compiled.arrays)
    args = tkernel.pack_args(c, r)
    args.out.fill_(-7)
    code = lib.acs_decide_dense(
        ctypes.addressof(args.ptrs), len(args.ptrs),
        ctypes.addressof(args.dims), len(args.dims), int(with_acl),
        int(with_hr), args.threads, None,
    )
    assert code == 0
    want = torch.stack(decide_dense_ref(c, r, with_acl, with_hr))
    return args.out, want


def port_batch(teng, specs):
    tc = compile_policies(teng.policy_sets, teng.urns)
    assert tc.supported, tc.unsupported_reason
    return tc, encode_requests([build_request(s, tmodels) for s in specs], tc)


def test_layout_matches_host(emulated):
    names = (tkernel.TABLE_ARRAYS + tkernel.ROW_ARRAYS
             + tkernel.BATCH_ARRAYS + tkernel.OUTPUTS)
    assert emulated.acs_decide_dense_layout().decode() == \
        ",".join(names) + ",|" + ",".join(tkernel.DIMS) + ","


def test_shared_memory_layout(emulated):
    """The ACL variant adds the per-row eligibility and equality masks
    (8 bytes each) to the per-target, per-set and per-policy bytes."""
    _, teng = make_engines("acl_policies.yml")
    tc, batch = port_batch(teng, spec_grid(n=16))
    c = tables_from_numpy(tc.arrays, "cpu")
    _, r = batch_from_numpy(batch, "cpu", keys=tkernel.ROW_ARRAYS)
    args = tkernel.pack_args(c, r)
    d = args.shape

    def smem(with_acl):
        return emulated.acs_decide_dense_smem(
            ctypes.addressof(args.dims), len(args.dims), with_acl)

    base = 8 + d["T"] + 2 * d["S"] + d["S"] * d["KP"]
    assert smem(0) == -(-base // 16) * 16
    acl = 8 * d["NACLE"] * (d["NHRR"] + d["NACLI"])
    assert smem(1) == -(-(base + acl) // 16) * 16


def test_argument_count_mismatch_is_refused(emulated):
    ptrs = (ctypes.c_int64 * 3)()
    dims = (ctypes.c_int32 * 3)()
    assert emulated.acs_decide_dense(
        ctypes.addressof(ptrs), 3, ctypes.addressof(dims), 3, 0, 0, 64, None
    ) == -1


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
    """The main path's tree: 511 target rows over 256-thread blocks, one
    policy of 511 rules (lanes stride over the rule axis)."""
    _, teng = make_engines("scoped_511")
    tc, batch = port_batch(teng, spec_grid(n=12, seed=23))
    assert tc.KR == 511
    got, want = run_emulated(emulated, tc, batch)
    assert torch.equal(got, want)


def test_condition_aborts(emulated):
    """Condition columns ([C, B]) and the flat-order abort: status and
    cacheable come from the aborting rule."""
    _, teng = engines_from_doc(abort_doc())
    tc, batch = port_batch(teng, spec_grid(n=48, seed=29))
    assert batch.cond_abort.any()
    got, want = run_emulated(emulated, tc, batch)
    assert torch.equal(got, want)
    assert (got[2] != 200).any()
