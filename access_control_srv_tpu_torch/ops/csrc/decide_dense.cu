// Dense batched isAllowed decision kernel for Hopper (sm_90a).
//
// Replaces the JAX package's dense decision program: the vmapped
// ops/kernel.py _evaluate_one under DecisionKernel.make_run.run (stages A-G:
// target matching, HR owner bitplanes, the relation-path fold (with_rel,
// ops/kernel.py:680-690), verifyACL, rule predicates, policy gates,
// combining algorithms, last-set-wins and flat-order condition aborts).
// Host side: access_control_srv_tpu_torch/ops/kernel.py (decide_dense); the
// plain PyTorch version it is held against: ops/kernel_ref.py.
//
// What bounds it: integer and boolean work over small padded int32 tables,
// no products at all, so bytes.  Each request row is read once (~0.7 KB of
// int32/uint8 arrays at the floor caps) and three int32 are written; the
// policy tables are shared by every row and stay in L1/L2.
//
// Design: one thread block per request row (the program itself is
// decide_row in decide_core.cuh, shared with decide_grouped.cu).
//   Stage A-C: threads stride over the T target rows; each thread runs the
//     whole per-target computation (subject/action/entity/property matching,
//     the sticky entity-run scans, the owner-bitplane HR check, the
//     relation-path check on the closure bitplanes (the same packed layout,
//     read through the same function) and the verifyACL create-path scan,
//     each kept sequential inside its thread) and writes six match bits per
//     target row into shared memory.
//   Stage D: one warp per policy set: carried policyEffect, exact-match break,
//     multi-entity recheck, set gate (warp-shuffle min/max/or).
//   Stage E: one warp per policy: lanes stride over the rules, positional
//     first-DENY / first-PERMIT / first / last selection by warp shuffles,
//     the flat-order abort position by atomicMin on a shared int.
//   Stage F-G: one warp per set over its policies, last-set-wins by
//     atomicMax on a shared int, then thread 0 assembles the three outputs.
// Per-row verifyACL pieces that do not depend on the target row (instance
// eligibility per HR role, instance value equality) are built once per block
// into shared memory before stage A.
//
// Explain mode (decide_core.cuh row_program): after stage F warp 0
// re-derives the winning set's policy and re-scans that policy's rules, and
// thread 0 writes the provenance code as a fourth output (the JAX
// program's explain recovery, ops/kernel.py:1165-1185).
//
// The policy tables and request arrays are kernel arguments (one struct of
// device pointers plus the shape ints); with_acl / with_hr / with_rel /
// explain are template parameters (16 variants).  Bools arrive as uint8.  The relation
// planes' width (NRU_REL) comes from their shapes, so the 1-wide dummy
// planes of a batch encoded without relation bits are read as they are.  The kernel allocates nothing.

#include "decide_core.cuh"

template <bool WITH_ACL, bool WITH_HR, bool WITH_REL, bool EXPLAIN>
__global__ void decide_dense_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  decide_row<WITH_ACL, WITH_HR, WITH_REL, EXPLAIN>(a, blockIdx.x, smem);
}

// one launch of the variant (with_acl, with_hr, with_rel, explain)
template <bool... F>
struct DenseLaunch {
  static int run(const Args& a, size_t smem, int threads,
                 cudaStream_t stream) {
    auto kernel = decide_dense_kernel<F...>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<a.B, threads, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
};

extern "C" {

// "ptr,ptr,...|dim,dim,..." : the argument order, checked by the host
const char* acs_decide_dense_layout() {
  return ACS_PTRS(ACS_NAME) "|" ACS_DIMS(ACS_DIM_NAME);
}

// dynamic shared memory bytes a launch needs (-1 on an argument mismatch)
long long acs_decide_dense_smem(const int32_t* dims, int n_dims, int with_acl) {
  Args a = {};
  if (!fill_dims(&a, dims, n_dims)) return -1;
  return (long long)smem_layout(a, with_acl != 0).total;
}

// launches the kernel on `stream`; returns cudaGetLastError() after the
// launch, or -1 when the argument counts do not match this build or the
// explain variant has no output to write
int acs_decide_dense(const int64_t* ptrs, int n_ptrs, const int32_t* dims,
                     int n_dims, int with_acl, int with_hr, int with_rel,
                     int explain, int threads, void* stream) {
  Args a;
  if (!fill_args(&a, ptrs, n_ptrs, dims, n_dims)) return -1;
  if (explain && a.out_explain == nullptr) return -1;
  if (a.B == 0) return 0;
  const size_t smem = smem_layout(a, with_acl != 0).total;
  const bool flags[4] = {with_acl != 0, with_hr != 0, with_rel != 0,
                         explain != 0};
  return dispatch_flags<4, DenseLaunch>(
      flags, a, smem, threads, reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
