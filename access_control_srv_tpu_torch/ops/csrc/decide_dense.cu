// Dense batched isAllowed decision kernel for Hopper (sm_90a).
//
// Replaces the JAX package's dense decision program: the vmapped
// ops/kernel.py _evaluate_one under DecisionKernel.make_run.run (stages A-G:
// target matching, HR owner bitplanes, the relation-path fold (with_rel,
// ops/kernel.py:680-690), verifyACL, rule predicates, policy gates,
// combining algorithms, last-set-wins and flat-order condition aborts), and
// per rank parallel/mesh.py ShardedDecisionKernel (K6).  Host side:
// access_control_srv_tpu_torch/ops/kernel.py (decide_dense); the plain
// PyTorch version it is held against: ops/kernel_ref.py.
//
// What bounds it: integer compares over small padded int32 tables, no
// products at all.  Every request row meets every target row and every rule
// position of the one table, so at the main path's shapes (511 rules, 4,096
// rows) the compares outweigh the bytes (each row ~0.7 KB in, three int32
// out; the tables stay in L1/L2).
//
// Design: the rows program of rows_core.cuh in ROW_DENSE mode, one block
// per RT rows (the host picks RT from the batch size, the SM count and
// shared memory): the rows' fields staged in shared memory, stages A-C over
// (row, target) pairs with the fold only for the pairs whose subject and
// action match (from a work list), stage D per (row, set), stage E as a
// bitset scan over staged rule tiles (warps over rows' rule words, ballots,
// then threads over (row, policy) read bit windows), stage F per (row,
// set), stage G one thread per row.  The design before it (one block per
// row, one thread per target row, one warp per policy over its rules) left
// all of a single-policy tree's stage E to one warp of the block.
//
// Explain mode (the EXPLAIN flag) writes the provenance code as a fourth
// output (the JAX program's explain recovery, ops/kernel.py:1165-1185) from
// the policy and rule slot stages E and F kept.
//
// The policy tables and request arrays are kernel arguments (one struct of
// device pointers plus the shape ints, then the block shape); with_acl /
// with_hr / with_rel / explain are template parameters (16 variants).  Bools
// arrive as uint8.  The relation planes' width (NRU_REL) comes from their
// shapes, so the 1-wide dummy planes of a batch encoded without relation
// bits are read as they are.  The kernel allocates nothing.

#include "rows_core.cuh"

template <bool WITH_ACL, bool WITH_HR, bool WITH_REL, bool EXPLAIN>
__global__ void __launch_bounds__(RW_THREADS, RW_MIN_BLOCKS)
    decide_dense_kernel(const RowsArgs ra) {
  extern __shared__ __align__(16) unsigned char smem[];
  rows_program<ROW_DENSE, WITH_ACL, WITH_HR, WITH_REL, EXPLAIN>(ra, smem);
}

// the shared-memory opt-in each variant has had
template <bool... F>
OptIn dense_opt_in;

// one launch of the variant (with_acl, with_hr, with_rel, explain)
template <bool... F>
struct DenseLaunch {
  static int run(const RowsArgs& ra, size_t smem, int threads,
                 cudaStream_t stream) {
    auto kernel = decide_dense_kernel<F...>;
    cudaError_t err = opt_in(kernel, smem, dense_opt_in<F...>);
    if (err != cudaSuccess) return (int)err;
    kernel<<<rows_grid(ra), threads, smem, stream>>>(ra);
    return (int)cudaGetLastError();
  }
};

// resident blocks per SM of the variant at this shared memory size
template <bool... F>
struct DenseOccupancy {
  static int run(size_t smem, int threads, int* blocks) {
    auto kernel = decide_dense_kernel<F...>;
    cudaError_t err = opt_in(kernel, smem, dense_opt_in<F...>);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, threads, smem);
  }
};

// fills the shape ints (the dense ones, then RW_DIMS); false on a count
// mismatch or a zero tile
static bool fill_dense_dims(RowsArgs* ra, const int32_t* dims, int n_dims) {
  if (n_dims != kNumDims + kNumRwDims) return false;
  return fill_dims(&ra->a, dims, kNumDims) &&
         fill_rows_tile(ra, dims, n_dims);
}

extern "C" {

// "ptr,ptr,...|dim,dim,..." : the argument order, checked by the host
const char* acs_decide_dense_layout() {
  return ACS_PTRS(ACS_NAME) "|" ACS_DIMS(ACS_DIM_NAME) RW_DIMS(ACS_DIM_NAME);
}

// dynamic shared memory bytes a launch needs (-1 on an argument mismatch)
long long acs_decide_dense_smem(const int32_t* dims, int n_dims, int with_acl,
                                int explain) {
  RowsArgs ra = {};
  if (!fill_dense_dims(&ra, dims, n_dims)) return -1;
  return (long long)rw_smem(ra.a, ra.rt, ROW_DENSE, with_acl != 0,
                            explain != 0).total;
}

// launches the kernel on `stream`; returns cudaGetLastError() after the
// launch, or -1 when the argument counts do not match this build or the
// explain variant has no output to write
int acs_decide_dense(const int64_t* ptrs, int n_ptrs, const int32_t* dims,
                     int n_dims, int with_acl, int with_hr, int with_rel,
                     int explain, int threads, void* stream) {
  RowsArgs ra = {};
  if (n_dims != kNumDims + kNumRwDims ||
      !fill_args(&ra.a, ptrs, n_ptrs, dims, kNumDims) ||
      !fill_rows_tile(&ra, dims, n_dims))
    return -1;
  if (explain && ra.a.out_explain == nullptr) return -1;
  if (ra.a.B == 0) return 0;
  const size_t smem =
      rw_smem(ra.a, ra.rt, ROW_DENSE, with_acl != 0, explain != 0).total;
  const bool flags[4] = {with_acl != 0, with_hr != 0, with_rel != 0,
                         explain != 0};
  return dispatch_flags<4, DenseLaunch>(
      flags, ra, smem, threads, reinterpret_cast<cudaStream_t>(stream));
}

// resident blocks per SM of a variant at these shapes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), -1 on a mismatch
int acs_decide_dense_occupancy(const int32_t* dims, int n_dims, int with_acl,
                               int with_hr, int with_rel, int explain,
                               int threads) {
  RowsArgs ra = {};
  if (!fill_dense_dims(&ra, dims, n_dims)) return -1;
  const size_t smem =
      rw_smem(ra.a, ra.rt, ROW_DENSE, with_acl != 0, explain != 0).total;
  int blocks = 0;
  const bool flags[4] = {with_acl != 0, with_hr != 0, with_rel != 0,
                         explain != 0};
  const int err = dispatch_flags<4, DenseOccupancy>(flags, smem, threads,
                                                    &blocks);
  return err != 0 ? -1 : blocks;
}

}  // extern "C"
