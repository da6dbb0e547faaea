// Shard kernel of the sharded programs (the per-shard half of K7 and K8)
// for Hopper (sm_90a).
//
// Replaces the per-device body of the JAX package's two sharded programs
// up to their collectives:
//   - mode 1, `rule_chunk`: the rule-axis program, parallel/rule_shard.py
//     _evaluate_chunk (:146-278) under RuleShardedKernel (:281), whose
//     lax.pmin / lax.pmax run inside the jitted shard_map (:176-182, :237,
//     :253-254);
//   - mode 2, `set_chunk`: the pod-sharded (set-axis) program,
//     parallel/pod_shard.py _evaluate_set_chunk (:182-300) under
//     PodShardedKernel (:303), up to the pmax of the winning set key (:230)
//     and the abort pmin / owner pmax (:246-261).
// A CUDA kernel cannot call NCCL, so each program splits into this kernel,
// one torch.distributed MIN all_reduce over the `model` group
// (parallel/rule_shard.py, parallel/pod_shard.py) and the tail kernel
// shard_tail.cu.  Host side: access_control_srv_tpu_torch/ops/kernel.py
// (rule_chunk, set_chunk); the plain PyTorch versions it is held against:
// ops/shard_ref.py rule_chunk_ref, set_chunk_ref.
//
// One merge row per request:
//   - rule_chunk, against this shard's compacted tables (the rule axis cut
//     to KR_local = KR_TOTAL / N_MODEL columns, the target subtable to the
//     rows those rules and every policy/set target reference): stages A-D
//     as in the dense kernel (rows_core.cuh), then stage E on the local
//     rule chunk with GLOBAL rule positions (OFFSET + kr).  Per (set,
//     policy) five int32: the first-DENY, first-PERMIT and first collected
//     rule keys (pos << 3 | effect << 1 | cacheable, 2e9 when none), the
//     NEGATED last key ((pos + 1) << 3 | payload; the cross-shard MAX
//     becomes the same MIN), and the policy's gate (valid, set gate, policy
//     gate; equal on every shard, it feeds the no-rules contribution in the
//     tail);
//   - set_chunk, against this shard's S_local set slots starting at global
//     slot OFFSET (policies and rules whole, the target subtable behind a
//     blank anchor row): stages A-F exactly as the dense kernel runs them
//     (whole sets are shard-local, so every combining algorithm is), then
//     the NEGATED key of the shard's last contributing set,
//     ((OFFSET + s + 1) << 3 | effect << 1 | cacheable), 0 when none;
//   - both: N_MODEL abort slots of three int32: this shard's first aborting
//     rule in GLOBAL flat order (rule_chunk: over the padded rule extent,
//     s * KP * KR_TOTAL + kp * KR_TOTAL + OFFSET + kr; set_chunk:
//     (OFFSET + s) * KP * KR + kp * KR + kr), its status code and its raw
//     cacheable + 1, in slot RANK; INT_MAX in every other slot.
// One MIN all_reduce over the model group then merges the row: the keys
// exactly (positions are unique, so MIN/MAX need no order), the slots as an
// all-gather.
//
// What bounds it on an H100: the int32 compares of stages A-C over the
// shard's target rows.  chip_smoke.py computes the bound from the main
// path's own launch and measures the kernel there (PERF.md section 6 has
// the readings on an H100 80GB HBM3 at 700 W).  Design: both kernels run
// the rows program of rows_core.cuh (one block per RT rows, the rows'
// fields staged in shared memory, stages A-C over (row, target) pairs with
// the fold only where subject and action match, targets whose role no row
// of the block has dropped with one test, stage E as a bitset scan that
// reads each rule record once for all of a block's rows):
//   - rule_chunk_kernel in ROW_RULE_CHUNK mode on the shard's compacted
//     tables: the threads over (row, policy) pairs write the five keys of
//     each policy straight into the merge row, stage G the abort slots;
//     no stage F (a rule chunk's policies are partial) and no explain
//     variant (shard_tail.cu recovers the provenance from the merged
//     keys).  The design before it (one block per row, every (row,
//     target) pair folded, one warp per policy reading every rule record
//     once per row) ran 46x its bound;
//   - set_chunk_kernel in ROW_SET_CHUNK mode on the shard's live target
//     rows: the host hands it prefix views, up to the shard's t_live, of
//     the tables padded to the sticky bucket (parallel/pod_shard.py), so
//     the pad rows no index reaches are not scanned.  A set shard holds
//     whole sets, so the shards' work is as uneven as the sets are.  In
//     explain mode it also writes the negated provenance key of the
//     shard's last contributing set after its set key; the MIN merge then
//     leaves the owner's, with no second collective.
// with_acl / with_hr / with_rel (and for set_chunk explain) are template
// parameters (8 + 16 variants).  The kernels allocate nothing.

#include "rows_core.cuh"

// the block's dynamic shared memory (one declaration for both kernels)
__device__ __forceinline__ unsigned char* dyn_smem() {
  extern __shared__ __align__(16) unsigned char smem[];
  return smem;
}

// rule_chunk: one block per RT request rows
template <bool WITH_ACL, bool WITH_HR, bool WITH_REL>
__global__ void __launch_bounds__(RW_THREADS, RW_MIN_BLOCKS)
    rule_chunk_kernel(const RowsArgs ra) {
  rows_program<ROW_RULE_CHUNK, WITH_ACL, WITH_HR, WITH_REL, false>(
      ra, dyn_smem());
}

// set_chunk: one block per RT request rows
template <bool WITH_ACL, bool WITH_HR, bool WITH_REL, bool EXPLAIN>
__global__ void __launch_bounds__(RW_THREADS, RW_MIN_BLOCKS)
    set_chunk_kernel(const RowsArgs ra) {
  rows_program<ROW_SET_CHUNK, WITH_ACL, WITH_HR, WITH_REL, EXPLAIN>(
      ra, dyn_smem());
}

// the shared-memory opt-in each variant of either kernel has had
template <bool... F>
OptIn rule_opt_in;
template <bool... F>
OptIn set_opt_in;

// one launch of `kernel` over the rows program's grid (the shared-memory
// opt-in set first where `smem` needs more than `seen` records)
template <class K>
static int launch(K kernel, const RowsArgs& ra, size_t smem, int threads,
                  cudaStream_t stream, OptIn& seen) {
  cudaError_t err = opt_in(kernel, smem, seen);
  if (err != cudaSuccess) return (int)err;
  kernel<<<rows_grid(ra), threads, smem, stream>>>(ra);
  return (int)cudaGetLastError();
}

// resident blocks per SM of `kernel` at this shared memory size
template <class K>
static int occupancy(K kernel, size_t smem, int threads, int* blocks,
                     OptIn& seen) {
  cudaError_t err = opt_in(kernel, smem, seen);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                            threads, smem);
}

// one rule_chunk launch of the variant (with_acl, with_hr, with_rel)
template <bool... F>
struct RuleLaunch {
  static int run(const RowsArgs& ra, size_t smem, int threads,
                 cudaStream_t stream) {
    return launch(rule_chunk_kernel<F...>, ra, smem, threads, stream,
                  rule_opt_in<F...>);
  }
};

// one set_chunk launch of the variant (with_acl, with_hr, with_rel,
// explain)
template <bool... F>
struct SetLaunch {
  static int run(const RowsArgs& ra, size_t smem, int threads,
                 cudaStream_t stream) {
    return launch(set_chunk_kernel<F...>, ra, smem, threads, stream,
                  set_opt_in<F...>);
  }
};

// resident blocks per SM of a variant of either kernel
template <bool... F>
struct RuleOccupancy {
  static int run(size_t smem, int threads, int* blocks) {
    return occupancy(rule_chunk_kernel<F...>, smem, threads, blocks,
                     rule_opt_in<F...>);
  }
};
template <bool... F>
struct SetOccupancy {
  static int run(size_t smem, int threads, int* blocks) {
    return occupancy(set_chunk_kernel<F...>, smem, threads, blocks,
                     set_opt_in<F...>);
  }
};

// the shape ints: the dense ones, ACS_CHUNK_DIMS, then RW_DIMS
static const int kNumShardDims = kNumDims + kNumChunkDims + kNumRwDims;

// fills the shape ints of `ra` (its Args' and block shape); false when the
// count differs from this build's, the tile is zero, or `mode` and
// `explain` name no kernel (explain only in set_chunk mode, where the
// merge row carries one more column)
static bool fill_shard_dims(RowsArgs* ra, const int32_t* dims, int n_dims,
                            int mode, int explain) {
  if (mode != ROW_RULE_CHUNK && mode != ROW_SET_CHUNK) return false;
  if (explain && mode != ROW_SET_CHUNK) return false;
  return n_dims == kNumShardDims && fill_dims(&ra->a, dims, kNumDims) &&
         fill_rows_tile(ra, dims, n_dims);
}

// dynamic shared memory bytes of a launch in `mode`
static size_t shard_smem(const RowsArgs& ra, int mode, int with_acl,
                         int explain) {
  return rw_smem(ra.a, ra.rt, mode, with_acl != 0, explain != 0).total;
}

extern "C" {

// "ptr,ptr,...|dim,dim,..." : the argument order, checked by the host (the
// dense list, whose three outputs are passed null, then the merge buffer)
const char* acs_shard_chunk_layout() {
  return ACS_PTRS(ACS_NAME) "merge,|" ACS_DIMS(ACS_DIM_NAME)
      ACS_CHUNK_DIMS(ACS_DIM_NAME) RW_DIMS(ACS_DIM_NAME);
}

// dynamic shared memory bytes a launch in `mode` needs (-1 on an argument
// mismatch)
long long acs_shard_chunk_smem(const int32_t* dims, int n_dims, int mode,
                               int with_acl, int explain) {
  RowsArgs ra = {};
  if (!fill_shard_dims(&ra, dims, n_dims, mode, explain)) return -1;
  return (long long)shard_smem(ra, mode, with_acl, explain);
}

// launches the kernel of `mode` (1: rule_chunk, 2: set_chunk) on
// `stream`; returns cudaGetLastError() after the launch, or -1 when the
// argument counts, the mode or the explain flag do not match this build
int acs_shard_chunk(const int64_t* ptrs, int n_ptrs, const int32_t* dims,
                    int n_dims, int mode, int with_acl, int with_hr,
                    int with_rel, int explain, int threads, void* stream) {
  RowsArgs ra = {};
  ChunkArgs ca;
  if (!fill_shard_dims(&ra, dims, n_dims, mode, explain) ||
      !fill_chunk_args(&ca, ptrs, n_ptrs, dims, n_dims - kNumRwDims))
    return -1;
  ra.a = ca.a;
  ra.ch = ca.ch;
  if (ra.a.B == 0) return 0;
  const size_t smem = shard_smem(ra, mode, with_acl, explain);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool flags[4] = {with_acl != 0, with_hr != 0, with_rel != 0,
                         explain != 0};
  if (mode == ROW_RULE_CHUNK)
    return dispatch_flags<3, RuleLaunch>(flags, ra, smem, threads, s);
  return dispatch_flags<4, SetLaunch>(flags, ra, smem, threads, s);
}

// resident blocks per SM of a variant of `mode`'s kernel at these shapes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), -1 on a mismatch
int acs_shard_chunk_occupancy(const int32_t* dims, int n_dims, int mode,
                              int with_acl, int with_hr, int with_rel,
                              int explain, int threads) {
  RowsArgs ra = {};
  if (!fill_shard_dims(&ra, dims, n_dims, mode, explain)) return -1;
  const size_t smem = shard_smem(ra, mode, with_acl, explain);
  int blocks = 0;
  const bool flags[4] = {with_acl != 0, with_hr != 0, with_rel != 0,
                         explain != 0};
  const int err =
      mode == ROW_RULE_CHUNK
          ? dispatch_flags<3, RuleOccupancy>(flags, smem, threads, &blocks)
          : dispatch_flags<4, SetOccupancy>(flags, smem, threads, &blocks);
  return err != 0 ? -1 : blocks;
}

}  // extern "C"
