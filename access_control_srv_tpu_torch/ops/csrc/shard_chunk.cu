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
// Per request row (one thread block), one merge row per request:
//   - rule_chunk, against this shard's compacted tables (the rule axis cut
//     to KR_local = KR_TOTAL / N_MODEL columns, the target subtable to the
//     rows those rules and every policy/set target reference): stages A-D
//     as in the dense kernel (decide_core.cuh), then stage E on the local
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
// the readings on an H100 80GB HBM3 at 700 W); both sit far above the
// bound, as the dense kernel does.  Design: the dense kernel's stage
// functions, unchanged (one thread per target row, one warp per policy
// with lanes over the rules and warp-shuffle min/max), so a rule shard
// costs what the dense kernel costs on a quarter of the rules and a set
// shard what it costs on its own sets (a set shard holds whole sets, so
// the shards' work is as uneven as the sets are); only the stage after E
// (rule_chunk) or F (set_chunk) differs.  In explain mode set_chunk also
// writes the negated provenance key of the shard's last contributing set
// after its set key (decide_core.cuh row_program); the MIN merge then
// leaves the owner's, with no second collective.  The mode and with_acl /
// with_hr / with_rel (and for set_chunk explain) are template parameters
// (24 variants).  The kernel allocates nothing.

#include "decide_core.cuh"

template <int MODE, bool WITH_ACL, bool WITH_HR, bool WITH_REL, bool EXPLAIN>
__global__ void shard_chunk_kernel(const ChunkArgs ca) {
  extern __shared__ __align__(16) unsigned char smem[];
  row_program<MODE, WITH_ACL, WITH_HR, WITH_REL, EXPLAIN>(ca.a, blockIdx.x,
                                                          smem, ca.ch);
}

// one launch in MODE of the variant (with_acl, with_hr, with_rel,
// explain); the rule-chunk mode has no explain variant
template <int MODE>
struct ChunkLaunch {
  template <bool... F>
  struct Variant {
    static int run(const ChunkArgs& ca, size_t smem, int threads,
                   cudaStream_t stream) {
      constexpr bool flags[] = {F...};
      if constexpr (MODE == ROW_RULE_CHUNK && flags[3]) {
        return -1;
      } else {
        auto kernel = shard_chunk_kernel<MODE, F...>;
        if (smem > 48 * 1024) {
          cudaError_t err = cudaFuncSetAttribute(
              kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
          if (err != cudaSuccess) return (int)err;
        }
        kernel<<<ca.a.B, threads, smem, stream>>>(ca);
        return (int)cudaGetLastError();
      }
    }
  };
};

extern "C" {

// "ptr,ptr,...|dim,dim,..." : the argument order, checked by the host (the
// dense list, whose three outputs are passed null, then the merge buffer)
const char* acs_shard_chunk_layout() {
  return ACS_PTRS(ACS_NAME) "merge,|" ACS_DIMS(ACS_DIM_NAME)
      ACS_CHUNK_DIMS(ACS_DIM_NAME);
}

// dynamic shared memory bytes a launch needs (-1 on an argument mismatch);
// the same in both modes
long long acs_shard_chunk_smem(const int32_t* dims, int n_dims,
                               int with_acl) {
  Args a = {};
  if (n_dims != kNumDims + kNumChunkDims || !fill_dims(&a, dims, kNumDims))
    return -1;
  return (long long)smem_layout(a, with_acl != 0).total;
}

// launches the kernel on `stream` in `mode` (1: rule_chunk, 2: set_chunk;
// explain only in set_chunk mode, where the merge row carries one more
// column); returns cudaGetLastError() after the launch, or -1 when the
// argument counts, the mode or the explain flag do not match this build
int acs_shard_chunk(const int64_t* ptrs, int n_ptrs, const int32_t* dims,
                    int n_dims, int mode, int with_acl, int with_hr,
                    int with_rel, int explain, int threads, void* stream) {
  ChunkArgs ca;
  if (!fill_chunk_args(&ca, ptrs, n_ptrs, dims, n_dims)) return -1;
  if (mode != ROW_RULE_CHUNK && mode != ROW_SET_CHUNK) return -1;
  if (explain && mode != ROW_SET_CHUNK) return -1;
  if (ca.a.B == 0) return 0;
  const size_t smem = smem_layout(ca.a, with_acl != 0).total;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool flags[4] = {with_acl != 0, with_hr != 0, with_rel != 0,
                         explain != 0};
  if (mode == ROW_RULE_CHUNK)
    return dispatch_flags<4, ChunkLaunch<ROW_RULE_CHUNK>::Variant>(
        flags, ca, smem, threads, s);
  return dispatch_flags<4, ChunkLaunch<ROW_SET_CHUNK>::Variant>(
      flags, ca, smem, threads, s);
}

}  // extern "C"
