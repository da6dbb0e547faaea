// Per-row grouped decision kernel for Hopper (sm_90a): the signature
// prefilter's path for batches that carry ACL pairs or request properties.
//
// Replaces the JAX package's ops/prefilter.py PrefilteredKernel._runner
// (`body`: _evaluate_one vmapped over rows, each row against the group-
// invariant policy arrays joined with its own compacted subtree cs[g_idx]).
// Host side: access_control_srv_tpu_torch/ops/kernel.py (decide_grouped);
// the plain PyTorch version it is held against: ops/prefilter_ref.py
// decide_grouped_ref.
//
// What bounds it: integer compares.  Every row runs stage A on all Tp
// target rows of its own group's compacted subtree (hundreds instead of the
// whole tree), which outweighs the bytes: the stacked subtrees are read by
// the rows of a group from L2, each row's request arrays once.
//
// Design: the dense program (decide_row in decide_core.cuh), one thread
// block per request row.  The block reads g = g_idx[row] and advances every
// group-varying table pointer (the target table t_*, the rule arrays, the
// policy and set target indices) by g strides of the stacked [G, ...]
// arrays; the group-invariant policy/set metadata and the batch arrays are
// as in the dense kernel.  The host chooses the with_rel variant from the
// stacked subtrees (as the JAX runner keys on tree_needs_rel(stacked)), so a
// batch whose groups carry no relation rows runs the plain variant.  In
// explain mode the stacked rule_orig_flat (each compacted slot's original
// flat position, group-varying like the rule arrays) maps the winning rule
// back to the uncompacted tree, as the JAX runner's recovery does.

#include "decide_core.cuh"

struct GroupedArgs {
  Args a;
  const int32_t* g_idx;  // [B] each row's group
};

// the tables of group g: every varying pointer advanced by g strides
__device__ __forceinline__ Args group_view(const Args& a, int g) {
  Args v = a;
  const size_t T = (size_t)g * a.T;
  const size_t sp = (size_t)g * a.S * a.KP;
  const size_t rules = sp * a.KR;
  v.t_n_subjects += T; v.t_role += T; v.t_has_role += T;
  v.t_has_scoping += T; v.t_hr_check += T; v.t_skip_acl += T;
  v.t_sub_ids += T * a.KS; v.t_sub_vals += T * a.KS;
  v.t_act_ids += T * a.KA; v.t_act_vals += T * a.KA;
  v.t_ent_vals += T * a.KE; v.t_ent_w += T * a.KE; v.t_ent_tails += T * a.KE;
  v.t_op_vals += T * a.KO;
  v.t_prop_vals += T * a.KPR; v.t_prop_sfx += T * a.KPR;
  v.t_has_props += T; v.t_n_res += T; v.t_rs_idx += T;
  v.t_rel_idx += T; v.t_rel_direct += T;
  v.set_target += (size_t)g * a.S;
  v.pol_target += sp;
  v.rule_valid += rules; v.rule_effect += rules;
  v.rule_cacheable_raw += rules; v.rule_cacheable_eff += rules;
  v.rule_has_target += rules; v.rule_target += rules; v.rule_cond += rules;
  if (a.rule_orig_flat != nullptr) v.rule_orig_flat += rules;
  return v;
}

template <bool WITH_ACL, bool WITH_HR, bool WITH_REL, bool EXPLAIN>
__global__ void decide_grouped_kernel(const GroupedArgs ga) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  decide_row<WITH_ACL, WITH_HR, WITH_REL, EXPLAIN>(
      group_view(ga.a, ga.g_idx[b]), b, smem);
}

// one launch of the variant (with_acl, with_hr, with_rel, explain)
template <bool... F>
struct GroupedLaunch {
  static int run(const GroupedArgs& ga, size_t smem, int threads,
                 cudaStream_t stream) {
    auto kernel = decide_grouped_kernel<F...>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<ga.a.B, threads, smem, stream>>>(ga);
    return (int)cudaGetLastError();
  }
};

extern "C" {

// "ptr,ptr,...|dim,dim,..." : the argument order, checked by the host
const char* acs_decide_grouped_layout() {
  return ACS_PTRS(ACS_NAME) "g_idx,|" ACS_DIMS(ACS_DIM_NAME);
}

// dynamic shared memory bytes a launch needs (-1 on an argument mismatch)
long long acs_decide_grouped_smem(const int32_t* dims, int n_dims,
                                  int with_acl) {
  Args a = {};
  if (!fill_dims(&a, dims, n_dims)) return -1;
  return (long long)smem_layout(a, with_acl != 0).total;
}

// launches the kernel on `stream`: the dense program's pointers, then
// g_idx; returns cudaGetLastError() after the launch, or -1 when the
// argument counts do not match this build or the explain variant has no
// output to write
int acs_decide_grouped(const int64_t* ptrs, int n_ptrs, const int32_t* dims,
                       int n_dims, int with_acl, int with_hr, int with_rel,
                       int explain, int threads, void* stream) {
  GroupedArgs ga;
  if (n_ptrs != kNumPtrs + 1 ||
      !fill_args(&ga.a, ptrs, kNumPtrs, dims, n_dims))
    return -1;
  ga.g_idx = reinterpret_cast<const int32_t*>(ptrs[kNumPtrs]);
  if (explain && ga.a.out_explain == nullptr) return -1;
  if (ga.a.B == 0) return 0;
  const size_t smem = smem_layout(ga.a, with_acl != 0).total;
  const bool flags[4] = {with_acl != 0, with_hr != 0, with_rel != 0,
                         explain != 0};
  return dispatch_flags<4, GroupedLaunch>(
      flags, ga, smem, threads, reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
