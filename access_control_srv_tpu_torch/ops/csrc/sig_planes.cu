// Signature planes kernel for Hopper (sm_90a): stage A per resource
// signature, gathered to rule / policy / set granularity.
//
// Replaces the JAX package's ops/prefilter.py PrefilteredKernel._planes_for
// `bits_fn` (_match_targets in components mode per signature pseudo-request,
// vmapped over the groups, then the jnp.take gathers to the [G,S,KP,KR] /
// [G,S,KP] / [G,S] planes and the multi-entity recheck).  Host side:
// access_control_srv_tpu_torch/ops/kernel.py (sig_planes); the plain PyTorch
// version it is held against: ops/prefilter_ref.py sig_planes_ref.  It runs
// once per signature-set cache miss.
//
// What bounds it: bytes.  It reads each group's compacted target table once
// (a few hundred rows) and writes the planes, which are most of the traffic
// (the subject id/value planes carry KS int32 per rule); the work per byte is
// a handful of compares.
//
// Design: one thread block per signature group.  Phase 1: threads stride
// over the group's Tp target rows and run the dense kernel's per-target
// stage A (target_components in decide_core.cuh, the sticky regex scan with
// prefix resets included) against the group's pseudo-request: no subjects,
// no properties, so the PERMIT property-fail reduces to has_props and an
// entity hit.  Five component bits per target go to a scratch byte, and for
// HR or relation trees the per-run collection bits (and for HR the
// per-op-slot hits) to scratch words.  After __syncthreads, phase 2: threads stride over the S*KP*KR rule
// positions, the S*KP policies and the S sets, gather the component bits
// through rule_target / pol_target / set_target and write every plane (for
// relation trees (with_rel) also the relation-path vocab index and !direct
// flag of each rule and policy target, and the collection planes an HR tree
// would carry; ops/prefilter.py:755-776); one thread per set folds the
// multi-entity recheck.  Scratch is global memory
// allocated by the host (Tp can exceed what shared memory holds).

#include "decide_core.cuh"

#define SP_PTRS(X)                                                           \
  X(const int32_t*, t_n_subjects) X(const int32_t*, t_role)                  \
  X(const uint8_t*, t_has_role) X(const uint8_t*, t_has_scoping)             \
  X(const uint8_t*, t_hr_check) X(const uint8_t*, t_skip_acl)                \
  X(const int32_t*, t_sub_ids) X(const int32_t*, t_sub_vals)                 \
  X(const int32_t*, t_act_ids) X(const int32_t*, t_act_vals)                 \
  X(const int32_t*, t_ent_vals) X(const int32_t*, t_ent_w)                   \
  X(const int32_t*, t_ent_tails) X(const int32_t*, t_op_vals)                \
  X(const int32_t*, t_prop_vals) X(const int32_t*, t_prop_sfx)               \
  X(const uint8_t*, t_has_props) X(const int32_t*, t_n_res)                  \
  X(const int32_t*, t_rs_idx) X(const int32_t*, t_rel_idx)                   \
  X(const uint8_t*, t_rel_direct)                                            \
  X(const int32_t*, rule_effect) X(const int32_t*, rule_target)              \
  X(const int32_t*, pol_target) X(const int32_t*, set_target)                \
  X(const uint8_t*, pol_valid) X(const int32_t*, pol_effect)                 \
  X(const uint8_t*, pol_has_props) X(const int32_t*, pol_ent_vals)           \
  X(const int32_t*, r_act_ids) X(const int32_t*, r_act_vals)                 \
  X(const int32_t*, r_ent_vals) X(const int32_t*, r_ent_e)                   \
  X(const uint8_t*, r_ent_valid) X(const int32_t*, r_prop_vals)              \
  X(const int32_t*, r_prop_sfx) X(const int32_t*, r_prop_run)                \
  X(const int32_t*, r_prop_tail) X(const int32_t*, r_op_vals)                \
  X(const uint8_t*, r_has_props) X(const uint8_t*, rgx_set)                  \
  X(const uint8_t*, pfx_neq)                                                 \
  X(uint8_t*, rl_ex) X(uint8_t*, rl_rg) X(int32_t*, rl_role)                 \
  X(uint8_t*, rl_has_role) X(int32_t*, rl_n_sub) X(int32_t*, rl_sub_ids)     \
  X(int32_t*, rl_sub_vals) X(uint8_t*, rl_skip)                              \
  X(uint8_t*, pp_ex_p) X(uint8_t*, pp_ex_d) X(uint8_t*, pp_rg_p)             \
  X(uint8_t*, pp_rg_d) X(int32_t*, pl_role) X(uint8_t*, pl_has_role)         \
  X(int32_t*, pl_n_sub) X(int32_t*, pl_sub_ids) X(int32_t*, pl_sub_vals)     \
  X(uint8_t*, ss_ex_p) X(int32_t*, sl_role) X(uint8_t*, sl_has_role)         \
  X(int32_t*, sl_n_sub) X(int32_t*, sl_sub_ids) X(int32_t*, sl_sub_vals)     \
  X(uint8_t*, multi_ok)                                                      \
  X(uint8_t*, rl_collect) X(uint8_t*, rl_op_hit) X(uint8_t*, rl_triv)        \
  X(int32_t*, rl_rs) X(uint8_t*, rl_hrchk)                                   \
  X(uint8_t*, pl_collect) X(uint8_t*, pl_op_hit) X(uint8_t*, pl_triv)        \
  X(int32_t*, pl_rs) X(uint8_t*, pl_hrchk)                                   \
  X(int32_t*, rl_rel_idx) X(uint8_t*, rl_rel_dir)                            \
  X(int32_t*, pl_rel_idx) X(uint8_t*, pl_rel_dir)                            \
  X(uint8_t*, comp_bits) X(int32_t*, comp_collect) X(int32_t*, comp_op)

#define SP_DIMS(X)                                                           \
  X(G) X(T) X(S) X(KP) X(KR) X(KS) X(KA) X(KE) X(KO) X(KPR) X(NACT) X(NR)    \
  X(NP) X(NOP) X(W) X(E)

struct SigArgs {
  SP_PTRS(ACS_FIELD)
  SP_DIMS(ACS_DIM_FIELD)
};

static const int kSpPtrs = 0 SP_PTRS(ACS_COUNT);
static const int kSpDims = 0 SP_DIMS(ACS_COUNT);

// the target table and regex matrices of group g (row arrays are indexed
// by g as the pseudo-request's row)
__device__ __forceinline__ SigArgs group_view(const SigArgs& a, int g) {
  SigArgs v = a;
  const size_t T = (size_t)g * a.T;
  v.t_n_subjects += T; v.t_role += T; v.t_has_role += T;
  v.t_has_scoping += T; v.t_hr_check += T; v.t_skip_acl += T;
  v.t_sub_ids += T * a.KS; v.t_sub_vals += T * a.KS;
  v.t_act_ids += T * a.KA; v.t_act_vals += T * a.KA;
  v.t_ent_vals += T * a.KE; v.t_ent_w += T * a.KE; v.t_ent_tails += T * a.KE;
  v.t_op_vals += T * a.KO;
  v.t_prop_vals += T * a.KPR; v.t_prop_sfx += T * a.KPR;
  v.t_has_props += T; v.t_n_res += T; v.t_rs_idx += T;
  v.t_rel_idx += T; v.t_rel_direct += T;
  v.rgx_set += (size_t)g * a.W * a.E;
  v.pfx_neq += (size_t)g * a.W * a.E;
  return v;
}

// the subject columns of target row t, copied to plane slot q
__device__ __forceinline__ void copy_subject(const SigArgs& v, int t,
                                             size_t q, int32_t* role,
                                             uint8_t* has_role,
                                             int32_t* n_sub, int32_t* ids,
                                             int32_t* vals) {
  role[q] = v.t_role[t];
  has_role[q] = v.t_has_role[t];
  n_sub[q] = v.t_n_subjects[t];
  for (int k = 0; k < v.KS; ++k) {
    ids[q * v.KS + k] = v.t_sub_ids[t * v.KS + k];
    vals[q * v.KS + k] = v.t_sub_vals[t * v.KS + k];
  }
}

// the collection state of a target row (per-run bits) to plane slot q
__device__ __forceinline__ void copy_collect(const SigArgs& v, size_t q,
                                             uint32_t collect, uint8_t* coll) {
  for (int j = 0; j < v.NR; ++j) coll[q * v.NR + j] = (collect >> j) & 1u;
}

// stage B's per-signature pieces of target row t, copied to plane slot q
__device__ __forceinline__ void copy_hr(const SigArgs& v, int t, size_t q,
                                        uint32_t collect, uint32_t op_hit,
                                        uint8_t* coll, uint8_t* op,
                                        uint8_t* triv, int32_t* rs,
                                        uint8_t* hrchk) {
  copy_collect(v, q, collect, coll);
  for (int j = 0; j < v.NOP; ++j) op[q * v.NOP + j] = (op_hit >> j) & 1u;
  triv[q] = v.t_n_subjects[t] == 0 || !v.t_has_scoping[t];
  rs[q] = v.t_rs_idx[t];
  hrchk[q] = v.t_hr_check[t];
}

// the relation-path pieces of target row t (the requirement's vocab index,
// -1 for none, and its !direct flag), plus the collection state when the HR
// planes do not already carry it, copied to plane slot q
template <bool WITH_HR>
__device__ __forceinline__ void copy_rel(const SigArgs& v, int t, size_t q,
                                         uint32_t collect, uint8_t* coll,
                                         int32_t* idx, uint8_t* dir) {
  if (!WITH_HR) copy_collect(v, q, collect, coll);
  idx[q] = v.t_rel_idx[t];
  dir[q] = v.t_rel_direct[t];
}

template <bool WITH_HR, bool WITH_REL>
__global__ void sig_planes_kernel(const SigArgs a) {
  const int g = blockIdx.x;
  const SigArgs v = group_view(a, g);
  uint8_t* cbits = a.comp_bits + (size_t)g * a.T;
  int32_t* ccoll = a.comp_collect + (size_t)g * a.T;
  int32_t* cop = a.comp_op + (size_t)g * a.T;

  // ---- phase 1: stage A components per target row of the group
  for (int t = threadIdx.x; t < a.T; t += blockDim.x) {
    const TargetComp c = target_components(v, g, t, WITH_HR || WITH_REL);
    cbits[t] = c.bits;
    if (WITH_HR || WITH_REL) ccoll[t] = (int32_t)c.collect;
    if (WITH_HR) cop[t] = (int32_t)c.op_hit;
  }
  __syncthreads();

  // ---- phase 2: gathers to rule, policy and set planes
  const size_t n_pol = (size_t)a.S * a.KP;
  const size_t n_rule = n_pol * a.KR;
  const int32_t* rt = a.rule_target + g * n_rule;
  const int32_t* reff = a.rule_effect + g * n_rule;
  for (size_t x = threadIdx.x; x < n_rule; x += blockDim.x) {
    const int t = rt[x];
    const size_t q = g * n_rule + x;
    const uint8_t cb = cbits[t];
    const bool act = cb & TC_ACT;
    const bool deny = reff[x] == 2;
    a.rl_ex[q] = act && (cb & (deny ? TC_EX_D : TC_EX_P));
    a.rl_rg[q] = act && (cb & (deny ? TC_RG_D : TC_RG_P));
    copy_subject(v, t, q, a.rl_role, a.rl_has_role, a.rl_n_sub,
                 a.rl_sub_ids, a.rl_sub_vals);
    a.rl_skip[q] = v.t_skip_acl[t];
    if (WITH_HR)
      copy_hr(v, t, q, ccoll[t], cop[t], a.rl_collect, a.rl_op_hit,
              a.rl_triv, a.rl_rs, a.rl_hrchk);
    if (WITH_REL)
      copy_rel<WITH_HR>(v, t, q, ccoll[t], a.rl_collect, a.rl_rel_idx,
                        a.rl_rel_dir);
  }
  const int32_t* pt = a.pol_target + g * n_pol;
  for (size_t x = threadIdx.x; x < n_pol; x += blockDim.x) {
    const int t = pt[x];
    const size_t q = g * n_pol + x;
    const uint8_t cb = cbits[t];
    const bool act = cb & TC_ACT;
    a.pp_ex_p[q] = act && (cb & TC_EX_P);
    a.pp_ex_d[q] = act && (cb & TC_EX_D);
    a.pp_rg_p[q] = act && (cb & TC_RG_P);
    a.pp_rg_d[q] = act && (cb & TC_RG_D);
    copy_subject(v, t, q, a.pl_role, a.pl_has_role, a.pl_n_sub,
                 a.pl_sub_ids, a.pl_sub_vals);
    if (WITH_HR)
      copy_hr(v, t, q, ccoll[t], cop[t], a.pl_collect, a.pl_op_hit,
              a.pl_triv, a.pl_rs, a.pl_hrchk);
    if (WITH_REL)
      copy_rel<WITH_HR>(v, t, q, ccoll[t], a.pl_collect, a.pl_rel_idx,
                        a.pl_rel_dir);
  }
  const int32_t* st = a.set_target + (size_t)g * a.S;
  const int32_t* pent = a.r_ent_vals + (size_t)g * a.NR;
  const uint8_t* pvalid = a.r_ent_valid + (size_t)g * a.NR;
  for (int s = threadIdx.x; s < a.S; s += blockDim.x) {
    const int t = st[s];
    const size_t q = (size_t)g * a.S + s;
    const uint8_t cb = cbits[t];
    a.ss_ex_p[q] = (cb & TC_ACT) && (cb & TC_EX_P);
    copy_subject(v, t, q, a.sl_role, a.sl_has_role, a.sl_n_sub,
                 a.sl_sub_ids, a.sl_sub_vals);
    // multi-entity recheck: every signature entity exactly matches some
    // valid policy's resources (PERMIT policies with properties excluded)
    bool ok = true;
    for (int j = 0; j < a.NR && ok; ++j) {
      if (!pvalid[j]) continue;
      bool hit = false;
      for (int kp = 0; kp < a.KP && !hit; ++kp) {
        const int p = s * a.KP + kp;
        if (!a.pol_valid[p] || (a.pol_effect[p] == 1 && a.pol_has_props[p]))
          continue;
        for (int k = 0; k < a.KE; ++k) {
          const int pe = a.pol_ent_vals[p * a.KE + k];
          if (pe >= 0 && pe == pent[j]) hit = true;
        }
      }
      ok = hit;
    }
    a.multi_ok[q] = ok;
  }
}

extern "C" {

// "ptr,ptr,...|dim,dim,..." : the argument order, checked by the host
const char* acs_sig_planes_layout() {
  return SP_PTRS(ACS_NAME) "|" SP_DIMS(ACS_DIM_NAME);
}

// launches one block per group on `stream`; returns cudaGetLastError()
// after the launch, or -1 when the argument counts do not match this build
int acs_sig_planes(const int64_t* ptrs, int n_ptrs, const int32_t* dims,
                   int n_dims, int with_hr, int with_rel, int threads,
                   void* stream_ptr) {
  if (n_ptrs != kSpPtrs || n_dims != kSpDims) return -1;
  SigArgs sa;
  SigArgs* a = &sa;
  int i = 0;
  SP_PTRS(ACS_SET_PTR)
  i = 0;
  SP_DIMS(ACS_SET_DIM)
  if (sa.G == 0) return 0;
  if ((with_hr || with_rel) && (sa.rl_collect == nullptr || sa.NR > MAX_NR))
    return -1;
  if ((with_hr && sa.rl_op_hit == nullptr) ||
      (with_rel && sa.rl_rel_idx == nullptr))
    return -1;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  auto kernel = with_hr ? (with_rel ? sig_planes_kernel<true, true>
                                    : sig_planes_kernel<true, false>)
                        : (with_rel ? sig_planes_kernel<false, true>
                                    : sig_planes_kernel<false, false>);
  kernel<<<sa.G, threads, 0, stream>>>(sa);
  return (int)cudaGetLastError();
}

}  // extern "C"
