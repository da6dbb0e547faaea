// Device code shared by the port's decision kernels (sm_90a).
//
// rows_core.cuh (the rows program, which decide_dense.cu and both modes of
// shard_chunk.cu run, and the stage helpers decide_grouped.cu shares),
// sig_decide.cu, sig_planes.cu (stage A per resource signature, its
// component pass), wia_planes.cu (the whatIsAllowed planes per
// representative row: the argument macros only) and shard_tail.cu (the
// sharded programs' merge tail) include this header.  It
// holds the argument list of the dense program and of the shard programs
// (Chunk, chunk_width), the stage-A components (`target_components`), the
// HR and relation-path fold (`hr_bad`), the verifyACL branches
// (`acl_rmd`, `acl_create`), the combining-algorithm selection
// (`select_pos`), the provenance code and the abort slots, written once;
// the programs themselves live in rows_core.cuh and the kernels' sources.
// The plain PyTorch versions they are held against: ops/kernel_ref.py,
// ops/prefilter_ref.py and ops/shard_ref.py.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define ACS_BIG (1 << 30)

// limits of the per-thread bitmask state (the encoder's ceiling caps are
// NR 16, NOP 8, NACLE 16, NACLI 64, NHRR 32; K_ENT is 2)
#define MAX_NR 32
#define MAX_NOP 32
#define MAX_NACLE 32
#define MAX_NACLI 64
#define MAX_NHRR 32
#define MAX_KE 8

// pointer arguments of the dense program, in the order the host passes them
#define ACS_PTRS(X)                                                          \
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
  X(const uint8_t*, set_valid) X(const int32_t*, set_ca)                     \
  X(const uint8_t*, set_has_target) X(const int32_t*, set_target)            \
  X(const uint8_t*, pol_valid) X(const int32_t*, pol_ca)                     \
  X(const int32_t*, pol_effect) X(const uint8_t*, pol_cacheable)             \
  X(const uint8_t*, pol_has_target) X(const int32_t*, pol_target)            \
  X(const uint8_t*, pol_has_subjects) X(const int32_t*, pol_n_rules)         \
  X(const int32_t*, pol_eff_ctx) X(const uint8_t*, pol_has_props)            \
  X(const int32_t*, pol_ent_vals)                                            \
  X(const uint8_t*, rule_valid) X(const int32_t*, rule_effect)               \
  X(const uint8_t*, rule_cacheable_raw) X(const uint8_t*, rule_cacheable_eff) \
  X(const uint8_t*, rule_has_target) X(const int32_t*, rule_target)          \
  X(const int32_t*, rule_cond) X(const int32_t*, acl_consts)                 \
  X(const int32_t*, rule_orig_flat)                                          \
  X(const int32_t*, r_sub_ids) X(const int32_t*, r_sub_vals)                 \
  X(const int32_t*, r_roles) X(const int32_t*, r_act_ids)                    \
  X(const int32_t*, r_act_vals) X(const int32_t*, r_ent_vals)                \
  X(const int32_t*, r_ent_e) X(const uint8_t*, r_ent_valid)                  \
  X(const int32_t*, r_prop_vals) X(const int32_t*, r_prop_sfx)               \
  X(const int32_t*, r_prop_run) X(const int32_t*, r_prop_tail)               \
  X(const int32_t*, r_op_vals) X(const int32_t*, r_ra3)                      \
  X(const int32_t*, r_ra2) X(const int32_t*, r_n_ra)                         \
  X(const uint8_t*, r_ctx_present) X(const int32_t*, r_n_entity_attrs)       \
  X(const uint8_t*, r_has_props) X(const int32_t*, r_acl_short)              \
  X(const int32_t*, r_acl_ent) X(const int32_t*, r_acl_inst)                 \
  X(const int32_t*, r_acl_hr) X(const int32_t*, r_hr_roles)                  \
  X(const int32_t*, r_subject_id) X(const int32_t*, r_own_runs)              \
  X(const int32_t*, r_own_bits) X(const int32_t*, r_rel_runs)               \
  X(const int32_t*, r_rel_bits)                                              \
  X(const uint8_t*, rgx_set) X(const uint8_t*, pfx_neq)                      \
  X(const uint8_t*, cond_true) X(const uint8_t*, cond_abort)                 \
  X(const int32_t*, cond_code)                                               \
  X(int32_t*, out_decision) X(int32_t*, out_cacheable) X(int32_t*, out_status) \
  X(int32_t*, out_explain)

// shape ints of the dense program, in the order the host passes them
#define ACS_DIMS(X)                                                          \
  X(B) X(T) X(S) X(KP) X(KR) X(KS) X(KA) X(KE) X(KO) X(KPR)                  \
  X(NSUB) X(NROLE) X(NACT) X(NR) X(NP) X(NOP) X(NRA) X(NHR)                  \
  X(NACLE) X(NACLI) X(NHRR) X(NRU) X(NWORDS) X(NRU_REL) X(NWORDS_REL)       \
  X(W) X(E) X(C) X(CSTRIDE)

#define ACS_FIELD(type, name) type name;
#define ACS_DIM_FIELD(name) int name;
#define ACS_COUNT(...) +1
#define ACS_NAME(type, name) #name ","
#define ACS_DIM_NAME(name) #name ","
#define ACS_SET_PTR(type, name) a->name = reinterpret_cast<type>(ptrs[i++]);
#define ACS_SET_DIM(name) a->name = dims[i++];

struct Args {
  ACS_PTRS(ACS_FIELD)
  ACS_DIMS(ACS_DIM_FIELD)
};

static const int kNumPtrs = 0 ACS_PTRS(ACS_COUNT);
static const int kNumDims = 0 ACS_DIMS(ACS_COUNT);

// fills the shape ints of `a`; false when the count differs from this
// build's
static bool fill_dims(Args* a, const int32_t* dims, int n_dims) {
  if (n_dims != kNumDims) return false;
  int i = 0;
  ACS_DIMS(ACS_SET_DIM)
  return true;
}

// fills `a` from the host's pointer and shape arrays; false when the
// counts differ from this build's
static bool fill_args(Args* a, const int64_t* ptrs, int n_ptrs,
                      const int32_t* dims, int n_dims) {
  if (n_ptrs != kNumPtrs) return false;
  int i = 0;
  ACS_PTRS(ACS_SET_PTR)
  return fill_dims(a, dims, n_dims);
}

// per-target match bits kept in shared memory
enum : uint8_t {
  TB_EX_P = 1, TB_EX_D = 2, TB_RG_P = 4, TB_RG_D = 8, TB_HR = 16, TB_ACL = 32
};
// stage-A components without the subject fold (signature planes)
enum : uint8_t {
  TC_EX_P = 1, TC_EX_D = 2, TC_RG_P = 4, TC_RG_D = 8, TC_ACT = 16
};

__host__ __device__ inline size_t align_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

// bits 0-3 of m as the bytes of a word (byte i = bit i): four byte-plane
// values as one 32-bit store
__device__ __forceinline__ uint32_t expand4(uint32_t m) {
  return (m & 1u) | ((m & 2u) << 7) | ((m & 4u) << 14) | ((m & 8u) << 21);
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ uint32_t warp_or(uint32_t v) {
  for (int o = 16; o > 0; o >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// every valid rule (id, value) pair appears among the request pairs
__device__ __forceinline__ bool pairs_subset(const int32_t* rid,
                                             const int32_t* rval, int K,
                                             const int32_t* qid,
                                             const int32_t* qval, int J) {
  for (int k = 0; k < K; ++k) {
    const int id = rid[k];
    if (id < 0) continue;
    const int v = rval[k];
    bool found = false;
    for (int j = 0; j < J; ++j) {
      if (qid[j] >= 0 && qid[j] == id && qval[j] == v) {
        found = true;
        break;
      }
    }
    if (!found) return false;
  }
  return true;
}

// true when `role` is one of target row t's scoped roles (a subject pair
// whose id is the role urn)
__device__ __forceinline__ bool role_scoped(const Args& a, int t, int role,
                                            int role_urn) {
  for (int k = 0; k < a.KS; ++k) {
    const int sv = a.t_sub_vals[t * a.KS + k];
    if (a.t_sub_ids[t * a.KS + k] == role_urn && sv >= 0 && sv == role)
      return true;
  }
  return false;
}

// one bit of the packed owner verdicts of vocab entry v (layout:
// ops/encode.owner_bit_layout); >> on int32 is arithmetic as in JAX, the
// payload bit is masked after the shift
__device__ __forceinline__ bool owner_bit(const int32_t* words, int v,
                                          int ebits, int k) {
  if (ebits <= 32) {
    const int epw = 32 / ebits;
    const int code = words[v / epw] >> ((v % epw) * ebits);
    return ((code >> k) & 1) == 1;
  }
  const int wpe = (ebits + 31) / 32;
  return ((words[v * wpe + k / 32] >> (k % 32)) & 1) == 1;
}

// verifyACL read/modify/delete branch for target row t (row b)
__device__ bool acl_rmd(const Args& a, int b, int t) {
  const int32_t* ents = a.r_acl_ent + (size_t)b * a.NACLE;
  const int32_t* insts = a.r_acl_inst + (size_t)b * a.NACLE * a.NACLI;
  const int32_t* ra3 = a.r_ra3 + (size_t)b * a.NRA * 3;
  const int role_urn = a.acl_consts[0];
  const int user_urn = a.acl_consts[1];
  const int subject = a.r_subject_id[b];
  bool has_ents = false;
  for (int e = 0; e < a.NACLE; ++e) {
    const int ent = ents[e];
    if (ent < 0) continue;
    has_ents = true;
    const int32_t* ie = insts + e * a.NACLI;
    if (ent == user_urn) {
      for (int i = 0; i < a.NACLI; ++i)
        if (ie[i] >= 0 && ie[i] == subject) return true;
    }
    for (int n = 0; n < a.NRA; ++n) {
      const int32_t* q = ra3 + n * 3;
      if (q[1] < 0 || q[1] != ent) continue;
      bool inst_has = false;
      for (int i = 0; i < a.NACLI; ++i)
        if (ie[i] >= 0 && ie[i] == q[2]) { inst_has = true; break; }
      if (inst_has && role_scoped(a, t, q[0], role_urn)) return true;
    }
  }
  return !has_ents;
}

// verifyACL create branch for target row t (row b): the sequential scan
// over the (HR role, instance) grid with the validated-instance set carried
// across roles, the per-role broken flag and the last set/fail event, then
// the in-order entity composition with the carried valid flag
__device__ bool acl_create(const Args& a, int b, int t,
                           const uint64_t* elig, const uint64_t* same) {
  const int32_t* ents = a.r_acl_ent + (size_t)b * a.NACLE;
  const int32_t* insts = a.r_acl_inst + (size_t)b * a.NACLE * a.NACLI;
  const int32_t* hr_roles = a.r_hr_roles + (size_t)b * a.NHRR;
  const int32_t* ra2 = a.r_ra2 + (size_t)b * a.NRA * 2;
  const int role_urn = a.acl_consts[0];
  const int user_urn = a.acl_consts[1];
  bool has_ents = false;
  for (int e = 0; e < a.NACLE; ++e) has_ents |= ents[e] >= 0;
  if (!has_ents) return true;  // empty entity dict

  uint64_t validated[MAX_NACLE];
  for (int e = 0; e < a.NACLE; ++e) validated[e] = 0;
  uint32_t last_set = 0, last_true = 0;
  for (int h = 0; h < a.NHRR; ++h) {
    const int role = hr_roles[h];
    if (role < 0 || !role_scoped(a, t, role, role_urn)) continue;
    uint32_t broken = 0;  // reset at each role start
    for (int i = 0; i < a.NACLI; ++i) {
      for (int e = 0; e < a.NACLE; ++e) {
        const uint32_t eb = 1u << e;
        if (insts[e * a.NACLI + i] < 0 || (broken & eb)) continue;
        if ((elig[e * a.NHRR + h] >> i) & 1ull) {
          validated[e] |= 1ull << i;
          last_set |= eb;
          last_true |= eb;
        } else if ((validated[e] & same[e * a.NACLI + i]) == 0ull) {
          broken |= eb;
          last_set |= eb;
          last_true &= ~eb;
        }
      }
    }
  }
  bool v = false, alive = true;
  for (int e = 0; e < a.NACLE; ++e) {
    const int ent = ents[e];
    if (ent < 0) continue;
    const uint32_t eb = 1u << e;
    const bool is_user = ent == user_urn;
    const bool v_out = (last_set & eb) ? ((last_true & eb) != 0) : v;
    bool subj_exists = false;
    for (int n = 0; n < a.NRA && !subj_exists; ++n) {
      const int32_t* q = ra2 + n * 2;
      subj_exists = q[1] >= 0 && q[1] == ent && role_scoped(a, t, q[0], role_urn);
    }
    if (!is_user && (!subj_exists || !v_out)) alive = false;
    v = is_user || v_out;
  }
  return alive;
}

// stage A without the subject fold for target row t against request row b:
// the resource/action match bits (TC_*), the per-op-slot operation hits,
// and when `want_collect` the sticky per-run collection state that stage B
// and the relation-path fold read.  `A` is any argument struct carrying
// the target-table, request-row and regex fields by these names (the
// dense program's Args, or sig_planes.cu's per-group view of a
// pseudo-request).
struct TargetComp {
  uint8_t bits;
  uint32_t collect;
  uint32_t op_hit;
};

template <class A>
__device__ TargetComp target_components(const A& a, int b, int t,
                                        bool want_collect) {
  const int NR = a.NR;
  const int32_t* rev = a.r_ent_vals + (size_t)b * NR;
  const int32_t* ree = a.r_ent_e + (size_t)b * NR;
  const auto* rvalid = a.r_ent_valid + (size_t)b * NR;

  const bool act_ok = pairs_subset(
      a.t_act_ids + t * a.KA, a.t_act_vals + t * a.KA, a.KA,
      a.r_act_ids + (size_t)b * a.NACT, a.r_act_vals + (size_t)b * a.NACT,
      a.NACT);

  // ---- entity matches per (entity slot, run): exact, regex, prefix reset
  uint32_t ex_k[MAX_KE], hit_k[MAX_KE], pfx_k[MAX_KE];
  uint32_t em_ex = 0, em_rg = 0, pfx_any = 0;
  for (int k = 0; k < a.KE; ++k) {
    const int tv = a.t_ent_vals[t * a.KE + k];
    const int tw = a.t_ent_w[t * a.KE + k];
    uint32_t ex = 0, hit = 0, pf = 0;
    for (int j = 0; j < NR; ++j) {
      if (!rvalid[j]) continue;
      const uint32_t bit = 1u << j;
      if (tv >= 0 && tv == rev[j]) ex |= bit;
      if (tw >= 0) {
        const size_t off = (size_t)tw * a.E + max(ree[j], 0);
        if (a.rgx_set[off]) hit |= bit;
        if (a.pfx_neq[off]) pf |= bit;
      }
    }
    ex_k[k] = ex;
    hit_k[k] = hit;
    pfx_k[k] = pf;
    em_ex |= ex;
    em_rg |= hit;
    pfx_any |= pf;
  }
  const uint32_t nr_mask = NR >= 32 ? 0xffffffffu : ((1u << NR) - 1u);

  // ---- operations (exact mode only)
  const int32_t* rop = a.r_op_vals + (size_t)b * a.NOP;
  uint32_t op_hit = 0;
  for (int j = 0; j < a.NOP; ++j) {
    const int rv = rop[j];
    if (rv < 0) continue;
    for (int k = 0; k < a.KO; ++k) {
      const int tv = a.t_op_vals[t * a.KO + k];
      if (tv >= 0 && tv == rv) op_hit |= 1u << j;
    }
  }
  const bool ent_any_ex = em_ex != 0;
  const bool opm = op_hit != 0;

  // exact mode: cumulative OR over runs; regex mode: sticky with reset
  const uint32_t state_ex = em_ex ? (nr_mask & ~((em_ex & (0u - em_ex)) - 1u)) : 0u;
  uint32_t state_rg = 0;
  {
    bool carry = false;
    for (int j = 0; j < NR; ++j) {
      const bool s = (em_rg >> j) & 1u;
      const bool reset = ((pfx_any >> j) & 1u) && !s;
      carry = s ? true : (reset ? false : carry);
      if (carry) state_rg |= 1u << j;
    }
  }

  // ---- property gates
  bool ex_not_in = false, ex_in = false, rg_not_sfx = false, rg_sfx = false;
  const int32_t* pvals = a.r_prop_vals + (size_t)b * a.NP;
  const int32_t* psfx = a.r_prop_sfx + (size_t)b * a.NP;
  const int32_t* prun = a.r_prop_run + (size_t)b * a.NP;
  const int32_t* ptail = a.r_prop_tail + (size_t)b * a.NP;
  for (int p = 0; p < a.NP; ++p) {
    const int pv = pvals[p];
    const int run = prun[p];
    if (pv < 0 || run < 0 || run >= NR) continue;
    const bool at_ex = (state_ex >> run) & 1u;
    const bool at_rg = (state_rg >> run) & 1u;
    if (at_ex) {
      bool tail_eq = false;
      for (int k = 0; k < a.KE; ++k) {
        const int tt = a.t_ent_tails[t * a.KE + k];
        if (tt >= 0 && tt == ptail[p]) tail_eq = true;
      }
      if (tail_eq) {
        bool in_rule = false;
        for (int k = 0; k < a.KPR; ++k) {
          const int tp = a.t_prop_vals[t * a.KPR + k];
          if (tp >= 0 && tp == pv) in_rule = true;
        }
        if (in_rule) ex_in = true; else ex_not_in = true;
      }
    }
    if (at_rg) {
      bool sfx_in = false;
      for (int k = 0; k < a.KPR; ++k) {
        const int ts = a.t_prop_sfx[t * a.KPR + k];
        if (ts >= 0 && ts == psfx[p]) sfx_in = true;
      }
      if (sfx_in) rg_sfx = true; else rg_not_sfx = true;
    }
  }
  const bool has_props = a.t_has_props[t];
  const bool r_has_props = a.r_has_props[b];
  const bool state_any_rg = state_rg != 0;
  const bool state_final_rg = (state_rg >> (NR - 1)) & 1u;
  const bool permit_fail_ex = has_props && ((!r_has_props && ent_any_ex) || ex_not_in);
  const bool deny_skip_ex = has_props && r_has_props && !ex_in;
  const bool permit_fail_rg = has_props && ((!r_has_props && state_any_rg) || rg_not_sfx);
  const bool deny_skip_rg = has_props && r_has_props && !rg_sfx;
  const bool no_res = a.t_n_res[t] == 0;

  TargetComp out;
  out.bits = 0;
  if (no_res || ((ent_any_ex || opm) && !permit_fail_ex)) out.bits |= TC_EX_P;
  if (no_res || ((ent_any_ex || opm) && !deny_skip_ex)) out.bits |= TC_EX_D;
  if (no_res || (state_final_rg && !permit_fail_rg)) out.bits |= TC_RG_P;
  if (no_res || (state_final_rg && !deny_skip_rg)) out.bits |= TC_RG_D;
  if (act_ok) out.bits |= TC_ACT;
  out.op_hit = op_hit;
  out.collect = 0;
  if (want_collect) {
    // sticky collection per entity slot over the runs, any over slots
    for (int k = 0; k < a.KE; ++k) {
      bool s = false;
      for (int j = 0; j < NR; ++j) {
        const uint32_t bit = 1u << j;
        const bool set = ((ex_k[k] | hit_k[k]) & bit) != 0;
        const bool reset = (pfx_k[k] & bit) && !set;
        s = set ? true : (reset ? false : s);
        if (s) out.collect |= bit;
      }
    }
  }
  return out;
}

// stage B from the host-packed owner bitplanes: `collect` / `op_hit` are
// the target's run and op-slot bits, v its (role, scoping) vocab index.
// The relation-path fold reads the closure bitplanes through the same
// function: no operation slots (nop 0), and plane A (bit g) unless the
// path is `!direct` (bit nru + g), i.e. hr_check = !direct.
__device__ __forceinline__ bool hr_bad(const int32_t* words,
                                       const int32_t* runs, int nru, int nop,
                                       int NR, int v, bool hr_check,
                                       uint32_t collect, uint32_t op_hit) {
  const int ebits = 2 * (nru + nop);
  for (int g = 0; g < nru; ++g) {
    const int run = runs[g];
    if (run >= 0 && run < NR && ((collect >> run) & 1u) &&
        owner_bit(words, v, ebits, hr_check ? g : nru + g))
      return true;
  }
  for (int j = 0; j < nop; ++j) {
    if (((op_hit >> j) & 1u) &&
        owner_bit(words, v, ebits, hr_check ? 2 * nru + j : 2 * nru + nop + j))
      return true;
  }
  return false;
}

// combining-algorithm selection over positions: 0 deny-overrides,
// 1 permit-overrides, 2 first-applicable, anything else 0
__device__ __forceinline__ int select_pos(int ca, int first_deny,
                                          int first_permit, int first,
                                          int last) {
  if (ca == 0) return first_deny < ACS_BIG ? first_deny : last;
  if (ca == 1) return first_permit < ACS_BIG ? first_permit : last;
  if (ca == 2) return first;
  return 0;
}

// the modes of the rows program (rows_core.cuh): the dense decision (K1),
// the rule-chunk shard program (K7: stages A-E on one rule chunk, packed
// keys out) and the set-chunk shard program (K8: stages A-F on one set
// chunk, the last-set key out); shard_tail.cu takes the two shard modes
// as its modes
enum RowMode { ROW_DENSE = 0, ROW_RULE_CHUNK = 1, ROW_SET_CHUNK = 2 };

// packed-key columns per (set, policy) in a rule chunk's merge row:
// first-DENY, first-PERMIT and first keys (pos << 3 | effect << 1 |
// cacheable, ACS_BIGKEY when none), the negated last key ((pos + 1) << 3 |
// payload, 0 when none; the MAX rides the MIN as a negation) and the
// policy's gate (valid, set gate and policy gate: identical on every shard)
#define KEY_COLS 5
#define ACS_BIGKEY 2000000000
#define ACS_INT_MAX 2147483647

// the shard programs' shape ints after the dense ones: the model-axis size,
// this shard's model coordinate, its first global rule (K7) or set (K8)
// position, and the padded global rule extent (K7)
#define ACS_CHUNK_DIMS(X) X(N_MODEL) X(RANK) X(OFFSET) X(KR_TOTAL)

struct Chunk {
  int32_t* merge;  // [B, W] this shard's merge rows (chunk_width)
  ACS_CHUNK_DIMS(ACS_DIM_FIELD)
};

struct ChunkArgs {
  Args a;
  Chunk ch;
};

static const int kNumChunkDims = 0 ACS_CHUNK_DIMS(ACS_COUNT);

// width of one merge row: K7's keys then the abort slots, K8's negated
// last-set key (and in explain mode its negated provenance key) then the
// abort slots; one slot of three ints per model shard (first aborting rule
// in global flat order, its status code, its raw cacheable + 1), INT_MAX in
// every slot but the shard's own, so the MIN over shards is an all-gather
// of the slots
__host__ __device__ inline int chunk_width(int mode, int S, int KP,
                                           int n_model, bool explain) {
  return (mode == ROW_RULE_CHUNK ? S * KP * KEY_COLS : 1 + (explain ? 1 : 0)) +
         n_model * 3;
}

// fills `ca` from a shard program's pointers (the dense list, whose three
// outputs are null, then the merge buffer) and shape ints (the dense ones,
// then ACS_CHUNK_DIMS); false when the counts differ from this build's
static bool fill_chunk_args(ChunkArgs* ca, const int64_t* ptrs, int n_ptrs,
                            const int32_t* dims, int n_dims) {
  if (n_ptrs != kNumPtrs + 1 || n_dims != kNumDims + kNumChunkDims)
    return false;
  if (!fill_args(&ca->a, ptrs, kNumPtrs, dims, kNumDims)) return false;
  ca->ch.merge = reinterpret_cast<int32_t*>(ptrs[kNumPtrs]);
  int i = kNumDims;
#define ACS_SET_CHUNK_DIM(name) ca->ch.name = dims[i++];
  ACS_CHUNK_DIMS(ACS_SET_CHUNK_DIM)
#undef ACS_SET_CHUNK_DIM
  return true;
}

// the provenance code's fields: (pos << 2) | kind with pos non-negative
// below 2^28 on trees that pass explain_capacity_ok; the shift runs
// unsigned so a wrapped position wraps as JAX's int32 shift does
__device__ __forceinline__ int explain_code(int pos, int kind) {
  return (int)(((uint32_t)pos << 2) | (uint32_t)kind);
}

// one abort slot per model shard into a merge row: this shard's triple in
// its own slot, INT_MAX elsewhere
__device__ __forceinline__ void write_abort_slots(int32_t* slots, int n_model,
                                                  int rank, int pos, int code,
                                                  int cach1) {
  for (int d = 0; d < n_model; ++d) {
    const bool own = d == rank;
    slots[d * 3] = own ? pos : ACS_INT_MAX;
    slots[d * 3 + 1] = own ? code : ACS_INT_MAX;
    slots[d * 3 + 2] = own ? cach1 : ACS_INT_MAX;
  }
}

// a launch's N variant flags as template arguments: Launch<Fs...>::run
// with the flags read from `flags` one at a time (every combination is
// instantiated)
template <int N, template <bool...> class Launch, bool... Fs, class... A>
static int dispatch_flags(const bool* flags, A&&... args) {
  if constexpr (sizeof...(Fs) == N) {
    return Launch<Fs...>::run(args...);
  } else {
    return flags[sizeof...(Fs)]
               ? dispatch_flags<N, Launch, Fs..., true>(flags, args...)
               : dispatch_flags<N, Launch, Fs..., false>(flags, args...);
  }
}

extern "C" {

// the largest dynamic shared memory a block may opt in to on the current
// device (-1 when the query fails)
int acs_max_smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return bytes;
}

const char* acs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
