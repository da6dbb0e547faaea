// Dense batched isAllowed decision kernel for Hopper (sm_90a).
//
// Replaces the JAX package's dense decision program: the vmapped
// ops/kernel.py _evaluate_one under DecisionKernel.make_run.run (stages A-G:
// target matching, HR owner bitplanes, verifyACL, rule predicates, policy
// gates, combining algorithms, last-set-wins and flat-order condition aborts).
// Host side: access_control_srv_tpu_torch/ops/kernel.py (decide_dense); the
// plain PyTorch version it is held against: ops/kernel_ref.py.
//
// What bounds it: integer and boolean work over small padded int32 tables,
// no products at all, so bytes.  Each request row is read once (~0.7 KB of
// int32/uint8 arrays at the floor caps) and three int32 are written; the
// policy tables are shared by every row and stay in L1/L2.
//
// Design: one thread block per request row.
//   Stage A-C: threads stride over the T target rows; each thread runs the
//     whole per-target computation (subject/action/entity/property matching,
//     the sticky entity-run scans, the owner-bitplane HR check and the
//     verifyACL create-path scan, each kept sequential inside its thread) and
//     writes six match bits per target row into shared memory.
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
// The policy tables and request arrays are kernel arguments (one struct of
// device pointers plus the shape ints); with_acl / with_hr are template
// parameters.  Bools arrive as uint8.  The kernel allocates nothing.

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

// pointer arguments, in the order the host passes them
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
  X(const int32_t*, t_rs_idx)                                                \
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
  X(const int32_t*, r_own_bits)                                              \
  X(const uint8_t*, rgx_set) X(const uint8_t*, pfx_neq)                      \
  X(const uint8_t*, cond_true) X(const uint8_t*, cond_abort)                 \
  X(const int32_t*, cond_code)                                               \
  X(int32_t*, out_decision) X(int32_t*, out_cacheable) X(int32_t*, out_status)

// shape ints, in the order the host passes them
#define ACS_DIMS(X)                                                          \
  X(B) X(T) X(S) X(KP) X(KR) X(KS) X(KA) X(KE) X(KO) X(KPR)                  \
  X(NSUB) X(NROLE) X(NACT) X(NR) X(NP) X(NOP) X(NRA) X(NHR)                  \
  X(NACLE) X(NACLI) X(NHRR) X(NRU) X(NWORDS) X(W) X(E) X(C) X(CSTRIDE)

#define ACS_FIELD(type, name) type name;
#define ACS_DIM_FIELD(name) int name;
#define ACS_COUNT(...) +1
#define ACS_NAME(type, name) #name ","
#define ACS_DIM_NAME(name) #name ","

struct Args {
  ACS_PTRS(ACS_FIELD)
  ACS_DIMS(ACS_DIM_FIELD)
};

static const int kNumPtrs = 0 ACS_PTRS(ACS_COUNT);
static const int kNumDims = 0 ACS_DIMS(ACS_COUNT);

// per-target match bits kept in shared memory
enum : uint8_t {
  TB_EX_P = 1, TB_EX_D = 2, TB_RG_P = 4, TB_RG_D = 8, TB_HR = 16, TB_ACL = 32
};

struct SmemLayout {
  size_t elig, same, scal, tbits, setinfo, contrib, setres, total;
};

__host__ __device__ inline size_t align_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

// dynamic shared memory layout; the host sizes the launch with the same
// function the kernel carves the buffer with
__host__ __device__ inline SmemLayout smem_layout(const Args& a,
                                                  bool with_acl) {
  SmemLayout l;
  size_t off = 0;
  l.elig = off;  // uint64 [NACLE * NHRR]: bit i = instance i eligible
  if (with_acl) off += sizeof(uint64_t) * a.NACLE * a.NHRR;
  l.same = off;  // uint64 [NACLE * NACLI]: bit j = instance j equals i
  if (with_acl) off += sizeof(uint64_t) * a.NACLE * a.NACLI;
  l.scal = off;  // int32 [2]: abort position, winning set
  off += sizeof(int32_t) * 2;
  l.tbits = off;  // uint8 [T]
  off += a.T;
  l.setinfo = off;  // uint8 [S]: exact | eval_deny << 1 | set_gate << 2
  off += a.S;
  l.contrib = off;  // uint8 [S * KP]: present | eff << 1 | cach << 3
  off += (size_t)a.S * a.KP;
  l.setres = off;  // uint8 [S]: eff | cach << 2
  off += a.S;
  l.total = align_up(off, 16);
  return l;
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

// stages A-C for target row t: the six match bits
template <bool WITH_ACL, bool WITH_HR>
__device__ uint8_t target_bits(const Args& a, int b, int t,
                               const uint64_t* elig, const uint64_t* same) {
  const int NR = a.NR;
  const int32_t* rev = a.r_ent_vals + (size_t)b * NR;
  const int32_t* ree = a.r_ent_e + (size_t)b * NR;
  const uint8_t* rvalid = a.r_ent_valid + (size_t)b * NR;

  // ---- subject and action matching
  const int n_subjects = a.t_n_subjects[t];
  bool sub_ok = true;
  if (n_subjects != 0) {
    if (a.t_has_role[t]) {
      const int role = a.t_role[t];
      const int32_t* roles = a.r_roles + (size_t)b * a.NROLE;
      sub_ok = false;
      for (int j = 0; j < a.NROLE; ++j)
        if (roles[j] >= 0 && roles[j] == role) sub_ok = true;
    } else {
      sub_ok = pairs_subset(a.t_sub_ids + t * a.KS, a.t_sub_vals + t * a.KS,
                            a.KS, a.r_sub_ids + (size_t)b * a.NSUB,
                            a.r_sub_vals + (size_t)b * a.NSUB, a.NSUB);
    }
  }
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
  const bool base = sub_ok && act_ok;

  uint8_t bits = 0;
  if (base && (no_res || ((ent_any_ex || opm) && !permit_fail_ex))) bits |= TB_EX_P;
  if (base && (no_res || ((ent_any_ex || opm) && !deny_skip_ex))) bits |= TB_EX_D;
  if (base && (no_res || (state_final_rg && !permit_fail_rg))) bits |= TB_RG_P;
  if (base && (no_res || (state_final_rg && !deny_skip_rg))) bits |= TB_RG_D;

  // ---- stage B: HR scopes from the host-packed owner bitplanes
  bool hr = true;
  if (WITH_HR && n_subjects != 0 && a.t_has_scoping[t]) {
    // sticky collection per entity slot over the runs, any over slots
    uint32_t collect = 0;
    for (int k = 0; k < a.KE; ++k) {
      bool s = false;
      for (int j = 0; j < NR; ++j) {
        const uint32_t bit = 1u << j;
        const bool set = ((ex_k[k] | hit_k[k]) & bit) != 0;
        const bool reset = (pfx_k[k] & bit) && !set;
        s = set ? true : (reset ? false : s);
        if (s) collect |= bit;
      }
    }
    const int nru = a.NRU, nop = a.NOP;
    const int ebits = 2 * (nru + nop);
    const int v = a.t_rs_idx[t];
    const bool hr_check = a.t_hr_check[t];
    const int32_t* words = a.r_own_bits + (size_t)b * a.NWORDS;
    const int32_t* runs = a.r_own_runs + (size_t)b * nru;
    bool bad = false;
    for (int g = 0; g < nru && !bad; ++g) {
      const int run = runs[g];
      if (run >= 0 && run < NR && ((collect >> run) & 1u))
        bad = owner_bit(words, v, ebits, hr_check ? g : nru + g);
    }
    for (int j = 0; j < nop && !bad; ++j) {
      if ((op_hit >> j) & 1u)
        bad = owner_bit(words, v, ebits,
                        hr_check ? 2 * nru + j : 2 * nru + nop + j);
    }
    const bool ctx_ok = a.r_ctx_present[b] && a.r_n_ra[b] > 0;
    hr = ctx_ok && !bad;
  }
  if (hr) bits |= TB_HR;

  // ---- stage B2: verifyACL
  const int acl_short = a.r_acl_short[b];
  bool acl;
  if (a.t_skip_acl[t] || acl_short == 1) {
    acl = true;
  } else if (acl_short != 0 || a.r_n_ra[b] <= 0) {
    acl = false;
  } else {
    const int32_t* k = a.acl_consts;
    const int id0 = a.r_act_ids[(size_t)b * a.NACT];
    const int val0 = a.r_act_vals[(size_t)b * a.NACT];
    const bool is_action = id0 == k[2];
    const bool create = is_action && val0 == k[3];
    const bool rmd = is_action && (val0 == k[4] || val0 == k[5] || val0 == k[6]);
    if (!WITH_ACL) {
      acl = create || rmd;
    } else if (create) {
      acl = acl_create(a, b, t, elig, same);
    } else if (rmd) {
      acl = acl_rmd(a, b, t);
    } else {
      acl = false;
    }
  }
  if (acl) bits |= TB_ACL;
  return bits;
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

template <bool WITH_ACL, bool WITH_HR>
__global__ void decide_dense_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SmemLayout L = smem_layout(a, WITH_ACL);
  uint64_t* elig = reinterpret_cast<uint64_t*>(smem + L.elig);
  uint64_t* same = reinterpret_cast<uint64_t*>(smem + L.same);
  int32_t* scal = reinterpret_cast<int32_t*>(smem + L.scal);
  uint8_t* tbits = smem + L.tbits;
  uint8_t* setinfo = smem + L.setinfo;
  uint8_t* contrib = smem + L.contrib;
  uint8_t* setres = smem + L.setres;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  if (tid == 0) {
    scal[0] = ACS_BIG;  // first aborting rule, flat position
    scal[1] = -1;       // last set with a contribution
  }
  if (WITH_ACL) {
    // target-independent verifyACL pieces of this row
    const int32_t* insts = a.r_acl_inst + (size_t)b * a.NACLE * a.NACLI;
    const int32_t* hr_roles = a.r_hr_roles + (size_t)b * a.NHRR;
    const int32_t* ahr = a.r_acl_hr + (size_t)b * a.NHR * 2;
    for (int x = tid; x < a.NACLE * a.NHRR; x += blockDim.x) {
      const int e = x / a.NHRR, h = x % a.NHRR;
      const int role = hr_roles[h];
      uint64_t m = 0;
      for (int i = 0; i < a.NACLI; ++i) {
        const int inst = insts[e * a.NACLI + i];
        if (inst < 0) continue;
        for (int q = 0; q < a.NHR; ++q) {
          if (ahr[q * 2 + 1] >= 0 && ahr[q * 2 + 1] == inst && ahr[q * 2] == role) {
            m |= 1ull << i;
            break;
          }
        }
      }
      elig[x] = m;
    }
    for (int x = tid; x < a.NACLE * a.NACLI; x += blockDim.x) {
      const int e = x / a.NACLI, i = x % a.NACLI;
      const int inst = insts[x];
      uint64_t m = 0;
      for (int j = 0; j < a.NACLI; ++j) {
        const int other = insts[e * a.NACLI + j];
        if (other >= 0 && other == inst) m |= 1ull << j;
      }
      same[x] = m;
    }
    __syncthreads();
  }

  // ---- stages A-C: one thread per target row
  for (int t = tid; t < a.T; t += blockDim.x)
    tbits[t] = target_bits<WITH_ACL, WITH_HR>(a, b, t, elig, same);
  __syncthreads();

  // ---- stage D: policy gates per set (one warp per set)
  const int32_t* rev = a.r_ent_vals + (size_t)b * a.NR;
  const uint8_t* rvalid = a.r_ent_valid + (size_t)b * a.NR;
  const bool multi = a.r_n_entity_attrs[b] > 1;
  for (int s = warp; s < a.S; s += nwarps) {
    int first_kp = ACS_BIG, last_valid = -1;
    uint32_t multi_hit = 0;
    for (int kp = lane; kp < a.KP; kp += 32) {
      const int p = s * a.KP + kp;
      const bool pv = a.pol_valid[p];
      if (!pv) continue;
      last_valid = kp;
      const uint8_t tb = tbits[a.pol_target[p]];
      const bool ctx_deny = a.pol_eff_ctx[p] == 2;
      if (a.pol_has_target[p] && (tb & (ctx_deny ? TB_EX_D : TB_EX_P)))
        first_kp = min(first_kp, kp);
      if (multi && !(a.pol_effect[p] == 1 && a.pol_has_props[p])) {
        for (int j = 0; j < a.NR; ++j) {
          if (!rvalid[j]) continue;
          for (int k = 0; k < a.KE; ++k) {
            const int pe = a.pol_ent_vals[p * a.KE + k];
            if (pe >= 0 && pe == rev[j]) multi_hit |= 1u << j;
          }
        }
      }
    }
    first_kp = warp_min(first_kp);
    last_valid = warp_max(last_valid);
    multi_hit = warp_or(multi_hit);
    if (lane == 0) {
      const bool exact0 = first_kp < ACS_BIG;
      const int src = exact0 ? min(max(first_kp, 0), a.KP - 1)
                             : min(max(last_valid, 0), a.KP - 1);
      const int eval_eff = a.pol_eff_ctx[s * a.KP + src];
      bool multi_gate = true;
      if (multi) {
        uint32_t valid_mask = 0;
        for (int j = 0; j < a.NR; ++j)
          if (rvalid[j]) valid_mask |= 1u << j;
        multi_gate = (valid_mask & ~multi_hit) == 0;
      }
      const bool exact = exact0 && multi_gate;
      const bool set_gate = (!a.set_has_target[s] ||
                             (tbits[a.set_target[s]] & TB_EX_P)) &&
                            a.set_valid[s];
      setinfo[s] = (exact ? 1 : 0) | (eval_eff == 2 ? 2 : 0) | (set_gate ? 4 : 0);
    }
  }
  __syncthreads();

  // ---- stage E: rule combination per policy (one warp per policy)
  const int n_pol = a.S * a.KP;
  for (int p = warp; p < n_pol; p += nwarps) {
    const int s = p / a.KP;
    const uint8_t si = setinfo[s];
    const bool exact = si & 1, eval_deny = si & 2, set_gate = si & 4;
    const bool pv = a.pol_valid[p];
    const uint8_t tb = tbits[a.pol_target[p]];
    const uint8_t tm = exact ? (eval_deny ? TB_EX_D : TB_EX_P)
                             : (eval_deny ? TB_RG_D : TB_RG_P);
    const bool pol_gate = (!a.pol_has_target[p] || (tb & tm)) && pv;
    const bool pol_subject = !a.pol_has_subjects[p] || (tb & TB_HR);
    const bool scope = set_gate && pol_gate;
    int first_deny = ACS_BIG, first_permit = ACS_BIG, first = ACS_BIG;
    int last = -1, abort_pos = ACS_BIG;
    if (scope) {
      for (int kr = lane; kr < a.KR; kr += 32) {
        const int q = p * a.KR + kr;
        if (!a.rule_valid[q]) continue;
        const bool has_t = a.rule_has_target[q];
        const uint8_t tr = has_t ? tbits[a.rule_target[q]] : 0xff;
        const int eff = a.rule_effect[q];
        const bool deny = eff == 2;
        const bool tm_rule = (tr & (deny ? TB_EX_D : TB_EX_P)) ||
                             (tr & (deny ? TB_RG_D : TB_RG_P));
        if (!tm_rule || !(tr & TB_HR)) continue;  // not reached
        const int ci = a.rule_cond[q];
        bool ct = true, cab = false;
        if (ci >= 0 && a.C > 0) {
          ct = a.cond_true[(size_t)ci * a.CSTRIDE + b];
          cab = a.cond_abort[(size_t)ci * a.CSTRIDE + b];
        }
        if (ci >= 0 && cab) {
          abort_pos = min(abort_pos, q);
          continue;
        }
        if ((ci < 0 || ct) && (tr & TB_ACL) && pol_subject) {
          first = min(first, kr);
          last = max(last, kr);
          if (eff == 2) first_deny = min(first_deny, kr);
          if (eff == 1) first_permit = min(first_permit, kr);
        }
      }
    }
    first_deny = warp_min(first_deny);
    first_permit = warp_min(first_permit);
    first = warp_min(first);
    last = warp_max(last);
    abort_pos = warp_min(abort_pos);
    if (lane == 0) {
      if (abort_pos < ACS_BIG) atomicMin(&scal[0], abort_pos);
      const int sel = select_pos(a.pol_ca[p], first_deny, first_permit,
                                 first, last);
      const int sel_c = min(max(sel, 0), a.KR - 1);
      const bool no_rules = pv && set_gate && pol_gate &&
                            a.pol_n_rules[p] == 0 && a.pol_effect[p] > 0;
      const bool present = no_rules || last >= 0;
      const int eff = no_rules ? a.pol_effect[p] : a.rule_effect[p * a.KR + sel_c];
      const bool cach = no_rules ? a.pol_cacheable[p]
                                 : a.rule_cacheable_eff[p * a.KR + sel_c];
      contrib[p] = (present ? 1 : 0) | ((eff & 3) << 1) | (cach ? 8 : 0);
    }
  }
  __syncthreads();

  // ---- stage F: policy combination per set (one warp per set)
  for (int s = warp; s < a.S; s += nwarps) {
    int first_deny = ACS_BIG, first_permit = ACS_BIG, first = ACS_BIG, last = -1;
    for (int kp = lane; kp < a.KP; kp += 32) {
      const uint8_t c8 = contrib[s * a.KP + kp];
      if (!(c8 & 1)) continue;
      const int eff = (c8 >> 1) & 3;
      first = min(first, kp);
      last = max(last, kp);
      if (eff == 2) first_deny = min(first_deny, kp);
      if (eff == 1) first_permit = min(first_permit, kp);
    }
    first_deny = warp_min(first_deny);
    first_permit = warp_min(first_permit);
    first = warp_min(first);
    last = warp_max(last);
    if (lane == 0 && last >= 0) {
      const int sel = select_pos(a.set_ca[s], first_deny, first_permit,
                                 first, last);
      const uint8_t c8 = contrib[s * a.KP + min(max(sel, 0), a.KP - 1)];
      setres[s] = ((c8 >> 1) & 3) | (((c8 >> 3) & 1) << 2);
      atomicMax(&scal[1], s);
    }
  }
  __syncthreads();

  // ---- stage G: last-set-wins, then condition aborts preempt everything
  if (tid == 0) {
    const int winner = scal[1];
    int decision = 0, cacheable = -1, status = 200;
    if (winner >= 0) {
      decision = setres[winner] & 3;
      cacheable = (setres[winner] >> 2) & 1;
    }
    const int abort_pos = scal[0];
    if (abort_pos < ACS_BIG) {
      decision = 2;
      cacheable = a.rule_cacheable_raw[abort_pos] ? 1 : 0;
      status = a.cond_code[(size_t)a.rule_cond[abort_pos] * a.CSTRIDE + b];
    }
    a.out_decision[b] = decision;
    a.out_cacheable[b] = cacheable;
    a.out_status[b] = status;
  }
}

static bool fill_args(Args* a, const int64_t* ptrs, int n_ptrs,
                      const int32_t* dims, int n_dims) {
  if (n_ptrs != kNumPtrs || n_dims != kNumDims) return false;
  int i = 0;
#define ACS_SET_PTR(type, name) a->name = reinterpret_cast<type>(ptrs[i++]);
  ACS_PTRS(ACS_SET_PTR)
#undef ACS_SET_PTR
  i = 0;
#define ACS_SET_DIM(name) a->name = dims[i++];
  ACS_DIMS(ACS_SET_DIM)
#undef ACS_SET_DIM
  return true;
}

template <bool WITH_ACL, bool WITH_HR>
static int launch(const Args& a, size_t smem, int threads, cudaStream_t stream) {
  auto kernel = decide_dense_kernel<WITH_ACL, WITH_HR>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<a.B, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" {

// "ptr,ptr,...|dim,dim,..." : the argument order, checked by the host
const char* acs_decide_dense_layout() {
  return ACS_PTRS(ACS_NAME) "|" ACS_DIMS(ACS_DIM_NAME);
}

// dynamic shared memory bytes a launch needs (-1 on an argument mismatch)
long long acs_decide_dense_smem(const int32_t* dims, int n_dims, int with_acl) {
  Args a = {};
  if (n_dims != kNumDims) return -1;
  int i = 0;
#define ACS_SET_DIM(name) a.name = dims[i++];
  ACS_DIMS(ACS_SET_DIM)
#undef ACS_SET_DIM
  return (long long)smem_layout(a, with_acl != 0).total;
}

// launches the kernel on `stream`; returns cudaGetLastError() after the
// launch, or -1 when the argument counts do not match this build
int acs_decide_dense(const int64_t* ptrs, int n_ptrs, const int32_t* dims,
                     int n_dims, int with_acl, int with_hr, int threads,
                     void* stream) {
  Args a;
  if (!fill_args(&a, ptrs, n_ptrs, dims, n_dims)) return -1;
  if (a.B == 0) return 0;
  const size_t smem = smem_layout(a, with_acl != 0).total;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (with_acl) {
    return with_hr ? launch<true, true>(a, smem, threads, s)
                   : launch<true, false>(a, smem, threads, s);
  }
  return with_hr ? launch<false, true>(a, smem, threads, s)
                 : launch<false, false>(a, smem, threads, s);
}

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
