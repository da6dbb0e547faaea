// Signature-path decision kernel for Hopper (sm_90a): every batch without
// ACL pairs or request properties on trees of 512 rules or more.
//
// Replaces the JAX package's ops/prefilter.py PrefilteredKernel._sig_runner
// (`body` / `slot_fn` / `one`: the per-row subject fold on the signature
// planes, the HR pass from the owner bitplanes, the relation-path fold on
// the closure bitplanes (with_rel, :563-583), the ACL short path, the
// condition wiring, _policy_gates_core, _combine_and_decide_flat with its
// KR-window packed-key reductions, last-set-wins and the flat-order abort,
// then the un-permute through gp_orig).  Host side:
// access_control_srv_tpu_torch/ops/kernel.py (sig_decide); the plain PyTorch
// version it is held against: ops/prefilter_ref.py sig_decide_ref.
//
// What bounds it: each row reads its group's rule planes (M = KP*KR rule
// positions per set, ~20 bytes each) and makes a few compares per position;
// the planes of a group are shared by its rows and stay in L1/L2.  Counting
// every plane once, bytes bound it at the stress shapes, with the compares
// within 2x (PERF.md).
//
// Design: one thread block per slot of the [NSLOT, R] layout (every row of a
// slot shares one signature group, read once from slot_g), one warp per row
// of the slot (warps loop over the R rows).  A row's packed columns are
// unpacked at the offsets the host passes as shape ints.  Per set, pass 1:
// lanes stride over the policies for the subject-folded policy planes and
// the first exact-match / last-valid positions (warp min/max): the carried
// policyEffect and the exact-match break.  Pass 2: lanes stride over the
// policies again, each lane walks its policy's KR rules in order and keeps
// the first-DENY / first-PERMIT / first / last collected rule as packed keys
// (position << 3 | effect << 1 | cacheable, as pack_rule_key), selects by
// the policy's combining algorithm and folds its contribution into the
// set's packed policy keys; a warp min/max per set and last-set-wins follow.
// The flat-order abort position is a warp min.  Lane 0 stores the row's
// three outputs at its original position: only real grid positions store
// (gp_orig[grid2row[p]] == p), pad positions read row 0 and must not
// overwrite it.
//
// Explain mode (the EXPLAIN template flag; the JAX package's
// _combine_and_decide_flat recovery, ops/kernel.py:920-944): the set loop
// remembers the last contributing set, its selected policy and the gates
// that policy was scanned under; after the loop lane 0 walks that one
// policy's rules again (the same selection by construction), reads the
// winner's within-set position as key >> 3 and maps it through the group's
// rule_orig_flat (clamped, as JAX clips the take) to the uncompacted tree.
// The fourth output is the provenance code (flat_pos << 2) | kind of
// srv/explain.py.

#include "decide_core.cuh"

#define SD_PTRS(X)                                                           \
  X(const int32_t*, acl_consts) X(const uint8_t*, set_valid)                 \
  X(const int32_t*, set_ca) X(const uint8_t*, set_has_target)                \
  X(const uint8_t*, pol_valid) X(const int32_t*, pol_ca)                     \
  X(const int32_t*, pol_effect) X(const uint8_t*, pol_cacheable)             \
  X(const uint8_t*, pol_has_target) X(const uint8_t*, pol_has_subjects)      \
  X(const int32_t*, pol_n_rules) X(const int32_t*, pol_eff_ctx)              \
  X(const uint8_t*, rule_valid) X(const int32_t*, rule_effect)               \
  X(const uint8_t*, rule_cacheable_raw) X(const uint8_t*, rule_cacheable_eff) \
  X(const uint8_t*, rule_has_target) X(const int32_t*, rule_cond)            \
  X(const int32_t*, rule_orig_flat)                                          \
  X(const uint8_t*, rl_ex) X(const uint8_t*, rl_rg)                          \
  X(const int32_t*, rl_role) X(const uint8_t*, rl_has_role)                  \
  X(const int32_t*, rl_n_sub) X(const int32_t*, rl_sub_ids)                  \
  X(const int32_t*, rl_sub_vals) X(const uint8_t*, rl_skip)                  \
  X(const uint8_t*, pp_ex_p) X(const uint8_t*, pp_ex_d)                      \
  X(const uint8_t*, pp_rg_p) X(const uint8_t*, pp_rg_d)                      \
  X(const int32_t*, pl_role) X(const uint8_t*, pl_has_role)                  \
  X(const int32_t*, pl_n_sub) X(const int32_t*, pl_sub_ids)                  \
  X(const int32_t*, pl_sub_vals) X(const uint8_t*, ss_ex_p)                  \
  X(const int32_t*, sl_role) X(const uint8_t*, sl_has_role)                  \
  X(const int32_t*, sl_n_sub) X(const int32_t*, sl_sub_ids)                  \
  X(const int32_t*, sl_sub_vals) X(const uint8_t*, multi_ok)                 \
  X(const uint8_t*, rl_collect) X(const uint8_t*, rl_op_hit)                 \
  X(const uint8_t*, rl_triv) X(const int32_t*, rl_rs)                        \
  X(const uint8_t*, rl_hrchk) X(const uint8_t*, pl_collect)                  \
  X(const uint8_t*, pl_op_hit) X(const uint8_t*, pl_triv)                    \
  X(const int32_t*, pl_rs) X(const uint8_t*, pl_hrchk)                       \
  X(const int32_t*, rl_rel_idx) X(const uint8_t*, rl_rel_dir)                \
  X(const int32_t*, pl_rel_idx) X(const uint8_t*, pl_rel_dir)                \
  X(const int32_t*, slot_g) X(const int32_t*, mega_rows)                     \
  X(const int32_t*, grid2row) X(const int32_t*, gp_orig)                     \
  X(int32_t*, out_decision) X(int32_t*, out_cacheable) X(int32_t*, out_status) \
  X(int32_t*, out_explain)

#define SD_DIMS(X)                                                           \
  X(NSLOT) X(R) X(S) X(KP) X(KR) X(KS) X(NR) X(NOP) X(WROW) X(NSUB)          \
  X(NROLE) X(NACT) X(NRU) X(NWORDS) X(NRU_REL) X(NWORDS_REL) X(C)          \
  X(O_SUB_IDS) X(O_SUB_VALS) X(O_ROLES) X(O_ACT_IDS) X(O_ACT_VALS)           \
  X(O_N_ENT_ATTRS) X(O_N_RA) X(O_ACL_SHORT) X(O_CTX_PRESENT) X(O_OWN_RUNS)   \
  X(O_OWN_BITS) X(O_REL_RUNS) X(O_REL_BITS) X(O_COND_TRUE) X(O_COND_ABORT)   \
  X(O_COND_CODE) X(NEEDS_PAIRS)

struct DecArgs {
  SD_PTRS(ACS_FIELD)
  SD_DIMS(ACS_DIM_FIELD)
};

static const int kSdPtrs = 0 SD_PTRS(ACS_COUNT);
static const int kSdDims = 0 SD_DIMS(ACS_COUNT);

// one request row, unpacked from its packed int32 columns
struct Row {
  const int32_t* roles;
  const int32_t* sub_ids;
  const int32_t* sub_vals;
  const int32_t* runs;  // owner bitplanes
  const int32_t* bits;
  const int32_t* rel_runs;  // relation-closure bitplanes
  const int32_t* rel_bits;
  const int32_t* cond_true;  // [C] each
  const int32_t* cond_abort;
  const int32_t* cond_code;
  bool ctx_ok;          // context present and role associations exist
  bool acl_row;         // verifyACL short path outcome for the row
  bool multi;           // more than one entity attribute
};

// checkSubjectMatches of one plane slot (n_sub, has_role, role, KS pairs)
__device__ __forceinline__ bool sub_fold(const DecArgs& a, const Row& r,
                                         int n_sub, bool has_role, int role,
                                         const int32_t* ids,
                                         const int32_t* vals) {
  bool role_ok = false;
  for (int j = 0; j < a.NROLE; ++j)
    role_ok |= r.roles[j] >= 0 && r.roles[j] == role;
  if (!a.NEEDS_PAIRS) return n_sub == 0 || role_ok;
  if (n_sub == 0) return true;
  if (has_role) return role_ok;
  for (int i = 0; i < a.KS; ++i) {
    const int sid = ids[i];
    if (sid < 0) continue;
    bool hit = false;
    for (int j = 0; j < a.NSUB; ++j)
      hit |= r.sub_ids[j] >= 0 && r.sub_ids[j] == sid && r.sub_vals[j] == vals[i];
    if (!hit) return false;
  }
  return true;
}

// stage B of one plane slot: trivial, or context present and no collected
// run / hit operation whose owner verdict fails
__device__ __forceinline__ bool hr_pass(const DecArgs& a, const Row& r,
                                        bool trivial, int v, bool hr_check,
                                        const uint8_t* collect,
                                        const uint8_t* op_hit) {
  if (trivial) return true;
  if (!r.ctx_ok) return false;
  uint32_t coll = 0, ops = 0;
  for (int j = 0; j < a.NR; ++j) coll |= (uint32_t)(collect[j] != 0) << j;
  for (int j = 0; j < a.NOP; ++j) ops |= (uint32_t)(op_hit[j] != 0) << j;
  return !hr_bad(r.bits, r.runs, a.NRU, a.NOP, a.NR, v, hr_check, coll, ops);
}

// the relation-path gate of one plane slot: no requirement (idx < 0), or
// no collected run whose closure verdict fails (plane A, or plane B for a
// !direct path: hr_bad with nop 0 and hr_check = !direct)
__device__ __forceinline__ bool rel_pass(const DecArgs& a, const Row& r,
                                         int idx, bool direct,
                                         const uint8_t* collect) {
  if (idx < 0) return true;
  uint32_t coll = 0;
  for (int j = 0; j < a.NR; ++j) coll |= (uint32_t)(collect[j] != 0) << j;
  return !hr_bad(r.rel_bits, r.rel_runs, a.NRU_REL, 0, a.NR, idx, !direct,
                 coll, 0);
}

// the group's planes: every pointer of `a` advanced to group g
__device__ __forceinline__ DecArgs group_view(const DecArgs& a, int g) {
  DecArgs v = a;
  const size_t sets = (size_t)g * a.S;
  const size_t pols = sets * a.KP;
  const size_t rules = pols * a.KR;
  v.rule_valid += rules; v.rule_effect += rules;
  v.rule_cacheable_raw += rules; v.rule_cacheable_eff += rules;
  v.rule_has_target += rules; v.rule_cond += rules;
  if (a.rule_orig_flat != nullptr) v.rule_orig_flat += rules;
  v.rl_ex += rules; v.rl_rg += rules; v.rl_role += rules;
  v.rl_has_role += rules; v.rl_n_sub += rules;
  v.rl_sub_ids += rules * a.KS; v.rl_sub_vals += rules * a.KS;
  v.rl_skip += rules;
  v.pp_ex_p += pols; v.pp_ex_d += pols; v.pp_rg_p += pols; v.pp_rg_d += pols;
  v.pl_role += pols; v.pl_has_role += pols; v.pl_n_sub += pols;
  v.pl_sub_ids += pols * a.KS; v.pl_sub_vals += pols * a.KS;
  v.ss_ex_p += sets; v.sl_role += sets; v.sl_has_role += sets;
  v.sl_n_sub += sets; v.sl_sub_ids += sets * a.KS;
  v.sl_sub_vals += sets * a.KS; v.multi_ok += sets;
  if (a.rl_collect != nullptr) {
    v.rl_collect += rules * a.NR; v.pl_collect += pols * a.NR;
  }
  if (a.rl_op_hit != nullptr) {
    v.rl_op_hit += rules * a.NOP;
    v.rl_triv += rules; v.rl_rs += rules; v.rl_hrchk += rules;
    v.pl_op_hit += pols * a.NOP;
    v.pl_triv += pols; v.pl_rs += pols; v.pl_hrchk += pols;
  }
  if (a.rl_rel_idx != nullptr) {
    v.rl_rel_idx += rules; v.rl_rel_dir += rules;
    v.pl_rel_idx += pols; v.pl_rel_dir += pols;
  }
  return v;
}

// the subject-folded policy match planes of policy p (bit 0 ex_p, 1 ex_d,
// 2 rg_p, 3 rg_d)
__device__ __forceinline__ int policy_planes(const DecArgs& v, const Row& r,
                                             int p) {
  const bool sub = sub_fold(v, r, v.pl_n_sub[p], v.pl_has_role[p],
                            v.pl_role[p], v.pl_sub_ids + (size_t)p * v.KS,
                            v.pl_sub_vals + (size_t)p * v.KS);
  if (!sub) return 0;
  return (v.pp_ex_p[p] ? 1 : 0) | (v.pp_ex_d[p] ? 2 : 0) |
         (v.pp_rg_p[p] ? 4 : 0) | (v.pp_rg_d[p] ? 8 : 0);
}

// policy p (= s * KP + kp) of one row, scanned by one lane: its rules in
// order under the set gate and the policy-plane bit tm_bit, the first-DENY /
// first-PERMIT / first / last collected rule as packed keys (within-set
// position kp * KR + kr << 3 | effect << 1 | cacheable), the key its
// combining algorithm selects (an unknown algorithm selects key 0, effect 0,
// as the flat JAX combine does; compile refuses one on a policy that has
// rules), whether the policy's own effect contributes, and the first
// aborting rule folded into *abort_pos
struct PolicySel {
  int sel, last;
  bool no_rules;
};

template <bool WITH_HR, bool WITH_REL>
__device__ __forceinline__ PolicySel scan_policy(const DecArgs& v,
                                                 const Row& r, int p, int kp,
                                                 bool set_gate, int tm_bit,
                                                 int* abort_pos) {
  const int KR = v.KR;
  const bool pv = v.pol_valid[p];
  const bool pol_gate =
      (!v.pol_has_target[p] || (policy_planes(v, r, p) & tm_bit)) && pv;
  const bool scope = set_gate && pol_gate;
  bool pol_subject = true;
  if (WITH_HR && v.pol_has_subjects[p])
    pol_subject = hr_pass(v, r, v.pl_triv[p], v.pl_rs[p], v.pl_hrchk[p],
                          v.pl_collect + (size_t)p * v.NR,
                          v.pl_op_hit + (size_t)p * v.NOP);
  if (WITH_REL && pol_subject && v.pol_has_subjects[p])
    pol_subject = rel_pass(v, r, v.pl_rel_idx[p], v.pl_rel_dir[p],
                           v.pl_collect + (size_t)p * v.NR);
  int first_deny = ACS_BIG, first_permit = ACS_BIG, first = ACS_BIG;
  int last = -1;
  for (int kr = 0; kr < KR && scope; ++kr) {
    const size_t q = (size_t)p * KR + kr;
    if (!v.rule_valid[q]) continue;
    const bool rht = v.rule_has_target[q];
    bool reached = true;
    if (rht) {
      reached = (v.rl_ex[q] || v.rl_rg[q]) &&
                sub_fold(v, r, v.rl_n_sub[q], v.rl_has_role[q],
                         v.rl_role[q], v.rl_sub_ids + q * v.KS,
                         v.rl_sub_vals + q * v.KS);
      if (WITH_HR && reached)
        reached = hr_pass(v, r, v.rl_triv[q], v.rl_rs[q], v.rl_hrchk[q],
                          v.rl_collect + q * v.NR,
                          v.rl_op_hit + q * v.NOP);
      if (WITH_REL && reached)
        reached = rel_pass(v, r, v.rl_rel_idx[q], v.rl_rel_dir[q],
                           v.rl_collect + q * v.NR);
    }
    if (!reached) continue;
    const int ci = v.rule_cond[q];
    bool ct = true, cab = false;
    if (ci >= 0 && v.C > 0) {
      ct = r.cond_true[ci] != 0;
      cab = r.cond_abort[ci] != 0;
    }
    if (ci >= 0 && cab) {
      *abort_pos = min(*abort_pos, (int)q);
      continue;
    }
    const bool acl = !rht || v.rl_skip[q] || r.acl_row;
    if ((ci < 0 || ct) && acl && pol_subject) {
      const int eff = v.rule_effect[q];
      const int key = ((kp * KR + kr) << 3) | (eff << 1) |
                      (v.rule_cacheable_eff[q] ? 1 : 0);
      first = min(first, key);
      last = max(last, key);
      if (eff == 2) first_deny = min(first_deny, key);
      if (eff == 1) first_permit = min(first_permit, key);
    }
  }
  PolicySel out;
  out.sel = select_pos(v.pol_ca[p], first_deny, first_permit, first, last);
  out.last = last;
  out.no_rules = pv && set_gate && pol_gate && v.pol_n_rules[p] == 0 &&
                 v.pol_effect[p] > 0;
  return out;
}

// decides one row against group view v; every lane of the warp calls it
// (the warp reductions need all 32), lane 0 holds the result (and with
// EXPLAIN the provenance code)
template <bool WITH_HR, bool WITH_REL, bool EXPLAIN>
__device__ void decide_sig_row(const DecArgs& v, const Row& r, int lane,
                               int* decision, int* cacheable, int* status,
                               int* code) {
  int win_key = -1;  // (effect << 1 | cacheable) of the last contributing set
  int abort_pos = ACS_BIG;
  // explain: the last contributing set, its selected policy and the gates
  // that policy was scanned under
  int win_s = -1, win_kp = 0, win_tm = 0;
  bool win_gate = false;
  for (int s = 0; s < v.S; ++s) {
    const bool sl_sub = sub_fold(v, r, v.sl_n_sub[s], v.sl_has_role[s],
                                 v.sl_role[s], v.sl_sub_ids + (size_t)s * v.KS,
                                 v.sl_sub_vals + (size_t)s * v.KS);
    const bool set_gate = (!v.set_has_target[s] || (v.ss_ex_p[s] && sl_sub)) &&
                          v.set_valid[s];
    // pass 1: carried policyEffect and the exact-match break
    int first_kp = ACS_BIG, last_valid = -1;
    for (int kp = lane; kp < v.KP; kp += 32) {
      const int p = s * v.KP + kp;
      if (!v.pol_valid[p]) continue;
      last_valid = kp;
      const int pp = policy_planes(v, r, p);
      const bool ctx_deny = v.pol_eff_ctx[p] == 2;
      if (v.pol_has_target[p] && (pp & (ctx_deny ? 2 : 1)))
        first_kp = min(first_kp, kp);
    }
    first_kp = warp_min(first_kp);
    last_valid = warp_max(last_valid);
    const bool exact0 = first_kp < ACS_BIG;
    const int src = exact0 ? min(max(first_kp, 0), v.KP - 1)
                           : min(max(last_valid, 0), v.KP - 1);
    const bool eval_deny = v.pol_eff_ctx[s * v.KP + src] == 2;
    const bool exact = exact0 && (!r.multi || v.multi_ok[s]);
    const int tm_bit = exact ? (eval_deny ? 2 : 1) : (eval_deny ? 8 : 4);

    // pass 2: rule combination per policy, folded into packed policy keys
    // (kp << 3 | effect << 1 | cacheable)
    int p_first_deny = ACS_BIG, p_first_permit = ACS_BIG;
    int p_first = ACS_BIG, p_last = -1, key0 = 0;
    for (int kp = lane; kp < v.KP; kp += 32) {
      const PolicySel q = scan_policy<WITH_HR, WITH_REL>(
          v, r, s * v.KP + kp, kp, set_gate, tm_bit, &abort_pos);
      const int p = s * v.KP + kp;
      const bool present = q.no_rules || q.last >= 0;
      const int payload = q.no_rules ? ((v.pol_effect[p] << 1) |
                                        (v.pol_cacheable[p] ? 1 : 0))
                                     : (q.sel & 7);
      if (kp == 0) key0 = payload;
      if (present) {
        const int pkey = (kp << 3) | payload;
        const int eff = payload >> 1;
        p_first = min(p_first, pkey);
        p_last = max(p_last, pkey);
        if (eff == 2) p_first_deny = min(p_first_deny, pkey);
        if (eff == 1) p_first_permit = min(p_first_permit, pkey);
      }
    }
    p_first_deny = warp_min(p_first_deny);
    p_first_permit = warp_min(p_first_permit);
    p_first = warp_min(p_first);
    p_last = warp_max(p_last);
    key0 = warp_max(lane == 0 ? key0 : 0);
    if (p_last >= 0) {  // the set contributes: last set wins
      const int ca = v.set_ca[s];
      const bool known = ca == 0 || ca == 1 || ca == 2;
      const int sel = known
          ? select_pos(ca, p_first_deny, p_first_permit, p_first, p_last)
          : key0;
      win_key = sel & 7;
      if (EXPLAIN) {
        win_s = s;
        win_kp = known ? min(max(sel >> 3, 0), v.KP - 1) : 0;
        win_gate = set_gate;
        win_tm = tm_bit;
      }
    }
  }
  abort_pos = warp_min(abort_pos);
  *decision = win_key >= 0 ? (win_key >> 1) & 3 : 0;
  *cacheable = win_key >= 0 ? win_key & 1 : -1;
  *status = 200;
  if (abort_pos < ACS_BIG) {
    *decision = 2;
    *cacheable = v.rule_cacheable_raw[abort_pos] ? 1 : 0;
    *status = r.cond_code[v.rule_cond[abort_pos]];
  }
  if (EXPLAIN && lane == 0) {
    const int32_t* orig = v.rule_orig_flat;
    *code = 0;
    if (win_s >= 0) {
      int ignored = ACS_BIG;
      const int win_flat = win_s * v.KP + win_kp;
      const PolicySel q = scan_policy<WITH_HR, WITH_REL>(
          v, r, win_flat, win_kp, win_gate, win_tm, &ignored);
      if (q.no_rules) {
        *code = explain_code(win_flat, 2);
      } else {
        // the winner's within-set position; >> is arithmetic, so a -1
        // "last" stays -1, as in JAX
        const int M = v.KP * v.KR;
        const int pos = win_s * M + (q.sel >> 3);
        *code = explain_code(
            orig ? orig[min(max(pos, 0), v.S * M - 1)] : pos, 1);
      }
    }
    if (abort_pos < ACS_BIG)
      *code = explain_code(orig ? orig[abort_pos] : abort_pos, 3);
  }
}

template <bool WITH_HR, bool WITH_REL, bool EXPLAIN>
__global__ void sig_decide_kernel(const DecArgs a) {
  const int slot = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const DecArgs v = group_view(a, a.slot_g[slot]);
  const int32_t* k = a.acl_consts;
  for (int j = warp; j < a.R; j += nwarps) {
    const int pos = slot * a.R + j;
    const int row = a.grid2row[pos];
    if (a.gp_orig[row] != pos) continue;  // a pad position (uniform per warp)
    const int32_t* w = a.mega_rows + (size_t)row * a.WROW;
    Row r;
    r.roles = w + a.O_ROLES;
    r.sub_ids = w + a.O_SUB_IDS;
    r.sub_vals = w + a.O_SUB_VALS;
    r.cond_true = w + a.O_COND_TRUE;
    r.cond_abort = w + a.O_COND_ABORT;
    r.cond_code = w + a.O_COND_CODE;
    const int n_ra = w[a.O_N_RA];
    r.ctx_ok = WITH_HR && w[a.O_CTX_PRESENT] != 0 && n_ra > 0;
    r.runs = WITH_HR ? w + a.O_OWN_RUNS : nullptr;
    r.bits = WITH_HR ? w + a.O_OWN_BITS : nullptr;
    r.rel_runs = WITH_REL ? w + a.O_REL_RUNS : nullptr;
    r.rel_bits = WITH_REL ? w + a.O_REL_BITS : nullptr;
    r.multi = w[a.O_N_ENT_ATTRS] > 1;
    const int id0 = w[a.O_ACT_IDS], val0 = w[a.O_ACT_VALS];
    const bool is_action = id0 == k[2];
    const bool crud = is_action && (val0 == k[3] || val0 == k[4] ||
                                    val0 == k[5] || val0 == k[6]);
    const int shortcut = w[a.O_ACL_SHORT];
    r.acl_row = shortcut == 1 || (shortcut == 0 && n_ra > 0 && crud);
    int decision, cacheable, status, code;
    decide_sig_row<WITH_HR, WITH_REL, EXPLAIN>(v, r, lane, &decision,
                                               &cacheable, &status, &code);
    if (lane == 0) {
      a.out_decision[row] = decision;
      a.out_cacheable[row] = cacheable;
      a.out_status[row] = status;
      if (EXPLAIN) a.out_explain[row] = code;
    }
  }
}

// one launch of the variant (with_hr, with_rel, explain)
template <bool... F>
struct SigLaunch {
  static int run(const DecArgs& da, int threads, cudaStream_t stream) {
    auto kernel = sig_decide_kernel<F...>;
    kernel<<<da.NSLOT, threads, 0, stream>>>(da);
    return (int)cudaGetLastError();
  }
};

extern "C" {

// "ptr,ptr,...|dim,dim,..." : the argument order, checked by the host
const char* acs_sig_decide_layout() {
  return SD_PTRS(ACS_NAME) "|" SD_DIMS(ACS_DIM_NAME);
}

// launches one block per slot on `stream`; returns cudaGetLastError()
// after the launch, or -1 when the argument counts do not match this build
// or a variant's inputs are missing
int acs_sig_decide(const int64_t* ptrs, int n_ptrs, const int32_t* dims,
                   int n_dims, int with_hr, int with_rel, int explain,
                   int threads, void* stream_ptr) {
  if (n_ptrs != kSdPtrs || n_dims != kSdDims) return -1;
  DecArgs da;
  DecArgs* a = &da;
  int i = 0;
  SD_PTRS(ACS_SET_PTR)
  i = 0;
  SD_DIMS(ACS_SET_DIM)
  if (da.NSLOT == 0) return 0;
  if ((with_hr || with_rel) && (da.rl_collect == nullptr || da.NR > MAX_NR))
    return -1;
  if (with_hr && (da.rl_op_hit == nullptr || da.NOP > MAX_NOP)) return -1;
  if (with_rel && (da.rl_rel_idx == nullptr || da.O_REL_RUNS < 0 ||
                   da.O_REL_BITS < 0))
    return -1;
  if (explain && da.out_explain == nullptr) return -1;
  const bool flags[3] = {with_hr != 0, with_rel != 0, explain != 0};
  return dispatch_flags<3, SigLaunch>(
      flags, da, threads, reinterpret_cast<cudaStream_t>(stream_ptr));
}

}  // extern "C"
