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
// What bounds it: every row tests all M = KP*KR rule positions of each set
// of its group's planes (~20 bytes of planes per position) with a subject
// fold and a few compares per position.  Counting every plane once, bytes
// bound it at the stress shapes, with the compares within 2x (PERF.md); the
// rows of a group share its planes, so what costs on the card is the
// per-(row, position) work and how much of it reads on-chip memory.
//
// Design: one 256-thread block per (slot, chunk of RB rows of the slot);
// warps take the chunk's real rows (pad grid positions, whose row does not
// map back to them through gp_orig, are dropped when the block lists its
// rows, so they never store).  A row's roles and subject pairs are loaded
// once into shared memory.  Per set:
//   pass 1: each warp, per row, lanes over the policies: the policy's
//     subject-folded match planes and its HR / relation subject pass, kept
//     as one byte per (row, policy) in shared memory (computed once, read
//     by pass 2), and the exact-match break (warp min/max) -> the row's set
//     gate and policy-plane bit;
//   pass 2, per tile of PT policies: the block stages the tile's rule
//     positions into shared memory as records (target role, condition,
//     flag bits; a transform of a dozen byte and int planes, so the threads
//     stage it between two barriers; the whole set is one tile at the
//     stress shapes) and, one ballot per 32 positions, as static bitsets
//     (reached with no subject test, role-gated, pair-gated, owner check,
//     relation check, condition, ACL-free, DENY, PERMIT).  Each warp then
//     takes a row: lanes over RULE positions, 32 at a time, test only what
//     the row decides (its roles against a role-gated rule's, its pairs,
//     owner and relation bitplanes, conditions, the ACL short path), and two
//     ballots per 32 positions leave the row's collected and aborting
//     rules as bitsets; then lanes over policies read each policy's first
//     selected rule (its algorithm's DENY / PERMIT / any mask) and last
//     collected rule from its window of KR bits (a segmented reduction by
//     bit scan), form its packed key and fold it into the set's keys.
// The set's keys are 64-bit: (kp << 3 | effect << 1 | cacheable) << 32 |
// the policy's own rule selection, so the explain variant reads the
// winning rule from the key the set reduction selected (no second walk),
// and the explain-off variant carries 0 there.  Aborts count only in
// policies in scope, as the walk did; after the last set the row's first
// lane stores the outputs at the row's original position.
//
// Explain mode (the EXPLAIN template flag; the JAX package's
// _combine_and_decide_flat recovery, ops/kernel.py:920-944): the winner's
// within-set position is the selected key >> 3 (a -1 "last" stays -1, as
// JAX shifts it), mapped through the group's rule_orig_flat (clamped, as JAX
// clips the take) to the uncompacted tree; an unknown set algorithm selects
// policy 0 with policy 0's own selection.  The fourth output is the
// provenance code (flat_pos << 2) | kind of srv/explain.py.

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

// RB: rows of a slot per block; PT: policies per staged rule tile
#define SD_DIMS(X)                                                           \
  X(NSLOT) X(R) X(S) X(KP) X(KR) X(KS) X(NR) X(NOP) X(WROW) X(NSUB)          \
  X(NROLE) X(NACT) X(NRU) X(NWORDS) X(NRU_REL) X(NWORDS_REL) X(C)          \
  X(O_SUB_IDS) X(O_SUB_VALS) X(O_ROLES) X(O_ACT_IDS) X(O_ACT_VALS)           \
  X(O_N_ENT_ATTRS) X(O_N_RA) X(O_ACL_SHORT) X(O_CTX_PRESENT) X(O_OWN_RUNS)   \
  X(O_OWN_BITS) X(O_REL_RUNS) X(O_REL_BITS) X(O_COND_TRUE) X(O_COND_ABORT)   \
  X(O_COND_CODE) X(NEEDS_PAIRS) X(RB) X(PT)

struct DecArgs {
  SD_PTRS(ACS_FIELD)
  SD_DIMS(ACS_DIM_FIELD)
};

static const int kSdPtrs = 0 SD_PTRS(ACS_COUNT);
static const int kSdDims = 0 SD_DIMS(ACS_COUNT);

// threads per block (the host passes it; the kernel is built for it)
#define SD_THREADS 256
// resident blocks per SM the register allocation is held to
#define SD_MIN_BLOCKS 4

// one request row, unpacked from its packed int32 columns (roles and
// subject pairs from the block's shared copy)
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

// flag bits of a staged rule record
enum : uint16_t {
  RF_VALID = 1, RF_HAS_T = 2, RF_MATCH = 4, RF_HAS_ROLE = 8, RF_NO_SUB = 16,
  RF_SKIP = 32, RF_CACH = 256, RF_TRIV = 512, RF_HRCHK = 1024, RF_REL = 2048,
  RF_RELDIR = 4096
};
#define RF_EFF(fl) (((fl) >> 6) & 3)
// the pass-1 byte per (row, policy): the four folded planes, then the
// policy's subject pass
#define PB_SUBJECT 16

// the tile's static bitsets over its rule positions (bit i of word i / 32):
// reached with no per-row subject test, reached when the row holds the
// rule's role, reached when the row holds the rule's subject pairs, owner
// check (HR), relation check, condition, ACL-free (no target or skip),
// DENY, PERMIT
enum { SB_FREE, SB_ROLE, SB_PAIRS, SB_HR, SB_REL, SB_COND, SB_ACL, SB_E2,
       SB_E1, SB_N };

// the set-level keys' neutral minimum ((ACS_BIG << 32), above every key)
#define SD_BIGKEY (((long long)ACS_BIG) << 32)

// one row's state in shared memory
struct SigRowState {
  long long fd, fp, f, last;  // the current set's policy keys
  int row;                    // source row
  int abort;                  // first aborting rule (group flat), ACS_BIG
  int gate;                   // current set: set_gate | plane bit << 1
  int key0;                   // the current set's policy 0 payload
  unsigned info0;             // ... and its rule selection
  int win_key;                // effect << 1 | cacheable of the last set
  int win_s, win_kp;          // explain: that set and its policy
  unsigned win_info;          // ... and the policy's rule selection
  int flags;                  // ctx_ok | acl_row << 1 | multi << 2
};

struct SigSmem {
  size_t count, state, roles, pairs, rowpol, rrole, rcond, rflags, sbits,
      wbits, total;
  int words;  // bitset words of a tile (one spare past the last position)
};

// dynamic shared memory of one block; the host sizes the launch with the
// same function the kernel carves the buffer with
__host__ __device__ inline SigSmem sig_smem(const DecArgs& a, int nwarps) {
  SigSmem l;
  const size_t P = (size_t)a.PT * a.KR;
  l.words = (int)((P + 31) / 32) + 1;
  size_t off = 0;
  l.count = off;  // int32: the block's real rows
  off += 16;
  l.state = off;  // SigRowState [RB]
  off += sizeof(SigRowState) * a.RB;
  l.roles = off;  // int32 [RB * NROLE]
  off += sizeof(int32_t) * a.RB * a.NROLE;
  l.pairs = off;  // int32 [RB * 2 * NSUB]: ids then values, per row
  if (a.NEEDS_PAIRS) off += sizeof(int32_t) * a.RB * 2 * a.NSUB;
  off = align_up(off, 16);
  l.rrole = off;  // int32 [PT * KR]: the tile's rule target roles
  off += sizeof(int32_t) * P;
  l.rcond = off;  // int32 [PT * KR]: their conditions
  off += sizeof(int32_t) * P;
  l.sbits = off;  // uint32 [SB_N * words]: the tile's static bitsets
  off += sizeof(uint32_t) * SB_N * l.words;
  l.wbits = off;  // uint32 [nwarps * 2 * words]: a warp's row bitsets
  off += sizeof(uint32_t) * nwarps * 2 * l.words;
  l.rflags = off;  // uint16 [PT * KR]: their RF_* bits
  off += sizeof(uint16_t) * P;
  l.rowpol = off;  // uint8 [RB * KP]: pass 1's byte per (row, policy)
  off += (size_t)a.RB * a.KP;
  l.total = align_up(off, 16);
  return l;
}

__device__ __forceinline__ long long warp_min64(long long v) {
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ long long warp_max64(long long v) {
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// bits [start, start + n) (n <= 32) of a bitset, bit 0 first; the word
// past the last position is readable (a spare)
__device__ __forceinline__ uint32_t bit_window(const uint32_t* words,
                                               int start, int n) {
  const int w = start >> 5, o = start & 31;
  uint32_t v = words[w] >> o;
  if (o != 0 && o + n > 32) v |= words[w + 1] << (32 - o);
  return n == 32 ? v : (v & ((1u << n) - 1u));
}

// row j of the block: the shared roles / pairs and the packed row's columns
__device__ __forceinline__ Row make_row(const DecArgs& a,
                                        const SigRowState& st,
                                        const int32_t* roles,
                                        const int32_t* pairs, int j) {
  const int32_t* w = a.mega_rows + (size_t)st.row * a.WROW;
  Row r;
  r.roles = roles + (size_t)j * a.NROLE;
  r.sub_ids = pairs + (size_t)j * 2 * a.NSUB;
  r.sub_vals = r.sub_ids + a.NSUB;
  r.cond_true = w + a.O_COND_TRUE;
  r.cond_abort = w + a.O_COND_ABORT;
  r.cond_code = w + a.O_COND_CODE;
  r.runs = w + a.O_OWN_RUNS;
  r.bits = w + a.O_OWN_BITS;
  r.rel_runs = w + a.O_REL_RUNS;
  r.rel_bits = w + a.O_REL_BITS;
  r.ctx_ok = st.flags & 1;
  r.acl_row = st.flags & 2;
  r.multi = st.flags & 4;
  return r;
}

// pass 1 of set s for one row, by one warp: the pass-1 bytes of every
// policy and the row's set gate and policy-plane bit (lane 0 resets the
// set's keys)
template <bool WITH_HR, bool WITH_REL>
__device__ void pass1(const DecArgs& v, const Row& r, int s, int lane,
                      uint8_t* rowpol, SigRowState* st) {
  int first_kp = ACS_BIG, last_valid = -1;
  for (int kp = lane; kp < v.KP; kp += 32) {
    const int p = s * v.KP + kp;
    const int pp = policy_planes(v, r, p);
    bool pol_subject = true;
    if (WITH_HR && v.pol_has_subjects[p])
      pol_subject = hr_pass(v, r, v.pl_triv[p], v.pl_rs[p], v.pl_hrchk[p],
                            v.pl_collect + (size_t)p * v.NR,
                            v.pl_op_hit + (size_t)p * v.NOP);
    if (WITH_REL && pol_subject && v.pol_has_subjects[p])
      pol_subject = rel_pass(v, r, v.pl_rel_idx[p], v.pl_rel_dir[p],
                             v.pl_collect + (size_t)p * v.NR);
    rowpol[kp] = (uint8_t)(pp | (pol_subject ? PB_SUBJECT : 0));
    if (!v.pol_valid[p]) continue;
    last_valid = kp;
    const bool ctx_deny = v.pol_eff_ctx[p] == 2;
    if (v.pol_has_target[p] && (pp & (ctx_deny ? 2 : 1)))
      first_kp = min(first_kp, kp);
  }
  first_kp = warp_min(first_kp);
  last_valid = warp_max(last_valid);
  if (lane != 0) return;
  const bool sl_sub = sub_fold(v, r, v.sl_n_sub[s], v.sl_has_role[s],
                               v.sl_role[s], v.sl_sub_ids + (size_t)s * v.KS,
                               v.sl_sub_vals + (size_t)s * v.KS);
  const bool set_gate = (!v.set_has_target[s] || (v.ss_ex_p[s] && sl_sub)) &&
                        v.set_valid[s];
  const bool exact0 = first_kp < ACS_BIG;
  const int src = exact0 ? min(max(first_kp, 0), v.KP - 1)
                         : min(max(last_valid, 0), v.KP - 1);
  const bool eval_deny = v.pol_eff_ctx[s * v.KP + src] == 2;
  const bool exact = exact0 && (!r.multi || v.multi_ok[s]);
  const int tm_bit = exact ? (eval_deny ? 2 : 1) : (eval_deny ? 8 : 4);
  st->gate = (set_gate ? 1 : 0) | (tm_bit << 1);
  st->fd = SD_BIGKEY;
  st->fp = SD_BIGKEY;
  st->f = SD_BIGKEY;
  st->last = -1;
  st->key0 = 0;
  st->info0 = 0;
}

// the block stages rule positions [kp0, kp0 + npt) x KR of set s: the
// records, then the static bitsets, one ballot per word and bitset
template <bool WITH_HR, bool WITH_REL>
__device__ void stage_rules(const DecArgs& v, int s, int kp0, int npt,
                            const SigSmem& L, unsigned char* smem) {
  int32_t* rrole = reinterpret_cast<int32_t*>(smem + L.rrole);
  int32_t* rcond = reinterpret_cast<int32_t*>(smem + L.rcond);
  uint16_t* rflags = reinterpret_cast<uint16_t*>(smem + L.rflags);
  uint32_t* sb = reinterpret_cast<uint32_t*>(smem + L.sbits);
  const size_t base = ((size_t)s * v.KP + kp0) * v.KR;
  const int P = npt * v.KR;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const size_t q = base + i;
    uint32_t fl = (v.rule_valid[q] ? RF_VALID : 0) |
                  (v.rule_has_target[q] ? RF_HAS_T : 0) |
                  ((v.rl_ex[q] || v.rl_rg[q]) ? RF_MATCH : 0) |
                  (v.rl_has_role[q] ? RF_HAS_ROLE : 0) |
                  (v.rl_n_sub[q] == 0 ? RF_NO_SUB : 0) |
                  (v.rl_skip[q] ? RF_SKIP : 0) |
                  ((uint32_t)(v.rule_effect[q] & 3) << 6) |
                  (v.rule_cacheable_eff[q] ? RF_CACH : 0);
    if (WITH_HR)
      fl |= (v.rl_triv[q] ? RF_TRIV : 0) | (v.rl_hrchk[q] ? RF_HRCHK : 0);
    if (WITH_REL)
      fl |= (v.rl_rel_idx[q] >= 0 ? RF_REL : 0) |
            (v.rl_rel_dir[q] ? RF_RELDIR : 0);
    rrole[i] = v.rl_role[q];
    rcond[i] = v.rule_cond[q];
    rflags[i] = (uint16_t)fl;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int w = threadIdx.x >> 5; w < L.words; w += blockDim.x >> 5) {
    const int i = w * 32 + lane;
    const uint32_t fl = i < P ? rflags[i] : 0;
    const bool live = (fl & RF_VALID) && (!(fl & RF_HAS_T) || (fl & RF_MATCH));
    const bool gated = live && (fl & RF_HAS_T) && !(fl & RF_NO_SUB);
    // the subject fold of a target's rule: n_sub == 0, else its role, else
    // (with subject pairs in the tree and no role) its pairs
    const bool by_pairs = gated && v.NEEDS_PAIRS && !(fl & RF_HAS_ROLE);
    const bool pred[SB_N] = {
        live && !gated, gated && !by_pairs, by_pairs,
        WITH_HR && live && (fl & RF_HAS_T) && !(fl & RF_TRIV),
        WITH_REL && live && (fl & RF_HAS_T) && (fl & RF_REL),
        live && v.C > 0 && i < P && rcond[i] >= 0,
        !(fl & RF_HAS_T) || (fl & RF_SKIP),
        RF_EFF(fl) == 2, RF_EFF(fl) == 1};
    for (int k = 0; k < SB_N; ++k) {
      const uint32_t word = __ballot_sync(0xffffffffu, pred[k]);
      if (lane == 0) sb[k * L.words + w] = word;
    }
  }
}

// pass 2 of one row over a staged tile (set s, policies kp0 .. kp0 + npt),
// by one warp: lanes over rule positions build the row's collected and
// aborting bitsets (one ballot each per 32 positions), then lanes over
// policies read each policy's first selected and last collected rule from
// its window of KR bits; the set's keys merge into the row's state (lane 0)
template <bool WITH_HR, bool WITH_REL, bool EXPLAIN>
__device__ void scan_tile(const DecArgs& v, const Row& r, int s, int kp0,
                          int npt, const SigSmem& L,
                          const unsigned char* smem, uint32_t* coll,
                          uint32_t* abt, const uint8_t* rowpol,
                          SigRowState* st, int lane) {
  const int32_t* rrole = reinterpret_cast<const int32_t*>(smem + L.rrole);
  const int32_t* rcond = reinterpret_cast<const int32_t*>(smem + L.rcond);
  const uint16_t* rflags =
      reinterpret_cast<const uint16_t*>(smem + L.rflags);
  const uint32_t* sb = reinterpret_cast<const uint32_t*>(smem + L.sbits);
  const int KR = v.KR, W = L.words;
  const size_t base = ((size_t)s * v.KP + kp0) * KR;
  const uint32_t bit = 1u << lane;
  for (int w = 0; w < W; ++w) {
    if ((sb[SB_FREE * W + w] | sb[SB_ROLE * W + w] | sb[SB_PAIRS * W + w]) ==
        0) {  // no position of the word can be reached
      if (lane == 0) coll[w] = abt[w] = 0;
      continue;
    }
    const int i = w * 32 + lane;
    const size_t q = base + i;
    bool reached = sb[SB_FREE * W + w] & bit;
    if (!reached && (sb[SB_ROLE * W + w] & bit)) {
      const int role = rrole[i];
      for (int j = 0; j < v.NROLE; ++j)
        reached |= r.roles[j] >= 0 && r.roles[j] == role;
    }
    if (!reached && (sb[SB_PAIRS * W + w] & bit))
      reached = sub_fold(v, r, 1, false, rrole[i], v.rl_sub_ids + q * v.KS,
                         v.rl_sub_vals + q * v.KS);
    if (WITH_HR && reached && (sb[SB_HR * W + w] & bit))
      reached = hr_pass(v, r, false, v.rl_rs[q], rflags[i] & RF_HRCHK,
                        v.rl_collect + q * v.NR, v.rl_op_hit + q * v.NOP);
    if (WITH_REL && reached && (sb[SB_REL * W + w] & bit))
      reached = rel_pass(v, r, v.rl_rel_idx[q], rflags[i] & RF_RELDIR,
                         v.rl_collect + q * v.NR);
    bool aborts = false;
    if (reached && (sb[SB_COND * W + w] & bit)) {
      const int ci = rcond[i];
      aborts = r.cond_abort[ci] != 0;
      reached = !aborts && r.cond_true[ci] != 0;
    }
    if (reached && !r.acl_row && !(sb[SB_ACL * W + w] & bit))
      reached = false;
    const uint32_t cw = __ballot_sync(0xffffffffu, reached);
    const uint32_t aw = __ballot_sync(0xffffffffu, aborts);
    if (lane == 0) {
      coll[w] = cw;
      abt[w] = aw;
    }
  }
  __syncwarp();

  const bool set_gate = st->gate & 1;
  const int tm_bit = st->gate >> 1;
  long long fd = SD_BIGKEY, fp = SD_BIGKEY, f = SD_BIGKEY, last = -1;
  int abort_pos = ACS_BIG;
  for (int kpl = lane; kpl < npt; kpl += 32) {
    const int kp = kp0 + kpl;
    const int p = s * v.KP + kp;
    const int pc = rowpol[kp];
    const bool pv = v.pol_valid[p];
    const bool pol_gate = (!v.pol_has_target[p] || (pc & tm_bit)) && pv;
    const bool pol_subject = pc & PB_SUBJECT;
    const int ca = v.pol_ca[p];
    // each policy's first selected rule (by its algorithm) and last
    // collected rule, as rule slots; its first aborting rule
    int prim_kr = ACS_BIG, last_kr = -1;
    if (set_gate && pol_gate) {
      int abort_kr = ACS_BIG;
      for (int c0 = 0; c0 < KR; c0 += 32) {
        const int n = min(32, KR - c0), at = kpl * KR + c0;
        const uint32_t am = bit_window(abt, at, n);
        if (am != 0 && abort_kr == ACS_BIG) abort_kr = c0 + __ffs((int)am) - 1;
        const uint32_t cm = pol_subject ? bit_window(coll, at, n) : 0u;
        const uint32_t pm =
            ca == 0 ? (cm & bit_window(sb + SB_E2 * W, at, n))
                    : (ca == 1 ? (cm & bit_window(sb + SB_E1 * W, at, n))
                               : (ca == 2 ? cm : 0u));
        if (pm != 0 && prim_kr == ACS_BIG) prim_kr = c0 + __ffs((int)pm) - 1;
        if (cm != 0) last_kr = c0 + 31 - __clz((int)cm);
      }
      if (abort_kr < ACS_BIG) abort_pos = min(abort_pos, p * KR + abort_kr);
    }
    // the policy's packed key (position kp * KR + kr << 3 | effect << 1 |
    // cacheable) its combining algorithm selects: an unknown algorithm
    // selects key 0, as the flat JAX combine does
    auto key = [&](int kr) {
      const uint32_t fl = rflags[kpl * KR + kr];
      return ((kp * KR + kr) << 3) | (RF_EFF(fl) << 1) |
             ((fl & RF_CACH) ? 1 : 0);
    };
    int sel;
    if (ca == 0 || ca == 1)
      sel = prim_kr < ACS_BIG ? key(prim_kr) : (last_kr >= 0 ? key(last_kr) : -1);
    else if (ca == 2)
      sel = prim_kr < ACS_BIG ? key(prim_kr) : ACS_BIG;
    else
      sel = 0;
    const bool no_rules = pv && set_gate && pol_gate &&
                          v.pol_n_rules[p] == 0 && v.pol_effect[p] > 0;
    const bool present = no_rules || last_kr >= 0;
    const int payload = no_rules ? ((v.pol_effect[p] << 1) |
                                    (v.pol_cacheable[p] ? 1 : 0))
                                 : (sel & 7);
    // the policy's own selection: the within-set position (sel >> 3, a -1
    // "last" stays -1) + 1, or bit 31 when its own effect decides
    const uint32_t info =
        EXPLAIN ? (no_rules ? 0x80000000u : (uint32_t)((sel >> 3) + 1)) : 0u;
    if (kp == 0) {
      st->key0 = payload;
      st->info0 = info;
    }
    if (present) {
      const long long k =
          ((long long)((kp << 3) | payload) << 32) | (long long)info;
      const int eff = payload >> 1;
      f = min(f, k);
      last = max(last, k);
      if (eff == 2) fd = min(fd, k);
      if (eff == 1) fp = min(fp, k);
    }
  }
  fd = warp_min64(fd);
  fp = warp_min64(fp);
  f = warp_min64(f);
  last = warp_max64(last);
  abort_pos = warp_min(abort_pos);
  if (lane == 0) {
    st->fd = min(st->fd, fd);
    st->fp = min(st->fp, fp);
    st->f = min(st->f, f);
    st->last = max(st->last, last);
    st->abort = min(st->abort, abort_pos);
  }
  __syncwarp();  // the row bitsets are read before the next row's writes
}

// after set s: the set's combining algorithm over its policy keys; a
// contributing set replaces the row's winner (last set wins)
__device__ __forceinline__ void finish_set(const DecArgs& v, int s,
                                           SigRowState* st) {
  if (st->last < 0) return;
  const int ca = v.set_ca[s];
  if (ca == 0 || ca == 1 || ca == 2) {
    const long long k =
        ca == 0 ? (st->fd < SD_BIGKEY ? st->fd : st->last)
                : (ca == 1 ? (st->fp < SD_BIGKEY ? st->fp : st->last) : st->f);
    const int pkey = (int)(k >> 32);
    st->win_key = pkey & 7;
    st->win_kp = min(max(pkey >> 3, 0), v.KP - 1);
    st->win_info = (uint32_t)k;
  } else {
    st->win_key = st->key0 & 7;
    st->win_kp = 0;
    st->win_info = st->info0;
  }
  st->win_s = s;
}

template <bool WITH_HR, bool WITH_REL, bool EXPLAIN>
__global__ void __launch_bounds__(SD_THREADS, SD_MIN_BLOCKS)
    sig_decide_kernel(const DecArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const SigSmem L = sig_smem(a, nwarps);
  int32_t* count = reinterpret_cast<int32_t*>(smem + L.count);
  SigRowState* st = reinterpret_cast<SigRowState*>(smem + L.state);
  int32_t* roles = reinterpret_cast<int32_t*>(smem + L.roles);
  int32_t* pairs = reinterpret_cast<int32_t*>(smem + L.pairs);
  uint8_t* rowpol = smem + L.rowpol;
  uint32_t* coll = reinterpret_cast<uint32_t*>(smem + L.wbits) +
                   (size_t)warp * 2 * L.words;
  uint32_t* abt = coll + L.words;
  const int nsplit = (a.R + a.RB - 1) / a.RB;
  const int slot = blockIdx.x / nsplit;
  const int j0 = (blockIdx.x % nsplit) * a.RB;
  const DecArgs v = group_view(a, a.slot_g[slot]);

  // the chunk's real rows (a pad position's row maps to another position)
  if (tid == 0) {
    int n = 0;
    for (int j = j0; j < min(a.R, j0 + a.RB); ++j) {
      const int pos = slot * a.R + j;
      const int row = a.grid2row[pos];
      if (a.gp_orig[row] == pos) st[n++].row = row;
    }
    *count = n;
  }
  __syncthreads();
  const int n = *count;
  const int32_t* k = a.acl_consts;
  for (int j = tid; j < n; j += blockDim.x) {
    const int32_t* w = a.mega_rows + (size_t)st[j].row * a.WROW;
    const int n_ra = w[a.O_N_RA];
    const int id0 = w[a.O_ACT_IDS], val0 = w[a.O_ACT_VALS];
    const bool is_action = id0 == k[2];
    const bool crud = is_action && (val0 == k[3] || val0 == k[4] ||
                                    val0 == k[5] || val0 == k[6]);
    const int shortcut = w[a.O_ACL_SHORT];
    const bool ctx_ok = WITH_HR && w[a.O_CTX_PRESENT] != 0 && n_ra > 0;
    const bool acl_row = shortcut == 1 || (shortcut == 0 && n_ra > 0 && crud);
    st[j].flags = (ctx_ok ? 1 : 0) | (acl_row ? 2 : 0) |
                  (w[a.O_N_ENT_ATTRS] > 1 ? 4 : 0);
    st[j].abort = ACS_BIG;
    st[j].win_key = -1;
    st[j].win_s = -1;
    st[j].win_kp = 0;
    st[j].win_info = 0;
  }
  for (int x = tid; x < n * a.NROLE; x += blockDim.x)
    roles[x] = a.mega_rows[(size_t)st[x / a.NROLE].row * a.WROW + a.O_ROLES +
                           x % a.NROLE];
  if (a.NEEDS_PAIRS) {
    for (int x = tid; x < n * 2 * a.NSUB; x += blockDim.x) {
      const int j = x / (2 * a.NSUB), c = x % (2 * a.NSUB);
      const int col = c < a.NSUB ? a.O_SUB_IDS + c : a.O_SUB_VALS + c - a.NSUB;
      pairs[x] = a.mega_rows[(size_t)st[j].row * a.WROW + col];
    }
  }
  __syncthreads();

  for (int s = 0; s < a.S; ++s) {
    for (int j = warp; j < n; j += nwarps)
      pass1<WITH_HR, WITH_REL>(v, make_row(a, st[j], roles, pairs, j), s,
                               lane, rowpol + (size_t)j * a.KP, &st[j]);
    for (int kp0 = 0; kp0 < a.KP; kp0 += a.PT) {
      const int npt = min(a.PT, a.KP - kp0);
      __syncthreads();  // the previous tile's readers are done
      stage_rules<WITH_HR, WITH_REL>(v, s, kp0, npt, L, smem);
      __syncthreads();
      for (int j = warp; j < n; j += nwarps)
        scan_tile<WITH_HR, WITH_REL, EXPLAIN>(
            v, make_row(a, st[j], roles, pairs, j), s, kp0, npt, L, smem,
            coll, abt, rowpol + (size_t)j * a.KP, &st[j], lane);
    }
    __syncthreads();  // every row's keys of the set are in
    for (int j = warp; j < n; j += nwarps)
      if (lane == 0) finish_set(v, s, &st[j]);
  }

  // the outputs at each row's original position
  for (int j = warp; j < n; j += nwarps) {
    if (lane != 0) continue;
    const SigRowState& q = st[j];
    const Row r = make_row(a, q, roles, pairs, j);
    int decision = q.win_key >= 0 ? (q.win_key >> 1) & 3 : 0;
    int cacheable = q.win_key >= 0 ? q.win_key & 1 : -1;
    int status = 200;
    if (q.abort < ACS_BIG) {
      decision = 2;
      cacheable = v.rule_cacheable_raw[q.abort] ? 1 : 0;
      status = r.cond_code[v.rule_cond[q.abort]];
    }
    a.out_decision[q.row] = decision;
    a.out_cacheable[q.row] = cacheable;
    a.out_status[q.row] = status;
    if (EXPLAIN) {
      const int32_t* orig = v.rule_orig_flat;
      int code = 0;
      if (q.win_s >= 0) {
        if (q.win_info >> 31) {
          code = explain_code(q.win_s * v.KP + q.win_kp, 2);
        } else {
          const int M = v.KP * v.KR;
          const int pos = q.win_s * M + ((int)q.win_info - 1);
          code = explain_code(
              orig ? orig[min(max(pos, 0), v.S * M - 1)] : pos, 1);
        }
      }
      if (q.abort < ACS_BIG)
        code = explain_code(orig ? orig[q.abort] : q.abort, 3);
      a.out_explain[q.row] = code;
    }
  }
}

// one launch of the variant (with_hr, with_rel, explain)
template <bool... F>
struct SigLaunch {
  static int run(const DecArgs& da, int threads, cudaStream_t stream) {
    auto kernel = sig_decide_kernel<F...>;
    const size_t smem = sig_smem(da, threads / 32).total;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const int nsplit = (da.R + da.RB - 1) / da.RB;
    kernel<<<da.NSLOT * nsplit, threads, smem, stream>>>(da);
    return (int)cudaGetLastError();
  }
};

// resident blocks per SM of the variant at these shapes
template <bool... F>
struct SigOccupancy {
  static int run(const DecArgs& da, int threads, int* blocks) {
    auto kernel = sig_decide_kernel<F...>;
    const size_t smem = sig_smem(da, threads / 32).total;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, threads, smem);
  }
};

// fills `da` from the host's pointer and shape arrays; false when the
// counts differ from this build's
static bool fill_sig(DecArgs* a, const int64_t* ptrs, int n_ptrs,
                     const int32_t* dims, int n_dims) {
  if (n_ptrs != kSdPtrs || n_dims != kSdDims) return false;
  int i = 0;
  SD_PTRS(ACS_SET_PTR)
  i = 0;
  SD_DIMS(ACS_SET_DIM)
  return a->RB > 0 && a->PT > 0;
}

extern "C" {

// "ptr,ptr,...|dim,dim,..." : the argument order, checked by the host
const char* acs_sig_decide_layout() {
  return SD_PTRS(ACS_NAME) "|" SD_DIMS(ACS_DIM_NAME);
}

// dynamic shared memory bytes a launch needs (-1 on an argument mismatch)
long long acs_sig_decide_smem(const int32_t* dims, int n_dims, int threads) {
  if (n_dims != kSdDims) return -1;
  DecArgs da = {};
  DecArgs* a = &da;
  int i = 0;
  SD_DIMS(ACS_SET_DIM)
  return (long long)sig_smem(da, threads / 32).total;
}

// launches one block per (slot, chunk of RB rows) on `stream`; returns
// cudaGetLastError() after the launch, or -1 when the argument counts do
// not match this build or a variant's inputs are missing
int acs_sig_decide(const int64_t* ptrs, int n_ptrs, const int32_t* dims,
                   int n_dims, int with_hr, int with_rel, int explain,
                   int threads, void* stream_ptr) {
  DecArgs da;
  if (!fill_sig(&da, ptrs, n_ptrs, dims, n_dims)) return -1;
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

// resident blocks per SM of a variant at these shapes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), -1 on a mismatch
int acs_sig_decide_occupancy(const int64_t* ptrs, int n_ptrs,
                             const int32_t* dims, int n_dims, int with_hr,
                             int with_rel, int explain, int threads) {
  DecArgs da;
  if (!fill_sig(&da, ptrs, n_ptrs, dims, n_dims)) return -1;
  int blocks = 0;
  const bool flags[3] = {with_hr != 0, with_rel != 0, explain != 0};
  const int err = dispatch_flags<3, SigOccupancy>(flags, da, threads,
                                                  &blocks);
  return err != 0 ? -1 : blocks;
}

}  // extern "C"
