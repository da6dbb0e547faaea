// Device code of the rows program for Hopper (sm_90a): one thread block
// per RT request rows against one set of tables shared by every row.
//
// decide_dense.cu (K1, and K6 on each rank's row slice) and both modes of
// shard_chunk.cu (K7's `rule_chunk`, K8's `set_chunk`) run it;
// decide_grouped.cu (K4) shares its stage helpers (the first half of this
// file, written for K4: the folded per-target program, the ACL masks,
// stage D per (row, set), the staged rule tiles and bit windows of stage
// E, stage F per (row, set)).  The plain PyTorch versions the programs are
// held against: ops/kernel_ref.py decide_dense_ref and ops/shard_ref.py
// rule_chunk_ref and set_chunk_ref.
//
// What bounds it: integer compares.  Every row meets every target row of
// the table (a thousand at K8's shard shapes) and every rule position,
// so the card's limits are how much per-(row, target) work is done, how
// often the shared tables are fetched, and how much of a block waits at
// barriers.
//
// Design (rows_program): the grid maps request rows directly, RT rows per
// block (the host picks RT from the batch size, the SM count and shared
// memory, so a small batch still spreads over the card).  Each row's
// roles, subject and action pairs and whether it carries ACL instances
// are staged in shared memory once per block, and every per-row result
// stays there:
//   Stages A-C over (row, target) pairs: the block's target bits start at
//     0 (16-byte stores).  A pair whose subject or action test fails has
//     no match bit, and then nothing reads its HR or ACL bits (a rule is
//     reached, and a policy gated, only through a match bit; a policy
//     with subjects always has a target), so 0 is its answer.  One pass,
//     one thread per target (and share of the rows, when the table has
//     fewer targets than the block threads), reads the target's subject
//     fields once into registers and drops it at once when its role is in
//     no row of the block (a 1,024-bit mask of the rows' roles); otherwise
//     it tests the target against each row's staged roles, subject and
//     action pairs.  The pairs that pass go to a work list and run the
//     whole folded program (grouped_target_bits) densely after the pass
//     (a thread that finds the list full folds its pair at once).  The
//     rows that carry ACL instances build their masks first, all at once;
//     other rows never do.
//   Stage D: one warp per (row, set).
//   Stage E, per staged tile of PT policies (records plus DENY / PERMIT /
//     valid bitsets): warps over words of 32 rule positions, each lane's
//     record read once, then for each row two ballots leave the row's
//     collected and aborting rules as bitsets; then threads over (row,
//     policy) pairs read each policy's first
//     selected and last collected rule from its window of KR bits and
//     write the contribution (in explain mode with the selected rule slot
//     and the no-rules flag beside it), the first aborting rule by
//     atomicMin per row.  Every warp works on every policy, however few
//     the policies and rows are.
//   Stage F: one warp per (row, set), last-set-wins by atomicMax per row.
//   Stage G: one thread per row: the decision outputs (ROW_DENSE) or the
//     merge row of a set chunk (ROW_SET_CHUNK: the negated last-set key,
//     in explain mode the negated provenance key, the abort slots).
// ROW_RULE_CHUNK (a rule shard's chunk: its policies are partial, so no
// set can be combined here) runs stages A-E as above, but the threads over
// (row, policy) pairs write each policy's five packed keys straight into
// the row's merge row (rows_rule_keys), and stage G writes only the abort
// slots: no contribution bytes, no stage F.
// Explain mode reads the winning set's policy and that policy's selected
// rule from what stages E and F kept; nothing is walked twice.

#pragma once

#include <mutex>

#include "decide_core.cuh"

// (row, target) pairs per round of stages A-C: the pairs of a round that
// need the stage-A components go to a work list of this many entries
#define GR_ROUND 4096

// bytes of one staged rule record: target, condition, flag byte
#define GR_RULE_BYTES 9
// bitset words over `p` staged rule positions (one spare past the last)
__host__ __device__ inline int gr_words(int p) { return (p + 31) / 32 + 1; }
// flag byte of a rule record
enum : uint8_t { GF_VALID = 1, GF_CACH = 8 };
#define GF_EFF(fl) (((fl) >> 1) & 3)

// stages A-C for target row t (row b): the six match bits (TB_*; TB_HR
// carries the HR check ANDed with the relation-path fold), with the
// stage-A components (entity runs, operations, properties) folded only
// where they can change the bits: under a passing subject and action
// test, or for the collection state an HR or relation-path check reads.
// Elsewhere the four match bits are 0 either way, so a target whose role
// the row lacks costs a few compares.
template <bool WITH_ACL, bool WITH_HR, bool WITH_REL>
__device__ uint8_t grouped_target_bits(const Args& a, int b, int t,
                                       const uint64_t* elig,
                                       const uint64_t* same) {
  // ---- subject matching
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
  const bool need_hr = WITH_HR && n_subjects != 0 && a.t_has_scoping[t];
  const int rel_idx = WITH_REL ? a.t_rel_idx[t] : -1;
  const bool need_collect = need_hr || rel_idx >= 0;
  uint8_t bits = 0;
  TargetComp comp;
  comp.collect = 0;
  comp.op_hit = 0;
  if (need_collect ||
      (sub_ok && pairs_subset(a.t_act_ids + t * a.KA, a.t_act_vals + t * a.KA,
                              a.KA, a.r_act_ids + (size_t)b * a.NACT,
                              a.r_act_vals + (size_t)b * a.NACT, a.NACT))) {
    comp = target_components(a, b, t, need_collect);
    if (sub_ok && (comp.bits & TC_ACT))
      bits = comp.bits & (TB_EX_P | TB_EX_D | TB_RG_P | TB_RG_D);
  }

  // ---- stage B: HR scopes from the host-packed owner bitplanes
  bool hr = true;
  if (need_hr) {
    const bool ctx_ok = a.r_ctx_present[b] && a.r_n_ra[b] > 0;
    hr = ctx_ok && !hr_bad(a.r_own_bits + (size_t)b * a.NWORDS,
                           a.r_own_runs + (size_t)b * a.NRU, a.NRU, a.NOP,
                           a.NR, a.t_rs_idx[t], a.t_hr_check[t],
                           comp.collect, comp.op_hit);
  }
  if (hr && rel_idx >= 0) {
    hr = !hr_bad(a.r_rel_bits + (size_t)b * a.NWORDS_REL,
                 a.r_rel_runs + (size_t)b * a.NRU_REL, a.NRU_REL, 0, a.NR,
                 rel_idx, !a.t_rel_direct[t], comp.collect, 0);
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

// the verifyACL masks of row b (its instances' eligibility per HR role and
// their value equality), by the block
__device__ void acl_masks(const Args& a, int b, uint64_t* elig,
                          uint64_t* same) {
  const int32_t* insts = a.r_acl_inst + (size_t)b * a.NACLE * a.NACLI;
  const int32_t* hr_roles = a.r_hr_roles + (size_t)b * a.NHRR;
  const int32_t* ahr = a.r_acl_hr + (size_t)b * a.NHR * 2;
  for (int x = threadIdx.x; x < a.NACLE * a.NHRR; x += blockDim.x) {
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
  for (int x = threadIdx.x; x < a.NACLE * a.NACLI; x += blockDim.x) {
    const int e = x / a.NACLI;
    const int inst = insts[x];
    uint64_t m = 0;
    for (int j = 0; j < a.NACLI; ++j) {
      const int other = insts[e * a.NACLI + j];
      if (other >= 0 && other == inst) m |= 1ull << j;
    }
    same[x] = m;
  }
}

// the verifyACL outcome of a row's light pairs: always (short path or a
// CRUD action without instance masks to read), only where the target skips
// ACL, or the per-target create / read-modify-delete scan (the pair goes to
// the work list unless the target skips ACL)
enum : uint8_t { GM_TRUE = 0, GM_SKIP = 1, GM_SCAN = 2 };

// stage D for (row b, set s) by one warp -> the row's setinfo[s]
__device__ void gates(const Args& v, int b, int s, const uint8_t* tbits,
                      uint8_t* setinfo) {
  const int lane = threadIdx.x & 31;
  const int32_t* rev = v.r_ent_vals + (size_t)b * v.NR;
  const uint8_t* rvalid = v.r_ent_valid + (size_t)b * v.NR;
  const bool multi = v.r_n_entity_attrs[b] > 1;
  int first_kp = ACS_BIG, last_valid = -1;
  uint32_t multi_hit = 0;
  for (int kp = lane; kp < v.KP; kp += 32) {
    const int p = s * v.KP + kp;
    if (!v.pol_valid[p]) continue;
    last_valid = kp;
    const uint8_t tb = tbits[v.pol_target[p]];
    const bool ctx_deny = v.pol_eff_ctx[p] == 2;
    if (v.pol_has_target[p] && (tb & (ctx_deny ? TB_EX_D : TB_EX_P)))
      first_kp = min(first_kp, kp);
    if (multi && !(v.pol_effect[p] == 1 && v.pol_has_props[p])) {
      for (int j = 0; j < v.NR; ++j) {
        if (!rvalid[j]) continue;
        for (int k = 0; k < v.KE; ++k) {
          const int pe = v.pol_ent_vals[p * v.KE + k];
          if (pe >= 0 && pe == rev[j]) multi_hit |= 1u << j;
        }
      }
    }
  }
  first_kp = warp_min(first_kp);
  last_valid = warp_max(last_valid);
  multi_hit = warp_or(multi_hit);
  if (lane != 0) return;
  const bool exact0 = first_kp < ACS_BIG;
  const int src = exact0 ? min(max(first_kp, 0), v.KP - 1)
                         : min(max(last_valid, 0), v.KP - 1);
  const int eval_eff = v.pol_eff_ctx[s * v.KP + src];
  bool multi_gate = true;
  if (multi) {
    uint32_t valid_mask = 0;
    for (int j = 0; j < v.NR; ++j)
      if (rvalid[j]) valid_mask |= 1u << j;
    multi_gate = (valid_mask & ~multi_hit) == 0;
  }
  const bool exact = exact0 && multi_gate;
  const bool set_gate = (!v.set_has_target[s] ||
                         (tbits[v.set_target[s]] & TB_EX_P)) &&
                        v.set_valid[s];
  setinfo[s] = (exact ? 1 : 0) | (eval_eff == 2 ? 2 : 0) | (set_gate ? 4 : 0);
}

// the block stages the rule arrays of policies [kp0, kp0 + npt) of set s:
// the records, then the DENY, PERMIT and valid bitsets (one ballot per
// word each)
__device__ void stage_rules(const Args& v, int s, int kp0, int npt,
                            int words, int32_t* rtgt, int32_t* rcond,
                            uint8_t* rfl, uint32_t* sb) {
  const size_t base = ((size_t)s * v.KP + kp0) * v.KR;
  const int P = npt * v.KR;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const size_t q = base + i;
    rtgt[i] = v.rule_has_target[q] ? v.rule_target[q] : -1;
    rcond[i] = v.rule_cond[q];
    rfl[i] = (uint8_t)((v.rule_valid[q] ? GF_VALID : 0) |
                       ((v.rule_effect[q] & 3) << 1) |
                       (v.rule_cacheable_eff[q] ? GF_CACH : 0));
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int w = threadIdx.x >> 5; w < words; w += blockDim.x >> 5) {
    const int i = w * 32 + lane;
    const uint8_t fl = i < P ? rfl[i] : 0;
    const uint32_t e2 = __ballot_sync(0xffffffffu, GF_EFF(fl) == 2);
    const uint32_t e1 = __ballot_sync(0xffffffffu, GF_EFF(fl) == 1);
    const uint32_t valid = __ballot_sync(0xffffffffu, fl & GF_VALID);
    if (lane == 0) {
      sb[w] = e2;
      sb[words + w] = e1;
      sb[2 * words + w] = valid;
    }
  }
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

// stage F for (row j, set s) by one warp: the policy slot the set's
// algorithm selects over the contribution bytes -> setres (and with EXPLAIN
// the slot), the last contributing set by atomicMax
template <class CT>
__device__ void sets_stage(const Args& v, int j, int s, const CT* contrib,
                           uint8_t* setres, int32_t* setkp, int32_t* scal) {
  const int lane = threadIdx.x & 31;
  const CT* c = contrib + (size_t)j * v.S * v.KP + (size_t)s * v.KP;
  int first_deny = ACS_BIG, first_permit = ACS_BIG, first = ACS_BIG, last = -1;
  for (int kp = lane; kp < v.KP; kp += 32) {
    const int c8 = c[kp] & 0xff;
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
  if (lane != 0 || last < 0) return;
  const int kp = min(max(select_pos(v.set_ca[s], first_deny, first_permit,
                                    first, last), 0), v.KP - 1);
  const int c8 = c[kp] & 0xff;
  setres[j * v.S + s] = ((c8 >> 1) & 3) | (((c8 >> 3) & 1) << 2);
  if (setkp != nullptr) setkp[j * v.S + s] = kp;
  atomicMax(&scal[j * 2 + 1], s);
}

// ------------------------------------------------------- the rows program

// its block shape ints after the program's own: request rows per block,
// policies per staged rule tile
#define RW_DIMS(X) X(RT) X(PT)

struct RowsTile {
  RW_DIMS(ACS_DIM_FIELD)
};

static const int kNumRwDims = 0 RW_DIMS(ACS_COUNT);

// the program's arguments: the dense tables and rows, the chunk fields
// (zero in ROW_DENSE) and the block shape
struct RowsArgs {
  Args a;
  Chunk ch;
  RowsTile rt;
};

// threads per block at most, and the resident blocks per SM the register
// allocation is held to
#define RW_THREADS 256
#define RW_MIN_BLOCKS 2

struct RwSmem {
  size_t scal, bits, work, roles, rmask, rroles, rsub, ract, setkp, contrib,
      inst, setinfo, setres, tbits, elig, same, region, total;
  int words;  // bitset words of a rule tile
};

// bits of the mask of the block's rows' roles
#define RW_ROLE_BITS 1024
// entries of the stages A-C work list
#define RW_WORK 2048

// dynamic shared memory layout of one block in `mode`; the host sizes the
// launch with the same function the kernel carves the buffer with.  The
// rule-chunk mode writes stage E's keys to the merge rows: it has no
// contribution or set-result region.
__host__ __device__ inline RwSmem rw_smem(const Args& a, const RowsTile& rt,
                                          int mode, bool with_acl,
                                          bool explain) {
  const bool keys = mode == ROW_RULE_CHUNK;
  const size_t RT = rt.RT, sets = (size_t)rt.RT * a.S;
  RwSmem l;
  l.words = gr_words(rt.PT * a.KR);
  size_t off = 0;
  l.scal = off;  // int32 [RT * 2]: abort position, winning set
  off += sizeof(int32_t) * RT * 2;
  l.bits = off;  // uint32 [RT * 2 * words]: each row's tile bitsets
  off += sizeof(uint32_t) * RT * 2 * l.words;
  l.work = off;  // int32 count, then uint32 [RW_WORK]: the work list
  off += sizeof(int32_t) + sizeof(uint32_t) * RW_WORK;
  l.roles = off;  // uint32 [RW_ROLE_BITS / 32]: the rows' roles, hashed
  off += RW_ROLE_BITS / 8;
  l.rmask = off;  // uint32 [RT * 2]: each row's roles, then action pairs,
  off += sizeof(uint32_t) * RT * 2;  // hashed to 32 bits
  l.rroles = off;  // int32 [RT * NROLE]: the rows' roles
  off += sizeof(int32_t) * RT * a.NROLE;
  l.rsub = off;  // int32 [RT * 2 * NSUB]: their subject ids, then values
  off += sizeof(int32_t) * RT * 2 * a.NSUB;
  l.ract = off;  // int32 [RT * 2 * NACT]: their action ids, then values
  off += sizeof(int32_t) * RT * 2 * a.NACT;
  l.setkp = off;  // int32 [RT * S]: each set's picked policy (explain)
  if (explain) off += sizeof(int32_t) * sets;
  l.contrib = off;  // [RT * S * KP]: uint8, int32 with the rule in explain
  if (!keys) off += (explain ? 4 : 1) * sets * a.KP;
  l.inst = off;  // uint8 [RT]: the row carries an ACL instance
  off += RT;
  l.setinfo = off;  // uint8 [RT * S]: exact | eval_deny << 1 | gate << 2
  off += sets;
  l.setres = off;  // uint8 [RT * S]: eff | cach << 2
  if (!keys) off += sets;
  off = align_up(off, 16);
  l.tbits = off;  // uint8 [RT * T], padded to 16 bytes
  off += align_up(RT * a.T, 16);
  l.elig = off;  // uint64 [RT * NACLE * NHRR]: each ACL row's masks
  if (with_acl) off += sizeof(uint64_t) * RT * a.NACLE * a.NHRR;
  l.same = off;  // uint64 [RT * NACLE * NACLI]
  if (with_acl) off += sizeof(uint64_t) * RT * a.NACLE * a.NACLI;
  off = align_up(off, 16);
  l.region = off;  // stage E's rule tile: bitsets, then records
  off += sizeof(uint32_t) * 3 * l.words + (size_t)GR_RULE_BYTES * rt.PT * a.KR;
  l.total = align_up(off, 16);
  return l;
}

// whether the pair (id, v) is one of a row's J staged action pairs (ids,
// then values)
__device__ __forceinline__ bool pair_in(int id, int v, const int32_t* q,
                                        int J) {
  for (int j = 0; j < J; ++j)
    if (q[j] >= 0 && q[j] == id && q[J + j] == v) return true;
  return false;
}

// target row t's subject and action tests against one row's staged roles,
// subject pairs (ids, then values) and action pairs: grouped_target_bits'
// sub_ok and action test, without which no match bit is set.  The
// target's subject count, role flag, role and first action pair come in
// registers.
__device__ __forceinline__ bool subject_action_ok(const Args& a, int t, int tn,
                                                  bool by_role, int role,
                                                  int act0, int val0,
                                                  const int32_t* roles,
                                                  const int32_t* sub,
                                                  const int32_t* act) {
  if (tn != 0) {
    bool ok = false;
    if (by_role) {
      for (int k = 0; k < a.NROLE; ++k)
        if (roles[k] >= 0 && roles[k] == role) ok = true;
    } else {
      ok = pairs_subset(a.t_sub_ids + t * a.KS, a.t_sub_vals + t * a.KS,
                        a.KS, sub, sub + a.NSUB, a.NSUB);
    }
    if (!ok) return false;
  }
  if (act0 >= 0 && !pair_in(act0, val0, act, a.NACT)) return false;
  for (int k = 1; k < a.KA; ++k) {
    const int id = a.t_act_ids[t * a.KA + k];
    if (id >= 0 && !pair_in(id, a.t_act_vals[t * a.KA + k], act, a.NACT))
      return false;
  }
  return true;
}

// the verifyACL masks of the block's rows that carry ACL instances (their
// instances' eligibility per HR role and their value equality, as
// acl_masks builds one row's), threads over (row, mask) pairs
__device__ void rows_acl_masks(const Args& a, int b0, int n,
                               const uint8_t* inst, uint64_t* elig,
                               uint64_t* same) {
  const int ne = a.NACLE * a.NHRR, ns = a.NACLE * a.NACLI;
  for (int y = threadIdx.x; y < n * (ne + ns); y += blockDim.x) {
    const int j = y / (ne + ns), x = y - j * (ne + ns);
    if (!inst[j]) continue;
    const int b = b0 + j;
    const int32_t* insts = a.r_acl_inst + (size_t)b * ns;
    uint64_t m = 0;
    if (x < ne) {
      const int e = x / a.NHRR, role = a.r_hr_roles[(size_t)b * a.NHRR +
                                                   x % a.NHRR];
      const int32_t* ahr = a.r_acl_hr + (size_t)b * a.NHR * 2;
      for (int i = 0; i < a.NACLI; ++i) {
        const int in = insts[e * a.NACLI + i];
        if (in < 0) continue;
        for (int q = 0; q < a.NHR; ++q) {
          if (ahr[q * 2 + 1] >= 0 && ahr[q * 2 + 1] == in && ahr[q * 2] == role) {
            m |= 1ull << i;
            break;
          }
        }
      }
      elig[(size_t)j * ne + x] = m;
    } else {
      const int z = x - ne, e = z / a.NACLI, in = insts[z];
      for (int k = 0; k < a.NACLI; ++k) {
        const int other = insts[e * a.NACLI + k];
        if (other >= 0 && other == in) m |= 1ull << k;
      }
      same[(size_t)j * ns + z] = m;
    }
  }
}

// a role's bit in the mask of the block's rows' roles (and in a row's
// 32-bit role mask), an action pair's in a row's action mask
__device__ __forceinline__ uint32_t role_bit(int role) {
  return 1u << (role & 31);
}
__device__ __forceinline__ uint32_t pair_bit(int id, int val) {
  return 1u << ((id * 31 + val) & 31);
}
__device__ __forceinline__ int role_word(int role) {
  return (role >> 5) & (RW_ROLE_BITS / 32 - 1);
}

// stages A-C for the block's n rows (request rows b0 ...) over the T
// targets.  The target bits start at 0; one pass, one thread per target
// (and share of its rows, when T is below the block's threads), reads
// the target's role and first action pair once, drops it when its role
// is in no row of the block, and otherwise tests it against each row:
// first the row's 32-bit role and action masks (a bit the target needs
// and the row lacks rejects the pair), then the staged fields
// (subject_action_ok).  The pairs that pass are folded densely from the
// work list after the pass (at once where the list is full), with their
// row's ACL masks where the row carries instances.  The others keep 0: no
// match bit, and nothing reads their other bits.
template <bool WITH_ACL, bool WITH_HR, bool WITH_REL>
__device__ void rows_targets(const Args& a, int b0, int n, const RwSmem& L,
                             unsigned char* smem) {
  const int T = a.T;
  uint8_t* tbits = smem + L.tbits;
  uint64_t* elig = reinterpret_cast<uint64_t*>(smem + L.elig);
  uint64_t* same = reinterpret_cast<uint64_t*>(smem + L.same);
  int32_t* wcount = reinterpret_cast<int32_t*>(smem + L.work);
  uint32_t* wlist = reinterpret_cast<uint32_t*>(wcount + 1);
  uint32_t* roles = reinterpret_cast<uint32_t*>(smem + L.roles);
  const int32_t* rroles = reinterpret_cast<const int32_t*>(smem + L.rroles);
  const int32_t* rsub = reinterpret_cast<const int32_t*>(smem + L.rsub);
  const int32_t* ract = reinterpret_cast<const int32_t*>(smem + L.ract);
  const uint32_t* rmask = reinterpret_cast<const uint32_t*>(smem + L.rmask);
  const uint8_t* inst = smem + L.inst;
  uint4* tb16 = reinterpret_cast<uint4*>(tbits);
  for (int i = threadIdx.x; i < (n * T + 15) / 16; i += blockDim.x)
    tb16[i] = make_uint4(0, 0, 0, 0);
  for (int w = threadIdx.x; w < RW_ROLE_BITS / 32; w += blockDim.x)
    roles[w] = 0;
  if (threadIdx.x == 0) *wcount = 0;
  if (WITH_ACL) rows_acl_masks(a, b0, n, inst, elig, same);
  __syncthreads();
  for (int x = threadIdx.x; x < n * a.NROLE; x += blockDim.x) {
    const int role = rroles[x];
    if (role >= 0) atomicOr(&roles[role_word(role)], role_bit(role));
  }
  __syncthreads();
  auto fold = [&](int j, int t) {
    const bool own = WITH_ACL && inst[j];
    tbits[(size_t)j * T + t] =
        grouped_target_bits<WITH_ACL, WITH_HR, WITH_REL>(
            a, b0 + j, t,
            own ? elig + (size_t)j * a.NACLE * a.NHRR : nullptr,
            own ? same + (size_t)j * a.NACLE * a.NACLI : nullptr);
  };
  const int g = max(1, min(n, (int)blockDim.x / T));
  for (int x = threadIdx.x; x < g * T; x += blockDim.x) {
    const int t = x % T;
    // the target's fields, loaded together
    const int tn = a.t_n_subjects[t];
    const bool has_role = a.t_has_role[t];
    const int trole = a.t_role[t];
    const int act0 = a.KA > 0 ? a.t_act_ids[t * a.KA] : -1;
    const int val0 = a.KA > 0 ? a.t_act_vals[t * a.KA] : 0;
    const bool by_role = tn != 0 && has_role;
    const int role = by_role ? trole : -1;
    if (by_role && !(roles[role_word(role)] & role_bit(role))) continue;
    const uint32_t rbit = by_role ? role_bit(role) : 0u;
    const uint32_t abit = act0 >= 0 ? pair_bit(act0, val0) : 0u;
    for (int j = x / T; j < n; j += g) {
      if ((rmask[j * 2] & rbit) != rbit || (rmask[j * 2 + 1] & abit) != abit)
        continue;
      if (!subject_action_ok(a, t, tn, by_role, role, act0, val0,
                             rroles + (size_t)j * a.NROLE,
                             rsub + (size_t)j * 2 * a.NSUB,
                             ract + (size_t)j * 2 * a.NACT))
        continue;
      const int slot = atomicAdd(wcount, 1);
      if (slot < RW_WORK)
        wlist[slot] = (uint32_t)(j * T + t);
      else
        fold(j, t);
    }
  }
  __syncthreads();
  const int nw = min(*wcount, RW_WORK);
  for (int y = threadIdx.x; y < nw; y += blockDim.x) {
    const int x = wlist[y];
    fold(x / T, x % T);
  }
  __syncthreads();
}

// stage E's first half over one staged tile of P rule positions: warps
// over words of 32 positions read each lane's rule record once, then for
// each row test it against the row's target bits and conditions; two
// ballots leave the row's collected and aborting rules in its bitsets
// (bits + j * 2 * words: collected, then aborting)
__device__ void rows_rule_bits(const Args& a, int b0, int n, int P, int words,
                               const int32_t* rtgt, const int32_t* rcond,
                               const uint8_t* rfl, const uint32_t* sb,
                               const uint8_t* tbits, uint32_t* bits) {
  const int lane = threadIdx.x & 31;
  for (int w = threadIdx.x >> 5; w < words; w += blockDim.x >> 5) {
    if (sb[2 * words + w] == 0) {  // no valid rule in the word
      for (int j = lane; j < n; j += 32)
        bits[(size_t)j * 2 * words + w] =
            bits[(size_t)j * 2 * words + words + w] = 0;
      continue;
    }
    const int i = w * 32 + lane;
    const uint8_t fl = i < P ? rfl[i] : 0;
    const bool valid = fl & GF_VALID;
    const int tg = valid ? rtgt[i] : -1;
    const int ci = valid ? rcond[i] : -1;
    const uint8_t tm = GF_EFF(fl) == 2 ? (TB_EX_D | TB_RG_D)
                                       : (TB_EX_P | TB_RG_P);
    for (int j = 0; j < n; ++j) {
      bool reached = false, aborts = false;
      if (valid) {
        const uint8_t tr = tg >= 0 ? tbits[(size_t)j * a.T + tg] : 0xff;
        if ((tr & tm) && (tr & TB_HR)) {
          bool ct = true;
          if (ci >= 0 && a.C > 0) {
            ct = a.cond_true[(size_t)ci * a.CSTRIDE + b0 + j];
            aborts = a.cond_abort[(size_t)ci * a.CSTRIDE + b0 + j];
          }
          reached = !aborts && ct && (tr & TB_ACL);
        }
      }
      const uint32_t cw = __ballot_sync(0xffffffffu, reached);
      const uint32_t aw = __ballot_sync(0xffffffffu, aborts);
      if (lane == 0) {
        bits[(size_t)j * 2 * words + w] = cw;
        bits[(size_t)j * 2 * words + words + w] = aw;
      }
    }
  }
}

// stage E's second half: threads over (row, policy) pairs of the tile
// (policies kp0 ... kp0 + npt - 1 of set s) read each policy's first
// selected and last collected rule from its window of KR bits and write
// its contribution (present | eff << 1 | cach << 3, with EXPLAIN also
// no_rules << 4 | the selected rule slot << 8); the first aborting rule in
// scope folds into the row's abort position
template <bool EXPLAIN>
__device__ void rows_policies(const Args& a, int n, int s, int kp0, int npt,
                              int words, const uint8_t* rfl,
                              const uint32_t* sb, const uint8_t* tbits,
                              const uint8_t* setinfo, const uint32_t* bits,
                              void* contrib, int32_t* scal) {
  const int KR = a.KR;
  for (int x = threadIdx.x; x < n * npt; x += blockDim.x) {
    const int j = x / npt, kpl = x - j * npt;
    const uint32_t* coll = bits + (size_t)j * 2 * words;
    const uint32_t* abt = coll + words;
    const uint8_t* tb = tbits + (size_t)j * a.T;
    const uint8_t si = setinfo[j * a.S + s];
    const bool exact = si & 1, eval_deny = si & 2, set_gate = si & 4;
    const uint8_t tm = exact ? (eval_deny ? TB_EX_D : TB_EX_P)
                             : (eval_deny ? TB_RG_D : TB_RG_P);
    const int p = s * a.KP + kp0 + kpl;
    const bool pv = a.pol_valid[p];
    const uint8_t pt = tb[a.pol_target[p]];
    const bool pol_gate = (!a.pol_has_target[p] || (pt & tm)) && pv;
    const bool pol_subject = !a.pol_has_subjects[p] || (pt & TB_HR);
    const bool gate = pv && set_gate && pol_gate;
    const int ca = a.pol_ca[p];
    // the first-DENY / first-PERMIT / first (by the algorithm) and last
    // collected rule slots, and the first aborting one
    int prim_kr = ACS_BIG, last_kr = -1;
    if (set_gate && pol_gate) {
      int abort_kr = ACS_BIG;
      for (int c0 = 0; c0 < KR; c0 += 32) {
        const int m = min(32, KR - c0), at = kpl * KR + c0;
        const uint32_t am = bit_window(abt, at, m);
        if (am != 0 && abort_kr == ACS_BIG) abort_kr = c0 + __ffs((int)am) - 1;
        const uint32_t cm = pol_subject ? bit_window(coll, at, m) : 0u;
        const uint32_t pm =
            ca == 0 ? (cm & bit_window(sb, at, m))
                    : (ca == 1 ? (cm & bit_window(sb + words, at, m))
                               : (ca == 2 ? cm : 0u));
        if (pm != 0 && prim_kr == ACS_BIG) prim_kr = c0 + __ffs((int)pm) - 1;
        if (cm != 0) last_kr = c0 + 31 - __clz((int)cm);
      }
      if (abort_kr < ACS_BIG) atomicMin(&scal[j * 2], p * KR + abort_kr);
    }
    // select_pos over those slots, clamped to [0, KR)
    int sel;
    if (ca == 0 || ca == 1)
      sel = prim_kr < ACS_BIG ? prim_kr : last_kr;
    else if (ca == 2)
      sel = prim_kr;
    else
      sel = 0;
    const int sel_c = min(max(sel, 0), KR - 1);
    const bool no_rules = gate && a.pol_n_rules[p] == 0 && a.pol_effect[p] > 0;
    const bool present = no_rules || last_kr >= 0;
    const uint8_t sf = rfl[kpl * KR + sel_c];
    const int eff = no_rules ? a.pol_effect[p] : GF_EFF(sf);
    const bool cach = no_rules ? a.pol_cacheable[p] : (sf & GF_CACH) != 0;
    const int c8 = (present ? 1 : 0) | ((eff & 3) << 1) | (cach ? 8 : 0);
    const size_t at = (size_t)j * a.S * a.KP + p;
    if (EXPLAIN)
      reinterpret_cast<int32_t*>(contrib)[at] =
          c8 | (no_rules ? 16 : 0) | (sel_c << 8);
    else
      reinterpret_cast<uint8_t*>(contrib)[at] = (uint8_t)c8;
  }
}

// stage E's second half in the rule-chunk mode (K7): threads over (row,
// policy) pairs of the tile (policies kp0 ... kp0 + npt - 1 of set s) read
// the policy's window of KR bits and write its five keys into the row's
// merge row: the first-DENY and first-PERMIT collected rule (the collected
// window ANDed with the tile's DENY / PERMIT bitset, whatever the policy's
// algorithm), the first and the negated last collected rule, each at its
// GLOBAL position OFFSET + kr packed with the rule's effect and cacheable
// bit (ACS_BIGKEY / 0 when none), and the policy's gate; the first aborting
// rule in scope folds into the row's abort position (local flat order,
// mapped to the global one in stage G)
__device__ void rows_rule_keys(const Args& a, const Chunk& ch, int b0, int n,
                               int s, int kp0, int npt, int words,
                               const uint8_t* rfl, const uint32_t* sb,
                               const uint8_t* tbits, const uint8_t* setinfo,
                               const uint32_t* bits, int32_t* scal) {
  const int KR = a.KR;
  const int width = chunk_width(ROW_RULE_CHUNK, a.S, a.KP, ch.N_MODEL, false);
  for (int x = threadIdx.x; x < n * npt; x += blockDim.x) {
    const int j = x / npt, kpl = x - j * npt;
    const uint32_t* coll = bits + (size_t)j * 2 * words;
    const uint32_t* abt = coll + words;
    const uint8_t* tb = tbits + (size_t)j * a.T;
    const uint8_t si = setinfo[j * a.S + s];
    const bool exact = si & 1, eval_deny = si & 2, set_gate = si & 4;
    const uint8_t tm = exact ? (eval_deny ? TB_EX_D : TB_EX_P)
                             : (eval_deny ? TB_RG_D : TB_RG_P);
    const int p = s * a.KP + kp0 + kpl;
    const bool pv = a.pol_valid[p];
    const uint8_t pt = tb[a.pol_target[p]];
    const bool pol_gate = (!a.pol_has_target[p] || (pt & tm)) && pv;
    const bool pol_subject = !a.pol_has_subjects[p] || (pt & TB_HR);
    int first_deny = ACS_BIG, first_permit = ACS_BIG, first = ACS_BIG;
    int last = -1;
    if (set_gate && pol_gate) {
      int abort_kr = ACS_BIG;
      for (int c0 = 0; c0 < KR; c0 += 32) {
        const int m = min(32, KR - c0), at = kpl * KR + c0;
        const uint32_t am = bit_window(abt, at, m);
        if (am != 0 && abort_kr == ACS_BIG) abort_kr = c0 + __ffs((int)am) - 1;
        const uint32_t cm = pol_subject ? bit_window(coll, at, m) : 0u;
        if (cm == 0) continue;
        const uint32_t dm = cm & bit_window(sb, at, m);
        const uint32_t pm = cm & bit_window(sb + words, at, m);
        if (dm != 0 && first_deny == ACS_BIG)
          first_deny = c0 + __ffs((int)dm) - 1;
        if (pm != 0 && first_permit == ACS_BIG)
          first_permit = c0 + __ffs((int)pm) - 1;
        if (first == ACS_BIG) first = c0 + __ffs((int)cm) - 1;
        last = c0 + 31 - __clz((int)cm);
      }
      if (abort_kr < ACS_BIG) atomicMin(&scal[j * 2], p * KR + abort_kr);
    }
    // GLOBAL rule positions packed with the rule's (effect, cacheable)
    auto key = [&](int kr, int shift) {
      const uint8_t fl = rfl[kpl * KR + kr];
      return ((ch.OFFSET + kr + shift) << 3) | (GF_EFF(fl) << 1) |
             ((fl & GF_CACH) ? 1 : 0);
    };
    int32_t* k = ch.merge + (size_t)(b0 + j) * width + (size_t)p * KEY_COLS;
    k[0] = first_deny < ACS_BIG ? key(first_deny, 0) : ACS_BIGKEY;
    k[1] = first_permit < ACS_BIG ? key(first_permit, 0) : ACS_BIGKEY;
    k[2] = first < ACS_BIG ? key(first, 0) : ACS_BIGKEY;
    k[3] = last >= 0 ? -key(last, 1) : 0;
    k[4] = pv && set_gate && pol_gate ? 1 : 0;
  }
}

// stage G for row j (request row b): the decision outputs (ROW_DENSE; with
// EXPLAIN the provenance code, rule positions mapped through
// rule_orig_flat when the rule axis was compacted) or the row's merge row
// of a set chunk (ROW_SET_CHUNK: the negated key of the last contributing
// set at its GLOBAL position + 1, with EXPLAIN the negated provenance key
// that orders like it, a no-rules policy's position scaled by KR, then the
// abort slots with the abort in GLOBAL flat rule order)
template <int MODE, bool EXPLAIN>
__device__ void rows_outputs(const Args& a, const Chunk& ch, int j, int b,
                             const int32_t* scal, const uint8_t* setres,
                             const int32_t* setkp, const void* contrib) {
  const int winner = scal[j * 2 + 1];
  const int abort_pos = scal[j * 2];
  const bool aborted = abort_pos < ACS_BIG;
  const int code = aborted
      ? a.cond_code[(size_t)a.rule_cond[abort_pos] * a.CSTRIDE + b] : 0;
  const int cach_raw = aborted && a.rule_cacheable_raw[abort_pos] ? 1 : 0;
  if constexpr (MODE == ROW_RULE_CHUNK) {
    // only the abort slots (the keys are written): the local flat
    // position (pk, kr) at pk * KR_TOTAL + OFFSET + kr in the padded
    // global rule extent
    const int pk = abort_pos / a.KR, kr = abort_pos - pk * a.KR;
    int32_t* row = ch.merge + (size_t)b * chunk_width(ROW_RULE_CHUNK, a.S,
                                                      a.KP, ch.N_MODEL, false);
    write_abort_slots(row + a.S * a.KP * KEY_COLS, ch.N_MODEL, ch.RANK,
                      aborted ? pk * ch.KR_TOTAL + ch.OFFSET + kr : ACS_BIG,
                      code, aborted ? cach_raw + 1 : 0);
    return;
  }
  const uint8_t sr = winner >= 0 ? setres[j * a.S + winner] : 0;
  // the winning set's selected policy p, its rule slot kr, and whether
  // the policy's own effect decided (no rules)
  int p = 0, kr = 0;
  bool no_rules = false;
  if (EXPLAIN && winner >= 0) {
    p = winner * a.KP + setkp[j * a.S + winner];
    const int c = reinterpret_cast<const int32_t*>(
        contrib)[(size_t)j * a.S * a.KP + p];
    kr = c >> 8;
    no_rules = (c & 16) != 0;
  }
  if (MODE == ROW_DENSE) {
    // last-set-wins, then condition aborts preempt everything
    int decision = 0, cacheable = -1, status = 200;
    if (winner >= 0) {
      decision = sr & 3;
      cacheable = (sr >> 2) & 1;
    }
    if (aborted) {
      decision = 2;
      cacheable = cach_raw;
      status = code;
    }
    a.out_decision[b] = decision;
    a.out_cacheable[b] = cacheable;
    a.out_status[b] = status;
    if (EXPLAIN) {
      const int32_t* orig = a.rule_orig_flat;
      const int q = p * a.KR + kr;
      int ecode = 0;
      if (winner >= 0)
        ecode = no_rules ? explain_code(p, 2)
                         : explain_code(orig ? orig[q] : q, 1);
      if (aborted) ecode = explain_code(orig ? orig[abort_pos] : abort_pos, 3);
      a.out_explain[b] = ecode;
    }
    return;
  }
  int32_t* row = ch.merge + (size_t)b * chunk_width(ROW_SET_CHUNK, a.S, a.KP,
                                                    ch.N_MODEL, EXPLAIN);
  row[0] = winner >= 0 ? -(((ch.OFFSET + winner + 1) << 3) |
                           ((sr & 3) << 1) | ((sr >> 2) & 1))
                       : 0;
  if (EXPLAIN) {
    const int pos = (ch.OFFSET * a.KP + p) * a.KR + (no_rules ? 0 : kr);
    row[1] = winner >= 0 ? -explain_code(pos, no_rules ? 2 : 1) : 0;
  }
  write_abort_slots(row + 1 + (EXPLAIN ? 1 : 0), ch.N_MODEL, ch.RANK,
                    aborted ? ch.OFFSET * a.KP * a.KR + abort_pos : ACS_BIG,
                    aborted ? code : 0, aborted ? cach_raw + 1 : 0);
}

// the rows program for the block's RT rows: ROW_DENSE (decide_dense.cu),
// ROW_RULE_CHUNK or ROW_SET_CHUNK (shard_chunk.cu's two modes); `smem` is
// the block's dynamic shared memory, laid out by rw_smem
template <int MODE, bool WITH_ACL, bool WITH_HR, bool WITH_REL, bool EXPLAIN>
__device__ void rows_program(const RowsArgs& ra, unsigned char* smem) {
  static_assert(MODE != ROW_RULE_CHUNK || !EXPLAIN,
                "the rule-chunk mode has no explain variant");
  const Args& a = ra.a;
  const RwSmem L = rw_smem(a, ra.rt, MODE, WITH_ACL, EXPLAIN);
  int32_t* scal = reinterpret_cast<int32_t*>(smem + L.scal);
  uint8_t* inst = smem + L.inst;
  const uint8_t* tbits = smem + L.tbits;
  uint8_t* setinfo = smem + L.setinfo;
  uint8_t* setres = smem + L.setres;
  int32_t* setkp = EXPLAIN ? reinterpret_cast<int32_t*>(smem + L.setkp)
                           : nullptr;
  void* contrib = smem + L.contrib;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int b0 = blockIdx.x * ra.rt.RT;
  const int n = min(ra.rt.RT, a.B - b0);

  // ---- the rows' staged fields: abort and winner slots, whether the row
  // carries ACL instances, its role and action masks, its roles, subject
  // and action pairs
  uint32_t* rmask = reinterpret_cast<uint32_t*>(smem + L.rmask);
  for (int j = tid; j < n; j += blockDim.x) {
    const int b = b0 + j;
    scal[j * 2] = ACS_BIG;  // first aborting rule, flat position
    scal[j * 2 + 1] = -1;   // last set with a contribution
    bool has = false;
    if (WITH_ACL) {
      const int32_t* insts = a.r_acl_inst + (size_t)b * a.NACLE * a.NACLI;
      for (int i = 0; i < a.NACLE * a.NACLI; ++i) has |= insts[i] >= 0;
    }
    inst[j] = has;
    uint32_t rm = 0, am = 0;
    for (int k = 0; k < a.NROLE; ++k) {
      const int role = a.r_roles[(size_t)b * a.NROLE + k];
      if (role >= 0) rm |= role_bit(role);
    }
    for (int k = 0; k < a.NACT; ++k) {
      const int id = a.r_act_ids[(size_t)b * a.NACT + k];
      if (id >= 0) am |= pair_bit(id, a.r_act_vals[(size_t)b * a.NACT + k]);
    }
    rmask[j * 2] = rm;
    rmask[j * 2 + 1] = am;
  }
  int32_t* rroles = reinterpret_cast<int32_t*>(smem + L.rroles);
  int32_t* rsub = reinterpret_cast<int32_t*>(smem + L.rsub);
  int32_t* ract = reinterpret_cast<int32_t*>(smem + L.ract);
  for (int x = tid; x < n * a.NROLE; x += blockDim.x)
    rroles[x] = a.r_roles[(size_t)b0 * a.NROLE + x];
  for (int x = tid; x < n * 2 * a.NSUB; x += blockDim.x) {
    const int j = x / (2 * a.NSUB), c = x % (2 * a.NSUB);
    const size_t at = (size_t)(b0 + j) * a.NSUB + c % a.NSUB;
    rsub[x] = c < a.NSUB ? a.r_sub_ids[at] : a.r_sub_vals[at];
  }
  for (int x = tid; x < n * 2 * a.NACT; x += blockDim.x) {
    const int j = x / (2 * a.NACT), c = x % (2 * a.NACT);
    const size_t at = (size_t)(b0 + j) * a.NACT + c % a.NACT;
    ract[x] = c < a.NACT ? a.r_act_ids[at] : a.r_act_vals[at];
  }
  __syncthreads();

  // ---- stages A-C, then D
  rows_targets<WITH_ACL, WITH_HR, WITH_REL>(a, b0, n, L, smem);
  for (int x = warp; x < n * a.S; x += nwarps) {
    const int j = x / a.S, s = x - j * a.S;
    gates(a, b0 + j, s, tbits + (size_t)j * a.T, setinfo + j * a.S);
  }
  __syncthreads();

  // ---- stage E per staged rule tile
  uint32_t* sb = reinterpret_cast<uint32_t*>(smem + L.region);
  int32_t* rtgt = reinterpret_cast<int32_t*>(sb + 3 * L.words);
  int32_t* rcond = rtgt + ra.rt.PT * a.KR;
  uint8_t* rfl = reinterpret_cast<uint8_t*>(rcond + ra.rt.PT * a.KR);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + L.bits);
  for (int s = 0; s < a.S; ++s) {
    for (int kp0 = 0; kp0 < a.KP; kp0 += ra.rt.PT) {
      const int npt = min(ra.rt.PT, a.KP - kp0);
      const int words = gr_words(npt * a.KR);
      stage_rules(a, s, kp0, npt, words, rtgt, rcond, rfl, sb);
      __syncthreads();
      rows_rule_bits(a, b0, n, npt * a.KR, words, rtgt, rcond, rfl, sb,
                     tbits, bits);
      __syncthreads();
      if constexpr (MODE == ROW_RULE_CHUNK)
        rows_rule_keys(a, ra.ch, b0, n, s, kp0, npt, words, rfl, sb, tbits,
                       setinfo, bits, scal);
      else
        rows_policies<EXPLAIN>(a, n, s, kp0, npt, words, rfl, sb, tbits,
                               setinfo, bits, contrib, scal);
      __syncthreads();
    }
  }

  // ---- stage F (none in the rule-chunk mode: its policies are partial)
  if constexpr (MODE != ROW_RULE_CHUNK) {
    for (int x = warp; x < n * a.S; x += nwarps) {
      const int j = x / a.S, s = x - j * a.S;
      if (EXPLAIN)
        sets_stage(a, j, s, reinterpret_cast<const int32_t*>(contrib),
                   setres, setkp, scal);
      else
        sets_stage(a, j, s, reinterpret_cast<const uint8_t*>(contrib),
                   setres, nullptr, scal);
    }
    __syncthreads();
  }

  // ---- stage G: one thread per row
  for (int j = tid; j < n; j += blockDim.x)
    rows_outputs<MODE, EXPLAIN>(a, ra.ch, j, b0 + j, scal, setres, setkp,
                                contrib);
}

// blocks of the rows program for the launch's B rows
__host__ __device__ inline int rows_grid(const RowsArgs& ra) {
  return (ra.a.B + ra.rt.RT - 1) / ra.rt.RT;
}

// fills the block shape of `ra` from the last kNumRwDims shape ints;
// false on a zero tile
static bool fill_rows_tile(RowsArgs* ra, const int32_t* dims, int n_dims) {
  int i = n_dims - kNumRwDims;
#define RW_SET_DIM(name) ra->rt.name = dims[i++];
  RW_DIMS(RW_SET_DIM)
#undef RW_SET_DIM
  return ra->rt.RT > 0 && ra->rt.PT > 0;
}

// the block shape of a launch in `mode` at the shapes in `a` (a.B rows),
// from the host's sizing rule `stage` (SM count, most rows per block,
// blocks per SM to fill, a block's shared bytes, a rule tile's bytes): PT
// policies per rule tile within its bytes; RT the fewest rows per block
// that keep the batch at most `blocks per SM` blocks on every SM, at most
// `most rows`, and fewer while the block's shared memory (rw_smem, sized
// for the ACL variant) passes its bytes
enum { RS_SMS, RS_ROWS, RS_FILL, RS_BLOCK_BYTES, RS_RULE_BYTES, RS_N };

static RowsTile rows_tile(const Args& a, int mode, bool explain,
                          const int32_t* stage) {
  RowsTile rt;
  const long long per_tile = (long long)GR_RULE_BYTES * max(a.KR, 1);
  rt.PT = (int)max(1LL, min((long long)a.KP, stage[RS_RULE_BYTES] / per_tile));
  const int blocks = max(1, stage[RS_FILL] * stage[RS_SMS]);
  rt.RT = max(1, min(stage[RS_ROWS], (a.B + blocks - 1) / blocks));
  while (rt.RT > 1 &&
         rw_smem(a, rt, mode, true, explain).total >
             (size_t)stage[RS_BLOCK_BYTES])
    --rt.RT;
  return rt;
}

// the largest dynamic shared memory one kernel variant was opted in to on
// each device, so that a launch sets the attribute only when it needs more
#define OPT_IN_DEVICES 64

struct OptIn {
  std::mutex mu;
  size_t bytes[OPT_IN_DEVICES] = {};
};

// sets `kernel`'s shared-memory opt-in for `smem` bytes where it needs one
// and `seen` (the variant's) has not recorded as much on this device
template <class K>
static cudaError_t opt_in(K kernel, size_t smem, OptIn& seen) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < OPT_IN_DEVICES;
  std::lock_guard<std::mutex> lock(seen.mu);
  if (known && seen.bytes[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && known) seen.bytes[dev] = smem;
  return err;
}

extern "C" {

// the block shape ints (RW_DIMS) of a launch in `mode` (RowMode) at the
// program's shape ints `dims` (the dense program's) under the sizing rule
// `stage` (RS_N ints), into `out`; -1 on a count mismatch or an unknown
// mode
int acs_rows_tile(const int32_t* dims, int n_dims, int mode, int explain,
                  const int32_t* stage, int32_t* out) {
  Args a = {};
  if (!fill_dims(&a, dims, n_dims) || mode < ROW_DENSE || mode > ROW_SET_CHUNK)
    return -1;
  const RowsTile rt = rows_tile(a, mode, explain != 0, stage);
  out[0] = rt.RT;
  out[1] = rt.PT;
  return 0;
}

}  // extern "C"
