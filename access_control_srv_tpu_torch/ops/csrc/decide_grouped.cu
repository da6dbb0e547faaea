// Grouped decision kernel for Hopper (sm_90a): the signature prefilter's
// path for batches that carry ACL pairs or request properties.
//
// Replaces the JAX package's ops/prefilter.py PrefilteredKernel._runner
// (`body`: _evaluate_one vmapped over rows, each row against the group-
// invariant policy arrays joined with its own compacted subtree cs[g_idx]).
// Host side: access_control_srv_tpu_torch/ops/kernel.py (decide_grouped);
// the plain PyTorch version it is held against: ops/prefilter_ref.py
// decide_grouped_ref.
//
// What bounds it: integer compares.  Every row runs stages A-C on all Tp
// target rows of its group's compacted subtree (a thousand at the stress
// shapes), which outweighs the bytes.  The rows of a group share that
// table and the group's rule and policy arrays, so the card's limits are
// how often those are fetched, how much per-(row, target) work is done, and
// how much of a block waits at barriers.
//
// Design: the rows come in the signature path's slot layout (rows sorted by
// group into [NSLOT, R] slots, ops/kernel.py slot_layout); one 256-thread
// block takes RT rows of one slot (pad grid positions, whose row does not
// map back to them through gp_orig, are dropped when the block lists its
// rows) and keeps every per-row result in shared memory:
//   Stages A-C over (row, target) pairs, in rounds of GR_ROUND pairs with
//     consecutive threads on consecutive targets: a first pass decides
//     each pair from the row's roles, subject and action pairs and ACL mode
//     (staged in shared memory once per block) and the target's subject,
//     action and scope fields (a round's few kilobytes stay in L1), and
//     writes its match bits directly where the stage-A components cannot
//     change them: a target whose role the row lacks costs a few compares.
//     The pairs that need the components, an HR / relation fold or the
//     per-target verifyACL scan go to a work list in shared memory and run
//     the full program (grouped_target_bits) densely after the pass, so a
//     warp does not run the fold for one lane in 32.  Rows that carry ACL
//     instances run it for every target, one such row at a time, after
//     their masks; other rows never build or read masks.  Each pair's six
//     match bits go to tbits[row][target].  The target table is read
//     through L1, not staged: staged in shared memory with cp.async
//     (double-buffered tiles) it measured slower, its waits outweighing
//     the reuse and its tiles leaving L1 too small for the rows' reads
//     (PERF.md).
//   Stage D: one warp per (row, set): carried policyEffect, exact-match
//     break, multi-entity recheck, set gate.
//   Stage E: the group's rule arrays are staged per tile of PT policies as
//     records (target, condition, valid / effect / cacheable bits) and
//     DENY / PERMIT / valid bitsets; one warp per row: lanes over rule
//     positions, 32 at a time, test each rule against the row's target
//     bits and conditions, and two ballots leave the row's collected and
//     aborting rules as bitsets; lanes over policies then read each
//     policy's first selected and last collected rule from its window of
//     KR bits and write the contribution (and in explain mode the selected
//     rule slot beside it); the first aborting rule in scope per row.
//   Stage F: one warp per (row, set) over the contributions; last-set-wins
//     by atomicMax per row; stage G: one thread per row.
// Explain mode reads the winning set's policy and that policy's selected
// rule from what stages E and F kept (no second walk); rule_orig_flat (each
// compacted slot's original flat position, group-varying like the rule
// arrays) maps it back to the uncompacted tree, as the JAX runner's recovery
// does.  The host chooses the with_rel variant from the stacked subtrees (as
// the JAX runner keys on tree_needs_rel(stacked)).  The stage helpers it
// shares with the rows program of decide_dense.cu and shard_chunk.cu
// (grouped_target_bits, acl_masks, gates, stage_rules, bit_window,
// sets_stage) live in rows_core.cuh.

#include "rows_core.cuh"

// K4's shape ints after the dense ones: the slot count and width, rows per
// block, policies per staged rule tile
#define GR_DIMS(X) X(NSLOT) X(R) X(RT) X(PT)
// and its pointers after the dense ones: the slot layout
#define GR_PTRS(X)                                                           \
  X(const int32_t*, slot_g) X(const int32_t*, grid2row)                      \
  X(const int32_t*, gp_orig)

struct GroupedArgs {
  Args a;
  GR_PTRS(ACS_FIELD)
  GR_DIMS(ACS_DIM_FIELD)
};

static const int kNumGrPtrs = 0 GR_PTRS(ACS_COUNT);
static const int kNumGrDims = 0 GR_DIMS(ACS_COUNT);

#define GR_THREADS 256
// resident blocks per SM the register allocation is held to
#define GR_MIN_BLOCKS 2
struct GrSmem {
  size_t rows, inst, scal, tbits, setinfo, setres, setkp, contrib, wbits,
      work, rroles, rsub, ract, rmode, elig, same, region, total;
  int words;  // bitset words of a rule tile
};

// dynamic shared memory layout of one block; the host sizes the launch
// with the same function the kernel carves the buffer with
__host__ __device__ inline GrSmem gr_smem(const GroupedArgs& ga,
                                          bool with_acl, bool explain,
                                          int nwarps) {
  const Args& a = ga.a;
  const size_t RT = ga.RT, sets = (size_t)ga.RT * a.S;
  GrSmem l;
  l.words = gr_words(ga.PT * a.KR);
  size_t off = 0;
  l.rows = off;  // int32 [RT + 1]: the block's rows, then their count
  off += sizeof(int32_t) * (RT + 1);
  l.scal = off;  // int32 [RT * 2]: abort position, winning set
  off += sizeof(int32_t) * RT * 2;
  l.wbits = off;  // uint32 [nwarps * 2 * words]: a warp's row bitsets
  off += sizeof(uint32_t) * nwarps * 2 * l.words;
  l.work = off;  // int32 count, then uint16 [GR_ROUND]: a round's work list
  off += sizeof(int32_t) + sizeof(uint16_t) * GR_ROUND;
  off = align_up(off, 4);
  l.rroles = off;  // int32 [RT * NROLE]: the rows' roles
  off += sizeof(int32_t) * RT * a.NROLE;
  l.rsub = off;  // int32 [RT * 2 * NSUB]: their subject ids, then values
  off += sizeof(int32_t) * RT * 2 * a.NSUB;
  l.ract = off;  // int32 [RT * 2 * NACT]: their action ids, then values
  off += sizeof(int32_t) * RT * 2 * a.NACT;
  l.setkp = off;  // int32 [RT * S]: each set's picked policy (explain)
  if (explain) off += sizeof(int32_t) * sets;
  l.contrib = off;  // [RT * S * KP]: uint8, int32 with the rule in explain
  off += (explain ? 4 : 1) * sets * a.KP;
  l.inst = off;  // uint8 [RT]: the row carries an ACL instance
  off += RT;
  l.rmode = off;  // uint8 [RT]: the row's ACL mode (GM_*)
  off += RT;
  l.setinfo = off;  // uint8 [RT * S]: exact | eval_deny << 1 | gate << 2
  off += sets;
  l.setres = off;  // uint8 [RT * S]: eff | cach << 2
  off += sets;
  l.tbits = off;  // uint8 [RT * T]
  off += RT * a.T;
  off = align_up(off, 16);
  l.elig = off;  // uint64 [NACLE * NHRR]: one ACL row's masks at a time
  if (with_acl) off += sizeof(uint64_t) * a.NACLE * a.NHRR;
  l.same = off;  // uint64 [NACLE * NACLI]
  if (with_acl) off += sizeof(uint64_t) * a.NACLE * a.NACLI;
  off = align_up(off, 16);
  l.region = off;  // stage E's rule tile: bitsets, then records
  off += sizeof(uint32_t) * 3 * l.words + (size_t)GR_RULE_BYTES * ga.PT * a.KR;
  l.total = align_up(off, 16);
  return l;
}

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

// stages A-C for the block's n rows over the group's T targets.  Rounds of
// at most GR_ROUND (row, target) pairs, consecutive threads on consecutive
// targets of one row: a first pass decides each pair from the row's staged
// roles, pairs and ACL mode and the target's subject, action and scope
// fields; the pairs that need the stage-A components or the per-target
// verifyACL scan go to the work list and are folded densely after it (a
// warp would otherwise run the fold for one lane in 32).  Rows that carry
// ACL instances take the full program for every target, one row at a
// time, after their masks.
template <bool WITH_ACL, bool WITH_HR, bool WITH_REL>
__device__ void targets_stage(const Args& v, const int32_t* rows, int n,
                              const uint8_t* inst, const GrSmem& L,
                              unsigned char* smem) {
  const int T = v.T;
  uint8_t* tbits = smem + L.tbits;
  uint64_t* elig = reinterpret_cast<uint64_t*>(smem + L.elig);
  uint64_t* same = reinterpret_cast<uint64_t*>(smem + L.same);
  int32_t* wcount = reinterpret_cast<int32_t*>(smem + L.work);
  uint16_t* wlist = reinterpret_cast<uint16_t*>(wcount + 1);
  const int32_t* rroles = reinterpret_cast<const int32_t*>(smem + L.rroles);
  const int32_t* rsub = reinterpret_cast<const int32_t*>(smem + L.rsub);
  const int32_t* ract = reinterpret_cast<const int32_t*>(smem + L.ract);
  const uint8_t* rmode = smem + L.rmode;
  const int trn = max(1, min(T, GR_ROUND / max(n, 1)));
  for (int t0 = 0; t0 < T; t0 += trn) {
    const int nt = min(trn, T - t0);
    if (threadIdx.x == 0) *wcount = 0;
    __syncthreads();
    for (int x = threadIdx.x; x < n * nt; x += blockDim.x) {
      const int j = x / nt, t = t0 + x - j * nt;
      if (WITH_ACL && inst[j]) continue;
      const int tn = v.t_n_subjects[t];
      bool heavy = (WITH_HR && tn != 0 && v.t_has_scoping[t]) ||
                   (WITH_REL && v.t_rel_idx[t] >= 0);
      const bool acl = rmode[j] == GM_TRUE || v.t_skip_acl[t];
      if (!acl && rmode[j] == GM_SCAN) heavy = true;
      if (!heavy) {
        bool sub_ok = true;
        if (tn != 0) {
          if (v.t_has_role[t]) {
            const int role = v.t_role[t];
            sub_ok = false;
            for (int k = 0; k < v.NROLE; ++k) {
              const int r = rroles[j * v.NROLE + k];
              if (r >= 0 && r == role) sub_ok = true;
            }
          } else {
            const int32_t* s = rsub + (size_t)j * 2 * v.NSUB;
            sub_ok = pairs_subset(v.t_sub_ids + t * v.KS,
                                  v.t_sub_vals + t * v.KS, v.KS, s,
                                  s + v.NSUB, v.NSUB);
          }
        }
        const int32_t* q = ract + (size_t)j * 2 * v.NACT;
        heavy = sub_ok && pairs_subset(v.t_act_ids + t * v.KA,
                                       v.t_act_vals + t * v.KA, v.KA, q,
                                       q + v.NACT, v.NACT);
      }
      if (heavy)
        wlist[atomicAdd(wcount, 1)] = (uint16_t)x;
      else  // no match bits; no HR or relation check; the row's ACL mode
        tbits[(size_t)j * T + t] = TB_HR | (acl ? TB_ACL : 0);
    }
    __syncthreads();
    const int nw = *wcount;
    for (int y = threadIdx.x; y < nw; y += blockDim.x) {
      const int x = wlist[y];
      const int j = x / nt, t = t0 + x - j * nt;
      tbits[(size_t)j * T + t] =
          grouped_target_bits<WITH_ACL, WITH_HR, WITH_REL>(v, rows[j], t,
                                                           nullptr, nullptr);
    }
    __syncthreads();
  }
  if (WITH_ACL) {
    for (int j = 0; j < n; ++j) {  // rows with instances, one at a time
      if (!inst[j]) continue;
      acl_masks(v, rows[j], elig, same);
      __syncthreads();
      for (int t = threadIdx.x; t < T; t += blockDim.x)
        tbits[(size_t)j * T + t] =
            grouped_target_bits<WITH_ACL, WITH_HR, WITH_REL>(v, rows[j], t,
                                                             elig, same);
      __syncthreads();
    }
  }
}

// stage E for row j (request row b) over one staged tile, by one warp:
// lanes over rule positions build the row's collected and aborting bitsets
// (one ballot each per 32 positions), then lanes over policies read each
// policy's first selected and last collected rule from its window of KR
// bits and write its contribution (present | eff << 1 | cach << 3, with
// EXPLAIN also no_rules << 4 | the selected rule slot << 8); the first
// aborting rule folds into the row's abort position (lane 0)
template <bool EXPLAIN>
__device__ void rules_row(const Args& v, int j, int b, int s, int kp0,
                          int npt, int words, const int32_t* rtgt,
                          const int32_t* rcond, const uint8_t* rfl,
                          const uint32_t* sb, const uint8_t* tb,
                          uint8_t si, uint32_t* coll, uint32_t* abt,
                          void* contrib, int32_t* scal) {
  const int lane = threadIdx.x & 31;
  const int KR = v.KR, P = npt * KR;
  for (int w = 0; w < words; ++w) {
    if (sb[2 * words + w] == 0) {  // no valid rule in the word
      if (lane == 0) coll[w] = abt[w] = 0;
      continue;
    }
    const int i = w * 32 + lane;
    bool reached = false, aborts = false;
    const uint8_t fl = i < P ? rfl[i] : 0;
    if (fl & GF_VALID) {
      const int tg = rtgt[i];
      const uint8_t tr = tg >= 0 ? tb[tg] : 0xff;
      const bool deny = GF_EFF(fl) == 2;
      const bool tm_rule = (tr & (deny ? TB_EX_D : TB_EX_P)) ||
                           (tr & (deny ? TB_RG_D : TB_RG_P));
      if (tm_rule && (tr & TB_HR)) {
        const int ci = rcond[i];
        bool ct = true;
        if (ci >= 0 && v.C > 0) {
          ct = v.cond_true[(size_t)ci * v.CSTRIDE + b];
          aborts = v.cond_abort[(size_t)ci * v.CSTRIDE + b];
        }
        reached = !aborts && ct && (tr & TB_ACL);
      }
    }
    const uint32_t cw = __ballot_sync(0xffffffffu, reached);
    const uint32_t aw = __ballot_sync(0xffffffffu, aborts);
    if (lane == 0) {
      coll[w] = cw;
      abt[w] = aw;
    }
  }
  __syncwarp();

  const bool exact = si & 1, eval_deny = si & 2, set_gate = si & 4;
  const uint8_t tm = exact ? (eval_deny ? TB_EX_D : TB_EX_P)
                           : (eval_deny ? TB_RG_D : TB_RG_P);
  int abort_pos = ACS_BIG;
  for (int kpl = lane; kpl < npt; kpl += 32) {
    const int p = s * v.KP + kp0 + kpl;
    const bool pv = v.pol_valid[p];
    const uint8_t pt = tb[v.pol_target[p]];
    const bool pol_gate = (!v.pol_has_target[p] || (pt & tm)) && pv;
    const bool pol_subject = !v.pol_has_subjects[p] || (pt & TB_HR);
    const bool gate = pv && set_gate && pol_gate;
    const int ca = v.pol_ca[p];
    // the first-DENY / first-PERMIT / first (by the algorithm) and last
    // collected rule slots, and the first aborting one
    int prim_kr = ACS_BIG, last_kr = -1;
    if (set_gate && pol_gate) {
      int abort_kr = ACS_BIG;
      for (int c0 = 0; c0 < KR; c0 += 32) {
        const int n = min(32, KR - c0), at = kpl * KR + c0;
        const uint32_t am = bit_window(abt, at, n);
        if (am != 0 && abort_kr == ACS_BIG) abort_kr = c0 + __ffs((int)am) - 1;
        const uint32_t cm = pol_subject ? bit_window(coll, at, n) : 0u;
        const uint32_t pm =
            ca == 0 ? (cm & bit_window(sb, at, n))
                    : (ca == 1 ? (cm & bit_window(sb + words, at, n))
                               : (ca == 2 ? cm : 0u));
        if (pm != 0 && prim_kr == ACS_BIG) prim_kr = c0 + __ffs((int)pm) - 1;
        if (cm != 0) last_kr = c0 + 31 - __clz((int)cm);
      }
      if (abort_kr < ACS_BIG) abort_pos = min(abort_pos, p * KR + abort_kr);
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
    const bool no_rules = gate && v.pol_n_rules[p] == 0 && v.pol_effect[p] > 0;
    const bool present = no_rules || last_kr >= 0;
    const uint8_t sf = rfl[kpl * KR + sel_c];
    const int eff = no_rules ? v.pol_effect[p] : GF_EFF(sf);
    const bool cach = no_rules ? v.pol_cacheable[p] : (sf & GF_CACH) != 0;
    const int c8 = (present ? 1 : 0) | ((eff & 3) << 1) | (cach ? 8 : 0);
    const size_t at = (size_t)j * v.S * v.KP + p;
    if (EXPLAIN)
      reinterpret_cast<int32_t*>(contrib)[at] =
          c8 | (no_rules ? 16 : 0) | (sel_c << 8);
    else
      reinterpret_cast<uint8_t*>(contrib)[at] = (uint8_t)c8;
  }
  abort_pos = warp_min(abort_pos);
  if (lane == 0) scal[j * 2] = min(scal[j * 2], abort_pos);
  __syncwarp();  // the row bitsets are read before the next row's writes
}

template <bool WITH_ACL, bool WITH_HR, bool WITH_REL, bool EXPLAIN>
__global__ void __launch_bounds__(GR_THREADS, GR_MIN_BLOCKS)
    decide_grouped_kernel(const GroupedArgs ga) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Args& a = ga.a;
  const GrSmem L = gr_smem(ga, WITH_ACL, EXPLAIN, blockDim.x >> 5);
  int32_t* rows = reinterpret_cast<int32_t*>(smem + L.rows);
  int32_t* scal = reinterpret_cast<int32_t*>(smem + L.scal);
  uint8_t* inst = smem + L.inst;
  uint8_t* rmode = smem + L.rmode;
  const uint8_t* tbits = smem + L.tbits;
  uint8_t* setinfo = smem + L.setinfo;
  uint8_t* setres = smem + L.setres;
  int32_t* setkp = EXPLAIN ? reinterpret_cast<int32_t*>(smem + L.setkp)
                           : nullptr;
  void* contrib = smem + L.contrib;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nsplit = (ga.R + ga.RT - 1) / ga.RT;
  const int slot = blockIdx.x / nsplit;
  const int j0 = (blockIdx.x % nsplit) * ga.RT;
  const Args v = group_view(a, ga.slot_g[slot]);

  // the block's real rows (a pad position's row maps to another position)
  if (tid == 0) {
    int n = 0;
    for (int j = j0; j < min(ga.R, j0 + ga.RT); ++j) {
      const int pos = slot * ga.R + j;
      const int row = ga.grid2row[pos];
      if (ga.gp_orig[row] == pos) rows[n++] = row;
    }
    rows[ga.RT] = n;
  }
  __syncthreads();
  const int n = rows[ga.RT];
  const int32_t* k = a.acl_consts;
  for (int j = tid; j < n; j += blockDim.x) {
    const int b = rows[j];
    scal[j * 2] = ACS_BIG;  // first aborting rule, flat position
    scal[j * 2 + 1] = -1;   // last set with a contribution
    bool has = false;
    if (WITH_ACL) {
      const int32_t* insts = a.r_acl_inst + (size_t)b * a.NACLE * a.NACLI;
      for (int i = 0; i < a.NACLE * a.NACLI; ++i) has |= insts[i] >= 0;
    }
    inst[j] = has;
    // stage B2's outcome where the target does not skip ACL
    const int acl_short = a.r_acl_short[b];
    const int id0 = a.r_act_ids[(size_t)b * a.NACT];
    const int val0 = a.r_act_vals[(size_t)b * a.NACT];
    const bool is_action = id0 == k[2];
    const bool crud = is_action && (val0 == k[3] || val0 == k[4] ||
                                    val0 == k[5] || val0 == k[6]);
    uint8_t mode = GM_SKIP;
    if (acl_short == 1) mode = GM_TRUE;
    else if (acl_short == 0 && a.r_n_ra[b] > 0 && crud)
      mode = WITH_ACL ? GM_SCAN : GM_TRUE;
    rmode[j] = mode;
  }
  int32_t* rroles = reinterpret_cast<int32_t*>(smem + L.rroles);
  int32_t* rsub = reinterpret_cast<int32_t*>(smem + L.rsub);
  int32_t* ract = reinterpret_cast<int32_t*>(smem + L.ract);
  for (int x = tid; x < n * a.NROLE; x += blockDim.x)
    rroles[x] = a.r_roles[(size_t)rows[x / a.NROLE] * a.NROLE + x % a.NROLE];
  for (int x = tid; x < n * 2 * a.NSUB; x += blockDim.x) {
    const int j = x / (2 * a.NSUB), c = x % (2 * a.NSUB);
    const size_t at = (size_t)rows[j] * a.NSUB + c % a.NSUB;
    rsub[x] = c < a.NSUB ? a.r_sub_ids[at] : a.r_sub_vals[at];
  }
  for (int x = tid; x < n * 2 * a.NACT; x += blockDim.x) {
    const int j = x / (2 * a.NACT), c = x % (2 * a.NACT);
    const size_t at = (size_t)rows[j] * a.NACT + c % a.NACT;
    ract[x] = c < a.NACT ? a.r_act_ids[at] : a.r_act_vals[at];
  }
  __syncthreads();

  // ---- stages A-C, then D
  targets_stage<WITH_ACL, WITH_HR, WITH_REL>(v, rows, n, inst, L, smem);
  for (int x = warp; x < n * a.S; x += nwarps) {
    const int j = x / a.S, s = x - j * a.S;
    gates(v, rows[j], s, tbits + (size_t)j * a.T, setinfo + j * a.S);
  }
  __syncthreads();

  // ---- stage E per staged rule tile, one warp per row
  uint32_t* sb = reinterpret_cast<uint32_t*>(smem + L.region);
  int32_t* rtgt = reinterpret_cast<int32_t*>(sb + 3 * L.words);
  int32_t* rcond = rtgt + ga.PT * a.KR;
  uint8_t* rfl = reinterpret_cast<uint8_t*>(rcond + ga.PT * a.KR);
  uint32_t* coll = reinterpret_cast<uint32_t*>(smem + L.wbits) +
                   (size_t)warp * 2 * L.words;
  uint32_t* abt = coll + L.words;
  for (int s = 0; s < a.S; ++s) {
    for (int kp0 = 0; kp0 < a.KP; kp0 += ga.PT) {
      const int npt = min(ga.PT, a.KP - kp0);
      const int words = gr_words(npt * a.KR);
      stage_rules(v, s, kp0, npt, words, rtgt, rcond, rfl, sb);
      __syncthreads();
      for (int j = warp; j < n; j += nwarps)
        rules_row<EXPLAIN>(v, j, rows[j], s, kp0, npt, words, rtgt, rcond,
                           rfl, sb, tbits + (size_t)j * a.T,
                           setinfo[j * a.S + s], coll, abt, contrib, scal);
      __syncthreads();
    }
  }

  // ---- stage F
  for (int x = warp; x < n * a.S; x += nwarps) {
    const int j = x / a.S, s = x - j * a.S;
    if (EXPLAIN)
      sets_stage(v, j, s, reinterpret_cast<const int32_t*>(contrib), setres,
                 setkp, scal);
    else
      sets_stage(v, j, s, reinterpret_cast<const uint8_t*>(contrib), setres,
                 nullptr, scal);
  }
  __syncthreads();

  // ---- stage G: one thread per row
  for (int j = tid; j < n; j += blockDim.x) {
    const int b = rows[j];
    const int winner = scal[j * 2 + 1];
    const int abort_pos = scal[j * 2];
    const bool aborted = abort_pos < ACS_BIG;
    const int code = aborted
        ? a.cond_code[(size_t)v.rule_cond[abort_pos] * a.CSTRIDE + b] : 0;
    const int cach_raw = aborted && v.rule_cacheable_raw[abort_pos] ? 1 : 0;
    // last-set-wins, then condition aborts preempt everything
    int decision = 0, cacheable = -1, status = 200;
    if (winner >= 0) {
      decision = setres[j * a.S + winner] & 3;
      cacheable = (setres[j * a.S + winner] >> 2) & 1;
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
      const int32_t* orig = v.rule_orig_flat;
      int ecode = 0;
      if (winner >= 0) {
        const int p = winner * a.KP + setkp[j * a.S + winner];
        const int c = reinterpret_cast<const int32_t*>(
            contrib)[(size_t)j * a.S * a.KP + p];
        const int q = p * a.KR + (c >> 8);
        ecode = (c & 16) ? explain_code(p, 2)
                         : explain_code(orig ? orig[q] : q, 1);
      }
      if (aborted)
        ecode = explain_code(orig ? orig[abort_pos] : abort_pos, 3);
      a.out_explain[b] = ecode;
    }
  }
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
    const int nsplit = (ga.R + ga.RT - 1) / ga.RT;
    kernel<<<ga.NSLOT * nsplit, threads, smem, stream>>>(ga);
    return (int)cudaGetLastError();
  }
};

// resident blocks per SM of the variant at this shared memory size
template <bool... F>
struct GroupedOccupancy {
  static int run(size_t smem, int threads, int* blocks) {
    auto kernel = decide_grouped_kernel<F...>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, threads, smem);
  }
};

// fills the shape ints (the dense ones, then GR_DIMS); false on a count
// mismatch or a zero tile
static bool fill_grouped_dims(GroupedArgs* ga, const int32_t* dims,
                              int n_dims) {
  if (n_dims != kNumDims + kNumGrDims) return false;
  if (!fill_dims(&ga->a, dims, kNumDims)) return false;
  int i = kNumDims;
#define GR_SET_DIM(name) ga->name = dims[i++];
  GR_DIMS(GR_SET_DIM)
#undef GR_SET_DIM
  return ga->RT > 0 && ga->PT > 0;
}

// fills `ga` from the host's pointer and shape arrays
static bool fill_grouped(GroupedArgs* ga, const int64_t* ptrs, int n_ptrs,
                         const int32_t* dims, int n_dims) {
  if (n_ptrs != kNumPtrs + kNumGrPtrs ||
      !fill_args(&ga->a, ptrs, kNumPtrs, dims, kNumDims))
    return false;
  int i = kNumPtrs;
#define GR_SET_PTR(type, name) ga->name = reinterpret_cast<type>(ptrs[i++]);
  GR_PTRS(GR_SET_PTR)
#undef GR_SET_PTR
  return fill_grouped_dims(ga, dims, n_dims);
}

extern "C" {


// "ptr,ptr,...|dim,dim,..." : the argument order, checked by the host
const char* acs_decide_grouped_layout() {
  return ACS_PTRS(ACS_NAME) GR_PTRS(ACS_NAME) "|" ACS_DIMS(ACS_DIM_NAME)
      GR_DIMS(ACS_DIM_NAME);
}

// dynamic shared memory bytes a launch needs (-1 on an argument mismatch)
long long acs_decide_grouped_smem(const int32_t* dims, int n_dims,
                                  int with_acl, int explain, int threads) {
  GroupedArgs ga = {};
  if (!fill_grouped_dims(&ga, dims, n_dims)) return -1;
  return (long long)gr_smem(ga, with_acl != 0, explain != 0, threads / 32)
      .total;
}

// launches one block per (slot, chunk of RT rows) on `stream`: the dense
// program's pointers, then the slot layout; returns cudaGetLastError()
// after the launch, or -1 when the argument counts do not match this build
// or the explain variant has no output to write
int acs_decide_grouped(const int64_t* ptrs, int n_ptrs, const int32_t* dims,
                       int n_dims, int with_acl, int with_hr, int with_rel,
                       int explain, int threads, void* stream) {
  GroupedArgs ga;
  if (!fill_grouped(&ga, ptrs, n_ptrs, dims, n_dims)) return -1;
  if (explain && ga.a.out_explain == nullptr) return -1;
  if (ga.NSLOT == 0 || ga.a.B == 0) return 0;
  const size_t smem = gr_smem(ga, with_acl != 0, explain != 0, threads / 32).total;
  const bool flags[4] = {with_acl != 0, with_hr != 0, with_rel != 0,
                         explain != 0};
  return dispatch_flags<4, GroupedLaunch>(
      flags, ga, smem, threads, reinterpret_cast<cudaStream_t>(stream));
}

// resident blocks per SM of a variant at these shapes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), -1 on a mismatch
int acs_decide_grouped_occupancy(const int32_t* dims, int n_dims,
                                 int with_acl, int with_hr, int with_rel,
                                 int explain, int threads) {
  GroupedArgs ga = {};
  if (!fill_grouped_dims(&ga, dims, n_dims)) return -1;
  const size_t smem = gr_smem(ga, with_acl != 0, explain != 0, threads / 32).total;
  int blocks = 0;
  const bool flags[4] = {with_acl != 0, with_hr != 0, with_rel != 0,
                         explain != 0};
  const int err = dispatch_flags<4, GroupedOccupancy>(flags, smem, threads,
                                                      &blocks);
  return err != 0 ? -1 : blocks;
}

}  // extern "C"
