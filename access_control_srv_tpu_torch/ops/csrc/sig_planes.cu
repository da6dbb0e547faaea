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
// (the subject id/value planes carry KS int32 per rule, the HR and relation
// collection planes NR bytes); the work per byte is a handful of compares.
//
// Design: two launches behind one launcher (launch_planes).
// 1. sig_planes_comp_kernel, a thread per (group, target row) over all G
//    groups: the dense kernel's per-target stage A (target_components in
//    decide_core.cuh, the sticky regex scan with prefix resets included)
//    against the group's pseudo-request (no subjects, no properties, so the
//    PERMIT property-fail reduces to has_props and an entity hit), written
//    as one 32-byte record per target (SP_REC: the TC_* bits with the
//    target's byte columns, role, subject count, the per-run collection
//    bits and per-op-slot hits, the HR and relation indices) into scratch
//    the host carves from the planes' own allocation.
// 2. sig_planes_kernel over a flat grid: first a block per warps-worth of
//    the G*S sets (a warp per set: the multi-entity recheck with lanes over
//    the set's policies, then the set planes), then the G*S*KP policies and
//    the G*S*KP*KR rule positions, 4 consecutive positions per thread and
//    4 * threads per block, so the grid does not depend on G.  A thread
//    gathers its positions' records through rule_target / pol_target and
//    writes each plane once: a byte plane as one 32-bit word, an int32
//    plane as one 16-byte store, the collection and op-hit planes (NR / NOP
//    bytes a position) as 16-byte stores where the width is a multiple of
//    4, else 32-bit words.  The subject planes (KS ints a position, most of
//    the bytes) are written by the whole block after a barrier: lanes over
//    the block's flattened (position, k) ints, 4 per lane as one 16-byte
//    store, so each warp store covers 512 contiguous bytes, the positions'
//    table rows read from shared memory.  Every plane starts 256-byte
//    aligned and is padded to whole quads of positions (pack_sig_planes),
//    so no store has an edge case; a quad's positions past the end write
//    the padding.  For
//    relation trees (with_rel) it also writes the relation-path vocab index
//    and !direct flag of each rule and policy target, and the collection
//    planes an HR tree would carry (ops/prefilter.py:755-776).

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
  X(uint32_t*, comp)

#define SP_DIMS(X)                                                           \
  X(G) X(T) X(S) X(KP) X(KR) X(KS) X(KA) X(KE) X(KO) X(KPR) X(NACT) X(NR)    \
  X(NP) X(NOP) X(W) X(E)

struct SigArgs {
  SP_PTRS(ACS_FIELD)
  SP_DIMS(ACS_DIM_FIELD)
};

static const int kSpPtrs = 0 SP_PTRS(ACS_COUNT);
static const int kSpDims = 0 SP_DIMS(ACS_COUNT);

// words per (group, target row) record in `comp`: the flags (the TC_* bits
// and the RF_* byte columns), role, subject count, collection bits; op-slot
// hits, HR vocab index, relation vocab index, unused
#define SP_REC 8
enum : uint32_t {
  RF_HAS_ROLE = 1u << 5, RF_SKIP = 1u << 6, RF_TRIV = 1u << 7,
  RF_HRCHK = 1u << 8, RF_REL_DIR = 1u << 9
};
// positions per thread in the policy and rule segments
#define SP_QUAD 4

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

// the two launches' grids: the component pass, and the planes pass's set,
// policy and rule segments (in that order)
struct SpGrid {
  size_t n_set, n_pol, n_rule;
  long long comp_blocks, set_blocks, pol_blocks, rule_blocks;
};

__host__ __device__ inline SpGrid sp_grid(const SigArgs& a, int threads) {
  SpGrid g;
  g.n_set = (size_t)a.G * a.S;
  g.n_pol = g.n_set * a.KP;
  g.n_rule = g.n_pol * a.KR;
  const long long per = (long long)SP_QUAD * threads, warps = threads / 32;
  g.comp_blocks = ((long long)a.G * a.T + threads - 1) / threads;
  g.set_blocks = ((long long)g.n_set + warps - 1) / warps;
  g.pol_blocks = ((long long)g.n_pol + per - 1) / per;
  g.rule_blocks = ((long long)g.n_rule + per - 1) / per;
  return g;
}

// ---- pass 1: stage A per (group, target row) into its record
template <bool WITH_HR, bool WITH_REL>
__global__ void __launch_bounds__(256) sig_planes_comp_kernel(const SigArgs a) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)a.G * a.T) return;
  const int g = (int)(i / a.T), t = (int)(i % a.T);
  const SigArgs v = group_view(a, g);
  const TargetComp c = target_components(v, g, t, WITH_HR || WITH_REL);
  uint32_t f = c.bits;
  if (v.t_has_role[t]) f |= RF_HAS_ROLE;
  if (v.t_skip_acl[t]) f |= RF_SKIP;
  uint32_t rs = 0, rel = 0;
  if (WITH_HR) {
    if (v.t_n_subjects[t] == 0 || !v.t_has_scoping[t]) f |= RF_TRIV;
    if (v.t_hr_check[t]) f |= RF_HRCHK;
    rs = (uint32_t)v.t_rs_idx[t];
  }
  if (WITH_REL) {
    if (v.t_rel_direct[t]) f |= RF_REL_DIR;
    rel = (uint32_t)v.t_rel_idx[t];
  }
  uint4* rec = reinterpret_cast<uint4*>(a.comp + i * SP_REC);
  rec[0] = make_uint4(f, (uint32_t)v.t_role[t], (uint32_t)v.t_n_subjects[t],
                      c.collect);
  rec[1] = make_uint4(c.op_hit, rs, rel, 0u);
}

// ---- pass 2: the stores of a quad of positions q0..q0+3 (q0 a multiple of
// 4; every plane is 256-byte aligned and padded to whole quads)

// v[i] for a runtime i in 0..3, as selects (no local-memory array)
template <class T>
__device__ __forceinline__ T pick4(const T (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// one word of 4 byte-plane values at plane + q0
__device__ __forceinline__ void put_word(uint8_t* plane, size_t q0,
                                         uint32_t w) {
  *reinterpret_cast<uint32_t*>(plane + q0) = w;
}

// 4 int32 values at plane + q0 as one 16-byte store
__device__ __forceinline__ void put_ints(int32_t* plane, size_t q0,
                                         const uint32_t (&v)[4]) {
  *reinterpret_cast<uint4*>(plane + q0) = make_uint4(v[0], v[1], v[2], v[3]);
}

// the subject planes of the block's positions p0..p0+np-1: KS ints per
// position copied from the subject columns of its target (s_gt[i]: the
// table row of position p0 + i, 0 past the end), lanes over the
// flattened (position, k) ints, 4 per lane as one 16-byte store (the last
// one may run into the padding)
__device__ __forceinline__ void put_subjects(const SigArgs& a, int32_t* ids,
                                             int32_t* vals, size_t p0,
                                             int np, const uint32_t* s_gt) {
  const int KS = a.KS, n = np * KS;
  uint4* out_ids = reinterpret_cast<uint4*>(ids + p0 * KS);
  uint4* out_vals = reinterpret_cast<uint4*>(vals + p0 * KS);
  for (int e = 4 * threadIdx.x; e < n; e += 4 * blockDim.x) {
    int q = e / KS, k = e - q * KS;
    uint32_t v[4], w[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const size_t src = (size_t)s_gt[q] * KS + k;
      v[m] = (uint32_t)a.t_sub_ids[src];
      w[m] = (uint32_t)a.t_sub_vals[src];
      if (++k == KS) {
        k = 0;
        ++q;
      }
    }
    out_ids[e / 4] = make_uint4(v[0], v[1], v[2], v[3]);
    out_vals[e / 4] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// W bytes per position, byte j = bit j of the position's `bits`: the quad's
// 4*W bytes as 16-byte stores where W % 4 == 0 (a word then never spans two
// positions), else as W words
__device__ __forceinline__ void put_bit_rows(uint8_t* plane, size_t q0, int W,
                                             const uint32_t (&bits)[4]) {
  uint32_t* out = reinterpret_cast<uint32_t*>(plane + q0 * W);
  int i = 0, j = 0;
  if (W % 4 == 0) {
    for (int c = 0; c < W / 4; ++c) {
      uint32_t v[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        v[m] = expand4((pick4(bits, i) >> j) & 0xfu);
        j += 4;
        if (j == W) {
          j = 0;
          ++i;
        }
      }
      reinterpret_cast<uint4*>(out)[c] = make_uint4(v[0], v[1], v[2], v[3]);
    }
    return;
  }
  for (int w = 0; w < W; ++w) {
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      v |= ((pick4(bits, i) >> j) & 1u) << (8 * b);
      if (++j == W) {
        j = 0;
        ++i;
      }
    }
    out[w] = v;
  }
}

// the planes of the quad q0..q0+3 of the rule (RULE) or policy segment, n
// positions in all, per_group of them per group, but the subject planes;
// the positions' table rows (0 past the end) to s_gt[0..3]
template <bool RULE, bool WITH_HR, bool WITH_REL>
__device__ __forceinline__ void quad_planes(const SigArgs& a, size_t q0,
                                            size_t n, size_t per_group,
                                            uint32_t* s_gt) {
  if (q0 >= n) {
    s_gt[0] = s_gt[1] = s_gt[2] = s_gt[3] = 0;
    return;
  }
  const int32_t* target = RULE ? a.rule_target : a.pol_target;
  uint32_t role[4], n_sub[4], coll[4], op[4], rs[4], rel[4];
  // the match-bit planes (rule: ex, rg; policy: ex_p, ex_d, rg_p, rg_d)
  uint32_t m0 = 0, m1 = 0, m2 = 0, m3 = 0;
  uint32_t has_role = 0, skip = 0, triv = 0, hrchk = 0, rel_dir = 0;
  size_t g = q0 / per_group, x = q0 - g * per_group;
#pragma unroll
  for (int i = 0; i < 4; ++i, ++x) {
    if (x == per_group) {
      x = 0;
      ++g;
    }
    const size_t q = q0 + i;
    const bool live = q < n;
    const uint32_t gt = live ? (uint32_t)(g * a.T + target[q]) : 0u;
    s_gt[i] = gt;
    const uint32_t* rec = a.comp + (size_t)gt * SP_REC;
    const uint4 r0 = *reinterpret_cast<const uint4*>(rec);
    const uint32_t f = r0.x;
    role[i] = r0.y;
    n_sub[i] = r0.z;
    coll[i] = r0.w;
    if (WITH_HR || WITH_REL) {
      const uint4 r1 = *reinterpret_cast<const uint4*>(rec + 4);
      op[i] = r1.x;
      rs[i] = r1.y;
      rel[i] = r1.z;
    }
    const int sh = 8 * i;
    const bool act = (f & TC_ACT) != 0;
    if (RULE) {
      const bool deny = live && a.rule_effect[q] == 2;
      m0 |= (uint32_t)(act && (f & (deny ? TC_EX_D : TC_EX_P))) << sh;
      m1 |= (uint32_t)(act && (f & (deny ? TC_RG_D : TC_RG_P))) << sh;
      skip |= (uint32_t)((f & RF_SKIP) != 0) << sh;
    } else {
      m0 |= (uint32_t)(act && (f & TC_EX_P)) << sh;
      m1 |= (uint32_t)(act && (f & TC_EX_D)) << sh;
      m2 |= (uint32_t)(act && (f & TC_RG_P)) << sh;
      m3 |= (uint32_t)(act && (f & TC_RG_D)) << sh;
    }
    has_role |= (uint32_t)((f & RF_HAS_ROLE) != 0) << sh;
    triv |= (uint32_t)((f & RF_TRIV) != 0) << sh;
    hrchk |= (uint32_t)((f & RF_HRCHK) != 0) << sh;
    rel_dir |= (uint32_t)((f & RF_REL_DIR) != 0) << sh;
  }
  if (RULE) {
    put_word(a.rl_ex, q0, m0);
    put_word(a.rl_rg, q0, m1);
    put_word(a.rl_skip, q0, skip);
  } else {
    put_word(a.pp_ex_p, q0, m0);
    put_word(a.pp_ex_d, q0, m1);
    put_word(a.pp_rg_p, q0, m2);
    put_word(a.pp_rg_d, q0, m3);
  }
  put_ints(RULE ? a.rl_role : a.pl_role, q0, role);
  put_word(RULE ? a.rl_has_role : a.pl_has_role, q0, has_role);
  put_ints(RULE ? a.rl_n_sub : a.pl_n_sub, q0, n_sub);
  if (WITH_HR || WITH_REL)
    put_bit_rows(RULE ? a.rl_collect : a.pl_collect, q0, a.NR, coll);
  if (WITH_HR) {
    put_bit_rows(RULE ? a.rl_op_hit : a.pl_op_hit, q0, a.NOP, op);
    put_word(RULE ? a.rl_triv : a.pl_triv, q0, triv);
    put_ints(RULE ? a.rl_rs : a.pl_rs, q0, rs);
    put_word(RULE ? a.rl_hrchk : a.pl_hrchk, q0, hrchk);
  }
  if (WITH_REL) {
    put_ints(RULE ? a.rl_rel_idx : a.pl_rel_idx, q0, rel);
    put_word(RULE ? a.rl_rel_dir : a.pl_rel_dir, q0, rel_dir);
  }
}

// the block b of the rule (RULE) or policy segment: a quad per thread,
// then the subject planes of all its positions
template <bool RULE, bool WITH_HR, bool WITH_REL>
__device__ __forceinline__ void block_planes(const SigArgs& a, long long b,
                                             size_t n, size_t per_group,
                                             uint32_t* s_gt) {
  const size_t per = (size_t)SP_QUAD * blockDim.x;
  const size_t p0 = (size_t)b * per;
  quad_planes<RULE, WITH_HR, WITH_REL>(a, p0 + SP_QUAD * threadIdx.x, n,
                                       per_group,
                                       s_gt + SP_QUAD * threadIdx.x);
  __syncthreads();
  put_subjects(a, RULE ? a.rl_sub_ids : a.pl_sub_ids,
               RULE ? a.rl_sub_vals : a.pl_sub_vals, p0,
               (int)(n - p0 < per ? n - p0 : per), s_gt);
}

// set sq (a warp): the multi-entity recheck (every signature entity exactly
// matches some valid policy's resources, PERMIT policies with properties
// excluded) with lanes over the set's policies, then the set planes
__device__ __forceinline__ void set_planes(const SigArgs& a, size_t sq) {
  const int lane = threadIdx.x & 31;
  const int g = (int)(sq / a.S), s = (int)(sq - (size_t)g * a.S);
  const size_t gt = (size_t)g * a.T + a.set_target[sq];
  const int32_t* pent = a.r_ent_vals + (size_t)g * a.NR;
  const uint8_t* pvalid = a.r_ent_valid + (size_t)g * a.NR;
  bool ok = true;
  for (int j = 0; j < a.NR && ok; ++j) {
    if (!pvalid[j]) continue;
    const int want = pent[j];
    bool hit = false;
    for (int kp0 = 0; kp0 < a.KP && !hit; kp0 += 32) {
      const int kp = kp0 + lane;
      bool h = false;
      if (kp < a.KP) {
        const int p = s * a.KP + kp;
        if (a.pol_valid[p] && !(a.pol_effect[p] == 1 && a.pol_has_props[p]))
          for (int k = 0; k < a.KE; ++k) {
            const int pe = a.pol_ent_vals[p * a.KE + k];
            if (pe >= 0 && pe == want) h = true;
          }
      }
      hit = __ballot_sync(0xffffffffu, h) != 0u;
    }
    ok = hit;
  }
  const uint32_t* rec = a.comp + gt * SP_REC;
  if (lane == 0) {
    const uint32_t f = rec[0];
    a.ss_ex_p[sq] = (f & TC_ACT) && (f & TC_EX_P);
    a.sl_role[sq] = (int32_t)rec[1];
    a.sl_has_role[sq] = (f & RF_HAS_ROLE) != 0;
    a.sl_n_sub[sq] = (int32_t)rec[2];
    a.multi_ok[sq] = ok;
  }
  for (int k = lane; k < a.KS; k += 32) {
    a.sl_sub_ids[sq * a.KS + k] = a.t_sub_ids[gt * a.KS + k];
    a.sl_sub_vals[sq * a.KS + k] = a.t_sub_vals[gt * a.KS + k];
  }
}

// the planes pass: blocks of the set, policy and rule segments in that
// order (a block's branch is uniform); shared memory: the table rows of a
// block's positions
template <bool WITH_HR, bool WITH_REL>
__global__ void __launch_bounds__(256) sig_planes_kernel(const SigArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_gt = reinterpret_cast<uint32_t*>(smem);
  const SpGrid gr = sp_grid(a, blockDim.x);
  long long b = blockIdx.x;
  if (b < gr.set_blocks) {
    const size_t sq = (size_t)b * (blockDim.x / 32) + threadIdx.x / 32;
    if (sq < gr.n_set) set_planes(a, sq);
    return;
  }
  b -= gr.set_blocks;
  if (b < gr.pol_blocks) {
    block_planes<false, WITH_HR, WITH_REL>(a, b, gr.n_pol,
                                           (size_t)a.S * a.KP, s_gt);
    return;
  }
  block_planes<true, WITH_HR, WITH_REL>(a, b - gr.pol_blocks, gr.n_rule,
                                        (size_t)a.S * a.KP * a.KR, s_gt);
}

// an empty kernel: the launch floor of a grid (acs_sig_planes_floor)
__global__ void sig_planes_floor_kernel(const SigArgs) {}

// one launch of `kernel` over `grid` blocks (none when the grid is empty)
// with `smem` bytes of shared memory
template <class K>
static int launch(K kernel, long long grid, int threads, size_t smem,
                  const SigArgs& a, cudaStream_t stream) {
  if (grid <= 0) return 0;
  kernel<<<(int)grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the two launches of a variant (or, with `floor`, the empty kernel over
// both grids); the first failure's code
template <bool WITH_HR, bool WITH_REL>
static int launch_planes(const SigArgs& a, int threads, cudaStream_t stream,
                         bool floor) {
  const SpGrid gr = sp_grid(a, threads);
  const long long grid = gr.set_blocks + gr.pol_blocks + gr.rule_blocks;
  const size_t smem = sizeof(uint32_t) * SP_QUAD * threads;
  int code = floor ? launch(sig_planes_floor_kernel, gr.comp_blocks, threads,
                            0, a, stream)
                   : launch(sig_planes_comp_kernel<WITH_HR, WITH_REL>,
                            gr.comp_blocks, threads, 0, a, stream);
  if (code != 0) return code;
  return floor ? launch(sig_planes_floor_kernel, grid, threads, smem, a,
                        stream)
               : launch(sig_planes_kernel<WITH_HR, WITH_REL>, grid, threads,
                        smem, a, stream);
}

// whole warps, at most the kernels' launch bound
static bool sp_threads_ok(int threads) {
  return threads >= 32 && threads <= 256 && threads % 32 == 0;
}

extern "C" {

// "ptr,ptr,...|dim,dim,..." : the argument order, checked by the host
const char* acs_sig_planes_layout() {
  return SP_PTRS(ACS_NAME) "|" SP_DIMS(ACS_DIM_NAME);
}

// launches the component pass and the planes pass on `stream`; returns
// cudaGetLastError() after a launch, or -1 when the argument counts, the
// block shape or the variant's planes do not match this build
int acs_sig_planes(const int64_t* ptrs, int n_ptrs, const int32_t* dims,
                   int n_dims, int with_hr, int with_rel, int threads,
                   void* stream_ptr) {
  if (n_ptrs != kSpPtrs || n_dims != kSpDims || !sp_threads_ok(threads))
    return -1;
  SigArgs sa;
  SigArgs* a = &sa;
  int i = 0;
  SP_PTRS(ACS_SET_PTR)
  i = 0;
  SP_DIMS(ACS_SET_DIM)
  if (sa.G == 0) return 0;
  if (sa.comp == nullptr) return -1;
  // a plane of no elements may come as a null pointer: nothing writes it
  if ((with_hr || with_rel) &&
      ((sa.NR > 0 && sa.rl_collect == nullptr) || sa.NR > MAX_NR))
    return -1;
  if ((with_hr && sa.NOP > 0 && sa.rl_op_hit == nullptr) ||
      (with_rel && sa.rl_rel_idx == nullptr))
    return -1;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (with_hr)
    return with_rel ? launch_planes<true, true>(sa, threads, stream, false)
                    : launch_planes<true, false>(sa, threads, stream, false);
  return with_rel ? launch_planes<false, true>(sa, threads, stream, false)
                  : launch_planes<false, false>(sa, threads, stream, false);
}

// launches the empty kernel over the grids of both launches of the shapes
// `dims`: the launch floor, for timing only (-1 on a count mismatch or a
// bad block shape)
int acs_sig_planes_floor(const int32_t* dims, int n_dims, int threads,
                         void* stream_ptr) {
  if (n_dims != kSpDims || !sp_threads_ok(threads)) return -1;
  SigArgs sa = {};
  SigArgs* a = &sa;
  int i = 0;
  SP_DIMS(ACS_SET_DIM)
  if (sa.G == 0) return 0;
  return launch_planes<false, false>(
      sa, threads, reinterpret_cast<cudaStream_t>(stream_ptr), true);
}

// resident blocks per SM of the planes pass of the variant in blocks of
// `threads` threads (cudaOccupancyMaxActiveBlocksPerMultiprocessor), -1 on
// a bad block shape or a failed query
int acs_sig_planes_occupancy(int with_hr, int with_rel, int threads) {
  if (!sp_threads_ok(threads)) return -1;
  void (*kernel)(const SigArgs) =
      with_hr ? (with_rel ? sig_planes_kernel<true, true>
                          : sig_planes_kernel<true, false>)
              : (with_rel ? sig_planes_kernel<false, true>
                          : sig_planes_kernel<false, false>);
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, threads, sizeof(uint32_t) * SP_QUAD * threads);
  return err != cudaSuccess ? -1 : blocks;
}

}  // extern "C"
