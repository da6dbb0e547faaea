// whatIsAllowed planes kernel for Hopper (sm_90a): K5 of the port.
//
// Replaces the JAX package's ops/reverse.py ReverseQueryKernel._runner
// (_match_targets in components mode with wia=True and with_hr=False,
// vmapped over one representative row per new resource signature, the
// seven planes stacked in _PLANE_KEYS order).  Host side:
// access_control_srv_tpu_torch/ops/kernel.py (wia_planes); the plain
// PyTorch version it is held against: ops/reverse_ref.py wia_planes_ref.
// It runs once per plane-cache miss set.
//
// Output: uint8 [N, 7, T], per representative row n and target row t
//   0 sig_wia_ex_p = no_res | ((ent_any_ex | opm) & ~(has_props & ~r_has_props & ent_any_ex))
//   1 sig_wia_ex_d = no_res | ent_any_ex | opm
//   2 sig_wia_rg_p = no_res | (state_final_rg & ~(has_props & ~r_has_props & state_any_rg))
//   3 sig_wia_rg_d = no_res | state_final_rg
//   4 sig_maybe_ex = has_props & ent_any_ex
//   5 sig_maybe_rg = has_props & state_any_rg
//   6 sig_act_ok
// The regex branch takes the sticky state after the LAST run (a later
// prefix mismatch resets it); the PERMIT property-fail takes the state at
// ANY run.  No plane reads the property gates of stage A, so the request
// properties and the target tails and property columns are not read.
//
// What bounds it: bytes.  The planes written are N * 7 * T bytes (at 256
// rows and T = 100,000: 179 MB, 0.053 ms at 3.35 TB/s); the target table
// (a few dozen bytes per row) is read once and every packed row is a few
// hundred bytes.  The work per (row, target) is the stage-A compare chain,
// which a thread per (row, target) re-reading the target's columns and
// every empty request slot made the limit instead.
//
// Design: two launches behind one launcher (launch_planes).
// 1. wia_rows_kernel, a warp per representative row: the row's valid
//    entity runs, valid operation values and valid action pairs as
//    compacted lists (lanes over a list's slots, each valid entry placed by
//    a ballot), and each valid run's regex and prefix-mismatch outcomes
//    over the W regex rows as two bitsets, into rows_c (scratch the host
//    carves after the planes): done once per row, not once per target tile.
// 2. wia_planes_kernel: a block takes a tile of TT target rows and RB rows
//    (acs_wia_planes_tile sizes both from the shapes).  It copies the
//    tile's target columns into shared memory as they lie in the table,
//    with 16-byte loads (action pairs, entity values and regex rows,
//    operation values; and a flags word: no resources, has properties),
//    and its rows' compacted lists.  Each thread then owns 4 consecutive
//    targets and loops over the block's rows: it holds their flags and
//    first action and entity slots in registers (later slots, where one of
//    the 4 uses them, read per row), walks each row's lists once for all 4
//    (the sticky regex state carried over the valid runs only, in order; a
//    regex lookup is a shared-memory bit, not a scattered global byte
//    load), and writes each of the seven planes as one 32-bit store (byte
//    stores where a plane row does not start 4-byte aligned, or at the
//    table's end).  Pad rows (all zeros) are computed like any other row.

#include "decide_core.cuh"

#define WIA_PLANES 7

#define WP_PTRS(X)                                                           \
  X(const int32_t*, t_act_ids) X(const int32_t*, t_act_vals)                 \
  X(const int32_t*, t_ent_vals) X(const int32_t*, t_ent_w)                   \
  X(const int32_t*, t_ent_tails) X(const int32_t*, t_op_vals)                \
  X(const int32_t*, t_prop_vals) X(const int32_t*, t_prop_sfx)               \
  X(const uint8_t*, t_has_props) X(const int32_t*, t_n_res)                  \
  X(const int32_t*, rows) X(const uint8_t*, rgx_set)                         \
  X(const uint8_t*, pfx_neq) X(uint8_t*, planes) X(int32_t*, rows_c)

// the block shape ends the shape ints: target rows per tile, rows per block
#define WP_DIMS(X)                                                           \
  X(N) X(T) X(KA) X(KE) X(KO) X(KPR) X(NACT) X(NR) X(NP) X(NOP) X(W) X(E)    \
  X(WROW) X(O_ACT_IDS) X(O_ACT_VALS) X(O_ENT_VALS) X(O_ENT_E)                \
  X(O_ENT_VALID) X(O_PROP_VALS) X(O_PROP_SFX) X(O_PROP_RUN) X(O_PROP_TAIL)   \
  X(O_OP_VALS) X(O_HAS_PROPS) X(TT) X(RB)

struct WiaArgs {
  WP_PTRS(ACS_FIELD)
  WP_DIMS(ACS_DIM_FIELD)
};

static const int kWpPtrs = 0 WP_PTRS(ACS_COUNT);
static const int kWpDims = 0 WP_DIMS(ACS_COUNT);

// the flags word of a staged target row: no resources, has properties
enum : uint32_t { WF_NO_RES = 1, WF_HAS_PROPS = 2 };

// a staged row's header ints before its lists: valid runs, valid
// operations, valid action pairs, has-props
#define WIA_ROW_HEAD 4

// the block's shared memory, in ints from its start: the target columns
// as they lie in the table (each [TT][K]: action ids, action values,
// entity values, entity regex rows, operation values), the flags words
// [TT], then per row the header and its lists (run values [NR], run regex
// columns [NR], operation values [NOP], action ids [NACT], action values
// [NACT], then per run slot the regex and prefix-mismatch bitsets over
// the W regex rows, WW words each)
struct WiaSmem {
  int aid, aval, ev, ew, ov, flags, rows, WW, row_ints, bytes;
};

// the ints of a compacted row (rows_c, and its copy in shared memory)
__host__ __device__ inline int wia_row_ints(const WiaArgs& a) {
  return WIA_ROW_HEAD + 2 * a.NR + a.NOP + 2 * a.NACT +
         2 * a.NR * ((a.W + 31) / 32);
}

__host__ __device__ inline WiaSmem wia_smem(const WiaArgs& a, int TT,
                                            int RB) {
  WiaSmem s;
  s.aid = 0;
  s.aval = s.aid + a.KA * TT;
  s.ev = s.aval + a.KA * TT;
  s.ew = s.ev + a.KE * TT;
  s.ov = s.ew + a.KE * TT;
  s.flags = s.ov + a.KO * TT;
  s.rows = s.flags + TT;
  s.WW = (a.W + 31) / 32;
  s.row_ints = wia_row_ints(a);
  s.bytes = (int)align_up((size_t)(s.rows + RB * s.row_ints) * 4, 16);
  return s;
}

// the 4 ints at p (16-byte aligned) as an array
__device__ __forceinline__ void load4(const int32_t* p, int (&v)[4]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  v[0] = (int)u.x; v[1] = (int)u.y; v[2] = (int)u.z; v[3] = (int)u.w;
}

// the tile's n ints of one column array (src: its first; 16-byte aligned
// where the table is, the tile starting at a multiple of 4 rows) into dst,
// -1 from n up to cap (a multiple of 4), with 16-byte loads and stores
__device__ __forceinline__ void copy_cols(int32_t* dst, const int32_t* src,
                                          int n, int cap) {
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15u) == 0;
  for (int e = 4 * threadIdx.x; e < cap; e += 4 * blockDim.x) {
    uint4 v;
    if (vec && e + 4 <= n) {
      v = *reinterpret_cast<const uint4*>(src + e);
    } else {
      v.x = (uint32_t)(e < n ? src[e] : -1);
      v.y = (uint32_t)(e + 1 < n ? src[e + 1] : -1);
      v.z = (uint32_t)(e + 2 < n ? src[e + 2] : -1);
      v.w = (uint32_t)(e + 3 < n ? src[e + 3] : -1);
    }
    *reinterpret_cast<uint4*>(dst + e) = v;
  }
}

// slot k of the targets tq..tq+3 of a staged column with K slots a row
__device__ __forceinline__ void slot4(const int32_t* col, int K, int tq,
                                      int k, int (&v)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = col[(tq + i) * K + k];
}

// 1 + the last slot of a K-slot column (or of either of two) that holds a
// value (>= 0) for one of the targets tq..tq+3, 0 for none: the slots a
// quad walks
__device__ __forceinline__ int slots_used(const int32_t* col,
                                          const int32_t* col2, int K,
                                          int tq) {
  int used = 0;
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = (tq + i) * K + k;
      if (col[j] >= 0 || (col2 != nullptr && col2[j] >= 0)) used = k + 1;
    }
  return used;
}

// the targets (bit i: target i) whose action pair of one slot (x id, y
// value; x < 0: no pair) is among the row's n compacted pairs
__device__ __forceinline__ uint32_t act_slot(const int (&x)[4],
                                             const int (&y)[4],
                                             const int32_t* aid,
                                             const int32_t* aval, int n) {
  uint32_t ok = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) ok |= (uint32_t)(x[i] < 0) << i;
  for (int m = 0; m < n; ++m) {  // the row's ids are valid (>= 0)
    const int id = aid[m], val = aval[m];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ok |= (uint32_t)(x[i] == id && y[i] == val) << i;
  }
  return ok;
}

// one entity slot (x values, y regex rows; < 0: none) of the targets
// against one valid run (value ev, its regex and prefix-mismatch bitsets):
// the exact hits into ex, the regex hits and prefix mismatches into hit
// and pf
__device__ __forceinline__ void ent_slot(const int (&x)[4], const int (&y)[4],
                                         int ev, const uint32_t* rgv,
                                         const uint32_t* pfv, uint32_t& ex,
                                         uint32_t& hit, uint32_t& pf) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (x[i] >= 0 && x[i] == ev) ex |= 1u << i;
    if (y[i] >= 0) {
      const int wd = y[i] >> 5, bt = y[i] & 31;
      hit |= ((rgv[wd] >> bt) & 1u) << i;
      pf |= ((pfv[wd] >> bt) & 1u) << i;
    }
  }
}

// row n as compacted lists into h (wia_row_ints ints), a warp: lanes over
// a list's slots, each valid entry placed by a ballot, so a row costs one
// round of loads; then each valid run's regex and prefix-mismatch bits
// over the regex rows, lanes over 32 regex rows a word
__device__ __forceinline__ void compact_row(const WiaArgs& a, int n,
                                            int32_t* h) {
  const int lane = threadIdx.x & 31;
  const uint32_t below = (1u << lane) - 1u;
  const int WW = (a.W + 31) / 32;
  const int32_t* row = a.rows + (size_t)n * a.WROW;
  int32_t* run_v = h + WIA_ROW_HEAD;
  int32_t* run_c = run_v + a.NR;
  int32_t* ops = run_c + a.NR;
  int32_t* aid = ops + a.NOP;
  int32_t* aval = aid + a.NACT;
  uint32_t* bits = reinterpret_cast<uint32_t*>(aval + a.NACT);
  // entity runs and operation slots: NR, NOP <= 32
  const bool run_ok = lane < a.NR && row[a.O_ENT_VALID + lane] != 0;
  const uint32_t runs = __ballot_sync(0xffffffffu, run_ok);
  if (run_ok) {
    const int at = __popc(runs & below);
    run_v[at] = row[a.O_ENT_VALS + lane];
    run_c[at] = max(row[a.O_ENT_E + lane], 0);
  }
  const int op = lane < a.NOP ? row[a.O_OP_VALS + lane] : -1;
  const uint32_t op_ok = __ballot_sync(0xffffffffu, op >= 0);
  if (op >= 0) ops[__popc(op_ok & below)] = op;
  int n_act = 0;
  for (int j0 = 0; j0 < a.NACT; j0 += 32) {
    const int j = j0 + lane;
    const int id = j < a.NACT ? row[a.O_ACT_IDS + j] : -1;
    const uint32_t act_ok = __ballot_sync(0xffffffffu, id >= 0);
    if (id >= 0) {
      const int at = n_act + __popc(act_ok & below);
      aid[at] = id;
      aval[at] = row[a.O_ACT_VALS + j];
    }
    n_act += __popc(act_ok);
  }
  if (lane == 0) {
    h[0] = __popc(runs);
    h[1] = __popc(op_ok);
    h[2] = n_act;
    h[3] = row[a.O_HAS_PROPS] != 0;
  }
  __syncwarp();  // the lanes' run columns, written above, read back
  for (int v = 0; v < __popc(runs); ++v) {
    const size_t ec = (size_t)run_c[v];
    for (int w = 0; w < WW; ++w) {
      const int wv = 32 * w + lane;
      const bool in = wv < a.W;
      const bool rg = in && a.rgx_set[(size_t)wv * a.E + ec] != 0;
      const bool pf = in && a.pfx_neq[(size_t)wv * a.E + ec] != 0;
      const uint32_t rg_word = __ballot_sync(0xffffffffu, rg);
      const uint32_t pf_word = __ballot_sync(0xffffffffu, pf);
      if (lane == 0) {
        bits[v * WW + w] = rg_word;
        bits[(a.NR + v) * WW + w] = pf_word;
      }
    }
  }
}

// pass 1: a warp per representative row, its compacted lists to rows_c
__global__ void __launch_bounds__(256) wia_rows_kernel(const WiaArgs a) {
  const int n = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  if (n < a.N) compact_row(a, n, a.rows_c + (size_t)n * wia_row_ints(a));
}

__global__ void __launch_bounds__(256) wia_planes_kernel(const WiaArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int TT = a.TT;
  const int tiles = (a.T + TT - 1) / TT;
  const int t_lo = (blockIdx.x % tiles) * TT;
  const int n_lo = (blockIdx.x / tiles) * a.RB;
  const int nt = min(TT, a.T - t_lo);
  const int nr = min(a.RB, a.N - n_lo);
  const WiaSmem L = wia_smem(a, TT, a.RB);
  int32_t* s = reinterpret_cast<int32_t*>(smem);

  // ---- the tile's target columns as they lie in the table (-1 past its
  // end), and each target's flags word
  const size_t t_base = (size_t)t_lo;
  copy_cols(s + L.aid, a.t_act_ids + t_base * a.KA, nt * a.KA, TT * a.KA);
  copy_cols(s + L.aval, a.t_act_vals + t_base * a.KA, nt * a.KA, TT * a.KA);
  copy_cols(s + L.ev, a.t_ent_vals + t_base * a.KE, nt * a.KE, TT * a.KE);
  copy_cols(s + L.ew, a.t_ent_w + t_base * a.KE, nt * a.KE, TT * a.KE);
  copy_cols(s + L.ov, a.t_op_vals + t_base * a.KO, nt * a.KO, TT * a.KO);
  for (int t = threadIdx.x; t < TT; t += blockDim.x) {
    const size_t gt = t_base + t;
    s[L.flags + t] = t < nt ? (int)((a.t_n_res[gt] == 0 ? WF_NO_RES : 0u) |
                                    (a.t_has_props[gt] ? WF_HAS_PROPS : 0u))
                            : 0;
  }
  // ---- the block's rows, compacted by the first pass
  const int row_ints = L.row_ints;
  const int32_t* rows_c = a.rows_c + (size_t)n_lo * row_ints;
  for (int e = threadIdx.x; e < nr * row_ints; e += blockDim.x)
    s[L.rows + e] = rows_c[e];
  __syncthreads();

  // ---- a thread per 4 consecutive targets over the block's rows: the
  // targets' flags and first action and entity slots held in registers,
  // each row's lists read from shared memory (one address per warp)
  const int qpr = TT / 4;
  const int per_row = min(qpr, (int)blockDim.x);
  const int row_step = blockDim.x / per_row;
  for (int qd = threadIdx.x % per_row; qd < qpr; qd += per_row) {
    const int tq = 4 * qd, t0 = t_lo + tq;
    if (t0 >= a.T) break;
    int fl[4], ax[4] = {-1, -1, -1, -1}, ay[4] = {-1, -1, -1, -1};
    int ev0[4] = {-1, -1, -1, -1}, ew0[4] = {-1, -1, -1, -1}, x[4], y[4];
    load4(s + L.flags + tq, fl);
    const int ka = slots_used(s + L.aid, nullptr, a.KA, tq);
    const int ke = slots_used(s + L.ev, s + L.ew, a.KE, tq);
    const int ko = slots_used(s + L.ov, nullptr, a.KO, tq);
    if (ka > 0) {
      slot4(s + L.aid, a.KA, tq, 0, ax);
      slot4(s + L.aval, a.KA, tq, 0, ay);
    }
    if (ke > 0) {
      slot4(s + L.ev, a.KE, tq, 0, ev0);
      slot4(s + L.ew, a.KE, tq, 0, ew0);
    }
    uint32_t no_res = 0, has_props = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      no_res |= ((uint32_t)fl[i] & WF_NO_RES) << i;
      has_props |= (((uint32_t)fl[i] & WF_HAS_PROPS) >> 1) << i;
    }
    const bool whole = t0 + 4 <= a.T;
    for (int r = threadIdx.x / per_row; r < nr; r += row_step) {
      const int32_t* h = s + L.rows + r * L.row_ints;
      const int32_t* run_v = h + WIA_ROW_HEAD;
      const int32_t* ops = run_v + 2 * a.NR;
      const int32_t* aid = ops + a.NOP;
      const int32_t* aval = aid + a.NACT;
      const uint32_t* rg_bits =
          reinterpret_cast<const uint32_t*>(aval + a.NACT);
      const uint32_t* pf_bits = rg_bits + a.NR * L.WW;
      const int n_run = h[0], n_op = h[1], n_act = h[2];

      // action pairs: every valid target pair among the row's
      uint32_t act = act_slot(ax, ay, aid, aval, n_act);
      for (int k = 1; k < ka; ++k) {
        slot4(s + L.aid, a.KA, tq, k, x);
        slot4(s + L.aval, a.KA, tq, k, y);
        act &= act_slot(x, y, aid, aval, n_act);
      }
      // entities over the valid runs in order: exact hits, and the sticky
      // regex state (set on a hit, reset on a prefix mismatch without one)
      uint32_t ex = 0, carry = 0, any_rg = 0;
      for (int v = 0; v < n_run; ++v) {
        const int ev = run_v[v];
        const uint32_t* rgv = rg_bits + v * L.WW;
        const uint32_t* pfv = pf_bits + v * L.WW;
        uint32_t hit = 0, pf = 0;
        if (ke > 0) ent_slot(ev0, ew0, ev, rgv, pfv, ex, hit, pf);
        for (int k = 1; k < ke; ++k) {
          slot4(s + L.ev, a.KE, tq, k, x);
          slot4(s + L.ew, a.KE, tq, k, y);
          ent_slot(x, y, ev, rgv, pfv, ex, hit, pf);
        }
        carry = hit | (carry & ~(pf & ~hit));
        any_rg |= carry;
      }
      // operations (exact mode)
      uint32_t opm = 0;
      for (int m = 0; m < n_op; ++m) {
        for (int k = 0; k < ko; ++k) {
          slot4(s + L.ov, a.KO, tq, k, x);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (x[i] == ops[m]) opm |= 1u << i;
        }
      }
      const uint32_t fail_ex = h[3] ? 0u : has_props & ex;
      const uint32_t fail_rg = h[3] ? 0u : has_props & any_rg;
      const uint32_t bits[WIA_PLANES] = {
          no_res | ((ex | opm) & ~fail_ex), no_res | ex | opm,
          no_res | (carry & ~fail_rg),      no_res | carry,
          has_props & ex,                   has_props & any_rg,
          act};
      uint8_t* out = a.planes + (size_t)(n_lo + r) * WIA_PLANES * a.T + t0;
      if (whole && (a.T & 3) == 0 &&
          (reinterpret_cast<uintptr_t>(out) & 3u) == 0) {
        // every plane row of the row starts word-aligned
#pragma unroll
        for (int p = 0; p < WIA_PLANES; ++p)
          *reinterpret_cast<uint32_t*>(out + (size_t)p * a.T) =
              expand4(bits[p]);
        continue;
      }
#pragma unroll
      for (int p = 0; p < WIA_PLANES; ++p) {
        uint8_t* dst = out + (size_t)p * a.T;
        if (whole && (reinterpret_cast<uintptr_t>(dst) & 3u) == 0) {
          *reinterpret_cast<uint32_t*>(dst) = expand4(bits[p]);
        } else {
          for (int i = 0; i < 4 && t0 + i < a.T; ++i)
            dst[i] = (uint8_t)((bits[p] >> i) & 1u);
        }
      }
    }
  }
}

// an empty kernel: the launch floor of a grid (acs_wia_planes_floor)
__global__ void wia_planes_floor_kernel(const WiaArgs) {}

// the grid of a launch: target tiles times row blocks
static int wia_grid(const WiaArgs& a) {
  return ((a.T + a.TT - 1) / a.TT) * ((a.N + a.RB - 1) / a.RB);
}

// whether the block shape of `a` is one the kernel takes (the rows pass
// holds a list's slots in one warp's lanes: NR, NOP <= 32)
static bool wia_shape_ok(const WiaArgs& a, int threads) {
  return a.TT >= 4 && (a.TT & (a.TT - 1)) == 0 && a.RB >= 1 &&
         a.NR <= 32 && a.NOP <= 32 && threads >= 32 && threads <= 256 &&
         threads % 32 == 0;
}

// one launch of `kernel` over `grid` blocks with `smem` bytes of shared
// memory (opted in above the default)
template <class K>
static int launch(K kernel, int grid, int threads, int smem,
                  const WiaArgs& a, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the two launches (or, with `floor`, the empty kernel over both grids):
// the rows pass, a warp per row, then the planes pass over target tiles x
// row blocks; the first failure's code
static int launch_planes(const WiaArgs& a, int threads, cudaStream_t stream,
                         bool floor) {
  const int row_blocks = (a.N * 32 + threads - 1) / threads;
  const int smem = wia_smem(a, a.TT, a.RB).bytes;
  const int code =
      launch(floor ? wia_planes_floor_kernel : wia_rows_kernel, row_blocks,
             threads, 0, a, stream);
  if (code != 0) return code;
  return launch(floor ? wia_planes_floor_kernel : wia_planes_kernel,
                wia_grid(a), threads, smem, a, stream);
}

// the shape ints of `a` from the host's array; false on a count mismatch
static bool wia_dims(WiaArgs* a, const int32_t* dims, int n_dims) {
  if (n_dims != kWpDims) return false;
  int i = 0;
  WP_DIMS(ACS_SET_DIM)
  return true;
}

extern "C" {

// "ptr,ptr,...|dim,dim,..." : the argument order, checked by the host
const char* acs_wia_planes_layout() {
  return WP_PTRS(ACS_NAME) "|" WP_DIMS(ACS_DIM_NAME);
}

// the block shape for the shapes `dims` (their TT and RB ignored) on n_sm
// SMs under stage = {target rows per tile at most, rows per block at most,
// blocks per SM, shared bytes per block}: out[0] TT, the largest power of
// two target rows, at most stage[0], whose block fits stage[3] bytes;
// out[1] RB, the fewest rows per block (at most stage[1]) that keep the
// grid within stage[2] blocks per SM; out[2] the ints of a compacted row
// (rows_c holds N of them).  -1 on a count mismatch or when no tile fits.
int acs_wia_planes_tile(const int32_t* dims, int n_dims, int n_sm,
                        const int32_t* stage, int32_t* out) {
  WiaArgs a = {};
  if (!wia_dims(&a, dims, n_dims) || n_sm < 1 || stage[0] < 4) return -1;
  int tt = 4;
  while (tt * 2 <= stage[0]) tt *= 2;
  while (tt > 4 && wia_smem(a, tt, stage[1]).bytes > stage[3]) tt /= 2;
  if (wia_smem(a, tt, stage[1]).bytes > stage[3]) return -1;
  const long long tiles = (a.T + tt - 1) / tt;
  const long long room = (long long)stage[2] * n_sm;
  const long long rb = (a.N * tiles + room - 1) / room;
  out[0] = tt;
  out[1] = (int)(rb < 1 ? 1 : rb > stage[1] ? stage[1] : rb);
  out[2] = wia_row_ints(a);
  return 0;
}

// launches the rows pass and the planes pass on `stream`; returns
// cudaGetLastError() after a launch, or -1 when the argument counts or the
// block shape do not match this build or the rows scratch is missing
int acs_wia_planes(const int64_t* ptrs, int n_ptrs, const int32_t* dims,
                   int n_dims, int threads, void* stream_ptr) {
  if (n_ptrs != kWpPtrs) return -1;
  WiaArgs sa;
  WiaArgs* a = &sa;
  int i = 0;
  WP_PTRS(ACS_SET_PTR)
  if (!wia_dims(&sa, dims, n_dims) || !wia_shape_ok(sa, threads) ||
      sa.rows_c == nullptr)
    return -1;
  if (sa.N == 0 || sa.T == 0) return 0;
  return launch_planes(sa, threads,
                       reinterpret_cast<cudaStream_t>(stream_ptr), false);
}

// launches the empty kernel over the grids and shared memory the two
// launches of the shapes `dims` take: the launch floor, for timing only
// (-1 on a count mismatch or a bad block shape)
int acs_wia_planes_floor(const int32_t* dims, int n_dims, int threads,
                         void* stream_ptr) {
  WiaArgs sa = {};
  if (!wia_dims(&sa, dims, n_dims) || !wia_shape_ok(sa, threads)) return -1;
  if (sa.N == 0 || sa.T == 0) return 0;
  return launch_planes(sa, threads,
                       reinterpret_cast<cudaStream_t>(stream_ptr), true);
}

// resident blocks per SM at the shapes `dims` in blocks of `threads`
// threads (cudaOccupancyMaxActiveBlocksPerMultiprocessor), -1 on a count
// mismatch, a bad block shape or a failed query
int acs_wia_planes_occupancy(const int32_t* dims, int n_dims, int threads) {
  WiaArgs sa = {};
  if (!wia_dims(&sa, dims, n_dims) || !wia_shape_ok(sa, threads)) return -1;
  const int smem = wia_smem(sa, sa.TT, sa.RB).bytes;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(wia_planes_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, wia_planes_kernel, threads, smem);
  return err != cudaSuccess ? -1 : blocks;
}

}  // extern "C"
