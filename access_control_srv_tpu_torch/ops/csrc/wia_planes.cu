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
// ANY run.
//
// What bounds it: bytes.  The planes written are N * 7 * T bytes (at 256
// rows and T = 100,000: 179 MB, 0.053 ms at 3.35 TB/s); the target table
// (a few dozen bytes per row) is read once and every packed row is a few
// hundred bytes.  The work per (row, target) is the stage-A compare chain.
//
// Design: the blocks tile (row, target range): block x handles row
// x / tiles and the x % tiles-th slice of the target rows, and its threads
// stride over that slice, so consecutive threads write consecutive bytes
// of each plane.  Each thread runs the dense kernel's per-target stage A
// (target_components in decide_core.cuh: exact and regex entity hits, the
// sticky regex scan with prefix resets, operation hits, the action pair
// subset) against the row, seen as a batch of one through pointers into
// the packed int32 row buffer, and folds the TR_* raw bits into the seven
// planes.  Pad rows (all zeros) are computed like any other row.

#include "decide_core.cuh"

#define WIA_PLANES 7
// target rows per thread and tile: sizes the tiles of large trees
#define WIA_ROWS_PER_THREAD 4

#define WP_PTRS(X)                                                           \
  X(const int32_t*, t_act_ids) X(const int32_t*, t_act_vals)                 \
  X(const int32_t*, t_ent_vals) X(const int32_t*, t_ent_w)                   \
  X(const int32_t*, t_ent_tails) X(const int32_t*, t_op_vals)                \
  X(const int32_t*, t_prop_vals) X(const int32_t*, t_prop_sfx)               \
  X(const uint8_t*, t_has_props) X(const int32_t*, t_n_res)                  \
  X(const int32_t*, rows) X(const uint8_t*, rgx_set)                         \
  X(const uint8_t*, pfx_neq) X(uint8_t*, planes)

#define WP_DIMS(X)                                                           \
  X(N) X(T) X(KA) X(KE) X(KO) X(KPR) X(NACT) X(NR) X(NP) X(NOP) X(W) X(E)    \
  X(WROW) X(O_ACT_IDS) X(O_ACT_VALS) X(O_ENT_VALS) X(O_ENT_E)                \
  X(O_ENT_VALID) X(O_PROP_VALS) X(O_PROP_SFX) X(O_PROP_RUN) X(O_PROP_TAIL)   \
  X(O_OP_VALS) X(O_HAS_PROPS)

struct WiaArgs {
  WP_PTRS(ACS_FIELD)
  WP_DIMS(ACS_DIM_FIELD)
  int tiles;  // target-range tiles per row, set by the launcher
};

static const int kWpPtrs = 0 WP_PTRS(ACS_COUNT);
static const int kWpDims = 0 WP_DIMS(ACS_COUNT);

// one packed row as a batch of one (b = 0), under the field names
// target_components reads
struct WiaRow {
  const int32_t *t_act_ids, *t_act_vals, *t_ent_vals, *t_ent_w;
  const int32_t *t_ent_tails, *t_op_vals, *t_prop_vals, *t_prop_sfx;
  const uint8_t* t_has_props;
  const int32_t* t_n_res;
  const int32_t *r_act_ids, *r_act_vals, *r_ent_vals, *r_ent_e, *r_ent_valid;
  const int32_t *r_prop_vals, *r_prop_sfx, *r_prop_run, *r_prop_tail;
  const int32_t *r_op_vals, *r_has_props;
  const uint8_t *rgx_set, *pfx_neq;
  int KA, KE, KO, KPR, NACT, NR, NP, NOP, E;
};

__device__ __forceinline__ WiaRow row_view(const WiaArgs& a, int n) {
  const int32_t* row = a.rows + (size_t)n * a.WROW;
  WiaRow v;
  v.t_act_ids = a.t_act_ids; v.t_act_vals = a.t_act_vals;
  v.t_ent_vals = a.t_ent_vals; v.t_ent_w = a.t_ent_w;
  v.t_ent_tails = a.t_ent_tails; v.t_op_vals = a.t_op_vals;
  v.t_prop_vals = a.t_prop_vals; v.t_prop_sfx = a.t_prop_sfx;
  v.t_has_props = a.t_has_props; v.t_n_res = a.t_n_res;
  v.r_act_ids = row + a.O_ACT_IDS; v.r_act_vals = row + a.O_ACT_VALS;
  v.r_ent_vals = row + a.O_ENT_VALS; v.r_ent_e = row + a.O_ENT_E;
  v.r_ent_valid = row + a.O_ENT_VALID;
  v.r_prop_vals = row + a.O_PROP_VALS; v.r_prop_sfx = row + a.O_PROP_SFX;
  v.r_prop_run = row + a.O_PROP_RUN; v.r_prop_tail = row + a.O_PROP_TAIL;
  v.r_op_vals = row + a.O_OP_VALS; v.r_has_props = row + a.O_HAS_PROPS;
  v.rgx_set = a.rgx_set; v.pfx_neq = a.pfx_neq;
  v.KA = a.KA; v.KE = a.KE; v.KO = a.KO; v.KPR = a.KPR; v.NACT = a.NACT;
  v.NR = a.NR; v.NP = a.NP; v.NOP = a.NOP; v.E = a.E;
  return v;
}

__global__ void wia_planes_kernel(const WiaArgs a) {
  const int n = blockIdx.x / a.tiles;
  const int tile = blockIdx.x % a.tiles;
  const int span = (a.T + a.tiles - 1) / a.tiles;
  const int t_end = min(a.T, (tile + 1) * span);
  const WiaRow v = row_view(a, n);
  const bool r_has_props = v.r_has_props[0] != 0;
  uint8_t* out = a.planes + (size_t)n * WIA_PLANES * a.T;
  for (int t = tile * span + threadIdx.x; t < t_end; t += blockDim.x) {
    const TargetComp c = target_components(v, 0, t, false);
    const bool ent_ex = c.raw & TR_ENT_EX;
    const bool opm = c.raw & TR_OPM;
    const bool final_rg = c.raw & TR_FINAL_RG;
    const bool any_rg = c.raw & TR_ANY_RG;
    const bool no_res = a.t_n_res[t] == 0;
    const bool has_props = a.t_has_props[t];
    const bool fail_ex = has_props && !r_has_props && ent_ex;
    const bool fail_rg = has_props && !r_has_props && any_rg;
    out[t] = no_res || ((ent_ex || opm) && !fail_ex);
    out[(size_t)a.T + t] = no_res || ent_ex || opm;
    out[(size_t)2 * a.T + t] = no_res || (final_rg && !fail_rg);
    out[(size_t)3 * a.T + t] = no_res || final_rg;
    out[(size_t)4 * a.T + t] = has_props && ent_ex;
    out[(size_t)5 * a.T + t] = has_props && any_rg;
    out[(size_t)6 * a.T + t] = (c.bits & TC_ACT) != 0;
  }
}

extern "C" {

// "ptr,ptr,...|dim,dim,..." : the argument order, checked by the host
const char* acs_wia_planes_layout() {
  return WP_PTRS(ACS_NAME) "|" WP_DIMS(ACS_DIM_NAME);
}

// launches N * tiles blocks on `stream`; returns cudaGetLastError() after
// the launch, or -1 when the argument counts do not match this build
int acs_wia_planes(const int64_t* ptrs, int n_ptrs, const int32_t* dims,
                   int n_dims, int threads, void* stream_ptr) {
  if (n_ptrs != kWpPtrs || n_dims != kWpDims) return -1;
  WiaArgs sa;
  WiaArgs* a = &sa;
  int i = 0;
  WP_PTRS(ACS_SET_PTR)
  i = 0;
  WP_DIMS(ACS_SET_DIM)
  if (sa.N == 0 || sa.T == 0) return 0;
  const int per_tile = threads * WIA_ROWS_PER_THREAD;
  sa.tiles = (sa.T + per_tile - 1) / per_tile;
  const int grid = sa.N * sa.tiles;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  auto kernel = wia_planes_kernel;
  kernel<<<grid, threads, 0, stream>>>(sa);
  return (int)cudaGetLastError();
}

}  // extern "C"
