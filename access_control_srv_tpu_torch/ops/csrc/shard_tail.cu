// Merge-tail kernel of the sharded programs (K7 and K8) for Hopper
// (sm_90a).
//
// Replaces what the JAX package's sharded programs compute after their
// collectives: for the rule-sharded program, parallel/rule_shard.py
// _evaluate_chunk's selection over pol_ca (:192-202), the no-rules
// contributions (:204-214), _combine_sets (stages F-G, ops/kernel.py) and
// the abort preemption (:237-258); for the pod-sharded program,
// parallel/pod_shard.py _evaluate_set_chunk's unpacking of the winning
// set key (:230-235) and its abort preemption (:246-265).  It reads the
// merge rows that shard_chunk.cu wrote and one MIN all_reduce over the
// `model` group merged.  Host side:
// access_control_srv_tpu_torch/ops/kernel.py (shard_tail); the plain
// PyTorch version it is held against: ops/shard_ref.py shard_tail_ref.
//
// MODE (a template parameter, the host's `mode`):
//   ROW_RULE_CHUNK (K7): per (set, policy) the merged keys select the rule
//     the policy's combining algorithm picks (first-DENY / first-PERMIT
//     falling back to the last key - 8, first-applicable; an unknown
//     algorithm selects key 0), the gate column adds the no-rules
//     contributions, then stage F (the combining algorithm over each set's
//     contributions, select_pos) and last-set-wins;
//   ROW_SET_CHUNK (K8): the merged (negated) last-set key unpacks to the
//     decision and cacheable bit.
// Both then take the first aborting rule over the N_MODEL slots (the
// least global flat position; positions are unique) and let it preempt:
// DENY, its cacheable, its status code.  Outputs are int32 [3, B]:
// decision, cacheable (-1 none), status; with EXPLAIN (a template
// parameter, the host's `explain`) a fourth, the provenance code of
// srv/explain.py, with rule positions in strides (KP, KR): in K7 mode the
// merged selection key of the winning set's selected policy names the
// GLOBAL rule (KR the padded kr_total), as the JAX program's recovery does
// with no extra collective; in K8 mode the merged provenance key is the
// owning shard's (its no-rules positions scaled by KR, which is divided
// back out here); an abort names the aborting rule.
//
// What bounds it: bytes, each merge row read once and three int32
// written (well under a microsecond at 3.35 TB/s for the shard-scale
// batches); the work per row is a few hundred integer operations.
// chip_smoke.py times it on the main path's own launches and alone, beside
// an empty kernel over the same grid (acs_shard_tail_floor): the launch,
// not the bytes, sets its time (PERF.md section 6, H100 80GB HBM3 at 700
// W).
// Design: several rows per block, each row's work in registers (no shared
// memory, no barrier).  K8 mode: one thread per row.  K7 mode: one warp
// per row; the warp walks the sets from the last down and stops at the
// first that has a contribution (last-set-wins: no earlier set can
// decide).  Per set the lanes stride over its policies, each lane reading
// one policy's merged keys (neighbouring lanes on neighbouring keys) and
// building its contribution in registers; three ballots per 32 policies
// give the contributing, DENY and PERMIT policies, from which every lane
// reads the set's first-DENY / first-PERMIT / first / last policy and
// select_pos picks the policy.  The design before it (one block per row,
// one busy thread in K8 mode, a shared-memory byte per policy and one warp
// per set in K7 mode) was launch-bound at 100-150x its bound.  The kernel
// allocates nothing.

#include "decide_core.cuh"

#define TAIL_PTRS(X)                                                         \
  X(const int32_t*, merge) X(const int32_t*, pol_ca)                         \
  X(const int32_t*, pol_effect) X(const uint8_t*, pol_cacheable)             \
  X(const int32_t*, pol_n_rules) X(const int32_t*, set_ca)                   \
  X(int32_t*, out_decision) X(int32_t*, out_cacheable) X(int32_t*, out_status) \
  X(int32_t*, out_explain)

#define TAIL_DIMS(X) X(B) X(S) X(KP) X(N_MODEL) X(KR)

struct TailArgs {
  TAIL_PTRS(ACS_FIELD)
  TAIL_DIMS(ACS_DIM_FIELD)
};

static const int kNumTailPtrs = 0 TAIL_PTRS(ACS_COUNT);
static const int kNumTailDims = 0 TAIL_DIMS(ACS_COUNT);

// threads per block the library launches each mode with (K8: as many rows
// per block; K7: a row per warp)
#define TAIL_THREADS_K7 256
#define TAIL_THREADS_K8 128

// request rows one block of `threads` threads takes in `mode`
__host__ __device__ inline int tail_rows(int mode, int threads) {
  return mode == ROW_RULE_CHUNK ? threads / 32 : threads;
}

// policy p's selected merged key (the combining algorithm's pick, 0 when
// none) from its merged keys; *any: some rule was collected, *no_rules:
// the policy's own effect contributes
__device__ __forceinline__ int merged_sel(const TailArgs& t,
                                          const int32_t* k, int p,
                                          bool* any, bool* no_rules) {
  const int k_last = -k[3];
  *any = k_last > 0;
  // the last key packs pos + 1: minus 8 aligns it with the first keys
  const int fallback = *any ? k_last - 8 : 0;
  const int sel_do = k[0] < ACS_BIGKEY ? k[0] : fallback;
  const int sel_po = k[1] < ACS_BIGKEY ? k[1] : fallback;
  const int sel_fa = k[2] < ACS_BIGKEY ? k[2] : 0;
  const int ca = t.pol_ca[p];
  *no_rules = k[4] != 0 && t.pol_n_rules[p] == 0 && t.pol_effect[p] > 0;
  return ca == 0 ? sel_do : (ca == 1 ? sel_po : (ca == 2 ? sel_fa : 0));
}

// policy p's contribution byte (present | eff << 1 | cach << 3) from its
// merged keys: the combining algorithm's pick, or the policy's own effect
// when it has no rules
__device__ __forceinline__ uint8_t merged_contrib(const TailArgs& t,
                                                  const int32_t* k, int p) {
  bool any, no_rules;
  const int sel = merged_sel(t, k, p, &any, &no_rules);
  const bool present = no_rules || any;
  const int eff = no_rules ? t.pol_effect[p] : (sel >> 1) & 3;
  const bool cach = no_rules ? t.pol_cacheable[p] != 0 : (sel & 1) != 0;
  return (present ? 1 : 0) | ((eff & 3) << 1) | (cach ? 8 : 0);
}

// row b's outputs once condition aborts are applied: the least global flat
// position over the N_MODEL abort slots preempts everything (DENY, its
// cacheable, its status code, with EXPLAIN its kind-3 code)
template <bool EXPLAIN>
__device__ __forceinline__ void tail_outputs(const TailArgs& t, int b,
                                             const int32_t* slots,
                                             int decision, int cacheable,
                                             int code) {
  int best = ACS_INT_MAX, owner = 0;
  // unrolled so that the slots' loads are in flight together
#pragma unroll 4
  for (int d = 0; d < t.N_MODEL; ++d) {
    if (slots[d * 3] < best) {
      best = slots[d * 3];
      owner = d;
    }
  }
  int status = 200;
  if (best < ACS_BIG) {
    decision = 2;
    cacheable = slots[owner * 3 + 2] - 1;
    status = slots[owner * 3 + 1];
    code = explain_code(best, 3);
  }
  t.out_decision[b] = decision;
  t.out_cacheable[b] = cacheable;
  t.out_status[b] = status;
  if (EXPLAIN) t.out_explain[b] = code;
}

// K7 mode, row b by one warp (every lane returns the same): the last set
// with a contribution, its selected policy by select_pos over three
// ballots per 32 policies, then that policy's contribution (and with
// EXPLAIN its merged selection key) read once more by lane 0
template <bool EXPLAIN>
__device__ void rule_tail_row(const TailArgs& t, int b) {
  const int lane = threadIdx.x & 31;
  const int32_t* row =
      t.merge + (size_t)b * chunk_width(ROW_RULE_CHUNK, t.S, t.KP, t.N_MODEL,
                                        false);
  int win_s = -1, win_kp = 0;
  for (int s = t.S - 1; s >= 0 && win_s < 0; --s) {
    int first_deny = ACS_BIG, first_permit = ACS_BIG, first = ACS_BIG;
    int last = -1;
    for (int k0 = 0; k0 < t.KP; k0 += 32) {
      const int kp = k0 + lane, p = s * t.KP + kp;
      const uint8_t c8 =
          kp < t.KP ? merged_contrib(t, row + (size_t)p * KEY_COLS, p) : 0;
      const int eff = (c8 >> 1) & 3;
      const uint32_t have = __ballot_sync(0xffffffffu, c8 & 1);
      const uint32_t deny = __ballot_sync(0xffffffffu, (c8 & 1) && eff == 2);
      const uint32_t permit =
          __ballot_sync(0xffffffffu, (c8 & 1) && eff == 1);
      if (have == 0) continue;
      if (first == ACS_BIG) first = k0 + __ffs((int)have) - 1;
      if (deny != 0 && first_deny == ACS_BIG)
        first_deny = k0 + __ffs((int)deny) - 1;
      if (permit != 0 && first_permit == ACS_BIG)
        first_permit = k0 + __ffs((int)permit) - 1;
      last = k0 + 31 - __clz((int)have);
    }
    if (last < 0) continue;
    win_s = s;
    win_kp = min(max(select_pos(t.set_ca[s], first_deny, first_permit, first,
                                last), 0), t.KP - 1);
  }
  if (lane != 0) return;
  int decision = 0, cacheable = -1, code = 0;
  if (win_s >= 0) {
    const int p = win_s * t.KP + win_kp;
    const int32_t* k = row + (size_t)p * KEY_COLS;
    const uint8_t c8 = merged_contrib(t, k, p);
    decision = (c8 >> 1) & 3;
    cacheable = (c8 >> 3) & 1;
    if (EXPLAIN) {
      // the GLOBAL rule position rides in the merged key's high bits
      bool any, no_rules;
      const int sel = merged_sel(t, k, p, &any, &no_rules);
      code = no_rules ? explain_code(p, 2)
                      : explain_code(p * t.KR + (sel >> 3), 1);
    }
  }
  tail_outputs<EXPLAIN>(t, b, row + t.S * t.KP * KEY_COLS, decision,
                        cacheable, code);
}

// K8 mode, row b by one thread: the merged (negated) last-set key
template <bool EXPLAIN>
__device__ void set_tail_row(const TailArgs& t, int b) {
  const int32_t* row =
      t.merge + (size_t)b * chunk_width(ROW_SET_CHUNK, t.S, t.KP, t.N_MODEL,
                                        EXPLAIN);
  int decision = 0, cacheable = -1, code = 0;
  const int k_win = -row[0];
  if (k_win > 0) {
    decision = (k_win >> 1) & 3;
    cacheable = k_win & 1;
  }
  if (EXPLAIN) {
    // the owner's key: a no-rules position scaled by KR comes back
    const int key = -row[1];
    code = (key & 3) == 2 ? explain_code((key >> 2) / max(t.KR, 1), 2) : key;
  }
  tail_outputs<EXPLAIN>(t, b, row + 1 + (EXPLAIN ? 1 : 0), decision,
                        cacheable, code);
}

template <int MODE, bool EXPLAIN>
__global__ void shard_tail_kernel(const TailArgs t) {
  const int rows = tail_rows(MODE, blockDim.x);
  if constexpr (MODE == ROW_RULE_CHUNK) {
    const int b = blockIdx.x * rows + (threadIdx.x >> 5);
    if (b < t.B) rule_tail_row<EXPLAIN>(t, b);
  } else {
    const int b = blockIdx.x * rows + threadIdx.x;
    if (b < t.B) set_tail_row<EXPLAIN>(t, b);
  }
}

// an empty kernel: the launch floor of a grid (acs_shard_tail_floor)
__global__ void shard_tail_floor_kernel(const TailArgs) {}

// one launch of `kernel` over the blocks that take the mode's B rows
template <class K>
static int launch(K kernel, const TailArgs& t, int mode, int threads,
                  cudaStream_t stream) {
  const int rows = tail_rows(mode, threads);
  kernel<<<(t.B + rows - 1) / rows, threads, 0, stream>>>(t);
  return (int)cudaGetLastError();
}

// whether `threads` makes a block shape of `mode`: whole warps, 1,024 at
// most
static bool tail_shape_ok(int mode, int threads) {
  return (mode == ROW_RULE_CHUNK || mode == ROW_SET_CHUNK) && threads > 0 &&
         threads <= 1024 && threads % 32 == 0;
}

extern "C" {

// "ptr,ptr,...|dim,dim,..." : the argument order, checked by the host
const char* acs_shard_tail_layout() {
  return TAIL_PTRS(ACS_NAME) "|" TAIL_DIMS(ACS_DIM_NAME);
}

// the block shape the library launches `mode` with: out[0] threads, out[1]
// request rows per block; -1 on an unknown mode
int acs_shard_tail_block(int mode, int32_t* out) {
  const int threads =
      mode == ROW_RULE_CHUNK ? TAIL_THREADS_K7 : TAIL_THREADS_K8;
  if (!tail_shape_ok(mode, threads)) return -1;
  out[0] = threads;
  out[1] = tail_rows(mode, threads);
  return 0;
}

// launches the kernel on `stream` in `mode` (1: the rule-sharded tail,
// 2: the pod-sharded tail), with the provenance output when `explain`, in
// blocks of `threads` threads (K8: a row per thread; K7: a row per warp);
// returns cudaGetLastError() after the launch, or -1 when the argument
// counts, the mode or the block shape do not match this build
int acs_shard_tail(const int64_t* ptrs, int n_ptrs, const int32_t* dims,
                   int n_dims, int mode, int explain, int threads,
                   void* stream) {
  if (n_ptrs != kNumTailPtrs || n_dims != kNumTailDims ||
      !tail_shape_ok(mode, threads))
    return -1;
  TailArgs t;
  int i = 0;
#define TAIL_SET_PTR(type, name) t.name = reinterpret_cast<type>(ptrs[i++]);
#define TAIL_SET_DIM(name) t.name = dims[i++];
  TAIL_PTRS(TAIL_SET_PTR)
  i = 0;
  TAIL_DIMS(TAIL_SET_DIM)
  if (explain && t.out_explain == nullptr) return -1;
  if (t.B == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (mode == ROW_RULE_CHUNK)
    return explain
        ? launch(shard_tail_kernel<ROW_RULE_CHUNK, true>, t, mode, threads, s)
        : launch(shard_tail_kernel<ROW_RULE_CHUNK, false>, t, mode, threads,
                 s);
  return explain
      ? launch(shard_tail_kernel<ROW_SET_CHUNK, true>, t, mode, threads, s)
      : launch(shard_tail_kernel<ROW_SET_CHUNK, false>, t, mode, threads, s);
}

// launches the empty kernel over the grid a launch of `b` rows in `mode`
// with `threads` threads would take: the tail's launch floor, for timing
// only (no output; -1 on a bad block shape)
int acs_shard_tail_floor(int mode, int b, int threads, void* stream) {
  if (!tail_shape_ok(mode, threads)) return -1;
  if (b == 0) return 0;
  TailArgs t = {};
  t.B = b;
  return launch(shard_tail_floor_kernel, t, mode, threads,
                reinterpret_cast<cudaStream_t>(stream));
}

// resident blocks per SM of the variant (mode, explain) in blocks of
// `threads` threads (cudaOccupancyMaxActiveBlocksPerMultiprocessor), -1 on
// a bad block shape or a failed query
int acs_shard_tail_occupancy(int mode, int explain, int threads) {
  if (!tail_shape_ok(mode, threads)) return -1;
  void (*kernel)(const TailArgs) =
      mode == ROW_RULE_CHUNK
          ? (explain ? shard_tail_kernel<ROW_RULE_CHUNK, true>
                     : shard_tail_kernel<ROW_RULE_CHUNK, false>)
          : (explain ? shard_tail_kernel<ROW_SET_CHUNK, true>
                     : shard_tail_kernel<ROW_SET_CHUNK, false>);
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    0);
  return err != cudaSuccess ? -1 : blocks;
}

}  // extern "C"
