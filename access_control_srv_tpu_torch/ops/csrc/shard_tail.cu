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
//     contributions, then stage F (decide_core.cuh stage_sets, one warp
//     per set) and last-set-wins;
//   ROW_SET_CHUNK (K8): the merged (negated) last-set key unpacks to the
//     decision and cacheable bit.
// Both then take the first aborting rule over the N_MODEL slots (the
// least global flat position; positions are unique) and let it preempt:
// DENY, its cacheable, its status code.  Outputs are int32 [3, B]:
// decision, cacheable (-1 none), status; with EXPLAIN (a template
// parameter, the host's `explain`) a fourth, the provenance code of
// srv/explain.py, with rule positions in strides (KP, KR): in K7 mode the
// winning set's selected policy is re-derived by one warp and its merged
// selection key names the GLOBAL rule (KR the padded kr_total), as the JAX
// program's recovery does with no extra collective; in K8 mode the merged
// provenance key is the owning shard's (its no-rules positions scaled by
// KR, which is divided back out here); an abort names the aborting rule.
//
// What bounds it: bytes, each merge row read once and three int32
// written (well under a microsecond at 3.35 TB/s for the shard-scale
// batches); the work per row is a few hundred integer operations.
// chip_smoke.py times it on the main path's own launches (PERF.md section
// 6, H100 80GB HBM3 at 700 W): thousands of small blocks, so launch and
// latency, not bytes, set its time.
// Design: one thread block per row; in K7 mode threads stride over the
// S * KP policies to build the contribution bytes in shared memory, in K8
// mode one thread per block does the whole row.  The kernel allocates
// nothing.

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

// dynamic shared memory of one block: the winning set (int32), the
// contribution bytes [S * KP] and the per-set results [S] (K7 mode only)
__host__ __device__ inline size_t tail_smem(const TailArgs& t, int mode) {
  if (mode != ROW_RULE_CHUNK) return 0;
  return align_up(sizeof(int32_t) + (size_t)t.S * t.KP + t.S, 16);
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

template <int MODE, bool EXPLAIN>
__global__ void shard_tail_kernel(const TailArgs t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int32_t* row =
      t.merge + (size_t)b * chunk_width(MODE, t.S, t.KP, t.N_MODEL, EXPLAIN);
  int decision = 0, cacheable = -1, status = 200, code = 0;
  if (MODE == ROW_RULE_CHUNK) {
    int32_t* winner = reinterpret_cast<int32_t*>(smem);
    uint8_t* contrib = smem + sizeof(int32_t);
    uint8_t* setres = contrib + (size_t)t.S * t.KP;
    if (tid == 0) *winner = -1;
    for (int p = tid; p < t.S * t.KP; p += blockDim.x)
      contrib[p] = merged_contrib(t, row + p * KEY_COLS, p);
    __syncthreads();
    stage_sets(t.set_ca, t.S, t.KP, contrib, setres, winner);
    const int s = *winner;
    if (EXPLAIN && tid < 32 && s >= 0) {
      // the winning set's selected policy (warp 0), then its merged key:
      // the GLOBAL rule position rides in the key's high bits
      bool any, no_rules;
      const int p = s * t.KP + set_pick(t.set_ca[s], s, t.KP, contrib, &any);
      const int sel = merged_sel(t, row + p * KEY_COLS, p, &any, &no_rules);
      code = no_rules ? explain_code(p, 2)
                      : explain_code(p * t.KR + (sel >> 3), 1);
    }
    if (tid != 0) return;
    if (s >= 0) {
      decision = setres[s] & 3;
      cacheable = (setres[s] >> 2) & 1;
    }
  } else {
    if (tid != 0) return;
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
  }
  // condition aborts: the least global flat position over the shards'
  // slots preempts everything
  const int32_t* slots =
      row + (MODE == ROW_RULE_CHUNK ? t.S * t.KP * KEY_COLS : 1 + (EXPLAIN ? 1 : 0));
  int best = ACS_INT_MAX, owner = 0;
  for (int d = 0; d < t.N_MODEL; ++d) {
    if (slots[d * 3] < best) {
      best = slots[d * 3];
      owner = d;
    }
  }
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

template <int MODE, bool EXPLAIN>
static int launch(const TailArgs& t, int threads, cudaStream_t stream) {
  auto kernel = shard_tail_kernel<MODE, EXPLAIN>;
  const size_t smem = tail_smem(t, MODE);
  kernel<<<t.B, threads, smem, stream>>>(t);
  return (int)cudaGetLastError();
}

extern "C" {

// "ptr,ptr,...|dim,dim,..." : the argument order, checked by the host
const char* acs_shard_tail_layout() {
  return TAIL_PTRS(ACS_NAME) "|" TAIL_DIMS(ACS_DIM_NAME);
}

// launches the kernel on `stream` in `mode` (1: the rule-sharded tail,
// 2: the pod-sharded tail), with the provenance output when `explain`;
// returns cudaGetLastError() after the launch, or -1 when the argument
// counts or the mode do not match this build
int acs_shard_tail(const int64_t* ptrs, int n_ptrs, const int32_t* dims,
                   int n_dims, int mode, int explain, int threads,
                   void* stream) {
  if (n_ptrs != kNumTailPtrs || n_dims != kNumTailDims) return -1;
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
    return explain ? launch<ROW_RULE_CHUNK, true>(t, threads, s)
                   : launch<ROW_RULE_CHUNK, false>(t, threads, s);
  if (mode == ROW_SET_CHUNK)
    return explain ? launch<ROW_SET_CHUNK, true>(t, threads, s)
                   : launch<ROW_SET_CHUNK, false>(t, threads, s);
  return -1;
}

}  // extern "C"
