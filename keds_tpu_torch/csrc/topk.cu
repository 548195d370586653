// Exact top-k by inner product (MIPS) on Hopper (sm_90a).
//
// Replaces the TPU kernel keds_tpu/ops/pallas_topk.py:mips_topk_pallas
// (body _kernel, merge _iterative_topk).  queries (B, D) and a database
// (N, D), both f32 or both bf16, give the k best rows per query: values
// (B, k) f32 and indices (B, k) int32, sorted by descending score with ties
// going to the lower row index; rows >= N never appear.  The TPU kernel
// carries its running top-k across a sequential grid in VMEM; Hopper blocks
// run in parallel and carry nothing between them, so every route below ends
// in a selection that one team of threads makes per query.  Any k <= N
// reads the database once, and one search launches the same kernels for
// every k.
//
// Order.  Entry (score s, row i) becomes one 64-bit key: the high word maps
// the float's bits to an unsigned order (-0.0 first turned into +0.0: the
// plain version ranks the two as equal), the low word is ~i, so that of two
// equal scores the lower row has the larger key.  No two keys are equal,
// empty slots (row -1) are key 0, and "the k best" is "the k largest keys".
//
// The selection (select_row, a warp or a block of threads a row).  The
// cost per entry must not grow with k, so there is no running list to
// insert into.  A first read of the row keeps each thread's group of eight
// keys' largest score; the want-th largest of those maxima (a radix
// descent over them in shared memory) is a bound that at least `want` keys
// reach and, on real scores, few more.  A second read gathers the keys at
// or above it (a ballot and one shared atomic a warp give the slots) and a
// bitonic sort in shared memory orders them.  Where the groups are too few
// (k a large share of the row) or too many keys pass, the radix descent runs
// over the row itself, 8 bits a pass from the top (warp-aggregated
// shared-memory histograms), stopping when the bin of the want-th key is
// taken whole.  A k above the sort's room (4096 keys a block) takes rounds
// inside the team, each after the previous round's last key.  (Tried and
// dropped on the H100: the radix descent over every row, a buffer with a
// running threshold sorted whenever it fills, and staging the row in
// shared memory; each was slower than the group bound.)
//
// Routes (variant codes below; ops/topk.py:split_plan picks one):
//
// f32 at any k, bf16 above k = 32 or at D > 1024: score, then select.  A
// score kernel writes the (B, N) f32 scores to scratch (38 MB at the CIRR
// ranking, 4181 x 2297), and topk_select selects per query.
//   * topk_score_f32: exact f32 FMA on CUDA cores (tensor cores would round
//     to TF32), 128 x 128 tiles with 8 x 8 outputs a thread (64 x 64 with 4 x
//     4 where a big tile would be half empty or the card half idle), 16-deep
//     slices staged transposed in shared memory while the next slice's loads
//     wait in registers.  Each score sums its D products in order by fmaf.
//     Bound: the products at 67 TFLOP/s (0.22 ms at the CIRR ranking).  (A
//     4-stage cp.async ring of untransposed slices, tried, was slower: 8 x 8
//     outputs and the ring's reads need more registers than two blocks an
//     SM leave.)
//   * topk_score_bf16: mma.sync m16n8k16 bf16 -> f32 (products of bf16
//     inputs are exact in f32) on 128 database rows x 64 queries a block,
//     both operands ldmatrix'd from a 4-stage cp.async ring (144-byte rows,
//     conflict-free), two blocks an SM.  Any D that is a multiple of 64.  Bound: the database
//     read (0.23 ms at (64, 0.5M, 768)); the scores add B * N * 4 bytes
//     written and read twice (128 MB there), so the selection, not the
//     product, is what this route pays above its bound.
//   * topk_select: a team per (query, segment).  A row longer than
//     SEGMENT_ROWS (ops/topk.py) is cut into segments so that a few queries
//     over a long database still fill the card; each segment's team selects
//     min(k, segment) candidates, and the team that finishes a query's last
//     segment (a per-query counter, reset by that team) merges them.
// f32 at N <= 1024 (the served corpus ranking, (64, 256, 768) at k = 10):
// topk_fused, one launch.  Blocks of 4 queries x 32 rows (1 x 128 above
// k = 256) stream their slices through a 6-deep cp.async ring (the tile's
// work per slice is too small to hide a copy otherwise) and write their
// scores to scratch; the block that finishes a query tile's last row tile
// selects its rows, a warp a row (the whole block above k = 256).  Bound:
// launch latency and the L2 round trips of a serial chain (the work is
// 0.0004 ms).
// bf16 at k <= 32 and D <= 1024 (the 0.5M retrieval, the train-step search):
// topk_tc, kept as it was (34 % of its bound, faster than its library
// call), then topk_select over its (B, slices, k) candidates with their
// explicit indices in place of the one-warp merge.
//
// topk_tc (bf16).  What bounds it on the H100: the database read (N * D * 2
// bytes, 768 MB at N = 0.5M, D = 768: 0.23 ms at 3.35 TB/s) against
// 2 * B * N * D flops (0.05 ms at B = 64 on bf16 tensor cores), so the
// floor is the memory read.  The design reads the database once per
// 64-query tile at close to HBM rate:
//   * mma.sync m16n8k16 bf16 -> f32 score tiles (products of bf16 inputs
//     are exact in f32, so scores match the plain version up to summation
//     order), computed transposed: 16 database rows x 8 queries per mma.
//     Warp pairs own 16 queries and split each stage's depth steps, so
//     each warp keeps its queries' fragments for half the depth (D <= 1024)
//     in registers, the query tile takes no shared memory, and each
//     ldmatrix'd operand feeds two products (64 KB of ldmatrix reads per
//     18 KB stage).
//   * the database streams through an 8-stage ring of 128-row x 64-deep
//     cp.async tiles (144-byte rows, conflict-free ldmatrix), up to seven
//     in flight; 210 KB of shared memory, one block per SM, and the wrapper
//     gives one slice per SM so that the whole search is a single wave.
//   * the fold: a pair adds its partial score tiles in shared memory, and
//     each warp marks in one parallel pass the scores of its 8 queries that
//     beat their list's k-th entry (lists in registers, lane i holds entry
//     i).  After the first chunks almost nothing is marked; only the marked
//     32-row groups take the ballot/shuffle insertion.  The insertions
//     that remain (about k(1 + ln(rows / k)) per list) are what keeps the
//     kernel above its bound.  Its registers and shared memory hold no room
//     for longer lists, hence the score-then-select route above k = 32.
//
// Scratch (scores, candidates) and the counters are the wrapper's
// (torch.empty, and one zeroed int32 buffer per device that the kernels
// leave zeroed); the kernels allocate nothing.  Two searches sharing a
// device's counters must not run at once on two streams.

#include <algorithm>

#include "common.cuh"

namespace {

using namespace keds;
using bf16 = __nv_bfloat16;
using u64 = unsigned long long;

constexpr int kLaneK = 32;       // k of topk_tc's lists, one entry a lane

// Variant codes of the C interface (mirrored in ops/topk.py).
enum Variant : int { kF32 = 0, kF32Mid = 1, kBf16Tc = 2, kBf16 = 3, kF32Fused = 4 };

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  if (bi < 0) return ai >= 0;
  if (ai < 0) return false;
  return av > bv || (av == bv && ai < bi);
}

// Offer one candidate per lane to the warp's running top-k (lane i holds
// entry i, sorted best first).  Warp-uniform control flow throughout.
__device__ __forceinline__ void offer(float& sv, int& si, float cv, int ci,
                                      bool valid, int k, int lane) {
  float tv = __shfl_sync(kFullMask, sv, k - 1);
  int ti = __shfl_sync(kFullMask, si, k - 1);
  unsigned pending = __ballot_sync(kFullMask, valid && better(cv, ci, tv, ti));
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    const float bv = __shfl_sync(kFullMask, cv, src);
    const int bi = __shfl_sync(kFullMask, ci, src);
    if (!better(bv, bi, tv, ti)) continue;       // threshold rose meanwhile
    const int pos = __popc(__ballot_sync(kFullMask, lane < k && better(sv, si, bv, bi)));
    const float uv = __shfl_up_sync(kFullMask, sv, 1);
    const int ui = __shfl_up_sync(kFullMask, si, 1);
    if (lane == pos) {
      sv = bv;
      si = bi;
    } else if (lane > pos) {
      sv = uv;
      si = ui;
    }
    tv = __shfl_sync(kFullMask, sv, k - 1);
    ti = __shfl_sync(kFullMask, si, k - 1);
  }
}

// Chunks [begin, end) of this block's slice: n_chunks split evenly.
__device__ __forceinline__ void slice_range(int n_chunks, int n_splits, int split,
                                            int& begin, int& end) {
  begin = static_cast<int>(static_cast<long long>(split) * n_chunks / n_splits);
  end = static_cast<int>(static_cast<long long>(split + 1) * n_chunks / n_splits);
}

// --- bf16 tensor-core partial kernel ----------------------------------------
//
// The score tile is computed transposed: A = 16 database rows x 16 depth
// (ldmatrix from the ring), B = 16 depth x 8 queries (held in registers for
// the whole block).  Warps work in pairs on 16 queries: the even warp takes
// the even 16-deep steps of every stage, the odd warp the odd ones, so each
// holds its queries' fragments for half the depth and every ldmatrix'd
// operand feeds two products.  After a chunk the pair adds its partial
// scores through shared memory, and each warp folds 8 of the 16 queries
// into running lists kept in registers (lane i holds entry i).

constexpr int kTcThreads = 256;
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcQPP = 16;                     // queries per warp pair (2 mma n-tiles)
constexpr int kTcQPW = kTcQPP / 2;             // queries each warp folds
constexpr int kTcBQ = kTcWarps / 2 * kTcQPP;   // 64 queries per block
constexpr int kTcBN = 128;                     // database rows per chunk
constexpr int kTcDK = 64;                      // depth of one ring stage
constexpr int kTcStages = 8;
constexpr int kTcRingPitch = kTcDK + 8;        // 144-byte rows: ldmatrix conflict-free
constexpr int kTcStageElems = kTcBN * kTcRingPitch;
constexpr int kTcTilePitch = kTcBN + 4;        // score tile rows: conflict-free stores
constexpr int kTcMaxDim = 1024;

constexpr size_t kTcSmemBytes = sizeof(bf16) * kTcStages * kTcStageElems +
                                sizeof(float) * kTcWarps * kTcQPP * kTcTilePitch;

// kMaxSlices: D <= 64 * kMaxSlices (the q fragments' registers).
template <int kMaxSlices>
__global__ void __launch_bounds__(kTcThreads, 1)
topk_tc(const bf16* __restrict__ q, const bf16* __restrict__ db,
        float* __restrict__ cand_v, int* __restrict__ cand_i, int B, int N, int D,
        int k, int n_splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* tiles = reinterpret_cast<float*>(ring + kTcStages * kTcStageElems);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTcBQ, split = blockIdx.y;
  const int n_chunks = (N + kTcBN - 1) / kTcBN;
  int c_begin, c_end;
  slice_range(n_chunks, n_splits, split, c_begin, c_end);
  const int n_slices = D / kTcDK;
  const int n_steps = (c_end - c_begin) * n_slices;

  // Ring step s holds rows of chunk c_begin + s / n_slices, depth slice s % n_slices.
  auto load_stage = [&](int s) {
    const int row0 = (c_begin + s / n_slices) * kTcBN, d0 = (s % n_slices) * kTcDK;
    bf16* dst = ring + (s % kTcStages) * kTcStageElems;
#pragma unroll
    for (int rep = 0; rep < kTcBN * (kTcDK / 8) / kTcThreads; ++rep) {
      const int e = tid + rep * kTcThreads;
      const int r = e / (kTcDK / 8), c = (e % (kTcDK / 8)) * 8;
      const bool in = row0 + r < N;     // the ragged edge is zero-filled
      cp_async16(dst + r * kTcRingPitch + c,
                 db + static_cast<size_t>(in ? row0 + r : 0) * D + d0 + c, in);
    }
  };
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < n_steps) load_stage(s);
    cp_async_commit();
  }

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int pair = warp / 2, parity = warp % 2;
  const int qp = q0 + pair * kTcQPP;            // the pair's first query
  const bool active = qp < B;                   // uniform over the pair
  // B fragments: n-tile nt holds query qp + nt*8 + g, depth 16*kk + 2t..+1
  // and +8, for this warp's steps kk = 2*kp + parity of every slice.
  unsigned qf[kMaxSlices][2][2][2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const bool in = qp + nt * 8 + g < B;
    const unsigned* qrow = reinterpret_cast<const unsigned*>(
        q + static_cast<size_t>(in ? qp + nt * 8 + g : 0) * D);
#pragma unroll
    for (int sl = 0; sl < kMaxSlices; ++sl)
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {
        const bool live = in && sl < n_slices;
        const int w = (sl * kTcDK + (2 * kp + parity) * 16) / 2 + t;
        qf[sl][kp][nt][0] = live ? __ldg(qrow + w) : 0u;
        qf[sl][kp][nt][1] = live ? __ldg(qrow + w + 4) : 0u;
      }
  }
  float sv[kTcQPW];                             // running lists, entry `lane`
  int si[kTcQPW];
#pragma unroll
  for (int j = 0; j < kTcQPW; ++j) {
    sv[j] = -CUDART_INF_F;
    si[j] = -1;
  }
  const int a_off = (lane % 16) * kTcRingPitch + (lane / 16) * 8 + parity * 16;
  float* tile = tiles + warp * kTcQPP * kTcTilePitch;           // [query][row]
  const float* even = tiles + (2 * pair) * kTcQPP * kTcTilePitch;
  const float* odd = even + kTcQPP * kTcTilePitch;

  float acc[kTcBN / 16][2][4];
  int step = 0;
  for (int c = c_begin; c < c_end; ++c) {
#pragma unroll
    for (int mt = 0; mt < kTcBN / 16; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
    for (int sl = 0; sl < kMaxSlices; ++sl) {
      if (sl >= n_slices) break;
      cp_async_wait<kTcStages - 2>();
      __syncthreads();                // stage `step` landed; slot step-1 is free
      if (step + kTcStages - 1 < n_steps) load_stage(step + kTcStages - 1);
      cp_async_commit();
      if (active) {
        const bf16* stage = ring + (step % kTcStages) * kTcStageElems + a_off;
#pragma unroll
        for (int kp = 0; kp < 2; ++kp)
#pragma unroll
          for (int mt = 0; mt < kTcBN / 16; ++mt) {
            unsigned af[4];
            ldmatrix_x4(af, stage + mt * 16 * kTcRingPitch + kp * 32);
            mma_bf16(acc[mt][0], af, qf[sl][kp][0]);
            mma_bf16(acc[mt][1], af, qf[sl][kp][1]);
          }
      }
      ++step;
    }
    if (!active) continue;

    // Add the pair's partial scores in shared memory, then fold this warp's
    // 8 queries.  One pass marks, all at once, the scores that beat their
    // list's k-th entry; only 32-row groups with a mark go through offer().
#pragma unroll
    for (int mt = 0; mt < kTcBN / 16; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tile[(nt * 8 + 2 * t + e % 2) * kTcTilePitch + mt * 16 + g + 8 * (e / 2)] =
              acc[mt][nt][e];
    asm volatile("bar.sync %0, 64;\n" :: "r"(1 + pair) : "memory");
    const int row0 = c * kTcBN;
    const float* ev = even + parity * kTcQPW * kTcTilePitch + lane;
    const float* od = odd + parity * kTcQPW * kTcTilePitch + lane;
    unsigned mask = 0;               // bit 4j + u: (query j, row 32u + lane)
#pragma unroll
    for (int j = 0; j < kTcQPW; ++j) {
      const float tv = __shfl_sync(kFullMask, sv[j], k - 1);
      const int ti = __shfl_sync(kFullMask, si[j], k - 1);
      const bool q_in = qp + parity * kTcQPW + j < B;
#pragma unroll
      for (int u = 0; u < kTcBN / 32; ++u) {
        const int row = row0 + 32 * u + lane;
        const float x = ev[j * kTcTilePitch + 32 * u] + od[j * kTcTilePitch + 32 * u];
        if (q_in && row < N && better(x, row, tv, ti)) mask |= 1u << (4 * j + u);
      }
    }
    if (__any_sync(kFullMask, mask)) {
#pragma unroll
      for (int j = 0; j < kTcQPW; ++j)
#pragma unroll
        for (int u = 0; u < kTcBN / 32; ++u) {
          const bool mine = (mask >> (4 * j + u)) & 1u;
          if (!__any_sync(kFullMask, mine)) continue;
          const float x = ev[j * kTcTilePitch + 32 * u] + od[j * kTcTilePitch + 32 * u];
          offer(sv[j], si[j], x, row0 + 32 * u + lane, mine, k, lane);
        }
    }
    // the tiles are rewritten only after the next chunk's __syncthreads
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < kTcQPW; ++j) {
    const int qi = qp + parity * kTcQPW + j;
    if (qi < B && lane < k) {
      const size_t o = (static_cast<size_t>(qi) * n_splits + split) * k + lane;
      cand_v[o] = sv[j];
      cand_i[o] = si[j];
    }
  }
}

// --- order keys and the team selection ----------------------------------------

// The float's bits as an unsigned order (larger float, larger key); -0.0
// ranks as +0.0.
__device__ __forceinline__ unsigned order_key(float v) {
  unsigned b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// (score, row) -> key: score order high, ~row low; an empty slot (row < 0) is 0.
__device__ __forceinline__ u64 entry_key(float v, int row) {
  return row < 0 ? 0ull
                 : (static_cast<u64>(order_key(v)) << 32) | static_cast<unsigned>(~row);
}

constexpr int kSelThreads = 256;
constexpr int kSelLoads = 8;        // keys a thread reads at once: one group
constexpr int kBlockCap = 4096;     // entries a block team sorts in one round
constexpr int kWarpCap = 256;       // ... a warp team
constexpr int kFusedMaxRows = 1024;
constexpr int kTeamCtlBytes = 256 * 4 + 4 * 4;   // histogram, control words
constexpr int kMaxGroups = 8192;                 // group maxima a team holds

// Groups of a row of `len` read by a team of `team` threads.
__host__ __device__ constexpr int row_groups(int len, int team) {
  return (len + team * kSelLoads - 1) / (team * kSelLoads) * team;
}

// Shared memory of a team: control, a sort buffer of 2 cap keys (a round
// keeps cap; the gathered keys may overshoot it), `groups` group maxima.
__host__ __device__ constexpr int team_bytes(int cap, int groups) {
  return kTeamCtlBytes + 16 * cap + 4 * groups;
}

template <int kTeam>
__device__ __forceinline__ void team_sync() {
  if constexpr (kTeam == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// One row to select from: values v[0, len), their rows idx[j] or base + j.
struct Row {
  const float* v;
  const int* idx;
  int base, len;
};

// kCached: read through L1 (the row was written by an earlier launch);
// otherwise from L2 (written by other blocks of this launch).
template <bool kCached>
__device__ __forceinline__ u64 row_key(const Row& r, int j) {
  if (j >= r.len) return 0ull;
  const float v = kCached ? __ldg(r.v + j) : __ldcg(r.v + j);
  const int row = r.idx ? (kCached ? __ldg(r.idx + j) : __ldcg(r.idx + j)) : r.base + j;
  return entry_key(v, row);
}

struct TeamSmem {
  int* hist;           // 256 bins
  int* ctl;            // 4 control words
  u64* buf;            // the sort buffer, 2 cap keys
  unsigned* gmax;      // the group maxima's high words
};

__device__ __forceinline__ TeamSmem team_smem(unsigned char* smem, int team, int cap,
                                              int groups) {
  unsigned char* p = smem + static_cast<size_t>(team) * team_bytes(cap, groups);
  int* hist = reinterpret_cast<int*>(p);
  u64* buf = reinterpret_cast<u64*>(p + kTeamCtlBytes);
  return {hist, hist + 256, buf, reinterpret_cast<unsigned*>(buf + 2 * cap)};
}

// A warp: the bin of hist that holds the remaining-th largest counted key.
// ctl = {bin, keys in the bins above it, keys in it}; bin -1 when hist
// counts fewer than `remaining` keys.
__device__ __forceinline__ void find_digit(const int* hist, int remaining, int* ctl, int lane) {
  int h[8], s = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    h[b] = hist[lane * 8 + b];
    s += h[b];
  }
  int incl = s;                    // keys in the bins of this lane and the lanes above
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_down_sync(kFullMask, incl, o);
    if (lane + o < 32) incl += t;
  }
  const int total = __shfl_sync(kFullMask, incl, 0);
  if (total < remaining) {
    if (lane == 0) ctl[0] = -1;
    return;
  }
  int above = incl - s;
  if (above < remaining && remaining <= incl) {
    bool found = false;
#pragma unroll
    for (int b = 7; b >= 0; --b) {
      if (!found && above + h[b] >= remaining) {
        ctl[0] = lane * 8 + b;
        ctl[1] = above;
        ctl[2] = h[b];
        found = true;
      }
      if (!found) above += h[b];
    }
  }
}

// The least key t such that the keys in [t, bound) of key_at(0 .. len-1)
// (0 for none) number `want`: a radix descent 8 bits a pass from the top,
// each pass a histogram of the keys that share the bits fixed so far
// (warp-aggregated shared atomics) and one warp finding the bin of the
// want-th key; it stops as soon as that bin is taken whole.  Keys below
// `lower` are not counted; 1 (every key) when fewer than `want` remain.
template <int kTeam, typename KeyAt>
__device__ u64 kth_key(KeyAt key_at, int len, int want, u64 lower, u64 bound,
                       const TeamSmem& s, int rank) {
  const int lane = rank % 32;
  u64 prefix = 0, thresh = 1;
  int remaining = want;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int b = rank; b < 256; b += kTeam) s.hist[b] = 0;
    team_sync<kTeam>();
    const u64 hi = shift == 56 ? 0ull : ~0ull << (shift + 8);
    for (int j0 = 0; j0 < len; j0 += kTeam * kSelLoads) {
      u64 key[kSelLoads];
#pragma unroll
      for (int u = 0; u < kSelLoads; ++u) key[u] = key_at(j0 + u * kTeam + rank);
#pragma unroll
      for (int u = 0; u < kSelLoads; ++u) {
        const bool in = key[u] >= lower && key[u] != 0 && key[u] < bound &&
                        (key[u] & hi) == prefix;
        const unsigned digit = static_cast<unsigned>(key[u] >> shift) & 255u;
        const unsigned m = __ballot_sync(kFullMask, in);
        if (in) {
          const unsigned peers = __match_any_sync(m, digit);
          if (lane == __ffs(peers) - 1) atomicAdd(s.hist + digit, __popc(peers));
        }
      }
    }
    team_sync<kTeam>();
    if (rank < 32) find_digit(s.hist, remaining, s.ctl, lane);
    team_sync<kTeam>();
    const int d = s.ctl[0], above = s.ctl[1], in_bin = s.ctl[2];
    team_sync<kTeam>();                    // ctl is rewritten next
    if (d < 0) break;                      // fewer keys left than wanted
    remaining -= above;
    prefix |= static_cast<u64>(d) << shift;
    thresh = prefix;
    if (in_bin == remaining) break;        // the bin is taken whole
  }
  return thresh;
}

// The row's keys in [lower, bound) into buf[0, room) (order lost; those
// past room dropped); returns how many there are.
template <int kTeam, bool kCached>
__device__ int gather(const Row& row, u64 lower, u64 bound, const TeamSmem& s, int room,
                      int rank) {
  const int lane = rank % 32;
  if (rank == 0) s.ctl[3] = 0;
  team_sync<kTeam>();
  for (int j0 = 0; j0 < row.len; j0 += kTeam * kSelLoads) {
    u64 key[kSelLoads];
#pragma unroll
    for (int u = 0; u < kSelLoads; ++u) key[u] = row_key<kCached>(row, j0 + u * kTeam + rank);
#pragma unroll
    for (int u = 0; u < kSelLoads; ++u) {
      const bool take = key[u] != 0 && key[u] >= lower && key[u] < bound;
      const unsigned m = __ballot_sync(kFullMask, take);
      int base = 0;
      if (lane == 0 && m) base = atomicAdd(s.ctl + 3, __popc(m));
      base = __shfl_sync(kFullMask, base, 0);
      if (take) {
        const int pos = base + __popc(m & ((1u << lane) - 1u));
        if (pos < room) s.buf[pos] = key[u];
      }
    }
  }
  team_sync<kTeam>();
  const int got = s.ctl[3];
  team_sync<kTeam>();
  return got;
}

// Sort buf[0, n) (n a power of two) into descending order.
template <int kTeam>
__device__ void bitonic_desc(u64* buf, int n, int rank) {
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = rank; t < n / 2; t += kTeam) {
        const int lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
        const u64 a = buf[lo], b = buf[hi];
        if ((a < b) == ((lo & size) == 0)) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      team_sync<kTeam>();
    }
}

// The k best entries of `row`, sorted, to out_v / out_i [0, k); slots past
// the row's entries get (-inf, -1).  A team of kTeam threads (rank 0 ..
// kTeam - 1, every one of them calling) shares s, with room for `groups`
// group maxima.  Each round (a k above cap takes several, each after the
// previous round's last key) first reads the row once in groups of
// kSelLoads keys a thread and keeps each group's largest score: the want-th
// largest of those maxima is a lower bound that at least `want` keys reach,
// and few more on real scores, so that one more read gathers them all (up
// to 2 cap) and a sort ends the round.  Where the groups are too few, or
// more keys pass, the radix descent over the row (above that bound) finds
// the want-th key itself; a round that takes every key left needs neither.
template <int kTeam, bool kCached>
__device__ void select_row(const Row& row, int k, float* out_v, int* out_i, const TeamSmem& s,
                           int cap, int groups, int rank) {
  const int n_groups = row_groups(row.len, kTeam);
  u64 bound = ~0ull;
  for (int done = 0; done < k;) {
    const int want = min(k - done, cap);
    u64 lower = 1;
    int got = -1;                          // keys gathered, -1 for none yet
    if (n_groups <= groups && n_groups >= want) {
      for (int j0 = 0, g = rank; j0 < row.len; j0 += kTeam * kSelLoads, g += kTeam) {
        unsigned top = 0;
#pragma unroll
        for (int u = 0; u < kSelLoads; ++u) {
          const u64 key = row_key<kCached>(row, j0 + u * kTeam + rank);
          if (key < bound) top = max(top, static_cast<unsigned>(key >> 32));
        }
        s.gmax[g] = top;
      }
      team_sync<kTeam>();
      const unsigned* gm = s.gmax;
      auto group_key = [&](int g) { return g < n_groups ? static_cast<u64>(gm[g]) << 32 : 0ull; };
      lower = kth_key<kTeam>(group_key, n_groups, want, 1, ~0ull, s, rank) & 0xffffffff00000000ull;
      if (lower == 0) lower = 1;
      got = gather<kTeam, kCached>(row, lower, bound, s, 2 * cap, rank);
    }
    if (got < 0 && want >= row.len) {        // the round takes every key left
      got = gather<kTeam, kCached>(row, 1, bound, s, cap, rank);
    } else if (got < 0 || got > 2 * cap) {
      const u64 thresh = kth_key<kTeam>([&](int j) { return row_key<kCached>(row, j); }, row.len,
                                        want, lower, bound, s, rank);
      got = gather<kTeam, kCached>(row, max(thresh, lower), bound, s, cap, rank);
    }
    got = min(got, 2 * cap);
    int n = 1;
    while (n < got) n <<= 1;
    for (int e = got + rank; e < n; e += kTeam) s.buf[e] = 0ull;
    team_sync<kTeam>();
    bitonic_desc<kTeam>(s.buf, n, rank);
    for (int e = rank; e < want; e += kTeam) {
      const u64 key = e < got ? s.buf[e] : 0ull;
      out_v[done + e] = key ? key_value(static_cast<unsigned>(key >> 32)) : -CUDART_INF_F;
      out_i[done + e] = key ? static_cast<int>(~static_cast<unsigned>(key)) : -1;
    }
    bound = want <= got ? s.buf[want - 1] : 0ull;
    done += want;
    team_sync<kTeam>();                    // buf and ctl are rewritten next round
    if (bound == 0ull) {                   // the row ran out: the rest are empty slots
      for (int e = done + rank; e < k; e += kTeam) {
        out_v[e] = -CUDART_INF_F;
        out_i[e] = -1;
      }
      break;
    }
  }
}

// Whether this team is the last of `total` to finish its share; that team
// resets the counter for the next launch.  Every thread of the team calls.
template <int kTeam>
__device__ __forceinline__ bool last_of(int* counter, int total, int rank, int* flag) {
  __threadfence();
  team_sync<kTeam>();
  if (rank == 0) {
    const bool last = atomicAdd(counter, 1) == total - 1;
    if (last) *counter = 0;
    *flag = last;
  }
  team_sync<kTeam>();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// One team per (row, segment) of a (rows, row_len) matrix with row stride
// ld: values, and indices `idx` or the column.  One segment: the row's k
// best go to out (row stride k).  Several: each segment's min(k, segment)
// best go to cand (row * n_segs + seg, stride that), and the team that
// finishes a row's last segment merges the row's candidates into out.
template <int kTeam>
__global__ void __launch_bounds__(kSelThreads)
topk_select(const float* __restrict__ vals, const int* __restrict__ idx, int rows, int row_len,
            int ld, int n_segs, int k, float* cand_v, int* cand_i, float* __restrict__ out_v,
            int* __restrict__ out_i, int* counters, int cap, int groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kTeams = kSelThreads / kTeam;
  const int rank = threadIdx.x % kTeam, team = threadIdx.x / kTeam;
  const long long t = static_cast<long long>(blockIdx.x) * kTeams + team;
  if (t >= static_cast<long long>(rows) * n_segs) return;   // a whole team (warp teams only)
  const TeamSmem s = team_smem(smem, team, cap, groups);
  const int row = static_cast<int>(t / n_segs), seg = static_cast<int>(t % n_segs);
  const int seg_len = (row_len + n_segs - 1) / n_segs, start = seg * seg_len;
  const size_t at = static_cast<size_t>(row) * ld + start;
  const Row r{vals + at, idx ? idx + at : nullptr, start, max(0, min(seg_len, row_len - start))};
  float* ov = out_v + static_cast<size_t>(row) * k;
  int* oi = out_i + static_cast<size_t>(row) * k;
  if (n_segs == 1) {
    select_row<kTeam, true>(r, k, ov, oi, s, cap, groups, rank);
    return;
  }
  const int kc = min(k, seg_len);
  const size_t c0 = static_cast<size_t>(row) * n_segs * kc;
  select_row<kTeam, true>(r, kc, cand_v + c0 + seg * kc, cand_i + c0 + seg * kc, s, cap, groups,
                          rank);
  if (!last_of<kTeam>(counters + row, n_segs, rank, s.ctl + 1)) return;
  const Row c{cand_v + c0, cand_i + c0, 0, n_segs * kc};
  select_row<kTeam, false>(c, k, ov, oi, s, cap, groups, rank);
}

// --- f32 score tiles on CUDA cores ---------------------------------------------
//
// A BM-query x BN-row tile, TM x TN outputs a thread: output (i, j) of
// thread (ty, tx) is query m_of(ty, i), row n_of(tx, j), in runs of up to
// four neighbours (G) so that each depth step reads them as one vector.
// Each kF32DK-deep slice of both operands is staged transposed ([d][m]);
// the next slice's loads are in registers while this one is multiplied.

constexpr int kF32DK = 16;
constexpr int kVecs = kF32DK / 4;     // 16-byte loads a row of a slice

template <int BM, int BN, int TM, int TN>
struct F32Tile {
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int kGM = TM < 4 ? TM : 4, kGN = TN < 4 ? TN : 4;
  static constexpr int kBandM = BM / (TM / kGM), kBandN = BN / (TN / kGN);
  static constexpr int kPitchM = BM + 4, kPitchN = BN + 4;
  static constexpr int kStage = kF32DK * (kPitchM + kPitchN);          // floats
  static constexpr int kSmemBytes = 2 * kStage * static_cast<int>(sizeof(float));
  static constexpr int kLoadsA = (BM * kVecs + kThreads - 1) / kThreads;
  static constexpr int kLoadsB = (BN * kVecs + kThreads - 1) / kThreads;
  __device__ static int m_of(int ty, int i) { return (i / kGM) * kBandM + ty * kGM + i % kGM; }
  __device__ static int n_of(int tx, int j) { return (j / kGN) * kBandN + tx * kGN + j % kGN; }
};

template <int G>
__device__ __forceinline__ void load_run(const float* p, float* x) {
  if constexpr (G == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (G == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = p[0];
  }
}

template <int G>
__device__ __forceinline__ void store_run(float* p, const float* x) {
  if constexpr (G == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (G == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

// acc = the tile's scores: queries q0.., rows n0.., summed over d in order.
template <int BM, int BN, int TM, int TN>
__device__ __forceinline__ void f32_tile(const float* __restrict__ q,
                                         const float* __restrict__ db, int B, int N, int D,
                                         int q0, int n0, float* smem, float (&acc)[TM][TN]) {
  using T = F32Tile<BM, BN, TM, TN>;
  const int tid = threadIdx.x, tx = tid % (BN / TN), ty = tid / (BN / TN);
  float4 ra[T::kLoadsA], rb[T::kLoadsB];
  auto fetch = [&](int d0) {
#pragma unroll
    for (int u = 0; u < T::kLoadsA; ++u) {
      const int e = tid + u * T::kThreads, r = e / kVecs;
      ra[u] = e < BM * kVecs && q0 + r < B
                  ? __ldg(reinterpret_cast<const float4*>(q + static_cast<size_t>(q0 + r) * D +
                                                          d0 + (e % kVecs) * 4))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < T::kLoadsB; ++u) {
      const int e = tid + u * T::kThreads, r = e / kVecs;
      rb[u] = e < BN * kVecs && n0 + r < N
                  ? __ldg(reinterpret_cast<const float4*>(db + static_cast<size_t>(n0 + r) * D +
                                                          d0 + (e % kVecs) * 4))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto put = [&](int stage) {
    float* as = smem + stage * T::kStage;
    float* bs = as + kF32DK * T::kPitchM;
#pragma unroll
    for (int u = 0; u < T::kLoadsA; ++u) {
      const int e = tid + u * T::kThreads, r = e / kVecs, c = (e % kVecs) * 4;
      if (e < BM * kVecs) {
        as[(c + 0) * T::kPitchM + r] = ra[u].x;
        as[(c + 1) * T::kPitchM + r] = ra[u].y;
        as[(c + 2) * T::kPitchM + r] = ra[u].z;
        as[(c + 3) * T::kPitchM + r] = ra[u].w;
      }
    }
#pragma unroll
    for (int u = 0; u < T::kLoadsB; ++u) {
      const int e = tid + u * T::kThreads, r = e / kVecs, c = (e % kVecs) * 4;
      if (e < BN * kVecs) {
        bs[(c + 0) * T::kPitchN + r] = rb[u].x;
        bs[(c + 1) * T::kPitchN + r] = rb[u].y;
        bs[(c + 2) * T::kPitchN + r] = rb[u].z;
        bs[(c + 3) * T::kPitchN + r] = rb[u].w;
      }
    }
  };
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const int n_steps = D / kF32DK;
  fetch(0);
  put(0);
  __syncthreads();
  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) fetch((s + 1) * kF32DK);
    const float* as = smem + (s & 1) * T::kStage;
    const float* bs = as + kF32DK * T::kPitchM;
#pragma unroll
    for (int d = 0; d < kF32DK; ++d) {
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < TM / T::kGM; ++g)
        load_run<T::kGM>(as + d * T::kPitchM + g * T::kBandM + ty * T::kGM, a + g * T::kGM);
#pragma unroll
      for (int g = 0; g < TN / T::kGN; ++g)
        load_run<T::kGN>(bs + d * T::kPitchN + g * T::kBandN + tx * T::kGN, b + g * T::kGN);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (s + 1 < n_steps) put((s + 1) & 1);
    __syncthreads();
  }
}

// The tile to scores[query * ld + row] (ld % 4 == 0, so a run of G never
// crosses a row's end).
template <int BM, int BN, int TM, int TN>
__device__ __forceinline__ void f32_store(const float (&acc)[TM][TN], float* scores, int ld,
                                          int B, int N, int q0, int n0) {
  using T = F32Tile<BM, BN, TM, TN>;
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = q0 + T::m_of(ty, i);
    if (m >= B) continue;
#pragma unroll
    for (int g = 0; g < TN / T::kGN; ++g) {
      const int n = n0 + T::n_of(tx, g * T::kGN);
      if (n < N) store_run<T::kGN>(scores + static_cast<size_t>(m) * ld + n, &acc[i][g * T::kGN]);
    }
  }
}

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), 2)
topk_score_f32(const float* __restrict__ q, const float* __restrict__ db,
               float* __restrict__ scores, int ld, int B, int N, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][TN];
  f32_tile<BM, BN, TM, TN>(q, db, B, N, D, q0, n0, reinterpret_cast<float*>(smem), acc);
  f32_store<BM, BN, TM, TN>(acc, scores, ld, B, N, q0, n0);
}

// --- f32 score tiles streamed through a cp.async ring (topk_fused) -----------
//
// For tiles too small to hide a slice's copy behind its products: TM x TN
// outputs a thread, output (i, j) of thread (ty, tx) query ty + i * BM / TM,
// row tx + j * BN / TN, so that a warp reads neighbouring rows and stores
// neighbouring scores.  DK-deep slices of both operands stream through a
// kStages-deep cp.async ring, rows of DK + 4 floats (an odd multiple of 16
// bytes: the 16-byte reads of eight neighbouring rows fall on distinct
// banks).  Each score sums its D products in order by fmaf.

template <int BM, int BN, int TM, int TN, int DK, int kStages>
struct RingTile {
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int kPitch = DK + 4;
  static constexpr int kStage = (BM + BN) * kPitch;                    // floats
  static constexpr int kSmemBytes = kStages * kStage * static_cast<int>(sizeof(float));
};

// acc = the tile's scores: queries q0.., rows n0...  Ends with a barrier, so
// the caller may reuse the shared memory.
template <int BM, int BN, int TM, int TN, int DK, int kStages>
__device__ __forceinline__ void ring_tile(const float* __restrict__ q,
                                         const float* __restrict__ db, int B, int N, int D,
                                         int q0, int n0, float* smem, float (&acc)[TM][TN]) {
  using T = RingTile<BM, BN, TM, TN, DK, kStages>;
  constexpr int kChunks = DK / 4;               // 16-byte copies a row of a slice
  const int tid = threadIdx.x, tx = tid % (BN / TN), ty = tid / (BN / TN);
  auto load_stage = [&](int s) {
    float* as = smem + (s % kStages) * T::kStage;
    float* bs = as + BM * T::kPitch;
    const int d0 = s * DK;
#pragma unroll
    for (int e = tid; e < BM * kChunks; e += T::kThreads) {
      const int r = e / kChunks, c = (e % kChunks) * 4;
      const bool in = q0 + r < B;                // rows past the edge are zero-filled
      cp_async16(as + r * T::kPitch + c, q + static_cast<size_t>(in ? q0 + r : 0) * D + d0 + c,
                 in);
    }
#pragma unroll
    for (int e = tid; e < BN * kChunks; e += T::kThreads) {
      const int r = e / kChunks, c = (e % kChunks) * 4;
      const bool in = n0 + r < N;
      cp_async16(bs + r * T::kPitch + c, db + static_cast<size_t>(in ? n0 + r : 0) * D + d0 + c,
                 in);
    }
  };
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const int n_steps = D / DK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load_stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                  // slice s landed; slot s - 1 is free
    if (s + kStages - 1 < n_steps) load_stage(s + kStages - 1);
    cp_async_commit();
    const float* as = smem + (s % kStages) * T::kStage + ty * T::kPitch;
    const float* bs = smem + (s % kStages) * T::kStage + (BM + tx) * T::kPitch;
#pragma unroll
    for (int c = 0; c < DK; c += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + i * (BM / TM) * T::kPitch + c);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(bs + j * (BN / TN) * T::kPitch + c);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The tile to scores[query * ld + row].
template <int BM, int BN, int TM, int TN>
__device__ __forceinline__ void ring_store(const float (&acc)[TM][TN], float* scores, int ld,
                                          int B, int N, int q0, int n0) {
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = q0 + ty + i * (BM / TM);
    if (m >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * (BN / TN);
      if (n < N) scores[static_cast<size_t>(m) * ld + n] = acc[i][j];
    }
  }
}

// --- f32 score and select in one launch (N <= kFusedMaxRows) ------------------
//
// BQ queries x BN rows a block, one output a thread; 32-deep slices six
// deep in flight (the per-slice work is small, so the copies' latency is
// what the ring hides).  The block that finishes a query tile's last row
// tile selects its rows: at k <= kWarpCap 4 x 32 tiles and a warp a row;
// above, 1 x 128 tiles, so that each query's block sorts its row with all
// its threads (one warp sorting 1024 keys is a long serial chain).

constexpr int kFusedThreads = 128, kFusedDK = 32, kFusedStages = 6;
constexpr int kFusedBQ = 4, kFusedBN = kFusedThreads / kFusedBQ;   // k <= kWarpCap

template <int BQ>
using FusedTile = RingTile<BQ, kFusedThreads / BQ, 1, 1, kFusedDK, kFusedStages>;

template <int BQ>
__global__ void __launch_bounds__(kFusedThreads)
topk_fused(const float* __restrict__ q, const float* __restrict__ db, float* scores, int ld,
           int B, int N, int D, int k, float* __restrict__ out_v, int* __restrict__ out_i,
           int* counters, int cap) {
  constexpr int BN = kFusedThreads / BQ;
  extern __shared__ __align__(16) unsigned char smem[];
  const int q0 = blockIdx.y * BQ, n0 = blockIdx.x * BN;
  float acc[1][1];
  ring_tile<BQ, BN, 1, 1, kFusedDK, kFusedStages>(q, db, B, N, D, q0, n0,
                                                  reinterpret_cast<float*>(smem), acc);
  ring_store<BQ, BN, 1, 1>(acc, scores, ld, B, N, q0, n0);
  __shared__ int flag;
  if (!last_of<kFusedThreads>(counters + blockIdx.y, gridDim.x, threadIdx.x, &flag)) return;
  if constexpr (BQ == 1) {
    const int groups = row_groups(N, kFusedThreads);
    const TeamSmem s = team_smem(smem, 0, cap, groups);
    select_row<kFusedThreads, false>(Row{scores + static_cast<size_t>(q0) * ld, nullptr, 0, N},
                                     k, out_v + static_cast<size_t>(q0) * k,
                                     out_i + static_cast<size_t>(q0) * k, s, cap, groups,
                                     threadIdx.x);
  } else {
    const int warp = threadIdx.x / 32, groups = row_groups(N, 32);
    const TeamSmem s = team_smem(smem, warp, cap, groups);
    for (int r = warp; r < BQ && q0 + r < B; r += kFusedThreads / 32) {
      const size_t qi = q0 + r;
      select_row<32, false>(Row{scores + qi * ld, nullptr, 0, N}, k, out_v + qi * k,
                            out_i + qi * k, s, cap, groups, threadIdx.x % 32);
    }
  }
}

// --- bf16 score tiles on tensor cores (k > 32 or D > 1024) --------------------
//
// 128 database rows x 64 queries a block; 8 warps of 32 rows x 32 queries,
// each k16 step two A fragments (database rows) and four B fragments
// (queries), both ldmatrix'd from the ring, into 8 mma.

constexpr int kMmaThreads = 256;
constexpr int kMmaBR = 128;
constexpr int kMmaBQ = 64;
constexpr int kMmaDK = 64;
constexpr int kMmaStages = 4;
constexpr int kMmaPitch = kMmaDK + 8;          // 144-byte rows: ldmatrix conflict-free
constexpr int kMmaStageElems = (kMmaBR + kMmaBQ) * kMmaPitch;
constexpr int kMmaSmemBytes = static_cast<int>(sizeof(bf16)) * kMmaStages * kMmaStageElems;

__global__ void __launch_bounds__(kMmaThreads, 2)
topk_score_bf16(const bf16* __restrict__ q, const bf16* __restrict__ db,
                float* __restrict__ scores, int ld, int B, int N, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kMmaBR, q0 = blockIdx.y * kMmaBQ;
  const int n_steps = D / kMmaDK;
  auto load_stage = [&](int s) {
    bf16* rows = ring + (s % kMmaStages) * kMmaStageElems;
    bf16* qs = rows + kMmaBR * kMmaPitch;
    const int d0 = s * kMmaDK;
#pragma unroll
    for (int rep = 0; rep < kMmaBR * (kMmaDK / 8) / kMmaThreads; ++rep) {
      const int e = tid + rep * kMmaThreads, r = e / (kMmaDK / 8), c = (e % (kMmaDK / 8)) * 8;
      const bool in = n0 + r < N;      // the ragged edge is zero-filled
      cp_async16(rows + r * kMmaPitch + c,
                 db + static_cast<size_t>(in ? n0 + r : 0) * D + d0 + c, in);
    }
#pragma unroll
    for (int rep = 0; rep < kMmaBQ * (kMmaDK / 8) / kMmaThreads; ++rep) {
      const int e = tid + rep * kMmaThreads, r = e / (kMmaDK / 8), c = (e % (kMmaDK / 8)) * 8;
      const bool in = q0 + r < B;
      cp_async16(qs + r * kMmaPitch + c,
                 q + static_cast<size_t>(in ? q0 + r : 0) * D + d0 + c, in);
    }
  };
#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < n_steps) load_stage(s);
    cp_async_commit();
  }
  const int wr = (warp % 4) * 32, wq = (warp / 4) * 32;
  const int a_off = (lane % 16) * kMmaPitch + (lane / 16) * 8;
  const int b_off = ((lane / 16) * 8 + lane % 8) * kMmaPitch + ((lane / 8) % 2) * 8;
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();                  // stage s landed; slot s-1 is free
    if (s + kMmaStages - 1 < n_steps) load_stage(s + kMmaStages - 1);
    cp_async_commit();
    const bf16* rows = ring + (s % kMmaStages) * kMmaStageElems;
    const bf16* qs = rows + kMmaBR * kMmaPitch;
#pragma unroll
    for (int ks = 0; ks < kMmaDK / 16; ++ks) {
      unsigned af[2][4], bfr[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(af[mt], rows + (wr + mt * 16) * kMmaPitch + a_off + ks * 16);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4(bfr[np], qs + (wq + np * 16) * kMmaPitch + b_off + ks * 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma_bf16(acc[mt][2 * np], af[mt], bfr[np]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bfr[np] + 2);
        }
    }
  }
  cp_async_wait<0>();
  // acc[mt][nt]: rows g and g + 8 of the m-tile, queries 2t and 2t + 1 of the n-tile
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = n0 + wr + mt * 16 + g + 8 * (e / 2);
        const int qi = q0 + wq + nt * 8 + 2 * t + e % 2;
        if (row < N && qi < B) scores[static_cast<size_t>(qi) * ld + row] = acc[mt][nt][e];
      }
}

// --- launches -------------------------------------------------------------------

// Per variant: query tile, database rows a block, depth step.
constexpr int kTiles[5][3] = {{128, 128, kF32DK}, {64, 64, kF32DK}, {kTcBQ, kTcBN, kTcDK},
                              {kMmaBQ, kMmaBR, kMmaDK}, {kFusedBQ, kFusedBN, kFusedDK}};

inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

constexpr int kMaxDynSmem = 226 * 1024;   // 227 KB less room for static shared memory

// Raise `kernel`'s dynamic shared-memory limit to near the card's, once.
template <typename K>
cudaError_t allow_max_smem(K kernel, int (&done)[64]) {
  return allow_smem(reinterpret_cast<const void*>(kernel), kMaxDynSmem, done);
}

// A team per (row, segment): warps where the rows are many, short and k
// small, else blocks; room for the group maxima of a segment and of the
// merged candidates.
cudaError_t launch_select(const float* vals, const int* idx, int rows, int row_len, int ld,
                          int n_segs, int k, float* cand_v, int* cand_i, float* out_v,
                          int* out_i, int* counters, cudaStream_t st) {
  const long long teams = static_cast<long long>(rows) * n_segs;
  const int seg_len = (row_len + n_segs - 1) / n_segs;
  const int merged = n_segs > 1 ? n_segs * std::min(k, seg_len) : 0;
  cudaError_t err;
  if (k <= kWarpCap && teams >= 512 && seg_len <= 4096) {
    static int smem_set[64];
    if ((err = allow_max_smem(topk_select<32>, smem_set)) != cudaSuccess) return err;
    constexpr int kTeams = kSelThreads / 32;
    const int cap = pow2_at_least(k), groups = row_groups(seg_len, 32);
    topk_select<32><<<static_cast<unsigned>((teams + kTeams - 1) / kTeams), kSelThreads,
                      kTeams * team_bytes(cap, groups), st>>>(vals, idx, rows, row_len, ld,
                                                              n_segs, k, cand_v, cand_i, out_v,
                                                              out_i, counters, cap, groups);
  } else {
    static int smem_set[64];
    if ((err = allow_max_smem(topk_select<kSelThreads>, smem_set)) != cudaSuccess) return err;
    const int cap = pow2_at_least(std::min(k, kBlockCap));
    const int groups = std::min(kMaxGroups, row_groups(std::max(seg_len, merged), kSelThreads));
    topk_select<kSelThreads><<<static_cast<unsigned>(teams), kSelThreads,
                               team_bytes(cap, groups), st>>>(
        vals, idx, rows, row_len, ld, n_segs, k, cand_v, cand_i, out_v, out_i, counters, cap,
        groups);
  }
  return cudaGetLastError();
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch_score_f32(const float* q, const float* db, float* scores, int ld, int B,
                             int N, int D, cudaStream_t st) {
  using T = F32Tile<BM, BN, TM, TN>;
  dim3 grid((N + BN - 1) / BN, (B + BM - 1) / BM);
  topk_score_f32<BM, BN, TM, TN><<<grid, T::kThreads, T::kSmemBytes, st>>>(q, db, scores, ld,
                                                                           B, N, D);
  return cudaGetLastError();
}

cudaError_t launch_score_bf16(const bf16* q, const bf16* db, float* scores, int ld, int B, int N,
                              int D, cudaStream_t st) {
  static int smem_set[64];
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(topk_score_bf16), kMmaSmemBytes,
                               smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kMmaBR - 1) / kMmaBR, (B + kMmaBQ - 1) / kMmaBQ);
  topk_score_bf16<<<grid, kMmaThreads, kMmaSmemBytes, st>>>(q, db, scores, ld, B, N, D);
  return cudaGetLastError();
}

// Shared memory: the tile's ring, then the selection's (a warp team's per
// warp, or the block team's).
template <int BQ>
cudaError_t launch_fused_tiles(const float* q, const float* db, float* scores, int ld, int B,
                               int N, int D, int k, float* out_v, int* out_i, int* counters,
                               cudaStream_t st) {
  static int smem_set[64];
  cudaError_t err = allow_max_smem(topk_fused<BQ>, smem_set);
  if (err != cudaSuccess) return err;
  const int cap = pow2_at_least(k);
  const int sel = BQ == 1 ? team_bytes(cap, row_groups(N, kFusedThreads))
                          : (kFusedThreads / 32) * team_bytes(cap, row_groups(N, 32));
  constexpr int BN = kFusedThreads / BQ;
  dim3 grid((N + BN - 1) / BN, (B + BQ - 1) / BQ);
  topk_fused<BQ><<<grid, kFusedThreads, std::max(FusedTile<BQ>::kSmemBytes, sel), st>>>(
      q, db, scores, ld, B, N, D, k, out_v, out_i, counters, cap);
  return cudaGetLastError();
}

cudaError_t launch_fused(const float* q, const float* db, float* scores, int ld, int B, int N,
                         int D, int k, float* out_v, int* out_i, int* counters, cudaStream_t st) {
  if (k <= kWarpCap)
    return launch_fused_tiles<kFusedBQ>(q, db, scores, ld, B, N, D, k, out_v, out_i, counters, st);
  return launch_fused_tiles<1>(q, db, scores, ld, B, N, D, k, out_v, out_i, counters, st);
}

template <int kMaxSlices>
cudaError_t launch_tc_slices(const void* q, const void* db, float* cv, int* ci, int B,
                             int N, int D, int k, int n_splits, cudaStream_t st) {
  static int smem_set[64];
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(topk_tc<kMaxSlices>),
                               static_cast<int>(kTcSmemBytes), smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((B + kTcBQ - 1) / kTcBQ, n_splits);
  topk_tc<kMaxSlices><<<grid, kTcThreads, kTcSmemBytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(db), cv, ci, B, N, D, k,
      n_splits);
  return cudaGetLastError();
}

// D <= 768 (the CLIP ViT-L/14 DB) keeps the q fragments in 96 registers;
// wider rows take the 128-register instantiation.
cudaError_t launch_tc(const void* q, const void* db, float* cv, int* ci, int B, int N,
                      int D, int k, int n_splits, cudaStream_t st) {
  if (D <= 12 * kTcDK) return launch_tc_slices<12>(q, db, cv, ci, B, N, D, k, n_splits, st);
  return launch_tc_slices<kTcMaxDim / kTcDK>(q, db, cv, ci, B, N, D, k, n_splits, st);
}

}  // namespace

extern "C" int keds_topk_query_tile(int variant) { return kTiles[variant][0]; }
extern "C" int keds_topk_chunk_rows(int variant) { return kTiles[variant][1]; }
extern "C" int keds_topk_depth_step(int variant) { return kTiles[variant][2]; }
// Largest D of topk_tc (its queries' fragments live in registers).
extern "C" int keds_topk_tc_max_dim() { return kTcMaxDim; }
extern "C" int keds_topk_fused_max_rows() { return kFusedMaxRows; }

// q (B, D) and db (N, D) row-major, 16-byte aligned, D a multiple of the
// variant's depth step (the Python wrapper, ops/topk.py:mips_topk, zero-pads
// any D).  1 <= k <= N; k <= 32 and D <= 1024 for bf16_tc; N <= 1024 for
// f32_fused.  out_v / out_i: (B, k).  bf16_tc: cand_v / cand_i hold
// B * n_splits * k entries (n_splits database slices, <= the chunks).  The
// others: scores holds B * ld floats (ld >= N, a multiple of 4); n_splits
// segments of each row, and with more than one cand_v / cand_i hold
// B * n_splits * min(k, ceil(N / n_splits)) entries.  counters: at least B
// zeroed ints, left zeroed.  *kernels receives the number of kernels
// launched (the same for every k).
extern "C" int keds_mips_topk(const void* q, const void* db, void* scores, void* cand_v,
                              void* cand_i, void* out_v, void* out_i, void* counters,
                              int variant, int B, int N, int D, int k, int n_splits, int ld,
                              void* stream, int* kernels) {
  *kernels = 0;
  if (variant < kF32 || variant > kF32Fused || k < 1 || k > N || B < 1 || n_splits < 1 ||
      n_splits > N || D < 1 || D % kTiles[variant][2] ||
      (variant == kBf16Tc && (k > kLaneK || D > kTcMaxDim)) ||
      (variant != kBf16Tc && (ld < N || ld % 4)) ||
      (variant == kF32Fused && (N > kFusedMaxRows || n_splits != 1)))
    return cudaErrorInvalidValue;
  float* cv = static_cast<float*>(cand_v);
  int* ci = static_cast<int*>(cand_i);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  float* sc = static_cast<float*>(scores);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (variant) {
    case kBf16Tc:
      err = launch_tc(q, db, cv, ci, B, N, D, k, n_splits, st);
      if (err != cudaSuccess) return err;
      *kernels = 1;
      err = launch_select(cv, ci, B, n_splits * k, n_splits * k, 1, k, nullptr, nullptr, ov, oi,
                          cnt, st);
      break;
    case kF32Fused:
      err = launch_fused(static_cast<const float*>(q), static_cast<const float*>(db), sc, ld, B,
                         N, D, k, ov, oi, cnt, st);
      break;
    default:
      if (variant == kF32)
        err = launch_score_f32<128, 128, 8, 8>(static_cast<const float*>(q),
                                               static_cast<const float*>(db), sc, ld, B, N, D, st);
      else if (variant == kF32Mid)
        err = launch_score_f32<64, 64, 4, 4>(static_cast<const float*>(q),
                                             static_cast<const float*>(db), sc, ld, B, N, D, st);
      else
        err = launch_score_bf16(static_cast<const bf16*>(q), static_cast<const bf16*>(db), sc,
                                ld, B, N, D, st);
      if (err != cudaSuccess) return err;
      *kernels = 1;
      err = launch_select(sc, nullptr, B, N, ld, n_splits, k, cv, ci, ov, oi, cnt, st);
  }
  if (err == cudaSuccess) ++*kernels;
  return err;
}
