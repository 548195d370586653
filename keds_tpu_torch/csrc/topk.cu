// Fused exact top-k by inner product (MIPS) on Hopper (sm_90a).
//
// Replaces the TPU kernel keds_tpu/ops/pallas_topk.py:mips_topk_pallas
// (body _kernel, merge _iterative_topk).  queries (B, D) and a database
// (N, D), both f32 or both bf16, give the k best rows per query: values
// (B, k) f32 and indices (B, k) int32, sorted by descending score with ties
// going to the lower row index.  Score tiles are accumulated in f32 and
// folded at once into a running top-k, so the (B, N) score matrix never
// reaches device memory.
//
// The TPU kernel carries its running top-k across a sequential grid in VMEM.
// Hopper blocks run in parallel and carry nothing between them, so the
// search is two launches:
//   1. a partial kernel, one block per (query tile, slice of the database),
//      writes k candidates per query to a scratch buffer (B, n_splits, k).
//      The slices split the database's chunks evenly (they differ by at
//      most one chunk).  Rows >= N (the ragged edge) are never offered;
//      the database is not padded.
//   2. topk_merge: one warp per query folds its candidates into the final
//      top-k with the same insertion rule.
//
// Tie rule (both passes): entry a beats b when a.score > b.score, or the
// scores are equal and a.index < b.index; empty slots (index -1) lose to
// everything.  This is the lower-index-first order of lax.top_k and of the
// Pallas kernel's first-argmax merge.
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
//     kernel above its bound.
//
// topk_f32 (f32: the corpus ranking).  Exact f32 FMA on CUDA cores (tensor
// cores would round to TF32), 64-query x 128-row tiles.  For a small
// database (the 256-row ranking) the wrapper picks 16 x 32 tiles, so the
// search spreads over tens of blocks instead of two.  Both tile sizes sum
// each score in the same order.

#include "common.cuh"

namespace {

using namespace keds;
using bf16 = __nv_bfloat16;

constexpr int kMaxK = 32;        // one lane per running entry

// Variant codes of the C interface (mirrored in ops/topk.py).
enum Variant : int { kF32 = 0, kF32Small = 1, kBf16Tc = 2 };

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

// --- f32 CUDA-core partial kernel -------------------------------------------

constexpr int kThreads = 256;
constexpr int kDK = 32;          // depth of one staged slice of D

// Stage rows [row0, row0 + kRows) x [d0, d0 + kDK) of a row-major (rows, D)
// f32 matrix into dst[d][row] (transposed), zero-filling rows >= limit.
template <int kRows>
__device__ __forceinline__ void stage(const float* __restrict__ src, int row0, int limit,
                                      int D, int d0, float* dst) {
  constexpr int kVecs = kRows * (kDK / 8);
#pragma unroll
  for (int rep = 0; rep < (kVecs + kThreads - 1) / kThreads; ++rep) {
    const int e = threadIdx.x + rep * kThreads;
    if (kVecs % kThreads != 0 && e >= kVecs) break;
    const int row = e / (kDK / 8), dd = (e % (kDK / 8)) * 8;
    float x[8];
    if (row0 + row < limit) {
      const float* p = src + static_cast<size_t>(row0 + row) * D + d0 + dd;
      const float4 a = *reinterpret_cast<const float4*>(p);
      const float4 b = *reinterpret_cast<const float4*>(p + 4);
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) dst[(dd + u) * kRows + row] = x[u];
  }
}

// kBQ queries x kBN rows per tile; thread (ty, tx) of a 16 x 16 grid owns
// queries ty * kBQ/16 + i and rows tx + 16 j.
template <int kBQ, int kBN>
__global__ void __launch_bounds__(kThreads)
topk_f32(const float* __restrict__ q, const float* __restrict__ db,
         float* __restrict__ cand_v, int* __restrict__ cand_i, int B, int N, int D,
         int k, int n_splits) {
  constexpr int kQPT = kBQ / 16, kRPT = kBN / 16;
  constexpr int kScoreLd = kBN + 1;
  constexpr int kQueriesPerWarp = kBQ / (kThreads / 32);
  constexpr int kTileFloats = kDK * kBQ + kDK * kBN;
  constexpr int kSmemFloats = kTileFloats > kBQ * kScoreLd ? kTileFloats : kBQ * kScoreLd;
  __shared__ __align__(16) float smem[kSmemFloats];
  float* q_s = smem;                 // [kDK][kBQ]
  float* d_s = smem + kDK * kBQ;     // [kDK][kBN]
  float* sc = smem;                  // [kBQ][kScoreLd], reuses the tiles

  const int q0 = blockIdx.x * kBQ;
  const int split = blockIdx.y;
  int c_begin, c_end;
  slice_range((N + kBN - 1) / kBN, n_splits, split, c_begin, c_end);

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float sv[kQueriesPerWarp];
  int si[kQueriesPerWarp];
#pragma unroll
  for (int i = 0; i < kQueriesPerWarp; ++i) {
    sv[i] = -CUDART_INF_F;
    si[i] = -1;
  }

  for (int c = c_begin; c < c_end; ++c) {
    const int n0 = c * kBN;
    float acc[kQPT][kRPT];
#pragma unroll
    for (int i = 0; i < kQPT; ++i)
#pragma unroll
      for (int j = 0; j < kRPT; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += kDK) {
      __syncthreads();
      stage<kBQ>(q, q0, B, D, d0, q_s);
      stage<kBN>(db, n0, N, D, d0, d_s);
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < kDK; ++d) {
        float av[kQPT];
        if constexpr (kQPT == 4) {
          const float4 a = *reinterpret_cast<const float4*>(q_s + d * kBQ + ty * 4);
          av[0] = a.x; av[1] = a.y; av[2] = a.z; av[3] = a.w;
        } else {
#pragma unroll
          for (int i = 0; i < kQPT; ++i) av[i] = q_s[d * kBQ + ty * kQPT + i];
        }
#pragma unroll
        for (int j = 0; j < kRPT; ++j) {
          const float bv = d_s[d * kBN + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kQPT; ++i) acc[i][j] = fmaf(av[i], bv, acc[i][j]);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kQPT; ++i)
#pragma unroll
      for (int j = 0; j < kRPT; ++j) sc[(ty * kQPT + i) * kScoreLd + tx + 16 * j] = acc[i][j];
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kQueriesPerWarp; ++i) {
      const float* row = sc + (warp * kQueriesPerWarp + i) * kScoreLd;
#pragma unroll
      for (int u = 0; u < kBN / 32; ++u) {
        const int col = lane + 32 * u;
        offer(sv[i], si[i], row[col], n0 + col, n0 + col < N, k, lane);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kQueriesPerWarp; ++i) {
    const int qi = q0 + warp * kQueriesPerWarp + i;
    if (qi < B && lane < k) {
      const size_t o = (static_cast<size_t>(qi) * n_splits + split) * k + lane;
      cand_v[o] = sv[i];
      cand_i[o] = si[i];
    }
  }
}

__global__ void __launch_bounds__(128)
topk_merge(const float* __restrict__ cand_v, const int* __restrict__ cand_i,
           float* __restrict__ out_v, int* __restrict__ out_i, int B,
           int n_cand, int k) {
  const int qi = blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (qi >= B) return;   // whole warp leaves together
  const float* cv = cand_v + static_cast<size_t>(qi) * n_cand;
  const int* ci = cand_i + static_cast<size_t>(qi) * n_cand;
  float sv = -CUDART_INF_F;
  int si = -1;
  for (int base = 0; base < n_cand; base += 32) {
    const int c = base + lane;
    const bool in = c < n_cand;
    const float v = in ? cv[c] : -CUDART_INF_F;
    const int i = in ? ci[c] : -1;
    offer(sv, si, v, i, in && i >= 0, k, lane);
  }
  if (lane < k) {
    out_v[static_cast<size_t>(qi) * k + lane] = sv;
    out_i[static_cast<size_t>(qi) * k + lane] = si;
  }
}

// Per variant: query tile, chunk rows.
constexpr int kTiles[3][2] = {{64, 128}, {16, 32}, {kTcBQ, kTcBN}};

template <int kBQ, int kBN>
cudaError_t launch_f32(const void* q, const void* db, float* cv, int* ci, int B, int N,
                       int D, int k, int n_splits, cudaStream_t st) {
  dim3 grid((B + kBQ - 1) / kBQ, n_splits);
  topk_f32<kBQ, kBN><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(db), cv, ci, B, N, D, k,
      n_splits);
  return cudaGetLastError();
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

extern "C" int keds_topk_max_k() { return kMaxK; }
extern "C" int keds_topk_query_tile(int variant) { return kTiles[variant][0]; }
extern "C" int keds_topk_chunk_rows(int variant) { return kTiles[variant][1]; }
// Largest D of the bf16 kernel (its queries' fragments live in registers).
extern "C" int keds_topk_tc_max_dim() { return kTcMaxDim; }

// q (B, D) and db (N, D) row-major, 16-byte aligned; D % 32 == 0 (f32) or
// D % 64 == 0 (bf16).  cand_v / cand_i: scratch of B * n_splits * k entries.  n_splits <= the number of chunks.
extern "C" int keds_mips_topk(const void* q, const void* db, void* cand_v,
                              void* cand_i, void* out_v, void* out_i, int variant,
                              int B, int N, int D, int k, int n_splits, void* stream) {
  if (k < 1 || k > kMaxK || k > N || B < 1 || n_splits < 1 || variant < kF32 ||
      variant > kBf16Tc)
    return cudaErrorInvalidValue;
  float* cv = static_cast<float*>(cand_v);
  int* ci = static_cast<int*>(cand_i);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (variant == kBf16Tc) {
    if (D % kTcDK || D > keds_topk_tc_max_dim()) return cudaErrorInvalidValue;
    err = launch_tc(q, db, cv, ci, B, N, D, k, n_splits, st);
  } else {
    if (D % kDK) return cudaErrorInvalidValue;
    err = variant == kF32 ? launch_f32<64, 128>(q, db, cv, ci, B, N, D, k, n_splits, st)
                          : launch_f32<16, 32>(q, db, cv, ci, B, N, D, k, n_splits, st);
  }
  if (err != cudaSuccess) return err;
  topk_merge<<<(B + 3) / 4, 128, 0, st>>>(cv, ci, static_cast<float*>(out_v),
                                         static_cast<int*>(out_i), B,
                                         n_splits * k, k);
  return cudaGetLastError();
}
