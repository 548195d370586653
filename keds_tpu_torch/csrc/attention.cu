// Fused self-attention forward for the CLIP towers on Hopper (sm_90a).
//
// Replaces the TPU kernel keds_tpu/ops/attention.py:flash_attention (Pallas
// body _kernel, pallas_call in _flash_forward).  Computes, for each
// (batch, head), softmax(q k^T / sqrt(Dh), optionally causal) v over any
// sequence length S >= 1 (257 vision tokens and up to 77 text tokens on the
// main paths; 577 for ViT-L/14 at 336 px).  Numerics follow the Pallas
// kernel: scores and softmax are f32, probabilities are normalised and then
// rounded to v's type, P.V accumulates in f32 and the output is written in
// q's type.  Keys >= S, and keys > row when causal, are masked, so nothing
// is padded on the host.
//
// Layout: q, k, v and o are (B, H, S, Dh) tensors with arbitrary batch,
// sequence and head strides (unit stride over Dh), so the strided views of
// the fused qkv projection's (B, S, 3, H, Dh) output are read in place and
// the context is written straight into (B, S, H, Dh) order.
//
// Four kernels: two for S <= kMaxResident (K and V of a (batch, head) stay
// whole in shared memory), two that stream K and V through shared memory in
// key chunks above that; bf16 and f32 each.  None falls back to another.
//
// attention_tc (bf16, Dh = 64, S <= 288).  What bounds it on the H100: at
// the vision chunk (16, 16, 257, 64) the function moves 34 MB and does 4.3
// GFLOP, about 128 flop per byte against the card's ridge of about 295, so
// the floor is the HBM read (10 us).  The design keeps the products on
// tensor cores and every byte on chip once read:
//   * mma.sync m16n8k16 (bf16 in, f32 accumulate) for q.k^T and P.V, with
//     K and V operands from shared memory through ldmatrix (.trans for V).
//     wgmma/TMA were not used: at these sizes the bytes set the bound, and a
//     warp owning 16 query rows keeps the softmax in the mma's own register
//     fragments with no cross-warp exchange.
//   * One block per (batch, head), whose warps (up to 9) take the 16-row
//     query tiles in rounds (at the vision chunk this measured faster than
//     splitting the query axis over 2 to 17 blocks).  K and V go to shared
//     memory once with 16-byte cp.async (rows padded to 144 bytes, so
//     ldmatrix is conflict-free).  q fragments come straight
//     from global memory into registers.
//   * Two passes over 16-key tiles per warp: the first takes each row's max
//     and sum in f32 (online rescaling within the pass), the second
//     recomputes q.k^T, forms P = exp(s - m) / l, rounds it to bf16 in the
//     mma A-fragment layout and accumulates P.V.  P therefore rounds where
//     the reference rounds it; the extra q.k^T is cheap where bytes bind.
//   * The 1/sqrt(Dh) scale is applied to the f32 scores (folded with
//     log2(e) into the fma that feeds exp2), and only key tiles that reach
//     a row's limit (S, or the diagonal when causal) are masked.
//
// attention_tc_stream (bf16, Dh = 64, S > 288).  The same two passes and
// per-tile arithmetic (the helpers below are shared), so the result equals
// the resident kernel's.  Whole K and V no longer fit at every S (227 KB
// holds about 800 keys), so each block takes kStreamWarps 16-row query
// tiles of one (batch, head), one per warp, and streams K (pass 1) and then
// K and V (pass 2) through a two-stage ring of kChunk-key buffers filled by
// cp.async while the previous chunk is in use.  K is read twice and V once
// per block; the blocks of one (batch, head) share them through L2 (a
// (batch, head) is 74 KB at S = 577).
//
// attention_f32 (f32, Dh <= 128): exact f32 on CUDA cores (a tensor-core
// version would round to TF32).  One warp per query row, scores in
// registers, K and V staged in shared memory.  It serves the f32 engine;
// the bf16 main path never runs it.  attention_f32_stream takes S above
// 288, or K and V beyond the 227 KB a block may hold: 64-row query tiles,
// K and V in kF32Chunk-key chunks, pass 1 the rows' max and sum in f32
// (online rescaling), pass 2 P = exp(s - m) / l and P.V.

#include "common.cuh"

namespace {

using namespace keds;
using bf16 = __nv_bfloat16;

constexpr int kMaxResident = 288;            // resident kernels: 9 keys a lane in f32
constexpr int kMaxSmem = 227 * 1024;         // the H100's per-block most

struct Strides {
  long long b, s, h;
};

// --- bf16 tensor-core kernels ----------------------------------------------

constexpr int kTcHeadDim = 64;
constexpr int kTcPitch = kTcHeadDim + 8;     // 144-byte smem rows
constexpr int kTcMaxWarps = 9;
constexpr int kTcRows = 16;                  // query rows per warp tile

__host__ __device__ constexpr int tc_key_rows(int n_keys) { return (n_keys + 15) & ~15; }

size_t tc_smem_bytes(int n_keys) {
  return 2 * static_cast<size_t>(tc_key_rows(n_keys)) * kTcPitch * sizeof(bf16);
}

// The query fragments of rows ra and rb = ra + 8 (zero for rows >= S).
__device__ __forceinline__ void tc_load_q(unsigned (&qf)[4][4], const bf16* qb, long long qs,
                                          int ra, int rb, int S, int t) {
  const unsigned* qa = reinterpret_cast<const unsigned*>(qb + ra * qs);
  const unsigned* qr = reinterpret_cast<const unsigned*>(qb + rb * qs);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    qf[kk][0] = ra < S ? __ldg(qa + kk * 8 + t) : 0u;
    qf[kk][1] = rb < S ? __ldg(qr + kk * 8 + t) : 0u;
    qf[kk][2] = ra < S ? __ldg(qa + kk * 8 + 4 + t) : 0u;
    qf[kk][3] = rb < S ? __ldg(qr + kk * 8 + 4 + t) : 0u;
  }
}

// The key limits of a warp's 16 rows: keys < lim are live for the row (rows
// >= S are computed, never stored).  A key tile whose keys all lie below
// lim_warp needs no mask.
struct TcLimits {
  int a, b, warp;
};

// Pass 1 over the 16-key tile at `k_tile` (keys key0..key0+15): each row's
// max m of the raw scores and its sum l = sum exp2(c * (s - m)),
// c = scale * log2(e), rescaled as m grows.
__device__ __forceinline__ void tc_stats_tile(float (&m)[2], float (&l)[2],
                                              const unsigned (&qf)[4][4], const bf16* k_tile,
                                              int key0, TcLimits lim, float c, int lane) {
  const int t = lane % 4;
  float s[2][4];
  mma_abt<kTcPitch>(s, qf, k_tile, lane);
  const bool masked = key0 + 16 > lim.warp;       // warp-uniform
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[u] = s[u / 2][2 * half + u % 2];
      if (masked && key0 + (u / 2) * 8 + 2 * t + (u % 2) >= (half ? lim.b : lim.a))
        v[u] = -CUDART_INF_F;
    }
    const float mx = fmaxf(m[half], fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])));
    if (mx != -CUDART_INF_F) {             // else nothing live yet
      const float mc = mx * c;
      float sum = l[half] * exp2f(fmaf(m[half], c, -mc));
#pragma unroll
      for (int u = 0; u < 4; ++u) sum += exp2f(fmaf(v[u], c, -mc));
      l[half] = sum;
      m[half] = mx;
    }
  }
}

// Combine the four threads of a quad (they hold the same rows): mc = m * c
// and 1 / l of each row.
__device__ __forceinline__ void tc_finish_stats(float (&m)[2], float (&l)[2], float c,
                                                float (&mc)[2], float (&inv_l)[2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float mo = __shfl_xor_sync(kFullMask, m[half], off);
      const float lo = __shfl_xor_sync(kFullMask, l[half], off);
      const float mn = fmaxf(m[half], mo);
      l[half] = (m[half] == -CUDART_INF_F ? 0.f : l[half] * exp2f((m[half] - mn) * c)) +
                (mo == -CUDART_INF_F ? 0.f : lo * exp2f((mo - mn) * c));
      m[half] = mn;
    }
    mc[half] = m[half] * c;
    inv_l[half] = 1.f / l[half];
  }
}

// Pass 2 over one 16-key tile: P = exp2(c * s - c * m) / l rounded to
// bf16, acc += P.V in f32.
__device__ __forceinline__ void tc_pv_tile(float (&acc)[kTcHeadDim / 8][4],
                                           const unsigned (&qf)[4][4], const bf16* k_tile,
                                           const bf16* v_tile, int key0, TcLimits lim, float c,
                                           const float (&mc)[2], const float (&inv_l)[2],
                                           int lane) {
  const int t = lane % 4;
  float s[2][4];
  mma_abt<kTcPitch>(s, qf, k_tile, lane);
  const bool masked = key0 + 16 > lim.warp;       // warp-uniform
  float p[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int half = e / 2;
      p[nt][e] = exp2f(fmaf(s[nt][e], c, -mc[half])) * inv_l[half];
      if (masked && key0 + nt * 8 + 2 * t + (e % 2) >= (half ? lim.b : lim.a))
        p[nt][e] = 0.f;
    }
  const unsigned pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                          pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
  mma_ab<kTcPitch>(acc, pa, v_tile, lane);
}

__device__ __forceinline__ void tc_store(bf16* ob, long long os, const float (&acc)[8][4],
                                         int ra, int rb, int S, int t) {
#pragma unroll
  for (int nt = 0; nt < kTcHeadDim / 8; ++nt) {
    const int d = nt * 8 + 2 * t;
    if (ra < S)
      *reinterpret_cast<unsigned*>(ob + ra * os + d) = pack_bf16(acc[nt][0], acc[nt][1]);
    if (rb < S)
      *reinterpret_cast<unsigned*>(ob + rb * os + d) = pack_bf16(acc[nt][2], acc[nt][3]);
  }
}

__global__ void __launch_bounds__(32 * kTcMaxWarps)
attention_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o, int H, int S,
             Strides qs, Strides ks, Strides vs, Strides os, int causal,
             float scale_log2e) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_tiles = (S + kTcRows - 1) / kTcRows;
  const int kp = tc_key_rows(S);
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kp * kTcPitch;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const bf16* kb_ptr = k + b * ks.b + h * ks.h;
  const bf16* vb_ptr = v + b * vs.b + h * vs.h;
  for (int e = threadIdx.x; e < kp * (kTcHeadDim / 8); e += blockDim.x) {
    const int j = e / (kTcHeadDim / 8), c = (e % (kTcHeadDim / 8)) * 8;
    const bool in = j < S;                 // padded key rows are zero-filled
    const int js = in ? j : 0;
    cp_async16(k_s + j * kTcPitch + c, kb_ptr + js * ks.s + c, in);
    cp_async16(v_s + j * kTcPitch + c, vb_ptr + js * vs.s + c, in);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_warps = blockDim.x / 32;
  const bf16* qb = q + b * qs.b + h * qs.h;
  bf16* ob = o + b * os.b + h * os.h;

  for (int tile = warp; tile < n_tiles; tile += n_warps) {
    const int r0 = tile * kTcRows;
    const int ra = r0 + g, rb = ra + 8;        // this thread's two rows
    unsigned qf[4][4];
    tc_load_q(qf, qb, qs.s, ra, rb, S, t);
    const TcLimits lim{causal ? min(S, ra + 1) : S, causal ? min(S, rb + 1) : S,
                       causal ? min(S, r0 + 1) : S};
    const int n_kb = ((causal ? min(S, r0 + kTcRows) : S) + 15) / 16;
    const float c = scale_log2e;

    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
#pragma unroll 2
    for (int kb = 0; kb < n_kb; ++kb)
      tc_stats_tile(m, l, qf, k_s + kb * 16 * kTcPitch, kb * 16, lim, c, lane);
    float mc[2], inv_l[2];
    tc_finish_stats(m, l, c, mc, inv_l);

    float acc[kTcHeadDim / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTcHeadDim / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll 2
    for (int kb = 0; kb < n_kb; ++kb)
      tc_pv_tile(acc, qf, k_s + kb * 16 * kTcPitch, v_s + kb * 16 * kTcPitch, kb * 16, lim,
                 c, mc, inv_l, lane);
    tc_store(ob, os.s, acc, ra, rb, S, t);
  }
}

// --- streaming bf16 kernel (S > kMaxResident) ------------------------------

constexpr int kStreamWarps = 8;              // 16-row query tiles a block
constexpr int kChunk = 64;                   // keys a shared-memory stage
constexpr size_t kChunkElems = static_cast<size_t>(kChunk) * kTcPitch;

constexpr size_t stream_smem_bytes() { return 2 * 2 * kChunkElems * sizeof(bf16); }

// cp.async the kChunk key rows from j0 of one (batch, head) into `dst`
// (rows past S zero-filled).
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src, long long stride,
                                           int j0, int S) {
  for (int e = threadIdx.x; e < kChunk * (kTcHeadDim / 8); e += blockDim.x) {
    const int j = e / (kTcHeadDim / 8), c = (e % (kTcHeadDim / 8)) * 8;
    const bool in = j0 + j < S;
    cp_async16(dst + j * kTcPitch + c, src + (in ? j0 + j : 0) * stride + c, in);
  }
}

__global__ void __launch_bounds__(32 * kStreamWarps)
attention_tc_stream(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, int H, int S,
                    Strides qs, Strides ks, Strides vs, Strides os, int causal,
                    float scale_log2e) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);       // two stages of kChunk keys
  bf16* v_s = k_s + 2 * kChunkElems;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = (blockIdx.y * kStreamWarps + warp) * kTcRows;
  const int ra = r0 + g, rb = ra + 8;
  const bf16* kb_ptr = k + b * ks.b + h * ks.h;
  const bf16* vb_ptr = v + b * vs.b + h * vs.h;
  bf16* ob = o + b * os.b + h * os.h;

  unsigned qf[4][4];
  tc_load_q(qf, q + b * qs.b + h * qs.h, qs.s, ra, rb, S, t);
  const TcLimits lim{causal ? min(S, ra + 1) : S, causal ? min(S, rb + 1) : S,
                     causal ? min(S, r0 + 1) : S};
  // keys any of this warp's rows sees (none for a tile past S), and any of
  // the block's
  const int warp_keys = r0 >= S ? 0 : (causal ? min(S, r0 + kTcRows) : S);
  const int block_keys = causal ? min(S, (blockIdx.y + 1) * kStreamWarps * kTcRows) : S;
  const int n_chunks = (block_keys + kChunk - 1) / kChunk;
  const float c = scale_log2e;

  // 16-key tiles of chunk ch that this warp computes
  auto chunk_tiles = [&](int ch) { return max(0, min(kChunk, warp_keys - ch * kChunk) + 15) / 16; };

  // Pass 1: K alone through the ring.
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  load_chunk(k_s, kb_ptr, ks.s, 0, S);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      load_chunk(k_s + ((ch + 1) & 1) * kChunkElems, kb_ptr, ks.s, (ch + 1) * kChunk, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kc = k_s + (ch & 1) * kChunkElems;
    const int n_kb = chunk_tiles(ch);
    for (int kb = 0; kb < n_kb; ++kb)
      tc_stats_tile(m, l, qf, kc + kb * 16 * kTcPitch, ch * kChunk + kb * 16, lim, c, lane);
    __syncthreads();                             // the stage is refilled next
  }
  float mc[2], inv_l[2];
  tc_finish_stats(m, l, c, mc, inv_l);

  // Pass 2: K and V through the ring.
  float acc[kTcHeadDim / 8][4];
#pragma unroll
  for (int nt = 0; nt < kTcHeadDim / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  load_chunk(k_s, kb_ptr, ks.s, 0, S);
  load_chunk(v_s, vb_ptr, vs.s, 0, S);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      const size_t off = ((ch + 1) & 1) * kChunkElems;
      load_chunk(k_s + off, kb_ptr, ks.s, (ch + 1) * kChunk, S);
      load_chunk(v_s + off, vb_ptr, vs.s, (ch + 1) * kChunk, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const size_t off = (ch & 1) * kChunkElems;
    const int n_kb = chunk_tiles(ch);
    for (int kb = 0; kb < n_kb; ++kb)
      tc_pv_tile(acc, qf, k_s + off + kb * 16 * kTcPitch, v_s + off + kb * 16 * kTcPitch,
                 ch * kChunk + kb * 16, lim, c, mc, inv_l, lane);
    __syncthreads();
  }
  tc_store(ob, os.s, acc, ra, rb, S, t);
}

int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int H,
              int S, Strides qs, Strides ks, Strides vs, Strides os, int causal,
              float scale, cudaStream_t stream) {
  const float c = scale * 1.4426950408889634f;
  if (S > kMaxResident) {
    // one block per (batch, head) and kStreamWarps query tiles
    dim3 grid(B * H, (S + kStreamWarps * kTcRows - 1) / (kStreamWarps * kTcRows));
    attention_tc_stream<<<grid, 32 * kStreamWarps, stream_smem_bytes(), stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), H, S, qs, ks, vs, os, causal, c);
    return cudaGetLastError();
  }
  static int smem_set[64];
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(attention_tc),
                               static_cast<int>(tc_smem_bytes(kMaxResident)), smem_set);
  if (err != cudaSuccess) return err;
  // One block per (batch, head); its warps take the 16-row tiles
  // round-robin, as many warps as make the rounds even.
  const int n_tiles = (S + kTcRows - 1) / kTcRows;
  const int rounds = (n_tiles + kTcMaxWarps - 1) / kTcMaxWarps;
  const int warps = (n_tiles + rounds - 1) / rounds;
  attention_tc<<<B * H, 32 * warps, tc_smem_bytes(S), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, S, qs, ks, vs, os,
      causal, c);
  return cudaGetLastError();
}

// --- f32 CUDA-core kernels ------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQueryTile = 64;
constexpr int kKeysPerLane = kMaxResident / 32;
constexpr int kMaxHeadDim = 128;
constexpr int kDimsPerLane = kMaxHeadDim / 32;

// Shared-memory row pitch: one extra word per row so that lanes reading the
// same column of consecutive rows hit distinct banks.
__host__ __device__ constexpr int f32_pitch(int dh) { return dh + 1; }

__host__ __device__ size_t f32_kv_bytes(int s, int dh) {
  size_t b = 2 * static_cast<size_t>(s) * f32_pitch(dh) * sizeof(float);
  return (b + 15) & ~static_cast<size_t>(15);
}

size_t f32_smem_bytes(int s, int dh) {
  return f32_kv_bytes(s, dh) + kWarps * (kMaxHeadDim + kMaxResident) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
attention_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int H, int S,
              int Dh, Strides qs, Strides ks, Strides vs, Strides os, int causal,
              float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = f32_pitch(Dh);
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + static_cast<size_t>(S) * ld;
  float* q_s = reinterpret_cast<float*>(smem + f32_kv_bytes(S, Dh));
  float* p_s = q_s + kWarps * kMaxHeadDim;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int r0 = blockIdx.y * kQueryTile;
  const int r_end = min(S, r0 + kQueryTile);
  const int n_keys = causal ? r_end : S;

  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  for (int e = threadIdx.x; e < n_keys * Dh; e += kThreads) {
    const int j = e / Dh, d = e - j * Dh;
    k_s[j * ld + d] = kb[j * ks.s + d];
    v_s[j * ld + d] = vb[j * vs.s + d];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* q_w = q_s + warp * kMaxHeadDim;
  float* p_w = p_s + warp * kMaxResident;
  const float* qb = q + b * qs.b + h * qs.h;
  float* ob = o + b * os.b + h * os.h;

  for (int r = r0 + warp; r < r_end; r += kWarps) {
    for (int d = lane; d < Dh; d += 32) q_w[d] = qb[r * qs.s + d] * scale;
    __syncwarp();
    const int nk = causal ? r + 1 : S;   // keys >= S (and > r if causal) masked

    float s[kKeysPerLane];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      float acc = -CUDART_INF_F;
      if (j < nk) {
        const float* kr = k_s + j * ld;
        acc = 0.f;
        for (int d = 0; d < Dh; ++d) acc = fmaf(q_w[d], kr[d], acc);
      }
      s[t] = acc;
      m = fmaxf(m, acc);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      s[t] = (lane + 32 * t < nk) ? expf(s[t] - m) : 0.f;
      sum += s[t];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < nk) p_w[j] = s[t] / sum;
    }
    __syncwarp();

    float acc[kDimsPerLane];
#pragma unroll
    for (int u = 0; u < kDimsPerLane; ++u) acc[u] = 0.f;
    for (int j = 0; j < nk; ++j) {
      const float p = p_w[j];
      const float* vr = v_s + j * ld;
#pragma unroll
      for (int u = 0; u < kDimsPerLane; ++u) {
        const int d = lane + 32 * u;
        if (d < Dh) acc[u] = fmaf(p, vr[d], acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kDimsPerLane; ++u) {
      const int d = lane + 32 * u;
      if (d < Dh) ob[r * os.s + d] = acc[u];
    }
    __syncwarp();   // q_w / p_w are rewritten by the warp's next row
  }
}

// --- streaming f32 kernel --------------------------------------------------

constexpr int kF32Chunk = 128;               // keys a stage: 4 a lane
constexpr int kF32ChunkPerLane = kF32Chunk / 32;
constexpr int kRowsPerWarp = kQueryTile / kWarps;

size_t f32_stream_smem_bytes(int dh) {
  // K and V chunks, the block's q rows (scaled), each warp's P row
  return (2 * static_cast<size_t>(kF32Chunk) * f32_pitch(dh) +
          static_cast<size_t>(kQueryTile) * dh + kWarps * kF32Chunk) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
attention_f32_stream(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int H, int S,
                     int Dh, Strides qs, Strides ks, Strides vs, Strides os, int causal,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = f32_pitch(Dh);
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + static_cast<size_t>(kF32Chunk) * ld;
  float* q_s = v_s + static_cast<size_t>(kF32Chunk) * ld;
  float* p_s = q_s + static_cast<size_t>(kQueryTile) * Dh;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int r0 = blockIdx.y * kQueryTile;
  const int r_end = min(S, r0 + kQueryTile);
  const int n_keys = causal ? r_end : S;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* qb = q + b * qs.b + h * qs.h;
  float* ob = o + b * os.b + h * os.h;
  for (int e = threadIdx.x; e < (r_end - r0) * Dh; e += kThreads) {
    const int i = e / Dh, d = e - i * Dh;
    q_s[i * Dh + d] = qb[(r0 + i) * qs.s + d] * scale;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p_w = p_s + warp * kF32Chunk;
  // row r0 + warp + kWarps * i of the tile is this warp's i-th
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < kDimsPerLane; ++u) acc[i][u] = 0.f;
  }

  for (int pass = 0; pass < 2; ++pass) {
    for (int j0 = 0; j0 < n_keys; j0 += kF32Chunk) {
      const int n = min(kF32Chunk, n_keys - j0);
      __syncthreads();                           // the previous chunk is done
      for (int e = threadIdx.x; e < n * Dh; e += kThreads) {
        const int j = e / Dh, d = e - j * Dh;
        k_s[j * ld + d] = kb[(j0 + j) * ks.s + d];
        if (pass) v_s[j * ld + d] = vb[(j0 + j) * vs.s + d];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = r0 + warp + kWarps * i;
        if (r >= r_end) break;                   // warp-uniform
        const int nk = (causal ? r + 1 : S) - j0;    // live keys of the chunk
        if (nk <= 0) continue;
        const float* q_r = q_s + (r - r0) * Dh;
        float s[kF32ChunkPerLane];
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int t = 0; t < kF32ChunkPerLane; ++t) {
          const int j = lane + 32 * t;
          float a = -CUDART_INF_F;
          if (j < n && j < nk) {
            const float* kr = k_s + j * ld;
            a = 0.f;
            for (int d = 0; d < Dh; ++d) a = fmaf(q_r[d], kr[d], a);
          }
          s[t] = a;
          mx = fmaxf(mx, a);
        }
        if (pass == 0) {
          mx = fmaxf(m[i], warp_max(mx));
          float sum = 0.f;
#pragma unroll
          for (int t = 0; t < kF32ChunkPerLane; ++t)
            sum += s[t] == -CUDART_INF_F ? 0.f : expf(s[t] - mx);
          l[i] = (m[i] == -CUDART_INF_F ? 0.f : l[i] * expf(m[i] - mx)) + warp_sum(sum);
          m[i] = mx;
          continue;
        }
#pragma unroll
        for (int t = 0; t < kF32ChunkPerLane; ++t) {
          const int j = lane + 32 * t;
          if (j < n) p_w[j] = s[t] == -CUDART_INF_F ? 0.f : expf(s[t] - m[i]) / l[i];
        }
        __syncwarp();
        const int live = min(n, nk);
        for (int j = 0; j < live; ++j) {
          const float p = p_w[j];
          const float* vr = v_s + j * ld;
#pragma unroll
          for (int u = 0; u < kDimsPerLane; ++u) {
            const int d = lane + 32 * u;
            if (d < Dh) acc[i][u] = fmaf(p, vr[d], acc[i][u]);
          }
        }
        __syncwarp();                            // p_w is rewritten by the next row
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + warp + kWarps * i;
    if (r >= r_end) break;
#pragma unroll
    for (int u = 0; u < kDimsPerLane; ++u) {
      const int d = lane + 32 * u;
      if (d < Dh) ob[r * os.s + d] = acc[i][u];
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H,
               int S, int Dh, Strides qs, Strides ks, Strides vs, Strides os,
               int causal, float scale, cudaStream_t stream) {
  const bool resident = S <= kMaxResident && f32_smem_bytes(S, Dh) <= kMaxSmem;
  const void* kernel = resident ? reinterpret_cast<const void*>(attention_f32)
                                : reinterpret_cast<const void*>(attention_f32_stream);
  static int smem_set[2][64];
  cudaError_t err = allow_smem(kernel, kMaxSmem, smem_set[resident ? 0 : 1]);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (S + kQueryTile - 1) / kQueryTile);
  const float* args[3] = {static_cast<const float*>(q), static_cast<const float*>(k),
                          static_cast<const float*>(v)};
  if (resident)
    attention_f32<<<grid, kThreads, f32_smem_bytes(S, Dh), stream>>>(
        args[0], args[1], args[2], static_cast<float*>(o), H, S, Dh, qs, ks, vs, os,
        causal, scale);
  else
    attention_f32_stream<<<grid, kThreads, f32_stream_smem_bytes(Dh), stream>>>(
        args[0], args[1], args[2], static_cast<float*>(o), H, S, Dh, qs, ks, vs, os,
        causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int keds_attention_max_head_dim() { return kMaxHeadDim; }
extern "C" int keds_attention_tc_head_dim() { return kTcHeadDim; }

// strides: 12 int64 values, (batch, seq, head) element strides of q, k, v, o.
extern "C" int keds_attention_fwd(const void* q, const void* k, const void* v,
                                  void* o, int dtype, int B, int H, int S,
                                  int Dh, const long long* strides, int causal,
                                  float scale, void* stream) {
  if (S < 1 || B * H < 1) return cudaErrorInvalidValue;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && Dh >= 1 && Dh <= kMaxHeadDim)
    return launch_f32(q, k, v, o, B, H, S, Dh, qs, ks, vs, os, causal, scale, st);
  if (dtype == kBFloat16 && Dh == kTcHeadDim)
    return launch_tc(q, k, v, o, B, H, S, qs, ks, vs, os, causal, scale, st);
  return cudaErrorInvalidValue;
}
