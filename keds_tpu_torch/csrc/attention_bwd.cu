// Fused self-attention backward for the CLIP text tower on Hopper (sm_90a).
//
// Replaces the gradient of the TPU kernel keds_tpu/ops/attention.py:
// flash_attention, whose custom_vjp backward (_bwd, :134) is the VJP of the
// plain attention_reference.  For each (batch, head) it takes q, k, v and the
// output gradient dO and writes dq, dk and dv:
//
//   P   = softmax(scale * q k^T, keys > row masked when causal)   (f32)
//   dV  = round(P)^T dO        P rounded to v's type, as the forward used it
//   dP  = dO V^T               f32 accumulation, rounded to v's type (the
//                              cotangent of the rounded P, as in the VJP)
//   D_i = sum_j P_ij dP_ij
//   dS  = P * (dP - D)
//   dQ  = scale * dS K,  dK = scale * dS^T Q
//
// P is recomputed from q and k (nothing is saved by the forward), with the
// forward's numerics: f32 scores scaled in f32, f32 softmax.  q, k, v and dO
// are (B, H, S, Dh) views with any (batch, seq, head) strides; dq, dk and dv
// are written once each (no atomics, so two calls agree bit for bit).
//
// attention_bwd_tc (bf16, Dh = 64, S <= 128).  What bounds it on the H100:
// bytes.  It reads q, k, v and dO and writes dq, dk and dv, 7 * B*H*S*Dh * 2
// bytes, against 10 * B*H*pairs*Dh flops: at S <= 128 that is at most 91
// flops a byte, under the card's ridge of about 295.  The design keeps the
// products on tensor cores and every byte on chip once read:
//   * q, k, v and dO of a (batch, head) go to shared memory once, with
//     16-byte cp.async into 144-byte rows (zero past S; q and k first, so
//     that q k^T and the softmax run while v and dO arrive).  Every operand
//     is read from there by ldmatrix, conflict-free.
//   * mma.sync m16n8k16 (bf16 in, f32 accumulate) for every product.
//     wgmma was not used: its 64-row tiles exceed most of these sequences.
//   * Pass A, one warp per 16 query rows: s = q k^T over the live key tiles,
//     held in registers (the key-tile count is a template parameter, so the
//     whole row fits), the row max and sum in f32 (one q k^T, no online
//     rescaling), P; then dP = dO V^T, D by quad shuffles and dS = P * (dP -
//     D) in f32, which enters dQ = scale * dS K from registers as two bf16
//     terms, hi = round(dS) and lo = round(dS - hi): one bf16 term loses
//     the tolerance where a row's softmax is nearly one-hot.  Each row's
//     max, 1 / l (0 for rows >= S) and D go to shared memory.
//   * Pass B, one warp per 16 key rows, over the query tiles at or below
//     the diagonal when causal: P^T = exp(k q^T - m) / l and dP^T = V dO^T
//     are recomputed in registers from those statistics (two more products
//     a tile pair), and dV = round(P)^T dO and dK = scale * (hi + lo)^T q
//     take them as A fragments.  Storing round(P) and dS's two terms as S x S
//     bf16 tiles instead takes 88 KB a block at S = 77 (two blocks an SM)
//     and measured 2-4 % slower than recomputing them at 47 KB and at most
//     128 registers (three blocks an SM; kernel_sweeps.py attention_bwd).
//     Warp w takes query tile w in pass A (w + 1 key tiles when causal) and
//     key tile w in pass B (n - w query tiles): every warp does the same
//     work in all, though the barrier between the passes waits for the
//     longest of each.
//   * S <= 16: one block takes kSmallSlices (batch, head) slices, one warp
//     each, as the Pallas kernel groups heads per program; otherwise one
//     block per (batch, head) with one warp per 16-row tile.  The plan is
//     exported (keds_attention_bwd_plan) and mirrored in ops/attention.py.
//   Shared memory: 47 KB a block at S = 77, 74 KB at S = 128.
//
// attention_bwd_f32 (f32, Dh = 64, S <= 128): exact f32 on CUDA cores (a
// tensor-core version would round to TF32).  One block per (batch, head)
// stages q*scale, k, v and dO as f32 rows of 65 floats (conflict-free column
// walks) and the S x S matrix P, later dS, in shared memory (199 KB at
// S = 128); every product is an f32 FMA.  No path runs it today.

#include "common.cuh"

namespace {

using namespace keds;
using bf16 = __nv_bfloat16;

constexpr int kMaxSeq = 128;
constexpr int kHeadDim = 64;

struct Strides {
  long long b, s, h;
};

// --- bf16 tensor-core kernel ----------------------------------------------

constexpr int kTcPitch = kHeadDim + 8;       // 144-byte rows of q, k, v, dO
constexpr int kSmallSlices = 4;              // (batch, head) slices a block at S <= 16

// q, k, v and dO of one (batch, head), and three f32 statistics a row.
__host__ __device__ constexpr int tc_slice_bytes(int key_tiles) {
  return 16 * key_tiles * (4 * kTcPitch * static_cast<int>(sizeof(bf16)) +
                           3 * static_cast<int>(sizeof(float)));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Plan {
  int key_tiles, slices, warps, smem_bytes;
};

Plan tc_plan(int S) {
  const int n = (S + 15) / 16;
  const int slices = n == 1 ? kSmallSlices : 1;
  return Plan{n, slices, n == 1 ? kSmallSlices : n, slices * tc_slice_bytes(n)};
}

// Blocks an SM that the register budget must allow (shared memory allows
// four at S <= 80); past 6 key tiles pass A's rows of scores need more.
__host__ __device__ constexpr int tc_min_blocks(int key_tiles) {
  return key_tiles == 1 ? 4 : key_tiles <= 5 ? 3 : key_tiles == 6 ? 2 : 1;
}

template <int NKB>
__global__ void __launch_bounds__(32 * (NKB == 1 ? kSmallSlices : NKB), tc_min_blocks(NKB))
attention_bwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                 int BH, int H, int S, Strides qs, Strides ks, Strides vs, Strides gs,
                 Strides dqs, Strides dks, Strides dvs, int causal, float scale) {
  constexpr int kRows = 16 * NKB;            // staged rows per tensor, zero past S
  constexpr int kSlices = NKB == 1 ? kSmallSlices : 1;
  extern __shared__ __align__(16) unsigned char smem[];

  const bf16* const src[4] = {q, k, v, dout};
  const Strides sst[4] = {qs, ks, vs, gs};
#pragma unroll
  for (int tn = 0; tn < 4; ++tn) {
    for (int e = threadIdx.x; e < kSlices * kRows * 8; e += blockDim.x) {
      const int sl = e / (kRows * 8), j = (e / 8) % kRows, c = (e % 8) * 8;
      const int bh = blockIdx.x * kSlices + sl;
      const bool in = j < S && bh < BH;
      const int b = in ? bh / H : 0, h = in ? bh % H : 0;
      bf16* dst = reinterpret_cast<bf16*>(smem + sl * tc_slice_bytes(NKB)) +
                  (tn * kRows + j) * kTcPitch + c;
      cp_async16(dst, src[tn] + b * sst[tn].b + h * sst[tn].h + (in ? j : 0) * sst[tn].s + c,
                 in);
    }
    if (tn % 2) cp_async_commit();           // q and k, then v and dO
  }
  cp_async_wait<1>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int sl = NKB == 1 ? warp : 0;
  const int tile = NKB == 1 ? 0 : warp;       // query tile in pass A, key tile in pass B
  const int bh = blockIdx.x * kSlices + sl;
  const bool live = bh < BH;
  const int b = live ? bh / H : 0, h = live ? bh % H : 0;
  const bf16* q_s = reinterpret_cast<const bf16*>(smem + sl * tc_slice_bytes(NKB));
  const bf16* k_s = q_s + kRows * kTcPitch;
  const bf16* v_s = k_s + kRows * kTcPitch;
  const bf16* g_s = v_s + kRows * kTcPitch;
  // each query row's m * scale * log2(e), 1 / l (0 past S) and D
  float* mc_s = reinterpret_cast<float*>(const_cast<bf16*>(g_s + kRows * kTcPitch));
  float* il_s = mc_s + kRows;
  float* d_s = il_s + kRows;

  // --- pass A: the warp's 16 query rows ---
  {
    const int r0 = tile * 16;
    const int ra = r0 + g, rb = ra + 8;       // this thread's two rows
    const int n_live = causal ? tile + 1 : NKB;
    // keys < lim are live for a row; a key tile below every row's lim needs no mask
    const int lim_a = causal ? min(S, ra + 1) : S;
    const int lim_b = causal ? min(S, rb + 1) : S;
    const int lim_warp = causal ? min(S, r0 + 1) : S;
    const float c = scale * 1.4426950408889634f;

    unsigned af[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldmatrix_a<kTcPitch>(af[kk], q_s + r0 * kTcPitch + kk * 16, lane);
    float s[NKB][2][4];
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int kb = 0; kb < NKB; ++kb) {
      if (kb >= n_live) continue;
      mma_abt<kTcPitch>(s[kb], af, k_s + kb * 16 * kTcPitch, lane);
      const bool masked = (kb + 1) * 16 > lim_warp;     // warp-uniform
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (masked && kb * 16 + nt * 8 + 2 * t + (e % 2) >= (e < 2 ? lim_a : lim_b))
            s[kb][nt][e] = -CUDART_INF_F;
          m[e / 2] = fmaxf(m[e / 2], s[kb][nt][e]);
        }
    }
    // every row has a live key (key 0), so m is finite after the quad's max
    float mc[2], l[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      m[half] = fmaxf(m[half], __shfl_xor_sync(kFullMask, m[half], 1));
      m[half] = fmaxf(m[half], __shfl_xor_sync(kFullMask, m[half], 2));
      mc[half] = m[half] * c;
    }
#pragma unroll
    for (int kb = 0; kb < NKB; ++kb) {
      if (kb >= n_live) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[kb][nt][e] = exp2f(fmaf(s[kb][nt][e], c, -mc[e / 2]));
          l[e / 2] += s[kb][nt][e];
        }
    }
    float inv_l[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      l[half] += __shfl_xor_sync(kFullMask, l[half], 1);
      l[half] += __shfl_xor_sync(kFullMask, l[half], 2);
      inv_l[half] = (half ? rb : ra) < S ? 1.f / l[half] : 0.f;   // rows >= S: P = 0
    }
#pragma unroll
    for (int kb = 0; kb < NKB; ++kb) {
      if (kb >= n_live) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[kb][nt][e] *= inv_l[e / 2];     // P
    }

    // dP = dO V^T rounded to bf16, and D = rowsum(P * dP)
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldmatrix_a<kTcPitch>(af[kk], g_s + r0 * kTcPitch + kk * 16, lane);
    float dp[NKB][2][4];
    float dsum[2] = {0.f, 0.f};
#pragma unroll
    for (int kb = 0; kb < NKB; ++kb) {
      if (kb >= n_live) continue;
      mma_abt<kTcPitch>(dp[kb], af, v_s + kb * 16 * kTcPitch, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp[kb][nt][e] = round_bf16(dp[kb][nt][e]);
          dsum[e / 2] = fmaf(s[kb][nt][e], dp[kb][nt][e], dsum[e / 2]);
        }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      dsum[half] += __shfl_xor_sync(kFullMask, dsum[half], 1);
      dsum[half] += __shfl_xor_sync(kFullMask, dsum[half], 2);
      if (t == 0) {
        const int r = half ? rb : ra;
        mc_s[r] = mc[half];
        il_s[r] = inv_l[half];
        d_s[r] = dsum[half];
      }
    }

    // dS = P * (dP - D) as hi + lo in bf16; dQ = scale * dS K
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < NKB; ++kb) {
      if (kb >= n_live) continue;
      float hi[2][4], lo[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = s[kb][nt][e] * (dp[kb][nt][e] - dsum[e / 2]);
          hi[nt][e] = round_bf16(d);
          lo[nt][e] = d - hi[nt][e];
        }
      const unsigned ha[4] = {pack_bf16(hi[0][0], hi[0][1]), pack_bf16(hi[0][2], hi[0][3]),
                              pack_bf16(hi[1][0], hi[1][1]), pack_bf16(hi[1][2], hi[1][3])};
      const unsigned la[4] = {pack_bf16(lo[0][0], lo[0][1]), pack_bf16(lo[0][2], lo[0][3]),
                              pack_bf16(lo[1][0], lo[1][1]), pack_bf16(lo[1][2], lo[1][3])};
      mma_ab2<kTcPitch>(acc, ha, la, k_s + kb * 16 * kTcPitch, lane);
    }
    bf16* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int d = nt * 8 + 2 * t;
      if (live && ra < S)
        *reinterpret_cast<unsigned*>(dqb + ra * dqs.s + d) =
            pack_bf16(acc[nt][0] * scale, acc[nt][1] * scale);
      if (live && rb < S)
        *reinterpret_cast<unsigned*>(dqb + rb * dqs.s + d) =
            pack_bf16(acc[nt][2] * scale, acc[nt][3] * scale);
    }
  }
  __syncthreads();

  // --- pass B: the warp's 16 key rows ---
  {
    const int c0 = tile * 16;
    const int ja = c0 + g, jb = ja + 8;       // this thread's two keys
    const float c = scale * 1.4426950408889634f;
    float av[8][4], ak[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) av[nt][e] = ak[nt][e] = 0.f;
    for (int qt = causal ? tile : 0; qt < NKB; ++qt) {
      // P^T and dP^T of keys c0.. x queries qt*16 + nt*8 + 2t (+1), as pass A
      // made them; keys >= S give rows that are never stored
      float st[2][4], dpt[2][4];
      {
        unsigned af[4][4];       // reloaded each tile: fewer live registers
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) ldmatrix_a<kTcPitch>(af[kk], k_s + c0 * kTcPitch + kk * 16, lane);
        mma_abt<kTcPitch>(st, af, q_s + qt * 16 * kTcPitch, lane);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) ldmatrix_a<kTcPitch>(af[kk], v_s + c0 * kTcPitch + kk * 16, lane);
        mma_abt<kTcPitch>(dpt, af, g_s + qt * 16 * kTcPitch, lane);
      }
      const bool diag = causal && qt == tile;
      float p[2][4], hi[2][4], lo[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int i = qt * 16 + nt * 8 + 2 * t;
        const float2 mc = *reinterpret_cast<const float2*>(mc_s + i);
        const float2 il = *reinterpret_cast<const float2*>(il_s + i);
        const float2 dd = *reinterpret_cast<const float2*>(d_s + i);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool odd = e % 2;
          float pv = exp2f(fmaf(st[nt][e], c, -(odd ? mc.y : mc.x))) * (odd ? il.y : il.x);
          if (diag && (e < 2 ? ja : jb) > i + odd) pv = 0.f;
          const float d = pv * (round_bf16(dpt[nt][e]) - (odd ? dd.y : dd.x));
          p[nt][e] = pv;
          hi[nt][e] = round_bf16(d);
          lo[nt][e] = d - hi[nt][e];
        }
      }
      const unsigned pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
      const unsigned ha[4] = {pack_bf16(hi[0][0], hi[0][1]), pack_bf16(hi[0][2], hi[0][3]),
                              pack_bf16(hi[1][0], hi[1][1]), pack_bf16(hi[1][2], hi[1][3])};
      const unsigned la[4] = {pack_bf16(lo[0][0], lo[0][1]), pack_bf16(lo[0][2], lo[0][3]),
                              pack_bf16(lo[1][0], lo[1][1]), pack_bf16(lo[1][2], lo[1][3])};
      mma_ab<kTcPitch>(av, pa, g_s + qt * 16 * kTcPitch, lane);
      mma_ab2<kTcPitch>(ak, ha, la, q_s + qt * 16 * kTcPitch, lane);
    }
    bf16* dvb = dv + b * dvs.b + h * dvs.h;
    bf16* dkb = dk + b * dks.b + h * dks.h;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int d = nt * 8 + 2 * t;
      if (live && ja < S) {
        *reinterpret_cast<unsigned*>(dvb + ja * dvs.s + d) = pack_bf16(av[nt][0], av[nt][1]);
        *reinterpret_cast<unsigned*>(dkb + ja * dks.s + d) =
            pack_bf16(ak[nt][0] * scale, ak[nt][1] * scale);
      }
      if (live && jb < S) {
        *reinterpret_cast<unsigned*>(dvb + jb * dvs.s + d) = pack_bf16(av[nt][2], av[nt][3]);
        *reinterpret_cast<unsigned*>(dkb + jb * dks.s + d) =
            pack_bf16(ak[nt][2] * scale, ak[nt][3] * scale);
      }
    }
  }
}

template <int NKB>
int launch_tc(const void* q, const void* k, const void* v, const void* dout, void* dq,
              void* dk, void* dv, int BH, int H, int S, const Strides* st, int causal,
              float scale, cudaStream_t stream) {
  static int smem_set[64];
  const Plan p = tc_plan(16 * NKB);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(attention_bwd_tc<NKB>),
                               p.smem_bytes, smem_set);
  if (err != cudaSuccess) return err;
  attention_bwd_tc<NKB><<<(BH + p.slices - 1) / p.slices, 32 * p.warps, p.smem_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), BH, H, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      causal, scale);
  return cudaGetLastError();
}

// --- f32 CUDA-core kernel -------------------------------------------------

constexpr int kPitch = kHeadDim + 1;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeysPerLane = kMaxSeq / 32;

size_t f32_smem_bytes(int S) {
  return (4 * static_cast<size_t>(S) * kPitch + static_cast<size_t>(S) * S) * sizeof(float);
}

__device__ __forceinline__ void stage(float* dst, const float* src, Strides st, int b, int h,
                                      int S, float mul) {
  const float* base = src + b * st.b + h * st.h;
  for (int e = threadIdx.x; e < S * kHeadDim; e += kThreads) {
    const int i = e / kHeadDim, d = e % kHeadDim;
    dst[i * kPitch + d] = base[i * st.s + d] * mul;
  }
}

__global__ void __launch_bounds__(kThreads)
attention_bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                  int H, int S, Strides qs, Strides ks, Strides vs, Strides gs, Strides dqs,
                  Strides dks, Strides dvs, int causal, float scale) {
  extern __shared__ __align__(16) float smem_f[];
  float* q_s = smem_f;                // q * scale
  float* k_s = q_s + S * kPitch;
  float* v_s = k_s + S * kPitch;
  float* g_s = v_s + S * kPitch;      // dO
  float* p_s = g_s + S * kPitch;      // (S, S): P, then dS
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  stage(q_s, q, qs, b, h, S, scale);
  stage(k_s, k, ks, b, h, S, 1.f);
  stage(v_s, v, vs, b, h, S, 1.f);
  stage(g_s, dout, gs, b, h, S, 1.f);
  __syncthreads();

  // scores; keys past the row are -inf when causal
  for (int e = threadIdx.x; e < S * S; e += kThreads) {
    const int i = e / S, j = e % S;
    float acc = -CUDART_INF_F;
    if (!causal || j <= i) {
      const float* qr = q_s + i * kPitch;
      const float* kr = k_s + j * kPitch;
      acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < kHeadDim; ++d) acc = fmaf(qr[d], kr[d], acc);
    }
    p_s[e] = acc;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // row softmax, one warp per row
  for (int i = warp; i < S; i += kWarps) {
    float* row = p_s + i * S;
    float s[kKeysPerLane];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      s[t] = j < S ? row[j] : -CUDART_INF_F;
      m = fmaxf(m, s[t]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      s[t] = s[t] == -CUDART_INF_F ? 0.f : expf(s[t] - m);
      sum += s[t];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < S) row[j] = s[t] / sum;
    }
  }
  __syncthreads();

  // dV = P^T dO: only rows i >= j see key j when causal
  float* dvb = dv + b * dvs.b + h * dvs.h;
  for (int e = threadIdx.x; e < S * kHeadDim; e += kThreads) {
    const int j = e / kHeadDim, d = e % kHeadDim;
    float acc = 0.f;
    for (int i = causal ? j : 0; i < S; ++i) acc = fmaf(p_s[i * S + j], g_s[i * kPitch + d], acc);
    dvb[j * dvs.s + d] = acc;
  }
  __syncthreads();

  // dP = dO V^T, D = rowsum(P * dP), dS = P * (dP - D), written over P
  for (int i = warp; i < S; i += kWarps) {
    float* row = p_s + i * S;
    const float* gr = g_s + i * kPitch;
    float p[kKeysPerLane], dp[kKeysPerLane];
    float dsum = 0.f;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      p[t] = 0.f;
      dp[t] = 0.f;
      if (j < S && (!causal || j <= i)) {
        const float* vr = v_s + j * kPitch;
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < kHeadDim; ++d) acc = fmaf(gr[d], vr[d], acc);
        p[t] = row[j];
        dp[t] = acc;
        dsum = fmaf(p[t], acc, dsum);
      }
    }
    dsum = warp_sum(dsum);
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < S) row[j] = p[t] * (dp[t] - dsum);
    }
  }
  __syncthreads();

  // dQ = scale * dS K (keys j <= i when causal); dK = dS^T (q * scale)
  float* dqb = dq + b * dqs.b + h * dqs.h;
  float* dkb = dk + b * dks.b + h * dks.h;
  for (int e = threadIdx.x; e < S * kHeadDim; e += kThreads) {
    const int r = e / kHeadDim, d = e % kHeadDim;
    float acc_q = 0.f, acc_k = 0.f;
    const int j_end = causal ? r + 1 : S;
    for (int j = 0; j < j_end; ++j) acc_q = fmaf(p_s[r * S + j], k_s[j * kPitch + d], acc_q);
    for (int i = causal ? r : 0; i < S; ++i)
      acc_k = fmaf(p_s[i * S + r], q_s[i * kPitch + d], acc_k);
    dqb[r * dqs.s + d] = acc_q * scale;
    dkb[r * dks.s + d] = acc_k;
  }
}

int launch_f32(const void* q, const void* k, const void* v, const void* dout, void* dq,
               void* dk, void* dv, int BH, int H, int S, const Strides* st, int causal,
               float scale, cudaStream_t stream) {
  static int smem_set[64];
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(attention_bwd_f32),
                               static_cast<int>(f32_smem_bytes(kMaxSeq)), smem_set);
  if (err != cudaSuccess) return err;
  attention_bwd_f32<<<BH, kThreads, f32_smem_bytes(S), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), H, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6], causal,
      scale);
  return cudaGetLastError();
}

using Launch = int (*)(const void*, const void*, const void*, const void*, void*, void*,
                       void*, int, int, int, const Strides*, int, float, cudaStream_t);
constexpr Launch kTcLaunch[kMaxSeq / 16] = {launch_tc<1>, launch_tc<2>, launch_tc<3>,
                                            launch_tc<4>, launch_tc<5>, launch_tc<6>,
                                            launch_tc<7>, launch_tc<8>};

}  // namespace

extern "C" int keds_attention_bwd_max_seq() { return kMaxSeq; }
extern "C" int keds_attention_bwd_head_dim() { return kHeadDim; }

// The bf16 kernel's launch plan at sequence length S: out[0..3] = 16-row
// tiles, (batch, head) slices a block, warps a block, dynamic shared bytes.
extern "C" int keds_attention_bwd_plan(int S, int* out) {
  if (S < 1 || S > kMaxSeq) return cudaErrorInvalidValue;
  const Plan p = tc_plan(S);
  out[0] = p.key_tiles;
  out[1] = p.slices;
  out[2] = p.warps;
  out[3] = p.smem_bytes;
  return cudaSuccess;
}

// strides: 21 int64 values, (batch, seq, head) element strides of q, k, v,
// dO, dq, dk, dv in that order; every head dimension has unit stride.  The
// bf16 kernel also needs 16-byte aligned rows of q, k, v and dO.
extern "C" int keds_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, void* dq, void* dk, void* dv,
                                  int dtype, int B, int H, int S, int Dh,
                                  const long long* strides, int causal, float scale,
                                  void* stream) {
  if (S < 1 || S > kMaxSeq || Dh != kHeadDim || B * H < 1) return cudaErrorInvalidValue;
  Strides st[7];
  for (int t = 0; t < 7; ++t)
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_f32(q, k, v, dout, dq, dk, dv, B * H, H, S, st, causal, scale, s);
  if (dtype == kBFloat16)
    return kTcLaunch[(S - 1) / 16](q, k, v, dout, dq, dk, dv, B * H, H, S, st, causal, scale, s);
  return cudaErrorInvalidValue;
}
