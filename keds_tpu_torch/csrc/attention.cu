// Fused self-attention forward for the CLIP towers on Hopper (sm_90a).
//
// Replaces the TPU kernel keds_tpu/ops/attention.py:flash_attention (Pallas
// body _kernel, pallas_call in _flash_forward).  Computes, for each
// (batch, head), softmax(q k^T / sqrt(Dh), optionally causal) v over a short
// sequence (S <= 288: 257 vision tokens, up to 77 text tokens).  Numerics
// follow the Pallas kernel: scores and softmax are f32, probabilities are
// normalised and then rounded to v's type, P.V accumulates in f32 and the
// output is written in q's type.  Keys >= S, and keys > row when causal,
// are masked, so nothing is padded on the host.
//
// Layout: q, k, v and o are (B, H, S, Dh) tensors with arbitrary batch,
// sequence and head strides (unit stride over Dh), so the strided views of
// the fused qkv projection's (B, S, 3, H, Dh) output are read in place and
// the context is written straight into (B, S, H, Dh) order.
//
// Two kernels, chosen by dtype; neither falls back to the other.
//
// attention_tc (bf16, Dh = 64).  What bounds it on the H100: at the vision
// chunk (16, 16, 257, 64) the function moves 34 MB and does 4.3 GFLOP,
// about 128 flop per byte against the card's ridge of about 295, so the
// floor is the HBM read (10 us).  The design keeps the products on tensor
// cores and every byte on chip once read:
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
// attention_f32 (f32, Dh <= 128): exact f32 on CUDA cores (a tensor-core
// version would round to TF32).  One warp per query row, scores in
// registers, K and V staged in shared memory.  It serves the f32 engine;
// the bf16 main path never runs it.

#include "common.cuh"

namespace {

using namespace keds;
using bf16 = __nv_bfloat16;

constexpr int kMaxSeq = 288;                 // 9 keys per lane in attention_f32

struct Strides {
  long long b, s, h;
};

// --- bf16 tensor-core kernel ----------------------------------------------

constexpr int kTcHeadDim = 64;
constexpr int kTcPitch = kTcHeadDim + 8;     // 144-byte smem rows
constexpr int kTcMaxWarps = 9;
constexpr int kTcRows = 16;                  // query rows per warp tile

__host__ __device__ constexpr int tc_key_rows(int n_keys) { return (n_keys + 15) & ~15; }

size_t tc_smem_bytes(int n_keys) {
  return 2 * static_cast<size_t>(tc_key_rows(n_keys)) * kTcPitch * sizeof(bf16);
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
    {
      const unsigned* qa = reinterpret_cast<const unsigned*>(qb + ra * qs.s);
      const unsigned* qr = reinterpret_cast<const unsigned*>(qb + rb * qs.s);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        qf[kk][0] = ra < S ? __ldg(qa + kk * 8 + t) : 0u;
        qf[kk][1] = rb < S ? __ldg(qr + kk * 8 + t) : 0u;
        qf[kk][2] = ra < S ? __ldg(qa + kk * 8 + 4 + t) : 0u;
        qf[kk][3] = rb < S ? __ldg(qr + kk * 8 + 4 + t) : 0u;
      }
    }
    // keys < lim are live for the row; rows >= S are computed, never stored.
    // A key tile whose keys are all below every row's lim needs no mask.
    const int lim_a = causal ? min(S, ra + 1) : S;
    const int lim_b = causal ? min(S, rb + 1) : S;
    const int lim_warp = causal ? min(S, r0 + 1) : S;
    const int n_kb = ((causal ? min(S, r0 + kTcRows) : S) + 15) / 16;
    const float c = scale_log2e;

    // Pass 1: each row's max m of the raw scores and its sum
    // l = sum exp2(c * (s - m)), c = scale * log2(e), rescaled as m grows.
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
#pragma unroll 2
    for (int kb = 0; kb < n_kb; ++kb) {
      float s[2][4];
      mma_abt<kTcPitch>(s, qf, k_s + kb * 16 * kTcPitch, lane);   // keys kb*16..
      const bool masked = (kb + 1) * 16 > lim_warp;     // warp-uniform
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          v[u] = s[u / 2][2 * half + u % 2];
          if (masked && kb * 16 + (u / 2) * 8 + 2 * t + (u % 2) >= (half ? lim_b : lim_a))
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
    // combine the four threads of a quad (they hold the same rows)
    float mc[2], inv_l[2];
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

    // Pass 2: P = exp2(c * s - c * m) / l rounded to bf16, O += P.V in f32.
    float acc[kTcHeadDim / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTcHeadDim / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll 2
    for (int kb = 0; kb < n_kb; ++kb) {
      float s[2][4];
      mma_abt<kTcPitch>(s, qf, k_s + kb * 16 * kTcPitch, lane);   // keys kb*16..
      const bool masked = (kb + 1) * 16 > lim_warp;     // warp-uniform
      float p[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e / 2;
          p[nt][e] = exp2f(fmaf(s[nt][e], c, -mc[half])) * inv_l[half];
          if (masked && kb * 16 + nt * 8 + 2 * t + (e % 2) >= (half ? lim_b : lim_a))
            p[nt][e] = 0.f;
        }
      const unsigned pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
      mma_ab<kTcPitch>(acc, pa, v_s + kb * 16 * kTcPitch, lane);
    }
#pragma unroll
    for (int nt = 0; nt < kTcHeadDim / 8; ++nt) {
      const int d = nt * 8 + 2 * t;
      if (ra < S)
        *reinterpret_cast<unsigned*>(ob + ra * os.s + d) = pack_bf16(acc[nt][0], acc[nt][1]);
      if (rb < S)
        *reinterpret_cast<unsigned*>(ob + rb * os.s + d) = pack_bf16(acc[nt][2], acc[nt][3]);
    }
  }
}

int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int H,
              int S, Strides qs, Strides ks, Strides vs, Strides os, int causal,
              float scale, cudaStream_t stream) {
  static int smem_set[64];
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(attention_tc),
                               static_cast<int>(tc_smem_bytes(kMaxSeq)), smem_set);
  if (err != cudaSuccess) return err;
  // One block per (batch, head); its warps take the 16-row tiles
  // round-robin, as many warps as make the rounds even.
  const int n_tiles = (S + kTcRows - 1) / kTcRows;
  const int rounds = (n_tiles + kTcMaxWarps - 1) / kTcMaxWarps;
  const int warps = (n_tiles + rounds - 1) / rounds;
  attention_tc<<<B * H, 32 * warps, tc_smem_bytes(S), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, S, qs, ks, vs, os,
      causal, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// --- f32 CUDA-core kernel -------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQueryTile = 64;
constexpr int kKeysPerLane = kMaxSeq / 32;
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
  return f32_kv_bytes(s, dh) + kWarps * (kMaxHeadDim + kMaxSeq) * sizeof(float);
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
  float* p_w = p_s + warp * kMaxSeq;
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

int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H,
               int S, int Dh, Strides qs, Strides ks, Strides vs, Strides os,
               int causal, float scale, cudaStream_t stream) {
  static int smem_set[64];
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(attention_f32),
                               227 * 1024, smem_set);     // the H100's per-block most
  if (err != cudaSuccess) return err;
  const size_t smem = f32_smem_bytes(S, Dh);
  dim3 grid(B * H, (S + kQueryTile - 1) / kQueryTile);
  attention_f32<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, S, Dh, qs, ks, vs,
      os, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int keds_attention_max_seq() { return kMaxSeq; }
extern "C" int keds_attention_max_head_dim() { return kMaxHeadDim; }
extern "C" int keds_attention_tc_head_dim() { return kTcHeadDim; }

// strides: 12 int64 values, (batch, seq, head) element strides of q, k, v, o.
extern "C" int keds_attention_fwd(const void* q, const void* k, const void* v,
                                  void* o, int dtype, int B, int H, int S,
                                  int Dh, const long long* strides, int causal,
                                  float scale, void* stream) {
  if (S < 1 || S > kMaxSeq || B * H < 1) return cudaErrorInvalidValue;
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
