// Fused self-attention backward for the CLIP text tower on Hopper (sm_90a).
//
// Replaces the gradient of the TPU kernel keds_tpu/ops/attention.py:
// flash_attention, whose custom_vjp backward (_bwd) is the VJP of the plain
// attention_reference.  For each (batch, head) it takes q, k, v and the
// output gradient dO and writes dq, dk and dv:
//
//   P   = softmax(scale * q k^T, keys > row masked when causal)   (f32)
//   dV  = round(P)^T dO        P rounded to v's type, as the forward used it
//   dP  = dO V^T               f32 accumulation
//   D_i = sum_j P_ij dP_ij
//   dS  = P * (dP - D)
//   dQ  = scale * dS K,  dK = scale * dS^T Q
//
// P is recomputed from q and k (nothing is saved by the forward), with the
// forward's numerics: f32 scale on f32 scores, f32 softmax.
//
// What bounds it on the H100: the training shape (128, 12, 8, 64) bf16 moves
// 11 MB (q, k, v, dO read; dq, dk, dv written) for 0.04 GFLOP, so the HBM
// traffic (about 3.3 us) is the floor; the text buckets up to S = 77 stay far
// below the ridge too.  This first version is simple and exact rather than
// fast: one block per (batch, head) (on grid.x, which takes any B*H) stages
// q*scale, k, v and dO in shared memory as f32 and keeps the S x S matrix P,
// later dS, there as well; every product runs on CUDA cores in f32, so the
// bf16 and f32 variants share one template and differ only in the element
// type read and written.  Rows of 65 floats keep lanes that walk a column
// on distinct banks.  S <= 128 at Dh = 64 fits in 199 KB.

#include "common.cuh"

namespace {

using namespace keds;
using bf16 = __nv_bfloat16;

constexpr int kMaxSeq = 128;
constexpr int kHeadDim = 64;
constexpr int kPitch = kHeadDim + 1;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeysPerLane = kMaxSeq / 32;

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

size_t smem_bytes(int S) {
  return (4 * static_cast<size_t>(S) * kPitch + static_cast<size_t>(S) * S) * sizeof(float);
}

template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, Strides st, int b, int h,
                                      int S, float mul) {
  const T* base = src + b * st.b + h * st.h;
  for (int e = threadIdx.x; e < S * kHeadDim; e += kThreads) {
    const int i = e / kHeadDim, d = e % kHeadDim;
    dst[i * kPitch + d] = to_f(base[i * st.s + d]) * mul;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dk,
              T* __restrict__ dv, int H, int S, Strides qs, Strides ks, Strides vs,
              Strides gs, Strides dqs, Strides dks, Strides dvs, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                  // q * scale
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

  // dV = round(P)^T dO: only rows i >= j see key j when causal
  T* dvb = dv + b * dvs.b + h * dvs.h;
  for (int e = threadIdx.x; e < S * kHeadDim; e += kThreads) {
    const int j = e / kHeadDim, d = e % kHeadDim;
    float acc = 0.f;
    for (int i = causal ? j : 0; i < S; ++i)
      acc = fmaf(to_f(from_f<T>(p_s[i * S + j])), g_s[i * kPitch + d], acc);
    dvb[j * dvs.s + d] = from_f<T>(acc);
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
  T* dqb = dq + b * dqs.b + h * dqs.h;
  T* dkb = dk + b * dks.b + h * dks.h;
  for (int e = threadIdx.x; e < S * kHeadDim; e += kThreads) {
    const int r = e / kHeadDim, d = e % kHeadDim;
    float acc_q = 0.f, acc_k = 0.f;
    const int j_end = causal ? r + 1 : S;
    for (int j = 0; j < j_end; ++j) acc_q = fmaf(p_s[r * S + j], k_s[j * kPitch + d], acc_q);
    for (int i = causal ? r : 0; i < S; ++i)
      acc_k = fmaf(p_s[i * S + r], q_s[i * kPitch + d], acc_k);
    dqb[r * dqs.s + d] = from_f<T>(acc_q * scale);
    dkb[r * dks.s + d] = from_f<T>(acc_k);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout, void* dq,
           void* dk, void* dv, int B, int H, int S, const Strides* st, int causal,
           float scale, cudaStream_t stream) {
  static int smem_set[64];
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(attention_bwd<T>),
                               static_cast<int>(smem_bytes(kMaxSeq)), smem_set);
  if (err != cudaSuccess) return err;
  attention_bwd<T><<<B * H, kThreads, smem_bytes(S), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), H, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6], causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int keds_attention_bwd_max_seq() { return kMaxSeq; }
extern "C" int keds_attention_bwd_head_dim() { return kHeadDim; }

// strides: 21 int64 values, (batch, seq, head) element strides of q, k, v,
// dO, dq, dk, dv in that order; every head dimension has unit stride.
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
    return launch<float>(q, k, v, dout, dq, dk, dv, B, H, S, st, causal, scale, s);
  if (dtype == kBFloat16)
    return launch<bf16>(q, k, v, dout, dq, dk, dv, B, H, S, st, causal, scale, s);
  return cudaErrorInvalidValue;
}
