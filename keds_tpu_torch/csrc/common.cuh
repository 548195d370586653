// Shared helpers for the port's CUDA kernels (plain C interface, ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace keds {

constexpr unsigned kFullMask = 0xffffffffu;

// Element types the wrappers pass as an int code.
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// --- Tensor-core building blocks (sm_80+ PTX, used on sm_90a) -------------
//
// mma_bf16: D += A * B for one m16n8k16 tile, bf16 inputs, f32 accumulators.
// Fragments (g = lane / 4, t = lane % 4):
//   A (16x16, row major): a[0] (g, 2t..2t+1), a[1] (g+8, 2t..), a[2] (g, 2t+8..),
//                         a[3] (g+8, 2t+8..)
//   B (16x8, k x n):      b[0] (k 2t..2t+1, n g), b[1] (k 2t+8.., n g)
//   C (16x8):             c[0..1] (g, 2t..2t+1), c[2..3] (g+8, 2t..2t+1)
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and r[i] receives row lane/4, columns 2(lane%4)..+1 of matrix i.
__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// As ldmatrix_x4, each matrix transposed: r[i] receives column lane/4,
// rows 2(lane%4)..+1.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// --- bf16 tiles of head dimension 64 in shared memory ----------------------
//
// Tiles are row major with a row pitch of kPitch elements; a pitch that is an
// odd multiple of 16 bytes puts the 8 rows an ldmatrix reads on distinct
// banks.  Fragments follow mma_bf16's layout.

// A fragment of the 16x16 tile at `tile`.
template <int kPitch>
__device__ __forceinline__ void ldmatrix_a(unsigned (&a)[4], const __nv_bfloat16* tile,
                                           int lane) {
  const int mi = lane / 8;
  ldmatrix_x4(a, tile + ((mi % 2) * 8 + lane % 8) * kPitch + (mi / 2) * 8);
}

// s = A B^T for A (16 x 64, fragments a[k / 16]) and B the 16 x 64 tile at
// `rows`: s[nt] holds the products with rows nt*8 .. nt*8+7 of B.
template <int kPitch>
__device__ __forceinline__ void mma_abt(float (&s)[2][4], const unsigned (&a)[4][4],
                                        const __nv_bfloat16* rows, int lane) {
  const int mi = lane / 8;
  const __nv_bfloat16* row = rows + ((mi / 2) * 8 + lane % 8) * kPitch + (mi % 2) * 8;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    unsigned bf[4];
    ldmatrix_x4(bf, row + ks * 16);
    mma_bf16(s[0], a[ks], bf);
    mma_bf16(s[1], a[ks], bf + 2);
  }
}

// acc += A B for A (16 x 16, fragment a) and B the 16 x 64 tile at `rows`:
// acc[nt] holds columns nt*8 .. nt*8+7.
template <int kPitch>
__device__ __forceinline__ void mma_ab(float (&acc)[8][4], const unsigned (&a)[4],
                                       const __nv_bfloat16* rows, int lane) {
  const int mi = lane / 8;
  const __nv_bfloat16* row = rows + ((mi % 2) * 8 + lane % 8) * kPitch + (mi / 2) * 8;
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    unsigned bf[4];
    ldmatrix_x4_trans(bf, row + np * 16);
    mma_bf16(acc[2 * np], a, bf);
    mma_bf16(acc[2 * np + 1], a, bf + 2);
  }
}

// acc += (A0 + A1) B: mma_ab for two A fragments sharing each B fragment.
template <int kPitch>
__device__ __forceinline__ void mma_ab2(float (&acc)[8][4], const unsigned (&a0)[4],
                                        const unsigned (&a1)[4], const __nv_bfloat16* rows,
                                        int lane) {
  const int mi = lane / 8;
  const __nv_bfloat16* row = rows + ((mi % 2) * 8 + lane % 8) * kPitch + (mi / 2) * 8;
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    unsigned bf[4];
    ldmatrix_x4_trans(bf, row + np * 16);
    mma_bf16(acc[2 * np], a0, bf);
    mma_bf16(acc[2 * np + 1], a0, bf + 2);
    mma_bf16(acc[2 * np], a1, bf);
    mma_bf16(acc[2 * np + 1], a1, bf + 2);
  }
}

// 16-byte global -> shared copy that bypasses L1; zero-fills when !valid
// (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Two floats rounded to bf16 (nearest even) and packed, lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Raise a kernel's dynamic shared-memory limit to `bytes` on the current
// device, once: later calls (for instance inside a CUDA graph capture, where
// the call would be refused) find it done.  `done` is the caller's per-device
// record for that kernel.
inline cudaError_t allow_smem(const void* kernel, int bytes, int (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = bytes;
  return err;
}

}  // namespace keds

extern "C" const char* keds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
