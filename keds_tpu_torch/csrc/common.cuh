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

// 4-byte global -> shared copy (rows that are not 16-byte aligned);
// zero-fills when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

// --- f32 products on tensor cores, in three TF32 terms -----------------------
//
// x = hi + lo with hi = x rounded to TF32 (10 mantissa bits) and lo the
// remainder, which the tensor core truncates to TF32: hi + lo keeps about 21
// bits of x.  A product
// a b is taken as a_hi b_hi + a_hi b_lo + a_lo b_hi (the dropped a_lo b_lo
// is below 2^-22 of |a b|), each term an exact TF32 product accumulated in
// f32: about f32's accuracy, where one TF32 product keeps 11 bits.
//
// mma.sync m16n8k8 tf32 fragments (g = lane / 4, t = lane % 4):
//   A (16x8, row major): a[0] (g, t), a[1] (g+8, t), a[2] (g, t+4), a[3] (g+8, t+4)
//   B (8x8, k x n):      b[0] (k t, n g), b[1] (k t+4, n g)
//   C (16x8):            c[0..1] (g, 2t..2t+1), c[2..3] (g+8, 2t..2t+1)
// A C tile becomes the A operand of the next product with no exchange if the
// contraction's 8 indices are taken in the order 0, 2, 4, 6, 1, 3, 5, 7:
// a = {c[0], c[2], c[1], c[3]}, and B's rows k = t and t+4 are then 2t and
// 2t+1.

// hi rounded to nearest (ties away) with integer operations, which issue
// faster than cvt.rna.tf32; lo = x - hi is exact, and the tensor core reads
// its top 19 bits (rounding it too cost the backward 30-50 %).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float* c, const unsigned* a, const unsigned* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[j] += a b[j] for the N products with j < live (warp-uniform), in three
// TF32 terms, the small ones first; each term is issued across the N
// accumulators before the next, so that no product waits on the one before.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (*c)[4], const unsigned (&ah)[4],
                                           const unsigned (&al)[4], const unsigned (&bh)[N][2],
                                           const unsigned (&bl)[N][2], int live) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < live) mma_tf32(c[j], al, bh[j]);
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < live) mma_tf32(c[j], ah, bl[j]);
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < live) mma_tf32(c[j], ah, bh[j]);
}

// c_hi[j] += a_hi b_hi[j] and c_lo[j] += a_hi b_lo[j] + a_lo b_hi[j]: the
// small terms summed apart from the large, so that the tensor core's
// rounding of its sums toward zero acts on each at its own scale.
template <int N>
__device__ __forceinline__ void mma_3xtf32_apart(float (*c_hi)[4], float (*c_lo)[4],
                                                 const unsigned (&ah)[4], const unsigned (&al)[4],
                                                 const unsigned (&bh)[N][2],
                                                 const unsigned (&bl)[N][2], int live) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < live) mma_tf32(c_lo[j], al, bh[j]);
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < live) mma_tf32(c_hi[j], ah, bh[j]);
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < live) mma_tf32(c_lo[j], ah, bl[j]);
}

// The A operand of a C tile (see above), split.
__device__ __forceinline__ void c_to_a(const float (&c)[4], unsigned (&ah)[4], unsigned (&al)[4]) {
  split_tf32(c[0], ah[0], al[0]);
  split_tf32(c[2], ah[1], al[1]);
  split_tf32(c[1], ah[2], al[2]);
  split_tf32(c[3], ah[3], al[3]);
}

// B fragment of an 8 x 8 block of B^T rows (n) by columns (k) in shared
// memory, `rows` at (n 0, k 0) with a row pitch of `pitch` floats: b[0] =
// (n g, k t), b[1] = (n g, k t+4).  Conflict-free for a pitch = 4 mod 32.
__device__ __forceinline__ void b_frag_rows(unsigned (&bh)[2], unsigned (&bl)[2],
                                            const float* rows, int pitch, int g, int t) {
  split_tf32(rows[g * pitch + t], bh[0], bl[0]);
  split_tf32(rows[g * pitch + t + 4], bh[1], bl[1]);
}

// B fragment of an 8 x 8 block of B, rows (k) in shared memory taken in the
// C-to-A order: b[0] = (k 2t, n g), b[1] = (k 2t+1, n g).  Conflict-free for
// a pitch = 4 mod 16.
__device__ __forceinline__ void b_frag_cols(unsigned (&bh)[2], unsigned (&bl)[2],
                                            const float* rows, int pitch, int g, int t) {
  split_tf32(rows[2 * t * pitch + g], bh[0], bl[0]);
  split_tf32(rows[(2 * t + 1) * pitch + g], bh[1], bl[1]);
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

// Streaming multiprocessors of the current device, read once per device.
inline int sm_count() {
  static int count[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 132;
  if (!count[dev] &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    count[dev] = 132;
  return count[dev];
}

// Warps that take one 16-row tile's keys in turn (1, 2 or 4), from the
// tiles of a call: more when the tiles alone give fewer than two warps to
// each of the card's four sub-partitions an SM.
inline int key_splits(long long tiles) {
  const int sms = sm_count();
  return tiles >= 8LL * sms ? 1 : tiles >= 4LL * sms ? 2 : 4;
}

}  // namespace keds

extern "C" const char* keds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
