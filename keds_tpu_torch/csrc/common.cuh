// Shared helpers for the port's CUDA kernels (plain C interface, ctypes).
#pragma once

#include <cuda.h>
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

// --- bf16 tiles of head dimension 16 to 64 in shared memory ----------------
//
// Tiles are row major with a row pitch of kPitch elements; a pitch that is an
// odd multiple of 16 bytes puts the 8 rows an ldmatrix reads on distinct
// banks.  Fragments follow mma_bf16's layout.  The head dimension is KS
// 16-column steps (q k^T) or NT 8-column tiles (P V): 64 unless a narrower
// head's kernel names it.

// A fragment of the 16x16 tile at `tile`.
template <int kPitch>
__device__ __forceinline__ void ldmatrix_a(unsigned (&a)[4], const __nv_bfloat16* tile,
                                           int lane) {
  const int mi = lane / 8;
  ldmatrix_x4(a, tile + ((mi % 2) * 8 + lane % 8) * kPitch + (mi / 2) * 8);
}

// s = A B^T for A (16 x 16 KS, fragments a[k / 16]) and B the 16 x 16 KS
// tile at `rows`: s[nt] holds the products with rows nt*8 .. nt*8+7 of B.
template <int kPitch, int KS>
__device__ __forceinline__ void mma_abt(float (&s)[2][4], const unsigned (&a)[KS][4],
                                        const __nv_bfloat16* rows, int lane) {
  const int mi = lane / 8;
  const __nv_bfloat16* row = rows + ((mi / 2) * 8 + lane % 8) * kPitch + (mi % 2) * 8;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    unsigned bf[4];
    ldmatrix_x4(bf, row + ks * 16);
    mma_bf16(s[0], a[ks], bf);
    mma_bf16(s[1], a[ks], bf + 2);
  }
}

// acc += A B for A (16 x 16, fragment a) and B the 16 x 8 NT tile at
// `rows`: acc[nt] holds columns nt*8 .. nt*8+7.
template <int kPitch, int NT>
__device__ __forceinline__ void mma_ab(float (&acc)[NT][4], const unsigned (&a)[4],
                                       const __nv_bfloat16* rows, int lane) {
  const int mi = lane / 8;
  const __nv_bfloat16* row = rows + ((mi % 2) * 8 + lane % 8) * kPitch + (mi / 2) * 8;
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    unsigned bf[4];
    ldmatrix_x4_trans(bf, row + np * 16);
    mma_bf16(acc[2 * np], a, bf);
    mma_bf16(acc[2 * np + 1], a, bf + 2);
  }
}

// acc += (A0 + A1) B: mma_ab for two A fragments sharing each B fragment.
template <int kPitch, int NT>
__device__ __forceinline__ void mma_ab2(float (&acc)[NT][4], const unsigned (&a0)[4],
                                        const unsigned (&a1)[4], const __nv_bfloat16* rows,
                                        int lane) {
  const int mi = lane / 8;
  const __nv_bfloat16* row = rows + ((mi % 2) * 8 + lane % 8) * kPitch + (mi / 2) * 8;
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    unsigned bf[4];
    ldmatrix_x4_trans(bf, row + np * 16);
    mma_bf16(acc[2 * np], a0, bf);
    mma_bf16(acc[2 * np + 1], a0, bf + 2);
    mma_bf16(acc[2 * np], a1, bf);
    mma_bf16(acc[2 * np + 1], a1, bf + 2);
  }
}

// --- 64 x 64 bf16 tiles loaded by the copy engine (tensor maps) ------------
//
// A tile holds 64 rows of 64 values (128 bytes) stored with the 128-byte
// swizzle: the 16-byte chunk c of row r sits at chunk c ^ (r mod 8), so the
// eight rows an ldmatrix reads fall on distinct banks.  Rows past the
// tensor's extent are zero.

__host__ __device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// Where a tensor map puts the sequence, head and batch among its dims 1..3.
struct TileCoords {
  int s_dim, h_dim, b_dim;                     // positions of S, H and B among dims 1..3
};

// The copy engine loads the 64 x 64 tile of rows j0.. of (b, h) from `map`
// into `dst` (1024-byte aligned; rows past S zero), counted on `bar`.
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap& map, TileCoords tc, int j0,
                                         int h, int b, unsigned long long* bar) {
  int c[4] = {0, 0, 0, 0};
  c[tc.s_dim] = j0;
  c[tc.h_dim] = h;
  c[tc.b_dim] = b;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<unsigned long long>(&map)), "r"(c[0]),
         "r"(c[1]), "r"(c[2]), "r"(c[3]), "r"(smem_addr(bar)) : "memory");
}

// A tensor map of a (B, H, S, 64) bf16 view with the given (batch, seq,
// head) element strides, for 64 x 64 tiles of (S, Dh) stored with the
// 128-byte swizzle; dims 1..3 (S, H, B) are taken in order of stride.
inline cudaError_t tile_map(CUtensorMap* map, TileCoords* tc, const void* base, int B, int H,
                            int S, long long s_stride, long long h_stride, long long b_stride) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || !fn)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  // dims 1..3 in order of stride
  long long ext[3] = {S, H, B}, str[3] = {s_stride, h_stride, b_stride};
  int order[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (str[order[j]] < str[order[i]]) {
        const int x = order[i];
        order[i] = order[j];
        order[j] = x;
      }
  cuuint64_t dims[4] = {64, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  int pos[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<cuuint64_t>(ext[order[i]]);
    strides[i] = static_cast<cuuint64_t>(str[order[i]]) * sizeof(__nv_bfloat16);
    pos[order[i]] = i + 1;
  }
  box[pos[0]] = 64;
  *tc = TileCoords{pos[0], pos[1], pos[2]};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// x[mt][kb] = A_mt B_kb^T for MT 16-row tiles of A at `a_rows` (rows
// kPitch elements apart) and NK 16-row tiles of B, rows b0 + 16 kb .. of
// the swizzled tile at `b` (each 16 x 64): each A fragment feeds every B
// tile and each B fragment every A tile, and the 2 MT NK products of a
// k-step are independent.
template <int kPitch, int MT, int NK>
__device__ __forceinline__ void mma_abt_tiles(float (&x)[MT][NK][2][4],
                                              const __nv_bfloat16* a_rows,
                                              const unsigned char* b, int b0, int lane) {
  const int mi = lane / 8;
  const int r = b0 + (mi / 2) * 8 + lane % 8;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kb = 0; kb < NK; ++kb)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[mt][kb][nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    unsigned af[MT][4], bf[NK][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldmatrix_a<kPitch>(af[mt], a_rows + mt * 16 * kPitch + ks * 16, lane);
#pragma unroll
    for (int kb = 0; kb < NK; ++kb) ldmatrix_x4(bf[kb], b + swz(r + kb * 16, ks * 2 + mi % 2));
#pragma unroll
    for (int kb = 0; kb < NK; ++kb)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(x[mt][kb][0], af[mt], bf[kb]);
        mma_bf16(x[mt][kb][1], af[mt], bf[kb] + 2);
      }
  }
}

// acc[mt] += A_mt B for MT 16 x 16 A fragments a[mt] and B rows b0 .. b0 +
// 15 of the swizzled tile at `b` (k x n): each B fragment feeds every A.
template <int MT>
__device__ __forceinline__ void mma_ab_tiles(float (&acc)[MT][8][4], const unsigned (&a)[MT][4],
                                             const unsigned char* b, int b0, int lane) {
  const int mi = lane / 8;
  const int r = b0 + (mi % 2) * 8 + lane % 8;
  unsigned bf[4][4];
#pragma unroll
  for (int np = 0; np < 4; ++np) ldmatrix_x4_trans(bf[np], b + swz(r, np * 2 + mi / 2));
#pragma unroll
  for (int np = 0; np < 4; ++np)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_bf16(acc[mt][2 * np], a[mt], bf[np]);
      mma_bf16(acc[mt][2 * np + 1], a[mt], bf[np] + 2);
    }
}

// As mma_ab_tiles for two A fragments a0[mt] + a1[mt] (a product's hi and
// lo terms), a0's sums taken first.
template <int MT>
__device__ __forceinline__ void mma_ab2_tiles(float (&acc)[MT][8][4], const unsigned (&a0)[MT][4],
                                              const unsigned (&a1)[MT][4], const unsigned char* b,
                                              int b0, int lane) {
  const int mi = lane / 8;
  const int r = b0 + (mi % 2) * 8 + lane % 8;
  unsigned bf[4][4];
#pragma unroll
  for (int np = 0; np < 4; ++np) ldmatrix_x4_trans(bf[np], b + swz(r, np * 2 + mi / 2));
#pragma unroll
  for (int np = 0; np < 4; ++np)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_bf16(acc[mt][2 * np], a0[mt], bf[np]);
      mma_bf16(acc[mt][2 * np + 1], a0[mt], bf[np] + 2);
    }
#pragma unroll
  for (int np = 0; np < 4; ++np)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_bf16(acc[mt][2 * np], a1[mt], bf[np]);
      mma_bf16(acc[mt][2 * np + 1], a1[mt], bf[np] + 2);
    }
}

// 2^x in one MUFU operation (ex2.approx.ftz: subnormal results flush to 0,
// where exp2f spends instructions on them).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// cp.async `rows` rows of 64 bf16 values from row j0 of `src` (rows
// `stride` elements apart) into rows of 72 at `dst` (144 bytes: ldmatrix
// reads them without bank conflicts), zero past row S, the block's threads
// sharing them.
__device__ __forceinline__ void rows_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long stride, int j0, int rows, int S) {
  for (int e = threadIdx.x; e < rows * 8; e += blockDim.x) {
    const int j = e / 8, c = (e % 8) * 8;
    const bool in = j0 + j < S;
    cp_async16(dst + j * 72 + c, src + (in ? j0 + j : 0) * stride + c, in);
  }
}

// --- mbarriers for tiles in flight --------------------------------------------
//
// Stage s of a ring has one barrier: the thread that issues the stage's
// tile loads arrives on it announcing their bytes (its one expected
// arrival), and it completes a phase when the bytes have landed.  Round r
// of the stage waits at parity r & 1.

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// After the inits, before any other thread uses the barriers (with a
// __syncthreads).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` more of tile loads to wait for.
__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
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

// Rows ra and rb = ra + 8 of a 16-row C tile set acc (those with in_a,
// in_b), times `mul`, to the bf16 rows at `base` (`stride` elements
// apart), columns below Dh: 4-byte stores where `pairs` (even Dh, rows
// 4-byte aligned).  FULL: every column, in 4-byte stores (Dh = 8 NT,
// pairs), with no test a column.
template <bool FULL, int NT>
__device__ __forceinline__ void store_tile_rows(__nv_bfloat16* base, long long stride,
                                                const float (&acc)[NT][4], float mul, int ra,
                                                int rb, bool in_a, bool in_b, int Dh,
                                                bool pairs, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int d = nt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!(half ? in_b : in_a) || (!FULL && d >= Dh)) continue;
      __nv_bfloat16* p = base + (half ? rb : ra) * stride + d;
      const float x0 = acc[nt][2 * half] * mul, x1 = acc[nt][2 * half + 1] * mul;
      if (FULL || pairs) {
        *reinterpret_cast<unsigned*>(p) = pack_bf16(x0, x1);
      } else {
        p[0] = __float2bfloat16_rn(x0);
        if (d + 1 < Dh) p[1] = __float2bfloat16_rn(x1);
      }
    }
  }
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

// The first of the tiles that block y of `blocks` takes of `tiles`: blocks
// take ranges of tiles as even as integers allow.
__host__ __device__ __forceinline__ int tile_begin(int y, int blocks, int tiles) {
  return static_cast<int>(static_cast<long long>(y) * tiles / blocks);
}

// --- bf16 wide-head attention (Dh > 64, tensor cores) --------------------------
//
// The bf16 wide-head kernels (attention.cu attention_wide_tc, attention_bwd.cu
// attention_bwd_wide_tc_*) take any head width on mma.sync.  The head
// dimension, zero-padded to DP = Dh rounded up to 16 in shared memory, is cut
// into nd = ceil(DP / 128) chunks of 16-column units as even as integers
// allow (WideChunks); a block writes the output columns of one chunk
// (grid.z) and sums its scores over every chunk.  Operands are staged by
// 16-byte cp.async (rows 16-byte aligned: the caller copies others) into
// rows of the widest chunk's width + 8 elements, an odd multiple of 16
// bytes, so every ldmatrix is free of bank conflicts.

constexpr int kWideUnits = 8;                // 16-column units a chunk at most (128 columns)

struct WideChunks {
  int nd, units;                             // chunks, 16-column units of DP
  __host__ __device__ WideChunks(int Dh) : units((Dh + 15) / 16) {
    nd = (units + kWideUnits - 1) / kWideUnits;
  }
  __host__ __device__ int begin(int c) const { return c * units / nd * 16; }
  __host__ __device__ int width(int c) const { return begin(c + 1) - begin(c); }
  // elements a staged row: the widest chunk + 8
  __host__ __device__ int pitch() const { return (units + nd - 1) / nd * 16 + 8; }
};

// Item `it` of a wide block: its sweeps run over n_tiles streamed tiles,
// each over the nd chunks with the block's own chunk z last, so that the
// last item of a tile holds the chunk of the block's output columns.
struct WideItem {
  int tile, i, chunk;                        // the tile, the item's place in it, its chunk
  __device__ WideItem(int it, int n_tiles, int nd, int z) {
    const int rem = it % (n_tiles * nd);
    tile = rem / nd;
    i = rem % nd;
    chunk = (z + 1 + i) % nd;
  }
};

// 16-byte global -> shared copy of `bytes` (0..16) bytes, the rest zero
// (src is not read when bytes is 0).
__device__ __forceinline__ void cp_async_part(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

// Rows j0 .. j0 + rows - 1 of a (batch, head) operand `src` (rows `stride`
// elements apart, 16-byte aligned), its columns c0 .. c0 + width - 1 (width
// a multiple of 8), into shared rows `pitch` elements apart at `dst`, the
// block's threads sharing them: zero past row S and column Dh.
__device__ __forceinline__ void chunk_async(__nv_bfloat16* dst, int pitch,
                                            const __nv_bfloat16* src, long long stride, int j0,
                                            int rows, int S, int c0, int width, int Dh) {
  // thread e takes the 8-column pieces e, e + blockDim.x, ... in row-major
  // order, stepped without a division
  const int per_row = width / 8;
  const int dj = blockDim.x / per_row, dc = blockDim.x % per_row;
  int j = threadIdx.x / per_row, c = threadIdx.x % per_row;
  while (j < rows) {
    const int col = c0 + 8 * c;
    const int bytes = j0 + j < S ? 2 * max(0, min(8, Dh - col)) : 0;
    cp_async_part(dst + j * pitch + 8 * c, bytes ? src + (j0 + j) * stride + col : src, bytes);
    j += dj;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++j;
    }
  }
}

// x[kb] += A B_kb^T for A the 16 rows at `a` (ap elements apart) and B_kb
// rows 16 kb .. 16 kb + 15 at `b` (bp apart), kb < live, over `steps` 16-column
// steps: each A fragment feeds every B tile.
template <int NK>
__device__ __forceinline__ void mma_abt_rows(float (&x)[NK][2][4], const __nv_bfloat16* a,
                                             int ap, const __nv_bfloat16* b, int bp, int steps,
                                             int live, int lane) {
  const int mi = lane / 8;
  const __nv_bfloat16* ar = a + ((mi % 2) * 8 + lane % 8) * ap + (mi / 2) * 8;
  const __nv_bfloat16* br = b + ((mi / 2) * 8 + lane % 8) * bp + (mi % 2) * 8;
#pragma unroll
  for (int ks = 0; ks < kWideUnits; ++ks) {
    if (ks >= steps) break;
    unsigned af[4];
    ldmatrix_x4(af, ar + ks * 16);
#pragma unroll
    for (int kb = 0; kb < NK; ++kb) {
      if (kb >= live) break;
      unsigned bf[4];
      ldmatrix_x4(bf, br + kb * 16 * bp + ks * 16);
      mma_bf16(x[kb][0], af, bf);
      mma_bf16(x[kb][1], af, bf + 2);
    }
  }
}

// acc += A B for A (16 x 16, fragment a) and B the 16 rows at `b` (bp
// elements apart), its first 16 n16 columns: acc[nt] holds columns 8 nt ..
__device__ __forceinline__ void mma_ab_rows(float (&acc)[2 * kWideUnits][4], const unsigned (&a)[4],
                                            const __nv_bfloat16* b, int bp, int n16, int lane) {
  const int mi = lane / 8;
  const __nv_bfloat16* row = b + ((mi % 2) * 8 + lane % 8) * bp + (mi / 2) * 8;
#pragma unroll
  for (int np = 0; np < kWideUnits; ++np) {
    if (np >= n16) break;
    unsigned bf[4];
    ldmatrix_x4_trans(bf, row + np * 16);
    mma_bf16(acc[2 * np], a, bf);
    mma_bf16(acc[2 * np + 1], a, bf + 2);
  }
}

// As mma_ab_rows for A = a0 + a1 (a product's hi and lo bf16 terms).
__device__ __forceinline__ void mma_ab2_rows(float (&acc)[2 * kWideUnits][4],
                                             const unsigned (&a0)[4], const unsigned (&a1)[4],
                                             const __nv_bfloat16* b, int bp, int n16, int lane) {
  const int mi = lane / 8;
  const __nv_bfloat16* row = b + ((mi % 2) * 8 + lane % 8) * bp + (mi / 2) * 8;
#pragma unroll
  for (int np = 0; np < kWideUnits; ++np) {
    if (np >= n16) break;
    unsigned bf[4];
    ldmatrix_x4_trans(bf, row + np * 16);
    mma_bf16(acc[2 * np], a0, bf);
    mma_bf16(acc[2 * np + 1], a0, bf + 2);
    mma_bf16(acc[2 * np], a1, bf);
    mma_bf16(acc[2 * np + 1], a1, bf + 2);
  }
}

// The mma A fragment of a 16 x 16 tile held as two C tiles (x[0], x[1]:
// columns 0..7 and 8..15), rounded to bf16.
__device__ __forceinline__ void c_to_a_bf16(const float (&x)[2][4], unsigned (&a)[4]) {
  a[0] = pack_bf16(x[0][0], x[0][1]);
  a[1] = pack_bf16(x[0][2], x[0][3]);
  a[2] = pack_bf16(x[1][0], x[1][1]);
  a[3] = pack_bf16(x[1][2], x[1][3]);
}

// Store rows ra and rb = ra + 8 (those < S) of a 16-row C tile set acc,
// times `mul`, as columns c0 + 8 nt + 2t (+1) below c_end, to the bf16 rows
// at `dst` (`stride` elements apart); `pairs`: 4-byte stores (even Dh,
// rows 4-byte aligned).
__device__ __forceinline__ void wide_store(__nv_bfloat16* dst, long long stride,
                                           const float (&acc)[2 * kWideUnits][4], float mul,
                                           int ra, int S, int c0, int c_end, bool pairs, int t) {
#pragma unroll
  for (int nt = 0; nt < 2 * kWideUnits; ++nt) {
    const int col = c0 + nt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = ra + 8 * half;
      if (r >= S || col >= c_end) continue;
      __nv_bfloat16* p = dst + r * stride + col;
      const float x0 = acc[nt][2 * half] * mul, x1 = acc[nt][2 * half + 1] * mul;
      if (pairs) {
        *reinterpret_cast<unsigned*>(p) = pack_bf16(x0, x1);
      } else {
        p[0] = __float2bfloat16_rn(x0);
        if (col + 1 < c_end) p[1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// --- f32 wide-head attention (above the tuned widths, tensor cores) ---------
//
// The f32 wide-head kernels (attention.cu attention_wide, attention_bwd.cu
// attention_bwd_wide_*) take any head width on mma.sync in three TF32 terms
// (above), as the tuned f32 kernels do at their widths.  The head
// dimension, zero-padded to a multiple of 8 in shared memory, is cut into
// nd = ceil(Dh / 64) chunks (F32Chunks), so a warp's accumulators stay at
// most 16 x 64 floats.  W warps share each 16-row tile, one chunk each, in
// R = ceil(nd / 4) rounds of W = ceil(nd / R) chunks (F32Wide): each warp
// takes its chunks' share of a product over the width, the W shares are
// summed through shared memory (xchg_put, xchg_sum), and each warp writes
// the output columns of its own chunk.  A block owns the chunks of round z
// (grid.z) and takes its rounds in WideItem's order, its own last
// (F32Item), so the products over the width are computed R times: once up
// to Dh = 256.  Operands are staged by cp.async, 16 bytes where rows are
// 16-byte aligned and Dh a multiple of 4, else 4 bytes (f32 rows are read in
// place, never copied), into rows of kF32WidePitch floats (= 4 mod 32:
// every fragment load is free of bank conflicts).

constexpr int kF32WideUnits = 8;             // 8-column units a chunk at most (64 columns)
constexpr int kF32WidePitch = 8 * kF32WideUnits + 4;

constexpr int kF32WideCols = 4;              // warps sharing a row tile at most

// nd chunks of cw columns, the last narrower (never empty: nd = ceil(Dh /
// 64)), taken without a division.
struct F32Chunks {
  int nd, cw, dp;                            // chunks, columns a chunk, Dh rounded up to 8
  __host__ __device__ F32Chunks(int Dh) : dp((Dh + 7) & ~7) {
    const int units = dp / 8;
    nd = (units + kF32WideUnits - 1) / kF32WideUnits;
    cw = (units + nd - 1) / nd * 8;
  }
  __host__ __device__ int begin(int c) const { return c * cw; }
  __host__ __device__ int width(int c) const { return dp - c * cw < cw ? dp - c * cw : cw; }
};

// The chunks, and the rounds R of W chunks that cover them (W warps a row
// tile; round r holds chunks r W .. r W + W - 1 below nd).
struct F32Wide : F32Chunks {
  int R, W;
  __host__ __device__ F32Wide(int Dh) : F32Chunks(Dh) {
    R = (nd + kF32WideCols - 1) / kF32WideCols;
    W = (nd + R - 1) / R;
  }
};

// The items of an f32 wide block in WideItem's order (the tiles, each over
// the R rounds with round z last), stepped without a division.
struct F32Item {
  int tile, i, round;                        // the tile, the item's place in it, its round
  __device__ F32Item(int R, int z) : tile(0), i(0), round(z + 1 < R ? z + 1 : 0) {}
  __device__ void next(int R, int n_tiles, int z) {
    if (++i == R) {
      i = 0;
      if (++tile == n_tiles) tile = 0;         // the next sweep
    }
    round = z + 1 + i < R ? z + 1 + i : z + 1 + i - R;
  }
};

// Rows j0 .. j0 + rows - 1 of a (batch, head) f32 operand `src` (rows
// `stride` floats apart), its columns c0 .. c0 + width - 1 (width a
// multiple of 8, at most 64), into shared rows kF32WidePitch floats apart at
// `dst`, the block's threads sharing them: zero past row S and column Dh.
// vec: 16-byte copies (rows 16-byte aligned, Dh a multiple of 4), else 4
// bytes; thread e takes the pieces e, e + blockDim.x, ... of 64-column rows.
__device__ __forceinline__ void f32_chunk_async(float* dst, const float* src, long long stride,
                                                int j0, int rows, int S, int c0, int width,
                                                int Dh, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < rows * 16; e += blockDim.x) {
      const int j = e >> 4, d = (e & 15) * 4, col = c0 + d;
      if (d >= width) continue;
      const bool in = j0 + j < S && col < Dh;
      cp_async16(dst + j * kF32WidePitch + d, in ? src + (j0 + j) * stride + col : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < rows * 64; e += blockDim.x) {
      const int j = e >> 6, d = e & 63, col = c0 + d;
      if (d >= width) continue;
      const bool in = j0 + j < S && col < Dh;
      cp_async4(dst + j * kF32WidePitch + d, in ? src + (j0 + j) * stride + col : src, in);
    }
  }
}

// The A fragment of 16 staged rows at `rows` (kF32WidePitch floats apart),
// 8 columns from there, split.
__device__ __forceinline__ void a_frag_rows(unsigned (&ah)[4], unsigned (&al)[4],
                                            const float* rows, int g, int t) {
  split_tf32(rows[g * kF32WidePitch + t], ah[0], al[0]);
  split_tf32(rows[(g + 8) * kF32WidePitch + t], ah[1], al[1]);
  split_tf32(rows[g * kF32WidePitch + t + 4], ah[2], al[2]);
  split_tf32(rows[(g + 8) * kF32WidePitch + t + 4], ah[3], al[3]);
}

// x_hi[n] + x_lo[n] += A B_n^T over `steps` 8-column steps of a chunk, for A
// the 16 staged rows at `a` and B_n the 8 staged rows 8 n .. at `b`, n <
// live (warp-uniform): hi.hi summed apart from the small terms
// (mma_3xtf32_apart), against the tensor core's rounding toward zero over
// sums as long as the head.  Whole: a whole chunk and tile take a path that
// no branch splits (faster in the backward; it costs registers that the
// forward's two blocks an SM do not have).
template <int N, bool Whole>
__device__ __forceinline__ void f32_wide_abt(float (&x_hi)[N][4], float (&x_lo)[N][4],
                                             const float* a, const float* b, int steps, int live,
                                             int g, int t) {
  if (Whole && steps == kF32WideUnits && live == N) {
#pragma unroll
    for (int kk = 0; kk < kF32WideUnits; ++kk) {
      unsigned ah[4], al[4], bh[N][2], bl[N][2];
      a_frag_rows(ah, al, a + kk * 8, g, t);
#pragma unroll
      for (int n = 0; n < N; ++n)
        b_frag_rows(bh[n], bl[n], b + n * 8 * kF32WidePitch + kk * 8, kF32WidePitch, g, t);
      mma_3xtf32_apart<N>(x_hi, x_lo, ah, al, bh, bl, N);
    }
    return;
  }
#pragma unroll
  for (int kk = 0; kk < kF32WideUnits; ++kk) {
    if (kk >= steps) break;
    unsigned ah[4], al[4], bh[N][2], bl[N][2];
    a_frag_rows(ah, al, a + kk * 8, g, t);
#pragma unroll
    for (int n = 0; n < N; ++n)
      if (n < live)
        b_frag_rows(bh[n], bl[n], b + n * 8 * kF32WidePitch + kk * 8, kF32WidePitch, g, t);
    mma_3xtf32_apart<N>(x_hi, x_lo, ah, al, bh, bl, live);
  }
}

// acc[n] += C B for C the 16 x 8 tiles c[kt], kt < live, and B the staged
// rows 8 kt .. at `b`, its columns 8 n .. 8 n + 7 for n < cols (both
// warp-uniform); Whole as f32_wide_abt's.
template <int KT, bool Whole>
__device__ __forceinline__ void f32_wide_cb(float (&acc)[kF32WideUnits][4], const float (&c)[KT][4],
                                            const float* b, int live, int cols, int g, int t) {
  if (Whole && live == KT && cols == kF32WideUnits) {
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      unsigned ah[4], al[4];
      c_to_a(c[kt], ah, al);
#pragma unroll
      for (int n0 = 0; n0 < kF32WideUnits; n0 += 4) {
        unsigned bh[4][2], bl[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b_frag_cols(bh[j], bl[j], b + kt * 8 * kF32WidePitch + (n0 + j) * 8, kF32WidePitch, g,
                      t);
        mma_3xtf32<4>(acc + n0, ah, al, bh, bl, 4);
      }
    }
    return;
  }
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    if (kt >= live) break;
    unsigned ah[4], al[4];
    c_to_a(c[kt], ah, al);
#pragma unroll
    for (int n0 = 0; n0 < kF32WideUnits; n0 += 4) {
      if (n0 >= cols) break;
      unsigned bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + j < cols)
          b_frag_cols(bh[j], bl[j], b + kt * 8 * kF32WidePitch + (n0 + j) * 8, kF32WidePitch, g,
                      t);
      mma_3xtf32<4>(acc + n0, ah, al, bh, bl, cols - n0);
    }
  }
}

// Partial products over the width, summed across the warps that share a
// row tile (one chunk of the width a warp): each warp puts its 16 x 8 N
// tiles in its slot of 128 N floats (lane-major, so conflict-free), and
// after a barrier every warp of the tile sums the W slots in the same
// order, so all W hold the same sums.
template <int N>
__device__ __forceinline__ void xchg_put(float* slot, const float (&x)[N][4], int lane) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) slot[(n * 4 + e) * 32 + lane] = x[n][e];
}

template <int N>
__device__ __forceinline__ void xchg_sum(float (&x)[N][4], const float* slots, int W, int lane) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float sum = 0.f;
      for (int w = 0; w < W; ++w) sum += slots[(w * N * 4 + n * 4 + e) * 32 + lane];
      x[n][e] = sum;
    }
}

// Store rows ra and ra + 8 (those < S) of a 16-row C tile set acc, row
// half h times mul[h], as columns c0 + 8 n + 2t (+1) below c_end, to the f32
// rows at `dst` (`stride` floats apart); pairs: 8-byte stores (even Dh,
// rows 8-byte aligned).
__device__ __forceinline__ void f32_wide_store(float* dst, long long stride,
                                               const float (&acc)[kF32WideUnits][4],
                                               const float (&mul)[2], int ra, int S, int c0,
                                               int c_end, bool pairs, int t) {
#pragma unroll
  for (int n = 0; n < kF32WideUnits; ++n) {
    const int col = c0 + n * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = ra + 8 * half;
      if (r >= S || col >= c_end) continue;
      float* p = dst + r * stride + col;
      const float x0 = acc[n][2 * half] * mul[half], x1 = acc[n][2 * half + 1] * mul[half];
      if (pairs) {
        *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
      } else {
        p[0] = x0;
        if (col + 1 < c_end) p[1] = x1;
      }
    }
  }
}

}  // namespace keds

extern "C" const char* keds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
