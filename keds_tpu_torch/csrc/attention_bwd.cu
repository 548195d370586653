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
// attention_bwd_tc<NKB, DH> (bf16, Dh <= 64, S <= kMaxSeq = 128).  What bounds it on the H100:
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
//     exported (keds_attention_bwd_plan); the wrapper reads its workspace
//     rows through keds_attention_bwd_route.
//   Shared memory: 47 KB a block at S = 77, 74 KB at S = 128.
//   * A head narrower than 64 runs at DH, Dh rounded up to 16 (a template
//     parameter beside NKB: 16, 32, 48 or 64): rows of DH + 8 elements,
//     zero past Dh by cp.async's source size (nothing padded in device
//     memory), DH / 16 k-steps of every product over the head and DH / 8
//     n-tiles of dQ, dK and dV, the gradients written at the caller's
//     width.  A slice stages (DH + 8) / 72 of the 64-wide bytes (S = 77:
//     26 KB at DH = 32, 16 KB at DH = 16), so shared memory lets more
//     blocks share an SM; the registers of pass A's rows of scores, which
//     do not narrow, still bound them (tc_min_blocks).
//
// attention_bwd_tc_dq and attention_bwd_tc_dkv (bf16, Dh = 64, S > 128).
// Above 128 keys a warp's row of scores no longer fits in registers and a
// (batch, head) no longer fits in one block's shared memory, so the work is
// split in two launches that stream tiles through shared memory, with no
// atomics.  What bounds them on the H100: at (4, 16, 577, 64) the function
// moves 33 MB (0.010 ms) and does 13.6 GFLOP, but the VJP's numerics need
// 11 products of 2 S^2 Dh a (batch, head) (dS enters dQ and dK as two
// terms) and 3 exp2 a score; as in the forward, the tile stream and the
// arithmetic add up, so blocks an SM mattered most.  The design:
//   * dq: a block takes 64 query rows (four warps of 16), their q and dO
//     rows held in shared memory; K and V arrive as 64 x 64 tiles through a
//     three-stage ring that the copy engine fills (thread 0, one tensor-map
//     load a tile, counted on the stage's mbarrier; rows past S zero), two
//     sweeps: the first takes each row's max m, sum l and D = sum P
//     round(dP) together, D rescaled with l as m grows (32 keys at a time);
//     the second dS = P (dP - D) as hi + lo bf16 terms into dQ = scale dS K.
//     It writes each row's m * scale * log2(e), 1 / l and D to a workspace
//     (0 for rows past S).
//   * dkv: a block takes 64 key rows, their K and V rows held in shared
//     memory, and streams the query rows (from the block's first key when
//     causal) as q and dO tiles the same way, their statistics by cp.async;
//     each warp recomputes P^T and dP^T per 16 queries and accumulates dV =
//     round(P)^T dO and dK = scale dS^T q in registers.
//   * 128 threads and three blocks an SM each (64-row blocks measured faster
//     than 128-row ones at every shape timed, though they stream K, V, q
//     and dO twice as often); no branch splits a tile's products.
//   The per-element arithmetic is the resident kernel's (round(P) for dV,
//   dP rounded to bf16, dS as hi + lo), so the two agree to rounding.
//   Shared memory: 67 KB (dq), 69 KB (dkv).

// attention_bwd_f32, attention_bwd_f32_dq and attention_bwd_f32_dkv (f32,
// Dh = 64, any S).  What bounds them on the H100: operations, 10 B H pairs
// Dh flops on 7 B H S Dh floats (at (4, 16, 577, 64) 13.6 GFLOP on 66 MB:
// 0.083 ms at 3xTF32's 494.7 / 3 TFLOP/s, 0.20 ms at f32 FMA's 67
// TFLOP/s).  One design at every S, on the forward's
// principles (attention.cu): every product on tensor cores in three TF32
// terms (common.cuh), a warp owning 16 rows with the softmax in its
// accumulator fragments, operands in 68-float shared rows (conflict-free
// fragment loads), split at their load by integer rounding, a product's
// terms issued across four accumulators.  Each gradient is written once
// (no atomics; splits merge in a fixed order), so two calls agree bit for
// bit.
//   * S <= kF32Chunk: one launch, a block a (batch, head) holding q, k, v
//     and dO (16-byte cp.async) and three statistics a row.  Warp w takes
//     query tile w (F32Dq: two sweeps over the keys, the first taking each
//     row's max m, sum l and D = sum P dP together, D accumulating
//     exp(s - m) dP with the same online rescaling as l; the second
//     dS = P (dP - D) into dQ), then key tile w (F32Dkv: P^T and dP^T
//     recomputed from the statistics per 32 queries, dV += P^T dO,
//     dK += dS^T q).  No workspace.
//   * Above: two launches.  dq holds its block's q and dO rows and streams
//     K and V through a two-stage ring of kF32Chunk rows, twice, writing the
//     statistics to a workspace (16 S rounded to 16 floats a (batch, head)
//     and statistic); dkv holds its keys' K and V and streams q, dO and the
//     statistics, from the block's first key when causal.
//   * A block takes up to four 16-row tiles of a (batch, head); where they
//     give fewer than two warps to each sub-partition, 2 or 4 warps take a
//     tile's keys (dq) or queries (dkv) in turn, one 32-row sub-tile of
//     each stage (128-row stages at four), and merge their statistics after
//     the first sweep and their sums at the end.  The A operands come from
//     shared memory, which keeps a thread at 147-168 registers (three
//     blocks an SM by registers; the streamed launches' shared memory:
//     102 KB and 104 KB at four tiles).

// attention_bwd_wide_tc_dq and attention_bwd_wide_tc_dkv (bf16 above Dh =
// 64, any Dh and S; narrower heads take the kernels above: the resident one
// at their own width, the streamed ones zero-padded to 64 by the caller).
// No CLIP preset reaches them; a custom config does.  What bounds them on the H100: at (4, 16, 257, 80) the function
// moves 18.4 MB (0.0055 ms) and does 3.4 GFLOP, so bytes; as at Dh = 64,
// the tile stream's latency and the VJP's 11 products of 2 S^2 Dh set the
// time.  The streamed routes' design (two launches, no atomics, the same
// per-element arithmetic: round(P) for dV, dP rounded to bf16, dS as hi +
// lo bf16 terms) made to take any width at bounded cost, as the forward's
// attention_wide_tc (attention.cu):
//   * The head dimension is zero-padded to a multiple of 16 in shared
//     memory alone and cut into nd = ceil(Dh / 128) chunks (common.cuh);
//     the products over the width (s = q k^T and dP = dO V^T) sum over the
//     chunks in registers, and a block writes the gradients' columns of
//     one chunk (grid.z), so dQ (or dK and dV) stay at most 16 x 128 f32
//     a warp each.
//   * dq: a block takes up to four 16-row query tiles, its q and dO rows
//     staged once at nd = 1; K and V stream through a two-stage cp.async
//     ring (one barrier an item) in tiles of 64 keys (S rounded to 16 at
//     most; the live keys alone), each over the nd chunks with the block's
//     own chunk last, twice: the statistics m, l and D, then dS = P
//     (round(dP) - D) into dQ.  It writes m c, 1 / l and D to an f32
//     workspace (S rows a (batch, head) and statistic).
//   * dkv: a block takes up to four 16-row key tiles, its K and V rows
//     staged once at nd = 1; the query rows that see them (from the
//     block's first key when causal) stream in tiles of 32 with their dO
//     rows and, at a tile's last chunk, their statistics; P^T and dP^T are
//     recomputed and dV += round(P)^T dO, dK += scale dS^T q, 16 queries at
//     a time.
//   * In trials on the card dq's 64-key tiles beat 32 (and 32 beat 16);
//     eight warps a block and a third ring stage moved nothing.  219
//     registers (dq) and 241 (dkv: two 16 x 128 accumulators), no spills,
//     two blocks an SM; at most 136 KB and 103 KB of shared memory.  Rows
//     must be 16-byte aligned; the caller copies others.

// attention_bwd_wide_dq and attention_bwd_wide_dkv (f32 above Dh = 64, any
// Dh and S).  Every f32 backward above 64 (128-wide heads too) and custom
// configs' wide heads reach them.  What bounds them on the H100: operations
// at large S (at (16, 4, 257, 256) 10.8 GFLOP on 118 MB: 0.066 ms at
// 3xTF32's rate), latency at the prompts' S.  The tuned f32 pair's design
// (attention_bwd_f32_dq and _dkv: 3xTF32 on mma.sync, a warp owning 16 rows,
// its per-element arithmetic, splits merged in a fixed order, no atomics, so
// two calls agree bit for bit) made width-general as the forward's
// attention_wide (attention.cu):
//   * W warps share each 16-row tile, one <= 64-column chunk each (common.cuh,
//     f32 wide-head attention): s = q k^T and dP = dO V^T (dkv: their
//     transposes) are summed over the W shares through shared memory, and
//     each warp writes the gradients' columns of its own chunk, so the
//     products over the width are taken once up to Dh = 256.
//   * dq: K and V stream through a two-stage cp.async ring in stages of 16
//     keys a warp, twice, the block's q and dO rows staged once (R = 1):
//     the statistics m, l and D, then dS = P (dP - D) into dQ.  It writes m
//     c, 1 / l and D to the workspace (3 x BH x S floats).  dkv: the queries
//     that see the block's keys stream with their dO rows and, at a tile's
//     last round, their statistics; P^T and dS^T enter dV and dK.
//   * Blocks of up to four warps, two an SM (their shared memory allows no
//     more); where the grid is thin, 2 to 4 splits of a tile's warps take
//     its keys (dq) or queries (dkv), a block of up to eight warps.  Rows are
//     read in place (16-byte copies where aligned, else 4 bytes).

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

// Rows of DH + 8 elements at head width DH (16, 32, 48 or 64): an odd
// multiple of 16 bytes, so every ldmatrix is conflict-free.
__host__ __device__ constexpr int tc_pitch(int dh) { return dh + 8; }

// q, k, v and dO of one (batch, head) at head width dh, and three f32
// statistics a row.
__host__ __device__ constexpr int tc_slice_bytes(int key_tiles, int dh) {
  return 16 * key_tiles * (4 * tc_pitch(dh) * static_cast<int>(sizeof(bf16)) +
                           3 * static_cast<int>(sizeof(float)));
}


__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Plan {
  int key_tiles, slices, warps, smem_bytes;
};

Plan tc_plan(int S, int dh) {
  const int n = (S + 15) / 16;
  const int slices = n == 1 ? kSmallSlices : 1;
  return Plan{n, slices, n == 1 ? kSmallSlices : n, slices * tc_slice_bytes(n, dh)};
}

// Blocks an SM that the register budget must allow (shared memory allows
// four at S <= 80); past 6 key tiles pass A's rows of scores need more.
__host__ __device__ constexpr int tc_min_blocks(int key_tiles) {
  return key_tiles == 1 ? 4 : key_tiles <= 5 ? 3 : key_tiles == 6 ? 2 : 1;
}

// FULL: Dh = DH and 4-byte aligned gradient rows, so no column is tested;
// the other instantiation masks columns past Dh (a head width off 16).
template <int NKB, int DH, bool FULL>
__global__ void __launch_bounds__(32 * (NKB == 1 ? kSmallSlices : NKB), tc_min_blocks(NKB))
attention_bwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                 int BH, int H, int S, int Dh, Strides qs, Strides ks, Strides vs, Strides gs,
                 Strides dqs, Strides dks, Strides dvs, int causal, float scale, int pairs) {
  constexpr int kRows = 16 * NKB;            // staged rows per tensor, zero past S
  constexpr int kSlices = NKB == 1 ? kSmallSlices : 1;
  constexpr int P = tc_pitch(DH), KS = DH / 16, NT = DH / 8, kPieces = DH / 8;
  extern __shared__ __align__(16) unsigned char smem[];

  // 16-byte pieces of the rows; rows past S and columns past Dh are
  // zero-filled (cp.async's source size), never read
  const bf16* const src[4] = {q, k, v, dout};
  const Strides sst[4] = {qs, ks, vs, gs};
#pragma unroll
  for (int tn = 0; tn < 4; ++tn) {
    for (int e = threadIdx.x; e < kSlices * kRows * kPieces; e += blockDim.x) {
      const int sl = e / (kRows * kPieces), j = (e / kPieces) % kRows, c = (e % kPieces) * 8;
      const int bh = blockIdx.x * kSlices + sl;
      const int bytes = j >= S || bh >= BH ? 0 : FULL ? 16 : 2 * max(0, min(8, Dh - c));
      const int b = bytes ? bh / H : 0, h = bytes ? bh % H : 0;
      bf16* dst = reinterpret_cast<bf16*>(smem + sl * tc_slice_bytes(NKB, DH)) +
                  (tn * kRows + j) * P + c;
      const long long at = bytes ? b * sst[tn].b + h * sst[tn].h + j * sst[tn].s + c : 0;
      cp_async_part(dst, src[tn] + at, bytes);
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
  const bf16* q_s = reinterpret_cast<const bf16*>(smem + sl * tc_slice_bytes(NKB, DH));
  const bf16* k_s = q_s + kRows * P;
  const bf16* v_s = k_s + kRows * P;
  const bf16* g_s = v_s + kRows * P;
  // each query row's m * scale * log2(e), 1 / l (0 past S) and D
  float* mc_s = reinterpret_cast<float*>(const_cast<bf16*>(g_s + kRows * P));
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

    unsigned af[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) ldmatrix_a<P>(af[kk], q_s + r0 * P + kk * 16, lane);
    float s[NKB][2][4];
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int kb = 0; kb < NKB; ++kb) {
      if (kb >= n_live) continue;
      mma_abt<P>(s[kb], af, k_s + kb * 16 * P, lane);
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
    for (int kk = 0; kk < KS; ++kk) ldmatrix_a<P>(af[kk], g_s + r0 * P + kk * 16, lane);
    float dp[NKB][2][4];
    float dsum[2] = {0.f, 0.f};
#pragma unroll
    for (int kb = 0; kb < NKB; ++kb) {
      if (kb >= n_live) continue;
      mma_abt<P>(dp[kb], af, v_s + kb * 16 * P, lane);
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
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
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
      mma_ab2<P>(acc, ha, la, k_s + kb * 16 * P, lane);
    }
    store_tile_rows<FULL>(dq + b * dqs.b + h * dqs.h, dqs.s, acc, scale, ra, rb,
                        live && ra < S, live && rb < S, Dh, pairs, t);
  }
  __syncthreads();

  // --- pass B: the warp's 16 key rows ---
  {
    const int c0 = tile * 16;
    const int ja = c0 + g, jb = ja + 8;       // this thread's two keys
    const float c = scale * 1.4426950408889634f;
    float av[NT][4], ak[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) av[nt][e] = ak[nt][e] = 0.f;
    for (int qt = causal ? tile : 0; qt < NKB; ++qt) {
      // P^T and dP^T of keys c0.. x queries qt*16 + nt*8 + 2t (+1), as pass A
      // made them; keys >= S give rows that are never stored
      float st[2][4], dpt[2][4];
      {
        unsigned af[KS][4];      // reloaded each tile: fewer live registers
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) ldmatrix_a<P>(af[kk], k_s + c0 * P + kk * 16, lane);
        mma_abt<P>(st, af, q_s + qt * 16 * P, lane);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) ldmatrix_a<P>(af[kk], v_s + c0 * P + kk * 16, lane);
        mma_abt<P>(dpt, af, g_s + qt * 16 * P, lane);
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
      mma_ab<P>(av, pa, g_s + qt * 16 * P, lane);
      mma_ab2<P>(ak, ha, la, q_s + qt * 16 * P, lane);
    }
    const bool in_a = live && ja < S, in_b = live && jb < S;
    store_tile_rows<FULL>(dv + b * dvs.b + h * dvs.h, dvs.s, av, 1.f, ja, jb, in_a, in_b, Dh,
                        pairs, t);
    store_tile_rows<FULL>(dk + b * dks.b + h * dks.h, dks.s, ak, scale, ja, jb, in_a, in_b, Dh,
                        pairs, t);
  }
}

template <int NKB, int DH, bool FULL>
int launch_tc_kernel(const void* q, const void* k, const void* v, const void* dout, void* dq,
                     void* dk, void* dv, int BH, int H, int S, int Dh, const Strides* st,
                     int causal, float scale, int pairs, cudaStream_t stream) {
  static int smem_set[64];
  const Plan p = tc_plan(16 * NKB, DH);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(attention_bwd_tc<NKB, DH, FULL>),
                               p.smem_bytes, smem_set);
  if (err != cudaSuccess) return err;
  attention_bwd_tc<NKB, DH, FULL><<<(BH + p.slices - 1) / p.slices, 32 * p.warps,
                                    p.smem_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), BH, H, S, Dh, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      causal, scale, pairs);
  return cudaGetLastError();
}

// The resident kernel of NKB key tiles at width DH for a head of Dh <= DH.
template <int NKB, int DH>
int launch_tc(const void* q, const void* k, const void* v, const void* dout, void* dq,
              void* dk, void* dv, int BH, int H, int S, int Dh, const Strides* st, int causal,
              float scale, cudaStream_t stream) {
  int pairs = Dh % 2 == 0;
  const void* out[3] = {dq, dk, dv};
  for (int i = 0; i < 3; ++i)
    pairs = pairs && reinterpret_cast<unsigned long long>(out[i]) % 4 == 0 &&
            st[4 + i].b % 2 == 0 && st[4 + i].s % 2 == 0 && st[4 + i].h % 2 == 0;
  return Dh == DH && pairs
             ? launch_tc_kernel<NKB, DH, true>(q, k, v, dout, dq, dk, dv, BH, H, S, Dh, st,
                                               causal, scale, pairs, stream)
             : launch_tc_kernel<NKB, DH, false>(q, k, v, dout, dq, dk, dv, BH, H, S, Dh, st,
                                                causal, scale, pairs, stream);
}

// --- streamed bf16 kernels (S > kMaxSeq) ------------------------------------

constexpr int kMt = 1;                            // 16-row tiles a warp (two spilled)
constexpr int kWarpRows = 16 * kMt;
constexpr int kStreamWarps = 4;                   // warps a block
constexpr int kStreamRows = kWarpRows * kStreamWarps;   // query (dq) or key (dkv) rows a block
constexpr int kChunk = 64;                        // rows a ring stage
constexpr int kStages = 3;
constexpr int kTileBytes = kChunk * kHeadDim * static_cast<int>(sizeof(bf16));   // 8 KB
// 1024-byte aligned: the ring (two swizzled tiles a stage: dq's K and V,
// dkv's q and dO), the block's own rows (dq: q and dO; dkv: K and V, in
// 144-byte rows), the barriers, dkv's three statistics a streamed row
constexpr int kDqSmem = 1024 + kStages * 2 * kTileBytes +
                        2 * kStreamRows * kTcPitch * static_cast<int>(sizeof(bf16)) +
                        kStages * static_cast<int>(sizeof(unsigned long long));
constexpr int kDkvSmem = kDqSmem + kStages * 3 * kChunk * static_cast<int>(sizeof(float));

// Workspace rows a (batch, head) per statistic: the query rows of its tiles.
__host__ __device__ constexpr int stream_rows(int S) { return (S + 15) / 16 * 16; }

// The A fragments of d = hi + lo, hi = d rounded to bf16 and lo = d - hi
// rounded, for one 16-column tile of d in accumulator layout.
__device__ __forceinline__ void split_bf16(const float (&d)[2][4], unsigned (&ha)[4],
                                           unsigned (&la)[4]) {
  float hi[2][4], lo[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[nt][e] = round_bf16(d[nt][e]);
      lo[nt][e] = d[nt][e] - hi[nt][e];
    }
  ha[0] = pack_bf16(hi[0][0], hi[0][1]);
  ha[1] = pack_bf16(hi[0][2], hi[0][3]);
  ha[2] = pack_bf16(hi[1][0], hi[1][1]);
  ha[3] = pack_bf16(hi[1][2], hi[1][3]);
  la[0] = pack_bf16(lo[0][0], lo[0][1]);
  la[1] = pack_bf16(lo[0][2], lo[0][3]);
  la[2] = pack_bf16(lo[1][0], lo[1][1]);
  la[3] = pack_bf16(lo[1][2], lo[1][3]);
}

// dq: the block's warps each own 32 query rows of one (batch, head), their
// q and dO rows in shared memory; K and V stream through a kStages-stage
// cp.async ring twice, which the block's threads fill kStages - 1 chunks
// ahead.
__global__ void __launch_bounds__(32 * kStreamWarps, 3)
attention_bwd_tc_dq(const bf16* __restrict__ q, const bf16* __restrict__ dout,
                    bf16* __restrict__ dq, float* __restrict__ stats, int H, int S,
                    Strides qs, Strides gs, Strides dqs, int causal, float scale,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, TileCoords k_tc,
                    TileCoords v_tc) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<unsigned long long>(smem_raw) + 1023) & ~1023ull);
  bf16* q_s = reinterpret_cast<bf16*>(ring + kStages * 2 * kTileBytes);
  bf16* g_s = q_s + kStreamRows * kTcPitch;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(g_s + kStreamRows * kTcPitch);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int units = (S + kWarpRows - 1) / kWarpRows;
  const int u_first = tile_begin(blockIdx.y, gridDim.y, units);
  const int u_end = tile_begin(blockIdx.y + 1, gridDim.y, units);
  const int block_keys = causal ? min(S, u_end * kWarpRows) : S;
  const int n_chunks = (block_keys + kChunk - 1) / kChunk;
  const int total = 2 * n_chunks;                   // sweep 0's chunks, then sweep 1's
  auto load = [&](int it) {                         // thread 0: K and V of chunk it
    const int st = it % kStages, j0 = (it % n_chunks) * kChunk;
    mbar_arrive_tx(&full[st], 2 * kTileBytes);
    tma_tile(ring + st * 2 * kTileBytes, k_map, k_tc, j0, h, b, &full[st]);
    tma_tile(ring + st * 2 * kTileBytes + kTileBytes, v_map, v_tc, j0, h, b, &full[st]);
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&full[st], 1);
    mbar_fence_init();
    for (int i = 0; i < kStages - 1 && i < total; ++i) load(i);
  }
  const int rows0 = u_first * kWarpRows, n_rows = (u_end - u_first) * kWarpRows;
  rows_async(q_s, q + b * qs.b + h * qs.h, qs.s, rows0, n_rows, S);
  rows_async(g_s, dout + b * gs.b + h * gs.h, gs.s, rows0, n_rows, S);
  cp_async_commit();
  cp_async_wait<0>();

  const int g = lane / 4, t = lane % 4;
  const int unit = u_first + warp;
  const bool live = unit < u_end;
  const int r0 = unit * kWarpRows;
  const bf16* q_rows = q_s + warp * kWarpRows * kTcPitch;
  const bf16* g_rows = g_s + warp * kWarpRows * kTcPitch;
  int lim[kMt][2];                                  // keys < lim are live for the row
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      lim[mt][half] = causal ? min(S, r0 + mt * 16 + g + 8 * half + 1) : S;
  const int lim_warp = causal ? min(S, r0 + 1) : S;
  const int warp_keys = !live ? 0 : causal ? min(S, r0 + kWarpRows) : S;
  const float c = scale * 1.4426950408889634f;

  // Sweep 0: each row's max m, sum l and D = sum P round(dP), the last two
  // rescaled together as m grows (32 keys at a time); then m becomes m c,
  // l becomes 1 / l and D is divided by l.  Sweep 1: dS = P (dP - D) into dQ.
  float m[kMt][2], l[kMt][2], dsum[kMt][2], acc[kMt][8][4];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      m[mt][half] = -CUDART_INF_F;
      l[mt][half] = dsum[mt][half] = 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }

  for (int it = 0; it < total; ++it) {
    __syncthreads();                                // every thread is done with it - 1
    if (threadIdx.x == 0 && it + kStages - 1 < total) load(it + kStages - 1);  // into its stage
    if (it == n_chunks) {                           // sweep 0's statistics
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            l[mt][half] += __shfl_xor_sync(kFullMask, l[mt][half], off);
            dsum[mt][half] += __shfl_xor_sync(kFullMask, dsum[mt][half], off);
          }
          // rows >= S (and a warp with no rows): P = 0, and a finite mc for dkv
          const bool row_live = live && r0 + mt * 16 + g + 8 * half < S;
          m[mt][half] = row_live ? m[mt][half] * c : 0.f;
          l[mt][half] = row_live ? 1.f / l[mt][half] : 0.f;
          dsum[mt][half] *= l[mt][half];
        }
    }
    const int chunk0 = (it % n_chunks) * kChunk;
    if (chunk0 >= warp_keys) continue;              // warp-uniform
    mbar_wait(&full[it % kStages], (it / kStages) & 1);
    const unsigned char* kc = ring + (it % kStages) * 2 * kTileBytes;
    const unsigned char* vc = kc + kTileBytes;
    const bool masked = chunk0 + kChunk > lim_warp;    // some key reaches a row's limit
    if (it < n_chunks) {
#pragma unroll
      for (int hk = 0; hk < 2; ++hk) {              // 32 keys at a time
        const int k32 = chunk0 + hk * 32;
        float s[kMt][2][2][4], dp[kMt][2][2][4];
        mma_abt_tiles<kTcPitch, kMt, 2>(s, q_rows, kc, hk * 32, lane);
        mma_abt_tiles<kTcPitch, kMt, 2>(dp, g_rows, vc, hk * 32, lane);
        if (masked) {
#pragma unroll
          for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
            for (int kt = 0; kt < 2; ++kt)
#pragma unroll
              for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  if (k32 + kt * 16 + nt * 8 + 2 * t + (e % 2) >= lim[mt][e / 2])
                    s[mt][kt][nt][e] = -CUDART_INF_F;
        }
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float x = -CUDART_INF_F;
#pragma unroll
            for (int kt = 0; kt < 2; ++kt)
#pragma unroll
              for (int nt = 0; nt < 2; ++nt)
                x = fmaxf(x, fmaxf(s[mt][kt][nt][2 * half], s[mt][kt][nt][2 * half + 1]));
            x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
            x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
            const float mn = fmaxf(m[mt][half], x);
            const float mcr = mn == -CUDART_INF_F ? 0.f : mn * c;   // no live key yet
            const float alpha = exp2_ftz(fmaf(m[mt][half], c, -mcr));
            float sum = l[mt][half] * alpha, dd = dsum[mt][half] * alpha;
#pragma unroll
            for (int kt = 0; kt < 2; ++kt)
#pragma unroll
              for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int e = 2 * half; e < 2 * half + 2; ++e) {
                  const float p = exp2_ftz(fmaf(s[mt][kt][nt][e], c, -mcr));
                  sum += p;
                  dd = fmaf(p, round_bf16(dp[mt][kt][nt][e]), dd);
                }
            l[mt][half] = sum;
            dsum[mt][half] = dd;
            m[mt][half] = mn;
          }
      }
      continue;
    }
#pragma unroll
    for (int kt = 0; kt < kChunk / 16; ++kt) {
      float s[kMt][1][2][4], dp[kMt][1][2][4];
      mma_abt_tiles<kTcPitch, kMt, 1>(s, q_rows, kc, kt * 16, lane);
      mma_abt_tiles<kTcPitch, kMt, 1>(dp, g_rows, vc, kt * 16, lane);
      // dS = P (round(dP) - D), P = exp2(c s - mc) / l (0 past a row's
      // limit), as hi + lo bf16 terms into dQ
      unsigned ha[kMt][4], la[kMt][4];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        float d[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2_ftz(fmaf(s[mt][0][nt][e], c, -m[mt][e / 2])) * l[mt][e / 2];
            if (masked && chunk0 + kt * 16 + nt * 8 + 2 * t + (e % 2) >= lim[mt][e / 2]) p = 0.f;
            d[nt][e] = p * (round_bf16(dp[mt][0][nt][e]) - dsum[mt][e / 2]);
          }
        split_bf16(d, ha[mt], la[mt]);
      }
      mma_ab2_tiles<kMt>(acc, ha, la, kc, kt * 16, lane);
    }
  }
  if (!live) return;

  const int pitch = stream_rows(S);
  float* st = stats + static_cast<long long>(bh) * 3 * pitch;
  bf16* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
    const int ra = r0 + mt * 16 + g, rb = ra + 8;
    if (t == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? rb : ra;
        st[r] = m[mt][half];
        st[pitch + r] = l[mt][half];
        st[2 * pitch + r] = dsum[mt][half];
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int d = nt * 8 + 2 * t;
      if (ra < S)
        *reinterpret_cast<unsigned*>(dqb + ra * dqs.s + d) =
            pack_bf16(acc[mt][nt][0] * scale, acc[mt][nt][1] * scale);
      if (rb < S)
        *reinterpret_cast<unsigned*>(dqb + rb * dqs.s + d) =
            pack_bf16(acc[mt][nt][2] * scale, acc[mt][nt][3] * scale);
    }
  }
}

// dkv: the block's warps each own 32 key rows of one (batch, head), their K
// and V rows in shared memory; the query rows (from the block's first key
// when causal) stream through the ring with their dO rows and statistics.
__global__ void __launch_bounds__(32 * kStreamWarps, 3)
attention_bwd_tc_dkv(const bf16* __restrict__ k, const bf16* __restrict__ v,
                     bf16* __restrict__ dk, bf16* __restrict__ dv,
                     const float* __restrict__ stats, int H, int S, Strides ks, Strides vs,
                     Strides dks, Strides dvs, int causal, float scale,
                     const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap g_map, TileCoords q_tc,
                     TileCoords g_tc) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<unsigned long long>(smem_raw) + 1023) & ~1023ull);
  bf16* k_s = reinterpret_cast<bf16*>(ring + kStages * 2 * kTileBytes);
  bf16* v_s = k_s + kStreamRows * kTcPitch;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(v_s + kStreamRows * kTcPitch);
  float* st_s = reinterpret_cast<float*>(full + kStages);   // three statistics a row a stage

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int units = (S + kWarpRows - 1) / kWarpRows;
  const int u_first = tile_begin(blockIdx.y, gridDim.y, units);
  const int u_end = tile_begin(blockIdx.y + 1, gridDim.y, units);
  // query rows from q0: when causal no earlier row sees the block's keys
  const int q0 = causal ? u_first * kWarpRows : 0;
  const int n_chunks = (S - q0 + kChunk - 1) / kChunk;
  const int pitch = stream_rows(S);
  const float* sb = stats + static_cast<long long>(bh) * 3 * pitch;
  auto load = [&](int it) {                         // thread 0: q and dO of chunk it
    const int st = it % kStages, i0 = q0 + it * kChunk;
    mbar_arrive_tx(&full[st], 2 * kTileBytes);
    tma_tile(ring + st * 2 * kTileBytes, q_map, q_tc, i0, h, b, &full[st]);
    tma_tile(ring + st * 2 * kTileBytes + kTileBytes, g_map, g_tc, i0, h, b, &full[st]);
  };
  auto load_stats = [&](int it) {                   // every thread: mc, 1 / l and D, 0 past S
    const int i0 = q0 + it * kChunk;
    float* dst = st_s + (it % kStages) * 3 * kChunk;
    for (int e = threadIdx.x; e < 3 * kChunk; e += blockDim.x) {
      const int which = e / kChunk, i = i0 + e % kChunk;
      const bool in = i < S;
      cp_async4(dst + e, sb + which * pitch + (in ? i : 0), in);
    }
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&full[st], 1);
    mbar_fence_init();
    for (int i = 0; i < kStages - 1 && i < n_chunks; ++i) load(i);
  }
  const int rows0 = u_first * kWarpRows, n_rows = (u_end - u_first) * kWarpRows;
  rows_async(k_s, k + b * ks.b + h * ks.h, ks.s, rows0, n_rows, S);
  rows_async(v_s, v + b * vs.b + h * vs.h, vs.s, rows0, n_rows, S);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {           // the first chunks' statistics
    if (i < n_chunks) load_stats(i);
    cp_async_commit();
  }

  const int g = lane / 4, t = lane % 4;
  const int unit = u_first + warp;
  const bool live = unit < u_end;
  const int c0 = unit * kWarpRows;                  // the warp's keys
  const bf16* k_rows = k_s + warp * kWarpRows * kTcPitch;
  const bf16* v_rows = v_s + warp * kWarpRows * kTcPitch;
  const float c = scale * 1.4426950408889634f;
  float av[kMt][8][4], ak[kMt][8][4];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) av[mt][nt][e] = ak[mt][nt][e] = 0.f;

  for (int it = 0; it < n_chunks; ++it) {
    cp_async_wait<kStages - 2>();                   // chunk it's statistics have landed
    __syncthreads();                                // ... for every thread; it - 1 is done
    if (it + kStages - 1 < n_chunks) {              // into it - 1's stage
      if (threadIdx.x == 0) load(it + kStages - 1);
      load_stats(it + kStages - 1);
    }
    cp_async_commit();
    if (!live) continue;
    mbar_wait(&full[it % kStages], (it / kStages) & 1);
    const unsigned char* qc = ring + (it % kStages) * 2 * kTileBytes;
    const unsigned char* gc = qc + kTileBytes;
    const float* mc_s = st_s + (it % kStages) * 3 * kChunk;
    const float* il_s = mc_s + kChunk;
    const float* d_s = il_s + kChunk;
#pragma unroll
    for (int qt = 0; qt < kChunk / 16; ++qt) {
      const int i0 = q0 + it * kChunk + qt * 16;
      // warp-uniform: no live query, or every query before every key
      if (i0 >= S || (causal && i0 + 15 < c0)) continue;
      // P^T and dP^T of the warp's keys x queries i0 + nt*8 + 2t (+1), as
      // dq made them; keys >= S give rows that are never stored
      float stt[kMt][1][2][4], dpt[kMt][1][2][4];
      mma_abt_tiles<kTcPitch, kMt, 1>(stt, k_rows, qc, qt * 16, lane);
      mma_abt_tiles<kTcPitch, kMt, 1>(dpt, v_rows, gc, qt * 16, lane);
      const bool diag = causal && i0 < c0 + kWarpRows;   // a key after a query
      float2 mc[2], il[2], dd[2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int ic = qt * 16 + nt * 8 + 2 * t;    // index in the chunk
        mc[nt] = *reinterpret_cast<const float2*>(mc_s + ic);
        il[nt] = *reinterpret_cast<const float2*>(il_s + ic);
        dd[nt] = *reinterpret_cast<const float2*>(d_s + ic);
      }
      unsigned pa[kMt][4], ha[kMt][4], la[kMt][4];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        const int ja = c0 + mt * 16 + g;
        float p[2][4], d[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool odd = e % 2;
            float pv = exp2_ftz(fmaf(stt[mt][0][nt][e], c, -(odd ? mc[nt].y : mc[nt].x))) *
                       (odd ? il[nt].y : il[nt].x);
            if (diag && ja + (e < 2 ? 0 : 8) > i0 + nt * 8 + 2 * t + odd) pv = 0.f;
            p[nt][e] = pv;
            d[nt][e] = pv * (round_bf16(dpt[mt][0][nt][e]) - (odd ? dd[nt].y : dd[nt].x));
          }
        pa[mt][0] = pack_bf16(p[0][0], p[0][1]);
        pa[mt][1] = pack_bf16(p[0][2], p[0][3]);
        pa[mt][2] = pack_bf16(p[1][0], p[1][1]);
        pa[mt][3] = pack_bf16(p[1][2], p[1][3]);
        split_bf16(d, ha[mt], la[mt]);
      }
      mma_ab_tiles<kMt>(av, pa, gc, qt * 16, lane);
      mma_ab2_tiles<kMt>(ak, ha, la, qc, qt * 16, lane);
    }
  }
  if (!live) return;
  bf16* dvb = dv + b * dvs.b + h * dvs.h;
  bf16* dkb = dk + b * dks.b + h * dks.h;
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
    const int ja = c0 + mt * 16 + g, jb = ja + 8;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int d = nt * 8 + 2 * t;
      if (ja < S) {
        *reinterpret_cast<unsigned*>(dvb + ja * dvs.s + d) =
            pack_bf16(av[mt][nt][0], av[mt][nt][1]);
        *reinterpret_cast<unsigned*>(dkb + ja * dks.s + d) =
            pack_bf16(ak[mt][nt][0] * scale, ak[mt][nt][1] * scale);
      }
      if (jb < S) {
        *reinterpret_cast<unsigned*>(dvb + jb * dvs.s + d) =
            pack_bf16(av[mt][nt][2], av[mt][nt][3]);
        *reinterpret_cast<unsigned*>(dkb + jb * dks.s + d) =
            pack_bf16(ak[mt][nt][2] * scale, ak[mt][nt][3] * scale);
      }
    }
  }
}

int launch_tc_stream(const void* q, const void* k, const void* v, const void* dout, void* dq,
                     void* dk, void* dv, int BH, int H, int S, const Strides* st, int causal,
                     float scale, float* stats, cudaStream_t stream) {
  static int dq_set[64], dkv_set[64];
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(attention_bwd_tc_dq), kDqSmem,
                               dq_set);
  if (err == cudaSuccess)
    err = allow_smem(reinterpret_cast<const void*>(attention_bwd_tc_dkv), kDkvSmem, dkv_set);
  if (err != cudaSuccess) return err;
  // the streamed tiles: K and V (dq), q and dO (dkv)
  CUtensorMap maps[4];
  TileCoords tcs[4];
  const void* base[4] = {k, v, q, dout};
  const int which[4] = {1, 2, 0, 3};                // their strides' places in st
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
    const Strides& s = st[which[i]];
    err = tile_map(&maps[i], &tcs[i], base[i], BH / H, H, S, s.s, s.h, s.b);
  }
  if (err != cudaSuccess) return err;
  // a block per (batch, head) and kStreamWarps 16-row tiles of its query
  // (dq) or key (dkv) rows, as even as the tiles allow
  const int tiles = (S + 15) / 16;
  const dim3 grid(BH, (tiles + kStreamWarps - 1) / kStreamWarps);
  attention_bwd_tc_dq<<<grid, 32 * kStreamWarps, kDqSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
      stats, H, S, st[0], st[3], st[4], causal, scale, maps[0], maps[1], tcs[0], tcs[1]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_tc_dkv<<<grid, 32 * kStreamWarps, kDkvSmem, stream>>>(
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), stats, H, S, st[1], st[2], st[5], st[6], causal, scale, maps[2],
      maps[3], tcs[2], tcs[3]);
  return cudaGetLastError();
}

// --- f32 kernels: products on tensor cores in three TF32 terms ---------------

constexpr int kF32Warps = 4;                      // warps a block at most
constexpr int kF32Pitch = kHeadDim + 4;           // floats a shared row (= 4 mod 32)
constexpr int kF32Chunk = 64;                     // rows a ring stage
constexpr int kF32Sub = 32;                       // keys (dq) or queries (dkv) a register tile
constexpr int kF32NT = kF32Sub / 8;
constexpr int kF32KK = kHeadDim / 8;

// Above kF32Chunk keys the streamed launches: `splits` warps take each
// 16-row tile in turn, one 32-row sub-tile of every stage each (a stage of
// 128 rows at four splits, else 64), and merge in a fixed order at the end.
__host__ __device__ constexpr int f32_stage_rows(int splits) {
  return splits == 4 ? 2 * kF32Chunk : kF32Chunk;
}

// Dynamic shared memory of the streamed launches at `splits` and `tiles`:
// dq holds its tiles' q and dO rows, a ring of K and V and the splits'
// statistics; dkv its keys' K and V and a ring of q, dO and statistics.
constexpr int f32_dq_smem(int splits, int tiles) {
  return (32 * tiles * kF32Pitch + 4 * f32_stage_rows(splits) * kF32Pitch +
          (splits > 1 ? 6 * 32 * splits * tiles : 0)) * static_cast<int>(sizeof(float));
}

constexpr int f32_dkv_smem(int splits, int tiles) {
  return (32 * tiles * kF32Pitch + 2 * f32_stage_rows(splits) * (2 * kF32Pitch + 3)) *
         static_cast<int>(sizeof(float));
}

struct F32Plan {
  int tiles, warps, resident, smem_bytes;
};

// One design at every S: a block takes `warps` 16-row tiles of one (batch,
// head) (as many as make its blocks even, at most kF32Warps).  S <= kF32Chunk:
// one launch holds q, k, v and dO of the (batch, head) and three statistics a
// row.  Above: a dq launch streams K and V through a two-stage ring and
// writes the statistics to the workspace; a dkv launch holds its keys' K and
// V and streams q, dO and the statistics.  smem_bytes is the larger launch's
// (dkv's) with no split.
F32Plan f32_plan(int S) {
  const int n = (S + 15) / 16;
  const int by = (n + kF32Warps - 1) / kF32Warps;
  const int w = (n + by - 1) / by;
  if (S <= kF32Chunk)
    return F32Plan{n, w, 1, 16 * n * (4 * kF32Pitch + 3) * static_cast<int>(sizeof(float))};
  return F32Plan{n, w, 0, f32_dkv_smem(1, w)};
}

// Rows j0 .. j0 + rows - 1 of two (batch, head) operands into 68-float rows
// (zero past S): 16-byte cp.async where rows are 16-byte aligned (vec).
__device__ __forceinline__ void f32_load_rows(float* a_dst, float* b_dst, const float* a,
                                              const float* b, long long as, long long bs,
                                              int j0, int rows, int S, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < rows * (kHeadDim / 4); e += blockDim.x) {
      const int j = e / (kHeadDim / 4), d = e % (kHeadDim / 4) * 4;
      const bool in = j0 + j < S;
      const long long js = in ? j0 + j : 0;
      cp_async16(a_dst + j * kF32Pitch + d, a + js * as + d, in);
      cp_async16(b_dst + j * kF32Pitch + d, b + js * bs + d, in);
    }
  } else {
    for (int e = threadIdx.x; e < rows * kHeadDim; e += blockDim.x) {
      const int j = e / kHeadDim, d = e % kHeadDim;
      const bool in = j0 + j < S;
      const long long js = in ? j0 + j : 0;
      cp_async4(a_dst + j * kF32Pitch + d, a + js * as + d, in);
      cp_async4(b_dst + j * kF32Pitch + d, b + js * bs + d, in);
    }
  }
}

// s[nt] = A B^T for A the 16 rows at `a_rows` and B the 8-row blocks nt of
// `b_rows` (nt < n_live), all in shared memory.
__device__ __forceinline__ void f32_abt(float (&s)[kF32NT][4], const float* a_rows,
                                        const float* b_rows, int n_live, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < kF32NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kF32KK; ++kk) {
    unsigned ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_tf32(a_rows[(g + (e % 2) * 8) * kF32Pitch + kk * 8 + t + (e / 2) * 4], ah[e], al[e]);
    unsigned bh[kF32NT][2], bl[kF32NT][2];
#pragma unroll
    for (int nt = 0; nt < kF32NT; ++nt)
      if (nt < n_live)
        b_frag_rows(bh[nt], bl[nt], b_rows + nt * 8 * kF32Pitch + kk * 8, kF32Pitch, g, t);
    mma_3xtf32<kF32NT>(s, ah, al, bh, bl, n_live);
  }
}

// acc += C B for C the 16 x (8 n_live) tile `c` and B the rows of `rows`.
__device__ __forceinline__ void f32_cb(float (&acc)[kF32KK][4], const float (&c)[kF32NT][4],
                                       const float* rows, int n_live, int g, int t) {
#pragma unroll
  for (int kt = 0; kt < kF32NT; ++kt) {
    if (kt < n_live) {
      unsigned ah[4], al[4];
      c_to_a(c[kt], ah, al);
#pragma unroll
      for (int n0 = 0; n0 < kF32KK; n0 += 4) {
        unsigned bh[4][2], bl[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b_frag_cols(bh[j], bl[j], rows + kt * 8 * kF32Pitch + (n0 + j) * 8, kF32Pitch, g, t);
        mma_3xtf32<4>(acc + n0, ah, al, bh, bl, 4);
      }
    }
  }
}

__device__ __forceinline__ void f32_store_rows(float* base, long long stride,
                                               const float (&acc)[kF32KK][4], float mul, int ra,
                                               int rb, int S, int t) {
#pragma unroll
  for (int nd = 0; nd < kF32KK; ++nd) {
    const int d = nd * 8 + 2 * t;
    if (ra < S)
      *reinterpret_cast<float2*>(base + ra * stride + d) =
          make_float2(acc[nd][0] * mul, acc[nd][1] * mul);
    if (rb < S)
      *reinterpret_cast<float2*>(base + rb * stride + d) =
          make_float2(acc[nd][2] * mul, acc[nd][3] * mul);
  }
}

// One warp's 16 query rows r0 .. r0 + 15 of dq.  Two sweeps over the keys:
// the first takes the rows' max m, sum l and D = sum P dP together (online
// rescaling: D accumulates exp(s - m) dP beside l), the second dS = P (dP - D)
// into dQ = scale dS K.
struct F32Dq {
  float acc[kF32KK][4];
  float m[2], l[2], dd[2], mc[2], inv_l[2], dsum[2];
  int ra, rb, lim_a, lim_b, lim_warp, keys;

  __device__ __forceinline__ void init(int r0, int S, int causal, int g) {
    ra = r0 + g;
    rb = ra + 8;
    lim_a = causal ? min(S, ra + 1) : S;
    lim_b = causal ? min(S, rb + 1) : S;
    lim_warp = causal ? min(S, r0 + 1) : S;
    keys = r0 >= S ? 0 : (causal ? min(S, r0 + 16) : S);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = -CUDART_INF_F;
      l[h] = dd[h] = mc[h] = inv_l[h] = dsum[h] = 0.f;
    }
#pragma unroll
    for (int nd = 0; nd < kF32KK; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  }

  // The 32 keys from key0: the warp's q and dO rows and the keys' K and V
  // rows in shared memory.
  __device__ __forceinline__ void sub(int sweep, const float* q_rows, const float* g_rows,
                                      const float* k_rows, const float* v_rows, int key0,
                                      float c, int g, int t) {
    const int n_live = min(kF32NT, (keys - key0 + 7) / 8);
    if (n_live <= 0) return;                           // warp-uniform
    float s[kF32NT][4], dp[kF32NT][4];
    f32_abt(s, q_rows, k_rows, n_live, g, t);
    f32_abt(dp, g_rows, v_rows, n_live, g, t);
    const bool masked = key0 + kF32Sub > lim_warp;
    bool live[kF32NT][4];
#pragma unroll
    for (int nt = 0; nt < kF32NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        live[nt][e] = nt < n_live &&
                      !(masked && key0 + nt * 8 + 2 * t + e % 2 >= (e < 2 ? lim_a : lim_b));
    if (sweep == 0) {
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int nt = 0; nt < kF32NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (live[nt][e]) mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
      float mcs[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFullMask, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFullMask, mx[h], 2));
        const float mn = fmaxf(m[h], mx[h]);
        mcs[h] = mn == -CUDART_INF_F ? 0.f : mn * c;   // no live key yet: add nothing
        const float alpha = exp2f(fmaf(m[h], c, -mcs[h]));
        m[h] = mn;
        l[h] *= alpha;
        dd[h] *= alpha;
      }
#pragma unroll
      for (int nt = 0; nt < kF32NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = live[nt][e] ? exp2f(fmaf(s[nt][e], c, -mcs[e / 2])) : 0.f;
          l[e / 2] += p;
          dd[e / 2] = fmaf(p, dp[nt][e], dd[e / 2]);
        }
      return;
    }
#pragma unroll
    for (int nt = 0; nt < kF32NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = live[nt][e] ? exp2f(fmaf(s[nt][e], c, -mc[e / 2])) * inv_l[e / 2] : 0.f;
        s[nt][e] = p * (dp[nt][e] - dsum[e / 2]);    // dS
      }
    f32_cb(acc, s, k_rows, n_live, g, t);
  }

  // After the first sweep: m * scale * log2(e), 1 / l and D of each row (0
  // past S, where P = 0).
  __device__ __forceinline__ void finish_stats(float c, int S) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l[h] += __shfl_xor_sync(kFullMask, l[h], off);
        dd[h] += __shfl_xor_sync(kFullMask, dd[h], off);
      }
      const bool row_live = (h ? rb : ra) < S;
      mc[h] = row_live ? m[h] * c : 0.f;
      inv_l[h] = row_live ? 1.f / l[h] : 0.f;
      dsum[h] = row_live ? dd[h] / l[h] : 0.f;
    }
  }

  // The statistics into rows ra, rb of three arrays `pitch` floats apart.
  __device__ __forceinline__ void put_stats(float* st, int pitch, int t) const {
    if (t != 0) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? rb : ra;
      st[r] = mc[h];
      st[pitch + r] = inv_l[h];
      st[2 * pitch + r] = dsum[h];
    }
  }
};

// One warp's 16 key rows c0 .. c0 + 15 of dk and dv, their K and V rows at
// k_rows and v_rows in shared memory: per 32 query rows, P^T = exp(k q^T - m)
// / l and dP^T = V dO^T from the rows' statistics, then dV += P^T dO and
// dK += dS^T q.
struct F32Dkv {
  float av[kF32KK][4], ak[kF32KK][4];
  int c0, ja, jb;

  __device__ __forceinline__ void init(int key0, int g) {
    c0 = key0;
    ja = c0 + g;
    jb = ja + 8;
#pragma unroll
    for (int nd = 0; nd < kF32KK; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) av[nd][e] = ak[nd][e] = 0.f;
  }

  // Query rows i0 .. i0 + 31: q_rows and g_rows (q and dO), mc, il and dl
  // their statistics, in shared memory.
  __device__ __forceinline__ void sub(const float* k_rows, const float* v_rows, const float* q_rows,
                      const float* g_rows, const float* mc, const float* il, const float* dl,
                      int i0, int S, int causal, float c, int g, int t) {
    // warp-uniform: no live key, no live query, or every query before every key
    if (c0 >= S || i0 >= S || (causal && i0 + kF32Sub - 1 < c0)) return;
    const int n_live = min(kF32NT, (S - i0 + 7) / 8);
    float p[kF32NT][4], ds[kF32NT][4];
    f32_abt(p, k_rows, q_rows, n_live, g, t);
    f32_abt(ds, v_rows, g_rows, n_live, g, t);
#pragma unroll
    for (int nt = 0; nt < kF32NT; ++nt) {
      const int ic = nt * 8 + 2 * t;                  // the columns' rows
      // read only live blocks: the statistics end at the 16-rounded S
      float2 mq = make_float2(0.f, 0.f), lq = mq, dq2 = mq;
      if (nt < n_live) {
        mq = *reinterpret_cast<const float2*>(mc + ic);
        lq = *reinterpret_cast<const float2*>(il + ic);
        dq2 = *reinterpret_cast<const float2*>(dl + ic);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e % 2;
        const int i = i0 + ic + odd, key = e < 2 ? ja : jb;
        const bool live = nt < n_live && i < S && !(causal && key > i);
        const float pv =
            live ? exp2f(fmaf(p[nt][e], c, -(odd ? mq.y : mq.x))) * (odd ? lq.y : lq.x) : 0.f;
        p[nt][e] = pv;
        ds[nt][e] = pv * (ds[nt][e] - (odd ? dq2.y : dq2.x));
      }
    }
    f32_cb(av, p, g_rows, n_live, g, t);
    f32_cb(ak, ds, q_rows, n_live, g, t);
  }
};

// S <= kF32Chunk: one block a (batch, head) holds q, k, v and dO; warp w
// takes query tile w for dq, then (the statistics in shared memory) key tile
// w for dk and dv.  One launch, no workspace.
__global__ void __launch_bounds__(32 * kF32Warps, 3)
attention_bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, int H,
                  int S, Strides qs, Strides ks, Strides vs, Strides gs, Strides dqs, Strides dks,
                  Strides dvs, int causal, float scale, float c, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = 16 * ((S + 15) / 16);
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + rows * kF32Pitch;
  float* v_s = k_s + rows * kF32Pitch;
  float* g_s = v_s + rows * kF32Pitch;
  float* st_s = g_s + rows * kF32Pitch;              // m c, 1 / l and D, `rows` apart
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  f32_load_rows(q_s, k_s, q + b * qs.b + h * qs.h, k + b * ks.b + h * ks.h, qs.s, ks.s, 0,
                rows, S, vec);
  f32_load_rows(v_s, g_s, v + b * vs.b + h * vs.h, dout + b * gs.b + h * gs.h, vs.s, gs.s, 0,
                rows, S, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int r0 = warp * 16;
  {
    F32Dq w;
    w.init(r0, S, causal, g);
    for (int sweep = 0; sweep < 2; ++sweep) {
#pragma unroll 1
      for (int j0 = 0; j0 < rows; j0 += kF32Sub)
        w.sub(sweep, q_s + r0 * kF32Pitch, g_s + r0 * kF32Pitch, k_s + j0 * kF32Pitch,
              v_s + j0 * kF32Pitch, j0, c, g, t);
      if (sweep == 0) w.finish_stats(c, S);
    }
    w.put_stats(st_s, rows, t);
    f32_store_rows(dq + b * dqs.b + h * dqs.h, dqs.s, w.acc, scale, w.ra, w.rb, S, t);
  }
  __syncthreads();
  F32Dkv w;
  w.init(r0, g);
#pragma unroll 1
  for (int i0 = 0; i0 < rows; i0 += kF32Sub)
      w.sub(k_s + r0 * kF32Pitch, v_s + r0 * kF32Pitch, q_s + i0 * kF32Pitch,
            g_s + i0 * kF32Pitch, st_s + i0, st_s + rows + i0, st_s + 2 * rows + i0, i0, S,
            causal, c, g, t);
  f32_store_rows(dv + b * dvs.b + h * dvs.h, dvs.s, w.av, 1.f, w.ja, w.jb, S, t);
  f32_store_rows(dk + b * dks.b + h * dks.h, dks.s, w.ak, scale, w.ja, w.jb, S, t);
}

// (m, l, D) of the splits of each tile: every split warp merges them in the
// same order into the same values (a barrier: every thread of the block
// calls it).
__device__ __forceinline__ void merge_stats(float (&wm)[2], float (&wl)[2], float (&wdd)[2],
                                            float* xchg, int split, int tile, int tiles,
                                            int splits, float c, int lane) {
  float* mine = xchg + (split * tiles + tile) * 6 * 32 + lane;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mine[h * 32] = wm[h];
    mine[(2 + h) * 32] = wl[h];
    mine[(4 + h) * 32] = wdd[h];
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m = -CUDART_INF_F, l = 0.f, dd = 0.f;
    for (int sp = 0; sp < splits; ++sp)
      m = fmaxf(m, xchg[((sp * tiles + tile) * 6 + h) * 32 + lane]);
    const float mc = m == -CUDART_INF_F ? 0.f : m * c;
    for (int sp = 0; sp < splits; ++sp) {
      const float* x = xchg + (sp * tiles + tile) * 6 * 32 + lane;
      const float f = exp2f(fmaf(x[h * 32], c, -mc));
      l = fmaf(x[(2 + h) * 32], f, l);
      dd = fmaf(x[(4 + h) * 32], f, dd);
    }
    wm[h] = m;
    wl[h] = l;
    wdd[h] = dd;
  }
}

// An accumulator tile through shared memory (32 lanes apart): split warps
// 1.. put theirs after the last stage, split 0 adds them in order.
constexpr int kF32AccFloats = kF32KK * 4 * 32;

__device__ __forceinline__ void put_acc(const float (&acc)[kF32KK][4], float* dst) {
#pragma unroll
  for (int nd = 0; nd < kF32KK; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[(nd * 4 + e) * 32] = acc[nd][e];
}

__device__ __forceinline__ void add_acc(float (&acc)[kF32KK][4], const float* src) {
#pragma unroll
  for (int nd = 0; nd < kF32KK; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] += src[(nd * 4 + e) * 32];
}

// dq: the block's q and dO rows held, K and V through the ring, swept twice
// (a one-stage call keeps them); the statistics go to the workspace.
__global__ void __launch_bounds__(32 * kF32Warps, 3)
attention_bwd_f32_dq(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     float* __restrict__ dq, float* __restrict__ stats, int H, int S,
                     Strides qs, Strides ks, Strides vs, Strides gs, Strides dqs, int causal,
                     float scale, float c, int vec, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = f32_stage_rows(splits);
  const int stage = rows * kF32Pitch;                // floats of K (then V) a stage
  const int tiles = blockDim.x / 32 / splits;
  float* q_s = reinterpret_cast<float*>(smem);       // the block's q and dO rows
  float* g_s = q_s + 16 * tiles * kF32Pitch;
  float* ring = g_s + 16 * tiles * kF32Pitch;
  float* xchg = ring + 4 * stage;                    // the splits' statistics
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int tile = warp % tiles, split = warp / tiles;
  const int r0 = (blockIdx.y * tiles + tile) * 16;
  const int block_keys = causal ? min(S, (blockIdx.y + 1) * tiles * 16) : S;
  const int n_chunks = (block_keys + rows - 1) / rows;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  F32Dq w;
  w.init(r0, S, causal, g);
  f32_load_rows(q_s, g_s, q + b * qs.b + h * qs.h, dout + b * gs.b + h * gs.h, qs.s, gs.s,
                blockIdx.y * tiles * 16, 16 * tiles, S, vec);
  for (int sweep = 0; sweep < 2; ++sweep) {
    if (sweep == 0 || n_chunks > 1) {
      f32_load_rows(ring, ring + stage, kb, vb, ks.s, vs.s, 0, rows, S, vec);
      cp_async_commit();
    }
    for (int ch = 0; ch < n_chunks; ++ch) {
      if (ch + 1 < n_chunks) {
        float* next = ring + ((ch + 1) & 1) * 2 * stage;
        f32_load_rows(next, next + stage, kb, vb, ks.s, vs.s, (ch + 1) * rows, rows, S, vec);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* k_st = ring + (ch & 1) * 2 * stage;
#pragma unroll 1
      for (int j0 = split * kF32Sub; j0 < rows; j0 += splits * kF32Sub)
        w.sub(sweep, q_s + tile * 16 * kF32Pitch, g_s + tile * 16 * kF32Pitch,
              k_st + j0 * kF32Pitch, k_st + stage + j0 * kF32Pitch, ch * rows + j0, c, g, t);
      __syncthreads();                               // the stage is refilled next
    }
    if (sweep == 0) {
      if (splits > 1) merge_stats(w.m, w.l, w.dd, xchg, split, tile, tiles, splits, c, lane);
      w.finish_stats(c, S);
    }
  }
  if (splits > 1) {                                  // the ring is idle
    if (split > 0) put_acc(w.acc, ring + ((split - 1) * tiles + tile) * kF32AccFloats + lane);
    __syncthreads();
    if (split > 0) return;
    for (int sp = 1; sp < splits; ++sp)
      add_acc(w.acc, ring + ((sp - 1) * tiles + tile) * kF32AccFloats + lane);
  }
  const int pitch = 16 * ((S + 15) / 16);
  if (r0 < S) w.put_stats(stats + static_cast<long long>(bh) * 3 * pitch, pitch, t);
  f32_store_rows(dq + b * dqs.b + h * dqs.h, dqs.s, w.acc, scale, w.ra, w.rb, S, t);
}

// dkv: the block's keys' K and V held, the query rows that see them (from
// the block's first key when causal) streamed with their dO rows and
// statistics through the ring.
__global__ void __launch_bounds__(32 * kF32Warps, 3)
attention_bwd_f32_dkv(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      float* __restrict__ dk, float* __restrict__ dv,
                      const float* __restrict__ stats, int H, int S, Strides qs, Strides ks,
                      Strides vs, Strides gs, Strides dks, Strides dvs, int causal, float scale,
                      float c, int vec, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = f32_stage_rows(splits);
  const int stage = rows * (2 * kF32Pitch + 3);      // q, dO, then m c, 1 / l and D
  const int tiles = blockDim.x / 32 / splits;
  float* k_s = reinterpret_cast<float*>(smem);       // the block's keys
  float* v_s = k_s + 16 * tiles * kF32Pitch;
  float* ring = v_s + 16 * tiles * kF32Pitch;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int tile = warp % tiles, split = warp / tiles;
  const int kb0 = blockIdx.y * tiles * 16;           // the block's first key
  const float* qb = q + b * qs.b + h * qs.h;
  const float* gb = dout + b * gs.b + h * gs.h;
  const int pitch = 16 * ((S + 15) / 16);
  const float* st = stats + static_cast<long long>(bh) * 3 * pitch;
  const int q0 = causal ? kb0 : 0;                   // no earlier query sees the block's keys
  const int n_chunks = (S - q0 + rows - 1) / rows;

  auto load_stage = [&](int ch) {
    float* dst = ring + (ch & 1) * stage;
    const int i0 = q0 + ch * rows;
    f32_load_rows(dst, dst + rows * kF32Pitch, qb, gb, qs.s, gs.s, i0, rows, S, vec);
    float* st_dst = dst + 2 * rows * kF32Pitch;
    for (int e = threadIdx.x; e < 3 * rows; e += blockDim.x) {
      const int which = e / rows, i = i0 + e % rows;
      cp_async4(st_dst + e, st + which * pitch + (i < S ? i : 0), i < S);
    }
  };
  f32_load_rows(k_s, v_s, k + b * ks.b + h * ks.h, v + b * vs.b + h * vs.h, ks.s, vs.s, kb0,
                16 * tiles, S, vec);
  load_stage(0);
  cp_async_commit();

  F32Dkv w;
  w.init(kb0 + tile * 16, g);
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      load_stage(ch + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* q_st = ring + (ch & 1) * stage;
    const float* g_st = q_st + rows * kF32Pitch;
    const float* st_st = g_st + rows * kF32Pitch;
#pragma unroll 1
    for (int j0 = split * kF32Sub; j0 < rows; j0 += splits * kF32Sub)
      w.sub(k_s + tile * 16 * kF32Pitch, v_s + tile * 16 * kF32Pitch, q_st + j0 * kF32Pitch,
            g_st + j0 * kF32Pitch, st_st + j0, st_st + rows + j0, st_st + 2 * rows + j0,
            q0 + ch * rows + j0, S, causal, c, g, t);
    __syncthreads();                                 // the stage is refilled next
  }
  if (splits > 1) {                                  // the ring is idle
    float* x = ring + ((split - 1) * tiles + tile) * 2 * kF32AccFloats + lane;
    if (split > 0) {
      put_acc(w.av, x);
      put_acc(w.ak, x + kF32AccFloats);
    }
    __syncthreads();
    if (split > 0) return;
    for (int sp = 1; sp < splits; ++sp) {
      const float* y = ring + ((sp - 1) * tiles + tile) * 2 * kF32AccFloats + lane;
      add_acc(w.av, y);
      add_acc(w.ak, y + kF32AccFloats);
    }
  }
  f32_store_rows(dv + b * dvs.b + h * dvs.h, dvs.s, w.av, 1.f, w.ja, w.jb, S, t);
  f32_store_rows(dk + b * dks.b + h * dks.h, dks.s, w.ak, scale, w.ja, w.jb, S, t);
}

int launch_f32(const void* q, const void* k, const void* v, const void* dout, void* dq,
               void* dk, void* dv, int BH, int H, int S, const Strides* st, int causal,
               float scale, float* stats, int vec, cudaStream_t stream) {
  static int res_set[64], dq_set[64], dkv_set[64];
  const F32Plan p = f32_plan(S);
  const float c = scale * 1.4426950408889634f;
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *gf = static_cast<const float*>(dout);
  cudaError_t err;
  if (p.resident) {
    err = allow_smem(reinterpret_cast<const void*>(attention_bwd_f32),
                     f32_plan(kF32Chunk).smem_bytes, res_set);
    if (err != cudaSuccess) return err;
    attention_bwd_f32<<<BH, 32 * p.warps, p.smem_bytes, stream>>>(
        qf, kf, vf, gf, static_cast<float*>(dq), static_cast<float*>(dk),
        static_cast<float*>(dv), H, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6], causal,
        scale, c, vec);
    return cudaGetLastError();
  }
  err = allow_smem(reinterpret_cast<const void*>(attention_bwd_f32_dq), f32_dq_smem(4, 1),
                   dq_set);
  if (err == cudaSuccess)
    err = allow_smem(reinterpret_cast<const void*>(attention_bwd_f32_dkv), f32_dkv_smem(4, 1),
                     dkv_set);
  if (err != cudaSuccess) return err;
  // as many tiles a block as make the blocks of a (batch, head) even
  const int splits = key_splits(static_cast<long long>(BH) * p.tiles);
  const int most = kF32Warps / splits;
  const int blocks_y = (p.tiles + most - 1) / most;
  const int tiles = (p.tiles + blocks_y - 1) / blocks_y;
  const dim3 grid(BH, blocks_y);
  attention_bwd_f32_dq<<<grid, 32 * tiles * splits, f32_dq_smem(splits, tiles), stream>>>(
      qf, kf, vf, gf, static_cast<float*>(dq), stats, H, S, st[0], st[1], st[2], st[3], st[4],
      causal, scale, c, vec, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_f32_dkv<<<grid, 32 * tiles * splits, f32_dkv_smem(splits, tiles), stream>>>(
      qf, kf, vf, gf, static_cast<float*>(dk), static_cast<float*>(dv), stats, H, S, st[0],
      st[1], st[2], st[3], st[5], st[6], causal, scale, c, vec, splits);
  return cudaGetLastError();
}

// --- f32 wide-head kernels (f32 above Dh = kHeadDim, tensor cores) ----------

constexpr int kF32WideWarps = 4;    // warps a block at most (two blocks an SM; twice with splits)
constexpr int kF32WideRows = 16;    // keys (dq) or queries (dkv) a warp takes of a stage
constexpr int kF32WideNT = kF32WideRows / 8;

// Floats of a ring stage: the streamed tile's two operands' W chunks (dq: K
// and V; dkv: q and dO) of `tile` rows, at R > 1 the block's `rows` rows of
// its own two operands' W chunks (dq: q and dO; dkv: K and V; at R = 1
// staged once), and dkv's three statistics a streamed row.
__host__ __device__ inline int f32_wide_stage(const F32Wide& sh, int rows, int tile, bool dkv) {
  return sh.W * (2 * tile + (sh.R > 1 ? 2 * rows : 0)) * kF32WidePitch + (dkv ? 3 * tile : 0);
}

// Dynamic shared floats of a block of `tiles` row tiles and `splits`: the
// two-stage ring (or the splits' accumulators, if larger), its own operands
// at R = 1, each warp's two slots of partial products, and dq's splits'
// statistics.
__host__ __device__ inline int f32_wide_floats(const F32Wide& sh, int tiles, int splits, bool dkv) {
  const int rows = 16 * tiles, warps = splits * tiles * sh.W;
  const int ring = 2 * f32_wide_stage(sh, rows, kF32WideRows * splits, dkv);
  const int merge = (splits - 1) * tiles * sh.W * (dkv ? 2 : 1) * kF32AccFloats;
  return (ring > merge ? ring : merge) + (sh.R > 1 ? 0 : 2 * sh.W * rows * kF32WidePitch) +
         warps * 2 * kF32WideNT * 128 + (dkv || splits == 1 ? 0 : warps * 6 * 32);
}

// dq: a block takes `tiles` 16-row query tiles of one (batch, head), as even
// as the tiles allow, W warps a tile, warp w owning chunk z W + w of dq's
// columns (z = blockIdx.z; common.cuh, f32 wide-head attention); where the
// grid is thin (R = 1), `splits` sets of those warps take a tile's keys, set
// s the keys 16 s .. 16 s + 15 of every stage.  K and V stream through a
// two-stage cp.async ring filled one item ahead (one barrier an item) in
// tiles of 16 splits keys (the live keys alone), each over the R rounds
// with the own round last, twice; the block's q and dO rows are staged once
// at R = 1, else with each round.  Each warp takes s = q k^T and dP = dO V^T
// over its chunk of the round (hi.hi apart), and at a tile's last round the
// W shares are summed through shared memory.  The tuned pair's per-element
// arithmetic and splits (F32Dq, merge_stats): sweep 1 takes each row's max
// m, sum l and D = sum P dP with the same online rescaling, the splits
// merging them in a fixed order; sweep 2 forms dS = P (dP - D) into dQ =
// scale dS K over the warp's columns, the splits' sums added in order at
// the end.  The block of round 0 writes m c, 1 / l and D (0 past S) to the
// workspace (3 x BH x S floats).  flags: 1 = q, k, v and dO rows 16-byte
// aligned with Dh a multiple of 4, 2 = dq, dk and dv rows 8-byte aligned
// with an even Dh.
__global__ void __launch_bounds__(64 * kF32WideWarps)
attention_bwd_wide_dq(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      float* __restrict__ dq, float* __restrict__ stats, int BH, int H, int S,
                      int Dh, Strides qs, Strides ks, Strides vs, Strides gs, Strides dqs,
                      int causal, float scale, float c, int flags, int splits) {
  constexpr int P = kF32WidePitch, NT = kF32WideNT;
  extern __shared__ __align__(16) unsigned char smem[];
  const F32Wide sh(Dh);
  const int nd = sh.nd, R = sh.R, W = sh.W, z = blockIdx.z;
  const int tiles = blockDim.x / 32 / W / splits;
  const int T = kF32WideRows * splits;           // keys a stage
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // the warp's chunk of a round, its row tile, its split
  const int wc = warp % W, wt = warp / W % tiles, split = warp / W / tiles;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tiles16 = (S + 15) / 16;
  const int u_first = tile_begin(blockIdx.y, gridDim.y, tiles16);
  const int u_end = tile_begin(blockIdx.y + 1, gridDim.y, tiles16);
  const int r_first = u_first * 16, n_rows = (u_end - u_first) * 16;
  const int rows = 16 * tiles, warps = splits * tiles * W;
  const int block_keys = causal ? min(S, u_end * 16) : S;
  const int n_tiles = (block_keys + T - 1) / T;
  const int per_sweep = n_tiles * R, n_items = 2 * per_sweep;
  const int stage = f32_wide_stage(sh, rows, T, false);
  float* ring = reinterpret_cast<float*>(smem);
  // R = 1: q's chunks, then dO's, after the ring or the splits' hand-over
  float* own_res = ring + max(2 * stage, (splits - 1) * tiles * W * kF32AccFloats);
  float* slots = own_res + (R > 1 ? 0 : 2 * W * rows * P);
  float* xchg = slots + warps * 2 * NT * 128;      // the splits' statistics
  const bool vec = flags & 1;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* gb = dout + b * gs.b + h * gs.h;

  // the next item's copies, one commit group an item (empty past the
  // last): K's chunks, V's, then (R > 1) q's rows' and dO's
  F32Item ld(R, z);
  int n_loaded = 0;
  auto load = [&]() {
    if (n_loaded < n_items) {
      float* st = ring + (n_loaded & 1) * stage;
      const F32Item& w = ld;
      const int k0 = w.tile * T, n_keys = (min(T, block_keys - k0) + 7) & ~7;
      for (int j = 0; j < W && w.round * W + j < nd; ++j) {
        const int cc = w.round * W + j, c0 = sh.begin(cc), wd = sh.width(cc);
        f32_chunk_async(st + j * T * P, kb, ks.s, k0, n_keys, S, c0, wd, Dh, vec);
        f32_chunk_async(st + (W + j) * T * P, vb, vs.s, k0, n_keys, S, c0, wd, Dh, vec);
        if (R > 1) {
          float* ob = st + 2 * W * T * P;
          f32_chunk_async(ob + j * rows * P, qb, qs.s, r_first, n_rows, S, c0, wd, Dh, vec);
          f32_chunk_async(ob + (W + j) * rows * P, gb, gs.s, r_first, n_rows, S, c0, wd, Dh, vec);
        }
      }
      ld.next(R, n_tiles, z);
    }
    ++n_loaded;
    cp_async_commit();
  };
  if (R == 1)
    for (int j = 0; j < W; ++j) {
      f32_chunk_async(own_res + j * rows * P, qb, qs.s, r_first, n_rows, S, sh.begin(j),
                      sh.width(j), Dh, vec);
      f32_chunk_async(own_res + (W + j) * rows * P, gb, gs.s, r_first, n_rows, S, sh.begin(j),
                      sh.width(j), Dh, vec);
    }
  load();

  const int unit = u_first + wt;
  const bool live = unit < u_end;
  const int r0 = unit * 16;
  const int ra = r0 + g, rb = ra + 8;
  const int lim_a = causal ? min(S, ra + 1) : S, lim_b = causal ? min(S, rb + 1) : S;
  const int lim_warp = causal ? min(S, r0 + 1) : S;
  const int warp_keys = !live ? 0 : causal ? min(S, r0 + 16) : S;
  const int own = z * W + wc;                      // the warp's chunk of dq
  const int z8 = own < nd ? sh.width(own) / 8 : 0, zc0 = own < nd ? sh.begin(own) : 0;
  // the shares of s, then of dP, of the warp's (split, tile)
  float* s_slots = slots + 2 * (split * tiles + wt) * W * NT * 128;
  float* dp_slots = s_slots + W * NT * 128;

  float s[NT][4], s_lo[NT][4], dp[NT][4], dp_lo[NT][4], acc[kF32WideUnits][4];
  // sweep 1: m, l and D's sum; then m c, 1 / l and D
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kF32WideUnits; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  F32Item w(R, z);
  for (int it = 0; it < n_items; ++it, w.next(R, n_tiles, z)) {
    cp_async_wait<0>();                          // item it has landed ...
    __syncthreads();                             // ... for every thread; it - 1 is done
    load();                                      // item it + 1, into it - 1's stage
    if (it == per_sweep) {                       // sweep 1's statistics
      if (splits > 1)
        merge_stats(m, l, dd, xchg, split, wt * W + wc, tiles * W, splits, c, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          l[half] += __shfl_xor_sync(kFullMask, l[half], off);
          dd[half] += __shfl_xor_sync(kFullMask, dd[half], off);
        }
        // rows >= S (and a warp with no rows): P = 0, and a finite m c for dkv
        const bool row_live = live && ra + 8 * half < S;
        m[half] = row_live ? m[half] * c : 0.f;
        l[half] = row_live ? 1.f / l[half] : 0.f;
        dd[half] = row_live ? dd[half] * l[half] : 0.f;
      }
    }
    const float* st = ring + (it & 1) * stage;
    const int kw = split * kF32WideRows;         // the warp's keys in the stage
    const int key0 = w.tile * T + kw;
    const int n_live = min(NT, (warp_keys - key0 + 7) / 8);   // the same for a tile's W warps
    const int cc = w.round * W + wc;
    if (n_live > 0) {
      if (w.i == 0) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = s_lo[nt][e] = dp[nt][e] = dp_lo[nt][e] = 0.f;
      }
      if (cc < nd) {
        const float* ob = R > 1 ? st + 2 * W * T * P : own_res;
        const int steps = sh.width(cc) >> 3;
        f32_wide_abt<NT, true>(s, s_lo, ob + (wc * rows + wt * 16) * P, st + (wc * T + kw) * P,
                               steps, n_live, g, t);
        f32_wide_abt<NT, true>(dp, dp_lo, ob + ((W + wc) * rows + wt * 16) * P,
                               st + ((W + wc) * T + kw) * P, steps, n_live, g, t);
      }
    }
    if (w.i < R - 1) continue;                   // the shares are whole at the last round
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] += s_lo[nt][e];
        dp[nt][e] += dp_lo[nt][e];
      }
    if (n_live > 0) {
      xchg_put<NT>(s_slots + wc * NT * 128, s, lane);
      xchg_put<NT>(dp_slots + wc * NT * 128, dp, lane);
    }
    __syncthreads();                             // every share is in
    if (n_live <= 0) continue;
    xchg_sum<NT>(s, s_slots, W, lane);
    xchg_sum<NT>(dp, dp_slots, W, lane);
    const bool masked = key0 + NT * 8 > lim_warp;
    bool on[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        on[nt][e] = nt < n_live &&
                    !(masked && key0 + nt * 8 + 2 * t + e % 2 >= (e < 2 ? lim_a : lim_b));
    if (it < per_sweep) {
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (on[nt][e]) mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
      float mcs[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(kFullMask, mx[half], 1));
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(kFullMask, mx[half], 2));
        const float mn = fmaxf(m[half], mx[half]);
        mcs[half] = mn == -CUDART_INF_F ? 0.f : mn * c;   // no live key yet: add nothing
        const float alpha = exp2f(fmaf(m[half], c, -mcs[half]));
        m[half] = mn;
        l[half] *= alpha;
        dd[half] *= alpha;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = on[nt][e] ? exp2f(fmaf(s[nt][e], c, -mcs[e / 2])) : 0.f;
          l[e / 2] += p;
          dd[e / 2] = fmaf(p, dp[nt][e], dd[e / 2]);
        }
      continue;
    }
    // dS = P (dP - D) into dQ over the warp's columns (K's chunk wc of the
    // own round)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = on[nt][e] ? exp2f(fmaf(s[nt][e], c, -m[e / 2])) * l[e / 2] : 0.f;
        s[nt][e] = p * (dp[nt][e] - dd[e / 2]);
      }
    f32_wide_cb<NT, true>(acc, s, st + (wc * T + kw) * P, n_live, z8, g, t);
  }
  if (splits > 1) {                              // splits 1.. hand dQ to split 0 in order
    __syncthreads();                             // every thread is done with the ring
    const int at = (wt * W + wc) * kF32AccFloats + lane;
    if (split > 0) put_acc(acc, ring + (split - 1) * tiles * W * kF32AccFloats + at);
    __syncthreads();
    if (split > 0) return;
    for (int sp = 1; sp < splits; ++sp)
      add_acc(acc, ring + (sp - 1) * tiles * W * kF32AccFloats + at);
  }
  if (!live) return;
  if (z == 0 && wc == 0 && t == 0) {
    const long long n = static_cast<long long>(BH) * S;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = ra + 8 * half;
      if (r >= S) continue;
      const long long at = static_cast<long long>(bh) * S + r;
      stats[at] = m[half];
      stats[n + at] = l[half];
      stats[2 * n + at] = dd[half];
    }
  }
  if (z8 == 0) return;
  const float mul[2] = {scale, scale};
  f32_wide_store(dq + b * dqs.b + h * dqs.h, dqs.s, acc, mul, ra, S, zc0, min(Dh, zc0 + 8 * z8),
                 flags & 2, t);
}

// dk and dv: a block takes `tiles` 16-row key tiles of one (batch, head), W
// warps a tile, warp w owning chunk z W + w of the columns, and `splits`
// sets of them a tile's queries (set s the queries 16 s .. 16 s + 15 of
// every stage).  The query rows that see the block's keys (from its first
// key when causal) stream through the ring with their dO rows in tiles of
// 16 splits, each over the R rounds, once, and with a tile's last round
// their statistics from dq's workspace; the block's K and V rows are staged
// once at R = 1, else with each round.  Each warp takes P^T = k q^T and
// dP^T = V dO^T over its chunk of the round (hi.hi apart), the W shares are
// summed at a tile's last round, and P^T = exp2(c s - m c) / l and dS^T =
// P^T (dP^T - D) (F32Dkv's arithmetic) enter dV += P^T dO and dK += dS^T q
// over the warp's columns, the splits' sums added in order at the end.
__global__ void __launch_bounds__(64 * kF32WideWarps)
attention_bwd_wide_dkv(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       float* __restrict__ dk, float* __restrict__ dv,
                       const float* __restrict__ stats, int BH, int H, int S, int Dh, Strides qs,
                       Strides ks, Strides vs, Strides gs, Strides dks, Strides dvs, int causal,
                       float scale, float c, int flags, int splits) {
  constexpr int P = kF32WidePitch, NT = kF32WideNT;
  extern __shared__ __align__(16) unsigned char smem[];
  const F32Wide sh(Dh);
  const int nd = sh.nd, R = sh.R, W = sh.W, z = blockIdx.z;
  const int tiles = blockDim.x / 32 / W / splits;
  const int T = kF32WideRows * splits;           // queries a stage
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wc = warp % W, wt = warp / W % tiles, split = warp / W / tiles;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tiles16 = (S + 15) / 16;
  const int u_first = tile_begin(blockIdx.y, gridDim.y, tiles16);
  const int u_end = tile_begin(blockIdx.y + 1, gridDim.y, tiles16);
  const int j_first = u_first * 16, n_rows = (u_end - u_first) * 16;
  const int rows = 16 * tiles;
  // query rows from q0: when causal no earlier row sees the block's keys
  const int q0 = causal ? j_first : 0;
  const int n_tiles = (S - q0 + T - 1) / T;
  const int n_items = n_tiles * R;
  const int stats_at = W * (2 * T + (R > 1 ? 2 * rows : 0)) * P;   // in a stage
  const int stage = f32_wide_stage(sh, rows, T, true);
  float* ring = reinterpret_cast<float*>(smem);
  // R = 1: K's chunks, then V's, after the ring or the splits' hand-over
  float* own_res = ring + max(2 * stage, (splits - 1) * tiles * W * 2 * kF32AccFloats);
  float* slots = own_res + (R > 1 ? 0 : 2 * W * rows * P);
  const bool vec = flags & 1;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* gb = dout + b * gs.b + h * gs.h;
  const long long n = static_cast<long long>(BH) * S;
  const float* sb = stats + static_cast<long long>(bh) * S;

  // the next item's copies, one commit group an item (empty past the
  // last): q's chunks, dO's, (R > 1) K's rows' and V's, then (the last
  // round) the statistics
  F32Item ld(R, z);
  int n_loaded = 0;
  auto load = [&]() {
    if (n_loaded < n_items) {
      float* st = ring + (n_loaded & 1) * stage;
      const F32Item& w = ld;
      const int i0 = q0 + w.tile * T, n_q = (min(T, S - i0) + 7) & ~7;
      for (int j = 0; j < W && w.round * W + j < nd; ++j) {
        const int cc = w.round * W + j, c0 = sh.begin(cc), wd = sh.width(cc);
        f32_chunk_async(st + j * T * P, qb, qs.s, i0, n_q, S, c0, wd, Dh, vec);
        f32_chunk_async(st + (W + j) * T * P, gb, gs.s, i0, n_q, S, c0, wd, Dh, vec);
        if (R > 1) {
          float* ob = st + 2 * W * T * P;
          f32_chunk_async(ob + j * rows * P, kb, ks.s, j_first, n_rows, S, c0, wd, Dh, vec);
          f32_chunk_async(ob + (W + j) * rows * P, vb, vs.s, j_first, n_rows, S, c0, wd, Dh, vec);
        }
      }
      if (w.i == R - 1) {                        // m c, 1 / l and D, 0 past S
        float* dst = st + stats_at;
        for (int e = threadIdx.x; e < 3 * T; e += blockDim.x) {
          const int which = e / T, i = i0 + e % T;
          const bool in = i < S;
          cp_async4(dst + e, sb + which * n + (in ? i : 0), in);
        }
      }
      ld.next(R, n_tiles, z);
    }
    ++n_loaded;
    cp_async_commit();
  };
  if (R == 1)
    for (int j = 0; j < W; ++j) {
      f32_chunk_async(own_res + j * rows * P, kb, ks.s, j_first, n_rows, S, sh.begin(j),
                      sh.width(j), Dh, vec);
      f32_chunk_async(own_res + (W + j) * rows * P, vb, vs.s, j_first, n_rows, S, sh.begin(j),
                      sh.width(j), Dh, vec);
    }
  load();

  const int unit = u_first + wt;
  const bool live = unit < u_end;
  const int c0w = unit * 16;                     // the warp's keys
  const int ja = c0w + g, jb = ja + 8;
  const int own = z * W + wc;                    // the warp's chunk of dk and dv
  const int z8 = own < nd ? sh.width(own) / 8 : 0, zc0 = own < nd ? sh.begin(own) : 0;
  // the shares of P^T, then of dP^T, of the warp's (split, tile)
  float* p_slots = slots + 2 * (split * tiles + wt) * W * NT * 128;
  float* dp_slots = p_slots + W * NT * 128;

  float pt[NT][4], pt_lo[NT][4], dpt[NT][4], dpt_lo[NT][4];
  float av[kF32WideUnits][4], ak[kF32WideUnits][4];
#pragma unroll
  for (int nn = 0; nn < kF32WideUnits; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) av[nn][e] = ak[nn][e] = 0.f;

  F32Item w(R, z);
  for (int it = 0; it < n_items; ++it, w.next(R, n_tiles, z)) {
    cp_async_wait<0>();                          // item it has landed ...
    __syncthreads();                             // ... for every thread; it - 1 is done
    load();                                      // item it + 1, into it - 1's stage
    const float* st = ring + (it & 1) * stage;
    const int qw = split * kF32WideRows;         // the warp's queries in the stage
    const int i0 = q0 + w.tile * T + qw;
    // the same for a tile's W warps: no live key, no live query, or every
    // query before every key
    const bool active = live && i0 < S && !(causal && i0 + kF32WideRows - 1 < c0w);
    const int n_live = active ? min(NT, (S - i0 + 7) / 8) : 0;
    const int cc = w.round * W + wc;
    if (n_live > 0) {
      if (w.i == 0) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) pt[nt][e] = pt_lo[nt][e] = dpt[nt][e] = dpt_lo[nt][e] = 0.f;
      }
      if (cc < nd) {
        const float* ob = R > 1 ? st + 2 * W * T * P : own_res;
        const int steps = sh.width(cc) >> 3;
        f32_wide_abt<NT, true>(pt, pt_lo, ob + (wc * rows + wt * 16) * P,
                               st + (wc * T + qw) * P, steps, n_live, g, t);
        f32_wide_abt<NT, true>(dpt, dpt_lo, ob + ((W + wc) * rows + wt * 16) * P,
                               st + ((W + wc) * T + qw) * P, steps, n_live, g, t);
      }
    }
    if (w.i < R - 1) continue;                   // the shares are whole at the last round
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pt[nt][e] += pt_lo[nt][e];
        dpt[nt][e] += dpt_lo[nt][e];
      }
    if (n_live > 0) {
      xchg_put<NT>(p_slots + wc * NT * 128, pt, lane);
      xchg_put<NT>(dp_slots + wc * NT * 128, dpt, lane);
    }
    __syncthreads();                             // every share is in
    if (n_live <= 0) continue;
    xchg_sum<NT>(pt, p_slots, W, lane);
    xchg_sum<NT>(dpt, dp_slots, W, lane);
    const float* mc_s = st + stats_at + qw;
    const float* il_s = mc_s + T;
    const float* d_s = il_s + T;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int ic = nt * 8 + 2 * t;             // the columns' queries
      // read only live blocks: the statistics end at the 8-rounded tile
      float2 mq = make_float2(0.f, 0.f), lq = mq, dq2 = mq;
      if (nt < n_live) {
        mq = *reinterpret_cast<const float2*>(mc_s + ic);
        lq = *reinterpret_cast<const float2*>(il_s + ic);
        dq2 = *reinterpret_cast<const float2*>(d_s + ic);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e % 2;
        const int i = i0 + ic + odd, key = e < 2 ? ja : jb;
        const bool on = nt < n_live && i < S && !(causal && key > i);
        const float p =
            on ? exp2f(fmaf(pt[nt][e], c, -(odd ? mq.y : mq.x))) * (odd ? lq.y : lq.x) : 0.f;
        pt[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - (odd ? dq2.y : dq2.x));
      }
    }
    // dV += P^T dO and dK += dS^T q over the warp's columns (dO's and q's
    // chunk wc of the own round)
    f32_wide_cb<NT, true>(av, pt, st + ((W + wc) * T + qw) * P, n_live, z8, g, t);
    f32_wide_cb<NT, true>(ak, dpt, st + (wc * T + qw) * P, n_live, z8, g, t);
  }
  if (splits > 1) {                              // splits 1.. hand dV and dK to split 0 in order
    __syncthreads();                             // every thread is done with the ring
    const int at = (wt * W + wc) * 2 * kF32AccFloats + lane;
    float* x = ring + (split - 1) * tiles * W * 2 * kF32AccFloats + at;
    if (split > 0) {
      put_acc(av, x);
      put_acc(ak, x + kF32AccFloats);
    }
    __syncthreads();
    if (split > 0) return;
    for (int sp = 1; sp < splits; ++sp) {
      const float* y = ring + (sp - 1) * tiles * W * 2 * kF32AccFloats + at;
      add_acc(av, y);
      add_acc(ak, y + kF32AccFloats);
    }
  }
  if (!live || z8 == 0) return;
  const int c_end = min(Dh, zc0 + 8 * z8);
  const float one[2] = {1.f, 1.f}, mul[2] = {scale, scale};
  f32_wide_store(dv + b * dvs.b + h * dvs.h, dvs.s, av, one, ja, S, zc0, c_end, flags & 2, t);
  f32_wide_store(dk + b * dks.b + h * dks.h, dks.s, ak, mul, ja, S, zc0, c_end, flags & 2, t);
}

int launch_wide(const void* q, const void* k, const void* v, const void* dout, void* dq,
                void* dk, void* dv, int BH, int H, int S, int Dh, const Strides* st, int causal,
                float scale, float* stats, cudaStream_t stream) {
  // 16-byte cp.async rows where q, k, v and dO allow them, 8-byte stores
  // where dq, dk and dv do
  int vec = Dh % 4 == 0, pairs = Dh % 2 == 0;
  const void* in[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i)
    vec = vec && reinterpret_cast<unsigned long long>(in[i]) % 16 == 0 && st[i].b % 4 == 0 &&
          st[i].s % 4 == 0 && st[i].h % 4 == 0;
  const void* out[3] = {dq, dk, dv};
  for (int i = 0; i < 3; ++i)
    pairs = pairs && reinterpret_cast<unsigned long long>(out[i]) % 8 == 0 &&
            st[4 + i].b % 2 == 0 && st[4 + i].s % 2 == 0 && st[4 + i].h % 2 == 0;
  const int flags = vec | pairs << 1;
  static int dq_set[64], dkv_set[64];
  // the most any call takes: two splits of four warps at R = 1 (Dh = 256)
  const F32Wide widest(256);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(attention_bwd_wide_dq),
                               4 * f32_wide_floats(widest, 1, 2, false), dq_set);
  if (err == cudaSuccess)
    err = allow_smem(reinterpret_cast<const void*>(attention_bwd_wide_dkv),
                     4 * f32_wide_floats(widest, 1, 2, true), dkv_set);
  if (err != cudaSuccess) return err;
  // a block per (batch, head), up to kF32WideWarps / W 16-row tiles of its
  // query (dq) or key (dkv) rows as even as the tiles allow, W warps a tile,
  // and round z of the gradients' chunks; splits (at R = 1) as the forward's,
  // a block of up to twice the warps then
  const F32Wide sh(Dh);
  const int tiles16 = (S + 15) / 16;
  const int splits = sh.R > 1 ? 1
                              : min(min(key_splits(static_cast<long long>(BH) * tiles16 * sh.W),
                                        2 * kF32WideWarps / sh.W),
                                    (S + kF32WideRows - 1) / kF32WideRows);
  const int most = (splits > 1 ? 2 * kF32WideWarps : kF32WideWarps) / (sh.W * splits);
  const int blocks_y = (tiles16 + most - 1) / most;
  const int tiles = (tiles16 + blocks_y - 1) / blocks_y;
  const dim3 grid(BH, blocks_y, sh.R);
  const int threads = 32 * sh.W * tiles * splits;
  const float c = scale * 1.4426950408889634f;
  const float *qt = static_cast<const float*>(q), *kt = static_cast<const float*>(k),
              *vt = static_cast<const float*>(v), *gt = static_cast<const float*>(dout);
  attention_bwd_wide_dq<<<grid, threads, 4 * f32_wide_floats(sh, tiles, splits, false),
                          stream>>>(qt, kt, vt, gt, static_cast<float*>(dq), stats, BH, H, S, Dh,
                                    st[0], st[1], st[2], st[3], st[4], causal, scale, c, flags,
                                    splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_wide_dkv<<<grid, threads, 4 * f32_wide_floats(sh, tiles, splits, true),
                           stream>>>(qt, kt, vt, gt, static_cast<float*>(dk),
                                     static_cast<float*>(dv), stats, BH, H, S, Dh, st[0], st[1],
                                     st[2], st[3], st[5], st[6], causal, scale, c, flags, splits);
  return cudaGetLastError();
}

// --- bf16 wide-head kernels (bf16 above Dh = kHeadDim, tensor cores) ----------

constexpr int kWideWarps = 4;                 // 16-row tiles a block at most
constexpr int kWideDqTile16 = 4;              // 16-row groups of dq's streamed tile at most
constexpr int kWideTile16 = 2;                // ... and of dkv's (two accumulators a warp)

// Elements of a ring stage: the streamed tile's two operands (dq: K and V;
// dkv: q and dO) of `tile` rows and, at nd > 1, the block's `rows` rows of
// its own two operands' chunk (at nd = 1 they are staged once); dkv adds
// three statistics a streamed row (`extra` elements).
__host__ __device__ inline int wide_stage_elems(const WideChunks& ch, int rows, int tile,
                                                int extra) {
  return (2 * tile + (ch.nd > 1 ? 2 * rows : 0)) * ch.pitch() + extra;
}
// bf16 elements that hold 3 floats a streamed row
__host__ __device__ constexpr int wide_dkv_extra(int tile) { return 3 * tile * 2; }

inline int wide_smem_bytes(const WideChunks& ch, int rows, int tile, int extra) {
  return static_cast<int>(sizeof(bf16)) *
         (2 * wide_stage_elems(ch, rows, tile, extra) +
          (ch.nd > 1 ? 0 : 2 * rows * ch.pitch()));
}

// dq: a block takes up to kWideWarps 16-row query tiles of one (batch, head),
// a warp each, and dq's columns of chunk blockIdx.z (common.cuh, bf16
// wide-head attention).  K and V stream through a two-stage cp.async ring,
// filled one item ahead (one barrier an item), in tiles of `tile` keys
// (the live keys alone), each over the nd chunks, twice; the block's q and
// dO rows are staged once at nd = 1, else with each item's chunk.  s = q k^T and
// dP = dO V^T accumulate over the chunks in registers.  Sweep 1 takes each
// row's max m, sum l and D = sum P round(dP) (D rescaled with l as m
// grows); sweep 2 forms dS = P (round(dP) - D) as hi + lo bf16 terms into
// dQ = scale dS K over the block's columns.  The column block 0 writes m c,
// 1 / l and D (0 past S) to the workspace (3 x BH x S floats).
__global__ void __launch_bounds__(32 * kWideWarps)
attention_bwd_wide_tc_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         bf16* __restrict__ dq, float* __restrict__ stats, int BH, int H, int S,
                         int Dh, Strides qs, Strides ks, Strides vs, Strides gs, Strides dqs,
                         int causal, float scale, int tile, int pairs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WideChunks ch(Dh);
  const int P = ch.pitch(), nd = ch.nd, z = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tiles16 = (S + 15) / 16;
  const int u_first = tile_begin(blockIdx.y, gridDim.y, tiles16);
  const int u_end = tile_begin(blockIdx.y + 1, gridDim.y, tiles16);
  const int r_first = u_first * 16, n_rows = (u_end - u_first) * 16;
  const int rows = blockDim.x / 32 * 16;
  const int block_keys = causal ? min(S, u_end * 16) : S;
  const int n_tiles = (block_keys + tile - 1) / tile;
  const int per_sweep = n_tiles * nd, n_items = 2 * per_sweep;
  const int stage_elems = wide_stage_elems(ch, rows, tile, 0);
  bf16* own = reinterpret_cast<bf16*>(smem);     // nd = 1: q's rows, then dO's
  bf16* ring = own + (nd > 1 ? 0 : 2 * rows * P);
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const bf16* gb = dout + b * gs.b + h * gs.h;

  // item it's copies, one commit group an item (empty past the last): K's
  // tile, V's, then (nd > 1) q's rows and dO's
  auto load = [&](int it) {
    if (it < n_items) {
      bf16* st = ring + (it & 1) * stage_elems;
      const WideItem w(it, n_tiles, nd, z);
      const int k0 = w.tile * tile, c0 = ch.begin(w.chunk), wd = ch.width(w.chunk);
      const int n_keys = (min(tile, block_keys - k0) + 15) & ~15;
      chunk_async(st, P, kb, ks.s, k0, n_keys, S, c0, wd, Dh);
      chunk_async(st + tile * P, P, vb, vs.s, k0, n_keys, S, c0, wd, Dh);
      if (nd > 1) {
        chunk_async(st + 2 * tile * P, P, qb, qs.s, r_first, n_rows, S, c0, wd, Dh);
        chunk_async(st + (2 * tile + rows) * P, P, gb, gs.s, r_first, n_rows, S, c0, wd, Dh);
      }
    }
    cp_async_commit();
  };
  if (nd == 1) {
    chunk_async(own, P, qb, qs.s, r_first, n_rows, S, 0, ch.width(0), Dh);
    chunk_async(own + rows * P, P, gb, gs.s, r_first, n_rows, S, 0, ch.width(0), Dh);
  }
  load(0);

  const int unit = u_first + warp;
  const bool live = unit < u_end;
  const int r0 = unit * 16;
  const int lim_a = causal ? min(S, r0 + g + 1) : S;   // keys < lim are live for the row
  const int lim_b = causal ? min(S, r0 + g + 9) : S;
  const int lim_warp = causal ? min(S, r0 + 1) : S;
  const int warp_keys = !live ? 0 : causal ? min(S, r0 + 16) : S;
  const int zc0 = ch.begin(z), z16 = ch.width(z) / 16;
  const float c = scale * 1.4426950408889634f;

  float s[kWideDqTile16][2][4], dp[kWideDqTile16][2][4], acc[2 * kWideUnits][4];
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 2 * kWideUnits; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    cp_async_wait<0>();                          // item it has landed ...
    __syncthreads();                             // ... for every thread; it - 1 is done
    load(it + 1);                                // into it - 1's stage
    if (it == per_sweep) {                       // sweep 1's statistics
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          l[half] += __shfl_xor_sync(kFullMask, l[half], off);
          dsum[half] += __shfl_xor_sync(kFullMask, dsum[half], off);
        }
        // rows >= S (and a warp with no rows): P = 0, and a finite m c for dkv
        const bool row_live = live && r0 + g + 8 * half < S;
        m[half] = row_live ? m[half] * c : 0.f;
        l[half] = row_live ? 1.f / l[half] : 0.f;
        dsum[half] *= l[half];
      }
    }
    const bf16* st = ring + (it & 1) * stage_elems;
    const WideItem w(it, n_tiles, nd, z);
    const int k0 = w.tile * tile;
    const int live16 = min(tile / 16, (warp_keys - k0 + 15) / 16);   // warp-uniform
    if (live16 <= 0) continue;
    if (w.i == 0) {
#pragma unroll
      for (int kb = 0; kb < kWideDqTile16; ++kb)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[kb][nt][e] = dp[kb][nt][e] = 0.f;
    }
    const bf16* qa = nd > 1 ? st + (2 * tile + warp * 16) * P : own + warp * 16 * P;
    const bf16* ga = qa + rows * P;
    const int steps = (ch.width(w.chunk)) / 16;
    mma_abt_rows<kWideDqTile16>(s, qa, P, st, P, steps, live16, lane);
    mma_abt_rows<kWideDqTile16>(dp, ga, P, st + tile * P, P, steps, live16, lane);
    if (w.i < nd - 1) continue;                  // the tile's products are whole at its last chunk
    if (k0 + 16 * live16 > lim_warp) {           // some key reaches a row's limit: mask
#pragma unroll
      for (int kb = 0; kb < kWideDqTile16; ++kb)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + kb * 16 + nt * 8 + 2 * t + (e % 2) >= (e < 2 ? lim_a : lim_b))
              s[kb][nt][e] = -CUDART_INF_F;
    }
    if (it < per_sweep) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float x = -CUDART_INF_F;
#pragma unroll
        for (int kb = 0; kb < kWideDqTile16; ++kb)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            if (kb < live16) x = fmaxf(x, fmaxf(s[kb][nt][2 * half], s[kb][nt][2 * half + 1]));
        x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
        x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
        const float mn = fmaxf(m[half], x);
        const float mcr = mn == -CUDART_INF_F ? 0.f : mn * c;   // no live key yet
        const float alpha = exp2_ftz(fmaf(m[half], c, -mcr));
        float sum = l[half] * alpha, dd = dsum[half] * alpha;
#pragma unroll
        for (int kb = 0; kb < kWideDqTile16; ++kb)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 2 * half; e < 2 * half + 2; ++e)
              if (kb < live16) {
                const float p = exp2_ftz(fmaf(s[kb][nt][e], c, -mcr));
                sum += p;
                dd = fmaf(p, round_bf16(dp[kb][nt][e]), dd);
              }
        l[half] = sum;
        dsum[half] = dd;
        m[half] = mn;
      }
      continue;
    }
    // dS = P (round(dP) - D), P = exp2(c s - m c) / l (0 past a row's limit),
    // as hi + lo bf16 terms into dQ over the block's columns
#pragma unroll
    for (int kb = 0; kb < kWideDqTile16; ++kb) {
      if (kb >= live16) break;
      float d[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_ftz(fmaf(s[kb][nt][e], c, -m[e / 2])) * l[e / 2];
          d[nt][e] = p * (round_bf16(dp[kb][nt][e]) - dsum[e / 2]);
        }
      unsigned ha[4], la[4];
      split_bf16(d, ha, la);
      mma_ab2_rows(acc, ha, la, st + kb * 16 * P, P, z16, lane);
    }
  }
  if (!live) return;
  if (z == 0 && t == 0) {
    const long long n = static_cast<long long>(BH) * S;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + g + 8 * half;
      if (r >= S) continue;
      const long long at = static_cast<long long>(bh) * S + r;
      stats[at] = m[half];
      stats[n + at] = l[half];
      stats[2 * n + at] = dsum[half];
    }
  }
  wide_store(dq + b * dqs.b + h * dqs.h, dqs.s, acc, scale, r0 + g, S, zc0,
             min(Dh, zc0 + 16 * z16), pairs, t);
}

// dk and dv: a block takes up to kWideWarps 16-row tiles of keys of one
// (batch, head), a warp each, and the columns of chunk blockIdx.z.  The
// query rows (from the block's first key when causal) stream through the
// ring with their dO rows in tiles of `tile`, each over the nd chunks,
// once, and with the last chunk their statistics from dq's workspace; the
// block's K and V rows are staged once at nd = 1, else with each item's
// chunk.  P^T = exp2(c k q^T - m c) / l and dP^T = V dO^T accumulate over
// the chunks; at a tile's last chunk dV += round(P)^T dO and dK += scale
// dS^T q (dS as hi + lo) over the block's columns, 16 queries at a time.
__global__ void __launch_bounds__(32 * kWideWarps)
attention_bwd_wide_tc_dkv(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          const float* __restrict__ stats, int BH, int H, int S, int Dh,
                          Strides qs, Strides ks, Strides vs, Strides gs, Strides dks,
                          Strides dvs, int causal, float scale, int tile, int pairs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WideChunks ch(Dh);
  const int P = ch.pitch(), nd = ch.nd, z = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tiles16 = (S + 15) / 16;
  const int u_first = tile_begin(blockIdx.y, gridDim.y, tiles16);
  const int u_end = tile_begin(blockIdx.y + 1, gridDim.y, tiles16);
  const int j_first = u_first * 16, n_rows = (u_end - u_first) * 16;
  const int rows = blockDim.x / 32 * 16;
  // query rows from q0: when causal no earlier row sees the block's keys
  const int q0 = causal ? j_first : 0;
  const int n_tiles = (S - q0 + tile - 1) / tile;
  const int n_items = n_tiles * nd;
  const int stats_at = (2 * tile + (nd > 1 ? 2 * rows : 0)) * P;   // in a stage
  const int stage_elems = wide_stage_elems(ch, rows, tile, wide_dkv_extra(tile));
  bf16* own = reinterpret_cast<bf16*>(smem);     // nd = 1: K's rows, then V's
  bf16* ring = own + (nd > 1 ? 0 : 2 * rows * P);
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const bf16* gb = dout + b * gs.b + h * gs.h;
  const long long n = static_cast<long long>(BH) * S;
  const float* sb = stats + static_cast<long long>(bh) * S;

  // item it's copies, one commit group an item (empty past the last): q's
  // tile, dO's, (nd > 1) K's rows and V's, then the statistics
  auto load = [&](int it) {
    if (it < n_items) {
      bf16* st = ring + (it & 1) * stage_elems;
      const WideItem w(it, n_tiles, nd, z);
      const int i0 = q0 + w.tile * tile, c0 = ch.begin(w.chunk), wd = ch.width(w.chunk);
      const int n_q = (min(tile, S - i0) + 15) & ~15;
      chunk_async(st, P, qb, qs.s, i0, n_q, S, c0, wd, Dh);
      chunk_async(st + tile * P, P, gb, gs.s, i0, n_q, S, c0, wd, Dh);
      if (nd > 1) {
        chunk_async(st + 2 * tile * P, P, kb, ks.s, j_first, n_rows, S, c0, wd, Dh);
        chunk_async(st + (2 * tile + rows) * P, P, vb, vs.s, j_first, n_rows, S, c0, wd, Dh);
      }
      if (w.i == nd - 1) {                       // mc, 1 / l and D, 0 past S
        float* dst = reinterpret_cast<float*>(st + stats_at);
        for (int e = threadIdx.x; e < 3 * tile; e += blockDim.x) {
          const int which = e / tile, i = i0 + e % tile;
          const bool in = i < S;
          cp_async4(dst + e, sb + which * n + (in ? i : 0), in);
        }
      }
    }
    cp_async_commit();
  };
  if (nd == 1) {
    chunk_async(own, P, kb, ks.s, j_first, n_rows, S, 0, ch.width(0), Dh);
    chunk_async(own + rows * P, P, vb, vs.s, j_first, n_rows, S, 0, ch.width(0), Dh);
  }
  load(0);

  const int unit = u_first + warp;
  const bool live = unit < u_end;
  const int c0w = unit * 16;                     // the warp's keys
  const int ja = c0w + g, jb = ja + 8;
  const int zc0 = ch.begin(z), z16 = ch.width(z) / 16;
  const float c = scale * 1.4426950408889634f;

  float stt[kWideTile16][2][4], dpt[kWideTile16][2][4];
  float av[2 * kWideUnits][4], ak[2 * kWideUnits][4];
#pragma unroll
  for (int nt = 0; nt < 2 * kWideUnits; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) av[nt][e] = ak[nt][e] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    cp_async_wait<0>();                          // item it has landed ...
    __syncthreads();                             // ... for every thread; it - 1 is done
    load(it + 1);                                // into it - 1's stage
    const bf16* st = ring + (it & 1) * stage_elems;
    const WideItem w(it, n_tiles, nd, z);
    const int i0 = q0 + w.tile * tile;
    // the tile's live 16-query groups: below S, and (causal) not all before
    // the warp's first key
    const int first = causal && live ? max(0, min(tile / 16, (c0w - i0) / 16)) : 0;
    const int n16 = !live ? 0 : min(tile / 16, (S - i0 + 15) / 16) - first;   // warp-uniform
    if (n16 <= 0) continue;
    if (w.i == 0) {
#pragma unroll
      for (int kb = 0; kb < kWideTile16; ++kb)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) stt[kb][nt][e] = dpt[kb][nt][e] = 0.f;
    }
    const bf16* ka = nd > 1 ? st + (2 * tile + warp * 16) * P : own + warp * 16 * P;
    const bf16* va = ka + rows * P;
    const int steps = (ch.width(w.chunk)) / 16;
    mma_abt_rows<kWideTile16>(stt, ka, P, st + first * 16 * P, P, steps, n16, lane);
    mma_abt_rows<kWideTile16>(dpt, va, P, st + (tile + first * 16) * P, P, steps, n16, lane);
    if (w.i < nd - 1) continue;                  // the tile's products are whole at its last chunk
    const float* mc_s = reinterpret_cast<const float*>(st + stats_at);
    const float* il_s = mc_s + tile;
    const float* d_s = il_s + tile;
#pragma unroll
    for (int kb = 0; kb < kWideTile16; ++kb) {
      if (kb >= n16) break;
      const int qg = (first + kb) * 16;          // the group's first query in the tile
      float p[2][4], d[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int ic = qg + nt * 8 + 2 * t;
        const float2 mc = *reinterpret_cast<const float2*>(mc_s + ic);
        const float2 il = *reinterpret_cast<const float2*>(il_s + ic);
        const float2 dd = *reinterpret_cast<const float2*>(d_s + ic);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool odd = e % 2;
          float pv = exp2_ftz(fmaf(stt[kb][nt][e], c, -(odd ? mc.y : mc.x))) *
                     (odd ? il.y : il.x);
          if (causal && (e < 2 ? ja : jb) > i0 + ic + odd) pv = 0.f;   // a key after a query
          p[nt][e] = pv;
          d[nt][e] = pv * (round_bf16(dpt[kb][nt][e]) - (odd ? dd.y : dd.x));
        }
      }
      unsigned pa[4], ha[4], la[4];
      c_to_a_bf16(p, pa);
      split_bf16(d, ha, la);
      mma_ab_rows(av, pa, st + (tile + qg) * P, P, z16, lane);
      mma_ab2_rows(ak, ha, la, st + qg * P, P, z16, lane);
    }
  }
  if (!live) return;
  const int c_end = min(Dh, zc0 + 16 * z16);
  wide_store(dv + b * dvs.b + h * dvs.h, dvs.s, av, 1.f, ja, S, zc0, c_end, pairs, t);
  wide_store(dk + b * dks.b + h * dks.h, dks.s, ak, scale, ja, S, zc0, c_end, pairs, t);
}

int launch_wide_tc(const void* q, const void* k, const void* v, const void* dout, void* dq,
                   void* dk, void* dv, int BH, int H, int S, int Dh, const Strides* st,
                   int causal, float scale, float* stats, cudaStream_t stream) {
  // 16-byte cp.async rows of q, k, v and dO (the caller copies others);
  // 4-byte stores where dq, dk and dv allow them
  const void* in[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i)
    if (reinterpret_cast<unsigned long long>(in[i]) % 16 || st[i].b % 8 || st[i].s % 8 ||
        st[i].h % 8)
      return cudaErrorInvalidValue;
  int pairs = Dh % 2 == 0;
  const void* out[3] = {dq, dk, dv};
  for (int i = 0; i < 3; ++i)
    pairs = pairs && reinterpret_cast<unsigned long long>(out[i]) % 4 == 0 &&
            st[4 + i].b % 2 == 0 && st[4 + i].s % 2 == 0 && st[4 + i].h % 2 == 0;
  static int dq_set[64], dkv_set[64];
  // the most any width takes: two 128-column chunks (Dh = 256), 64 rows
  const WideChunks widest(256);
  const int dq_most = 16 * kWideDqTile16, dkv_most = 16 * kWideTile16;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(attention_bwd_wide_tc_dq),
                               wide_smem_bytes(widest, 16 * kWideWarps, dq_most, 0), dq_set);
  if (err == cudaSuccess)
    err = allow_smem(reinterpret_cast<const void*>(attention_bwd_wide_tc_dkv),
                     wide_smem_bytes(widest, 16 * kWideWarps, dkv_most, wide_dkv_extra(dkv_most)),
                     dkv_set);
  if (err != cudaSuccess) return err;
  // a block per (batch, head), up to kWideWarps 16-row tiles of its query
  // (dq) or key (dkv) rows as even as the tiles allow, and chunk z of the
  // gradients' columns; streamed tiles of S rounded to 16 at most
  const WideChunks ch(Dh);
  const int dq_tile = min(dq_most, (S + 15) & ~15), tile = min(dkv_most, (S + 15) & ~15);
  const int tiles16 = (S + 15) / 16;
  const int blocks_y = (tiles16 + kWideWarps - 1) / kWideWarps;
  const int warps = (tiles16 + blocks_y - 1) / blocks_y;
  const dim3 grid(BH, blocks_y, ch.nd);
  const bf16 *qt = static_cast<const bf16*>(q), *kt = static_cast<const bf16*>(k),
             *vt = static_cast<const bf16*>(v), *gt = static_cast<const bf16*>(dout);
  attention_bwd_wide_tc_dq<<<grid, 32 * warps, wide_smem_bytes(ch, 16 * warps, dq_tile, 0),
                             stream>>>(qt, kt, vt, gt, static_cast<bf16*>(dq), stats, BH, H, S,
                                       Dh, st[0], st[1], st[2], st[3], st[4], causal, scale,
                                       dq_tile, pairs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_wide_tc_dkv<<<grid, 32 * warps,
                              wide_smem_bytes(ch, 16 * warps, tile, wide_dkv_extra(tile)),
                              stream>>>(
      qt, kt, vt, gt, static_cast<bf16*>(dk), static_cast<bf16*>(dv), stats, BH, H, S, Dh,
      st[0], st[1], st[2], st[3], st[5], st[6], causal, scale, tile, pairs);
  return cudaGetLastError();
}

// Routes of keds_attention_bwd: the tuned kernels (bf16 tensor cores or f32
// 3xTF32, at most kHeadDim wide) and the wide-head pair.
enum BwdRoute : int { kRouteTuned = 0, kRouteWide = 1 };

// The route for `dtype` at head width Dh and sequence length S (-1: not
// taken); *width = the width the caller hands the inputs at, *runs = the
// head width the kernels run at (zero past Dh in shared memory).  At most
// kHeadDim the tuned kernels: bf16 resident (S <= kMaxSeq) at Dh rounded up
// to 16; bf16 streamed and f32 at kHeadDim, to which the caller zero-pads a
// narrower head.  Above it the wide-head pair (bf16 at Dh rounded up to 16,
// f32 to 8).
int bwd_route(int dtype, int Dh, int S, int* width, int* runs) {
  if (Dh < 1 || S < 1 || (dtype != kFloat32 && dtype != kBFloat16)) return -1;
  *width = Dh;
  *runs = dtype == kBFloat16 ? (Dh + 15) & ~15 : (Dh + 7) & ~7;
  if (Dh > kHeadDim) return kRouteWide;
  if (dtype == kFloat32 || S > kMaxSeq) *width = *runs = kHeadDim;
  return kRouteTuned;
}

using Launch = int (*)(const void*, const void*, const void*, const void*, void*, void*,
                       void*, int, int, int, int, const Strides*, int, float, cudaStream_t);
// the resident bf16 kernel by head width (16, 32, 48, 64) and 16-key tiles
constexpr Launch kTcLaunch[4][kMaxSeq / 16] = {
    {launch_tc<1, 16>, launch_tc<2, 16>, launch_tc<3, 16>, launch_tc<4, 16>,
     launch_tc<5, 16>, launch_tc<6, 16>, launch_tc<7, 16>, launch_tc<8, 16>},
    {launch_tc<1, 32>, launch_tc<2, 32>, launch_tc<3, 32>, launch_tc<4, 32>,
     launch_tc<5, 32>, launch_tc<6, 32>, launch_tc<7, 32>, launch_tc<8, 32>},
    {launch_tc<1, 48>, launch_tc<2, 48>, launch_tc<3, 48>, launch_tc<4, 48>,
     launch_tc<5, 48>, launch_tc<6, 48>, launch_tc<7, 48>, launch_tc<8, 48>},
    {launch_tc<1, 64>, launch_tc<2, 64>, launch_tc<3, 64>, launch_tc<4, 64>,
     launch_tc<5, 64>, launch_tc<6, 64>, launch_tc<7, 64>, launch_tc<8, 64>}};

}  // namespace

// The tuned kernels' launch plan at sequence length S for `dtype` and a
// head of Dh <= kHeadDim: out[0..4] = 16-row tiles, (batch, head) slices a
// block, warps a block, dynamic shared bytes (of the larger of two
// launches; the resident bf16 kernel's at the width Dh runs at) and the f32
// workspace rows a (batch, head) takes for each of three statistics (0
// where one launch needs none: bf16 at S <= kMaxSeq, f32 at S <= kF32Chunk).
extern "C" int keds_attention_bwd_plan(int S, int dtype, int Dh, int* out) {
  if (S < 1 || Dh < 1 || Dh > kHeadDim || (dtype != kFloat32 && dtype != kBFloat16))
    return cudaErrorInvalidValue;
  if (dtype == kFloat32) {
    const F32Plan p = f32_plan(S);
    out[0] = p.tiles;
    out[1] = 1;
    out[2] = p.warps;
    out[3] = p.smem_bytes;
    out[4] = p.resident ? 0 : 16 * p.tiles;
  } else if (S <= kMaxSeq) {
    const Plan p = tc_plan(S, (Dh + 15) & ~15);
    out[0] = p.key_tiles;
    out[1] = p.slices;
    out[2] = p.warps;
    out[3] = p.smem_bytes;
    out[4] = 0;
  } else {
    out[0] = (S + 15) / 16;
    out[1] = 1;
    out[2] = kStreamWarps;
    out[3] = kDkvSmem;
    out[4] = stream_rows(S);
  }
  return cudaSuccess;
}

// The route of keds_attention_bwd for `dtype` at head width Dh and sequence
// length S (-1: not taken): out[0] = the width the caller hands the inputs
// at (it zero-pads narrower ones to it), out[1] = the head width the
// kernels run at, out[2] = the f32 workspace rows a (batch, head) takes for
// each of three statistics (0: none).
extern "C" int keds_attention_bwd_route(int dtype, int Dh, int S, int* out) {
  const int route = bwd_route(dtype, Dh, S, &out[0], &out[1]);
  if (route == kRouteWide) {
    out[2] = S;
  } else if (route == kRouteTuned) {
    int plan[5];
    keds_attention_bwd_plan(S, dtype, out[0], plan);
    out[2] = plan[4];
  }
  return route;
}

// strides: 21 int64 values, (batch, seq, head) element strides of q, k, v,
// dO, dq, dk, dv in that order; every head dimension has unit stride.  Dh
// is the width the caller hands the inputs at (keds_attention_bwd_route's
// out[0]).  The
// bf16 tuned kernels also need 16-byte aligned rows of q, k, v and dO, and
// the f32 ones 8-byte aligned rows of dq, dk and dv.  A route with
// workspace rows (out[2]) takes a `workspace` of 3 * B * H * out[2] floats
// (16-byte aligned).
extern "C" int keds_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, void* dq, void* dk, void* dv,
                                  int dtype, int B, int H, int S, int Dh,
                                  const long long* strides, int causal, float scale,
                                  void* workspace, void* stream) {
  int plan[3] = {0, 0, 0};
  const int route = keds_attention_bwd_route(dtype, Dh, S, plan);
  if (route < 0 || plan[0] != Dh || B * H < 1) return cudaErrorInvalidValue;
  if (plan[2] > 0 && workspace == nullptr) return cudaErrorInvalidValue;
  Strides st[7];
  for (int t = 0; t < 7; ++t)
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  if (route == kRouteWide)
    return dtype == kFloat32
               ? launch_wide(q, k, v, dout, dq, dk, dv, B * H, H, S, Dh, st, causal, scale, ws,
                             s)
               : launch_wide_tc(q, k, v, dout, dq, dk, dv, B * H, H, S, Dh, st, causal, scale,
                                ws, s);
  if (dtype == kFloat32) {
    // 16-byte cp.async rows where q, k, v and dO allow them
    bool vec = true;
    const void* in[4] = {q, k, v, dout};
    for (int i = 0; i < 4; ++i)
      vec = vec && reinterpret_cast<unsigned long long>(in[i]) % 16 == 0 && st[i].b % 4 == 0 &&
            st[i].s % 4 == 0 && st[i].h % 4 == 0;
    return launch_f32(q, k, v, dout, dq, dk, dv, B * H, H, S, st, causal, scale, ws, vec, s);
  }
  if (dtype == kBFloat16)
    return S > kMaxSeq
               ? launch_tc_stream(q, k, v, dout, dq, dk, dv, B * H, H, S, st, causal, scale, ws, s)
               : kTcLaunch[(Dh - 1) / 16][(S - 1) / 16](q, k, v, dout, dq, dk, dv, B * H, H,
                                                        S, Dh, st, causal, scale, s);
  return cudaErrorInvalidValue;
}
