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
// Five designs: bf16 at Dh <= 64 for S <= kMaxResident (K and V of a
// (batch, head) whole in shared memory) and above it (K and V streamed in
// key chunks, at Dh = 64), bf16 above Dh = 64 (the wide-head tensor-core
// kernel), one f32 design at every S and Dh <= 128, and f32 above it.  None
// falls back to another; bf16 heads narrower than 64 are zero-padded to it
// by the caller above kMaxResident keys alone (keds_attention_fwd_route
// says which route takes which width, and the width it runs at).
//
// attention_tc<DH> (bf16, Dh <= 64, S <= 288).  What bounds it on the H100: at
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
//   * A head narrower than 64 runs at DH, Dh rounded up to 16 (a template
//     parameter: 16, 32, 48 or 64): K and V rows of DH + 8 elements, zero
//     past Dh by cp.async's source size, q's fragments zero past Dh, DH / 16
//     k-steps of q.k^T and DH / 8 n-tiles of P.V, the output written at
//     the caller's width.  Nothing is padded in device memory, and a block
//     stages (DH + 8) / 72 of the 64-wide kernel's bytes (S = 288: 27 KB at
//     DH = 16, 81 KB at 64), so more blocks share an SM.
//
// attention_tc_stream (bf16, Dh = 64, S > 288).  Two passes, so that P is
// normalised before it is rounded, where the reference rounds it: one pass
// with an online softmax rounds it before, which moved near-one-hot rows
// (q scaled by 8) one bf16 step off the plain version, 0.03125 at |out| >=
// 4, past the card test's 2e-2.  What bounds it on the H100: at ViT-L/14's
// 336 px chunk (16, 16, 577, 64) the function moves 38 MB (0.011 ms) and
// does 21.8 GFLOP (0.022 ms at 989 TFLOP/s); two passes take 1.5 times the
// products and two exp2 a score.  Measured, the tile stream alone (no
// arithmetic) took about half the kernel's time and the arithmetic added to
// it rather than hiding under it: the kernel is latency-bound, so blocks an
// SM (one block's loads under another's products) mattered most.  The
// design:
//   * A block takes 128 query rows of one (batch, head), its four warps 32
//     rows each (two 16-row tiles, so each K or V fragment feeds two
//     products), held in shared memory in 144-byte rows; 168 registers and
//     67 KB, three blocks an SM.
//   * K (pass 1), then K and V (pass 2) arrive as 64 x 64 tiles through a
//     three-stage ring that the copy engine fills two chunks ahead: thread
//     0 issues one tensor-map load a tile (tile_map, 128-byte swizzle, rows
//     past S zero) counted on the stage's mbarrier, so no thread spends
//     instructions or registers on the copies (cp.async by every thread,
//     and a bulk copy a row, were slower).
//   * Pass 1 takes each row's max and sum a chunk at a time (the quad's
//     threads share the max; one rescale a chunk); pass 2 forms P =
//     exp2(c s - c m) / l, rounds it to bf16 in the mma A-fragment layout
//     and accumulates P.V.  No branch splits a chunk's products: a masked
//     key (past S, or past the row when causal) is -inf before the softmax.
//   * mma.sync m16n8k16, as the resident kernel; wgmma was not tried
//     (PERF.md, open questions).

// attention_f32 (f32, any Dh <= 128, any S).  What bounds it on the H100:
// operations.  At ViT-L/14's 336 px chunk (16, 16, 577, 64) the function
// does 21.8 GFLOP on 151 MB, 144 flop a byte.  The design takes the
// products on tensor cores in three TF32 terms (common.cuh: split_tf32,
// mma_3xtf32), which keeps about f32's accuracy at a third of the TF32 rate
// (kernel_sweeps.py mma_rate, attention_precision; PERF.md), so its bound
// is 0.13 ms at 494.7 / 3 TFLOP/s (0.33 ms at f32 FMA's 67 TFLOP/s):
//   * A warp owns 16 query rows: q's fragments are split once into
//     registers (up to Dh = 64), s = q k^T over a stage's keys and the
//     online softmax run in the accumulator fragments (m shared by a quad,
//     l each thread's part), and P feeds P.V as its A operand with no
//     exchange (each 8-key step's keys taken in the accumulators' order).
//     One pass: f32 P is not rounded before the sum, so q k^T is not
//     recomputed as the bf16 kernels do.
//   * K and V arrive through a two-stage cp.async ring of 16-byte rows (64
//     keys a stage, 32 above Dh = 64), each row 4 floats longer than the
//     head dimension (zero-padded to 32, 64 or 128), so every fragment load
//     is free of bank conflicts.  An operand is split at its fragment load
//     by integer rounding (faster than cvt.rna.tf32), and a product's three
//     terms are issued across four accumulators, so that no mma waits on
//     the one before it (a TF32 mma.sync takes about 25 cycles).
//   * A block takes up to four 16-row tiles of one (batch, head), as many as
//     make its blocks even.  Where the tiles alone give fewer than two warps
//     to each of the card's four sub-partitions an SM, 2 or 4 warps take a
//     tile's keys in turn and merge (m, l, acc) in a fixed order.  At
//     Dh = 64 a block takes 70 KB of shared memory and 233 registers a
//     thread, two blocks an SM; a call of S <= 64 keys holds them alone (S
//     rounded to 16 rows).
//   * The tensor core rounds its sums toward zero, which over a long sum of
//     one sign drifts: q k^T sums hi.hi apart from the small terms, and each
//     stage's P.V is summed apart and added to the output by an FMA.
// One design serves every S, so no resident route is kept: at S <= 64 the
// ring holds the keys alone and a call is one stage.
//
// attention_wide_tc (bf16 above Dh = 64, any Dh and S).  No CLIP preset
// reaches it (every tower's heads are 64 wide); a custom config does.  What
// bounds it on the H100: at (4, 16, 257, 80) the function moves 10.5 MB
// (0.0031 ms) and does 1.35 GFLOP (0.0014 ms), so bytes; as at Dh = 64, the
// tile stream's latency sets the time.  The design is the tuned kernels'
// (two passes, so P is normalised before it is rounded; mma.sync m16n8k16,
// a warp owning 16 query rows with the softmax in its accumulators) made
// to take any width at bounded cost:
//   * The head dimension is zero-padded to a multiple of 16 in shared
//     memory alone (cp.async's zero fill past Dh: no host copy), and cut
//     into nd = ceil(Dh / 128) chunks (common.cuh, bf16 wide-head
//     attention).  q.k^T sums over the chunks' 16-column steps in
//     registers; a block writes the output columns of one chunk (grid.z),
//     so O stays at most 16 x 128 f32 a warp.
//   * A block takes up to eight 16-row query tiles, as even as the tiles
//     allow; at nd = 1 its query rows are staged once.  K tiles of 64 keys
//     (S rounded to 16 at most: S = 8 stages 16 rows; the live keys alone,
//     and no causal tile past the block's last row) stream through a
//     two-stage cp.async ring, one barrier an item, each over the nd chunks
//     with the block's own chunk last, V's rows of that chunk arriving with
//     it in pass 2 (and at nd > 1 the query rows' chunk with each).
//   * Latency-bound, so resident warps an SM set the time: in trials on the
//     card, four warps a block and a third ring stage lost occupancy to
//     shared memory and ran slower at S = 257, 32-key tiles (more items)
//     lost at Dh = 80, and a stage sized for 64 keys at S = 8 held four
//     times the rows S needs.  164 registers; at S = 257, 61 KB (Dh = 80)
//     and 94 KB (Dh = 128) a block of six warps, two blocks an SM; at most
//     136 KB.
//   * Rows must be 16-byte aligned; the caller copies others (Dh = 100:
//     200-byte rows into 208).
//
// attention_wide (f32 above Dh = 128, any Dh and S).  No CLIP preset
// reaches it (every tower's heads are 64 wide); a custom config does.  What
// bounds it on the H100: operations, as attention_f32 (at (16, 4, 257,
// 256) 4.3 GFLOP on 67 MB: 0.026 ms at 3xTF32's 494.7 / 3 TFLOP/s).  The
// design is attention_f32's arithmetic (3xTF32 on mma.sync, a warp owning
// 16 query rows with the online softmax in its accumulators, one pass, P.V
// summed apart a tile) made to take any width at bounded cost:
//   * The head is cut into nd <= 64-column chunks, and W warps share each
//     16-row tile, one chunk each (common.cuh, f32 wide-head attention):
//     each takes its chunk's share of q.k^T (hi.hi apart from the small
//     terms), the shares are summed through shared memory, and each warp
//     forms the same softmax and P.V over its own columns.  So q.k^T is
//     taken once up to Dh = 256, R times above (R rounds over grid.z).  A
//     block per 64-column chunk (grid.z), each recomputing q.k^T, restaged
//     every operand a chunk and lost to the plain version (PERF.md).
//   * A block takes up to eight warps; keys stream in stages of 16 a warp
//     (the live keys alone) through a two-stage cp.async ring, one barrier
//     an item and one for the shares, K's chunks (and V's at the own round)
//     of the round; the query rows are staged once (R = 1) or with each
//     round.  Rows are read in place: 16-byte copies where aligned, 4-byte
//     otherwise.  Two blocks an SM (__launch_bounds__(256, 2): f32 tiles of
//     the whole width leave no room for more, and 16-key stages for no
//     wider ones).
//   * Where the grid is thin, 2 splits of a tile's warps take its keys
//     and merge (m, l, acc) in a fixed order, as attention_f32 does.

#include "common.cuh"

namespace {

using namespace keds;
using bf16 = __nv_bfloat16;

constexpr int kMaxResident = 288;            // the bf16 kernel's whole K and V

struct Strides {
  long long b, s, h;
};

bool aligned(const void* p, long long bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

// --- bf16 tensor-core kernels ----------------------------------------------

constexpr int kTcHeadDim = 64;               // the streamed kernel's width
constexpr int kTcPitch = kTcHeadDim + 8;     // 144-byte smem rows
constexpr int kTcMaxWarps = 9;
constexpr int kTcRows = 16;                  // query rows per warp tile

// The resident kernel at head width DH (16, 32, 48 or 64: a head of Dh runs
// at Dh rounded up to 16, zero past Dh in shared memory and in q's
// fragments): rows of DH + 8 elements, an odd multiple of 16 bytes, so
// every ldmatrix is conflict-free.
template <int DH> struct TcShape {
  static constexpr int kPitch = DH + 8;
  static constexpr int kSteps = DH / 16;     // 16-column k-steps of q k^T
  static constexpr int kTiles = DH / 8;      // 8-column n-tiles of P V
};

__host__ __device__ constexpr int tc_key_rows(int n_keys) { return (n_keys + 15) & ~15; }

size_t tc_smem_bytes(int n_keys, int dh) {
  return 2 * static_cast<size_t>(tc_key_rows(n_keys)) * (dh + 8) * sizeof(bf16);
}

// Columns c, c + 1 of a q row as an A-fragment register: zero at and past
// Dh (the row is 4-byte aligned; an odd Dh's last column is read alone).
__device__ __forceinline__ unsigned tc_q_pair(const bf16* row, int c, int Dh) {
  if (c + 2 <= Dh) return __ldg(reinterpret_cast<const unsigned*>(row + c));
  return c < Dh ? __ldg(reinterpret_cast<const unsigned short*>(row + c)) : 0u;
}

// The query fragments of rows ra and rb = ra + 8 (zero for rows >= S).
// FULL: Dh is the kernel's width, so no column is masked and no load is
// conditional on one.
template <bool FULL, int KS>
__device__ __forceinline__ void tc_load_q(unsigned (&qf)[KS][4], const bf16* qb, long long qs,
                                          int ra, int rb, int S, int Dh, int t) {
  const bf16* qa = qb + ra * qs;
  const bf16* qr = qb + rb * qs;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = kk * 16 + 2 * t;
    if (FULL) {
      const unsigned* ua = reinterpret_cast<const unsigned*>(qa + c);
      const unsigned* ub = reinterpret_cast<const unsigned*>(qr + c);
      qf[kk][0] = ra < S ? __ldg(ua) : 0u;
      qf[kk][1] = rb < S ? __ldg(ub) : 0u;
      qf[kk][2] = ra < S ? __ldg(ua + 4) : 0u;
      qf[kk][3] = rb < S ? __ldg(ub + 4) : 0u;
    } else {
      qf[kk][0] = ra < S ? tc_q_pair(qa, c, Dh) : 0u;
      qf[kk][1] = rb < S ? tc_q_pair(qr, c, Dh) : 0u;
      qf[kk][2] = ra < S ? tc_q_pair(qa, c + 8, Dh) : 0u;
      qf[kk][3] = rb < S ? tc_q_pair(qr, c + 8, Dh) : 0u;
    }
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
template <int DH>
__device__ __forceinline__ void tc_stats_tile(float (&m)[2], float (&l)[2],
                                              const unsigned (&qf)[DH / 16][4],
                                              const bf16* k_tile, int key0, TcLimits lim,
                                              float c, int lane) {
  const int t = lane % 4;
  float s[2][4];
  mma_abt<TcShape<DH>::kPitch>(s, qf, k_tile, lane);
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
template <int DH>
__device__ __forceinline__ void tc_pv_tile(float (&acc)[DH / 8][4],
                                           const unsigned (&qf)[DH / 16][4], const bf16* k_tile,
                                           const bf16* v_tile, int key0, TcLimits lim, float c,
                                           const float (&mc)[2], const float (&inv_l)[2],
                                           int lane) {
  constexpr int P = TcShape<DH>::kPitch;
  const int t = lane % 4;
  float s[2][4];
  mma_abt<P>(s, qf, k_tile, lane);
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
  mma_ab<P>(acc, pa, v_tile, lane);
}

// FULL: Dh = DH and 4-byte aligned output rows, so no column is tested;
// the other instantiation masks columns past Dh (a head width off 16).
// Measured on the H100: column tests in the FULL kernel cost it 2-15 %,
// and both paths in one kernel took 126 registers where one takes 94 (one
// block an SM at the vision chunk, 30 % slower), hence two kernels.
template <int DH, bool FULL>
__global__ void __launch_bounds__(32 * kTcMaxWarps)
attention_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o, int H, int S, int Dh,
             Strides qs, Strides ks, Strides vs, Strides os, int causal,
             float scale_log2e, int pairs) {
  using Sh = TcShape<DH>;
  constexpr int P = Sh::kPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_tiles = (S + kTcRows - 1) / kTcRows;
  const int kp = tc_key_rows(S);
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kp * P;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const bf16* kb_ptr = k + b * ks.b + h * ks.h;
  const bf16* vb_ptr = v + b * vs.b + h * vs.h;
  // 16-byte pieces of K's and V's rows; key rows past S and columns past
  // Dh are zero-filled (cp.async's source size), never read
  for (int e = threadIdx.x; e < kp * (DH / 8); e += blockDim.x) {
    const int j = e / (DH / 8), c = (e % (DH / 8)) * 8;
    const int bytes = j >= S ? 0 : FULL ? 16 : 2 * max(0, min(8, Dh - c));
    cp_async_part(k_s + j * P + c, bytes ? kb_ptr + j * ks.s + c : kb_ptr, bytes);
    cp_async_part(v_s + j * P + c, bytes ? vb_ptr + j * vs.s + c : vb_ptr, bytes);
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
    unsigned qf[Sh::kSteps][4];
    tc_load_q<FULL>(qf, qb, qs.s, ra, rb, S, Dh, t);
    const TcLimits lim{causal ? min(S, ra + 1) : S, causal ? min(S, rb + 1) : S,
                       causal ? min(S, r0 + 1) : S};
    const int n_kb = ((causal ? min(S, r0 + kTcRows) : S) + 15) / 16;
    const float c = scale_log2e;

    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
#pragma unroll 2
    for (int kb = 0; kb < n_kb; ++kb)
      tc_stats_tile<DH>(m, l, qf, k_s + kb * 16 * P, kb * 16, lim, c, lane);
    float mc[2], inv_l[2];
    tc_finish_stats(m, l, c, mc, inv_l);

    float acc[Sh::kTiles][4];
#pragma unroll
    for (int nt = 0; nt < Sh::kTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll 2
    for (int kb = 0; kb < n_kb; ++kb)
      tc_pv_tile<DH>(acc, qf, k_s + kb * 16 * P, v_s + kb * 16 * P, kb * 16, lim, c, mc,
                     inv_l, lane);
    store_tile_rows<FULL>(ob, os.s, acc, 1.f, ra, rb, ra < S, rb < S, Dh, pairs, t);
  }
}

// --- streamed bf16 kernel (S > kMaxResident) -------------------------------

constexpr int kMt = 2;                       // 16-row query tiles a warp
constexpr int kStreamWarps = 4;              // warps a block
constexpr int kWarpRows = 16 * kMt;          // query rows a warp
constexpr int kBlockRows = kStreamWarps * kWarpRows;
constexpr int kChunk = 64;                   // keys a ring stage
constexpr int kStages = 3;
constexpr int kTileBytes = kChunk * kTcHeadDim * static_cast<int>(sizeof(bf16));  // 8 KB
// 1024-byte aligned: the ring (a K tile and a V tile a stage, 128-byte rows
// swizzled), the block's query rows, the stages' barriers
constexpr int kStreamSmem = 1024 + kStages * 2 * kTileBytes +
                            kBlockRows * kTcPitch * static_cast<int>(sizeof(bf16)) +
                            kStages * static_cast<int>(sizeof(unsigned long long));

// The block's warps each own 32 query rows of one (batch, head), all of
// them in shared memory.  K tiles (pass 1), then K and V tiles (pass 2) of
// 64 keys stream through a three-stage ring that the copy engine fills two
// chunks ahead (one tensor-map load a tile, issued by thread 0, counted on
// the stage's barrier); pass 1 takes each row's max and sum (rescaled a
// chunk at a time), pass 2 the normalised probabilities, rounded, into P.V.
__global__ void __launch_bounds__(32 * kStreamWarps, 3)
attention_tc_stream(const bf16* __restrict__ q, bf16* __restrict__ o, int H, int S,
                    Strides qs, Strides os, int causal, float scale_log2e,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, TileCoords k_tc,
                    TileCoords v_tc) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<unsigned long long>(smem_raw) + 1023) & ~1023ull);
  bf16* q_s = reinterpret_cast<bf16*>(ring + kStages * 2 * kTileBytes);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(q_s + kBlockRows * kTcPitch);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int units = (S + kWarpRows - 1) / kWarpRows;
  const int u_first = tile_begin(blockIdx.y, gridDim.y, units);
  const int u_end = tile_begin(blockIdx.y + 1, gridDim.y, units);
  // keys any of the block's rows sees
  const int block_keys = causal ? min(S, u_end * kWarpRows) : S;
  const int n_chunks = (block_keys + kChunk - 1) / kChunk;
  const int total = 2 * n_chunks;              // pass 1's chunks, then pass 2's
  auto load = [&](int it) {                    // thread 0: chunk it into its stage
    const int st = it % kStages, j0 = (it % n_chunks) * kChunk;
    const bool with_v = it >= n_chunks;
    mbar_arrive_tx(&full[st], kTileBytes * (with_v ? 2 : 1));
    tma_tile(ring + st * 2 * kTileBytes, k_map, k_tc, j0, h, b, &full[st]);
    if (with_v)
      tma_tile(ring + st * 2 * kTileBytes + kTileBytes, v_map, v_tc, j0, h, b, &full[st]);
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&full[st], 1);
    mbar_fence_init();
    for (int i = 0; i < kStages - 1 && i < total; ++i) load(i);
  }
  // the block's query rows, zero past S
  rows_async(q_s, q + b * qs.b + h * qs.h, qs.s, u_first * kWarpRows,
             (u_end - u_first) * kWarpRows, S);
  cp_async_commit();
  cp_async_wait<0>();

  const int g = lane / 4, t = lane % 4;
  const int unit = u_first + warp;
  const bool live = unit < u_end;
  const int r0 = unit * kWarpRows;
  const bf16* q_rows = q_s + warp * kWarpRows * kTcPitch;
  int lim[kMt][2];                              // keys < lim are live for the row
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      lim[mt][half] = causal ? min(S, r0 + mt * 16 + g + 8 * half + 1) : S;
  const int lim_warp = causal ? min(S, r0 + 1) : S;   // the least of the rows' limits
  const int warp_keys = !live ? 0 : causal ? min(S, r0 + kWarpRows) : S;
  const float c = scale_log2e;

  float m[kMt][2], l[kMt][2], acc[kMt][kTcHeadDim / 8][4];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      m[mt][half] = -CUDART_INF_F;
      l[mt][half] = 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < kTcHeadDim / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }

  for (int it = 0; it < total; ++it) {
    __syncthreads();                           // every thread is done with it - 1 (and q is in)
    if (threadIdx.x == 0 && it + kStages - 1 < total) load(it + kStages - 1);  // into it - 1's stage
    const bool pass2 = it >= n_chunks;
    if (it == n_chunks) {                      // pass 1's statistics: m c and 1 / l
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          l[mt][half] += __shfl_xor_sync(kFullMask, l[mt][half], 1);
          l[mt][half] += __shfl_xor_sync(kFullMask, l[mt][half], 2);
          m[mt][half] *= c;
          l[mt][half] = 1.f / l[mt][half];
        }
    }
    const int key0 = (it % n_chunks) * kChunk;
    if (key0 >= warp_keys) continue;           // warp-uniform
    mbar_wait(&full[it % kStages], (it / kStages) & 1);
    const unsigned char* kc = ring + (it % kStages) * 2 * kTileBytes;
    float s[kMt][4][2][4];
    mma_abt_tiles<kTcPitch, kMt, 4>(s, q_rows, kc, 0, lane);
    if (key0 + kChunk > lim_warp) {            // some key reaches a row's limit: mask
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int kb = 0; kb < 4; ++kb)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (key0 + kb * 16 + nt * 8 + 2 * t + (e % 2) >= lim[mt][e / 2])
                s[mt][kb][nt][e] = -CUDART_INF_F;
    }
    if (!pass2) {
      // the quad's threads share their rows' max; the sum so far is
      // rescaled once a chunk (every row has a live key in the first)
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float x = -CUDART_INF_F;
#pragma unroll
          for (int kb = 0; kb < 4; ++kb)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
              x = fmaxf(x, fmaxf(s[mt][kb][nt][2 * half], s[mt][kb][nt][2 * half + 1]));
          x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
          x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
          const float mn = fmaxf(m[mt][half], x);
          const float mcr = mn * c;
          float sum = l[mt][half] * exp2_ftz(fmaf(m[mt][half], c, -mcr));
#pragma unroll
          for (int kb = 0; kb < 4; ++kb)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
              sum += exp2_ftz(fmaf(s[mt][kb][nt][2 * half], c, -mcr)) +
                     exp2_ftz(fmaf(s[mt][kb][nt][2 * half + 1], c, -mcr));
          l[mt][half] = sum;
          m[mt][half] = mn;
        }
      continue;
    }
    // P = exp2(c s - c m) / l rounded to bf16 (0 where masked), then P.V,
    // each V fragment feeding both row tiles
    const unsigned char* vc = kc + kTileBytes;
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      unsigned pa[kMt][4];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        float p[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[nt][e] = exp2_ftz(fmaf(s[mt][kb][nt][e], c, -m[mt][e / 2])) * l[mt][e / 2];
        pa[mt][0] = pack_bf16(p[0][0], p[0][1]);
        pa[mt][1] = pack_bf16(p[0][2], p[0][3]);
        pa[mt][2] = pack_bf16(p[1][0], p[1][1]);
        pa[mt][3] = pack_bf16(p[1][2], p[1][3]);
      }
      mma_ab_tiles<kMt>(acc, pa, vc, kb * 16, lane);
    }
  }
  if (!live) return;
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
    const int ra = r0 + mt * 16 + g;
    store_tile_rows<true>(o + b * os.b + h * os.h, os.s, acc[mt], 1.f, ra, ra + 8, ra < S,
                          ra + 8 < S, kTcHeadDim, true, t);
  }
}

// The resident kernel at width DH for a head of Dh <= DH (S <= kMaxResident).
template <int DH, bool FULL>
int launch_tc_kernel(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H,
                       int S, int Dh, Strides qs, Strides ks, Strides vs, Strides os,
                       int causal, float c, int pairs, cudaStream_t stream) {
  static int smem_set[64];
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(attention_tc<DH, FULL>),
                               static_cast<int>(tc_smem_bytes(kMaxResident, DH)), smem_set);
  if (err != cudaSuccess) return err;
  // One block per (batch, head); its warps take the 16-row tiles
  // round-robin, as many warps as make the rounds even.
  const int n_tiles = (S + kTcRows - 1) / kTcRows;
  const int rounds = (n_tiles + kTcMaxWarps - 1) / kTcMaxWarps;
  const int warps = (n_tiles + rounds - 1) / rounds;
  attention_tc<DH, FULL><<<B * H, 32 * warps, tc_smem_bytes(S, DH), stream>>>(
      q, k, v, o, H, S, Dh, qs, ks, vs, os, causal, c, pairs);
  return cudaGetLastError();
}

template <int DH>
int launch_tc_resident(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H,
                       int S, int Dh, Strides qs, Strides ks, Strides vs, Strides os,
                       int causal, float c, cudaStream_t stream) {
  const int pairs = Dh % 2 == 0 && aligned(o, 4) && os.b % 2 == 0 && os.s % 2 == 0 &&
                    os.h % 2 == 0;
  return Dh == DH && pairs
             ? launch_tc_kernel<DH, true>(q, k, v, o, B, H, S, Dh, qs, ks, vs, os, causal, c,
                                          pairs, stream)
             : launch_tc_kernel<DH, false>(q, k, v, o, B, H, S, Dh, qs, ks, vs, os, causal, c,
                                           pairs, stream);
}

int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int H,
              int S, int Dh, Strides qs, Strides ks, Strides vs, Strides os, int causal,
              float scale, cudaStream_t stream) {
  const float c = scale * 1.4426950408889634f;
  if (S > kMaxResident) {                      // Dh = kTcHeadDim (fwd_route)
    static int smem_set[64];
    cudaError_t err = allow_smem(reinterpret_cast<const void*>(attention_tc_stream),
                                 kStreamSmem, smem_set);
    if (err != cudaSuccess) return err;
    CUtensorMap k_map, v_map;
    TileCoords k_tc, v_tc;
    err = tile_map(&k_map, &k_tc, k, B, H, S, ks.s, ks.h, ks.b);
    if (err == cudaSuccess) err = tile_map(&v_map, &v_tc, v, B, H, S, vs.s, vs.h, vs.b);
    if (err != cudaSuccess) return err;
    // a block per (batch, head) and up to kStreamWarps 32-row units of its
    // queries, as even as the units allow
    const int units = (S + kWarpRows - 1) / kWarpRows;
    const dim3 grid(B * H, (units + kStreamWarps - 1) / kStreamWarps);
    attention_tc_stream<<<grid, 32 * kStreamWarps, kStreamSmem, stream>>>(
        static_cast<const bf16*>(q), static_cast<bf16*>(o), H, S, qs, os, causal, c, k_map,
        v_map, k_tc, v_tc);
    return cudaGetLastError();
  }
  const bf16 *qt = static_cast<const bf16*>(q), *kt = static_cast<const bf16*>(k),
             *vt = static_cast<const bf16*>(v);
  bf16* ot = static_cast<bf16*>(o);
  switch ((Dh + 15) / 16) {                    // the least multiple of 16 at or above Dh
    case 1:
      return launch_tc_resident<16>(qt, kt, vt, ot, B, H, S, Dh, qs, ks, vs, os, causal, c,
                                    stream);
    case 2:
      return launch_tc_resident<32>(qt, kt, vt, ot, B, H, S, Dh, qs, ks, vs, os, causal, c,
                                    stream);
    case 3:
      return launch_tc_resident<48>(qt, kt, vt, ot, B, H, S, Dh, qs, ks, vs, os, causal, c,
                                    stream);
    default:
      return launch_tc_resident<64>(qt, kt, vt, ot, B, H, S, Dh, qs, ks, vs, os, causal, c,
                                    stream);
  }
}

// --- f32 kernel: products on tensor cores in three TF32 terms ---------------

constexpr int kF32Warps = 4;                 // warps a block at most
constexpr int kMaxHeadDim = 128;

// The head dimension is padded to DHP (32, 64 or 128: zero in shared memory
// and in q's fragments).  A ring stage holds kKeys keys of K and of V, rows
// kPitch floats apart (= 4 mod 32: both fragment reads are conflict-free).
template <int DHP> struct F32Shape {
  static constexpr int kKeys = DHP <= 64 ? 64 : 32;
  static constexpr int kPitch = DHP + 4;
};

// Key rows j0 .. j0 + rows - 1 of K and V into a stage (zero past S and past
// Dh): 16-byte cp.async where rows are 16-byte aligned (vec), else 4 bytes.
template <int DHP>
__device__ __forceinline__ void f32_load_stage(float* k_dst, float* v_dst, const float* kb,
                                               const float* vb, long long kst, long long vst,
                                               int j0, int rows, int S, int Dh, bool vec) {
  constexpr int P = F32Shape<DHP>::kPitch;
  if (vec) {
    for (int e = threadIdx.x; e < rows * (DHP / 4); e += blockDim.x) {
      const int j = e / (DHP / 4), d = e % (DHP / 4) * 4;
      const bool in = j0 + j < S && d < Dh;
      const long long js = in ? j0 + j : 0;
      cp_async16(k_dst + j * P + d, kb + js * kst + (in ? d : 0), in);
      cp_async16(v_dst + j * P + d, vb + js * vst + (in ? d : 0), in);
    }
  } else {
    for (int e = threadIdx.x; e < rows * DHP; e += blockDim.x) {
      const int j = e / DHP, d = e % DHP;
      const bool in = j0 + j < S && d < Dh;
      const long long js = in ? j0 + j : 0;
      cp_async4(k_dst + j * P + d, kb + js * kst + (in ? d : 0), in);
      cp_async4(v_dst + j * P + d, vb + js * vst + (in ? d : 0), in);
    }
  }
}

// Each warp owns 16 query rows (a tile); a block holds `tiles` tiles of one
// (batch, head) and SPLITS warps per tile, split s taking keys s * KT ..
// (s + 1) * KT - 1 of every stage, merged at the end.  flags: 1 = k and v
// rows 16-byte aligned, 2 = o rows 8-byte aligned with an even Dh.
template <int DHP, int SPLITS>
__global__ void __launch_bounds__(32 * kF32Warps)
attention_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int H, int S, int Dh,
              Strides qs, Strides ks, Strides vs, Strides os, int causal, float c, int flags) {
  constexpr int P = F32Shape<DHP>::kPitch, KEYS = F32Shape<DHP>::kKeys;
  constexpr int KT = KEYS / SPLITS, NT = KT / 8, KK = DHP / 8;
  constexpr int KQ = DHP <= 64 ? KK : 1;      // q kept split in registers up to 64
  constexpr int kGroup = NT < 4 ? NT : 4;     // 8-key tiles whose products interleave
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);

  const int tiles = blockDim.x / 32 / SPLITS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int tile = warp % tiles, split = warp / tiles;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int r0 = (blockIdx.y * tiles + tile) * 16;
  const int ra = r0 + g, rb = ra + 8;
  const int lim_a = causal ? min(S, ra + 1) : S, lim_b = causal ? min(S, rb + 1) : S;
  const int lim_warp = causal ? min(S, r0 + 1) : S;
  const int warp_keys = r0 >= S ? 0 : (causal ? min(S, r0 + 16) : S);
  const int block_keys = causal ? min(S, (blockIdx.y + 1) * tiles * 16) : S;
  const int n_chunks = (block_keys + KEYS - 1) / KEYS;
  // S <= KEYS: one stage of S keys rounded to 16; else a two-stage ring
  const int stage_rows = S > KEYS ? KEYS : (S + 15) & ~15;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const bool vec = flags & 1;

  f32_load_stage<DHP>(ring, ring + stage_rows * P, kb, vb, ks.s, vs.s, 0, stage_rows, S, Dh,
                      vec);
  cp_async_commit();

  // q's A fragments of rows ra and rb (zero past S and Dh)
  float qf[KK][4];
  {
    const float* qb = q + b * qs.b + h * qs.h;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e % 2 ? rb : ra, d = kk * 8 + t + (e / 2) * 4;
        qf[kk][e] = r < S && d < Dh ? __ldg(qb + r * qs.s + d) : 0.f;
      }
  }
  unsigned qh[KQ][4], ql[KQ][4];
  if constexpr (DHP <= 64) {
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(qf[kk][e], qh[kk][e], ql[kk][e]);
  }

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  float acc[KK][4];
#pragma unroll
  for (int nd = 0; nd < KK; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      float* next = ring + ((ch + 1) & 1) * 2 * stage_rows * P;
      f32_load_stage<DHP>(next, next + stage_rows * P, kb, vb, ks.s, vs.s, (ch + 1) * KEYS,
                          stage_rows, S, Dh, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* k_st = ring + (ch & 1) * 2 * stage_rows * P + split * KT * P;
    const float* v_st = k_st + stage_rows * P;
    const int key0 = ch * KEYS + split * KT;
    const int n_live = min(NT, (warp_keys - key0 + 7) / 8);   // warp-uniform 8-key tiles
    if (n_live > 0) {
      // s = q k^T over the warp's KT keys
      float s[NT][4], s_lo[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = s_lo[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        unsigned ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (DHP <= 64) {
            ah[e] = qh[kk][e];
            al[e] = ql[kk][e];
          } else {
            split_tf32(qf[kk][e], ah[e], al[e]);
          }
        }
#pragma unroll
        for (int n0 = 0; n0 < NT; n0 += kGroup) {
          unsigned bh[kGroup][2], bl[kGroup][2];
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            if (n0 + j < n_live)
              b_frag_rows(bh[j], bl[j], k_st + (n0 + j) * 8 * P + kk * 8, P, g, t);
          mma_3xtf32_apart<kGroup>(s + n0, s_lo + n0, ah, al, bh, bl, n_live - n0);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] += s_lo[nt][e];
      // online softmax: the quad's rows share m; l is each thread's part
      const bool masked = key0 + NT * 8 > lim_warp;
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + nt * 8 + 2 * t + e % 2;
          if (nt >= n_live || (masked && key >= (e < 2 ? lim_a : lim_b))) s[nt][e] = -CUDART_INF_F;
          mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
        }
      float mc[2], alpha[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(kFullMask, mx[half], 1));
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(kFullMask, mx[half], 2));
        const float mn = fmaxf(m[half], mx[half]);
        mc[half] = mn == -CUDART_INF_F ? 0.f : mn * c;      // no live key yet: add nothing
        alpha[half] = exp2f(fmaf(m[half], c, -mc[half]));
        m[half] = mn;
        l[half] *= alpha[half];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = exp2f(fmaf(s[nt][e], c, -mc[e / 2]));
          l[e / 2] += s[nt][e];
        }
      // acc = alpha acc + P v, the stage's P v summed apart: the tensor core
      // rounds its sums toward zero, which over many stages of one sign drifts
      float pv[KK][4];
#pragma unroll
      for (int nd = 0; nd < KK; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[nd][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < NT; ++kt) {
        if (kt < n_live) {
          unsigned ph[4], pl[4];
          c_to_a(s[kt], ph, pl);
#pragma unroll
          for (int n0 = 0; n0 < KK; n0 += 4) {
            unsigned bh[4][2], bl[4][2];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              b_frag_cols(bh[j], bl[j], v_st + kt * 8 * P + (n0 + j) * 8, P, g, t);
            mma_3xtf32<4>(pv + n0, ph, pl, bh, bl, 4);
          }
        }
      }
#pragma unroll
      for (int nd = 0; nd < KK; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] = fmaf(acc[nd][e], alpha[e / 2], pv[nd][e]);
    }
    __syncthreads();                              // the stage is refilled next
  }

  if constexpr (SPLITS > 1) {
    // splits 1.. hand their (m, l, acc) to split 0 through the idle ring
    constexpr int kVals = 4 + 4 * KK;
    if (split > 0) {
      float* dst = ring + ((split - 1) * tiles + tile) * kVals * 32 + lane;
      dst[0] = m[0];
      dst[32] = m[1];
      dst[64] = l[0];
      dst[96] = l[1];
#pragma unroll
      for (int nd = 0; nd < KK; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[(4 + nd * 4 + e) * 32] = acc[nd][e];
    }
    __syncthreads();
    if (split > 0) return;
#pragma unroll
    for (int sp = 1; sp < SPLITS; ++sp) {
      const float* src = ring + ((sp - 1) * tiles + tile) * kVals * 32 + lane;
      float fa[2], fb[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float mo = src[half * 32];
        const float mn = fmaxf(m[half], mo);
        const float mcn = mn == -CUDART_INF_F ? 0.f : mn * c;
        fa[half] = exp2f(fmaf(m[half], c, -mcn));
        fb[half] = exp2f(fmaf(mo, c, -mcn));
        l[half] = l[half] * fa[half] + src[(2 + half) * 32] * fb[half];
        m[half] = mn;
      }
#pragma unroll
      for (int nd = 0; nd < KK; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[nd][e] = acc[nd][e] * fa[e / 2] + src[(4 + nd * 4 + e) * 32] * fb[e / 2];
    }
  }

  float inv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(kFullMask, l[half], 1);
    l[half] += __shfl_xor_sync(kFullMask, l[half], 2);
    inv[half] = 1.f / l[half];
  }
  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int nd = 0; nd < KK; ++nd) {
    const int d = nd * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? rb : ra;
      if (r >= S || d >= Dh) continue;
      const float x0 = acc[nd][2 * half] * inv[half], x1 = acc[nd][2 * half + 1] * inv[half];
      float* dst = ob + r * os.s + d;
      if (flags & 2) {
        *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
      } else {
        dst[0] = x0;
        if (d + 1 < Dh) dst[1] = x1;
      }
    }
  }
}

// Dynamic shared memory of a block: the ring (a stage of S keys rounded to
// 16 at S <= kKeys), or the splits' hand-over if larger.
template <int DHP, int SPLITS>
size_t f32_smem_bytes(int S, int tiles) {
  using Sh = F32Shape<DHP>;
  const size_t rows = S > Sh::kKeys ? Sh::kKeys : (S + 15) & ~15;
  const size_t ring = (S > Sh::kKeys ? 2 : 1) * 2 * rows * Sh::kPitch * sizeof(float);
  const size_t merge = (SPLITS - 1) * static_cast<size_t>(tiles) * (4 + DHP / 2) * 32 *
                       sizeof(float);
  return ring > merge ? ring : merge;
}

template <int DHP, int SPLITS>
int launch_f32_t(const float* q, const float* k, const float* v, float* o, int B, int H, int S,
                 int Dh, Strides qs, Strides ks, Strides vs, Strides os, int causal, float c,
                 int flags, cudaStream_t stream) {
  static int smem_set[64];
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(attention_f32<DHP, SPLITS>),
                               static_cast<int>(f32_smem_bytes<DHP, SPLITS>(1 << 20, kF32Warps)),
                               smem_set);
  if (err != cudaSuccess) return err;
  // as many tiles a block as make the blocks of a (batch, head) even
  const int n_tiles = (S + 15) / 16;
  const int most = kF32Warps / SPLITS;
  const int blocks_y = (n_tiles + most - 1) / most;
  const int tiles = (n_tiles + blocks_y - 1) / blocks_y;
  const size_t smem = f32_smem_bytes<DHP, SPLITS>(S, tiles);
  attention_f32<DHP, SPLITS><<<dim3(B * H, blocks_y), 32 * tiles * SPLITS, smem, stream>>>(
      q, k, v, o, H, S, Dh, qs, ks, vs, os, causal, c, flags);
  return cudaGetLastError();
}

using F32Launch = int (*)(const float*, const float*, const float*, float*, int, int, int, int,
                          Strides, Strides, Strides, Strides, int, float, int, cudaStream_t);
constexpr F32Launch kF32Launch[3][3] = {
    {launch_f32_t<32, 1>, launch_f32_t<32, 2>, launch_f32_t<32, 4>},
    {launch_f32_t<64, 1>, launch_f32_t<64, 2>, launch_f32_t<64, 4>},
    {launch_f32_t<128, 1>, launch_f32_t<128, 2>, launch_f32_t<128, 4>}};

int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H,
               int S, int Dh, Strides qs, Strides ks, Strides vs, Strides os,
               int causal, float scale, cudaStream_t stream) {
  const int dhp = Dh <= 32 ? 0 : Dh <= 64 ? 1 : 2;
  const int n = key_splits(static_cast<long long>(B) * H * ((S + 15) / 16));
  const int splits = n == 1 ? 0 : n == 2 ? 1 : 2;
  auto rows16 = [](const void* p, const Strides& s) {
    return aligned(p, 16) && s.b % 4 == 0 && s.s % 4 == 0 && s.h % 4 == 0;
  };
  const int flags = (Dh % 4 == 0 && rows16(k, ks) && rows16(v, vs) ? 1 : 0) |
                    (Dh % 2 == 0 && aligned(o, 8) && os.b % 2 == 0 && os.s % 2 == 0 &&
                             os.h % 2 == 0 ? 2 : 0);
  return kF32Launch[dhp][splits](static_cast<const float*>(q), static_cast<const float*>(k),
                                 static_cast<const float*>(v), static_cast<float*>(o), B, H, S,
                                 Dh, qs, ks, vs, os, causal, scale * 1.4426950408889634f, flags,
                                 stream);
}

// --- f32 wide-head kernel (f32 above Dh = 128, tensor cores) ----------------

constexpr int kF32WideWarps = 8;             // warps a block at most
constexpr int kF32WideKeys = 16;             // keys a warp takes of a stage
constexpr int kF32WideNT = kF32WideKeys / 8;
constexpr int kF32WideVals = 4 + 4 * kF32WideUnits;   // a lane's (m, l, acc): a split's hand-over

// Floats of a ring stage: K's W chunks of `keys` rows, V's, then at R > 1
// the block's `rows` query rows' W chunks (at R = 1 staged once).
__host__ __device__ inline int f32_wide_stage(const F32Wide& sh, int rows, int keys) {
  return sh.W * (2 * keys + (sh.R > 1 ? rows : 0)) * kF32WidePitch;
}

// Dynamic shared floats of a block of `tiles` row tiles and `splits`: the
// two-stage ring (or the splits' hand-over, if larger), the query rows at R
// = 1, then each warp's slot of partial scores.
__host__ __device__ inline int f32_wide_floats(const F32Wide& sh, int tiles, int splits) {
  const int rows = 16 * tiles, warps = splits * tiles * sh.W;
  const int ring = 2 * f32_wide_stage(sh, rows, kF32WideKeys * splits);
  const int merge = (splits - 1) * tiles * sh.W * kF32WideVals * 32;
  return (ring > merge ? ring : merge) + (sh.R > 1 ? 0 : sh.W * rows * kF32WidePitch) +
         warps * kF32WideNT * 128;
}

// A block takes `tiles` 16-row query tiles of one (batch, head), as even as
// the tiles allow, W warps a tile, warp w owning chunk z W + w of the
// output's columns (z = blockIdx.z; common.cuh, f32 wide-head attention).
// Where the grid is thin (R = 1), `splits` sets of those warps take a
// tile's keys, set s the keys 16 s .. 16 s + 15 of every stage, and merge
// (m, l, acc) at the end in a fixed order, as attention_f32's splits do.
// Its items: the key tiles of 16 splits keys (the live keys alone), each
// over the R rounds with its own round last, through a two-stage cp.async
// ring filled one item ahead (one barrier an item): K's W chunks, at R > 1
// the query rows' (at R = 1 they are staged once), and at the own round V's.
// Each warp takes q k^T over its chunk of the round (hi.hi apart from the
// small terms) and at a tile's last round the W shares are summed through
// shared memory (a second barrier); then attention_f32's one pass: the
// online softmax, each warp the same, and acc = alpha acc + P V over its
// columns, the tile's P V summed apart.  flags: 1 = q, k and v rows 16-byte
// aligned with Dh a multiple of 4, 2 = o rows 8-byte aligned with an even
// Dh.
__global__ void __launch_bounds__(32 * kF32WideWarps, 2)
attention_wide(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int H, int S, int Dh,
               Strides qs, Strides ks, Strides vs, Strides os, int causal, float c, int flags,
               int splits) {
  constexpr int P = kF32WidePitch, NT = kF32WideNT;
  extern __shared__ __align__(16) unsigned char smem[];
  const F32Wide sh(Dh);
  const int nd = sh.nd, R = sh.R, W = sh.W, z = blockIdx.z;
  const int tiles = blockDim.x / 32 / W / splits;
  const int keys = kF32WideKeys * splits;        // keys a stage
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // the warp's chunk of a round, its row tile, its split
  const int wc = warp % W, tile = warp / W % tiles, split = warp / W / tiles;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tiles16 = (S + 15) / 16;
  const int u_first = tile_begin(blockIdx.y, gridDim.y, tiles16);
  const int u_end = tile_begin(blockIdx.y + 1, gridDim.y, tiles16);
  const int r_first = u_first * 16, n_rows = (u_end - u_first) * 16;
  const int rows = 16 * tiles;
  const int block_keys = causal ? min(S, u_end * 16) : S;   // keys any of its rows sees
  const int n_tiles = (block_keys + keys - 1) / keys;
  const int n_items = n_tiles * R;
  const int stage = f32_wide_stage(sh, rows, keys);
  float* ring = reinterpret_cast<float*>(smem);
  // R = 1: the query rows' chunks, after the ring or the splits' hand-over
  float* q_res = ring + max(2 * stage, (splits - 1) * tiles * W * kF32WideVals * 32);
  float* slots = q_res + (R > 1 ? 0 : W * rows * P);
  const bool vec = flags & 1;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  // the next item's copies (every thread), one commit group an item, empty
  // past the last
  F32Item ld(R, z);
  int n_loaded = 0;
  auto load = [&]() {
    if (n_loaded < n_items) {
      float* st = ring + (n_loaded & 1) * stage;
      const F32Item& w = ld;
      const int k0 = w.tile * keys, n_keys = (min(keys, block_keys - k0) + 7) & ~7;
      for (int j = 0; j < W && w.round * W + j < nd; ++j) {
        const int cc = w.round * W + j, c0 = sh.begin(cc), wd = sh.width(cc);
        f32_chunk_async(st + j * keys * P, kb, ks.s, k0, n_keys, S, c0, wd, Dh, vec);
        if (w.i == R - 1)
          f32_chunk_async(st + (W + j) * keys * P, vb, vs.s, k0, n_keys, S, c0, wd, Dh, vec);
        if (R > 1)
          f32_chunk_async(st + (2 * W * keys + j * rows) * P, qb, qs.s, r_first, n_rows, S, c0,
                          wd, Dh, vec);
      }
      ld.next(R, n_tiles, z);
    }
    ++n_loaded;
    cp_async_commit();
  };
  if (R == 1)
    for (int j = 0; j < W; ++j)
      f32_chunk_async(q_res + j * rows * P, qb, qs.s, r_first, n_rows, S, sh.begin(j),
                      sh.width(j), Dh, vec);
  load();

  const int unit = u_first + tile;
  const bool live = unit < u_end;
  const int r0 = unit * 16;
  const int ra = r0 + g, rb = ra + 8;
  const int lim_a = causal ? min(S, ra + 1) : S, lim_b = causal ? min(S, rb + 1) : S;
  const int lim_warp = causal ? min(S, r0 + 1) : S;    // the least of the rows' limits
  const int warp_keys = !live ? 0 : causal ? min(S, r0 + 16) : S;
  const int own = z * W + wc;                          // the warp's output chunk
  const int z8 = own < nd ? sh.width(own) / 8 : 0, zc0 = own < nd ? sh.begin(own) : 0;
  float* tile_slots = slots + (split * tiles + tile) * W * NT * 128;   // its W warps' shares

  float s[NT][4], s_lo[NT][4], acc[kF32WideUnits][4];
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kF32WideUnits; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  F32Item w(R, z);
  for (int it = 0; it < n_items; ++it, w.next(R, n_tiles, z)) {
    cp_async_wait<0>();                          // item it has landed ...
    __syncthreads();                             // ... for every thread; it - 1 is done
    load();                                      // item it + 1, into it - 1's stage
    const float* st = ring + (it & 1) * stage;
    const int kw = split * kF32WideKeys;         // the warp's keys in the stage
    const int key0 = w.tile * keys + kw;
    const int n_live = min(NT, (warp_keys - key0 + 7) / 8);   // the same for a tile's W warps
    const int cc = w.round * W + wc;
    if (n_live > 0) {
      if (w.i == 0) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = s_lo[nt][e] = 0.f;
      }
      if (cc < nd) {
        const float* a = R > 1 ? st + (2 * W * keys + wc * rows + tile * 16) * P
                               : q_res + (wc * rows + tile * 16) * P;
        f32_wide_abt<NT, false>(s, s_lo, a, st + (wc * keys + kw) * P, sh.width(cc) >> 3,
                                n_live, g, t);
      }
    }
    if (w.i < R - 1) continue;                   // the shares are whole at the last round
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] += s_lo[nt][e];
    if (n_live > 0) xchg_put<NT>(tile_slots + wc * NT * 128, s, lane);
    __syncthreads();                             // every share is in
    if (n_live <= 0) continue;
    xchg_sum<NT>(s, tile_slots, W, lane);
    // online softmax: the quad's rows share m; l is each thread's part
    const bool masked = key0 + NT * 8 > lim_warp;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + nt * 8 + 2 * t + e % 2;
        if (nt >= n_live || (masked && key >= (e < 2 ? lim_a : lim_b))) s[nt][e] = -CUDART_INF_F;
        mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
      }
    float mc[2], alpha[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(kFullMask, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(kFullMask, mx[half], 2));
      const float mn = fmaxf(m[half], mx[half]);
      mc[half] = mn == -CUDART_INF_F ? 0.f : mn * c;      // no live key yet: add nothing
      alpha[half] = exp2f(fmaf(m[half], c, -mc[half]));
      m[half] = mn;
      l[half] *= alpha[half];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(fmaf(s[nt][e], c, -mc[e / 2]));
        l[e / 2] += s[nt][e];
      }
    // acc = alpha acc + P v over the warp's columns (V's chunk wc of the own
    // round), the tile's P v summed apart: the tensor core rounds its sums
    // toward zero
    float pv[kF32WideUnits][4];
#pragma unroll
    for (int n = 0; n < kF32WideUnits; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
    f32_wide_cb<NT, false>(pv, s, st + ((W + wc) * keys + kw) * P, n_live, z8, g, t);
#pragma unroll
    for (int n = 0; n < kF32WideUnits; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = fmaf(acc[n][e], alpha[e / 2], pv[n][e]);
  }

  if (splits > 1) {
    // splits 1.. hand their (m, l, acc) to split 0 through the idle ring
    __syncthreads();                             // every thread is done with the ring
    const int at = (tile * W + wc) * kF32WideVals * 32 + lane;   // a split's set of slots
    if (split > 0) {
      float* dst = ring + (split - 1) * tiles * W * kF32WideVals * 32 + at;
      dst[0] = m[0];
      dst[32] = m[1];
      dst[64] = l[0];
      dst[96] = l[1];
#pragma unroll
      for (int n = 0; n < kF32WideUnits; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[(4 + n * 4 + e) * 32] = acc[n][e];
    }
    __syncthreads();
    if (split > 0) return;
    for (int sp = 1; sp < splits; ++sp) {
      const float* src = ring + (sp - 1) * tiles * W * kF32WideVals * 32 + at;
      float fa[2], fb[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float mo = src[half * 32];
        const float mn = fmaxf(m[half], mo);
        const float mcn = mn == -CUDART_INF_F ? 0.f : mn * c;
        fa[half] = exp2f(fmaf(m[half], c, -mcn));
        fb[half] = exp2f(fmaf(mo, c, -mcn));
        l[half] = l[half] * fa[half] + src[(2 + half) * 32] * fb[half];
        m[half] = mn;
      }
#pragma unroll
      for (int n = 0; n < kF32WideUnits; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = acc[n][e] * fa[e / 2] + src[(4 + n * 4 + e) * 32] * fb[e / 2];
    }
  }
  if (!live || z8 == 0) return;
  float inv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(kFullMask, l[half], 1);
    l[half] += __shfl_xor_sync(kFullMask, l[half], 2);
    inv[half] = 1.f / l[half];
  }
  f32_wide_store(o + b * os.b + h * os.h, os.s, acc, inv, ra, S, zc0, min(Dh, zc0 + 8 * z8),
                 flags & 2, t);
}

int launch_wide(const void* q, const void* k, const void* v, void* o, int B, int H, int S,
                int Dh, Strides qs, Strides ks, Strides vs, Strides os, int causal, float scale,
                cudaStream_t stream) {
  static int smem_set[64];
  // the most any call takes: two splits of four warps at R = 1 (Dh = 256)
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(attention_wide),
                                     4 * f32_wide_floats(F32Wide(256), 1, 2), smem_set);
  if (err != cudaSuccess) return err;
  auto rows16 = [](const void* p, const Strides& s) {
    return aligned(p, 16) && s.b % 4 == 0 && s.s % 4 == 0 && s.h % 4 == 0;
  };
  const int flags = (Dh % 4 == 0 && rows16(q, qs) && rows16(k, ks) && rows16(v, vs) ? 1 : 0) |
                    (Dh % 2 == 0 && aligned(o, 8) && os.b % 2 == 0 && os.s % 2 == 0 &&
                             os.h % 2 == 0 ? 2 : 0);
  // a block per (batch, head), up to kF32WideWarps / (W splits) 16-row
  // tiles of its queries as even as the tiles allow, and round z of the
  // output's chunks; splits (at R = 1) where the warps alone give fewer than
  // two to each of the card's four sub-partitions an SM (key_splits), at
  // most one a 16 keys of S
  const F32Wide sh(Dh);
  const int tiles16 = (S + 15) / 16;
  const int splits = sh.R > 1 ? 1
                              : min(min(key_splits(static_cast<long long>(B) * H * tiles16 * sh.W),
                                        kF32WideWarps / sh.W),
                                    (S + kF32WideKeys - 1) / kF32WideKeys);
  const int most = kF32WideWarps / (sh.W * splits);
  const int blocks_y = (tiles16 + most - 1) / most;
  const int tiles = (tiles16 + blocks_y - 1) / blocks_y;
  attention_wide<<<dim3(B * H, blocks_y, sh.R), 32 * sh.W * tiles * splits,
                   4 * f32_wide_floats(sh, tiles, splits), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, S, Dh, qs, ks, vs, os, causal, scale * 1.4426950408889634f,
      flags, splits);
  return cudaGetLastError();
}

// --- bf16 wide-head kernel (bf16 above Dh = 64, tensor cores) ----------------

constexpr int kWideWarps = 8;                // 16-row query tiles a block at most
constexpr int kWideKeys = 64;                // keys a streamed tile at most
constexpr int kWideNK = kWideKeys / 16;
// Elements of a ring stage: a K tile and a V tile of `keys` rows, and at
// nd > 1 the block's `rows` query rows of the item's chunk.
__host__ __device__ inline int wide_stage_elems(const WideChunks& ch, int rows, int keys) {
  return (2 * keys + (ch.nd > 1 ? rows : 0)) * ch.pitch();
}

// Dynamic shared bytes of a block: a two-stage ring, and at nd = 1 the
// query rows.
inline int wide_smem_bytes(const WideChunks& ch, int rows, int keys) {
  return static_cast<int>(sizeof(bf16)) *
         (2 * wide_stage_elems(ch, rows, keys) + (ch.nd > 1 ? 0 : rows * ch.pitch()));
}

// A block takes up to kWideWarps 16-row query tiles of one (batch, head),
// a warp each, and writes the output columns of chunk blockIdx.z (common.cuh,
// bf16 wide-head attention).  Its items, in order: pass 1's key tiles, then
// pass 2's, each over the nd chunks with the block's own chunk last.  A
// two-stage cp.async ring, filled one item ahead (one barrier an item),
// holds an item's K chunk (`keys` rows a tile, the live keys alone), at nd
// > 1 the query rows' chunk (at nd = 1 they are staged once), and at pass
// 2's last chunk V's rows of the block's chunk.  s = q k^T accumulates over
// the chunks in registers; at a tile's last chunk pass 1 takes each row's
// max and sum, and pass 2 forms P = exp2(c s - c m) / l, rounds it to bf16
// in the mma A-fragment layout and accumulates P.V.  pairs: o's rows take
// 4-byte stores.
__global__ void __launch_bounds__(32 * kWideWarps)
attention_wide_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int H, int S, int Dh,
                  Strides qs, Strides ks, Strides vs, Strides os, int causal, float c,
                  int keys, int pairs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WideChunks ch(Dh);
  const int P = ch.pitch(), nd = ch.nd, z = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tiles16 = (S + 15) / 16;
  const int u_first = tile_begin(blockIdx.y, gridDim.y, tiles16);
  const int u_end = tile_begin(blockIdx.y + 1, gridDim.y, tiles16);
  const int r_first = u_first * 16, n_rows = (u_end - u_first) * 16;
  const int rows = blockDim.x / 32 * 16;         // query rows a stage holds
  const int block_keys = causal ? min(S, u_end * 16) : S;   // keys any of its rows sees
  const int n_tiles = (block_keys + keys - 1) / keys;
  const int per_pass = n_tiles * nd, n_items = 2 * per_pass;
  const int stage_elems = wide_stage_elems(ch, rows, keys);
  bf16* q_res = reinterpret_cast<bf16*>(smem);   // nd = 1: the query rows
  bf16* ring = q_res + (nd > 1 ? 0 : rows * P);
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;

  // item it's copies (every thread), one commit group an item, empty past
  // the last
  auto load = [&](int it) {
    if (it < n_items) {
      bf16* st = ring + (it & 1) * stage_elems;
      const WideItem w(it, n_tiles, nd, z);
      const int k0 = w.tile * keys, c0 = ch.begin(w.chunk), wd = ch.width(w.chunk);
      const int n_keys = (min(keys, block_keys - k0) + 15) & ~15;
      chunk_async(st, P, kb, ks.s, k0, n_keys, S, c0, wd, Dh);
      if (it >= per_pass && w.i == nd - 1)
        chunk_async(st + keys * P, P, vb, vs.s, k0, n_keys, S, c0, wd, Dh);
      if (nd > 1) chunk_async(st + 2 * keys * P, P, qb, qs.s, r_first, n_rows, S, c0, wd, Dh);
    }
    cp_async_commit();
  };
  if (nd == 1) chunk_async(q_res, P, qb, qs.s, r_first, n_rows, S, 0, ch.width(0), Dh);
  load(0);

  const int unit = u_first + warp;
  const bool live = unit < u_end;
  const int r0 = unit * 16;
  const int lim_a = causal ? min(S, r0 + g + 1) : S;   // keys < lim are live for the row
  const int lim_b = causal ? min(S, r0 + g + 9) : S;
  const int lim_warp = causal ? min(S, r0 + 1) : S;    // the least of the rows' limits
  const int warp_keys = !live ? 0 : causal ? min(S, r0 + 16) : S;
  const int zc0 = ch.begin(z), z16 = ch.width(z) / 16;

  float s[kWideNK][2][4], acc[2 * kWideUnits][4];
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 2 * kWideUnits; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    cp_async_wait<0>();                          // item it has landed ...
    __syncthreads();                             // ... for every thread; it - 1 is done
    load(it + 1);                                // into it - 1's stage
    if (it == per_pass) {                        // pass 1's statistics: m c and 1 / l
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        l[half] += __shfl_xor_sync(kFullMask, l[half], 1);
        l[half] += __shfl_xor_sync(kFullMask, l[half], 2);
        m[half] *= c;
        l[half] = 1.f / l[half];
      }
    }
    const bf16* st = ring + (it & 1) * stage_elems;
    const WideItem w(it, n_tiles, nd, z);
    const int k0 = w.tile * keys;
    const int live16 = min(keys / 16, (warp_keys - k0 + 15) / 16);   // warp-uniform
    if (live16 <= 0) continue;
    if (w.i == 0) {
#pragma unroll
      for (int kb = 0; kb < kWideNK; ++kb)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[kb][nt][e] = 0.f;
    }
    const bf16* a = nd > 1 ? st + (2 * keys + warp * 16) * P : q_res + warp * 16 * P;
    mma_abt_rows<kWideNK>(s, a, P, st, P, ch.width(w.chunk) / 16, live16, lane);
    if (w.i < nd - 1) continue;                  // the tile's scores are whole at its last chunk
    if (k0 + 16 * live16 > lim_warp) {           // some key reaches a row's limit: mask
#pragma unroll
      for (int kb = 0; kb < kWideNK; ++kb)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + kb * 16 + nt * 8 + 2 * t + (e % 2) >= (e < 2 ? lim_a : lim_b))
              s[kb][nt][e] = -CUDART_INF_F;
    }
    if (it < per_pass) {
      // the quad's threads share their rows' max; the sum so far is
      // rescaled once a tile (every row has a live key in the first)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float x = -CUDART_INF_F;
#pragma unroll
        for (int kb = 0; kb < kWideNK; ++kb)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            if (kb < live16) x = fmaxf(x, fmaxf(s[kb][nt][2 * half], s[kb][nt][2 * half + 1]));
        x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
        x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
        const float mn = fmaxf(m[half], x), mcr = mn * c;
        float sum = l[half] * exp2_ftz(fmaf(m[half], c, -mcr));
#pragma unroll
        for (int kb = 0; kb < kWideNK; ++kb)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            if (kb < live16)
              sum += exp2_ftz(fmaf(s[kb][nt][2 * half], c, -mcr)) +
                     exp2_ftz(fmaf(s[kb][nt][2 * half + 1], c, -mcr));
        l[half] = sum;
        m[half] = mn;
      }
      continue;
    }
    // P = exp2(c s - c m) / l rounded to bf16 (0 where masked), then P.V over
    // the block's columns
#pragma unroll
    for (int kb = 0; kb < kWideNK; ++kb) {
      if (kb >= live16) break;
      float p[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[nt][e] = exp2_ftz(fmaf(s[kb][nt][e], c, -m[e / 2])) * l[e / 2];
      unsigned pa[4];
      c_to_a_bf16(p, pa);
      mma_ab_rows(acc, pa, st + (keys + kb * 16) * P, P, z16, lane);
    }
  }
  if (live)
    wide_store(o + b * os.b + h * os.h, os.s, acc, 1.f, r0 + g, S, zc0,
               min(Dh, zc0 + 16 * z16), pairs, t);
}

int launch_wide_tc(const void* q, const void* k, const void* v, void* o, int B, int H, int S,
                   int Dh, Strides qs, Strides ks, Strides vs, Strides os, int causal,
                   float scale, cudaStream_t stream) {
  // 16-byte cp.async rows of q, k and v (the caller copies others)
  const void* in[3] = {q, k, v};
  const Strides* st[3] = {&qs, &ks, &vs};
  for (int i = 0; i < 3; ++i)
    if (!aligned(in[i], 16) || st[i]->b % 8 || st[i]->s % 8 || st[i]->h % 8)
      return cudaErrorInvalidValue;
  static int smem_set[64];
  // the most any width takes: two 128-column chunks (Dh = 256), 128 query
  // rows and 64 keys (136 KB)
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(attention_wide_tc),
                                     wide_smem_bytes(WideChunks(256), 16 * kWideWarps, kWideKeys),
                                     smem_set);
  if (err != cudaSuccess) return err;
  // a block per (batch, head), up to kWideWarps 16-row tiles of its queries
  // as even as the tiles allow, and chunk z of the output's columns; tiles
  // of up to kWideKeys keys, S rounded to 16 at most
  const WideChunks ch(Dh);
  const int tiles16 = (S + 15) / 16;
  const int keys = min(kWideKeys, (S + 15) & ~15);
  const int blocks_y = (tiles16 + kWideWarps - 1) / kWideWarps;
  const int warps = (tiles16 + blocks_y - 1) / blocks_y;
  const int pairs = Dh % 2 == 0 && aligned(o, 4) && os.b % 2 == 0 && os.s % 2 == 0 &&
                    os.h % 2 == 0;
  attention_wide_tc<<<dim3(B * H, blocks_y, ch.nd), 32 * warps,
                       wide_smem_bytes(ch, 16 * warps, keys), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), H, S, Dh, qs, ks, vs, os, causal, scale * 1.4426950408889634f,
      keys, pairs);
  return cudaGetLastError();
}

// Routes of keds_attention_fwd.
enum FwdRoute : int { kRouteF32 = 0, kRouteTc = 1, kRouteWide = 2 };

// The route for `dtype` at head width Dh and sequence length S (-1: not
// taken); out[0] = the width the caller hands the inputs at, out[1] = the
// head width the kernel runs at (zero-padded past Dh in shared memory and
// registers).  bf16 up to kTcHeadDim runs the tensor-core kernels: resident
// at Dh rounded up to 16, streamed (S > kMaxResident) at kTcHeadDim, to
// which the caller zero-pads a narrower head; f32 up to kMaxHeadDim its own
// kernel (at 32, 64 or 128); wider heads the wide-head kernels (bf16 at Dh
// rounded up to 16, f32 to 8).
int fwd_route(int dtype, int Dh, int S, int* out) {
  if (Dh < 1 || S < 1 || (dtype != kFloat32 && dtype != kBFloat16)) return -1;
  out[0] = Dh;
  if (dtype == kFloat32) {
    out[1] = Dh <= 32 ? 32 : Dh <= 64 ? 64 : Dh <= kMaxHeadDim ? kMaxHeadDim : (Dh + 7) & ~7;
    return Dh <= kMaxHeadDim ? kRouteF32 : kRouteWide;
  }
  out[1] = (Dh + 15) & ~15;
  if (Dh > kTcHeadDim) return kRouteWide;
  if (S > kMaxResident) out[0] = out[1] = kTcHeadDim;
  return kRouteTc;
}

}  // namespace

extern "C" int keds_attention_fwd_route(int dtype, int Dh, int S, int* out) {
  return fwd_route(dtype, Dh, S, out);
}

// strides: 12 int64 values, (batch, seq, head) element strides of q, k, v, o.
// Dh is the width the caller hands the inputs at (keds_attention_fwd_route's
// out[0]).
extern "C" int keds_attention_fwd(const void* q, const void* k, const void* v,
                                  void* o, int dtype, int B, int H, int S,
                                  int Dh, const long long* strides, int causal,
                                  float scale, void* stream) {
  int out[2] = {0, 0};
  const int route = fwd_route(dtype, Dh, S, out);
  if (B * H < 1 || route < 0 || out[0] != Dh) return cudaErrorInvalidValue;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kRouteF32)
    return launch_f32(q, k, v, o, B, H, S, Dh, qs, ks, vs, os, causal, scale, st);
  if (route == kRouteTc)
    return launch_tc(q, k, v, o, B, H, S, Dh, qs, ks, vs, os, causal, scale, st);
  return dtype == kFloat32
             ? launch_wide(q, k, v, o, B, H, S, Dh, qs, ks, vs, os, causal, scale, st)
             : launch_wide_tc(q, k, v, o, B, H, S, Dh, qs, ks, vs, os, causal, scale, st);
}
