"""Exact maximum-inner-product top-k search (counterpart of
``keds_tpu/ops/topk.py`` and ``keds_tpu/ops/pallas_topk.py``).

:func:`mips_topk` does the knowledge-DB neighbour search and the corpus
ranking.  On CUDA tensors it launches the hand-written fused kernel
``csrc/topk.cu`` (which replaces the Pallas ``mips_topk_pallas``) or
raises: bf16 runs the tensor-core kernel (variant ``bf16_tc``), f32 the
exact-f32 CUDA-core kernel (variant ``f32``).  Above k = 32 both dtypes
take the CUDA-core kernel with lists of up to eight entries a lane (f32
counts as ``f32``, bf16 as ``bf16``), up to k = 256 in one pass.  A larger
k (the Pallas kernel has no cap) runs that kernel in ceil(k / 256) passes,
each bounded by the previous pass's last entry (``csrc/topk.cu``); each
pass counts as ``f32_multi`` or ``bf16_multi``.  On CPU tensors it runs the
plain version :func:`mips_topk_plain`.  Both order equal scores by lower
row index first.

:func:`mips_topk_sharded` searches a database whose rows are split over the
ranks of a mesh (the counterpart of faiss ``index_cpu_to_all_gpus``): each
rank runs :func:`mips_topk` on its shard, and the candidates are
all-gathered and merged in plain torch, (B, W·k) values.

The int8 backend (:func:`mips_topk_int8`, ROADMAP item 14) scores an int8
copy of the DB (:func:`quantize_int8`) with the s8 x s8 -> s32 product of
:mod:`keds_tpu_torch.ops.quant` (``torch._int_mm`` on the card, as the JAX
package leaves it to XLA), takes the top ``k * oversample`` candidates and
re-ranks them in f32 against the true (or dequantized) rows.  Equal scores
keep the lower index in both stages, as ``lax.top_k`` does.
:func:`mips_topk_approx` is the ``approx`` backend: ``lax.approx_max_k`` is
a TPU partial reduce, and off the TPU JAX lowers it to an exact top-k, so
here it is the exact search (B1 on the card).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from keds_tpu_torch.ops.cuda_build import CudaKernel, require_cuda, sm_count, stream_ptr
from keds_tpu_torch.ops.quant import by_127, int8_matmul, int8_matmul_plain
from keds_tpu_torch.parallel.mesh import all_gather

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("topk", {
    "keds_mips_topk": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "keds_topk_max_k": [],
    "keds_topk_query_tile": [_I],
    "keds_topk_chunk_rows": [_I],
    "keds_topk_tc_max_dim": [],
}, variants=("bf16_tc", "f32", "bf16", "f32_multi", "bf16_multi"))


class Tiling(NamedTuple):
    """One instantiation of the partial kernel in ``csrc/topk.cu``."""

    code: int           # the C interface's variant code
    variant: str        # launch-count key
    query_tile: int     # queries per block
    chunk_rows: int     # database rows per chunk
    blocks_per_sm: int  # blocks the split aims to run on each SM at once


# Mirrors of csrc/topk.cu's constants (a card test in tests/test_torch_cuda.py
# checks them against the library).  The bf16 kernel holds 210 KB of shared
# memory, so one block fits an SM; the f32 kernel's 33 KB let several run
# together.  k above LANE_K takes the wide tilings: 32-query tiles on CUDA
# cores, whose lists hold up to eight entries a lane.
TC = Tiling(2, "bf16_tc", 64, 128, 1)
F32 = Tiling(0, "f32", 64, 128, 4)
F32_SMALL = Tiling(1, "f32", 16, 32, 4)
F32_WIDE = Tiling(3, "f32", 32, 128, 4)
BF16_WIDE = Tiling(4, "bf16", 32, 128, 4)
TILINGS = (F32, F32_SMALL, TC, F32_WIDE, BF16_WIDE)
LANE_K = 32           # one list entry a lane
MAX_K = 256           # one pass of the wide kernel; a larger k takes several
TC_MAX_DIM = 1024     # the queries' fragments live in registers


def _check_k(k: int, n: int) -> None:
    if not 1 <= k <= n:
        raise ValueError(f"top-k needs 1 <= k <= N, got k={k}, N={n}")


def mips_topk_plain(queries: torch.Tensor, db: torch.Tensor,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch exact top-k: f32 scores, then a stable descending sort
    so that equal scores keep the lower index first."""
    _check_k(k, db.shape[0])
    scores = torch.matmul(queries.float(), db.float().T)
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32)


def split_plan(n_queries: int, n_rows: int, n_sms: int,
               dtype: torch.dtype, k: int = 1) -> Tuple[Tiling, int]:
    """(tiling, number of database slices) for the fused kernel.

    k above ``LANE_K`` takes the wide tiling of its dtype.  Otherwise bf16
    takes the tensor-core tiling, and f32 the 64 x 128 tiling unless its
    grid would leave three quarters of the SMs idle (a small database, such
    as a ranked corpus of a few hundred rows); then the 16 x 32 one.  The
    slices are sized so that the grid has ``blocks_per_sm`` blocks per SM
    where the database has chunks enough, and no slice is empty.  A slice
    may hold fewer than k rows: the merge skips the empty slots it leaves."""
    bf16 = dtype == torch.bfloat16
    if k > LANE_K:
        tiling = BF16_WIDE if bf16 else F32_WIDE
    else:
        tiling = TC if bf16 else F32
        big_blocks = -(-n_queries // F32.query_tile) * -(-n_rows // F32.chunk_rows)
        if tiling is F32 and big_blocks < n_sms // 4:
            tiling = F32_SMALL
    n_chunks = -(-n_rows // tiling.chunk_rows)
    q_tiles = -(-n_queries // tiling.query_tile)
    want = -(-tiling.blocks_per_sm * n_sms // q_tiles)
    return tiling, max(1, min(n_chunks, want))


def mips_topk(queries: torch.Tensor, db: torch.Tensor,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by inner product: queries (B, D), db (N, D) ->
    (values (B, k) f32, indices (B, k) int32), best first, ties to the lower
    index."""
    if queries.device.type == "cpu":
        return mips_topk_plain(queries, db, k)
    require_cuda(queries, db)
    B, D = queries.shape
    N = db.shape[0]
    _check_k(k, N)
    if queries.dtype != db.dtype or queries.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"top-k kernel takes f32 or bf16 inputs of one dtype, "
                         f"got {queries.dtype} and {db.dtype}")
    tiling, n_splits = split_plan(B, N, sm_count(queries), queries.dtype, k)
    step = 64 if tiling is TC else 32
    if db.shape[1] != D or D % step or (tiling is TC and D > TC_MAX_DIM):
        raise ValueError(f"top-k kernel needs matching D divisible by {step}"
                         f"{f' and at most {TC_MAX_DIM}' if tiling is TC else ''}, "
                         f"got {queries.shape} and {db.shape}")
    if not (queries.is_contiguous() and db.is_contiguous()):
        raise ValueError("top-k kernel needs contiguous queries and database")
    if queries.data_ptr() % 16 or db.data_ptr() % 16:
        raise ValueError("top-k kernel needs 16-byte aligned inputs")
    return launch(queries, db, k, tiling, n_splits)


def launch(queries: torch.Tensor, db: torch.Tensor, k: int, tiling: Tiling,
           n_splits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A search through ``tiling`` over ``n_splits`` database slices, on
    inputs :func:`mips_topk` has checked (the card tests also call it with a
    plan of their own).  A k above MAX_K takes the wide ``tiling`` in
    passes: pass p fills columns [MAX_K p, MAX_K (p + 1)) of the output with
    the best rows after the entry in column MAX_K p - 1, in the order
    (score desc, index asc)."""
    (B, D), N, dev = queries.shape, db.shape[0], queries.device
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int32, device=dev)
    width = min(k, MAX_K)
    cand_v = torch.empty((B, n_splits, width), dtype=torch.float32, device=dev)
    cand_i = torch.empty((B, n_splits, width), dtype=torch.int32, device=dev)
    variant = tiling.variant if k <= MAX_K else f"{tiling.variant}_multi"
    for col in range(0, k, MAX_K):
        # a later pass is bounded by the previous pass's last entry
        bound = ((vals.data_ptr() + 4 * (col - 1), idx.data_ptr() + 4 * (col - 1)) if col
                 else (None, None))
        err = KERNEL.lib().keds_mips_topk(
            queries.data_ptr(), db.data_ptr(), cand_v.data_ptr(), cand_i.data_ptr(),
            vals.data_ptr() + 4 * col, idx.data_ptr() + 4 * col, tiling.code, B, N, D,
            min(MAX_K, k - col), n_splits, k, *bound, stream_ptr(queries))
        KERNEL.check(err)
        KERNEL.launches[variant] += 1
    return vals, idx


def _merge_candidates(vals: torch.Tensor, gidx: torch.Tensor, k: int, mesh,
                      n_real: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-gather every rank's (B, kc) candidates and take the global top-k.
    Candidates on pad rows (``gidx >= n_real``) are masked to -inf first:
    a zero pad row would outrank negative true scores.  The sort is stable
    and descending, so equal scores keep the lower position, which is the
    lower rank and so the lower global row (``lax.top_k``'s order;
    ``torch.topk`` fixes none)."""
    vals = torch.where(gidx < n_real, vals, torch.full_like(vals, float("-inf")))
    all_vals, all_idx = all_gather(mesh, vals), all_gather(mesh, gidx)   # (W, B, kc)
    W, B, kc = all_vals.shape
    cand_vals = all_vals.permute(1, 0, 2).reshape(B, W * kc)
    cand_idx = all_idx.permute(1, 0, 2).reshape(B, W * kc)
    mvals, mpos = torch.sort(cand_vals, dim=1, descending=True, stable=True)
    return mvals[:, :k].contiguous(), torch.gather(cand_idx, 1, mpos[:, :k])


def _pad_candidates(vals: torch.Tensor, idx: torch.Tensor,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad the candidate slots up to ``k`` (a shard may hold fewer rows than
    k) with -inf and index -1."""
    short = k - vals.shape[1]
    if short <= 0:
        return vals, idx
    B = vals.shape[0]
    return (torch.cat([vals, vals.new_full((B, short), float("-inf"))], dim=1),
            torch.cat([idx, idx.new_full((B, short), -1)], dim=1))


def _shard_merge_tail(vals: torch.Tensor, idx: torch.Tensor, k: int, k_cand: int, mesh,
                      n_real: int, n_local: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Offset the local indices to global rows, pad the candidate width to
    ``k_cand`` (the all-gather needs one width on every rank) and merge."""
    gidx = idx + mesh.rank * n_local
    vals, gidx = _pad_candidates(vals, gidx, k_cand)
    return _merge_candidates(vals, gidx, k, mesh, n_real)


def _local_then_merge(queries: torch.Tensor, db_shard: torch.Tensor, k: int, mesh,
                      n_real: int, n_pad: int,
                      backend: str = "xla") -> Tuple[torch.Tensor, torch.Tensor]:
    """B1 over this rank's rows at k + n_pad, then the merge.  Zero pad rows
    score 0.0, which outranks negative true scores, and the merge's mask
    cannot bring back a true row that a pad row pushed out of the local
    candidates: ``n_pad`` extra candidates keep at least min(k, true rows
    of the shard) true ones.  ``backend`` 'approx' runs
    :func:`mips_topk_approx` (B1 as well); 'xla', 'pallas' and 'auto' run
    :func:`mips_topk`."""
    n_local = db_shard.shape[0]
    k_cand = min(k + n_pad, n_local)
    search = mips_topk_approx if backend == "approx" else mips_topk
    vals, idx = search(queries, db_shard, k_cand)
    return _shard_merge_tail(vals, idx, k, max(k, k_cand), mesh, n_real, n_local)


def mips_topk_sharded(queries: torch.Tensor, db_shard: torch.Tensor, k: int, mesh,
                      n_real: int, backend: str = "xla") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a database whose rows are split over ``mesh``:
    ``queries`` (B, D) are the same on every rank, ``db_shard`` is this
    rank's block of the rows padded to a multiple of the world size
    (:meth:`KnowledgeDB.shard_over`), ``n_real`` the true row count.
    Returns (values (B, k) f32, global indices (B, k) int32) on every rank,
    equal to :func:`mips_topk` on the whole database (ties to the lower
    row)."""
    n_pad = db_shard.shape[0] * mesh.size - n_real
    return _local_then_merge(queries, db_shard, k, mesh, n_real, n_pad, backend)


def mips_topk_approx(queries: torch.Tensor, db: torch.Tensor,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``approx`` backend.  The JAX package's ``mips_topk_approx`` calls
    ``lax.approx_max_k``, a partial reduce of the TPU that Hopper has no
    counterpart of; off the TPU JAX lowers it to an exact top-k (ties to
    the lower index), whose exact re-rank then changes nothing.  So this
    is :func:`mips_topk`: B1 at k on the card, :func:`mips_topk_plain` on
    the CPU.  These are the reference's own semantics off the TPU, not a
    fallback."""
    return mips_topk(queries, db, k)


def quantize_int8(db: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8, row ~ scale * row_i8: (values (N, D) int8,
    scales (N,) f32), in f32 with rounding half to even, as the JAX
    package computes it (the same bits on the CPU and the card)."""
    db = db.float()
    scale = by_127(db.abs().amax(dim=1))
    q = torch.round(db / scale.clamp_min(1e-12)[:, None])
    return q.to(torch.int8), scale


def topk_lower_index(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each row of (B, N) f32 ``scores``, best first, equal scores
    by lower index first (``lax.top_k``'s order; ``torch.topk`` fixes none
    on CUDA).  Each score becomes an int64 key that orders as the float
    does in its high 32 bits (-0.0 below +0.0, as XLA's total order has it)
    and holds N - 1 - index in its low 32, so no two keys tie and one
    ``torch.topk`` of the keys is that order."""
    B, N = scores.shape
    bits = scores.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    rev = (N - 1) - torch.arange(N, device=scores.device, dtype=torch.int64)
    keys = ordered * 4294967296 + rev
    top = torch.topk(keys, k, dim=1).values
    idx = (N - 1) - (top & 0xFFFFFFFF)
    return torch.gather(scores, 1, idx), idx


def mips_topk_int8(queries: torch.Tensor, db_i8: torch.Tensor, db_scale: torch.Tensor,
                   k: int, oversample: int = 4, db: Optional[torch.Tensor] = None,
                   plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over an int8 DB with an f32 re-rank of the candidates (the JAX
    package's ``mips_topk_int8``): (values (B, k) f32, indices (B, k)
    int32).

    Stage 1 is exact integer arithmetic: the queries quantized per row, the
    s8 x s8 -> s32 product with ``db_i8`` (:func:`~keds_tpu_torch.ops.quant.
    int8_matmul`: ``torch._int_mm`` on the card), times ``db_scale``, and
    the top ``k * oversample`` rows.  Stage 2 gathers those candidates' true
    rows (``db``) or, without it, their dequantized rows, and takes the
    top k of their f32 products with the f32 queries.  ``oversample <= 1``
    skips stage 2 and returns the stage-1 scores times the query scales.
    Ties go to the lower row in stage 1 and the lower candidate in stage 2.

    ``plain=True`` takes the stage-1 product in float64
    (:func:`~keds_tpu_torch.ops.quant.int8_matmul_plain`, exact) on any
    device: the card check's plain version.  It is never chosen for a
    CUDA tensor otherwise."""
    q = queries.float()
    N = db_i8.shape[0]
    qs = by_127(q.abs().amax(dim=1))
    q_i8 = torch.round(q / qs.clamp_min(1e-12)[:, None]).to(torch.int8)
    raw = (int8_matmul_plain(q_i8, db_i8.T) if plain
           else int8_matmul(q_i8, db_i8.T, path="retrieval"))
    scores = raw.float() * db_scale[None, :]
    kk = min(k * max(oversample, 1), N)
    cand_vals, cand_idx = topk_lower_index(scores, kk)
    if oversample <= 1:
        return (cand_vals * qs[:, None])[:, :k].contiguous(), cand_idx[:, :k].to(torch.int32)
    if db is not None:       # exact re-rank against the true rows
        cand_rows = db[cand_idx].float()
    else:                    # the dequantized rows (int8 artifacts are all there is)
        cand_rows = db_i8[cand_idx].float() * db_scale[cand_idx][:, :, None]
    exact = torch.bmm(cand_rows, q[:, :, None])[..., 0]      # (B, kk)
    vals, pos = torch.sort(exact, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), torch.gather(cand_idx, 1, pos[:, :k]).to(torch.int32)


def mips_topk_int8_sharded(queries: torch.Tensor, db_i8_shard: torch.Tensor,
                           scale_shard: torch.Tensor, k: int, mesh, n_real: int,
                           oversample: int = 4, db_shard: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-sharded int8 search: every rank runs :func:`mips_topk_int8` on
    its block at k + n_pad (with its block of the true rows for the
    re-rank), then the candidates merge over the mesh as in
    :func:`mips_topk_sharded`; zero pad rows score 0.0 in int8 too, hence
    the n_pad extra candidates."""
    n_local = db_i8_shard.shape[0]
    k_cand = min(k + n_local * mesh.size - n_real, n_local)
    vals, idx = mips_topk_int8(queries, db_i8_shard, scale_shard, k_cand,
                               oversample=oversample, db=db_shard)
    return _shard_merge_tail(vals, idx, k, max(k, k_cand), mesh, n_real, n_local)
