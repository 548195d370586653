"""Exact maximum-inner-product top-k search (counterpart of
``keds_tpu/ops/topk.py`` and ``keds_tpu/ops/pallas_topk.py``).

:func:`mips_topk` does the knowledge-DB neighbour search and the corpus
ranking.  On CUDA tensors it launches the hand-written kernels of
``csrc/topk.cu`` (which replace the Pallas ``mips_topk_pallas``) or
raises.  bf16 at k <= 32 runs the fused tensor-core kernel (variant
``bf16_tc``), then a selection over its candidates.  f32 at any k (variant
``f32``) and bf16 above k = 32 or wider than the fused kernel holds
(``TC_MAX_DIM``; variant ``bf16``) score first, exact f32 FMA on CUDA cores
or bf16 ``mma.sync`` into a scratch score matrix, then select per query on
64-bit (score, row) keys (:func:`entry_keys`), reading the database once
for every k <= N.  f32 over at most ``FUSED_MAX_ROWS`` rows (the served
corpus ranking) does both in one launch.  One search launches the same
kernels for every k (``GRID_LAUNCHES`` counts them).  Like the Pallas
kernel, it takes any D: a D off the kernel's depth step (64 for bf16, 16
for f32, 32 for the one-launch f32) is zero-padded in the wrapper, which
adds 0 to every inner product, and counts in ``KERNEL.pads``.  On CPU
tensors it runs the plain version :func:`mips_topk_plain`.  Both order
equal scores by lower row index first.

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
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from keds_tpu_torch.ops.cuda_build import CudaKernel, require_cuda, sm_count, stream_ptr
from keds_tpu_torch.ops.quant import (INT8_MM, by_127, int8_matmul, int8_matmul_plain,
                                     pad_depth)
from keds_tpu_torch.parallel.mesh import all_gather

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("topk", {
    "keds_mips_topk": [_P] * 8 + [_I] * 7 + [_P, _P],
    "keds_topk_query_tile": [_I],
    "keds_topk_chunk_rows": [_I],
    "keds_topk_depth_step": [_I],
    "keds_topk_tc_max_dim": [],
    "keds_topk_fused_max_rows": [],
}, variants=("bf16_tc", "f32", "bf16"))
# CUDA kernels launched per variant (one search launches one to two)
GRID_LAUNCHES = dict.fromkeys(KERNEL.launches, 0)


class Tiling(NamedTuple):
    """One route of ``csrc/topk.cu``."""

    code: int           # the C interface's variant code
    variant: str        # launch-count key
    query_tile: int     # queries per block
    chunk_rows: int     # database rows per block
    depth_step: int     # the multiple of D the kernel reads


# Mirrors of csrc/topk.cu's constants (a card test in tests/test_torch_cuda.py
# checks them against the library).  TC (bf16, k <= 32, D <= TC_MAX_DIM)
# holds 210 KB of shared memory, one block an SM, and splits the database
# into one slice per SM.  The others score into scratch and select per
# query: F32 in 128 x 128 tiles, F32_MID in 64 x 64 where the big tiles
# would be half empty or leave more than half the card idle, BF16 in
# 64-query x 128-row mma tiles; F32_FUSED, over at most FUSED_MAX_ROWS rows,
# in 4 x 32 tiles and one launch.
F32 = Tiling(0, "f32", 128, 128, 16)
F32_MID = Tiling(1, "f32", 64, 64, 16)
TC = Tiling(2, "bf16_tc", 64, 128, 64)
BF16 = Tiling(3, "bf16", 64, 128, 64)
F32_FUSED = Tiling(4, "f32", 4, 32, 32)
TILINGS = (F32, F32_MID, TC, BF16, F32_FUSED)
LANE_K = 32               # TC's lists hold one entry a lane
TC_MAX_DIM = 1024         # TC's query fragments live in registers
FUSED_MAX_ROWS = 1024     # F32_FUSED sorts a whole row in one warp's round
FUSED_MAX_SCORES = 1 << 20   # ... and its small tiles pay off below B * N of this
SEGMENT_ROWS = 16_384     # longer rows are selected in segments, then merged
SCORE_BYTES = 1 << 30     # one launch's scratch scores; more queries take several


def depth_step(tiling: Tiling) -> int:
    """The multiple of D that ``tiling``'s kernel reads: 64 for bf16
    (the tensor-core tiles), 16 for f32 (32 for F32_FUSED)."""
    return tiling.depth_step


def kernel_depth(tiling: Tiling, dim: int) -> int:
    """``dim`` rounded up to ``tiling``'s depth step: the D the kernel runs."""
    return -(-dim // depth_step(tiling)) * depth_step(tiling)


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


def entry_keys(scores: torch.Tensor) -> torch.Tensor:
    """The 64-bit keys ``csrc/topk.cu`` selects on, as int64 with the sign
    bit flipped (so that signed order is the kernel's unsigned order): the
    score's order in the high word (-0.0 as +0.0), ~row in the low, so that
    the k largest keys are the k best entries, equal scores lower row first.
    The kernels' order on the CPU, for the tests."""
    bits = scores.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    bits = torch.where(bits == 0x80000000, torch.zeros_like(bits), bits)
    order = torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF, bits | 0x80000000)
    rows = torch.arange(scores.shape[-1], dtype=torch.int64)
    return ((order << 32) | (0xFFFFFFFF - rows)) ^ (-(1 << 63))


def split_plan(n_queries: int, n_rows: int, n_sms: int,
               dtype: torch.dtype, k: int = 1, dim: int = 0) -> Tuple[Tiling, int]:
    """(tiling, number of database slices or row segments) for a search.

    bf16 at k <= ``LANE_K`` whose D (``dim``), padded to the tensor-core
    step, fits ``TC_MAX_DIM`` takes TC, with the database split into one
    slice an SM for each query tile (no slice empty).  Otherwise bf16 takes
    BF16, and f32 F32_FUSED over at most ``FUSED_MAX_ROWS`` rows (and
    ``FUSED_MAX_SCORES`` scores), else F32, or F32_MID where F32's query
    tile would be half empty or its grid hold fewer than two blocks an SM.
    These select per query over ceil(N / ``SEGMENT_ROWS``) segments of the
    row: k decides nothing but TC."""
    bf16 = dtype == torch.bfloat16
    if bf16 and k <= LANE_K and kernel_depth(TC, dim) <= TC_MAX_DIM:
        n_chunks = -(-n_rows // TC.chunk_rows)
        want = -(-n_sms // -(-n_queries // TC.query_tile))
        return TC, max(1, min(n_chunks, want))
    if bf16:
        tiling = BF16
    elif n_rows <= FUSED_MAX_ROWS and n_queries * n_rows <= FUSED_MAX_SCORES:
        return F32_FUSED, 1
    else:
        blocks = -(-n_queries // F32.query_tile) * -(-n_rows // F32.chunk_rows)
        big = n_queries > F32_MID.query_tile and blocks >= 2 * n_sms
        tiling = F32 if big else F32_MID
    return tiling, -(-n_rows // SEGMENT_ROWS)


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
    if db.shape[1] != D:
        raise ValueError(f"top-k kernel needs queries and database of one D, got "
                         f"{tuple(queries.shape)} and {tuple(db.shape)}")
    tiling, n_splits = split_plan(B, N, sm_count(queries), queries.dtype, k, D)
    if D % depth_step(tiling):
        queries, db = pad_depth(queries, depth_step(tiling)), pad_depth(db, depth_step(tiling))
        KERNEL.pads[tiling.variant] += 1
    if not (queries.is_contiguous() and db.is_contiguous()):
        raise ValueError("top-k kernel needs contiguous queries and database")
    if queries.data_ptr() % 16 or db.data_ptr() % 16:
        raise ValueError("top-k kernel needs 16-byte aligned inputs")
    return launch(queries, db, k, tiling, n_splits)


_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    """A zeroed int32 buffer of at least ``n`` entries on ``dev``, kept for
    the device: the kernels that count finished tiles or segments leave it
    zeroed."""
    c = _COUNTERS.get(dev)
    if c is None or c.numel() < n:
        c = _COUNTERS[dev] = torch.zeros(max(n, 1 << 16), dtype=torch.int32, device=dev)
    return c


def launch(queries: torch.Tensor, db: torch.Tensor, k: int, tiling: Tiling,
           n_splits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A search through ``tiling`` over ``n_splits`` database slices (TC)
    or row segments, on inputs :func:`mips_topk` has checked (the card tests
    also call it with a plan of their own).  The scratch score matrix is
    kept under ``SCORE_BYTES``: more queries than fit take one launch each
    share."""
    (B, D), N, dev = queries.shape, db.shape[0], queries.device
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int32, device=dev)
    if tiling is TC:
        ld, step = 0, B
        cand_shape = (B, n_splits, k)
    else:
        ld = -(-N // 4) * 4
        step = max(1, min(B, SCORE_BYTES // (4 * ld)))
        cand_shape = (step, n_splits, min(k, -(-N // n_splits))) if n_splits > 1 else (0,)
    scores = torch.empty((step, ld) if ld else (0,), dtype=torch.float32, device=dev)
    cand_v = torch.empty(cand_shape, dtype=torch.float32, device=dev)
    cand_i = torch.empty(cand_shape, dtype=torch.int32, device=dev)
    counters = _counters(dev, step)
    row_bytes = D * queries.element_size()
    for b0 in range(0, B, step):
        rows, kernels = min(step, B - b0), ctypes.c_int(0)
        err = KERNEL.lib().keds_mips_topk(
            queries.data_ptr() + b0 * row_bytes, db.data_ptr(), scores.data_ptr(),
            cand_v.data_ptr(), cand_i.data_ptr(), vals.data_ptr() + 4 * b0 * k,
            idx.data_ptr() + 4 * b0 * k, counters.data_ptr(), tiling.code, rows, N, D, k,
            n_splits, ld, stream_ptr(queries), ctypes.byref(kernels))
        KERNEL.check(err)
        KERNEL.launches[tiling.variant] += 1
        GRID_LAUNCHES[tiling.variant] += kernels.value
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
    the top ``k * oversample`` rows.  ``db_i8`` may be wider than the
    queries, zero-padded to the depth ``torch._int_mm`` takes (the
    ``Retriever`` pads its tables once): the int8 queries are then padded
    to it per call, and the dequantized rows are read at the queries'
    width.  Stage 2 gathers those candidates' true
    rows (``db``) or, without it, their dequantized rows, and takes the
    top k of their f32 products with the f32 queries.  ``oversample <= 1``
    skips stage 2 and returns the stage-1 scores times the query scales.
    Ties go to the lower row in stage 1 and the lower candidate in stage 2.

    ``plain=True`` takes the stage-1 product in float64
    (:func:`~keds_tpu_torch.ops.quant.int8_matmul_plain`, exact) on any
    device: the card check's plain version.  It is never chosen for a
    CUDA tensor otherwise."""
    q = queries.float()
    (N, depth), D = db_i8.shape, q.shape[1]
    qs = by_127(q.abs().amax(dim=1))
    q_i8 = torch.round(q / qs.clamp_min(1e-12)[:, None]).to(torch.int8)
    if depth > D:            # tables padded to the product's depth (Retriever)
        q_i8 = torch.nn.functional.pad(q_i8, (0, depth - D))
        if q_i8.device.type == "cuda":
            INT8_MM.pads["queries"] += 1
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
        cand_rows = db_i8[cand_idx, :D].float() * db_scale[cand_idx][:, :, None]
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
