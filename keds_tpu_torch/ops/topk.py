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
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from keds_tpu_torch.ops.cuda_build import CudaKernel, require_cuda, sm_count, stream_ptr

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
