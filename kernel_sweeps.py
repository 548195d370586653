#!/usr/bin/env python3
"""Design measurements of the port's kernels on one CUDA card, kept apart
from ``chip_smoke.py`` so that the smoke run stays a check.

    python3 kernel_sweeps.py [--impl DIR] [rank] [topk_anatomy] [narrow_k] [wide_k] [topk_split]
                             [attention] [attention_bwd] [attention_split]
                             [attention_precision] [mma_rate]
                             [train_check_controls]
                             [raw_check_controls] [rn_gain_controls] [rn_encode_chunks]
                             [int8_layouts] [graft_entry_controls]

Each phase prints one JSON line; with no phase named, all run.

rank              the f32 ranking top-k (64, 256, 768, k=10) and ``mm`` +
                  ``topk``, each timed two ways: CUDA-graph replays
                  (``chip_smoke.time_ms``) and eager launches between two
                  events (``eager_ms``, the timing of the first slice).
                  ``--impl DIR`` imports ``keds_tpu_torch`` from DIR instead,
                  e.g. a ``git archive`` of an earlier commit, so that two
                  versions are timed by one method in one call.
topk_anatomy      where the bf16 top-k's time goes at the retrieval shape:
                  one query at k=1 is the database stream alone, 64 queries
                  at k=1 add the products, k=16 and k=32 add insertions into
                  the running lists, and zero queries (every score ties, so
                  nothing after the first chunk is inserted) isolate the
                  fold's fixed cost.
narrow_k          the top-k at the k <= 32 rows of chip_smoke.py: bf16 at
                  (64 and 128, 500 000, 768) k=16 and (128, 500 000, 768) k=2,
                  f32 at (64, 256 and 10 000, 768) k=10.  Takes ``--impl``.
wide_k            the top-k above k=32 at the evaluators' rankings (4181,
                  2297, 768) k=101, (2048, 4096, 768) k=100 and (1024, 10 000,
                  768) k=200 in f32, the serve CLI's --topn 300 over 4096
                  images and k = N = 1000 in f32, and (64, 500 000, 768) k=64
                  and k=300 in bf16; the k=101 ranking also with zero queries
                  (every score ties: the selection tells entries apart by
                  their rows alone) and at k=32.  Takes ``--impl`` as
                  ``rank`` does.
topk_split        where one top-k search's device time goes, by CUDA kernel
                  (torch.profiler, ten searches): the score kernel against
                  the selection at the rows of narrow_k and wide_k, and the
                  one-launch f32 ranking at k = 1 (its score tiles and
                  launch alone), 10 and N.  Takes ``--impl``.
attention         the attention forward at the rows of chip_smoke.py: bf16 at
                  the vision chunk (16, 16, 257, 64), the text (64, 12, 32,
                  64) and ViT-L/14 at 336 px (16, 16, 577, 64); f32 at (2, 4,
                  77, 64) causal, (2, 4, {289, 577}, 64) and the shapes
                  --precision fp32 gives: (16, 16, {257, 577}, 64) and the
                  text tower's (64, 12, 77, 64) causal, and the f32 paths'
                  own: (128, 12, 8, 64) causal, (4, 16, {257, 577}, 64); bf16
                  streamed at the 336 px check's (4, 16, 577, 64) and at (4,
                  12, 1025, 64); bf16 above Dh = 64 (the wide-head
                  kernels) at (4, 16, 257, 80), (4, 8, 77, 128) causal,
                  (64, 2, {32, 8}, 160) causal and the main path's widths
                  re-split into 128-wide heads: (16, 8, 257, 128), (64, 6,
                  32, 128) causal and (128, 6, 8, 128) causal, with the
                  image stream's prompt at Dh = 64 beside them; f32
                  above Dh = 128 (the f32 wide-head kernel) at (2, 4, 77,
                  256) and (64, 2, 8, 160) causal and ViT-L/14's vision
                  chunk in 256-wide heads, (16, 4, 257, 256); on
                  the inputs and the graph-replay timing of
                  ``chip_smoke.py``, SDPA's time beside each.  Takes ``--impl`` as ``rank`` does (an
                  implementation that refuses a shape times it as null).
attention_bwd     the attention backward (``attention_backward``): bf16
                  causal at the train prompt (128, 12, 8, 64) and the text
                  buckets (64, 12, {16, 32, 77, 128}, 64), above 128 (the
                  streamed launches) at (4, 16, {257, 577}, 64) and (4, 12,
                  1025, 64); f32 at (2,
                  4, 77, 64) causal, (2, 4, 289, 64), the f32 train prompt
                  (128, 12, 8, 64) and neighbour templates (256, 12, 32, 64)
                  causal and (4, 16, 577, 64); bf16 above Dh = 64 at (4,
                  16, 257, 80), (4, 8, 77, 128) causal, (64, 2, 8, 160)
                  causal, (128, 6, 8, 128) causal and (256, 6, 32, 128)
                  causal, with the neighbour templates at Dh = 64 beside
                  them; f32 above Dh = 64 at (2, 4, 77, 256) and (64, 2,
                  8, 160) causal, (16, 4, 257, 256) with its Dh = 64 twin
                  (16, 16, 257, 64), and (128, 6, 8, 128) and (256, 6, 32,
                  128) causal; on the inputs and the
                  graph-replay timing of ``chip_smoke.py``, SDPA's backward
                  (its forward and backward less its forward) beside each.
                  Takes ``--impl`` as ``rank`` does (an implementation that
                  refuses a shape times it as null): run parent, change,
                  change, parent.
attention_split   where the f32 wide-head routes' time goes, by CUDA kernel
                  (torch.profiler, ten calls): the forward and the
                  backward's dq and dkv launches at the f32 wide rows of
                  attention and attention_bwd, with the tuned kernels' at
                  (16, 16, 257, 64) beside them.  Takes ``--impl``.
attention_precision
                  the f32 attention forward and backward against float64:
                  the kernels' largest error beside the plain version's and
                  beside the plain version's on inputs cut to TF32 (their low
                  13 mantissa bits cleared), at (2, 4, 289, 64), (16, 16, 257,
                  64) and (64, 12, 77, 64) causal, and with q scaled by 8
                  (nearly one-hot softmax) at (2, 4, 289, 64) and (2, 6, 77,
                  64) causal.
mma_rate          mma.sync m16n8k8 TF32 (and m16n8k16 bf16): its latency (one
                  chain of dependent products), a warp's issue interval
                  (independent products) and the card's rate, from a small
                  CUDA program built with nvcc under build/mma_rate/.
train_check_controls
                  what ``chip_smoke.py``'s train_check reads when the
                  attention gradient is broken on purpose, beside the sound
                  reading, on the same ViT-L/14 weights, 0.5M DB and batch:
                  the attention output with no autograd node (the port before
                  its backward kernel), and the backward kernel's dq, dk or dv
                  replaced by zeros.  Each fault is a patch of
                  ``keds_tpu_torch.ops.attention`` for the duration of one
                  card step; the CPU f32 step is read once.
raw_check_controls
                  what ``chip_smoke.py``'s raw_train_check reads, and why: on
                  the same ViT-L/14 weights, 0.5M DB and neighbours, for a
                  batch of train-cropped smooth JPEGs (the smoke run's) and
                  one of uniform noise, the image features' spread (the
                  mean cosine between two images of the batch) and their
                  card-bf16-vs-CPU-f32 cosine, then the check's reading of
                  the card in bf16 and in f32, and of the CPU in bf16,
                  each against the CPU in f32, and of the card in bf16
                  against the CPU in bf16.
rn_gain_controls
                  why synth's RN towers hold a gain of 0.25 in each
                  bottleneck's last BatchNorm: RN50 and RN50x64 (synthetic
                  weights, BatchNorms calibrated) at gains 1, 0.5 and 0.25
                  (``synth.RESIDUAL_GAIN`` patched for each build),
                  the card's bf16 encode of 4 N(0, 1) images against its f32
                  encode (cuDNN TF32 off): the cosine, the same after
                  subtracting the f32 batch mean from both (what tells the
                  images apart), and the f32 features' spread.
rn_encode_chunks
                  RN50's bf16 encode of 64 uint8 images (synthetic weights)
                  in the serving engine's chunks of 16 and in one chunk of
                  64: host-clock ms between two synchronises (median of
                  five after a warm-up) and device ms (torch.profiler), to
                  tell the host's launches from the card's work.
int8_layouts      ``torch._int_mm`` (the W8A8 towers' int8 product) at a
                  ViT-L/14 vision chunk's four block GEMMs and the text
                  tower's, the weight row-major and column-major, beside a
                  bf16 ``mm``; and which small shapes cuBLASLt takes in
                  each layout.
graft_entry_controls
                  graft_entry_torch.py's composed query (``entry()``'s
                  weights and first 2 rows) on the card against the same
                  weights' f32 run on the CPU, cosine and centred cosine
                  (the CPU's mean of the rows taken out), for the right run
                  and two faults: each caption reversed (chip_smoke.py's
                  control) and the DB's two modalities swapped.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch

from chip_smoke import (DB_ROWS, QUERY_BATCH, RAW_CHECK_BATCH, SERVE_CORPUS, SERVE_WIDE_TOPN,
                        TRAIN_BATCH, VIT336_IMAGES, _cosines, _dout, _qkv, _unit_rows,
                        compare_readings,
                        emit, jpeg_bytes, raw_reading, time_ms, train_check_batch,
                        train_reading)

PHASES = ("rank", "topk_anatomy", "narrow_k", "wide_k", "topk_split", "attention",
          "attention_bwd", "attention_split", "attention_precision", "mma_rate", "train_check_controls",
          "raw_check_controls", "rn_gain_controls", "rn_encode_chunks", "int8_layouts",
          "graft_entry_controls")
IMPL_PHASES = ("rank", "narrow_k", "wide_k", "topk_split", "attention",
               "attention_bwd", "attention_split")   # --impl's
# bf16 above Dh = 64 (the wide-head kernels): chip_smoke.py's rows, and the
# main path's widths re-split into 128-wide heads (the same bytes as their
# Dh = 64 rows)
WIDE_FWD_SHAPES = ((4, 16, 257, 80, torch.bfloat16, False), (4, 8, 77, 128, torch.bfloat16, True),
                   (QUERY_BATCH, 2, 32, 160, torch.bfloat16, True),
                   (QUERY_BATCH, 2, 8, 160, torch.bfloat16, True),
                   (16, 8, 257, 128, torch.bfloat16, False),
                   (QUERY_BATCH, 6, 32, 128, torch.bfloat16, True),
                   (TRAIN_BATCH, 6, 8, 128, torch.bfloat16, True))
WIDE_BWD_SHAPES = ((4, 16, 257, 80, torch.bfloat16, False), (4, 8, 77, 128, torch.bfloat16, True),
                   (QUERY_BATCH, 2, 8, 160, torch.bfloat16, True),
                   (TRAIN_BATCH, 6, 8, 128, torch.bfloat16, True),
                   (2 * TRAIN_BATCH, 6, 32, 128, torch.bfloat16, True))
# f32 above Dh = 128 forward, 64 backward (the f32 wide-head kernels):
# chip_smoke.py's rows, and ViT-L/14's vision chunk in 256-wide heads (the
# same bytes as its Dh = 64 row)
F32_WIDE_SHAPES = ((2, 4, 77, 256, torch.float32, True),
                   (QUERY_BATCH, 2, 8, 160, torch.float32, True),
                   (16, 4, 257, 256, torch.float32, False))
# the backward's alone (above Dh = 64): the image stream's prompt and the
# neighbour templates in 128-wide heads, and the vision chunk's Dh = 64 twin
F32_WIDE_BWD_SHAPES = ((TRAIN_BATCH, 6, 8, 128, torch.float32, True),
                       (2 * TRAIN_BATCH, 6, 32, 128, torch.float32, True),
                       (16, 16, 257, 64, torch.float32, False))
FWD_SHAPES = ((16, 16, 257, 64, torch.bfloat16, False), (64, 12, 32, 64, torch.bfloat16, True),
              (2, 4, 77, 64, torch.float32, True), (16, 16, 577, 64, torch.bfloat16, False),
              (2, 4, 289, 64, torch.float32, False), (2, 4, 577, 64, torch.float32, False),
              # --precision fp32: ViT-L/14 at 224 and 336 px, the text tower at S=77
              (16, 16, 257, 64, torch.float32, False), (16, 16, 577, 64, torch.float32, False),
              (64, 12, 77, 64, torch.float32, True),
              # chip_smoke.py's f32 paths: the image step's prompt, the encodes
              (TRAIN_BATCH, 12, 8, 64, torch.float32, True),
              (VIT336_IMAGES, 16, 257, 64, torch.float32, False),
              (VIT336_IMAGES, 16, 577, 64, torch.float32, False),
              # the streamed bf16 route: the 336 px check's own shape, 1025 tokens
              (VIT336_IMAGES, 16, 577, 64, torch.bfloat16, False),
              (4, 12, 1025, 64, torch.bfloat16, False),
              # the image stream's prompt at Dh = 64, beside its 128-wide twin
              (TRAIN_BATCH, 12, 8, 64, torch.bfloat16, True),
              *WIDE_FWD_SHAPES, *F32_WIDE_SHAPES)
NARROW_SHAPES = ((QUERY_BATCH, DB_ROWS, 16, torch.bfloat16), (TRAIN_BATCH, DB_ROWS, 16, torch.bfloat16),
                 (TRAIN_BATCH, DB_ROWS, 2, torch.bfloat16), (QUERY_BATCH, 256, 10, torch.float32),
                 (QUERY_BATCH, 10_000, 10, torch.float32))
WIDE_SHAPES = ((4181, 2297, 101, torch.float32), (2048, 4096, 100, torch.float32),
               (1024, 10_000, 200, torch.float32),
               (QUERY_BATCH, SERVE_CORPUS, SERVE_WIDE_TOPN, torch.float32),   # serve --topn 300
               (8, 1000, 1000, torch.float32),                                # k = N
               (QUERY_BATCH, DB_ROWS, 64, torch.bfloat16),
               (QUERY_BATCH, DB_ROWS, 300, torch.bfloat16))
BWD_SHAPES = ((TRAIN_BATCH, 12, 8, 64, torch.bfloat16, True),
              (64, 12, 16, 64, torch.bfloat16, True), (64, 12, 32, 64, torch.bfloat16, True),
              (64, 12, 77, 64, torch.bfloat16, True), (64, 12, 128, 64, torch.bfloat16, True),
              (2, 4, 77, 64, torch.float32, True),
              # above 128: the streamed launches (an implementation that refuses
              # them times them as null)
              (4, 16, 257, 64, torch.bfloat16, False), (4, 16, 577, 64, torch.bfloat16, False),
              (4, 12, 1025, 64, torch.bfloat16, False),
              (2, 4, 289, 64, torch.float32, False),
              # f32 training: the image stream's prompt, the text stream's
              # neighbour templates, and beside the bf16 streamed row
              (TRAIN_BATCH, 12, 8, 64, torch.float32, True),
              (2 * TRAIN_BATCH, 12, 32, 64, torch.float32, True),
              (4, 16, 577, 64, torch.float32, False),
              # the neighbour templates at Dh = 64, beside their 128-wide twin
              (2 * TRAIN_BATCH, 12, 32, 64, torch.bfloat16, True),
              *WIDE_BWD_SHAPES, *F32_WIDE_SHAPES, *F32_WIDE_BWD_SHAPES)
CONTROL_FAULTS = ("none", "attention_detached", "dq_zero", "dk_zero", "dv_zero")


def eager_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device ms of one call from ``iters`` eager launches between two events,
    so a kernel shorter than its launch is timed at the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rank(impl: str) -> None:
    from keds_tpu_torch.ops.topk import mips_topk

    B, N, D, k = QUERY_BATCH, 256, 768, 10
    db = _unit_rows(N, D, torch.float32, seed=N)
    q = _unit_rows(B, D, torch.float32, seed=B + 1)
    fns = {"kernel": lambda: mips_topk(q, db, k),
           "library": lambda: torch.topk(torch.mm(q, db.t()), k)}
    emit("rank", impl=impl, shape=[B, N, D, k], dtype="float32",
         graph_ms={name: time_ms(fn) for name, fn in fns.items()},
         eager_ms={name: eager_ms(fn) for name, fn in fns.items()})


def topk_anatomy(N: int = DB_ROWS, D: int = 768) -> None:
    from keds_tpu_torch.ops.topk import mips_topk

    db = _unit_rows(N, D, torch.bfloat16, seed=1)
    q64 = _unit_rows(QUERY_BATCH, D, torch.bfloat16, seed=2)
    cases = {"B1_k1": (q64[:1], 1), "B64_k1": (q64, 1), "B64_k16": (q64, 16),
             "B64_k32": (q64, 32), "B64_k16_zero_queries": (torch.zeros_like(q64), 16)}
    ms = {name: time_ms(lambda: mips_topk(q, db, k)) for name, (q, k) in cases.items()}
    ms["torch_sum_over_db"] = time_ms(lambda: torch.sum(db, dim=0))
    emit("topk_anatomy", shape=[N, D], dtype="bf16", kernel_ms=ms)


def narrow_k(impl: str) -> None:
    _time_topk("narrow_k", impl, NARROW_SHAPES)


def wide_k(impl: str) -> None:
    _time_topk("wide_k", impl, WIDE_SHAPES)


def _time_topk(phase: str, impl: str, shapes, D: int = 768) -> None:
    from keds_tpu_torch.ops.topk import mips_topk

    ms = {}
    for B, N, k, dtype in shapes:
        db = _unit_rows(N, D, dtype, seed=N)
        q = _unit_rows(B, D, dtype, seed=B + 1)
        ms[f"{B}x{N}_k{k}_{str(dtype)[6:]}"] = time_ms(lambda: mips_topk(q, db, k))
        if k == 101:
            ms[f"{B}x{N}_k{k}_zero_queries"] = time_ms(lambda: mips_topk(torch.zeros_like(q),
                                                                         db, k))
            ms[f"{B}x{N}_k32"] = time_ms(lambda: mips_topk(q, db, 32))
        del db, q
        torch.cuda.empty_cache()
    emit(phase, impl=impl, D=D, kernel_ms=ms)


def topk_split(impl: str, D: int = 768) -> None:
    from torch.profiler import ProfilerActivity, profile

    from keds_tpu_torch.ops.topk import mips_topk

    shapes = (*NARROW_SHAPES, *WIDE_SHAPES, (QUERY_BATCH, 256, 1, torch.float32),
              (QUERY_BATCH, 256, 256, torch.float32), (8, 1000, 1, torch.float32))
    rows = []
    for B, N, k, dtype in shapes:
        db = _unit_rows(N, D, dtype, seed=N)
        q = _unit_rows(B, D, dtype, seed=B + 1)
        for _ in range(3):
            mips_topk(q, db, k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                mips_topk(q, db, k)
            torch.cuda.synchronize()
        ms = {e.key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]:
              e.device_time_total / 10 / 1e3 for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total}
        rows.append(dict(shape=[B, N, D, k], dtype=str(dtype)[6:], ms_by_kernel=ms))
        del db, q
        torch.cuda.empty_cache()
    emit("topk_split", impl=impl, searches=rows)


def attention(impl: str) -> None:
    import torch.nn.functional as F

    from keds_tpu_torch.ops.attention import attention as fwd

    ms, sdpa = {}, {}
    for B, H, S, Dh, dtype, causal in FWD_SHAPES:
        q, k, v = _qkv(B, H, S, Dh, dtype)
        name = f"{B}x{H}x{S}x{Dh} {str(dtype)[6:]}{' causal' if causal else ''}"
        sdpa[name] = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
        try:
            fwd(q, k, v, causal)
        except ValueError:          # an implementation that refuses the shape
            ms[name] = None
            continue
        ms[name] = time_ms(lambda: fwd(q, k, v, causal))
    emit("attention", impl=impl, kernel_ms=ms, sdpa_ms=sdpa, sdpa_f32_kernels=_sdpa_kernels())


def _sdpa_kernels() -> list:
    """The CUDA kernels of SDPA's f32 forward and backward, by name."""
    import torch.nn.functional as F

    leaves = [t.detach().requires_grad_() for t in _qkv(2, 4, 577, 64, torch.float32)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = F.scaled_dot_product_attention(*leaves)
        torch.autograd.grad(out, leaves, torch.ones_like(out))
        torch.cuda.synchronize()
    return sorted({e.key.split("(")[0] for e in prof.key_averages()
                   if e.device_type.name == "CUDA" and "fmha" in e.key})


def attention_bwd(impl: str) -> None:
    import torch.nn.functional as F

    from keds_tpu_torch.ops.attention import attention_backward

    ms, sdpa = {}, {}
    for B, H, S, Dh, dtype, causal in BWD_SHAPES:
        q, k, v = _qkv(B, H, S, Dh, dtype)
        dout = _dout(B, H, S, Dh, dtype)
        name = f"{B}x{H}x{S}x{Dh} {str(dtype)[6:]}{' causal' if causal else ''}"
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]

        def sdpa_fwd():
            return F.scaled_dot_product_attention(*leaves, is_causal=causal)

        # SDPA's backward alone: its forward and backward less its forward
        sdpa[name] = (time_ms(lambda: torch.autograd.grad(sdpa_fwd(), leaves, dout))
                      - time_ms(sdpa_fwd))
        try:
            attention_backward(q, k, v, dout, causal)
        except ValueError:          # an implementation that refuses the shape
            ms[name] = None
            continue
        ms[name] = time_ms(lambda: attention_backward(q, k, v, dout, causal))
    emit("attention_bwd", impl=impl, kernel_ms=ms, sdpa_backward_ms=sdpa)


def _kernel_name(key: str) -> str:
    """A profiler key's function name, without namespace and arguments."""
    import re

    found = re.search(r"(\w+(?:<[^>]*>)?)\(", key)
    return found.group(1) if found else key


def attention_split(impl: str) -> None:
    from keds_tpu_torch.ops.attention import attention, attention_backward

    rows = []
    for B, H, S, Dh, dtype, causal in (*F32_WIDE_SHAPES, *F32_WIDE_BWD_SHAPES):
        q, k, v = _qkv(B, H, S, Dh, dtype)
        dout = _dout(B, H, S, Dh, dtype)
        calls = {"forward": lambda: attention(q, k, v, causal),
                 "backward": lambda: attention_backward(q, k, v, dout, causal)}
        for name, fn in calls.items():
            fn()                        # built, warm
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
            ms = {_kernel_name(e.key): e.device_time_total / 10 / 1e3
                  for e in prof.key_averages() if e.device_time_total}
            rows.append(dict(shape=[B, H, S, Dh], causal=causal, call=name, ms_by_kernel=ms))
    emit("attention_split", impl=impl, rows=rows)


def _attention_f64(q, k, v, causal):
    q, k, v = q.double(), k.double(), v.double()
    s = q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5
    if causal:
        s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).triu(1),
                          float("-inf"))
    return torch.softmax(s, -1) @ v


def attention_precision() -> None:
    from keds_tpu_torch.ops.attention import (attention, attention_backward,
                                              attention_reference, attention_reference_backward)

    def tf32(x):
        return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)

    def err(a, b):
        return max((x.double() - y).abs().max().item() for x, y in zip(a, b))

    rows = []
    for B, H, S, causal, q_scale in ((2, 4, 289, False, 1), (16, 16, 257, False, 1),
                                     (64, 12, 77, True, 1), (2, 4, 289, False, 8),
                                     (2, 6, 77, True, 8)):
        q, k, v = _qkv(B, H, S, 64, torch.float32)
        q = q * q_scale
        dout = _dout(B, H, S, 64, torch.float32)
        exact = _attention_f64(q, k, v, causal)
        leaves = [t.detach().double().requires_grad_() for t in (q, k, v)]
        grads = torch.autograd.grad(_attention_f64(*leaves, causal), leaves, dout.double())
        rows.append(dict(
            shape=[B, H, S, 64], causal=causal, q_scale=q_scale,
            fwd=dict(kernel=err([attention(q, k, v, causal)], [exact]),
                     plain=err([attention_reference(q, k, v, causal)], [exact]),
                     plain_tf32_inputs=err([attention_reference(tf32(q), tf32(k), tf32(v), causal)],
                                           [exact])),
            bwd=dict(kernel=err(attention_backward(q, k, v, dout, causal), grads),
                     plain=err(attention_reference_backward(q, k, v, dout, causal), grads),
                     plain_tf32_inputs=err(attention_reference_backward(
                         *map(tf32, (q, k, v, dout)), causal), grads)),
            grad_max=max(g.abs().max().item() for g in grads)))
    emit("attention_precision", against="float64", rows=rows)


MMA_RATE_CU = r"""
#include <cstdio>
template <int CHAINS, bool TF32>
__global__ void chain(float* out, int iters, long long* cycles) {
  float c[CHAINS][4];
  for (int j = 0; j < CHAINS; ++j) for (int e = 0; e < 4; ++e) c[j][e] = threadIdx.x + j;
  unsigned a[4] = {threadIdx.x, 2u, 3u, 4u}, b[2] = {5u, threadIdx.x};
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) {
      if (TF32)
        asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
            "{%8,%9}, {%0,%1,%2,%3};" : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
            "{%8,%9}, {%0,%1,%2,%3};" : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  long long t1 = clock64();
  float s = 0;
  for (int j = 0; j < CHAINS; ++j) for (int e = 0; e < 4; ++e) s += c[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cycles = t1 - t0;
}
template <int CHAINS, bool TF32>
void run(int blocks, int threads) {
  float* out; long long* cyc; cudaMalloc(&out, blocks * threads * 4); cudaMalloc(&cyc, 8);
  const int iters = 4096;
  chain<CHAINS, TF32><<<blocks, threads>>>(out, iters, cyc);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  cudaEventRecord(e0);
  chain<CHAINS, TF32><<<blocks, threads>>>(out, iters, cyc);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  long long c; cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost);
  double flops = (double)blocks * threads / 32 * iters * CHAINS * (TF32 ? 2048 : 4096);
  printf("{\"type\": \"%s\", \"chains\": %d, \"blocks\": %d, \"threads\": %d, "
         "\"cycles_per_mma_per_warp\": %.3f, \"tflops\": %.1f}\n", TF32 ? "tf32" : "bf16",
         CHAINS, blocks, threads, (double)c / (iters * CHAINS), flops / ms / 1e9);
  cudaFree(out); cudaFree(cyc);
}
int main() {
  run<1, true>(1, 32); run<4, true>(1, 32); run<8, true>(132, 128); run<8, true>(528, 128);
  run<1, false>(1, 32); run<8, false>(528, 128);
  return cudaGetLastError();
}
"""


def mma_rate() -> None:
    import json
    import pathlib
    import shutil
    import subprocess

    build = pathlib.Path(__file__).resolve().parent / "build" / "mma_rate"
    build.mkdir(parents=True, exist_ok=True)
    (build / "mma_rate.cu").write_text(MMA_RATE_CU)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o",
                    str(build / "mma_rate"), str(build / "mma_rate.cu")], check=True)
    out = subprocess.run([str(build / "mma_rate")], capture_output=True, text=True, check=True)
    emit("mma_rate", note="one 16x8 tile's mma.sync: cycles between dependent (chains 1) "
         "or independent issues per warp, and the card's rate over 132 or 528 blocks of 4 "
         "warps", rows=[json.loads(line) for line in out.stdout.splitlines()])


def _fault(name: str):
    """A patch of the attention op that breaks its gradient as ``name`` says."""
    from keds_tpu_torch.ops import attention as att

    if name == "none":
        return contextlib.nullcontext()
    if name == "attention_detached":
        # the kernel's output written through ctypes, with no autograd node
        return mock.patch.object(att, "_AttentionFunction",
                                 SimpleNamespace(apply=att._forward_kernel))
    which = ("dq_zero", "dk_zero", "dv_zero").index(name)
    real = att.attention_backward

    def broken(*args):
        grads = list(real(*args))
        grads[which] = torch.zeros_like(grads[which])
        return tuple(grads)

    return mock.patch.object(att, "attention_backward", broken)


def train_check_controls() -> None:
    from keds_tpu_torch import synth
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.models.convert import cast_floating
    from keds_tpu_torch.retrieval.database import KnowledgeDB

    clip_params, heads, db = synth.build(VIT_L_14, db_rows=DB_ROWS, dtype=torch.bfloat16,
                                         seed=0)
    cpu_db = KnowledgeDB(db.image_db.cpu().float(), db.text_db.cpu().float(), db.names)
    inputs = train_check_batch(db)
    cpu = train_reading(cast_floating(clip_params, torch.float32, "cpu"),
                        cast_floating(heads, torch.float32, "cpu"), cpu_db, torch.float32,
                        inputs)
    for fault in CONTROL_FAULTS:
        with _fault(fault):
            card = train_reading(clip_params, heads, db, torch.bfloat16, inputs)
        emit("train_check_control", fault=fault, **compare_readings(card, cpu))


def raw_check_controls() -> None:
    import random

    from keds_tpu_torch import synth
    from keds_tpu_torch.data.tarstream import pil_jpeg_decoder
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.models.convert import cast_floating
    from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever
    from keds_tpu_torch.train.losses import RawBatch, encode_raw_batch
    from keds_tpu_torch.train.trainer import frozen_clip

    clip_params, heads, db = synth.build(VIT_L_14, db_rows=DB_ROWS, dtype=torch.bfloat16,
                                         seed=0)
    cpu_clip = cast_floating(clip_params, torch.float32, "cpu")
    cpu_heads = cast_floating(heads, torch.float32, "cpu")
    cpu_db = KnowledgeDB(db.image_db.cpu().float(), db.text_db.cpu().float(), db.names)
    rng = np.random.default_rng(3)
    decode = pil_jpeg_decoder(224, is_train=True, normalize=False, rng=random.Random(3))
    caps = np.zeros((RAW_CHECK_BATCH, 16), np.int64)
    caps[:, :3] = [49406, 320, 49407]
    batches = {
        "smooth_jpeg": np.stack([decode(jpeg_bytes(rng)) for _ in range(RAW_CHECK_BATCH)]),
        "uniform_noise": rng.integers(0, 256, (RAW_CHECK_BATCH, 224, 224, 3), dtype=np.uint8)}
    for name, images in batches.items():
        batch = RawBatch(torch.from_numpy(images).cuda(), torch.from_numpy(caps).cuda())
        feats = {dev: encode_raw_batch(frozen_clip(clip_params, dtype, torch.device(dev)),
                                       VIT_L_14, RawBatch(batch.images.to(dev),
                                                          batch.caption_tokens.to(dev)),
                                       captions=False).image_features.cpu().double()
                 for dev, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32))}
        unit = {k: v / v.norm(dim=1, keepdim=True) for k, v in feats.items()}
        gram = unit["cpu"] @ unit["cpu"].T
        off = gram[~torch.eye(len(gram), dtype=torch.bool)]
        idx = Retriever(db).neighbour_indices(feats["cuda"].float().cuda(), 16)
        cpu = raw_reading(cpu_clip, cpu_heads, cpu_db, torch.float32, batch, idx)
        readings = {
            "card_bf16": raw_reading(clip_params, heads, db, torch.bfloat16, batch, idx),
            "card_f32": raw_reading(clip_params, heads, db, torch.float32, batch, idx),
            "cpu_bf16": raw_reading(cpu_clip, cpu_heads, cpu_db, torch.bfloat16, batch, idx)}
        emit("raw_check_control", batch=name, images=RAW_CHECK_BATCH,
             mean_pairwise_feature_cosine=float(off.mean()),
             min_pairwise_feature_cosine=float(off.min()),
             card_bf16_vs_cpu_f32_feature_cosine=(unit["cuda"] * unit["cpu"]).sum(1).tolist(),
             **{f"{k}_vs_cpu_f32": compare_readings(v, cpu) for k, v in readings.items()},
             card_bf16_vs_cpu_bf16=compare_readings(readings["card_bf16"],
                                                    readings["cpu_bf16"]))


def rn_gain_controls() -> None:
    from chip_smoke import _cosines, feature_spread

    from keds_tpu_torch import synth
    from keds_tpu_torch.models import clip as mclip
    from keds_tpu_torch.models.convert import cast_floating
    from keds_tpu_torch.runtime import disable_tf32

    disable_tf32()
    for name in ("RN50", "RN50x64"):
        cfg = synth.RN_CONFIGS[name]
        px = cfg.image_resolution
        x = torch.randn((4, px, px, 3), generator=torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
        for gain in (1.0, 0.5, 0.25):
            with mock.patch.object(synth, "RESIDUAL_GAIN", gain):
                p32 = synth.init_clip(cfg, 40, torch.device("cuda"), torch.float32)
            with torch.inference_mode():
                f32 = mclip.encode_image(p32, cfg, x)
                bf16 = mclip.encode_image(cast_floating(p32, torch.bfloat16, "cuda"), cfg, x)
            mean = f32.mean(dim=0)
            emit("rn_gain_controls", model=name, residual_gain=gain,
                 cudnn_tf32=torch.backends.cudnn.allow_tf32,
                 bf16_vs_f32_cosine=_cosines(bf16, f32),
                 centred_cosine=_cosines(bf16 - mean, f32 - mean),
                 f32_feature_spread=feature_spread(f32.cpu()))
            del p32
            torch.cuda.empty_cache()


INT8_SHAPES = ((16 * 257, 1024, 3072), (16 * 257, 1024, 1024), (16 * 257, 1024, 4096),
               (16 * 257, 4096, 1024), (64 * 32, 768, 2304), (64 * 32, 3072, 768))
INT8_SMALL = tuple((m, k, n) for m in (17, 20, 24, 32) for k in (64, 128, 768)
                   for n in (64, 192, 256))


def int8_layouts() -> None:
    """``torch._int_mm`` (the int8 product of the W8A8 towers) at a ViT-L/14
    vision chunk's four block GEMMs (4112 tokens) and the text tower's at
    the S=32 bucket (2048 tokens), with the weight (K, N) row-major (as
    ``quantize_weight`` lays it out) and column-major (a transposed view of
    an (N, K) tensor); then which small shapes cuBLASLt takes in each
    layout (M rows just past 16, K and N of a tiny test tower)."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def i8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    rows = []
    for m, k, n in INT8_SHAPES:
        a, b = i8((m, k)), i8((k, n))
        col = b.t().contiguous().t()
        exact = torch.equal(torch._int_mm(a, b), torch._int_mm(a, col))
        rows.append(dict(shape=[m, k, n], equal=exact,
                         row_major_ms=time_ms(lambda: torch._int_mm(a, b)),
                         col_major_ms=time_ms(lambda: torch._int_mm(a, col)),
                         bf16_mm_ms=time_ms(lambda: torch.mm(a.to(torch.bfloat16),
                                                             b.to(torch.bfloat16)))))
    taken = {}
    for m, k, n in INT8_SMALL:
        a, b = i8((m, k)), i8((k, n))
        for name, w in (("row_major", b), ("col_major", b.t().contiguous().t())):
            try:
                torch._int_mm(a, w)
                torch.cuda.synchronize()
                taken[f"{m}x{k}x{n} {name}"] = True
            except RuntimeError as e:
                taken[f"{m}x{k}x{n} {name}"] = str(e).splitlines()[0][:120]
    emit("int8_layouts", gemms=rows, small_shapes=taken)


def rn_encode_chunks() -> None:
    import time

    from chip_smoke import profile_device

    from keds_tpu_torch import synth
    from keds_tpu_torch.models import clip as mclip

    cfg = synth.RN_CONFIGS["RN50"]
    params = synth.init_clip(cfg, 30, torch.device("cuda"), torch.bfloat16)
    images = torch.randint(0, 256, (64, 224, 224, 3), dtype=torch.uint8, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(0))
    for chunk in (16, 64):
        def encode():
            with torch.inference_mode():
                mclip.encode_image_chunked(params, cfg, images, chunk)

        walls = []
        for _ in range(6):
            torch.cuda.synchronize()
            t = time.perf_counter()
            encode()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        emit("rn_encode_chunks", model="RN50", images=64, chunk=chunk,
             host_ms=float(np.median(walls[1:])), host_ms_runs=walls[1:])
        profile_device(f"rn_encode_chunks_profile_{chunk}", encode,
                       [("convolution (cuDNN)", ("conv", "fprop", "cudnn", "implicit"))])


def graft_entry_controls() -> None:
    import graft_entry_torch as ge
    from keds_tpu_torch.models.convert import cast_floating

    fn, (clip_params, heads, db_img, db_txt, images, text) = ge.entry()
    rows = slice(0, 2)
    reversed_caption = text[rows].clone()
    reversed_caption[:, 6:20] = reversed_caption[:, 6:20].flip(1)
    with torch.inference_mode():
        runs = {"right": fn(clip_params, heads, db_img, db_txt, images[rows], text[rows]),
                "caption_reversed": fn(clip_params, heads, db_img, db_txt, images[rows],
                                       reversed_caption),
                "db_modalities_swapped": fn(clip_params, heads, db_txt, db_img, images[rows],
                                            text[rows])}
        cpu = fn(*(cast_floating(a, torch.float32, "cpu")
                   for a in (clip_params, heads, db_img, db_txt)),
                 images[rows].float().cpu(), text[rows].cpu())
    mean = cpu.double().mean(dim=0)
    for name, card in runs.items():
        emit("graft_entry_control", run=name, cosine=_cosines(card, cpu),
             centred_cosine=_cosines(card.double().cpu() - mean, cpu - mean))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phases", nargs="*", metavar="phase",
                    help=f"any of {', '.join(PHASES)} (default: all)")
    ap.add_argument("--impl", default=None,
                    help="directory whose keds_tpu_torch is timed "
                         f"({' and '.join(IMPL_PHASES)} only)")
    args = ap.parse_args()
    phases = args.phases or list(PHASES)
    if set(phases) - set(PHASES):
        ap.error(f"unknown phase in {phases}; choose from {PHASES}")
    if not torch.cuda.is_available():
        print("kernel_sweeps: no CUDA device", file=sys.stderr)
        return 1
    impl = os.path.abspath(args.impl) if args.impl else os.path.dirname(os.path.abspath(__file__))
    if args.impl:
        if set(phases) - set(IMPL_PHASES):
            ap.error(f"--impl times the {' and '.join(IMPL_PHASES)} phases only")
        sys.path.insert(0, impl)
    import keds_tpu_torch

    if not keds_tpu_torch.__file__.startswith(impl):
        raise RuntimeError(f"imported {keds_tpu_torch.__file__}, not the one under {impl}")
    for phase in phases:
        if phase in IMPL_PHASES:
            globals()[phase](impl)
        else:
            globals()[phase]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
