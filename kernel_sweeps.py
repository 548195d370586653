#!/usr/bin/env python3
"""Design measurements of the port's kernels on one CUDA card, kept apart
from ``chip_smoke.py`` so that the smoke run stays a check.

    python3 kernel_sweeps.py [--impl DIR] [rank] [topk_anatomy] [attention_bwd]
                             [train_check_controls]

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
attention_bwd     the bf16 attention backward (``attention_backward``,
                  causal) at the train prompt (128, 12, 8, 64) and the text
                  buckets (64, 12, {16, 32, 77}, 64), on the inputs and the
                  graph-replay timing of ``chip_smoke.py``.  Takes ``--impl``
                  as ``rank`` does: run parent, change, change, parent.
train_check_controls
                  what ``chip_smoke.py``'s train_check reads when the
                  attention gradient is broken on purpose, beside the sound
                  reading, on the same ViT-L/14 weights, 0.5M DB and batch:
                  the attention output with no autograd node (the port before
                  its backward kernel), and the backward kernel's dq, dk or dv
                  replaced by zeros.  Each fault is a patch of
                  ``keds_tpu_torch.ops.attention`` for the duration of one
                  card step; the CPU f32 step is read once.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from types import SimpleNamespace
from unittest import mock

import torch

from chip_smoke import (DB_ROWS, QUERY_BATCH, TRAIN_BATCH, _dout, _qkv, _unit_rows,
                        compare_readings, emit, time_ms, train_check_batch, train_reading)

PHASES = ("rank", "topk_anatomy", "attention_bwd", "train_check_controls")
IMPL_PHASES = ("rank", "attention_bwd")      # the phases --impl times
BWD_SHAPES = ((TRAIN_BATCH, 12, 8, 64), (64, 12, 16, 64), (64, 12, 32, 64), (64, 12, 77, 64))
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


def attention_bwd(impl: str) -> None:
    from keds_tpu_torch.ops.attention import attention_backward

    ms = {}
    for B, H, S, Dh in BWD_SHAPES:
        q, k, v = _qkv(B, H, S, Dh, torch.bfloat16)
        dout = _dout(B, H, S, Dh, torch.bfloat16)
        ms[f"{B}x{H}x{S}x{Dh}"] = time_ms(lambda: attention_backward(q, k, v, dout, True))
    emit("attention_bwd", impl=impl, dtype="bf16", causal=True, kernel_ms=ms)


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
