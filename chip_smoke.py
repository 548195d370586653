#!/usr/bin/env python3
"""Smoke run of the keds_tpu_torch serving, training and evaluation paths
and of its serve, demo and train command lines on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. build   nvcc-builds every kernel of ``keds_tpu_torch/csrc`` (sm_90a, one
           nvcc per source, all started together) and prints ptxas'
           registers and spills.
2. attention / attention_bwd / mips_topk
           each kernel variant at the shapes the serving and training paths
           give it, held against its plain PyTorch version on the same
           inputs, with times of the kernel, the plain version and one
           library call (SDPA, the backward of SDPA, matmul + topk), and the
           bound: the larger of bytes over 3.35 TB/s and flops over the
           dtype's peak (989 TFLOP/s bf16, 67 TFLOP/s f32; H100 SXM data
           sheet).  Times are device times: CUDA-graph replays of 20 calls.
           The library backward is SDPA's forward and backward replayed
           together less its forward replayed alone.  (Design sweeps of the
           kernels are in ``kernel_sweeps.py``.)
3. main_path
           ViT-L/14 + heads (random weights from a seed) and a 0.5M x 768 bf16
           knowledge DB made on the card; ComposedQueryEngine encodes a corpus
           and answers batches of 64 composed queries ranked against it.
           Kernel launch counts are zeroed just before and read just after;
           per-stage times of one batch are the median of three.
4. profile torch.profiler over one query batch: device time by kernel, the
           top kernels, and their sums for GEMMs, the fused kernels and the
           rest.
5. e2e_check
           two queries through the same weights on the CPU in f32; cosine of
           the composed features against the card's bf16 output.
6. train_path
           the features-mode image-stream train step (make_train_step +
           train_epoch) on the main path's ViT-L/14 and 0.5M DB, heads in
           f32: B=128 unit-norm feature pairs made on the card, 2 warm-up
           and 10 timed steps on one repeated batch (launch counts zeroed
           just before, read just after), samples/s, per-stage ms (median of
           three), peak memory, and a checkpoint saved and reloaded.
7. profile_train
           torch.profiler over one train step: device ms by group and the
           device's busy share.
8. train_check
           one train step on the card in bf16 against the same step on the
           CPU in f32 (same weights and batch, the card's neighbour indices
           fed to both, dropout 0): relative loss difference and cosine of
           the flattened head gradients.
9. train_text_path
           the text-stream train step on the same model and DB: neighbour
           templates "a photo of * * {other}" for all 0.5M DB rows, B=128
           own templates "a photo of * * * {other}" bucketed as the CLI
           feeds them (seeded ids, 4 to 20 of them an other caption: the
           S=32 bucket for both tower calls), 2 warm-up and 10 timed steps
           through train_epoch (launch counts zeroed just before, read just
           after: B1 twice a step, at k=16 and k=2), text_condition
           unchanged, per-stage ms, peak memory and a checkpoint round trip.
10. profile_train_text
           torch.profiler over one text-stream step.
11. train_text_check
           one text-stream step on the card in bf16 against the CPU's f32
           step, the card's three index sets fed to both, own templates at
           the full width 77; train_check's limits over img2text and
           retrieval_fuse (text_condition has no gradient on either side).
12. eval_path
           evaluate_cirr on the same model and DB over a CIRR-val-sized split
           (2297 uint8 224x224 corpus images and 4181 queries made from a seed,
           prompts in the S=32 bucket, in-memory loaders of 64) and two
           branches of heads-only checkpoints epoch_1..3 under build/: three
           sweep epochs with device ranking (launch counts zeroed just before,
           read just after: B1 f32 at k=101 three times an epoch, B1 bf16_tc
           twice a query batch), then with host ranking; phase walls, corpus
           images/s, queries/s, peak memory, and the gate: the two runs' recall
           tables are equal but for queries whose rankings differ only between
           entries whose scores lie within 1e-5 (counted and printed).
13. profile_eval
           torch.profiler over one device-ranked sweep epoch.
14. smoke_files
           the files the CLIs read, under build/ (removed at the end): a
           synthetic BPE merges file (KEDS_TPU_BPE_VOCAB; '*' = 265), the
           main path's weights as reference-layout ViT-L/14 checkpoints with
           an MLP and with a CrossFormer img2text, its 0.5M DB in f32 and a
           1000-row one, 4096 256 px JPEGs with CC3M-length captions,
           queries.jsonl, two csvs and four tar shards of 384 of the JPEGs.
15. serve_path
           keds_tpu_torch.cli.serve.main in this process: 512 queries over
           the 4096-image folder at --topn 10 (ranked on the card: B1 f32),
           then the first 128 at --topn 300 ranked on the card (B1's passes,
           f32_multi) and on the host; launch counts zeroed just before and
           read just after each card run; corpus images/s, queries/s with
           decode, peak memory; the gate (the two --topn 300 files name the
           same images in the same order but for near-ties within 1e-5,
           counted); 4 queries composed on the card in bf16 against the CPU
           in f32 from the same files (cosine).
16. demo_path
           keds_tpu_torch.cli.demo.main, MLP and CrossFormer intents, one
           query and two prompts over a 256-image csv: index.html and the
           feature cache written, each prompt's top-10 equal to a ranking
           recomputed apart on the host but for near-ties; no B1 launch.
17. raw_train_path, profile_train_raw, raw_train_check, raw_train_cli
           the image stream on raw images: the shards through
           TarShardDataset (train crop, 8 decode threads), B=128, 2 warm-up
           and 10 timed steps (launch counts zeroed just before, read just
           after), stage ms with the frozen encode, the profile of one step;
           the card's bf16 encode of 8 images against the CPU's f32 one
           (cosine >= 0.995), and the card's bf16 raw step against the CPU's
           f32 step on the card's features, with the card's neighbours fed
           to both (train_check's limits; raw_train_check says why); then
           `python -m keds_tpu_torch.cli.main --dataset-type webdataset` and
           a csv run in this process, one epoch each and a --resume auto.
18. the kernels line (launches of each path beside each variant), then the
    card's name and power limit from nvidia-smi, then the result line.

The top-k rows cover k=16, 10 and 2 and, above 32, the evaluators'
rankings (k=101, 100, 200), a --db-topk of 64 and, above 256 (passes of the
wide kernel), k=300 over 10 000, 4096 and 0.5M rows and k = N = 1000.
"""

from __future__ import annotations

import contextlib
import copy
import json
import pathlib
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
ATT_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}   # output-dtype rounding
TOPK_TOL = 1e-4        # f32 sums of 768 products in another order
COSINE_MIN = 0.995
# backward kernel vs plain, |err| <= atol + rtol * |plain|: f32 sums in
# another order; bf16 gradients rounded to bf16, and a probability or
# dP = dO V^T, which both round to bf16, may round the other way
BWD_TOL = {torch.bfloat16: (3e-2, 2e-2), torch.float32: (1e-4, 1e-4)}
BWD_VARIANT = {torch.bfloat16: "bf16", torch.float32: "f32"}
TRAIN_BATCH = 128
TRAIN_LOSS_RTOL = 0.01       # train_check: card bf16 vs CPU f32 (PERF.md)
TRAIN_GRAD_COSINE_MIN = 0.99
TRAIN_OPT = SimpleNamespace(lr=5e-4, beta1=0.9, beta2=0.98, eps=1e-6, wd=0.2, warmup=2,
                            skip_scheduler=False)   # ViT-L/14 defaults, short warm-up
TRAIN_PROMPT = np.array([[49406, 320, 1125, 539, 49407] + [0] * 72])   # "a photo of"
OTHER_LEN = (4, 20)    # ids in a text-stream "other" caption (CC3M: about 10 words)
VARIANT = {torch.bfloat16: "bf16_tc", torch.float32: "f32"}   # per kernel, by dtype
SPLIT_ID = 265         # '*' in the CLIP BPE vocab (bench.py's prompt)
DB_ROWS = 500_000
QUERY_BATCH = 64
N_QUERY_BATCHES = 3
N_CORPUS = 256
EVAL_CORPUS = 2297     # the CIRR val corpus and queries (keds_tpu/evalkit/metrics.py:113)
EVAL_QUERIES = 4181
EVAL_EPOCHS = 3
NEAR_TIE = 1e-5        # eval gate: scores this close may rank either way


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, iters: int = 20, reps: int = 3) -> float:
    """Device ms of one call: ``iters`` calls captured in a CUDA graph and
    replayed (median of ``reps``), so the host's launch cost is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()                       # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    torch.cuda.empty_cache()
    return float(np.median(times))


def bound(nbytes: float, flops: float, dtype: torch.dtype):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check_attention(cases):
    import torch.nn.functional as F

    from keds_tpu_torch.ops.attention import KERNEL, attention, attention_reference

    rows = []
    for B, H, S, Dh, dtype, causal in cases:
        variant = VARIANT[dtype]
        launches0 = KERNEL.launches[variant]
        q, k, v = _qkv(B, H, S, Dh, dtype)
        out = attention(q, k, v, causal)
        ref = attention_reference(q, k, v, causal)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not err <= ATT_TOL[dtype]:
            raise AssertionError(f"attention {B, H, S, Dh} {dtype} causal={causal}: "
                                 f"max_abs_err {err} > {ATT_TOL[dtype]}")
        pairs = S * (S + 1) // 2 if causal else S * S
        b_ms, b_by = bound(4 * B * H * S * Dh * q.element_size(), 4 * B * H * pairs * Dh,
                           dtype)
        row = dict(shape=[B, H, S, Dh], dtype=str(dtype), variant=variant, causal=causal,
                   max_abs_err=err, tol=ATT_TOL[dtype],
                   kernel_ms=time_ms(lambda: attention(q, k, v, causal)),
                   plain_ms=time_ms(lambda: attention_reference(q, k, v, causal)),
                   library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                       q, k, v, is_causal=causal)),
                   bound_ms=b_ms, bound_by=b_by,
                   launches=KERNEL.launches[variant] - launches0)
        emit("attention", **row)
        rows.append(row)
    return rows


def check_attention_bwd(cases):
    import torch.nn.functional as F

    from keds_tpu_torch.ops.attention import (BWD_KERNEL, attention_backward,
                                              attention_reference_backward, bwd_plan)

    rows = []
    for B, H, S, Dh, dtype, causal in cases:
        variant = BWD_VARIANT[dtype]
        launches0 = BWD_KERNEL.launches[variant]
        q, k, v = _qkv(B, H, S, Dh, dtype)
        dout = _dout(B, H, S, Dh, dtype)
        grads = attention_backward(q, k, v, dout, causal)
        ref = attention_reference_backward(q, k, v, dout, causal)
        torch.cuda.synchronize()
        atol, rtol = BWD_TOL[dtype]
        err = max((g.float() - r.float()).abs().max().item() for g, r in zip(grads, ref))
        excess = max(((g.float() - r.float()).abs() - rtol * r.float().abs()).max().item()
                     for g, r in zip(grads, ref))
        if not excess <= atol:
            raise AssertionError(f"attention_bwd {B, H, S, Dh} {dtype} causal={causal}: "
                                 f"max_abs_err {err}, beyond {atol} + {rtol}|ref| by "
                                 f"{excess - atol}")
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]

        def sdpa():
            return F.scaled_dot_product_attention(*leaves, is_causal=causal)

        pairs = S * (S + 1) // 2 if causal else S * S
        # q, k, v and dO read, dq, dk and dv written (P is recomputed, the
        # forward's output is not read)
        b_ms, b_by = bound(7 * B * H * S * Dh * q.element_size(), 10 * B * H * pairs * Dh,
                           dtype)
        sdpa_fwd_ms = time_ms(sdpa)
        sdpa_both_ms = time_ms(lambda: torch.autograd.grad(sdpa(), leaves, dout))
        row = dict(shape=[B, H, S, Dh], dtype=str(dtype), variant=variant, causal=causal,
                   max_abs_err=err, tol=f"{atol} + {rtol} * |plain|",
                   kernel_ms=time_ms(lambda: attention_backward(q, k, v, dout, causal)),
                   plain_ms=time_ms(lambda: attention_reference_backward(q, k, v, dout,
                                                                         causal)),
                   library_ms=sdpa_both_ms - sdpa_fwd_ms, library_fwd_bwd_ms=sdpa_both_ms,
                   bound_ms=b_ms, bound_by=b_by,
                   launches=BWD_KERNEL.launches[variant] - launches0)
        if dtype == torch.bfloat16:
            plan = bwd_plan(S)
            row["plan"] = dict(plan._asdict(), blocks=plan.blocks(B * H))
        emit("attention_bwd", **row)
        rows.append(row)
    return rows


def _qkv(B, H, S, Dh, dtype):
    """Strided q/k/v views of one (B, S, 3, H, Dh) buffer, as the towers pass them."""
    gen = torch.Generator(device="cuda").manual_seed(S)
    qkv = torch.randn((B, S, 3, H, Dh), generator=gen, device="cuda").to(dtype)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def _dout(B, H, S, Dh, dtype):
    """The output gradient as the tower hands it: a (B, H, S, Dh) view of a
    (B, S, H, Dh) buffer."""
    gen = torch.Generator(device="cuda").manual_seed(S + 1)
    return torch.randn((B, S, H, Dh), generator=gen, device="cuda").to(dtype).transpose(1, 2)


def _unit_rows(n: int, d: int, dtype, seed: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((n, d), generator=gen, device="cuda")
    return (a / a.norm(dim=1, keepdim=True)).to(dtype)


def check_topk(cases):
    from keds_tpu_torch.ops.topk import KERNEL, MAX_K, mips_topk, mips_topk_plain, split_plan

    rows = []
    for B, N, D, k, dtype in cases:
        db = _unit_rows(N, D, dtype, seed=N)
        q = _unit_rows(B, D, dtype, seed=B + 1)
        variant = split_plan(B, N, torch.cuda.get_device_properties(0).multi_processor_count,
                             dtype, k)[0].variant + ("_multi" if k > MAX_K else "")
        launches0 = KERNEL.launches[variant]
        vals, idx = mips_topk(q, db, k)
        pv, pi = mips_topk_plain(q, db, min(k + 1, N))
        torch.cuda.synchronize()
        err = (vals - pv[:, :k]).abs().max().item()
        if not err <= TOPK_TOL:
            raise AssertionError(f"mips_topk {B, N, D, k} {dtype}: max_abs_err {err}")
        # an index must match wherever its plain score is separated from both
        # neighbours (the (k+1)-th included, where N has one) by more than the
        # value tolerance
        gaps = (pv[:, :-1] - pv[:, 1:]).abs() > TOPK_TOL
        sep = torch.ones_like(idx, dtype=torch.bool)
        sep[:, :gaps.shape[1]] &= gaps[:, :k]
        sep[:, 1:] &= gaps[:, :k - 1]
        agree = (idx == pi[:, :k]) | ~sep
        if not bool(agree.all()):
            raise AssertionError(f"mips_topk {B, N, D, k} {dtype}: indices differ at "
                                 f"{int((~agree).sum())} separated positions")
        b_ms, b_by = bound((B * D + N * D) * q.element_size() + B * k * 8,
                           2 * B * N * D, dtype)
        row = dict(shape=[B, N, D, k], dtype=str(dtype), variant=variant,
                   max_abs_err=err, tol=TOPK_TOL,
                   idx_equal_share=float((idx == pi[:, :k]).float().mean()),
                   separated_positions=int(sep.sum()),
                   kernel_ms=time_ms(lambda: mips_topk(q, db, k)),
                   plain_ms=time_ms(lambda: mips_topk_plain(q, db, k), iters=5),
                   library_ms=time_ms(lambda: torch.topk(torch.mm(q, db.t()).float(), k)),
                   bound_ms=b_ms, bound_by=b_by,
                   launches=KERNEL.launches[variant] - launches0)
        emit("mips_topk", **row)
        rows.append(row)
        del db, q
        torch.cuda.empty_cache()
    return rows


def prompt_batch(rng: np.random.Generator, batch: int) -> np.ndarray:
    """bench.py's "a photo of * , <14-token caption>" rows (S=32 bucket)."""
    text = np.zeros((batch, 77), np.int32)
    text[:, 0] = 49406
    text[:, 1:4] = [320, 1125, 539]
    text[:, 4:6] = [SPLIT_ID, 267]
    text[:, 6:20] = rng.integers(1000, 40000, (batch, 14))
    text[:, 20] = 49407
    return text


def timed_stage(out: dict, name: str, fn):
    """``fn()``, with its host-clock ms between two synchronises in ``out[name]``."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    out[name] = (time.perf_counter() - t) * 1e3
    return r


def stage_times(engine, images_u8: np.ndarray, text: np.ndarray, corpus) -> dict:
    """Per-stage ms of one query batch (synchronised after each stage)."""
    from keds_tpu_torch.models import clip as mclip
    from keds_tpu_torch.models.composition import compose_pseudo_tokens
    from keds_tpu_torch.tokenizer import bucket_text

    out = {}

    def run(name, fn):
        return timed_stage(out, name, fn)

    with torch.inference_mode():
        im = torch.from_numpy(images_u8).cuda()
        tx = torch.from_numpy(bucket_text(text)).cuda()
        f = run("encode_image", lambda: engine.encode_features(im))
        ti, tt = run("retrieval", lambda: engine.retriever.retrieve_features(
            f.float(), k=engine.db_topk))
        tok = run("fusion_heads", lambda: compose_pseudo_tokens(
            engine.heads, f, ti.to(f.dtype), tt.to(f.dtype)))
        q = run("text_tower", lambda: mclip.encode_text_img_retrieval(
            engine.clip_c, engine.cfg, tx, tok, split_id=SPLIT_ID))
        run("rank", lambda: engine.rank(q / q.norm(dim=-1, keepdim=True), corpus, 10))
    return out


GEMM_WORDS = ("gemm", "xmma", "cutlass", "nvjet", "cublas", "sm90")


def profile_device(phase: str, fn, groups) -> None:
    """torch.profiler over ``fn()``: device ms of each kernel and copy, their
    sums by group (``groups``: (name, words) in order of precedence, the
    first group whose word a kernel name holds takes it; GEMMs and the rest
    follow), and the device's busy share of the profiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # kernels and copies only: a CPU op's self device time repeats its
    # kernels', and a user annotation's device range (the optimizer's step)
    # spans them
    ops = sorted(((e.key, device_us(e) / 1e3, e.count) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and device_us(e) > 0
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda r: -r[1])
    total = sum(ms for _, ms, _ in ops)
    if total == 0:
        emit(phase, device_ms=0.0, wall_ms=wall_ms,
             note="key_averages() shows no device time on this machine")
        return
    sums = {name: 0.0 for name, _ in groups} | {"gemm": 0.0, "other": 0.0}
    for name, ms, _ in ops:
        low = name.lower()
        group = next((g for g, words in groups if any(w in low for w in words)), None)
        if group is None:
            group = "gemm" if any(w in low for w in GEMM_WORDS) else "other"
        sums[group] += ms
    emit(phase, device_ms=total, wall_ms_profiled=wall_ms,
         device_busy_share_profiled=total / wall_ms, groups_ms=sums,
         top=[dict(name=n[:90], ms=ms, count=c, share=ms / total) for n, ms, c in ops[:15]])


def profile_batch(engine, images_u8: np.ndarray, text: np.ndarray, corpus) -> None:
    """Device time of one query batch by kernel."""
    def batch():
        with torch.inference_mode():
            f, _ = engine.compose_batch(images_u8, text)
            engine.rank(f, corpus, 10)

    profile_device("profile", batch, [("attention (B2)", ("attention_tc", "attention_f32")),
                                      ("mips_topk (B1)", ("topk_",))])


def _train_setup(clip_params, heads, db, device, dropout=0.1, dtype=torch.bfloat16,
                 total_steps=20, stream="image", db_other_tokens=None, retriever=None):
    """f32 trainable copies of the heads, their optimizer and the train step
    (over ``retriever``, by default a Retriever of ``db``).  The copies are
    new tensors even where ``heads`` are f32 on ``device`` already (the
    CPU's), which the step would otherwise train in place."""
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.models.convert import cast_floating
    from keds_tpu_torch.retrieval.database import Retriever
    from keds_tpu_torch.train.trainer import make_optimizer, make_train_step

    theads = cast_floating(copy.deepcopy(heads), torch.float32, device)
    opt, sched = make_optimizer(TRAIN_OPT, total_steps, theads)
    step = make_train_step(clip_params, VIT_L_14, retriever or Retriever(db), opt, sched,
                           stream=stream, prompt_tokens=TRAIN_PROMPT, split_id=SPLIT_ID,
                           dropout=dropout, db_other_tokens=db_other_tokens,
                           compute_dtype=dtype, device=device)
    return theads, opt, sched, step


def text_templates(rng: np.random.Generator, n: int, n_stars: int) -> np.ndarray:
    """(n, 77) int32 rows [SOT, a, photo, of, * x n_stars, other, EOT], the
    other caption ``OTHER_LEN`` seeded ids in 1000-40000."""
    lo, hi = OTHER_LEN
    lens = rng.integers(lo, hi + 1, n)
    other = rng.integers(1000, 40000, (n, hi), dtype=np.int32)
    out = np.zeros((n, 77), np.int32)
    out[:, :4] = [49406, 320, 1125, 539]
    out[:, 4:4 + n_stars] = SPLIT_ID
    out[:, 4 + n_stars:4 + n_stars + hi] = np.where(np.arange(hi) < lens[:, None], other, 0)
    out[np.arange(n), 4 + n_stars + lens] = 49407
    return out


def train_stage_times(step, theads, batch, t: int) -> dict:
    """Per-stage ms of train step ``t``: the step's own stage marks, each a
    synchronise and a host-clock reading."""
    out = {}
    torch.cuda.synchronize()
    last = [time.perf_counter()]

    def mark(stage: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[stage], last[0] = (now - last[0]) * 1e3, now

    step(theads, batch, t, mark=mark)
    return out


def train_path(clip_params, heads, db, kernels) -> tuple:
    """The training main path: make_train_step + train_epoch at B=128 on
    one repeated batch, then a checkpoint round trip."""
    from keds_tpu_torch import synth
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.train.losses import TrainBatch
    from keds_tpu_torch.train.trainer import train_epoch

    dev = db.image_db.device
    img, cap = synth.feature_pairs(TRAIN_BATCH, VIT_L_14.embed_dim, seed=5, device=dev)
    batch = TrainBatch(img, cap)
    theads, opt, sched, step = _train_setup(clip_params, heads, db, dev)
    losses = []

    def recorded(h, b, t):
        loss = step(h, b, t)
        losses.append(loss)
        return loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for t in range(2):                      # warm-up steps t = 0, 1
        recorded(theads, batch, t)
    torch.cuda.synchronize()
    for k in kernels.values():
        k.reset()
    t0 = time.perf_counter()
    # timed: epoch 1 of 10 steps (t = 10..19), synchronised at its one log step
    train_epoch(recorded, theads, iter([batch] * 10), 1, 10, log_every=10, schedule=sched)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {name: dict(k.launches) for name, k in kernels.items()}
    missing = [f"{n}/{v}" for n, v in (("attention", "bf16_tc"), ("attention_bwd", "bf16"),
                                       ("mips_topk", "bf16_tc")) if launches[n][v] == 0]
    if missing or launches["attention"]["f32"] or launches["attention_bwd"]["f32"]:
        raise AssertionError(f"train path launches {launches}: missing {missing}")
    loss_vals = [float(x) for x in losses]
    if not (np.isfinite(loss_vals).all() and loss_vals[-1] < loss_vals[0]):
        raise AssertionError(f"train losses not finite and falling: {loss_vals}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    runs = [train_stage_times(step, theads, batch, t) for t in (20, 21, 22)]
    stages = {name: float(np.median([r[name] for r in runs])) for name in runs[0]}

    checkpoint = checkpoint_round_trip(clip_params, theads, opt, dev)
    emit("train_path", model="ViT-L/14", db_rows=db.size, batch=TRAIN_BATCH, dtype="bf16",
         timed_steps=10, step_ms=elapsed / 10 * 1e3, samples_per_s=TRAIN_BATCH * 10 / elapsed,
         stage_ms_one_step=stages, stage_ms_runs=runs, peak_mem_gb=peak_gb,
         losses=loss_vals, launches=launches, checkpoint=checkpoint)
    return theads, opt, step, batch, launches


def checkpoint_round_trip(clip_params, theads, opt, dev) -> dict:
    """Save and reload a train checkpoint: the heads and the AdamW moments
    must come back exactly, and a parameter without state (text_condition
    in the text stream) must stay without."""
    from keds_tpu_torch.io.checkpoint import (load_checkpoint, load_heads_checkpoint,
                                              restore_optimizer, save_train_checkpoint)
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.models.convert import head_parameters
    from keds_tpu_torch.train.trainer import make_optimizer

    t = time.perf_counter()
    build = pathlib.Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        path = str(pathlib.Path(d) / "epoch_1.pt")
        save_train_checkpoint(path, epoch=1, name="chip_smoke", clip_params=clip_params,
                              clip_cfg=VIT_L_14, heads=theads, optimizer=opt)
        ckpt = load_checkpoint(path)
        size_gb = pathlib.Path(path).stat().st_size / 1e9
    heads2, epoch = load_heads_checkpoint(path, dev, ckpt)
    opt2, _ = make_optimizer(TRAIN_OPT, 20, heads2)
    restored = restore_optimizer(opt2, ckpt, heads2)

    def same_state(a, b):
        if (b in opt.state) != (a in opt2.state):
            return False
        return b not in opt.state or all(torch.equal(opt.state[b][m], opt2.state[a][m])
                                         for m in ("exp_avg", "exp_avg_sq"))

    exact = restored and epoch == 1 and all(
        torch.equal(a, b) and same_state(a, b)
        for (_, _, a), (_, _, b) in zip(head_parameters(heads2), head_parameters(theads)))
    if not exact:
        raise AssertionError("checkpoint round trip changed the heads or AdamW moments")
    return dict(exact_round_trip=exact, size_gb=size_gb, seconds=time.perf_counter() - t)


def profile_train(step, theads, batch) -> None:
    """Device time of one train step by group."""
    profile_device("profile_train", lambda: step(theads, batch, 23),
                   [("attention backward (B2')", ("attention_bwd",)),
                    ("attention forward (B2)", ("attention_tc", "attention_f32")),
                    ("mips_topk (B1)", ("topk_",))])


def train_check_batch(db):
    """The check's B=128 feature pairs (seed 6) and the card's top-16
    neighbour rows of both DB modalities."""
    from keds_tpu_torch import synth
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.ops.topk import mips_topk

    img, cap = synth.feature_pairs(TRAIN_BATCH, VIT_L_14.embed_dim, seed=6,
                                   device=db.image_db.device)
    q = (img / img.norm(dim=1, keepdim=True)).to(db.image_db.dtype)
    return img, cap, [mips_topk(q, a, 16)[1] for a in (db.image_db, db.text_db)]


def train_reading(clip_params, heads, db, dtype, inputs, stream="image",
                  db_other_tokens=None) -> tuple:
    """(loss, flattened f64 head gradient) of train step 0 on ``db``'s device
    in ``dtype``, dropout 0, over ``inputs`` (:func:`train_check_batch`, or
    :func:`train_text_check_batch` with the text stream).  In the text
    stream text_condition must get no gradient, and the gradient covers the
    other heads."""
    from keds_tpu_torch.models.convert import head_parameters
    from keds_tpu_torch.train.losses import TrainBatch

    img, cap, idx = inputs[:3]
    dev = db.image_db.device
    theads, _, _, step = _train_setup(clip_params, heads, db, dev, dropout=0.0, dtype=dtype,
                                      stream=stream, db_other_tokens=db_other_tokens)
    extra = {}
    if stream == "text":
        extra = dict(cap2_idx=idx[2].to(dev), other_tokens=inputs[3].to(dev))
    loss = float(step(theads, TrainBatch(img.to(dev), cap.to(dev), img_idx=idx[0].to(dev),
                                         txt_idx=idx[1].to(dev), **extra), 0))
    params = head_parameters(theads)
    if stream == "text":
        if any(p.grad is not None for mod, _, p in params if mod == "text_condition"):
            raise AssertionError("the text stream gave text_condition a gradient")
        params = [(mod, n, p) for mod, n, p in params if mod != "text_condition"]
    return loss, torch.cat([p.grad.flatten().double().cpu() for _, _, p in params])


def compare_readings(card: tuple, cpu: tuple) -> dict:
    """The check's numbers for a card and a CPU reading, and whether they
    pass its limits.  The cosine is None where the card's gradient is 0."""
    (l_card, g_card), (l_cpu, g_cpu) = card, cpu
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    norm_card, norm_cpu = float(g_card.norm()), float(g_cpu.norm())
    cos = float(g_card @ g_cpu) / (norm_card * norm_cpu) if norm_card > 0 else None
    return dict(loss_card_bf16=l_card, loss_cpu_f32=l_cpu, loss_rel_diff=rel,
                loss_rel_max=TRAIN_LOSS_RTOL, head_grad_cosine=cos,
                head_grad_cosine_min=TRAIN_GRAD_COSINE_MIN, head_grad_norm_card=norm_card,
                head_grad_norm_cpu=norm_cpu,
                passes=rel <= TRAIN_LOSS_RTOL and cos is not None
                and cos >= TRAIN_GRAD_COSINE_MIN)


def train_check(clip_params, heads, db, cpu_clip, cpu_heads, cpu_db) -> None:
    """One train step on the card (bf16) against the CPU (f32) from the same
    weights and batch; the card's neighbour indices go to both (idx=), so
    near-ties in the bf16 search do not decide the check, and dropout is 0
    (the two devices' generators differ; the neighbour permutation cancels
    in cross-attention).  ``kernel_sweeps.py train_check_controls`` reads
    the same check with the attention gradient broken."""
    t = time.perf_counter()
    inputs = train_check_batch(db)
    r = compare_readings(train_reading(clip_params, heads, db, torch.bfloat16, inputs),
                         train_reading(cpu_clip, cpu_heads, cpu_db, torch.float32, inputs))
    emit("train_check", **r, seconds=time.perf_counter() - t)
    if not r["passes"]:
        raise AssertionError(f"train step card vs CPU: loss rel diff {r['loss_rel_diff']}, "
                             f"grad cosine {r['head_grad_cosine']}")


def train_text_path(clip_params, heads, db, kernels, table: np.ndarray) -> tuple:
    """The text-stream main path: make_train_step(stream="text") +
    train_epoch at B=128 on one repeated batch, ``table`` the neighbour
    templates of every DB row, then a checkpoint round trip."""
    from keds_tpu_torch import synth
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.models.convert import head_parameters
    from keds_tpu_torch.tokenizer import bucket_text
    from keds_tpu_torch.train.losses import TrainBatch
    from keds_tpu_torch.train.trainer import train_epoch

    dev = db.image_db.device
    img, cap = synth.feature_pairs(TRAIN_BATCH, VIT_L_14.embed_dim, seed=8, device=dev)
    own = bucket_text(text_templates(np.random.default_rng(8), TRAIN_BATCH, 3), n_pseudo=1)
    batch = TrainBatch(img, cap, other_tokens=torch.as_tensor(own, device=dev))
    theads, opt, sched, step = _train_setup(clip_params, heads, db, dev, stream="text",
                                            db_other_tokens=table)
    condition = [(p, p.detach().clone()) for mod, _, p in head_parameters(theads)
                 if mod == "text_condition"]
    losses = []

    def recorded(h, b, t):
        loss = step(h, b, t)
        losses.append(loss)
        return loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for t in range(2):                      # warm-up steps t = 0, 1
        recorded(theads, batch, t)
    torch.cuda.synchronize()
    for k in kernels.values():
        k.reset()
    t0 = time.perf_counter()
    train_epoch(recorded, theads, iter([batch] * 10), 1, 10, log_every=10, schedule=sched)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {name: dict(k.launches) for name, k in kernels.items()}
    missing = [f"{n}/{v}" for n, v in (("attention", "bf16_tc"), ("attention_bwd", "bf16"))
               if launches[n][v] == 0]
    f32 = [n for n in kernels if launches[n].get("f32")]
    # B1 twice a step: the image DB at k=16 and the caption DB at k=2 (the
    # caption neighbours of the image stream are not searched)
    if missing or f32 or launches["mips_topk"]["bf16_tc"] != 2 * 10:
        raise AssertionError(f"text train path launches {launches}: missing {missing}, "
                             f"f32 {f32}, B1 bf16_tc not 20")
    loss_vals = [float(x) for x in losses]
    if not (np.isfinite(loss_vals).all() and loss_vals[-1] < loss_vals[0]):
        raise AssertionError(f"text train losses not finite and falling: {loss_vals}")
    if not all(torch.equal(p, p0) and p not in opt.state for p, p0 in condition):
        raise AssertionError("the text stream changed text_condition or gave it AdamW state")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    runs = [train_stage_times(step, theads, batch, t) for t in (20, 21, 22)]
    stages = {name: float(np.median([r[name] for r in runs])) for name in runs[0]}
    checkpoint = checkpoint_round_trip(clip_params, theads, opt, dev)
    emit("train_text_path", model="ViT-L/14", db_rows=db.size, batch=TRAIN_BATCH,
         dtype="bf16", own_bucket=int(own.shape[1]), timed_steps=10,
         step_ms=elapsed / 10 * 1e3, samples_per_s=TRAIN_BATCH * 10 / elapsed,
         stage_ms_one_step=stages, stage_ms_runs=runs, peak_mem_gb=peak_gb,
         losses=loss_vals, launches=launches, text_condition_unchanged=True,
         checkpoint=checkpoint)
    return theads, step, batch, launches


def profile_train_text(step, theads, batch) -> None:
    """Device time of one text-stream step by group."""
    profile_device("profile_train_text", lambda: step(theads, batch, 23),
                   [("attention backward (B2')", ("attention_bwd",)),
                    ("attention forward (B2)", ("attention_tc", "attention_f32")),
                    ("mips_topk (B1)", ("topk_",))])


def train_text_check_batch(db):
    """The text check's B=128 feature pairs (seed 9), own templates at the
    full width 77, and the card's image, caption and caption-neighbour rows,
    searched as the step searches them."""
    from keds_tpu_torch import synth
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.retrieval.database import Retriever, unit_rows

    img, cap = synth.feature_pairs(TRAIN_BATCH, VIT_L_14.embed_dim, seed=9,
                                   device=db.image_db.device)
    retr = Retriever(db)
    idx = retr.neighbour_indices(img, 16) + (retr.caption_indices(unit_rows(cap), 2),)
    own = torch.from_numpy(text_templates(np.random.default_rng(9), TRAIN_BATCH, 3))
    return img, cap, idx, own


def train_text_check(clip_params, heads, db, cpu_clip, cpu_heads, cpu_db, table,
                     kernels) -> None:
    """One text-stream step on the card (bf16) against the CPU (f32) from
    the same weights and batch, the card's index triple fed to both,
    dropout 0; the limits are train_check's.  The card step's launches
    (its own templates at S=77, the neighbours' at S=32) are counted."""
    t = time.perf_counter()
    inputs = train_text_check_batch(db)
    before = {name: dict(k.launches) for name, k in kernels.items()}
    card = train_reading(clip_params, heads, db, torch.bfloat16, inputs, "text", table)
    launches = {name: {v: n - before[name][v] for v, n in k.launches.items()}
                for name, k in kernels.items()}
    r = compare_readings(card, train_reading(cpu_clip, cpu_heads, cpu_db, torch.float32,
                                             inputs, "text", table))
    emit("train_text_check", **r, own_width=int(inputs[3].shape[1]),
         text_condition_grad="none on both", launches_card_step=launches,
         seconds=time.perf_counter() - t)
    if not r["passes"]:
        raise AssertionError(f"text train step card vs CPU: loss rel diff "
                             f"{r['loss_rel_diff']}, grad cosine {r['head_grad_cosine']}")


class Batches:
    """An in-memory loader: ``n`` batches, batch ``i`` made by ``make(i)``
    each time the loader is iterated."""

    def __init__(self, n: int, make):
        self.n, self.make = n, make

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        return (self.make(i) for i in range(self.n))


def cirr_split(seed: int) -> SimpleNamespace:
    """A CIRR-val-shaped split from ``seed``: EVAL_CORPUS uint8 224x224
    corpus images named ``dev/NNNN.png`` and EVAL_QUERIES queries, each a
    corpus image as its reference, another as its target (every name once
    in the corpus, so check_cirr_gt_unique holds) and a prompt "a photo of
    * , <14 seeded ids>" (the S=32 bucket).  Loaders of QUERY_BATCH yield
    the CIRR val tuples."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (EVAL_CORPUS, 224, 224, 3), dtype=np.uint8)
    names = [f"{i:04d}.png" for i in range(EVAL_CORPUS)]
    ref = rng.integers(0, EVAL_CORPUS, EVAL_QUERIES)
    target = (ref + rng.integers(1, EVAL_CORPUS, EVAL_QUERIES)) % EVAL_CORPUS
    text = prompt_batch(rng, EVAL_QUERIES)
    caption = np.zeros_like(text)
    caption[:, 0], caption[:, 1:15], caption[:, 15] = 49406, text[:, 6:20], 49407

    def corpus_batch(i):
        sl = slice(i * QUERY_BATCH, (i + 1) * QUERY_BATCH)
        return images[sl], [f"dev/{n}" for n in names[sl]]

    def query_batch(i):
        sl = slice(i * QUERY_BATCH, (i + 1) * QUERY_BATCH)
        r, t = ref[sl], target[sl]
        return (images[r], text[sl], caption[sl], [names[j] for j in r],
                [names[j] for j in t], ["a photo of * , <ids>"] * len(r), ["<ids>"] * len(r))

    return SimpleNamespace(
        ref=ref, target=target, names=names,
        corpus=Batches(-(-EVAL_CORPUS // QUERY_BATCH), corpus_batch),
        queries=Batches(-(-EVAL_QUERIES // QUERY_BATCH), query_batch))


def write_branches(root: pathlib.Path, device: torch.device) -> list:
    """Heads-only reference-layout checkpoints epoch_1..EVAL_EPOCHS of an
    image and a text branch, each epoch's heads from synth with a seed of
    its own."""
    from keds_tpu_torch import synth
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.models.convert import heads_to_state_dicts

    branches = []
    for b, name in enumerate(("image_branch", "text_branch")):
        (root / name).mkdir()
        for j in range(1, EVAL_EPOCHS + 1):
            heads = synth.init_heads(VIT_L_14.embed_dim, 1000 * (b + 1) + j, device,
                                     torch.float32)
            torch.save({"epoch": j, **heads_to_state_dicts(heads)},
                       root / name / f"epoch_{j}.pt")
        branches.append(str(root / name))
    return branches


def target_positions(split, idx: np.ndarray, order: np.ndarray) -> tuple:
    """Each query's target position after its reference is removed, capped
    at 100 (what R@1..R@100 read): from the device's top-101 indices
    ``idx`` (absent: 100), and from the host's full ascending-distance order
    ``order``."""
    r, t = split.ref[:, None], split.target[:, None]
    hit = idx == t
    col = hit.argmax(axis=1)
    ref_before = ((idx == r) & (np.arange(idx.shape[1]) < col[:, None])).any(axis=1)
    pos_d = np.where(hit.any(axis=1), col - ref_before, 100)
    rank = np.empty_like(order)
    rank[np.arange(order.shape[0])[:, None], order] = np.arange(order.shape[1])
    pos_t = np.take_along_axis(rank, t, 1)[:, 0]
    pos_r = np.take_along_axis(rank, r, 1)[:, 0]
    return np.minimum(pos_d, 100), np.minimum(pos_t - (pos_r < pos_t), 100)


def recall_table(pos: np.ndarray) -> dict:
    """get_metrics_cirr's table from target positions."""
    return {f"recall_R@{k}": float(np.sum(pos < k) / len(pos)) * 100
            for k in (1, 5, 10, 50, 100)}


def near_tie_gate(split, runs: dict) -> dict:
    """Host and device recall tables must be equal, but for queries whose two
    rankings differ only between entries whose host scores lie within
    NEAR_TIE of the target's (a tie to within f32 summation order).  The
    host positions are recomputed from the host run's features with its
    formula and must give its tables; the device positions come from the
    device run's top-101 indices."""
    host, dev = runs["host"], runs["device"]
    corpus = host["corpus"]
    near, bad, moved = 0, [], []
    feat_diff = max(float(np.abs(a - b).max()) for fa, fb in zip(host["feats"], dev["feats"])
                    for a, b in zip(fa, fb))
    for e, j in enumerate(range(1, EVAL_EPOCHS + 1)):
        a, b = host["feats"][e]
        mixture = a * 0.5 + b * 0.5
        mixture /= np.linalg.norm(mixture, axis=-1, keepdims=True)
        for key, f, idx in zip(("composed", "image", "mixture"), (a, b, mixture),
                               dev["topk"][e]):
            scores = f @ corpus.T
            order = np.argsort(1 - scores, axis=-1, kind="stable")
            pos_d, pos_h = target_positions(split, idx, order)
            if recall_table(pos_h) != host["tables"][(j, key)]:
                raise AssertionError(f"eval gate: host positions do not give the host "
                                     f"table at {(j, key)}")
            if recall_table(pos_d) != dev["tables"][(j, key)]:
                raise AssertionError(f"eval gate: device positions do not give the "
                                     f"device table at {(j, key)}")
            for q in np.nonzero(pos_d != pos_h)[0]:
                kept = order[q][order[q] != split.ref[q]]
                lo, hi = sorted((pos_d[q], pos_h[q]))
                window = kept[lo:hi + 1]
                if np.abs(scores[q, window] - scores[q, split.target[q]]).max() <= NEAR_TIE:
                    near += 1
                else:
                    bad.append(dict(epoch=j, key=key, query=int(q), host_pos=int(pos_h[q]),
                                    device_pos=int(pos_d[q])))
            moved += [f"{j}/{key}/{m}" for m, v in host["tables"][(j, key)].items()
                      if dev["tables"][(j, key)][m] != v]
    return dict(near_tie_queries=near, cells_moved=moved, other_differences=bad[:10],
                n_other=len(bad), tables_equal=host["tables"] == dev["tables"],
                composed_feature_max_diff=feat_diff, near_tie=NEAR_TIE,
                passes=not bad)


def check_eval_launches(launches: dict, n_batches: int) -> None:
    """The device-ranked sweep's launches: B1 f32 at k=101 three times an
    epoch, B1 bf16_tc twice a query batch (image and caption DB), B2
    bf16_tc in both towers, nothing else."""
    want = {("mips_topk", "f32"): 3 * EVAL_EPOCHS, ("mips_topk", "bf16_tc"): 2 * n_batches,
            ("mips_topk", "bf16"): 0, ("attention", "f32"): 0}
    got = {key: launches[key[0]][key[1]] for key in want}
    if (got != want or launches["attention"]["bf16_tc"] == 0
            or any(launches["attention_bwd"].values())):
        raise AssertionError(f"eval path launches {launches}; want {want}, B2 bf16_tc > 0, "
                             "no backward")


def eval_path(clip_params, db, kernels, root: pathlib.Path) -> tuple:
    """The evaluation main path: evaluate_cirr over EVAL_EPOCHS sweep epochs
    of a CIRR-val-sized split, device ranking and then host ranking, with
    the main path's ViT-L/14 and DB, the head branches written under
    ``root``, and the gate between the two."""
    from keds_tpu_torch.evalkit import evaluators as ev
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.retrieval.database import Retriever

    t = time.perf_counter()
    split = cirr_split(11)
    gen_s = time.perf_counter() - t
    runs = {}
    real = (ev._encode_corpus, ev._compose_all, ev._rank_topk)
    run = {}

    def encode_corpus(ctx, loader):
        corpus, names = real[0](ctx, loader)
        run["corpus"] = corpus
        return corpus, names

    def compose_all(ctx, compose, hi, ht, cache, texts=None):
        out = real[1](ctx, compose, hi, ht, cache, texts)
        run["feats"].append(out)                     # kept on the card until the end
        run["profile"] = (ctx, compose, cache)
        return out

    def rank_topk(feats, corpus_dev, k):
        out = real[2](feats, corpus_dev, k)
        run["topk"].append(out)
        run["corpus_dev"] = corpus_dev
        return out

    branches = write_branches(root, db.image_db.device)
    ev._encode_corpus, ev._compose_all, ev._rank_topk = encode_corpus, compose_all, rank_topk
    try:
        for ranking in ("device", "host"):
            run = dict(feats=[], topk=[])
            ctx = ev.EvalContext(clip_params, VIT_L_14, Retriever(db),
                                 image_branch=branches[0], text_branch=branches[1],
                                 compute_dtype=torch.bfloat16,
                                 eval_ranking=ranking, split_id=SPLIT_ID)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for k in kernels.values():
                k.reset()
            t0 = time.perf_counter()
            tables = ev.evaluate_cirr(ctx, split.queries, split.corpus,
                                      epochs=range(1, EVAL_EPOCHS + 1))
            torch.cuda.synchronize()
            run.update(tables=tables, seconds=time.perf_counter() - t0,
                       walls=dict(ev.last_cirr_walls),
                       launches={n: dict(k.launches) for n, k in kernels.items()},
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            runs[ranking] = run
    finally:
        ev._encode_corpus, ev._compose_all, ev._rank_topk = real
    for r in runs.values():
        r["feats"] = [tuple(f.cpu().numpy() for f in pair) for pair in r["feats"]]
    launches = runs["device"]["launches"]
    check_eval_launches(launches, len(split.queries))
    for r in runs.values():
        ok = set(r["tables"]) == {(j, k) for j in range(1, EVAL_EPOCHS + 1)
                                  for k in ("composed", "image", "mixture")}
        if not ok or not all(0 <= v <= 100 for m in r["tables"].values() for v in m.values()):
            raise AssertionError(f"eval tables malformed: {r['tables']}")
    t = time.perf_counter()
    gate = near_tie_gate(split, runs)
    gate["seconds"] = time.perf_counter() - t

    def summary(r):
        w = r["walls"]
        return dict(seconds=r["seconds"], walls=w, peak_mem_gb=r["peak_mem_gb"],
                    corpus_images_per_s=EVAL_CORPUS / w["corpus_s"],
                    queries_per_s=EVAL_QUERIES / w["queries_s"],
                    per_epoch_s={k: w[f"sweep_{k}_s"] / w["epochs"]
                                 for k in ("load", "compose", "metrics")},
                    last_epoch={k: r["tables"][(EVAL_EPOCHS, k)]
                                for k in ("composed", "image", "mixture")})

    emit("eval_path", model="ViT-L/14", db_rows=db.size, dtype="bf16",
         corpus_images=EVAL_CORPUS, queries=EVAL_QUERIES, query_batch=QUERY_BATCH,
         epochs=EVAL_EPOCHS, split_made_s=gen_s, device=summary(runs["device"]),
         host=summary(runs["host"]), launches=launches, gate=gate)
    if not gate["passes"]:
        raise AssertionError(f"eval gate: host and device rankings differ beyond near-ties "
                             f"at {gate['n_other']} queries: {gate['other_differences']}")
    return split, runs["device"]["profile"], runs["device"]["corpus_dev"], launches


def profile_eval(split, profile, corpus_dev) -> None:
    """Device time of one device-ranked sweep epoch (heads loaded, both
    branches composed, three rankings and their tables) by group."""
    from keds_tpu_torch.evalkit import evaluators as ev, metrics as M

    ctx, compose, cache = profile
    refs = [split.names[i] for i in split.ref]
    targets = [split.names[i] for i in split.target]

    def epoch():
        with torch.inference_mode():
            hi = ctx.load_heads(ctx.image_branch, 1)
            ht = ctx.load_heads(ctx.text_branch, 1)
            a, b = ev._compose_all(ctx, compose, hi, ht, cache)
            for ti in ev._rank_topk((a, b, ev._mix(a, b, 0.5, 0.5)), corpus_dev, 101):
                M.get_metrics_cirr_from_topk(ti, split.names, refs, targets, EVAL_CORPUS)

    profile_device("profile_eval", epoch, [("attention (B2)", ("attention_tc", "attention_f32")),
                                           ("mips_topk (B1)", ("topk_",))])


# --- the serve and demo CLIs and raw-image training ----------------------------

# A copy of tests/torch_port_helpers.py:SYNTHETIC_MERGES: the card's machine
# has no CLIP BPE vocab.  '*' keeps its id 265; SOT and EOT keep theirs.
SYNTHETIC_MERGES = """t h|th e</w>|o f</w>|p h|ph o|pho t|phot o</w>|a n|an d</w>|i n|in g</w>
e r|e s|o n|o r|r e|a t|e n|h a|ha t</w>|d o|do g</w>|c a|ca t</w>|w e|a r|t o|s t
l l</w>|b a|ba ll</w>|c h|ch a|cha s|chas ing</w>|r ed</w>|e d</w>|Ã ©|Ã ©</w>
ca f|caf Ã©</w>|n u|nu m|num b|numb er|number s</w>|1 2</w>|w or|wor ld</w>|l d</w>
x x|xx xx|xxxx xxxx|! !|!! !</w>|' s</w>""".replace("\n", "|").split("|")
WORDS = ("the dog cat ball red hat chasing and of world numbers cafe a on in with "
         "street man woman blue green near tree car house water people").split()
SERVE_CORPUS = 4096    # the serve CLI ranks a corpus this large on the device
SERVE_QUERIES = 512
SERVE_WIDE_TOPN = 300  # above 256: the multi-pass top-k
SERVE_WIDE_QUERIES = 128
SERVE_CHECK_QUERIES = 4
DEMO_CORPUS = 256
RAW_SHARDS, RAW_PER_SHARD = 4, 384
RAW_CHECK_BATCH = 8    # small enough for the CPU's f32 ViT-L/14 encode
CLI_ROWS = 16          # the CLI runs: 2 steps of 8 an epoch over a 1000-row DB


DEV = "cuda"


def check_path_launches(path: str, launches: dict, want: dict, positive=()) -> None:
    """A path's launch counts: each (kernel, variant) of ``want`` exactly,
    each of ``positive`` at least once."""
    got = {key: launches[key[0]][key[1]] for key in want}
    zero = [key for key in positive if launches[key[0]][key[1]] == 0]
    if got != want or zero:
        raise AssertionError(f"{path} launches {launches}: want {want}, none of {zero}")


def caption(rng: np.random.Generator) -> str:
    """A CC3M-length caption (8-14 words)."""
    return " ".join(rng.choice(WORDS, int(rng.integers(8, 15))))


def jpeg_bytes(rng: np.random.Generator, px: int = 256) -> bytes:
    """A smooth px x px JPEG: 16 x 16 noise upsampled (tens of KB)."""
    import io

    from PIL import Image

    small = Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
    buf = io.BytesIO()
    small.resize((px, px), Image.BILINEAR).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def write_smoke_files(root: pathlib.Path, clip_params, heads, db) -> SimpleNamespace:
    """The files the CLIs read, under ``root``: the synthetic vocab (set in
    KEDS_TPU_BPE_VOCAB), reference-layout ViT-L/14 checkpoints with an MLP
    and a CrossFormer img2text, the 0.5M DB in f32 and a 1000-row one,
    SERVE_CORPUS 256 px JPEGs, queries.jsonl, csvs of DEMO_CORPUS and
    CLI_ROWS images, tar shards of the first RAW_SHARDS x RAW_PER_SHARD
    images and their caption map."""
    import gzip
    import io
    import os
    import tarfile

    from keds_tpu_torch.io.checkpoint import save_train_checkpoint
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.models.convert import heads_to_state_dicts

    t = time.perf_counter()
    f = SimpleNamespace(root=root)
    f.vocab = root / "merges.txt.gz"
    with gzip.open(f.vocab, "wt", encoding="utf-8") as fh:
        fh.write("#version: synthetic\n" + "\n".join(SYNTHETIC_MERGES) + "\n")
    os.environ["KEDS_TPU_BPE_VOCAB"] = str(f.vocab)
    f.mlp = root / "mlp.pt"
    save_train_checkpoint(str(f.mlp), epoch=1, name="chip_smoke", clip_params=clip_params,
                          clip_cfg=VIT_L_14, heads=heads)
    ckpt = torch.load(f.mlp, map_location="cpu", weights_only=False)
    ckpt["state_dict_img2text"] = heads_to_state_dicts(heads)["state_dict_retrieval_fuse"]
    f.cross = root / "cross.pt"
    torch.save(ckpt, f.cross)
    del ckpt
    f.db, f.tiny_db = root / "db", root / "tiny_db"
    for d, rows in ((f.db, db.size), (f.tiny_db, 1000)):
        d.mkdir()
        np.save(d / "image_db.npy", db.image_db[:rows].float().cpu().numpy())
        np.save(d / "text_db.npy", db.text_db[:rows].float().cpu().numpy())
        (d / "database_names.txt").write_text("\n".join(db.names[:rows]))
    rng = np.random.default_rng(21)
    f.corpus = root / "corpus"
    f.corpus.mkdir()
    caps, paths = {}, []
    for i in range(SERVE_CORPUS):
        key = f"img{i:05d}"
        paths.append(f.corpus / f"{key}.jpg")
        paths[-1].write_bytes(jpeg_bytes(rng))
        caps[key] = caption(rng)
    f.queries = root / "queries.jsonl"
    f.queries.write_text("\n".join(json.dumps(
        {"image": str(paths[int(rng.integers(SERVE_CORPUS))]),
         "text": f"a photo of * , {caption(rng)}"}) for _ in range(SERVE_QUERIES)))
    f.wide_queries = root / "wide_queries.jsonl"
    f.wide_queries.write_text("\n".join(f.queries.read_text().splitlines()[:SERVE_WIDE_QUERIES]))
    for name, n in (("demo.csv", DEMO_CORPUS), ("train.csv", CLI_ROWS)):
        setattr(f, name.split(".")[0] + "_csv", root / name)
        (root / name).write_text("filepath\ttitle\n" + "\n".join(
            f"{paths[i]}\t{caps[paths[i].stem]}" for i in range(n)))
    f.shards = []
    for s in range(RAW_SHARDS):
        f.shards.append(str(root / f"cc-{s:05d}.tar"))
        with tarfile.open(f.shards[-1], "w") as tf:
            for p in paths[s * RAW_PER_SHARD:(s + 1) * RAW_PER_SHARD]:
                data = p.read_bytes()
                info = tarfile.TarInfo(f"{p.stem}.image_byte")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    f.captions = root / "caps.json"
    f.captions.write_text(json.dumps(caps))
    f.seconds = time.perf_counter() - t
    return f


def _serve_args(f, out: pathlib.Path, queries, topn: int) -> list:
    return ["--resume", str(f.mlp), "--database-path", str(f.db), "--target-data",
            str(f.corpus), "--query_file", str(queries), "--demo-out", str(out),
            "--batch-size", str(QUERY_BATCH), "--topn", str(topn), "--workers", "8",
            "--logs", str(f.root / "logs"), "--name", out.stem]


def served_results(path) -> list:
    return [json.loads(x) for x in open(path)]


def serve_gate(device_rows: list, host_rows: list) -> dict:
    """Device- and host-ranked result files: the same names in the same
    order, but where the two names' host scores lie within NEAR_TIE of each
    other (a tie to within f32 summation order; counted)."""
    near, bad, score_diff = 0, [], 0.0
    for qi, (d, h) in enumerate(zip(device_rows, host_rows)):
        dn, hn = [r["name"] for r in d["results"]], [r["name"] for r in h["results"]]
        ds = np.array([r["score"] for r in d["results"]])
        hs = np.array([r["score"] for r in h["results"]])
        if len(dn) != len(hn):
            bad.append(dict(query=qi, lengths=(len(dn), len(hn))))
            continue
        score_diff = max(score_diff, float(np.abs(ds - hs).max()))
        host_score = dict(zip(hn, hs))
        for r in np.nonzero(np.array(dn) != np.array(hn))[0]:
            other = host_score.get(dn[r], hs[-1])
            if abs(other - hs[r]) <= NEAR_TIE:
                near += 1
            else:
                bad.append(dict(query=qi, rank=int(r), device=dn[r], host=hn[r]))
    return dict(queries=len(device_rows), near_tie_positions=near, other_differences=bad[:10],
                n_other=len(bad), max_score_diff=score_diff, near_tie=NEAR_TIE,
                passes=not bad and len(device_rows) == len(host_rows) > 0)


def serve_check(f) -> dict:
    """SERVE_CHECK_QUERIES queries composed on the card in bf16 against the
    CPU in f32, each engine built from the files as the serve CLI builds
    it: the cosine of each pair."""
    from keds_tpu_torch.cli import serve
    from keds_tpu_torch.engine import ComposedQueryEngine
    from keds_tpu_torch.io.checkpoint import load_heads_checkpoint
    from keds_tpu_torch.models.loader import load_clip
    from keds_tpu_torch.retrieval.database import KnowledgeDB

    t = time.perf_counter()
    rows = [json.loads(x) for x in f.queries.read_text().splitlines()[:SERVE_CHECK_QUERIES]]
    feats = {}
    for dev, dtype in ((DEV, torch.bfloat16), ("cpu", torch.float32)):
        clip_params, cfg, _, t_val = load_clip(str(f.mlp), normalize_on_host=False, device=dev)
        heads, _ = load_heads_checkpoint(str(f.mlp), dev)
        db = KnowledgeDB.from_directory(str(f.db), dtype, dev)
        engine = ComposedQueryEngine(clip_params, cfg, heads, db, compute_dtype=dtype,
                                     device=dev)
        ds = serve._QueryDataset(rows, t_val)
        images, text = zip(*(ds[i] for i in range(len(ds))))
        feats[dev] = engine.compose([np.stack(images)], [np.stack(text)])
        del engine, db, clip_params, heads
    torch.cuda.empty_cache()
    a, b = feats[DEV], feats["cpu"]
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    return dict(cosine=cos.tolist(), min_cosine=float(cos.min()), threshold=COSINE_MIN,
                seconds=time.perf_counter() - t)


def serve_path(f, kernels) -> dict:
    """The serve CLI in this process: SERVE_QUERIES queries over the
    SERVE_CORPUS-image folder at --topn 10 (ranked on the device), then the
    first SERVE_WIDE_QUERIES at --topn 300 ranked on the device and on the
    host, the gate between the two, and the card-vs-CPU check.  Launch
    counts are zeroed just before and read just after each device run."""
    from keds_tpu_torch.cli import serve

    def run(out_name, queries, topn):
        for k in kernels.values():
            k.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):   # the CLI prints its output path
            out = serve.main(_serve_args(f, f.root / out_name, queries, topn))
        torch.cuda.synchronize()
        out.update(wall_s=time.perf_counter() - t,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches={n: dict(k.launches) for n, k in kernels.items()})
        return out

    main = run("served.jsonl", f.queries, 10)
    n_batches = -(-SERVE_QUERIES // QUERY_BATCH)
    rows = served_results(main["out_path"])
    if not (main["device_ranking"] and len(rows) == SERVE_QUERIES
            and all(len(r["results"]) == 10 for r in rows)
            and all(np.isfinite([x["score"] for x in r["results"]]).all() for r in rows)):
        raise AssertionError(f"serve CLI output malformed: {main}")
    la = main["launches"]
    # B1 bf16_tc twice a query batch (both DB modalities), B1 f32 once (the
    # ranking at --topn 10), B2 in both towers; no backward
    check_path_launches("serve", la, {
        ("mips_topk", "bf16_tc"): 2 * n_batches, ("mips_topk", "f32"): n_batches,
        ("mips_topk", "f32_multi"): 0, ("attention", "f32"): 0,
        ("attention_bwd", "bf16"): 0, ("attention_bwd", "f32"): 0},
        [("attention", "bf16_tc")])
    wide = run("served_wide.jsonl", f.wide_queries, SERVE_WIDE_TOPN)
    n_wide = -(-SERVE_WIDE_QUERIES // QUERY_BATCH)
    passes = -(-SERVE_WIDE_TOPN // 256)
    check_path_launches("serve --topn 300", wide["launches"], {
        ("mips_topk", "f32_multi"): passes * n_wide, ("mips_topk", "f32"): 0,
        ("mips_topk", "bf16_tc"): 2 * n_wide})
    real_min = serve.DEVICE_RANK_MIN_ROWS
    serve.DEVICE_RANK_MIN_ROWS = SERVE_CORPUS + 1
    try:
        host = run("served_host.jsonl", f.wide_queries, SERVE_WIDE_TOPN)
    finally:
        serve.DEVICE_RANK_MIN_ROWS = real_min
    if host["device_ranking"] or not wide["device_ranking"]:
        raise AssertionError("serve ranking placement not as asked")
    gate = serve_gate(served_results(wide["out_path"]), served_results(host["out_path"]))
    check = serve_check(f)

    def summary(r):
        return dict(corpus_images=r["corpus_images"], corpus_s=r["corpus_s"],
                    corpus_images_per_s=r["corpus_images"] / r["corpus_s"],
                    queries=r["queries"], queries_s=r["queries_s"],
                    queries_per_s=r["queries"] / r["queries_s"], wall_s=r["wall_s"],
                    peak_mem_gb=r["peak_mem_gb"], device_ranking=r["device_ranking"])

    emit("serve_path", model="ViT-L/14", db_rows=DB_ROWS, dtype="bf16", batch=QUERY_BATCH,
         workers=8, main=summary(main), topn_300_device=summary(wide),
         topn_300_host=summary(host), launches=la, launches_topn_300=wide["launches"],
         gate=gate, check=check)
    if not gate["passes"]:
        raise AssertionError(f"serve gate: device and host rankings differ beyond near-ties "
                             f"at {gate['n_other']} positions: {gate['other_differences']}")
    if not check["min_cosine"] >= COSINE_MIN:
        raise AssertionError(f"serve card bf16 vs CPU f32 cosine {check['cosine']}")
    return dict(serve=la, serve_topn300=wide["launches"])


def demo_reference_top10(f, ckpt, query: str, prompts: list, cache: dict) -> list:
    """The demo's ranking recomputed apart from the CLI: the composed query
    from the checkpoint's files through the model functions, ranked on the
    host against the demo's feature cache as the engine's host branch ranks
    (stable descending sort of f32 products)."""
    from PIL import Image

    from keds_tpu_torch.io.checkpoint import load_checkpoint
    from keds_tpu_torch.models import clip as mclip, heads as mheads
    from keds_tpu_torch.models.convert import (cast_floating, crossformer_from_state_dict,
                                               im2text_from_state_dict, params_from_numpy)
    from keds_tpu_torch.models.loader import load_clip
    from keds_tpu_torch.tokenizer import star_token_id, tokenize

    clip_params, cfg, _, t_val = load_clip(str(ckpt), normalize_on_host=False, device=DEV)
    clip_c = cast_floating(clip_params, torch.bfloat16, DEV)
    sd = load_checkpoint(str(ckpt))["state_dict_img2text"]
    cross = any(k.startswith("cross_layers") for k in sd)
    img2text = params_from_numpy(crossformer_from_state_dict(sd) if cross
                                 else im2text_from_state_dict(sd), DEV)
    text = torch.as_tensor(tokenize(prompts), device=DEV)
    with torch.inference_mode():
        im = torch.as_tensor(t_val(Image.open(query))[None], device=DEV)
        feat = mclip.encode_image_chunked(clip_c, cfg, im)
        if cross:
            seq, _ = mclip.get_text_tokens(clip_c, cfg, text)
            q = feat[:, None].expand(len(prompts), 1, feat.shape[-1])
            out = mheads.crossformer_apply(img2text, q, seq, seq)[:, 0] @ \
                clip_c["text"]["proj"].to(feat.dtype)
        else:
            tok = mheads.im2text_apply(img2text, feat)[:, None].expand(len(prompts), 1, -1)
            out = mclip.encode_text_img_retrieval(clip_c, cfg, text, tok, star_token_id())
        out = (out / out.norm(dim=-1, keepdim=True)).float().cpu().numpy()
    sims = out @ np.asarray(cache["feats"], np.float32).T
    order = np.argsort(-sims, axis=1, kind="stable")[:, :10]
    return [[cache["path"][j] for j in row] for row in order], sims


def demo_path(f, kernels) -> dict:
    """The demo CLI on the card, in a working directory of its own, once per
    intent: a query image and two prompts against the DEMO_CORPUS-image csv;
    index.html and the cache are written, and each prompt's top-10 equals
    the ranking recomputed apart (:func:`demo_reference_top10`) but for
    swaps within NEAR_TIE."""
    import os
    import pickle

    from keds_tpu_torch.cli import demo

    prompts = ["a cartoon of *", "a photo of * on the street"]
    query = json.loads(f.queries.read_text().splitlines()[0])["image"]
    out, launches = {}, {}
    cwd = os.getcwd()
    for intent, ckpt in (("mlp", f.mlp), ("crossformer", f.cross)):
        work = f.root / f"demo_{intent}"
        work.mkdir()
        for k in kernels.values():
            k.reset()
        t = time.perf_counter()
        os.chdir(work)
        try:
            r = demo.main(["--retrieval-data", str(f.demo_csv), "--query_file", query,
                           "--prompts", ",".join(prompts), "--resume", str(ckpt),
                           "--demo-out", str(work / "demo"), "--batch-size", str(QUERY_BATCH),
                           "--workers", "8", "--logs", str(work / "logs"), "--name", intent])
        finally:
            os.chdir(cwd)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches[intent] = {n: dict(k.launches) for n, k in kernels.items()}
        cache_file = work / r["cache"]
        html = (work / "demo" / "index.html").read_text()
        with open(cache_file, "rb") as fh:
            cache = pickle.load(fh)
        want, sims = demo_reference_top10(f, ckpt, query, prompts, cache)
        near, bad = 0, []
        for p, (got_row, want_row) in enumerate(zip(r["top10"][0], want)):
            score = dict(zip(cache["path"], sims[p]))
            for i, (g, w) in enumerate(zip(got_row, want_row)):
                if g != w:
                    if abs(score[g] - score[w]) <= NEAR_TIE:
                        near += 1
                    else:
                        bad.append(dict(prompt=p, rank=i, demo=g, reference=w))
        # no B1: the demo ranks on the host and its MLP intent retrieves nothing
        check_path_launches(f"demo {intent}", launches[intent],
                            {("mips_topk", v): 0 for v in launches[intent]["mips_topk"]},
                            [("attention", "bf16_tc")])
        ok = (r["late_fusion"] == (intent == "crossformer") and html.count("<table>") == 2
              and len(cache["path"]) == DEMO_CORPUS and cache["feats"].shape[0] == DEMO_CORPUS
              and np.isfinite(cache["feats"]).all() and not bad)
        out[intent] = dict(seconds=seconds, late_fusion=r["late_fusion"],
                           cache=os.path.basename(r["cache"]), near_tie_swaps=near,
                           differences=bad[:5], passes=ok)
        if not ok:
            raise AssertionError(f"demo {intent}: {out[intent]}, launches {launches[intent]}")
    emit("demo_path", model="ViT-L/14", corpus_images=DEMO_CORPUS, prompts=prompts, **out,
         launches=launches)
    return launches


class FedNeighbours:
    """A Retriever whose searches return given (img_idx, txt_idx): the raw
    check's card and CPU steps take the card's neighbours, so near-ties in
    the bf16 search do not decide it."""

    def __init__(self, db, idx):
        from keds_tpu_torch.retrieval.database import Retriever

        self.retriever = Retriever(db)
        self.db, self.idx = db, idx

    def retrieve_features(self, feature, k=16, generator=None, idx=None, text=True):
        dev = self.db.image_db.device
        return self.retriever.retrieve_features(
            feature, k, generator, (self.idx[0].to(dev), self.idx[1].to(dev)), text)


def raw_batches(f, dev, rng_seed: int = 0, batch: int = 0, workers: int = 8):
    """RawBatch stream of the tar shards (batches of ``batch``, by default
    TRAIN_BATCH): TarShardDataset with the train crop's PIL decode (uint8,
    normalised on the card), the caption map's captions tokenized and
    bucketed."""
    import random

    from keds_tpu_torch.data.tarstream import TarShardDataset, load_caption_map, pil_jpeg_decoder
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.tokenizer import bucket_text, tokenize
    from keds_tpu_torch.train.losses import RawBatch

    ds = TarShardDataset(f.shards, batch_size=batch or TRAIN_BATCH,
                         decode_image=pil_jpeg_decoder(VIT_L_14.image_resolution, is_train=True,
                                                       normalize=False,
                                                       rng=random.Random(rng_seed)),
                         caption_map=load_caption_map(str(f.captions)), tokenize=tokenize,
                         seed=rng_seed, train_num_samples=RAW_SHARDS * RAW_PER_SHARD,
                         workers=workers)
    try:
        for images, caps in ds:
            yield RawBatch(torch.as_tensor(images, device=dev),
                           torch.as_tensor(bucket_text(caps, n_pseudo=1), device=dev))
    finally:
        ds.close()


def raw_train_path(f, clip_params, heads, db, kernels) -> tuple:
    """Image-stream training on raw images: the tar shards decoded on 8
    threads while the card steps, B=128, 2 warm-up and 10 timed steps
    through train_epoch (launch counts zeroed just before, read just
    after), per-stage ms of a further batch."""
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.train.trainer import train_epoch

    dev = db.image_db.device
    theads, opt, sched, step = _train_setup(clip_params, heads, db, dev)
    losses = []

    def recorded(h, b, t):
        loss = step(h, b, t)
        losses.append(loss)
        return loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stream = raw_batches(f, dev)
    t = time.perf_counter()
    for s in range(2):                      # warm-up steps t = 0, 1 (the buffer fills)
        recorded(theads, next(stream), s)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    for k in kernels.values():
        k.reset()
    t0 = time.perf_counter()
    train_epoch(recorded, theads, stream, 1, 10, log_every=10, schedule=sched)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {name: dict(k.launches) for name, k in kernels.items()}
    # B1 twice a step (both modalities), B2 in the frozen image tower and the
    # prompt's text tower, B2' in every text layer's backward
    check_path_launches("raw train", launches, {
        ("mips_topk", "bf16_tc"): 20, ("mips_topk", "f32"): 0,
        ("attention_bwd", "bf16"): 10 * VIT_L_14.transformer_layers,
        ("attention", "f32"): 0, ("attention_bwd", "f32"): 0}, [("attention", "bf16_tc")])
    loss_vals = [float(x) for x in losses]
    if not (len(loss_vals) == 12 and np.isfinite(loss_vals).all()):
        raise AssertionError(f"raw train losses: {loss_vals}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batch = next(raw_batches(f, dev, rng_seed=1))
    runs = [train_stage_times(step, theads, batch, t) for t in (20, 21, 22)]
    stages = {name: float(np.median([r[name] for r in runs])) for name in runs[0]}
    emit("raw_train_path", model="ViT-L/14", db_rows=db.size, batch=TRAIN_BATCH, dtype="bf16",
         shards=RAW_SHARDS, per_shard=RAW_PER_SHARD, decode_threads=8, warm_up_s=warm_s,
         timed_steps=10, step_ms=elapsed / 10 * 1e3, samples_per_s=TRAIN_BATCH * 10 / elapsed,
         stage_ms_one_step=stages, stage_ms_runs=runs, peak_mem_gb=peak_gb,
         caption_bucket=int(batch.caption_tokens.shape[1]), losses=loss_vals,
         launches=launches)
    return theads, step, batch, launches


def profile_train_raw(step, theads, batch) -> None:
    profile_device("profile_train_raw", lambda: step(theads, batch, 23),
                   [("attention backward (B2')", ("attention_bwd",)),
                    ("attention forward (B2)", ("attention_tc", "attention_f32")),
                    ("mips_topk (B1)", ("topk_",))])


def raw_reading(clip_params, heads, db, dtype, batch, idx) -> tuple:
    """(loss, flattened f64 head gradient) of one image-stream step on
    ``db``'s device in ``dtype``, dropout 0, the neighbours ``idx`` fed;
    ``batch`` a RawBatch (encoded in the step) or a TrainBatch of features."""
    from keds_tpu_torch.models.convert import head_parameters

    dev = db.image_db.device
    theads, _, _, step = _train_setup(clip_params, heads, db, dev, dropout=0.0, dtype=dtype,
                                      retriever=FedNeighbours(db, idx))
    batch = type(batch)(*(None if t is None else t.to(dev) for t in batch))
    loss = float(step(theads, batch, 0))
    return loss, torch.cat([p.grad.flatten().double().cpu() for _, _, p in head_parameters(theads)])


def raw_train_check(f, clip_params, heads, db, cpu_clip, cpu_heads, cpu_db) -> None:
    """The raw step on the card in bf16 against the CPU in f32, in two
    gates.  The frozen encode: the card's bf16 image features of
    RAW_CHECK_BATCH train-cropped images against the CPU's f32 ones (cosine
    >= COSINE_MIN, e2e_check's limit).  The step: the card's whole bf16
    raw step (its own encode included) against the CPU's f32 step on the
    card's features, the same weights and the card's neighbours
    (train_check's limits).  The CPU step takes the card's features
    because random ViT-L/14 weights map every image to nearly the same
    feature (cosine about 0.996 between two images), so bf16 rounding in
    the encode, about 1 % of a feature, is a large share of what tells the
    images apart and turns the InfoNCE gradient by itself: the CPU's own
    bf16 step reads a gradient cosine of 0.82-0.92 against its f32 step,
    and the card's f32 raw step reads 1.0000 (``kernel_sweeps.py
    raw_check_controls``)."""
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.retrieval.database import Retriever
    from keds_tpu_torch.train.losses import TrainBatch, encode_raw_batch
    from keds_tpu_torch.train.trainer import frozen_clip

    t = time.perf_counter()
    batch = next(raw_batches(f, DEV, rng_seed=2, batch=RAW_CHECK_BATCH, workers=0))
    feats = {}
    for dev, dtype, clip in ((DEV, torch.bfloat16, clip_params), ("cpu", torch.float32, cpu_clip)):
        raw = type(batch)(*(x.to(dev) for x in batch))
        feats[dev] = encode_raw_batch(frozen_clip(clip, dtype, torch.device(dev)), VIT_L_14,
                                      raw, captions=False).image_features.cpu()
    a, b = feats[DEV].double(), feats["cpu"].double()
    cos = ((a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))).tolist()
    idx = Retriever(db).neighbour_indices(feats[DEV].to(DEV), 16)
    r = compare_readings(raw_reading(clip_params, heads, db, torch.bfloat16, batch, idx),
                         raw_reading(cpu_clip, cpu_heads, cpu_db, torch.float32,
                                     TrainBatch(feats[DEV], None), idx))
    emit("raw_train_check", encode_cosine=cos, encode_cosine_min=COSINE_MIN, **r,
         batch=RAW_CHECK_BATCH, seconds=time.perf_counter() - t)
    if not (min(cos) >= COSINE_MIN and r["passes"]):
        raise AssertionError(f"raw train step card vs CPU: encode cosine {cos}, loss rel diff "
                             f"{r['loss_rel_diff']}, grad cosine {r['head_grad_cosine']}")


def raw_cli_runs(f) -> None:
    """The train CLI on raw images on the card: webdataset through
    ``python -m keds_tpu_torch.cli.main`` and csv in this process, each one
    epoch of 2 steps of 8 over a 1000-row DB, then --resume auto to a
    second epoch; checkpoints in the reference layout, scalars.jsonl, and
    the resume logged."""
    import os

    from keds_tpu_torch.cli.main import main as train_main
    from keds_tpu_torch.io.checkpoint import load_checkpoint

    modes = {"webdataset": ["--train-data", "::".join(f.shards[:2]), "--dataset-type",
                            "webdataset", "--caption-map", str(f.captions),
                            "--train-num-samples", str(CLI_ROWS)],
             "csv": ["--train-data", str(f.train_csv), "--dataset-type", "csv"]}
    keys = {"epoch", "name", "state_dict", "state_dict_img2text", "state_dict_retrieval_fuse",
            "state_dict_text_condition", "optimizer"}
    out = {}
    for mode, data in modes.items():
        t = time.perf_counter()
        base = [*data, "--clip-weights", str(f.mlp), "--database-path", str(f.tiny_db),
                "--batch-size", "8", "--workers", "4", "--warmup", "2",
                "--logs", str(f.root / "logs"), "--name", f"cli_{mode}"]
        for epochs, extra in ((1, []), (2, ["--resume", "auto"])):
            args = base + ["--epochs", str(epochs), *extra]
            if mode == "webdataset":
                subprocess.run([sys.executable, "-m", "keds_tpu_torch.cli.main", *args],
                               check=True, timeout=600, cwd=pathlib.Path(__file__).parent,
                               env=dict(os.environ), stdout=sys.stderr)
            else:
                train_main(args)
        run = f.root / "logs" / f"cli_{mode}"
        ck = [load_checkpoint(str(run / "checkpoints" / f"epoch_{e}.pt")) for e in (1, 2)]
        scalars = [json.loads(x) for x in (run / "scalars.jsonl").read_text().splitlines()]
        log = (run / "out.log").read_text()
        ok = (all(set(c) == keys for c in ck) and [c["epoch"] for c in ck] == [1, 2]
              and bool(ck[1]["optimizer"].get("state")) and len(scalars) == 2
              and all(np.isfinite(s["train/loss"]) for s in scalars) and "resumed from" in log)
        out[mode] = dict(seconds=time.perf_counter() - t, steps=[s["step"] for s in scalars],
                         losses=[s["train/loss"] for s in scalars], passes=ok)
        del ck
        if not ok:
            raise AssertionError(f"train CLI {mode}: {out[mode]}")
    emit("raw_train_cli", **out)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from keds_tpu_torch import synth
    from keds_tpu_torch.engine import ComposedQueryEngine
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.models.convert import cast_floating
    from keds_tpu_torch.ops import attention as att_mod, topk as topk_mod
    from keds_tpu_torch.ops.cuda_build import build_all
    from keds_tpu_torch.retrieval.database import KnowledgeDB

    kernels = {"attention": att_mod.KERNEL, "attention_bwd": att_mod.BWD_KERNEL,
               "mips_topk": topk_mod.KERNEL}
    card = nvidia_smi()
    t = time.perf_counter()
    build_all(kernels.values())
    ptxas = [ln.strip() for k in kernels.values() for ln in k.build_log.splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    emit("build", build_s=time.perf_counter() - t, card=card,
         torch=torch.__version__, cuda=torch.version.cuda, ptxas=ptxas)

    bf16, f32 = torch.bfloat16, torch.float32
    att_rows = check_attention([(16, 16, 257, 64, bf16, False),    # vision chunk
                                (64, 12, 32, 64, bf16, True),      # text, S=32 bucket
                                (2, 4, 77, 64, f32, True),
                                (2 * TRAIN_BATCH, 12, 32, 64, bf16, True)])  # text stream
    bwd_rows = check_attention_bwd([(TRAIN_BATCH, 12, 8, 64, bf16, True),   # train prompt
                                    (64, 12, 16, 64, bf16, True),    # text buckets
                                    (64, 12, 32, 64, bf16, True),
                                    (64, 12, 77, 64, bf16, True),
                                    (2, 4, 77, 64, f32, True),
                                    (2 * TRAIN_BATCH, 12, 32, 64, bf16, True)])
    topk_rows = check_topk([(256, DB_ROWS, 768, 16, bf16),
                            (QUERY_BATCH, DB_ROWS, 768, 16, bf16),   # retrieval
                            (TRAIN_BATCH, DB_ROWS, 768, 16, bf16),   # train-step search
                            (QUERY_BATCH, 10_000, 768, 10, f32),
                            (QUERY_BATCH, N_CORPUS, 768, 10, f32),   # ranking
                            (TRAIN_BATCH, DB_ROWS, 768, 2, bf16),    # caption neighbours
                            (EVAL_QUERIES, EVAL_CORPUS, 768, 101, f32),   # CIRR ranking
                            (2048, 4096, 768, 100, f32),             # Fashion-IQ-like
                            (1024, 10_000, 768, 200, f32),           # ImageNet-like
                            (QUERY_BATCH, DB_ROWS, 768, 64, bf16),   # --db-topk 64
                            (QUERY_BATCH, 10_000, 768, 300, f32),    # k > 256: passes
                            (QUERY_BATCH, DB_ROWS, 768, 300, bf16),
                            (8, 1000, 768, 1000, f32),               # k = N
                            (QUERY_BATCH, SERVE_CORPUS, 768, SERVE_WIDE_TOPN, f32)])  # serve

    # --- main path ---------------------------------------------------------
    t = time.perf_counter()
    clip_params, heads, db = synth.build(VIT_L_14, db_rows=DB_ROWS, dtype=bf16, seed=0)
    engine = ComposedQueryEngine(clip_params, VIT_L_14, heads, db, split_id=SPLIT_ID)
    torch.cuda.synchronize()
    build_model_s = time.perf_counter() - t
    rng = np.random.default_rng(0)
    corpus_batches = [rng.integers(0, 256, (QUERY_BATCH, 224, 224, 3), dtype=np.uint8)
                      for _ in range(N_CORPUS // QUERY_BATCH)]
    q_images = [rng.integers(0, 256, (QUERY_BATCH, 224, 224, 3), dtype=np.uint8)
                for _ in range(N_QUERY_BATCHES)]
    q_texts = [prompt_batch(rng, QUERY_BATCH) for _ in range(N_QUERY_BATCHES)]
    engine.compose_batch(q_images[0], q_texts[0])          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for k in kernels.values():
        k.reset()
    t0 = time.perf_counter()
    corpus = engine.encode_corpus(corpus_batches)
    t1 = time.perf_counter()
    dcorpus = engine.corpus_to_device(corpus)
    t2 = time.perf_counter()
    scores, idx = engine.search(q_images, q_texts, dcorpus, topn=10)
    t3 = time.perf_counter()
    launches = {name: dict(k.launches) for name, k in kernels.items()}
    # bf16 serving runs both tensor-core kernels and the f32 ranking; no
    # CUDA-core attention is left on it
    missing = [f"{n}/{v}" for n, v in (("attention", "bf16_tc"), ("mips_topk", "bf16_tc"),
                                       ("mips_topk", "f32")) if launches[n][v] == 0]
    # serving saves nothing for a backward and launches none
    if missing or launches["attention"]["f32"] or any(launches["attention_bwd"].values()):
        raise AssertionError(f"main path launches {launches}: missing {missing}")
    n_q = QUERY_BATCH * N_QUERY_BATCHES
    if scores.shape != (n_q, 10) or idx.shape != (n_q, 10):
        raise AssertionError(f"search shapes {scores.shape} {idx.shape}")
    if not (np.isfinite(scores).all() and np.isfinite(corpus).all()):
        raise AssertionError("non-finite corpus features or scores")
    if not ((idx >= 0) & (idx < N_CORPUS)).all() or (np.diff(scores, axis=1) > 1e-6).any():
        raise AssertionError("ranked indices out of range or scores not descending")
    if not np.allclose(np.linalg.norm(corpus, axis=1), 1.0, atol=1e-2):
        raise AssertionError("corpus features not unit-norm")
    runs = [stage_times(engine, q_images[0], q_texts[0], dcorpus) for _ in range(3)]
    stages = {name: float(np.median([r[name] for r in runs])) for name in runs[0]}
    emit("main_path", model="ViT-L/14", db_rows=DB_ROWS, dtype="bf16",
         corpus_images=N_CORPUS, queries=n_q, query_batch=QUERY_BATCH,
         build_model_s=build_model_s, encode_corpus_s=t1 - t0,
         corpus_images_per_s=N_CORPUS / (t1 - t0), search_s=t3 - t2,
         queries_per_s=n_q / (t3 - t2), stage_ms_one_batch=stages,
         stage_ms_runs=runs, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=launches)
    profile_batch(engine, q_images[1], q_texts[1], dcorpus)

    # --- end-to-end check against the CPU in f32 ----------------------------
    t = time.perf_counter()
    gpu = engine.compose([q_images[0][:2]], [q_texts[0][:2]])
    cpu_db = KnowledgeDB(db.image_db.cpu().float(), db.text_db.cpu().float(), db.names)
    cpu_clip, cpu_heads = cast_floating(clip_params, f32, "cpu"), cast_floating(heads, f32, "cpu")
    cpu_engine = ComposedQueryEngine(cpu_clip, VIT_L_14, cpu_heads, cpu_db,
                                     split_id=SPLIT_ID, compute_dtype=f32, device="cpu")
    cpu = cpu_engine.compose([q_images[0][:2]], [q_texts[0][:2]])
    cos = (gpu * cpu).sum(1) / (np.linalg.norm(gpu, axis=1) * np.linalg.norm(cpu, axis=1))
    emit("e2e_check", cosine=cos.tolist(), min_cosine=float(cos.min()),
         threshold=COSINE_MIN, seconds=time.perf_counter() - t)
    if not (np.isfinite(cos).all() and cos.min() >= COSINE_MIN):
        raise AssertionError(f"card bf16 vs CPU f32 cosine {cos} < {COSINE_MIN}")

    # --- training path ------------------------------------------------------
    del engine, cpu_engine
    torch.cuda.empty_cache()
    theads, opt, step, batch, train_launches = train_path(clip_params, heads, db, kernels)
    profile_train(step, theads, batch)
    del theads, opt, step, batch
    train_check(clip_params, heads, db, cpu_clip, cpu_heads, cpu_db)

    # --- text-stream training path -----------------------------------------
    table = text_templates(np.random.default_rng(7), DB_ROWS, 2)   # "a photo of * * {other}"
    theads, step, batch, text_launches = train_text_path(clip_params, heads, db, kernels,
                                                         table)
    profile_train_text(step, theads, batch)
    del theads, step, batch
    torch.cuda.empty_cache()
    train_text_check(clip_params, heads, db, cpu_clip, cpu_heads, cpu_db, table, kernels)
    del table
    torch.cuda.empty_cache()

    # --- evaluation path ------------------------------------------------------
    build = pathlib.Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        split, profile, corpus_dev, eval_launches = eval_path(clip_params, db, kernels,
                                                              pathlib.Path(d))
        profile_eval(split, profile, corpus_dev)
    del split, profile, corpus_dev
    torch.cuda.empty_cache()

    # --- the serve and demo CLIs and raw-image training -----------------------
    with tempfile.TemporaryDirectory(dir=build) as d:
        files = write_smoke_files(pathlib.Path(d), clip_params, heads, db)
        emit("smoke_files", seconds=files.seconds, corpus_jpegs=SERVE_CORPUS,
             shards=len(files.shards), vocab="synthetic merges, '*' = 265")
        serve_launches = serve_path(files, kernels)
        demo_launches = demo_path(files, kernels)
        theads, step, batch, raw_launches = raw_train_path(files, clip_params, heads, db,
                                                           kernels)
        profile_train_raw(step, theads, batch)
        del theads, step, batch
        torch.cuda.empty_cache()
        raw_train_check(files, clip_params, heads, db, cpu_clip, cpu_heads, cpu_db)
        del cpu_clip, cpu_heads, cpu_db
        raw_cli_runs(files)

    att = ("attention", "keds_tpu_torch/csrc/attention.cu", "keds_tpu/ops/attention.py:122")
    bwd = ("attention_bwd", "keds_tpu_torch/csrc/attention_bwd.cu",
           "keds_tpu/ops/attention.py:134")
    top = ("mips_topk", "keds_tpu_torch/csrc/topk.cu", "keds_tpu/ops/pallas_topk.py:93")
    # launches: the serving main path's, the image-stream training path's for
    # the backward, the evaluation path's for the f32 ranking at k = 101 and
    # the serve CLI's --topn 300 run for the passes; each path's beside them
    entries = [(att, "bf16_tc", att_rows[0], launches), (att, "f32", att_rows[2], launches),
               (bwd, "bf16", bwd_rows[0], train_launches),
               (bwd, "f32", bwd_rows[4], train_launches),
               (top, "bf16_tc", topk_rows[1], launches),
               (top, "f32", topk_rows[6], eval_launches),
               (top, "bf16", topk_rows[9], launches),
               (top, "f32_multi", topk_rows[13], serve_launches["serve_topn300"]),
               (top, "bf16_multi", topk_rows[11], serve_launches["serve_topn300"])]
    paths = {"serving": launches, "train_image": train_launches, "train_text": text_launches,
             "eval": eval_launches, "serve_cli": serve_launches["serve"],
             "serve_cli_topn300": serve_launches["serve_topn300"],
             "demo_mlp": demo_launches["mlp"], "demo_crossformer": demo_launches["crossformer"],
             "train_raw": raw_launches}
    print(json.dumps({"kernels": [
        {"name": f"{name}/{variant}", "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name][variant], "max_abs_err": row["max_abs_err"],
         "ms": row["kernel_ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": row["library_ms"],
         "shape": row["shape"], "dtype": row["dtype"],
         "launches_by_path": {p: c[name][variant] for p, c in paths.items()}}
        for (name, src, rep), variant, row, counts in entries]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
