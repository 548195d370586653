#!/usr/bin/env python3
"""Smoke run of the keds_tpu_torch serving and training paths on one CUDA
card.

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
12. the kernels line (launches of each path beside each variant), then the
    card's name and power limit from nvidia-smi, then the result line.
"""

from __future__ import annotations

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
    from keds_tpu_torch.ops.topk import KERNEL, mips_topk, mips_topk_plain

    rows = []
    for B, N, D, k, dtype in cases:
        variant = VARIANT[dtype]
        launches0 = KERNEL.launches[variant]
        db = _unit_rows(N, D, dtype, seed=N)
        q = _unit_rows(B, D, dtype, seed=B + 1)
        vals, idx = mips_topk(q, db, k)
        pv, pi = mips_topk_plain(q, db, k + 1)
        torch.cuda.synchronize()
        err = (vals - pv[:, :k]).abs().max().item()
        if not err <= TOPK_TOL:
            raise AssertionError(f"mips_topk {B, N, D, k} {dtype}: max_abs_err {err}")
        # an index must match wherever its plain score is separated from both
        # neighbours (the (k+1)-th included) by more than the value tolerance
        gaps = (pv[:, :-1] - pv[:, 1:]).abs()
        sep = gaps[:, :k] > TOPK_TOL
        sep[:, 1:] &= gaps[:, :k - 1] > TOPK_TOL
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
                 total_steps=20, stream="image", db_other_tokens=None):
    """f32 trainable copies of the heads, their optimizer and the train step.
    The copies are new tensors even where ``heads`` are f32 on ``device``
    already (the CPU's), which the step would otherwise train in place."""
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.models.convert import cast_floating
    from keds_tpu_torch.retrieval.database import Retriever
    from keds_tpu_torch.train.trainer import make_optimizer, make_train_step

    theads = cast_floating(copy.deepcopy(heads), torch.float32, device)
    opt, sched = make_optimizer(TRAIN_OPT, total_steps, theads)
    step = make_train_step(clip_params, VIT_L_14, Retriever(db), opt, sched,
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
                            (TRAIN_BATCH, DB_ROWS, 768, 2, bf16)])   # caption neighbours

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

    att = ("attention", "keds_tpu_torch/csrc/attention.cu", "keds_tpu/ops/attention.py:122")
    bwd = ("attention_bwd", "keds_tpu_torch/csrc/attention_bwd.cu",
           "keds_tpu/ops/attention.py:134")
    top = ("mips_topk", "keds_tpu_torch/csrc/topk.cu", "keds_tpu/ops/pallas_topk.py:93")
    # launches: the serving main path's, and the image-stream training path's
    # for the backward; each path's beside them
    entries = [(att, "bf16_tc", att_rows[0], launches), (att, "f32", att_rows[2], launches),
               (bwd, "bf16", bwd_rows[0], train_launches),
               (bwd, "f32", bwd_rows[4], train_launches),
               (top, "bf16_tc", topk_rows[1], launches), (top, "f32", topk_rows[4], launches)]
    paths = {"serving": launches, "train_image": train_launches, "train_text": text_launches}
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
