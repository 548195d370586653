#!/usr/bin/env python3
"""Smoke run of the keds_tpu_torch serving path on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. build   nvcc-builds every kernel of ``keds_tpu_torch/csrc`` (sm_90a) and
           prints ptxas' registers and spills.
2. attention / 3. mips_topk
           each kernel variant at the shapes the serving path gives it, held
           against its plain PyTorch version on the same inputs, with times
           of the kernel, the plain version and one library call (SDPA;
           matmul + topk), and the bound: the larger of bytes over 3.35 TB/s
           and flops over the dtype's peak (989 TFLOP/s bf16, 67 TFLOP/s f32;
           H100 SXM data sheet).  Times are device times: CUDA-graph replays
           of 20 calls.  (Design sweeps of the kernels are in
           ``kernel_sweeps.py``.)
4. main_path
           ViT-L/14 + heads (random weights from a seed) and a 0.5M x 768 bf16
           knowledge DB made on the card; ComposedQueryEngine encodes a corpus
           and answers batches of 64 composed queries ranked against it.
           Kernel launch counts are zeroed just before and read just after;
           per-stage times of one batch are the median of three.
5. profile torch.profiler over one query batch: device time by kernel, the
           top kernels, and their sums for GEMMs, the two fused kernels and
           the rest.
6. e2e_check
           two queries through the same weights on the CPU in f32; cosine of
           the composed features against the card's bf16 output.
7. the kernels line, then the card's name and power limit from nvidia-smi,
   then the result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
ATT_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}   # output-dtype rounding
TOPK_TOL = 1e-4        # f32 sums of 768 products in another order
COSINE_MIN = 0.995
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


def _qkv(B, H, S, Dh, dtype):
    """Strided q/k/v views of one (B, S, 3, H, Dh) buffer, as the towers pass them."""
    gen = torch.Generator(device="cuda").manual_seed(S)
    qkv = torch.randn((B, S, 3, H, Dh), generator=gen, device="cuda").to(dtype)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


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


def stage_times(engine, images_u8: np.ndarray, text: np.ndarray, corpus) -> dict:
    """Per-stage ms of one query batch (synchronised after each stage)."""
    from keds_tpu_torch.models import clip as mclip
    from keds_tpu_torch.models.composition import compose_pseudo_tokens
    from keds_tpu_torch.tokenizer import bucket_text

    out = {}

    def run(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t) * 1e3
        return r

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


def profile_batch(engine, images_u8: np.ndarray, text: np.ndarray, corpus) -> None:
    """Device time of one query batch by kernel (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            f, _ = engine.compose_batch(images_u8, text)
            engine.rank(f, corpus, 10)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # kernels and copies only: a CPU op's self device time repeats its kernels'
    ops = sorted(((e.key, device_us(e) / 1e3, e.count) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and device_us(e) > 0),
                 key=lambda r: -r[1])
    total = sum(ms for _, ms, _ in ops)
    if total == 0:
        emit("profile", device_ms=0.0, wall_ms=wall_ms,
             note="key_averages() shows no device time on this machine")
        return
    groups = {"gemm": 0.0, "attention (B2)": 0.0, "mips_topk (B1)": 0.0, "other": 0.0}
    for name, ms, _ in ops:
        low = name.lower()
        if "attention_tc" in low or "attention_f32" in low:
            groups["attention (B2)"] += ms
        elif "topk_" in low:
            groups["mips_topk (B1)"] += ms
        elif any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet", "cublas", "sm90")):
            groups["gemm"] += ms
        else:
            groups["other"] += ms
    emit("profile", device_ms=total, wall_ms_profiled=wall_ms,
         device_busy_share_profiled=total / wall_ms, groups_ms=groups,
         top=[dict(name=n[:90], ms=ms, count=c, share=ms / total) for n, ms, c in ops[:15]])


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

    kernels = {"attention": att_mod.KERNEL, "mips_topk": topk_mod.KERNEL}
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
                                (2, 4, 77, 64, f32, True)])
    topk_rows = check_topk([(256, DB_ROWS, 768, 16, bf16),
                            (QUERY_BATCH, DB_ROWS, 768, 16, bf16),   # retrieval
                            (QUERY_BATCH, 10_000, 768, 10, f32),
                            (QUERY_BATCH, N_CORPUS, 768, 10, f32)])  # ranking

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
    if missing or launches["attention"]["f32"]:
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
    cpu_engine = ComposedQueryEngine(cast_floating(clip_params, f32, "cpu"), VIT_L_14,
                                     cast_floating(heads, f32, "cpu"), cpu_db,
                                     split_id=SPLIT_ID, compute_dtype=f32, device="cpu")
    cpu = cpu_engine.compose([q_images[0][:2]], [q_texts[0][:2]])
    cos = (gpu * cpu).sum(1) / (np.linalg.norm(gpu, axis=1) * np.linalg.norm(cpu, axis=1))
    emit("e2e_check", cosine=cos.tolist(), min_cosine=float(cos.min()),
         threshold=COSINE_MIN, seconds=time.perf_counter() - t)
    if not (np.isfinite(cos).all() and cos.min() >= COSINE_MIN):
        raise AssertionError(f"card bf16 vs CPU f32 cosine {cos} < {COSINE_MIN}")

    att = ("attention", "keds_tpu_torch/csrc/attention.cu", "keds_tpu/ops/attention.py:122")
    top = ("mips_topk", "keds_tpu_torch/csrc/topk.cu", "keds_tpu/ops/pallas_topk.py:93")
    entries = [(att, "bf16_tc", att_rows[0]), (att, "f32", att_rows[2]),
               (top, "bf16_tc", topk_rows[1]), (top, "f32", topk_rows[3])]
    print(json.dumps({"kernels": [
        {"name": f"{name}/{variant}", "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name][variant], "max_abs_err": row["max_abs_err"],
         "ms": row["kernel_ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": row["library_ms"],
         "shape": row["shape"], "dtype": row["dtype"]}
        for (name, src, rep), variant, row in entries]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
