"""The port's benchmark entry (counterpart of ``bench.py``): prints ONE JSON
line on stdout with ``bench.py``'s keys; everything else goes to stderr.

Headline: **composed queries / s / card** on the flagship pipeline, CLIP
ViT-L/14 in bf16 (``models.clip.VIT_L_14`` read at call time) with random
weights from seed 0 (``graft_entry_torch._build``): image encode -> top-16
retrieval from each modality of a 0.5M x 768 knowledge DB (B1) -> IM2TEXT
and the two CrossFormers -> three pseudo-tokens spliced in at ``*`` ->
causal text tower (B2 in every block) -> unit rows.  A 256-query macro
batch runs as two steps, the encode in chunks of 16 images and then the
retrieval, fusion and text tower, the features staying on the card; the
pipelined batches are launched back to back and each one scalar is read
at the end.

    python3 bench_torch.py [--quick] [--stages] [--u8] [--quant int8]
                           [--retrieval xla|approx|int8|pallas]
    python3 bench_torch.py --latency      # b1 / b32 / b{batch} latency curve
    python3 bench_torch.py --train [--stream text] [--raw | --neighbors] [--scan]
    ... --device cpu                      # the plain versions on the CPU (tests)

Modes and what they launch (ops/topk.py B1, ops/attention.py B2 and B2'):

* headline: B1 twice a batch at (batch, db rows, 768) bf16, k=16 (``int8``:
  ``mips_topk_int8``, no B1); B2 in each vision block over 16-image chunks
  and in each text block.  ``--stages`` adds the encode rate and one
  modality's search, B1 beside ``torch.mm`` + ``torch.topk``, on stderr.
* ``--latency``: at b in {1, 32, batch}, with reps = max(8, min(64, 512 // b)):
  ``two_prog_chained_ms``, one synchronise per request of the two steps;
  ``fused_chained_ms``, the whole step as one function chained through its
  images (a data dependency) with one synchronise at the end;
  ``fused_device_ms``, ``reps`` steps captured in one CUDA graph and
  replayed (``chip_smoke.time_ms``), so the host is out of the window (on
  the CPU: a host clock around ``reps`` chained steps).
* ``--train``: the port's train step (``train/trainer.py``) with
  ``bench.py``'s AdamW (lr 1e-4, betas 0.9 / 0.98, eps 1e-6, wd 0.1, 10 000
  warm-up steps of 600 000), heads in f32, bf16 compute, batch 128: B1 at
  k=16 (and k=2 for the text stream's captions; none under
  ``--neighbors``), B2 and B2' in every text block, B2 in every vision
  block under ``--raw``.  Chained steps with one synchronise at the end.
  ``--scan`` (implied by ``--neighbors``): 8 batches rolled along axis 0,
  stepped in turn at step indices 0-7 as 8 eager launches of the step
  (not a CUDA graph: the AdamW step reads its count on the host), one
  synchronise per 8 steps, ``max(iters // 4, 3)`` such chains; the rate is
  per step.

Inputs are drawn from ``np.random.default_rng(0)`` in ``bench.py``'s order,
so they equal its arrays bit for bit.  On the card a kernel that fails to
build or launch raises; nothing falls back to a plain version.

``vs_baseline`` keeps ``bench.py``'s fixed analytic estimate of the
reference PyTorch + Faiss pipeline on one A100 (the reference publishes no
numbers), so the ratio means the same in both harnesses:

  per batch of 64 composed queries on A100 (fp16):
    ViT-L/14 encode  ~162 GFLOP/img -> 312 TFLOPS @ 40% MFU  ~ 83 ms
    faiss L2 scan    2 x (64 x 0.5M x 768) w/ GPU<->CPU hop   ~ 10 ms
    fusion + text tower + host glue                           ~ 10 ms
  => ~64 / 0.103 s  ~ 620 q/s theoretical; with the reference's per-step
     host round-trips and unpipelined eval loop, ~400 q/s is a generous
     realistic figure.  A100_BASELINE_QPS = 400.

Imports torch, numpy, the standard library, keds_tpu_torch and
graft_entry_torch.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

import graft_entry_torch as ge
from keds_tpu_torch import tokenizer
from keds_tpu_torch.config import Config
from keds_tpu_torch.models import clip as mclip
from keds_tpu_torch.models.composition import compose_pseudo_tokens
from keds_tpu_torch.models.convert import cast_floating
from keds_tpu_torch.ops import attention as att_mod, topk as topk_mod
from keds_tpu_torch.ops.cuda_build import build_all
from keds_tpu_torch.ops.quant import maybe_quantize_clip
from keds_tpu_torch.ops.topk import mips_topk
from keds_tpu_torch.retrieval.database import Retriever
from keds_tpu_torch.runtime import resolve_device
from keds_tpu_torch.train import trainer
from keds_tpu_torch.train.losses import RawBatch, TrainBatch

A100_BASELINE_QPS = 400.0
# Analytic A100 training baselines (fixed, bench.py's): features mode ~2000/s
# (faiss round-trip + heads fwd/bwd + text tower); raw mode adds the frozen
# ViT-L encode -- fp16 encode ~166 ms/b128 at 40% MFU + faiss 10 ms + step
# ~64 ms + host glue ~20 ms -> ~260 ms -> ~490/s.  Text stream, from the same
# per-component numbers (text tower fwd/bwd ~37 ms/b128 fp16): image step
# 64 ms + two extra tower passes 74 ms + top-2 faiss search ~5 ms + per-step
# host tokenization of 2x128 neighbour templates (~15 ms) -> ~158 ms/b128
# -> ~810/s.
A100_TRAIN_BASE = {"image": 2000.0, "text": 810.0, "raw": 490.0}
SPLIT_ID = ge.SPLIT_ID    # '*' in the CLIP BPE vocab
DB_TOPK = 16


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(state) -> float:
    """Wait for ``state`` by reading one scalar of it (its last item when a
    tuple) on the host."""
    t = state[-1] if isinstance(state, tuple) else state
    return float(t.reshape(-1)[0])


def timeit_chain(step, state, iters: int, warmup: int = 2) -> float:
    """Seconds a step of ``state -> step(state) -> ...``: each step depends
    on the last, one synchronise at the end (latency)."""
    for _ in range(warmup):
        state = step(state)
    _sync(state)
    t0 = time.perf_counter()
    for _ in range(iters):
        state = step(state)
    _sync(state)
    return (time.perf_counter() - t0) / iters


def timeit_pipelined(step, inputs: list, warmup: int = 2) -> float:
    """Seconds an input: ``step(x)`` (a scalar tensor) launched for every
    input back to back, then every scalar read (throughput)."""
    for x in inputs[:warmup]:
        _sync(step(x))
    t0 = time.perf_counter()
    outs = [step(x) for x in inputs]
    for o in outs:
        _sync(o)
    return (time.perf_counter() - t0) / len(inputs)


def device_ms(fn, calls: int, dev: torch.device) -> float:
    """ms of one ``fn()`` with the host out of the window: on the card
    ``calls`` calls captured in a CUDA graph and replayed
    (``chip_smoke.time_ms``); on the CPU a host clock around ``calls``
    calls."""
    if dev.type == "cuda":
        from chip_smoke import time_ms

        return time_ms(fn, iters=calls)
    fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e3


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="The port's benchmark entry: one JSON line.")
    p.add_argument("--quick", action="store_true", help="small DB / few iters")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--db-rows", type=int, default=None)
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--stages", action="store_true",
                   help="also time the encode and one modality's search (stderr)")
    p.add_argument("--train", action="store_true",
                   help="measure the training step instead (image stream, "
                        "precomputed features, the reference recipe's batch)")
    p.add_argument("--raw", action="store_true",
                   help="with --train: feed raw uint8 images, encoded by the "
                        "frozen CLIP inside the step")
    p.add_argument("--stream", choices=["image", "text"], default="image",
                   help="with --train: which stream's step to measure (text "
                        "adds the top-2 caption search and the neighbour-"
                        "template loss terms)")
    p.add_argument("--quant", choices=["none", "int8"], default="none",
                   help="W8A8-quantize the tower GEMMs (serving)")
    p.add_argument("--retrieval", choices=["xla", "approx", "int8", "pallas"],
                   default="xla", help="retrieval backend (xla, approx and pallas "
                                       "run B1; int8 the int8 scan and re-rank)")
    p.add_argument("--encode-chunk", type=int, default=None,
                   help="encode the batch in chunks of this size (default 16 "
                        "where it divides a larger batch; 0 turns chunking off)")
    p.add_argument("--neighbors", action="store_true",
                   help="train bench: precomputed-neighbour mode, the step "
                        "gathers DB rows by index instead of searching "
                        "(features mode only)")
    p.add_argument("--scan", action="store_true",
                   help="train bench: time 8 varied batches stepped in turn "
                        "with one synchronise per 8 steps; implied by "
                        "--neighbors")
    p.add_argument("--query-tokens", type=int, default=None,
                   help="composed-query caption length in tokens (default 14, "
                        "the S=32 text bucket; 76 the full width)")
    p.add_argument("--u8", action="store_true",
                   help="feed uint8 images, normalised on the device")
    p.add_argument("--latency", action="store_true",
                   help="serving latency curve at b1 / b32 / b{batch} instead "
                        "of the throughput headline")
    p.add_argument("--device", default=None, help="cpu, or the card (default)")
    return p


def rest_body(clip_params: dict, cfg, heads, retriever: Retriever, f: torch.Tensor,
              text: torch.Tensor) -> torch.Tensor:
    """The second serving step: features ``f`` -> top-16 rows of each
    modality -> pseudo-tokens spliced in at ``*`` of ``text`` -> text tower
    -> unit rows."""
    ti, tt = retriever.retrieve_features(f.float(), k=DB_TOPK)
    tok = compose_pseudo_tokens(heads, f, ti.to(f.dtype), tt.to(f.dtype), train=False)
    out = mclip.encode_text_img_retrieval(clip_params, cfg, text, tok, split_id=SPLIT_ID)
    return out / out.norm(dim=-1, keepdim=True)


def composed_step(clip_params: dict, cfg, heads, retriever: Retriever, images: torch.Tensor,
                  text: torch.Tensor, chunk: Optional[int]) -> torch.Tensor:
    """The whole composed query: the encode in ``chunk``-image pieces, then
    :func:`rest_body`."""
    f = mclip.encode_image_chunked(clip_params, cfg, images, chunk)
    return rest_body(clip_params, cfg, heads, retriever, f, text)


def query_text(rng: np.random.Generator, batch: int, n_cap: int) -> np.ndarray:
    """Rows of "a photo of * , {caption}" with an ``n_cap``-token caption
    and EOT after it (at most at 76)."""
    text = np.zeros((batch, 77), np.int32)
    text[:, 0] = 49406
    text[:, 1:4] = [320, 1125, 539]           # "a photo of"
    text[:, 4:6] = [SPLIT_ID, 267]            # "* ,"
    end = min(6 + n_cap, 76)
    text[:, 6:end] = rng.integers(1000, 40000, (batch, end - 6))
    text[:, end] = 49407
    return text


def run(argv: Optional[List[str]] = None, built=None) -> dict:
    """Parse ``argv``, run the mode, print its JSON line on stdout and
    return it.  ``built`` = (clip params, heads, DB) on the device skips
    the build (the weights' dtype and the DB's rows are then the caller's)."""
    args = parser().parse_args(argv)
    if args.train:
        refuse_train_flags(args)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from chip_smoke import nvidia_smi

        t = time.perf_counter()
        build_all([att_mod.KERNEL, att_mod.BWD_KERNEL, topk_mod.KERNEL])
        log(f"bench: card {nvidia_smi()}, torch {torch.__version__}, kernels built or "
            f"loaded in {time.perf_counter() - t:.1f} s")
    with torch.inference_mode(not args.train):
        result = bench_train(args, dev, built) if args.train else bench_serve(args, dev, built)
    print(json.dumps(result), flush=True)
    return result


def bench_serve(args, dev: torch.device, built) -> dict:
    batch = args.batch or 256
    chunk = mclip.DEFAULT_ENCODE_CHUNK
    encode_chunk = args.encode_chunk
    if encode_chunk is None and batch > chunk and batch % chunk == 0:
        encode_chunk = chunk           # the macro schedule; --encode-chunk 0 turns it off
    encode_chunk = encode_chunk or None
    db_rows = args.db_rows or (50_000 if args.quick else 500_000)
    iters = args.iters or (5 if args.quick else 15)
    cfg = mclip.VIT_L_14
    log(f"bench: device={dev} batch={batch} db_rows={db_rows} iters={iters} "
        f"quant={args.quant} u8={args.u8} retrieval={args.retrieval}")
    clip_params, heads, db = built or ge._build(cfg, db_rows, dtype=torch.bfloat16,
                                                device=dev)
    clip_params = maybe_quantize_clip(clip_params, args.quant)
    retriever = Retriever(db, backend=args.retrieval)
    rng = np.random.default_rng(0)
    px = cfg.image_resolution

    def make_images(r: np.random.Generator) -> torch.Tensor:
        if args.u8:
            return torch.from_numpy(r.integers(0, 256, (batch, px, px, 3)).astype(np.uint8)
                                    ).to(dev)
        return torch.from_numpy(r.standard_normal((batch, px, px, 3))).to(
            torch.bfloat16).to(dev)

    images = make_images(rng)
    n_cap = max(args.query_tokens or 14, 1)
    text = torch.as_tensor(tokenizer.bucket_text(query_text(rng, batch, n_cap)), device=dev)
    log(f"query text: caption {n_cap} tokens -> S={text.shape[1]} bucket")

    if args.stages:
        enc_inputs = [make_images(rng) for _ in range(iters)]
        t_enc = timeit_pipelined(
            lambda im: mclip.encode_image_chunked(clip_params, cfg, im, encode_chunk).sum(),
            enc_inputs)
        log(f"stage encode_image: {t_enc * 1e3:.2f} ms/batch ({batch / t_enc:.0f} img/s)")
        del enc_inputs
        q_inputs = [torch.from_numpy(rng.standard_normal((batch, cfg.embed_dim))).to(
            db.image_db.dtype).to(dev) for _ in range(iters)]
        dbi = db.image_db
        t_b1 = timeit_pipelined(lambda q: mips_topk(q, dbi, DB_TOPK)[0].sum(), q_inputs)
        t_lib = timeit_pipelined(
            lambda q: torch.topk(torch.mm(q, dbi.t()).float(), DB_TOPK)[0].sum(), q_inputs)
        log(f"stage retrieval (1 modality, {db.size} rows, k={DB_TOPK}): B1 "
            f"{t_b1 * 1e3:.3f} ms, torch.mm + torch.topk {t_lib * 1e3:.3f} ms")
        del q_inputs

    if args.latency:
        curve = {}
        for b in sorted({1, 32, batch}):
            chunk_b = chunk if (b > chunk and b % chunk == 0) else None
            reps = max(8, min(64, 512 // b))
            im_b, tx_b = images[:b], text[:b]

            def two_prog_req(im):
                f = mclip.encode_image_chunked(clip_params, cfg, im, chunk_b)
                return rest_body(clip_params, cfg, heads, retriever, f, tx_b).sum()

            def fused(im):
                out = composed_step(clip_params, cfg, heads, retriever, im, tx_b, chunk_b)
                return im + (out.sum() * 1e-30).to(im.dtype)

            for _ in range(2):
                _sync(two_prog_req(im_b))
            n_it = max(iters // 2, 3)
            t0 = time.perf_counter()
            for _ in range(n_it):
                _sync(two_prog_req(im_b))      # one synchronise per request
            t_2p = (time.perf_counter() - t0) / n_it
            t_ch = timeit_chain(fused, im_b, max(iters // 2, 3))
            dev_ms = device_ms(lambda: fused(im_b), reps, dev)
            curve[b] = {"two_prog_chained_ms": round(t_2p * 1e3, 2),
                        "fused_chained_ms": round(t_ch * 1e3, 2),
                        "fused_device_ms": round(dev_ms, 2)}
            log(f"latency b{b}: two-step request {t_2p * 1e3:.2f} ms "
                f"({t_2p * 1e3 / b:.2f} ms/q), fused chained {t_ch * 1e3:.2f} ms, "
                f"fused x{reps} {'graph replays' if dev.type == 'cuda' else 'chained'} "
                f"{dev_ms:.2f} ms ({dev_ms / b:.2f} ms/q)")
        return {"metric": "composed_query_latency_ms_per_batch",
                "value": curve[batch]["two_prog_chained_ms"],
                "unit": f"ms/b{batch}",
                "method": "two-program request, sync fetch per batch",
                "curve": curve,
                "vs_baseline": None}

    def fused_chain(im):
        out = composed_step(clip_params, cfg, heads, retriever, im, text, encode_chunk)
        return im + (out.sum() * 1e-30).to(im.dtype)

    t_lat = timeit_chain(fused_chain, images, max(iters // 2, 3))
    log(f"composed query latency (chained, one step): {t_lat * 1e3:.2f} ms/batch")

    batch_inputs = [make_images(rng) for _ in range(iters)]

    def two_prog(im):
        f = mclip.encode_image_chunked(clip_params, cfg, im, encode_chunk)
        return rest_body(clip_params, cfg, heads, retriever, f, text).sum()

    t = timeit_pipelined(two_prog, batch_inputs)
    qps = round(batch / t, 2)
    log(f"composed query two-step pipeline: {t * 1e3:.2f} ms/batch -> {qps} q/s/card")
    return {"metric": "composed_queries_per_sec_per_chip", "value": qps, "unit": "query/s",
            "vs_baseline": round(qps / A100_BASELINE_QPS, 3)}


def refuse_train_flags(args) -> None:
    """bench.py's refusals of flag conflicts, before anything is built."""
    if args.neighbors and args.retrieval != "xla":
        raise SystemExit(
            f"--neighbors bypasses the in-step search, which would silently "
            f"override --retrieval {args.retrieval} — same refusal as the "
            "train CLI")
    if args.neighbors and args.raw:
        raise SystemExit("--neighbors is a features-mode gather (raw "
                         "batches compute features on the fly) — same "
                         "refusal as the train CLI")
    if args.scan and args.raw:
        raise SystemExit("--scan is for sub-RTT feature-mode steps; the raw "
                         "step (~200 ms) chain-measures fine")
    if args.stream == "text" and args.raw:
        raise SystemExit("--stream text trains from precomputed features "
                         "(no raw mode; see cli/main.py)")


def bench_train(args, dev: torch.device, built) -> dict:
    """Training samples/s of one stream's step (features, raw images or
    precomputed neighbours)."""
    batch = args.batch or 128
    db_rows = args.db_rows or (50_000 if args.quick else 500_000)
    iters = args.iters or (5 if args.quick else 15)
    cfg = mclip.VIT_L_14
    log(f"train bench: device={dev} batch={batch} db_rows={db_rows} iters={iters} "
        f"stream={args.stream} raw={args.raw} neighbors={args.neighbors}")
    clip_params, heads, db = built or ge._build(cfg, db_rows, dtype=torch.bfloat16,
                                                device=dev)
    retriever = Retriever(db, backend=args.retrieval)
    theads = cast_floating(copy.deepcopy(heads), torch.float32, dev)   # updated in place
    opt_cfg = Config(lr=1e-4, beta1=0.9, beta2=0.98, eps=1e-6, wd=0.1, warmup=10000)
    opt, schedule = trainer.make_optimizer(opt_cfg, 600_000, theads)
    n_rows = len(db.names)
    rng = np.random.default_rng(0)
    prompt = np.zeros((1, 77), np.int32)
    prompt[0, :5] = [49406, 320, 1125, 539, 49407]
    db_other = None
    if args.stream == "text":
        # "a photo of * * {other}" templates of every DB row, the {other} 8
        # tokens (EOT at 14, the S=16 bucket)
        db_other = np.zeros((n_rows, 77), np.int32)
        db_other[:, 0] = 49406
        db_other[:, 1:4] = [320, 1125, 539]
        db_other[:, 4:6] = SPLIT_ID
        db_other[:, 6:14] = rng.integers(1000, 40000, (n_rows, 8))
        db_other[:, 14] = 49407
    step = trainer.make_train_step(
        clip_params, cfg, retriever, opt, schedule, stream=args.stream,
        prompt_tokens=prompt, split_id=SPLIT_ID, db_topk=DB_TOPK,
        db_other_tokens=db_other, compute_dtype=torch.bfloat16, device=dev)

    def on_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    if args.raw:
        text = np.zeros((batch, 77), np.int32)
        text[:, :6] = [49406, 320, 1125, 539, SPLIT_ID, 267]
        text[:, 6:14] = rng.integers(1000, 40000, (batch, 8))
        text[:, 14] = 49407
        px = cfg.image_resolution
        batch_data = RawBatch(
            images=on_dev(rng.integers(0, 256, (batch, px, px, 3)).astype(np.uint8)),
            caption_tokens=on_dev(tokenizer.bucket_text(text, n_pseudo=1)))
    else:
        if args.stream == "text":
            own = np.zeros((batch, 77), np.int32)
            own[:, 0] = 49406
            own[:, 1:4] = [320, 1125, 539]
            own[:, 4:7] = SPLIT_ID              # "* * *", the dataset's template
            own[:, 7:14] = rng.integers(1000, 40000, (batch, 7))
            own[:, 14] = 49407
            own_tokens = on_dev(tokenizer.bucket_text(own, n_pseudo=1))
        else:
            own_tokens = torch.zeros((batch, 77), dtype=torch.int32, device=dev)
        nb = {}
        if args.neighbors:
            # random valid rows: the gather and everything after it have the
            # searched step's shapes
            nb = {name: on_dev(rng.integers(0, n_rows, (batch, k)).astype(np.int32))
                  for name, k in (("img_idx", DB_TOPK), ("txt_idx", DB_TOPK),
                                  ("cap2_idx", 2))}
        batch_data = TrainBatch(
            image_features=on_dev(rng.standard_normal((batch, cfg.embed_dim)).astype(np.float32)),
            caption_features=on_dev(
                rng.standard_normal((batch, cfg.embed_dim)).astype(np.float32)),
            other_tokens=own_tokens, **nb)

    def chain_step(state):
        t, _ = state
        return t + 1, step(theads, batch_data, t)

    zero = torch.zeros((), device=dev)
    t = timeit_chain(chain_step, (0, zero), iters)
    sps = batch / t
    if args.neighbors or args.scan:
        # 8 different batches: a step's search or gather reads its own rows
        batches8 = [type(batch_data)(*(None if a is None else torch.roll(a, i, 0)
                                       for a in batch_data)) for i in range(8)]

        def chain8(state):
            t, loss = state
            for i, b in enumerate(batches8):
                loss = step(theads, b, i)
            return t, loss

        t8 = timeit_chain(chain8, (0, zero), max(iters // 4, 3)) / 8.0
        log(f"train step (x8 varied batches, one synchronise): {t8 * 1e3:.2f} ms -> "
            f"{batch / t8:.0f} samples/s (chained: {t * 1e3:.2f} ms)")
        t, sps = t8, batch / t8
    tag = " (raw images)" if args.raw else (
        " (text stream)" if args.stream == "text" else "")
    if args.neighbors:
        tag += " (precomputed neighbors)"
    if args.scan and not args.neighbors:
        tag += " (x8 scan)"
    log(f"train step{tag}: {t * 1e3:.2f} ms -> {sps:.0f} samples/s/card")
    base = A100_TRAIN_BASE["raw" if args.raw else args.stream]
    metric = ("raw_" if args.raw else "") + (
        "text_stream_" if args.stream == "text" else "") + (
        "neighbors_" if args.neighbors else "") + "train_samples_per_sec_per_chip"
    value = round(sps, 2)
    return {"metric": metric, "value": value, "unit": "sample/s",
            "method": "x8-scan" if (args.neighbors or args.scan) else "chained",
            "vs_baseline": round(value / base, 3)}


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
