#!/usr/bin/env python3
"""Smoke run of the keds_tpu_torch serving, training and evaluation paths
(ViT-L/14 and RN50), of the RN family and the rest of the model surface,
of its serve, demo and train command lines and tools, of two ranks of the
port sharing the card, of the full-scale eval benches, of
graft_entry_torch.py's entry() and dry run and of bench_torch.py's modes at
--quick, on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py full-sweeps    # the benches' full sweeps alone

``full-sweeps`` runs bench_cirr_fullscale (30 epochs x 2 branches) and
bench_coco_fullscale (25 epochs) with their defaults, each device- and
then host-ranked, and prints each run's JSON line and launch counts.

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
5a. rn_path, profile_rn, rn_check
           the same serving run, profile and check for RN50 at its published
           shapes (ModifiedResNet tower of layers (3, 4, 6, 3), width 64,
           224 px, a 32-head attention pool over 50 tokens, embed 1024; text
           512 wide, 8 heads, 12 layers; IM2TEXT 1024 -> 512 -> 512 -> 512,
           CrossFormers at 512; synthetic weights whose BatchNorms hold the
           statistics of a seeded calibration batch) over a 0.5M x 1024 bf16
           DB a modality made on the card; the features' spread (mean
           cosine between two images) beside the gate.
5b. rn_family
           RN101, RN50x4 (288 px), RN50x16 (384 px) and RN50x64 (448 px, a
           pool over 197 tokens), one at a time: bf16 encode images/s at a
           batch of 64, peak memory, and the card's bf16 encode of 4 images
           against its own f32 encode (cuDNN TF32 off), cosine >= 0.995,
           with the cosine after the batch mean is taken out and the spread.
5c. vit336_check
           ViT-L/14 at 336 px (577 tokens, B2 streaming K and V): the
           encode of a 16-image chunk timed, 4 images on the card in bf16
           against the CPU in f32 (cosine >= 0.995), B2 launches counted.
5c'. vit336_f32_check, vit224_f32_check
           --precision fp32: the same 4 images, and 4 at 224 px (257
           tokens, the main path's weights), encoded on the card in f32
           (B2's f32 kernel in each of the 24 blocks, launches counted)
           against the CPU's f32 encode:
           1 - cosine <= 1e-10 and 1 - centred cosine (the CPU batch mean
           taken out) <= 1e-7, limits the same encode with B2's inputs
           cut to TF32 (the control) must miss.
5d. surface_path
           the rest of the model surface at ViT-L/14 full width on the main
           path's weights, 2 rows each on the card in bf16 and the CPU in
           f32 (cosine >= 0.995 for each): encode_image_tokens,
           encode_image_mid_features (24 x 2 x 257 x 1024),
           get_visual_composed_features at mask_ratio 1 (B2 at S = 1, its
           launches counted) and 0.75 (the same tokens kept on both),
           encode_text_img_vis, get_text_mid_cross_feature, clip_forward.
5e. int8_quantize, int8_retrieval, int8_linear
           the int8 backend over the main path's DB: quantize_int8 on the
           card against the CPU bit for bit (a 50 000-row slice);
           mips_topk_int8 (k = 16 at B = 64 and 128, k = 2 at 128,
           oversample 4, true-row re-rank) against its plain version (the
           stage-1 product in float64) index for index but for near-ties
           within 1e-5 (counted), its top-16 overlap with B1's exact
           search, rows padded for torch._int_mm (B = 17 and 1 over 4096
           rows) and every row present twice (the lower row first); then
           int8_linear at a ViT-L/14 block's four GEMM shapes (16 images'
           4112 tokens) against the CPU bit for bit.  Times beside B1 at
           the same shape, the bf16 addmm of the same work and the bound
           (the int8 rate: 1,979 TOP/s, H100 SXM data sheet).
5f. quant_path, profile_quant, quant_check, quant_rn50
           ViT-L/14 serving with --quant-towers int8 and the int8
           Retriever (3 batches of 64; launch counts zeroed just before
           and read just after: no B1 bf16, the int8 products counted),
           the profile of one batch, 4 queries' composed features against
           the card's bf16 towers and the CPU's f32 int8 towers as
           cosines centred by the CPU's batch mean (a control with each
           int8 weight's scales permuted across channels must stay below
           the limit), and RN50's text tower quantized, its ResNet visual
           tower skipped with the warning seen.
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
           the flattened head gradients.  Then the same step on the card in
           f32 (B2 and B2' in f32, launches counted) against the same CPU
           step, within 1e-5 and 1 - 1e-6, which the bf16 step must miss.
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
           then the first 128 at --topn 300 ranked on the card (B1 f32 at
           k = 300) and on the host; launch counts zeroed just before and
           read just after each card run; corpus images/s, queries/s with
           decode, peak memory; the gate (the two --topn 300 files name the
           same images in the same order but for near-ties within 1e-5,
           counted); 4 queries composed on the card in bf16 against the CPU
           in f32 from the same files (cosine).  Then serve_quant: the
           first 128 queries with --quant-towers int8 --retrieval-backend
           int8 at --topn 10, their top-10 overlap with the exact run.
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
18. dist_path
           two ranks of the port on this card (``chip_smoke.py dist-rank``
           children, RANK/WORLD_SIZE, gloo: NCCL refuses two ranks on one
           device), each with ViT-L/14 from synth.build(seed=0) and its
           250 000-row half of the 0.5M DB (KnowledgeDB.shard_over): 3
           batches of 64 composed queries through ComposedQueryEngine(mesh=)
           (B1 bf16_tc on each shard, 6 launches a rank), their DB
           neighbours, a sharded f32 ranking of a 4096-row corpus, the
           image-stream step over the global batch of 2 x 128 (2 warm-up
           and 10 timed steps, samples/s, gloo's collective ms a step: the
           host-staged transport of a shared card, not NCCL), one bf16 and
           one f32 reading of step 0, a device-ranked CIRR sweep epoch,
           and mips_topk_int8_sharded over its half (quantized on the
           card) for 64 queries, equal to the one-process int8 search
           but for near-ties.
           This process computes the same on one device first, and the
           gates hold the ranks to it: composed-feature cosine >= 0.9999,
           DB neighbours equal but for near-ties (scores within 1e-4),
           the sharded ranking equal to B1 over the whole corpus but for
           ties within 1e-5, the step's loss within 1e-3 (bf16) and 1e-5
           (f32) relative, its head gradient at cosine >= 0.999 and
           0.99999 and its norm within 1e-3 and 1e-5 relative (the cosine
           cannot see a gradient off by a factor), and the sweep's epoch-1 tables equal to the one-process
           device-ranked tables but for near-ties within 1e-5.  Each rank
           is joined with a timeout; a failed rank fails the phase.
18b. graft_entry
           graft_entry_torch.py, the counterpart of __graft_entry__.py:
           fn(*entry()) once (ViT-L/14 bf16 from synth seed 0, a 16384-row
           DB, 8 zero images, 8 prompts at S=32; launch counts zeroed just
           before and read just after: B2 bf16_tc 36, B1 bf16_tc 2, nothing
           else), three calls timed, its first 2 rows against the same
           weights' f32 run on the CPU (cosine >= 0.995; centred cosine,
           the CPU's mean of the rows taken out, >= 0.99, which the card's
           rows with each caption reversed must miss), unit rows; then
           dryrun_multichip(2), two gloo ranks sharing cuda:0 at the tiny
           f32 config: each rank's four OK lines (the precomputed-neighbour
           loss bit-equal to the searched one) and its launches (B1 f32 8,
           B2 f32 12, B2' f32 8, no bf16).
18c. bench_entry
           bench_torch.py, the counterpart of bench.py, in this process at
           --quick (50 000 DB rows) --iters 2 on the main path's
           ViT-L/14 weights and the first 50 000 rows of its DB, built once
           and handed to each of six modes: the headline (256-query macro
           batches), --latency (b1, b32, b256), --train, --train --stream
           text, --train --neighbors and --train --raw.  Each mode's launch
           counts are zeroed just before and read just after; its one JSON
           line parses with bench.py's keys and a finite, positive value;
           serving launches B1 and B2 and no backward, training B2', and
           --neighbors no B1.  One line a mode with its wall.
2a. any_depth_path
           D off the kernels' steps through the entry points (launch and
           pad counts zeroed just before and read just after): the exact
           Retriever over 100 000-row DBs at D = 100 (f32), 96 (bf16) and
           1280 (bf16), 64 queries at k = 16 (B1 with D zero-padded to its
           step, or B1's bf16 score route above 1024) against the plain
           version; int8_matmul at (32, 100) x (100, 4096) equal to its
           plain version; an int8 Retriever over a 4096 x 100 DB (tables
           padded once to depth 104, the queries per call) with the CPU's
           neighbours but for near-ties.
2b. head_widths
           B2 and B2' at head widths off 64 (rows as in 2): the wide-head
           kernels at (4, 16, 257, 80) and (4, 8, 77, 128) causal in bf16
           and (2, 4, 77, 256) causal in f32, and the tensor-core kernels at
           the heads' own width, Dh = 32, at (64, 2, 32, 32) bf16 causal; the
           shapes the two configs below give the kernels, all causal: the
           wide one's engine batch at (64, 2, 32, 160) bf16 and its train
           steps' prompts at (64, 2, 8, 160) bf16 and f32, the tiny one's at
           (64, 2, 8, 32) bf16 and f32 (the backward at those four); the
           main path's widths re-split into 128-wide heads in bf16, each
           beside its Dh = 64 row of 2 (the same bytes): forward (16, 8,
           257, 128), (64, 6, 32, 128) and (128, 6, 8, 128) causal, backward
           (128, 6, 8, 128) and (256, 6, 32, 128) causal, and in f32 (the
           f32 wide-head kernels) ViT-L/14's vision chunk in 256-wide heads,
           (16, 4, 257, 256), both ways and the backward's two 128-wide
           rows; then two
           tiny configs through the entry points (head_width_path):
           tests/test_api_surface.py's (text heads of 32) and the same with
           text heads of 160, each a bf16 engine batch of 64 composed
           queries and a bf16 and an f32 image-stream train step, launch
           and pad counts zeroed just before and read just after (the tiny
           one: bf16 launches > 0 and no bf16 pad, the f32 backward's 2
           pads; the wide one: wide launches > 0), against the CPU's f32;
           empty shapes (empty_shape_check): the top-k at k = 0 and at no
           query through each tiling and mips_topk, B2 and B2' at B * H = 0,
           each of its shape on the card with no launch; and
           transforms.device_preprocess on an (8, 480, 640, 3) batch
           against the CPU's.
17a. extract_features, profile_dir, validate_artifacts
           keds_tpu_torch.tools.extract_features over the 4096 JPEGs and
           their captions with the ViT-L/14 checkpoint: images/s, names in
           folder order, 64 sampled rows of both arrays against a direct
           bf16 encode within 2e-2 and row-aligned; the train CLI on its
           output (32 steps of 128 over the 1000-row DB) with and without
           --profile-dir: one trace of 11 train_step_e0 ranges holding the
           port's own kernels, equal losses; validate_artifacts in CIRR
           mode over a 256-image PNG tree, the 0.5M DB and the checkpoint
           as both streams, --expected from the port's eval CLI table on
           the same files: parity_ok true.
18a. fullscale_path
           keds_tpu_torch.tools.bench_cirr_fullscale as a user runs it, at
           the CIRR val protocol's size: 4181 queries over 2297 noise PNGs at
           224 px, the 0.5M x 768 f32 DB in the reference's .pt layout, a full
           ViT-L/14 resume.pt and heads-only branches of 1 epoch (of 30),
           staged once under build/ (timed apart), then device- and
           host-ranked in bf16 at batch 64 with 8 decode threads: each JSON
           line, the two recall tables equal but for near-ties within 1e-5
           (eval_path's gate), the text buckets the prompts took; then
           bench_coco_fullscale over 2500 rows (5000 JPEGs; 5000 rows in
           full-sweeps) at 1 epoch (of 25), device-ranked, its tables finite.  Launch counts are zeroed
           just before and read just after each run and must equal what its
           batches give: B1 bf16_tc twice a query batch, B1 f32 (k=101)
           three times an epoch for CIRR's device ranking, B2 bf16_tc 24
           times an encoded chunk and 12 times a composed batch, nothing else.
19. the kernels line (launches of each path beside each variant, the
    dist path's rank 0 among them; graft_entry's entry() beside its own
    vision and search rows and its dry run's rank 0 beside the f32 rows of
    its shapes; bench_entry's modes beside the rows of their shapes over
    its 50 000 rows; RN50's serving for the D = 1024 top-k
    rows and its text tower's attention, the 336 px encode for the rows
    above 288 keys, any_depth_path's searches for the D = 100, 96 and 1280
    rows with their pads, head_widths' two configs beside the rows of their
    own shapes (the padded rows with their pads; every entry's row must have
    launched the variant it is printed under), and beside the wide config
    the f32 wide-head rows of other shapes, extract_features for
    the vision attention, the device-ranked CIRR bench for the text
    attention at S=77; the f32
    image step and f32 encodes each beside its own shape), the walls line
    (seconds of each part of the run), then the card's name and power
    limit from nvidia-smi, then the result line.

The backward rows cover S above 128 (the streamed launches): bf16 at 257
and 577, f32 at 289.  The top-k rows cover k=16, 10 and 2 and, above 32, the evaluators'
rankings (k=101, 100, 200), a --db-topk of 64 and, above 256, k=300 over
10 000, 4096 and 0.5M rows and k = N = 1000, and
RN50's retrieval and ranking at D = 1024, and D off the kernels' steps
(100 f32, 96 bf16, 1280 bf16 over 100 000 rows, with the pad's own ms).
The attention rows cover S
above 288, where the kernels stream K and V: ViT-L/14 at 336 px (577),
1025 tokens, and f32 at 577 and 289; and the eval benches' prompt batches,
(64, 12, 77, 64) causal.  The f32 rows' bound takes the operations at
3xTF32's rate (494.7 / 3 TFLOP/s), with the f32 FMA rate's bound beside it.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
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
# B2 and B2' in f32 take each product as three TF32 terms on tensor cores
# (494.7 TFLOP/s dense TF32, H100 SXM data sheet): their bound's rate
ATT_PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 494.7e12 / 3}
ATT_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}   # output-dtype rounding
TOPK_TOL = 1e-4        # f32 sums of 768 products in another order
COSINE_MIN = 0.995
# backward kernel vs plain, |err| <= atol + rtol * |plain|: f32 sums in
# another order; bf16 gradients rounded to bf16, and a probability or
# dP = dO V^T, which both round to bf16, may round the other way
BWD_TOL = {torch.bfloat16: (3e-2, 2e-2), torch.float32: (1e-4, 1e-4)}
TRAIN_BATCH = 128
TRAIN_LOSS_RTOL = 0.01       # train_check: card bf16 vs CPU f32 (PERF.md)
TRAIN_GRAD_COSINE_MIN = 0.99
# the card's f32 step vs the CPU's f32 step (loss rel diff, gradient cosine):
# the same f32 math in another order; the bf16 step misses them (PERF.md)
TRAIN_F32_LIMITS = (1e-5, 1 - 1e-6)
TRAIN_OPT = SimpleNamespace(lr=5e-4, beta1=0.9, beta2=0.98, eps=1e-6, wd=0.2, warmup=2,
                            skip_scheduler=False)   # ViT-L/14 defaults, short warm-up
TRAIN_PROMPT = np.array([[49406, 320, 1125, 539, 49407] + [0] * 72])   # "a photo of"
OTHER_LEN = (4, 20)    # ids in a text-stream "other" caption (CC3M: about 10 words)
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


class Walls:
    """Host seconds of each part of the run, in order: ``walls(name)`` closes
    the part that began at the previous call."""

    def __init__(self):
        self.seconds, self.t = {}, time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name], self.t = now - self.t, now


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


def bound(nbytes: float, flops: float, dtype: torch.dtype, peak: dict = PEAK_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _fma_bound(nbytes: float, flops: float, dtype: torch.dtype) -> dict:
    """An f32 attention row's bound at the f32 FMA rate, beside its 3xTF32 one."""
    return {"bound_fma_ms": bound(nbytes, flops, dtype)[0]} if dtype == torch.float32 else {}


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
        q, k, v = _qkv(B, H, S, Dh, dtype)
        launches0, pads0 = dict(KERNEL.launches), dict(KERNEL.pads)
        out = attention(q, k, v, causal)
        variant = _launched(KERNEL.launches, launches0)
        ref = attention_reference(q, k, v, causal)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not err <= ATT_TOL[dtype]:
            raise AssertionError(f"attention {B, H, S, Dh} {dtype} causal={causal}: "
                                 f"max_abs_err {err} > {ATT_TOL[dtype]}")
        pairs = S * (S + 1) // 2 if causal else S * S
        nbytes, flops = 4 * B * H * S * Dh * q.element_size(), 4 * B * H * pairs * Dh
        b_ms, b_by = bound(nbytes, flops, dtype, ATT_PEAK_FLOPS)
        row = dict(shape=[B, H, S, Dh], dtype=str(dtype), variant=variant, causal=causal,
                   max_abs_err=err, tol=ATT_TOL[dtype],
                   kernel_ms=time_ms(lambda: attention(q, k, v, causal)),
                   plain_ms=time_ms(lambda: attention_reference(q, k, v, causal)),
                   library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                       q, k, v, is_causal=causal)),
                   bound_ms=b_ms, bound_by=b_by, **_fma_bound(nbytes, flops, dtype),
                   launches=KERNEL.launches[variant] - launches0[variant],
                   **_padded(KERNEL.pads[variant] - pads0[variant]))
        emit("attention", **row)
        rows.append(row)
    return rows


def check_attention_bwd(cases):
    import torch.nn.functional as F

    from keds_tpu_torch.ops.attention import (BWD_KERNEL, attention_backward,
                                              attention_reference_backward)

    rows = []
    for B, H, S, Dh, dtype, causal in cases:
        q, k, v = _qkv(B, H, S, Dh, dtype)
        dout = _dout(B, H, S, Dh, dtype)
        launches0, pads0 = dict(BWD_KERNEL.launches), dict(BWD_KERNEL.pads)
        grads = attention_backward(q, k, v, dout, causal)
        variant = _launched(BWD_KERNEL.launches, launches0)
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
        nbytes, flops = 7 * B * H * S * Dh * q.element_size(), 10 * B * H * pairs * Dh
        b_ms, b_by = bound(nbytes, flops, dtype, ATT_PEAK_FLOPS)
        sdpa_fwd_ms = time_ms(sdpa)
        sdpa_both_ms = time_ms(lambda: torch.autograd.grad(sdpa(), leaves, dout))
        row = dict(shape=[B, H, S, Dh], dtype=str(dtype), variant=variant, causal=causal,
                   max_abs_err=err, tol=f"{atol} + {rtol} * |plain|",
                   kernel_ms=time_ms(lambda: attention_backward(q, k, v, dout, causal)),
                   plain_ms=time_ms(lambda: attention_reference_backward(q, k, v, dout,
                                                                         causal)),
                   library_ms=sdpa_both_ms - sdpa_fwd_ms, library_fwd_bwd_ms=sdpa_both_ms,
                   bound_ms=b_ms, bound_by=b_by, **_fma_bound(nbytes, flops, dtype),
                   launches=BWD_KERNEL.launches[variant] - launches0[variant],
                   **_padded(BWD_KERNEL.pads[variant] - pads0[variant]))
        if not variant.endswith("_wide"):     # the tuned kernels' plan
            row["plan"] = _bwd_plan(B * H, S, dtype, Dh)
        emit("attention_bwd", **row)
        rows.append(row)
    return rows


def _bwd_plan(batch_heads: int, S: int, dtype, Dh: int = 64) -> dict:
    """The tuned backward kernels' launch plan for a head of ``Dh``, as
    keds_attention_bwd_plan gives it, and the blocks of a call over
    ``batch_heads`` slices."""
    import ctypes

    from keds_tpu_torch.ops.attention import BWD_KERNEL

    out = (ctypes.c_int * 5)()
    code = 1 if dtype == torch.bfloat16 else 0
    if BWD_KERNEL.lib().keds_attention_bwd_plan(S, code, Dh, ctypes.cast(out, ctypes.c_void_p)):
        raise AssertionError(f"keds_attention_bwd_plan refused S={S} Dh={Dh} {dtype}")
    plan = dict(zip(("key_tiles", "slices", "warps", "smem_bytes", "workspace_rows"), out))
    return dict(plan, blocks=-(-batch_heads // plan["slices"]))


def _launched(launches: dict, before: dict) -> str:
    """The one variant whose count rose since ``before``."""
    rose = [v for v in launches if launches[v] != before[v]]
    if len(rose) != 1 or launches[rose[0]] != before[rose[0]] + 1:
        raise AssertionError(f"one launch expected, counts {before} -> {launches}")
    return rose[0]


def _padded(pads: int) -> dict:
    """A row's pad fields where the wrapper zero-padded the head to 64."""
    return {"padded_to": 64, "pads": pads} if pads else {}


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
    from keds_tpu_torch.ops.quant import pad_depth
    from keds_tpu_torch.ops.topk import (GRID_LAUNCHES, KERNEL, TILINGS, depth_step,
                                         kernel_depth, mips_topk, mips_topk_plain, split_plan)
    tiling_names = dict(zip(TILINGS, ("F32", "F32_MID", "TC", "BF16", "F32_FUSED")))

    rows = []
    for B, N, D, k, dtype in cases:
        db = _unit_rows(N, D, dtype, seed=N)
        q = _unit_rows(B, D, dtype, seed=B + 1)
        tiling = split_plan(B, N, torch.cuda.get_device_properties(0).multi_processor_count,
                            dtype, k, D)[0]
        variant = tiling.variant
        depth = kernel_depth(tiling, D)
        launches0, pads0 = KERNEL.launches[variant], KERNEL.pads[variant]
        grid0 = GRID_LAUNCHES[variant]
        vals, idx = mips_topk(q, db, k)
        pads = KERNEL.pads[variant] - pads0
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
                   tiling=tiling_names[tiling], cuda_kernels=GRID_LAUNCHES[variant] - grid0,
                   max_abs_err=err, tol=TOPK_TOL,
                   idx_equal_share=float((idx == pi[:, :k]).float().mean()),
                   separated_positions=int(sep.sum()),
                   kernel_ms=time_ms(lambda: mips_topk(q, db, k)),
                   plain_ms=time_ms(lambda: mips_topk_plain(q, db, k), iters=5),
                   library_ms=time_ms(lambda: torch.topk(torch.mm(q, db.t()).float(), k)),
                   bound_ms=b_ms, bound_by=b_by,
                   launches=KERNEL.launches[variant] - launches0)
        if depth != D:    # any D: the wrapper's zero-padded copies, timed alone
            if pads != 1:
                raise AssertionError(f"mips_topk {B, N, D, k} {dtype}: {pads} pads, want 1")
            row.update(padded_to=depth, pads=pads,
                       pad_ms=time_ms(lambda: (pad_depth(q, depth_step(tiling)),
                                               pad_depth(db, depth_step(tiling)))))
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


def profile_batch(engine, images_u8: np.ndarray, text: np.ndarray, corpus,
                  phase: str = "profile", groups=()) -> None:
    """Device time of one query batch by kernel (``groups`` first, then
    the kernels' and GEMMs')."""
    def batch():
        with torch.inference_mode():
            f, _ = engine.compose_batch(images_u8, text)
            engine.rank(f, corpus, 10)

    profile_device(phase, batch, [*groups,
                                  ("attention (B2)", ("attention_tc", "attention_f32")),
                                  ("mips_topk (B1)", ("topk_",))])


def feature_spread(features) -> float:
    """Mean cosine between the features of two different rows: near 1, the
    rows are nearly collinear and a cosine gate against another device
    reads little of what tells them apart."""
    f = torch.as_tensor(np.asarray(features), dtype=torch.float64)
    f = f / f.norm(dim=1, keepdim=True)
    n = f.shape[0]
    return float(((f @ f.T).sum() - n) / (n * (n - 1)))


SERVING_WANT = {("attention", "f32"): 0, ("attention_bwd", "bf16"): 0,
                ("attention_bwd", "f32"): 0}
SERVING_POSITIVE = (("attention", "bf16_tc"), ("mips_topk", "bf16_tc"), ("mips_topk", "f32"))


def serving_run(phase: str, engine, kernels, seed: int, want=SERVING_WANT,
                positive=SERVING_POSITIVE, **fields) -> SimpleNamespace:
    """ComposedQueryEngine over a path's model and DB: N_CORPUS uint8
    images at the model's resolution encoded, N_QUERY_BATCHES of 64 composed
    queries (the S=32 bucket) ranked against them, kernel launch counts
    zeroed just before and read just after, the outputs checked (shapes,
    finite, ranks in range and descending, unit-norm corpus), per-stage ms
    of one batch (median of three) and peak memory; one JSON line."""
    px = engine.cfg.image_resolution
    rng = np.random.default_rng(seed)
    corpus_batches = [rng.integers(0, 256, (QUERY_BATCH, px, px, 3), dtype=np.uint8)
                      for _ in range(N_CORPUS // QUERY_BATCH)]
    q_images = [rng.integers(0, 256, (QUERY_BATCH, px, px, 3), dtype=np.uint8)
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
    # CUDA-core attention is left on it, and it saves nothing for a backward
    check_path_launches(phase, launches, want, positive)
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
    emit(phase, **fields, dtype="bf16", corpus_images=N_CORPUS, queries=n_q,
         query_batch=QUERY_BATCH, encode_corpus_s=t1 - t0,
         corpus_images_per_s=N_CORPUS / (t1 - t0), search_s=t3 - t2,
         queries_per_s=n_q / (t3 - t2), stage_ms_one_batch=stages,
         stage_ms_runs=runs, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         corpus_feature_spread=feature_spread(corpus), launches=launches)
    return SimpleNamespace(launches=launches, q_images=q_images, q_texts=q_texts,
                           dcorpus=dcorpus)


def compose_check(phase: str, engine, cfg, clip_params, heads, db, q_images, q_texts):
    """Two queries through the same weights on the CPU in f32 against the
    card's bf16 composed features (cosine >= COSINE_MIN); returns the CPU's
    f32 (clip, heads, DB)."""
    from keds_tpu_torch.engine import ComposedQueryEngine
    from keds_tpu_torch.models.convert import cast_floating
    from keds_tpu_torch.retrieval.database import KnowledgeDB

    t = time.perf_counter()
    f32 = torch.float32
    gpu = engine.compose([q_images[0][:2]], [q_texts[0][:2]])
    cpu_db = KnowledgeDB(db.image_db.cpu().float(), db.text_db.cpu().float(), db.names)
    cpu_clip, cpu_heads = cast_floating(clip_params, f32, "cpu"), cast_floating(heads, f32, "cpu")
    cpu_engine = ComposedQueryEngine(cpu_clip, cfg, cpu_heads, cpu_db, split_id=SPLIT_ID,
                                     compute_dtype=f32, device="cpu")
    cpu = cpu_engine.compose([q_images[0][:2]], [q_texts[0][:2]])
    cos = (gpu * cpu).sum(1) / (np.linalg.norm(gpu, axis=1) * np.linalg.norm(cpu, axis=1))
    emit(phase, cosine=cos.tolist(), min_cosine=float(cos.min()), threshold=COSINE_MIN,
         composed_spread=feature_spread(cpu), seconds=time.perf_counter() - t)
    if not (np.isfinite(cos).all() and cos.min() >= COSINE_MIN):
        raise AssertionError(f"{phase}: card bf16 vs CPU f32 cosine {cos} < {COSINE_MIN}")
    return cpu_clip, cpu_heads, cpu_db


def _train_setup(clip_params, heads, db, device, dropout=0.1, dtype=torch.bfloat16,
                 total_steps=20, stream="image", db_other_tokens=None, retriever=None,
                 grad_scale=1.0, mesh=None, cfg=None):
    """f32 trainable copies of the heads, their optimizer and the train step
    of ``cfg`` (ViT-L/14 by default; over ``retriever``, by default a
    Retriever of ``db``; data-parallel over ``mesh``).  The copies are new
    tensors even where ``heads`` are f32 on ``device`` already (the CPU's),
    which the step would otherwise train in place."""
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.models.convert import cast_floating
    from keds_tpu_torch.retrieval.database import Retriever
    from keds_tpu_torch.train.trainer import make_optimizer, make_train_step

    theads = cast_floating(copy.deepcopy(heads), torch.float32, device)
    opt, sched = make_optimizer(TRAIN_OPT, total_steps, theads)
    step = make_train_step(clip_params, cfg or VIT_L_14, retriever or Retriever(db), opt, sched,
                           stream=stream, prompt_tokens=TRAIN_PROMPT, split_id=SPLIT_ID,
                           dropout=dropout, db_other_tokens=db_other_tokens,
                           compute_dtype=dtype, device=device, grad_scale=grad_scale,
                           mesh=mesh)
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
                  db_other_tokens=None, cfg=None) -> tuple:
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
                                      stream=stream, db_other_tokens=db_other_tokens, cfg=cfg)
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


def compare_readings(card: tuple, cpu: tuple, limits=(TRAIN_LOSS_RTOL, TRAIN_GRAD_COSINE_MIN),
                     card_dtype: str = "bf16") -> dict:
    """The check's numbers for a card and a CPU reading, and whether they
    pass ``limits`` (loss relative difference, gradient cosine).  The cosine
    is None where the card's gradient is 0."""
    (l_card, g_card), (l_cpu, g_cpu) = card, cpu
    rtol, cos_min = limits
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    norm_card, norm_cpu = float(g_card.norm()), float(g_cpu.norm())
    cos = float(g_card @ g_cpu) / (norm_card * norm_cpu) if norm_card > 0 else None
    return {f"loss_card_{card_dtype}": l_card, "loss_cpu_f32": l_cpu, "loss_rel_diff": rel,
            "loss_rel_max": rtol, "head_grad_cosine": cos, "head_grad_cosine_min": cos_min,
            "head_grad_norm_card": norm_card, "head_grad_norm_cpu": norm_cpu,
            "passes": rel <= rtol and cos is not None and cos >= cos_min}


def train_check(clip_params, heads, db, cpu_clip, cpu_heads, cpu_db, kernels) -> dict:
    """One train step on the card (bf16) against the CPU (f32) from the same
    weights and batch; the card's neighbour indices go to both (idx=), so
    near-ties in the bf16 search do not decide the check, and dropout is 0
    (the two devices' generators differ; the neighbour permutation cancels
    in cross-attention).  ``kernel_sweeps.py train_check_controls`` reads
    the same check with the attention gradient broken.  Then the same step
    on the card in f32 (``--precision fp32``: B2 and B2' in f32, launches
    counted) against the same CPU step, at TRAIN_F32_LIMITS, which the bf16
    step (the control) misses; returns the f32 step's launches."""
    t = time.perf_counter()
    inputs = train_check_batch(db)
    cpu = train_reading(cpu_clip, cpu_heads, cpu_db, torch.float32, inputs)
    r = compare_readings(train_reading(clip_params, heads, db, torch.bfloat16, inputs), cpu)
    for k in kernels.values():
        k.reset()
    card32 = train_reading(clip_params, heads, db, torch.float32, inputs)
    torch.cuda.synchronize()
    launches = {name: dict(k.launches) for name, k in kernels.items()}
    r32 = compare_readings(card32, cpu, TRAIN_F32_LIMITS, "f32")
    control = (r["loss_rel_diff"] <= TRAIN_F32_LIMITS[0]
               and r["head_grad_cosine"] >= TRAIN_F32_LIMITS[1])
    emit("train_check", **r, f32_step=r32, f32_launches=launches,
         bf16_step_passes_f32_limits=control, seconds=time.perf_counter() - t)
    if not r["passes"]:
        raise AssertionError(f"train step card vs CPU: loss rel diff {r['loss_rel_diff']}, "
                             f"grad cosine {r['head_grad_cosine']}")
    if not r32["passes"] or control:
        raise AssertionError(f"f32 train step card vs CPU: {r32}; the bf16 step within the "
                             f"f32 limits: {control}")
    check_path_launches("train_check_f32", launches,
                        {("attention", "bf16_tc"): 0, ("attention_bwd", "bf16"): 0,
                         ("attention_bwd", "bf16_stream"): 0},
                        [("attention", "f32"), ("attention_bwd", "f32")])
    return launches


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
            heads = synth.init_heads(VIT_L_14.embed_dim, 512, VIT_L_14.transformer_width,
                                     seed=1000 * (b + 1) + j, device=device,
                                     dtype=torch.float32)
            torch.save({"epoch": j, **heads_to_state_dicts(heads)},
                       root / name / f"epoch_{j}.pt")
        branches.append(str(root / name))
    return branches


def device_positions(split, idx: np.ndarray) -> np.ndarray:
    """Each query's target position after its reference is removed, capped
    at 100 (what R@1..R@100 read), from top-101 indices ``idx`` (absent: 100)."""
    r, t = split.ref[:, None], split.target[:, None]
    hit = idx == t
    col = hit.argmax(axis=1)
    ref_before = ((idx == r) & (np.arange(idx.shape[1]) < col[:, None])).any(axis=1)
    return np.minimum(np.where(hit.any(axis=1), col - ref_before, 100), 100)


def target_positions(split, idx: np.ndarray, order: np.ndarray) -> tuple:
    """:func:`device_positions` of the device's top-101 indices ``idx``, and
    the same from the host's full ascending-distance order ``order``."""
    t, r = split.target[:, None], split.ref[:, None]
    pos_d = device_positions(split, idx)
    rank = np.empty_like(order)
    rank[np.arange(order.shape[0])[:, None], order] = np.arange(order.shape[1])
    pos_t = np.take_along_axis(rank, t, 1)[:, 0]
    pos_r = np.take_along_axis(rank, r, 1)[:, 0]
    return pos_d, np.minimum(pos_t - (pos_r < pos_t), 100)


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
    for e, j in enumerate(sorted({j for j, _ in host["tables"]})):
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


@contextlib.contextmanager
def eval_capture():
    """Record what evaluate_cirr (or evaluate_coco) computes while the block
    runs: the corpus features and names, each epoch's two composed feature
    sets, the device ranking's top-k indices, the tables, and what
    profile_eval replays.  The features are kept on the card until the
    block ends, then copied to the host."""
    from keds_tpu_torch.evalkit import evaluators as ev

    run = dict(feats=[], topk=[])
    real = (ev._encode_corpus, ev._compose_all, ev._rank_topk, ev.evaluate_cirr,
            ev.evaluate_coco)

    def encode_corpus(ctx, loader):
        run["corpus"], run["names"] = real[0](ctx, loader)
        return run["corpus"], run["names"]

    def compose_all(ctx, compose, hi, ht, cache, texts=None):
        out = real[1](ctx, compose, hi, ht, cache, texts)
        run["feats"].append(out)
        run["profile"] = (ctx, compose, cache)
        return out

    def rank_topk(feats, corpus_dev, k):
        out = real[2](feats, corpus_dev, k)
        run["topk"].append([i.cpu().numpy() for i in out])
        run["corpus_dev"] = corpus_dev
        return out

    def recorded(evaluate):
        def run_evaluator(*args, **kw):
            run["tables"] = evaluate(*args, **kw)
            return run["tables"]
        return run_evaluator

    ev._encode_corpus, ev._compose_all, ev._rank_topk, ev.evaluate_cirr, ev.evaluate_coco = (
        encode_corpus, compose_all, rank_topk, recorded(real[3]), recorded(real[4]))
    try:
        yield run
    finally:
        (ev._encode_corpus, ev._compose_all, ev._rank_topk, ev.evaluate_cirr,
         ev.evaluate_coco) = real
    run["feats"] = [tuple(f.cpu().numpy() for f in pair) for pair in run["feats"]]


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
    branches = write_branches(root, db.image_db.device)
    for ranking in ("device", "host"):
        ctx = ev.EvalContext(clip_params, VIT_L_14, Retriever(db),
                             image_branch=branches[0], text_branch=branches[1],
                             compute_dtype=torch.bfloat16,
                             eval_ranking=ranking, split_id=SPLIT_ID)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.reset()
        with eval_capture() as run:
            t0 = time.perf_counter()
            ev.evaluate_cirr(ctx, split.queries, split.corpus,
                             epochs=range(1, EVAL_EPOCHS + 1))
            torch.cuda.synchronize()
        run.update(seconds=time.perf_counter() - t0, walls=dict(ev.last_cirr_walls),
                   launches={n: dict(k.launches) for n, k in kernels.items()},
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        runs[ranking] = run
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
    # what dist_path holds its 2-rank sweep epoch against
    ref = SimpleNamespace(tables={k: runs["device"]["tables"][(1, k)]
                                  for k in ("composed", "image", "mixture")},
                          topk=runs["device"]["topk"][0], feats=runs["host"]["feats"][0],
                          corpus=runs["host"]["corpus"], split=split)
    return split, runs["device"]["profile"], runs["device"]["corpus_dev"], launches, ref


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
                M.get_metrics_cirr_from_topk(ti.cpu().numpy(), split.names, refs, targets,
                                             EVAL_CORPUS)

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
SERVE_WIDE_TOPN = 300  # above 256
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


def write_vocab(path: pathlib.Path) -> pathlib.Path:
    """The synthetic merges file at ``path``, set in KEDS_TPU_BPE_VOCAB."""
    import gzip
    import os

    with gzip.open(path, "wt", encoding="utf-8") as fh:
        fh.write("#version: synthetic\n" + "\n".join(SYNTHETIC_MERGES) + "\n")
    os.environ["KEDS_TPU_BPE_VOCAB"] = str(path)
    return path


def write_smoke_files(root: pathlib.Path, clip_params, heads, db) -> SimpleNamespace:
    """The files the CLIs read, under ``root``: the synthetic vocab (set in
    KEDS_TPU_BPE_VOCAB), reference-layout ViT-L/14 checkpoints with an MLP
    and a CrossFormer img2text, the 0.5M DB in f32 and a 1000-row one,
    SERVE_CORPUS 256 px JPEGs, queries.jsonl, csvs of DEMO_CORPUS and
    CLI_ROWS images, tar shards of the first RAW_SHARDS x RAW_PER_SHARD
    images and their caption map."""
    import io
    import tarfile

    from keds_tpu_torch.io.checkpoint import save_train_checkpoint
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.models.convert import heads_to_state_dicts

    t = time.perf_counter()
    f = SimpleNamespace(root=root)
    f.vocab = write_vocab(root / "merges.txt.gz")
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
        ("mips_topk", "bf16"): 0, ("attention", "f32"): 0,
        ("attention_bwd", "bf16"): 0, ("attention_bwd", "f32"): 0},
        [("attention", "bf16_tc")])
    wide = run("served_wide.jsonl", f.wide_queries, SERVE_WIDE_TOPN)
    n_wide = -(-SERVE_WIDE_QUERIES // QUERY_BATCH)
    check_path_launches("serve --topn 300", wide["launches"], {
        ("mips_topk", "f32"): n_wide, ("mips_topk", "bf16"): 0,
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


# --- two ranks on one card -------------------------------------------------------

DIST_RANKS = 2
DIST_SEED = 21          # the phase's query batches, corpus and train batch
DIST_CORPUS = 4096
DIST_TOPN = 10
DIST_STEPS = 10
DIST_TIMEOUT_S = 900
DIST_FEATURE_COSINE_MIN = 0.9999
# DB neighbours of the 2-rank run against the 1-process run: a differing
# entry is a near-tie when the two runs' scores at its place agree this
# closely (queries whose features agree at cosine >= 0.9999)
DIST_NB_TIE = 1e-4
# a 2-rank card step against the 1-process card step: (loss rel diff, head-gradient
# cosine, head-gradient norm rel diff)
DIST_STEP_LIMITS = {"bf16": (1e-3, 0.999, 1e-3), "f32": (1e-5, 0.99999, 1e-5)}
DIST_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def dist_inputs() -> tuple:
    """The phase's 3 batches of 64 query images and S=32 prompts and its
    4096-row unit-norm f32 corpus, from DIST_SEED."""
    rng = np.random.default_rng(DIST_SEED)
    images = [rng.integers(0, 256, (QUERY_BATCH, 224, 224, 3), dtype=np.uint8)
              for _ in range(N_QUERY_BATCHES)]
    texts = [prompt_batch(rng, QUERY_BATCH) for _ in range(N_QUERY_BATCHES)]
    from keds_tpu_torch.models.clip import VIT_L_14

    corpus = rng.standard_normal((DIST_CORPUS, VIT_L_14.embed_dim)).astype(np.float32)
    return images, texts, corpus / np.linalg.norm(corpus, axis=1, keepdims=True)


def dist_batch(dev):
    """The global train batch, DIST_RANKS x TRAIN_BATCH feature pairs."""
    from keds_tpu_torch import synth
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.train.losses import TrainBatch

    return TrainBatch(*synth.feature_pairs(DIST_RANKS * TRAIN_BATCH, VIT_L_14.embed_dim,
                                           seed=DIST_SEED, device=dev))


def neighbours(engine, images) -> list:
    """(scores, rows) of the top db_topk rows of the image and the caption DB
    for each query image (the global batch's, on every rank), batch by batch."""
    from keds_tpu_torch.parallel.mesh import fetch_global, shard_global_batch
    from keds_tpu_torch.retrieval.database import unit_rows

    out = []
    with torch.inference_mode():
        for im in images:
            x, n = shard_global_batch(engine.mesh, im, engine.device)
            q = unit_rows(engine.encode_features(x).float()).to(engine.db.image_db.dtype)
            for table in (engine.db.image_db, engine.db.text_db):
                v, i = engine.retriever.search(q, table, engine.db_topk)
                out.append(tuple(fetch_global(engine.mesh, a, n).cpu().numpy() for a in (v, i)))
    return out


def step_reading(step, theads, batch) -> tuple:
    """(loss, flattened f64 head gradient) of train step 0 on ``batch``."""
    from keds_tpu_torch.models.convert import head_parameters

    loss = float(step(theads, batch, 0))
    return loss, torch.cat([p.grad.flatten().double().cpu() for _, _, p in
                            head_parameters(theads)])


def dist_rank(workdir: pathlib.Path, url: str) -> None:
    """One of DIST_RANKS gloo ranks sharing cuda:0 (chip_smoke.py dist-rank
    <dir> <url>, RANK and WORLD_SIZE set): ViT-L/14 from synth.build(seed=0)
    with its 0.5M DB split over the ranks; sharded serving and ranking, the
    image-stream train step (timed, then one bf16 and one f32 reading) and a
    device-ranked CIRR sweep epoch.  Writes rank<r>.json and rank<r>.npz."""
    from keds_tpu_torch import synth
    from keds_tpu_torch.engine import ComposedQueryEngine
    from keds_tpu_torch.evalkit import evaluators as ev
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.ops import attention as att_mod, topk as topk_mod
    from keds_tpu_torch.parallel.mesh import (make_mesh, maybe_init_distributed,
                                              shard_global_batch, shard_rows)
    from keds_tpu_torch.retrieval.database import Retriever
    from keds_tpu_torch.train.losses import TrainBatch
    from keds_tpu_torch.train.trainer import train_epoch

    maybe_init_distributed(SimpleNamespace(distributed=True, dist_url=url, device=DEV))
    mesh = make_mesh(device=DEV)
    dev = mesh.device
    from keds_tpu_torch.ops.quant import INT8_MM

    kernels = {"attention": att_mod.KERNEL, "attention_bwd": att_mod.BWD_KERNEL,
               "mips_topk": topk_mod.KERNEL, "int8_mm": INT8_MM}

    def counted(fn):
        """(fn(), seconds, launches, collectives) of one synchronised run."""
        torch.cuda.synchronize()
        for k in kernels.values():
            k.reset()
        mesh.comm.reset()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return (r, time.perf_counter() - t, {n: dict(k.launches) for n, k in kernels.items()},
                dataclasses.asdict(mesh.comm))

    t = time.perf_counter()
    clip_params, heads, full = synth.build(VIT_L_14, db_rows=DB_ROWS, dtype=torch.bfloat16,
                                           seed=0, device=dev)
    db = full.shard_over(mesh)
    del full
    torch.cuda.empty_cache()
    info = dict(rank=mesh.rank, backend=mesh.backend, device=str(dev), shard_rows=db.size,
                build_s=time.perf_counter() - t)
    arrays = {}

    # sharded serving and ranking
    engine = ComposedQueryEngine(clip_params, VIT_L_14, heads, db, split_id=SPLIT_ID,
                                 mesh=mesh)
    images, texts, corpus = dist_inputs()
    engine.compose_batch(images[0], texts[0])            # warm-up
    with torch.inference_mode():
        composed, s, launches, comm = counted(lambda: engine.compose(images, texts))
    info["serving"] = dict(seconds=s, queries_per_s=len(composed) / s, launches=launches,
                           collectives=comm)
    arrays["composed"] = composed
    for j, (v, i) in enumerate(neighbours(engine, images)):
        arrays[f"nb{j}_vals"], arrays[f"nb{j}_idx"] = v, i
    dc = engine.corpus_to_device(corpus)

    def rank_all():
        with torch.inference_mode():
            return [engine.rank(shard_global_batch(mesh, composed[b:b + QUERY_BATCH], dev)[0],
                                dc, DIST_TOPN)
                    for b in range(0, len(composed), QUERY_BATCH)]

    ranked, s, launches, comm = counted(rank_all)
    info["ranking"] = dict(seconds=s, corpus_rows_here=int(dc.array.shape[0]),
                           launches=launches, collectives=comm)
    arrays["rank_vals"] = torch.cat([v for v, _ in ranked]).cpu().numpy()
    arrays["rank_idx"] = torch.cat([i for _, i in ranked]).cpu().numpy()
    del engine, dc, ranked
    torch.cuda.empty_cache()

    # the int8 search: the rank's half quantized on the card, searched and merged
    q = _unit_rows(QUERY_BATCH, VIT_L_14.embed_dim, torch.bfloat16, seed=DIST_SEED)
    q8, sc = topk_mod.quantize_int8(db.image_db)
    (v8, i8), s, launches, comm = counted(lambda: topk_mod.mips_topk_int8_sharded(
        q.float(), q8, sc, 16, mesh, DB_ROWS, db_shard=db.image_db))
    info["int8"] = dict(seconds=s, launches=launches, collectives=comm)
    arrays["int8_vals"], arrays["int8_idx"] = v8.cpu().numpy(), i8.cpu().numpy()
    del q8, sc
    torch.cuda.empty_cache()

    # image-stream training, the rank's block of the global batch
    batch = dist_batch(dev)
    local = TrainBatch(shard_rows(mesh, batch.image_features), shard_rows(mesh, batch.caption_features))
    retr = Retriever(db)
    theads, _, sched, step = _train_setup(clip_params, heads, db, dev, retriever=retr,
                                          grad_scale=1 / mesh.size, mesh=mesh)
    losses = [step(theads, local, t) for t in range(2)]       # warm-up steps t = 0, 1

    def timed_steps():
        def recorded(h, b, t):
            losses.append(step(h, b, t))
            return losses[-1]
        train_epoch(recorded, theads, iter([local] * DIST_STEPS), 1, DIST_STEPS,
                    log_every=DIST_STEPS, schedule=sched, world_size=mesh.size)

    _, s, launches, comm = counted(timed_steps)
    info["train"] = dict(step_ms=s / DIST_STEPS * 1e3,
                         samples_per_s=mesh.size * TRAIN_BATCH * DIST_STEPS / s,
                         collective_ms_per_step=comm["seconds"] / DIST_STEPS * 1e3,
                         collectives_per_step=comm["calls"] / DIST_STEPS,
                         collective_mb_per_step=comm["bytes"] / DIST_STEPS / 1e6,
                         losses=[float(x) for x in losses], launches=launches)
    del theads, step
    for name, dtype in DIST_DTYPES.items():
        th, _, _, st = _train_setup(clip_params, heads, db, dev, dtype=dtype, retriever=retr,
                                    grad_scale=1 / mesh.size, mesh=mesh)
        loss, grad = step_reading(st, th, local)
        info[f"reading_{name}_loss"] = loss
        arrays[f"grad_{name}"] = grad.numpy()
        del th, st
        torch.cuda.empty_cache()

    # a device-ranked CIRR sweep epoch, batches split over the ranks
    split = cirr_split(11)
    ctx = ev.EvalContext(clip_params, VIT_L_14, retr, image_branch=str(workdir / "image_branch"),
                         text_branch=str(workdir / "text_branch"),
                         compute_dtype=torch.bfloat16, eval_ranking="device",
                         split_id=SPLIT_ID, mesh=mesh)
    real, topk = ev._ranked, []

    def ranked_kept(*args):
        topk.extend(real(*args))
        return topk[-3:]

    ev._ranked = ranked_kept
    try:
        tables, s, launches, comm = counted(
            lambda: ev.evaluate_cirr(ctx, split.queries, split.corpus, epochs=[1]))
    finally:
        ev._ranked = real
    info["eval"] = dict(seconds=s, walls=dict(ev.last_cirr_walls), launches=launches,
                        collectives=comm,
                        tables={k: tables[(1, k)] for k in ("composed", "image", "mixture")})
    for key, idx in zip(("composed", "image", "mixture"), topk):
        arrays[f"eval_{key}"] = idx
    info["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    np.savez(workdir / f"rank{mesh.rank}.npz", **arrays)
    (workdir / f"rank{mesh.rank}.json").write_text(json.dumps(info))


def run_dist_ranks(workdir: pathlib.Path) -> list:
    """DIST_RANKS children ``chip_smoke.py dist-rank``, gloo over a free
    localhost port, each joined with a timeout; a rank that fails or runs
    past DIST_TIMEOUT_S stops every rank and fails the phase with their
    output's tail.  Returns each rank's (info, arrays)."""
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        url = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
    procs, logs = [], []
    for r in range(DIST_RANKS):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(DIST_RANKS), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(DIST_RANKS))
        logs.append(open(workdir / f"rank{r}.log", "w"))
        procs.append(subprocess.Popen([sys.executable, str(pathlib.Path(__file__).resolve()),
                                       "dist-rank", str(workdir), url], env=env,
                                      stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + DIST_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=60)
        for log in logs:
            log.close()
    if any(p.returncode for p in procs):
        tails = "\n".join(f"--- rank {r} (exit {p.returncode})\n"
                          f"{(workdir / f'rank{r}.log').read_text()[-4000:]}"
                          for r, p in enumerate(procs))
        raise AssertionError(f"dist_path: a rank failed or ran past {DIST_TIMEOUT_S} s\n{tails}")
    return [(json.loads((workdir / f"rank{r}.json").read_text()),
             dict(np.load(workdir / f"rank{r}.npz"))) for r in range(DIST_RANKS)]


def ties_apart(v1: np.ndarray, i1: np.ndarray, v2: np.ndarray, i2: np.ndarray,
               tie: float) -> tuple:
    """(entries whose rows differ between two rankings, how many of them are
    near-ties: the two rankings' scores at that place within ``tie``)."""
    diff = i1 != i2
    return int(diff.sum()), int((diff & (np.abs(v1 - v2) <= tie)).sum())


def dist_eval_gate(split, ref, topk2: dict) -> dict:
    """The 2-rank sweep epoch's tables against the 1-process device-ranked
    epoch 1: queries whose target position differs must differ only between
    entries whose (1-process host) scores lie within NEAR_TIE of the
    target's."""
    a, b = ref.feats
    mixture = a * 0.5 + b * 0.5
    mixture /= np.linalg.norm(mixture, axis=-1, keepdims=True)
    near, bad = 0, []
    for key, f, idx1 in zip(("composed", "image", "mixture"), (a, b, mixture), ref.topk):
        scores = f @ ref.corpus.T
        p1, p2 = device_positions(split, idx1), device_positions(split, topk2[key])
        for q in np.nonzero(p1 != p2)[0]:
            lo, hi = sorted((p1[q], p2[q]))
            kept = idx1[q][idx1[q] != split.ref[q]]
            window = kept[lo:hi + 1]
            if np.abs(scores[q, window] - scores[q, split.target[q]]).max() <= NEAR_TIE:
                near += 1
            else:
                bad.append(dict(key=key, query=int(q), one_process=int(p1[q]),
                                two_ranks=int(p2[q])))
    return dict(near_tie_queries=near, other_differences=bad[:10], n_other=len(bad),
                passes=not bad)


def dist_path(clip_params, heads, db, eval_ref, root: pathlib.Path) -> dict:
    """DIST_RANKS gloo ranks sharing cuda:0 (:func:`dist_rank`) against this
    process's card runs of the same work: the sharded serving's composed
    features (cosine) and DB neighbours, the sharded f32 ranking, one bf16
    and one f32 step of the global batch (loss, head-gradient cosine and norm)
    and the CIRR sweep's epoch-1 tables; the ranks' times, collectives and
    launches.  Returns rank 0's launches by path."""
    from keds_tpu_torch.engine import ComposedQueryEngine
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.ops.topk import mips_topk, mips_topk_int8, quantize_int8

    t = time.perf_counter()
    dev = db.image_db.device
    q = _unit_rows(QUERY_BATCH, VIT_L_14.embed_dim, torch.bfloat16, seed=DIST_SEED)
    q8, sc = quantize_int8(db.image_db)
    int8_1 = [a.cpu().numpy() for a in mips_topk_int8(q.float(), q8, sc, 16, db=db.image_db)]
    del q, q8, sc
    engine = ComposedQueryEngine(clip_params, VIT_L_14, heads, db, split_id=SPLIT_ID,
                                 device=dev)
    images, texts, corpus = dist_inputs()
    composed1 = engine.compose(images, texts)
    nb1 = neighbours(engine, images)
    del engine
    batch = dist_batch(dev)
    readings1 = {}
    for name, dtype in DIST_DTYPES.items():
        th, _, _, st = _train_setup(clip_params, heads, db, dev, dtype=dtype,
                                    grad_scale=1 / DIST_RANKS)
        readings1[name] = step_reading(st, th, batch)
        del th, st
    del batch
    write_branches(root, dev)
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t

    t = time.perf_counter()
    ranks = run_dist_ranks(root)
    ranks_s = time.perf_counter() - t
    (info, arrays), (info1, arrays1) = ranks
    agree = all(np.array_equal(arrays[k], arrays1[k]) for k in arrays) and (
        info["eval"]["tables"] == info1["eval"]["tables"])

    composed = arrays["composed"]
    cos = (composed * composed1).sum(1) / (np.linalg.norm(composed, axis=1)
                                           * np.linalg.norm(composed1, axis=1))
    nb = [ties_apart(v, i, arrays[f"nb{j}_vals"], arrays[f"nb{j}_idx"], DIST_NB_TIE)
          for j, (v, i) in enumerate(nb1)]
    # the sharded ranking against B1 over the whole corpus, the same queries
    with torch.inference_mode():
        v1, i1 = mips_topk(torch.from_numpy(composed).to(dev),
                           torch.from_numpy(corpus).to(dev), DIST_TOPN)
    rk = ties_apart(v1.cpu().numpy(), i1.cpu().numpy(), arrays["rank_vals"],
                    arrays["rank_idx"], NEAR_TIE)
    steps = {}
    for name, (l1, g1) in readings1.items():
        l2, g2 = info[f"reading_{name}_loss"], torch.from_numpy(arrays[f"grad_{name}"])
        rel, cosine = abs(l2 - l1) / abs(l1), float(g1 @ g2) / float(g1.norm() * g2.norm())
        # the cosine cannot see the gradient's size (a sum over the ranks
        # taken twice, a grad_scale lost): the norms' ratio can
        norm_rel = abs(float(g2.norm() / g1.norm()) - 1)
        rel_max, cos_min, norm_max = DIST_STEP_LIMITS[name]
        steps[name] = dict(loss_two_ranks=l2, loss_one_process=l1, loss_rel_diff=rel,
                           loss_rel_max=rel_max, head_grad_cosine=cosine,
                           head_grad_cosine_min=cos_min, head_grad_norm_rel_diff=norm_rel,
                           head_grad_norm_rel_max=norm_max,
                           passes=rel <= rel_max and cosine >= cos_min and norm_rel <= norm_max)
    gate = dist_eval_gate(eval_ref.split, eval_ref,
                          {k: arrays[f"eval_{k}"] for k in ("composed", "image", "mixture")})
    i8 = ties_apart(*int8_1, arrays["int8_vals"], arrays["int8_idx"], NEAR_TIE)
    by_rank = [{p: i[p]["launches"] for p in ("serving", "ranking", "int8", "train", "eval")}
               for i, _ in ranks]

    def launched(c):
        """Each path's kernels on a rank: B1 bf16_tc twice a query batch on
        its shard, B1 f32 once a ranked batch, B2 and B2' in the step."""
        return {"serving": c["serving"]["mips_topk"]["bf16_tc"] == 2 * N_QUERY_BATCHES
                and c["serving"]["attention"]["bf16_tc"] > 0,
                "ranking": c["ranking"]["mips_topk"]["f32"] == N_QUERY_BATCHES,
                "int8": c["int8"]["int8_mm"]["retrieval"] == 1
                and c["int8"]["mips_topk"]["bf16_tc"] == 0,
                "train": c["train"]["mips_topk"]["bf16_tc"] > 0
                and c["train"]["attention"]["bf16_tc"] > 0
                and c["train"]["attention_bwd"]["bf16"] > 0,
                "eval": c["eval"]["mips_topk"]["f32"] == 3
                and c["eval"]["mips_topk"]["bf16_tc"] == 2 * len(eval_ref.split.queries)}

    want = [launched(c) for c in by_rank]
    ok = dict(ranks_agree=agree, backend_gloo=info["backend"] == "gloo",
              shard_rows=info["shard_rows"] == -(-DB_ROWS // DIST_RANKS),
              feature_cosine=bool(np.isfinite(cos).all() and cos.min() >= DIST_FEATURE_COSINE_MIN),
              neighbours=all(n == near for n, near in nb), ranking=rk[0] == rk[1],
              int8_search=i8[0] == i8[1],
              steps=all(r["passes"] for r in steps.values()), eval=gate["passes"],
              launches=all(all(w.values()) for w in want))
    emit("dist_path", model="ViT-L/14", ranks=DIST_RANKS, device=info["device"],
         backend=info["backend"], transport="gloo over the host (shared card), not NCCL",
         db_rows=DB_ROWS, shard_rows=info["shard_rows"], queries=len(composed),
         query_batch=QUERY_BATCH, corpus_rows=DIST_CORPUS, train_batch_per_rank=TRAIN_BATCH,
         timed_steps=DIST_STEPS, reference_s=ref_s, ranks_s=ranks_s,
         rank_build_s=[i["build_s"] for i, _ in ranks],
         serving=info["serving"], ranking=info["ranking"],
         train={k: v for k, v in info["train"].items() if k != "launches"},
         train_rank1={k: info1["train"][k] for k in ("step_ms", "samples_per_s",
                                                     "collective_ms_per_step")},
         eval={k: v for k, v in info["eval"].items() if k != "launches"},
         peak_mem_gb=[i["peak_mem_gb"] for i, _ in ranks],
         feature_cosine_min=float(cos.min()), feature_cosine_limit=DIST_FEATURE_COSINE_MIN,
         neighbour_entries_differing=[n for n, _ in nb], neighbour_near_ties=[x for _, x in nb],
         ranking_entries_differing=rk[0], ranking_near_ties=rk[1],
         int8=dict(info["int8"], entries_differing=i8[0], near_ties=i8[1], k=16,
                   oversample=INT8_OVERSAMPLE),
         steps=steps,
         eval_gate=gate, eval_tables_one_process=eval_ref.tables, launches_by_rank=by_rank,
         launch_checks=want, checks=ok)
    if not all(ok.values()):
        raise AssertionError(f"dist_path checks failed: {ok}")
    return by_rank[0]


# --- graft_entry_torch.py: entry() and dryrun_multichip(n) ---------------------

ENTRY_CPU_ROWS = 2
# entry()'s card rows against the CPU's f32 with the CPU's mean of them taken
# out read 0.9990-0.9991 on the H100 (PERF.md); the control (each row's
# caption reversed, a token-order fault) read 0.46-0.55
ENTRY_CENTRED_MIN = 0.99
# one fn(*entry()): B2 in each of 24 vision and 12 text blocks, B1 on each table
ENTRY_WANT = {("attention", "bf16_tc"): 36, ("mips_topk", "bf16_tc"): 2,
              ("attention", "f32"): 0, ("attention_bwd", "bf16"): 0,
              ("attention_bwd", "f32"): 0, ("mips_topk", "f32"): 0}
DRYRUN_RANKS = 2
# a rank of the f32 dry run: B1 on both shards' tables in (a), for (b)'s
# indices, in (c) (k=16 and the captions' k=2) and in (d); B2 in the two
# text blocks of (a) and (b), twice in (c), and the two vision and two text
# blocks of (d); B2' in each of those train-step blocks
DRYRUN_WANT = {("mips_topk", "f32"): 8, ("attention", "f32"): 12,
               ("attention_bwd", "f32"): 8, ("mips_topk", "bf16_tc"): 0,
               ("attention", "bf16_tc"): 0, ("attention_bwd", "bf16"): 0}


def graft_entry_path(kernels) -> dict:
    """graft_entry_torch.py on the card.  fn(*entry()) once (ViT-L/14 bf16,
    a 16384-row DB, 8 zero images, prompts at S=32), launch counts zeroed
    just before and read just after, then three more calls timed; its first
    ENTRY_CPU_ROWS rows held to the same weights' f32 run on the CPU (cosine
    >= COSINE_MIN, centred cosine >= ENTRY_CENTRED_MIN, which the control,
    the card's rows with each caption reversed, must miss); unit rows.  Then
    dryrun_multichip(DRYRUN_RANKS), its ranks sharing cuda:0 over gloo: each
    rank's four lines and its launches.  Returns the launches by path."""
    import graft_entry_torch as ge
    from keds_tpu_torch.models.convert import cast_floating

    t = time.perf_counter()
    fn, args = ge.entry()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    for k in kernels.values():
        k.reset()
    t = time.perf_counter()
    with torch.inference_mode():
        out = fn(*args)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = {name: dict(k.launches) for name, k in kernels.items()}
    check_path_launches("graft_entry", launches, ENTRY_WANT)
    runs_ms = []
    with torch.inference_mode():
        for _ in range(3):
            t = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            runs_ms.append((time.perf_counter() - t) * 1e3)

    t = time.perf_counter()
    clip_params, heads, db_img, db_txt, images, text = args
    rows = slice(0, ENTRY_CPU_ROWS)
    reversed_caption = text[rows].clone()
    reversed_caption[:, 6:20] = reversed_caption[:, 6:20].flip(1)
    with torch.inference_mode():
        control = fn(clip_params, heads, db_img, db_txt, images[rows], reversed_caption)
        cpu = fn(*(cast_floating(a, torch.float32, "cpu")
                   for a in (clip_params, heads, db_img, db_txt)),
                 images[rows].float().cpu(), text[rows].cpu())
    card = out[rows]
    mean = cpu.double().mean(dim=0)
    cos, centred = _cosines(card, cpu), _cosines(card.double().cpu() - mean, cpu - mean)
    control_cos = _cosines(control, cpu)
    control_centred = _cosines(control.double().cpu() - mean, cpu - mean)
    norms = out.float().norm(dim=1)
    ok = dict(shape=tuple(out.shape) == (8, 768) and out.dtype == torch.bfloat16,
              finite=bool(torch.isfinite(out).all()),
              unit_rows=bool(((norms - 1).abs() <= 1e-2).all()),
              cosine=min(cos) >= COSINE_MIN,
              centred=min(centred) >= ENTRY_CENTRED_MIN > max(control_centred))
    check_s = time.perf_counter() - t
    del fn, args, out, control, cpu
    torch.cuda.empty_cache()

    t = time.perf_counter()
    ranks = ge.dryrun_multichip(DRYRUN_RANKS)
    dryrun_s = time.perf_counter() - t
    steps = ("image-stream step OK", "precomputed-neighbour step OK (bit-equal",
             "text-stream step OK", f"sharded composed-query OK, out ({4 * DRYRUN_RANKS}, 64)")
    for r in ranks:
        check_path_launches(f"graft_dryrun_rank{r['rank']}", r["launches"], DRYRUN_WANT)
    ok.update(dryrun_lines=all(
        len(r["lines"]) == len(steps) and all(
            ln.startswith(f"dryrun_multichip({DRYRUN_RANKS}): {s}")
            for ln, s in zip(r["lines"], steps)) for r in ranks),
        dryrun_bit_equal=all(r["losses"]["image"] == r["losses"]["neighbours"] for r in ranks),
        dryrun_on_card=all(r["device"] == "cuda:0" and r["backend"] == "gloo" for r in ranks))
    emit("graft_entry", model="ViT-L/14", dtype="bf16", db_rows=ge.ENTRY_DB_ROWS,
         batch=8, text_shape=list(text.shape), build_s=build_s, first_call_s=first_s,
         call_ms=runs_ms, cpu_rows=ENTRY_CPU_ROWS, cosine=cos, threshold=COSINE_MIN,
         centred_cosine=centred, centred_threshold=ENTRY_CENTRED_MIN,
         control="each row's caption reversed", control_cosine=control_cos,
         control_centred_cosine=control_centred, row_norms=norms.tolist(),
         check_s=check_s, launches=launches, dryrun_ranks=DRYRUN_RANKS, dryrun_s=dryrun_s,
         dryrun_lines=ranks[0]["lines"], dryrun_losses=[r["losses"] for r in ranks],
         dryrun_launches=[r["launches"] for r in ranks], checks=ok)
    if not all(ok.values()):
        raise AssertionError(f"graft_entry checks failed: {ok}")
    return {"entry": launches, "dryrun_rank0": ranks[0]["launches"]}


# --- bench_torch.py: the benchmark entry's modes at --quick ------------------

BENCH_QUICK_ROWS = 50_000      # bench.py's --quick DB
BENCH_ITERS = 2                # of --quick's 5: the whole run is near its time limit
BENCH_SERVE_KEYS = {"metric", "value", "unit", "vs_baseline"}
BENCH_TRAIN_KEYS = {"metric", "value", "unit", "method", "vs_baseline"}
# serving launches B1 and B2 and no backward; a train step B2' in each text
# block and B1 unless its neighbours are precomputed
BENCH_SERVE_LAUNCHES = ({("attention_bwd", "bf16"): 0, ("attention", "f32"): 0,
                   ("attention_bwd", "f32"): 0},
                  (("attention", "bf16_tc"), ("mips_topk", "bf16_tc")))
BENCH_TRAIN_LAUNCHES = ({}, (("attention_bwd", "bf16"), ("attention", "bf16_tc"),
                       ("mips_topk", "bf16_tc")))
# mode: (bench_torch.py's flags past --quick, its line's keys, (exact, positive) launches)
BENCH_MODES = {
    "headline": ([], BENCH_SERVE_KEYS, BENCH_SERVE_LAUNCHES),
    "latency": (["--latency"], BENCH_SERVE_KEYS | {"method", "curve"}, BENCH_SERVE_LAUNCHES),
    "train": (["--train"], BENCH_TRAIN_KEYS, BENCH_TRAIN_LAUNCHES),
    "train_text": (["--train", "--stream", "text"], BENCH_TRAIN_KEYS, BENCH_TRAIN_LAUNCHES),
    "train_neighbors": (["--train", "--neighbors"], BENCH_TRAIN_KEYS,
                        ({("mips_topk", v): 0 for v in ("bf16_tc", "f32", "bf16")},
                         BENCH_TRAIN_LAUNCHES[1][:2])),
    "train_raw": (["--train", "--raw"], BENCH_TRAIN_KEYS, BENCH_TRAIN_LAUNCHES)}


def bench_entry_path(clip_params, heads, db, kernels) -> dict:
    """bench_torch.py's six BENCH_MODES at --quick in this process, on the
    main path's weights and the first BENCH_QUICK_ROWS rows of its DB (built
    once, handed to each mode), each mode's launch counts zeroed just
    before and read just after.  Returns the launches by mode."""
    import io

    import bench_torch
    from keds_tpu_torch.retrieval.database import KnowledgeDB

    n = BENCH_QUICK_ROWS
    built = (clip_params, heads, KnowledgeDB(db.image_db[:n], db.text_db[:n], db.names[:n]))
    by_mode = {}
    for mode, (extra, keys, (want, positive)) in BENCH_MODES.items():
        argv = ["--quick", "--iters", str(BENCH_ITERS), *extra]
        out = io.StringIO()
        for k in kernels.values():
            k.reset()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            bench_torch.run(argv, built=built)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
        launches = by_mode[mode] = {name: dict(k.launches) for name, k in kernels.items()}
        check_path_launches(f"bench_{mode}", launches, want, positive)
        lines = out.getvalue().splitlines()
        line = json.loads(lines[0]) if len(lines) == 1 else {}
        values = [line.get("value")]
        if mode == "latency":
            values += [v for point in line.get("curve", {}).values() for v in point.values()]
        ok = dict(one_line=len(lines) == 1, keys=set(line) == keys,
                  value=all(isinstance(v, (int, float)) and np.isfinite(v) and v > 0
                            for v in values))
        emit("bench_entry", mode=mode, argv=argv, db_rows=n, line=line, wall_s=wall_s,
             launches=launches, checks=ok)
        if not all(ok.values()):
            raise AssertionError(f"bench_entry {mode} checks failed: {ok} {lines}")
        torch.cuda.empty_cache()
    return by_mode


# --- int8 retrieval and the W8A8 towers (ROADMAP items 14 and 15) ------------

INT8_PEAK_OPS = 1979e12   # H100 SXM dense int8 tensor-core rate (NVIDIA data sheet)
INT8_SLICE = 50_000       # quantize_int8: card vs CPU bit for bit on this many rows
INT8_OVERSAMPLE = 4
QUANT_CHECK_QUERIES = 4
# quant_check: the int8 towers' composed features against the card's bf16
# towers and the CPU's f32 int8 towers, cosine after the f32 batch mean is
# taken out (random ViT-L/14 features are nearly collinear, PERF.md); the
# control (each int8 weight's scales permuted across its output channels)
# must stay below the limit in the same run
QUANT_CENTRED_MIN = {"int8_vs_bf16": 0.8, "int8_vs_cpu_int8": 0.9}
QUANT_LINEAR_ROWS = 16 * 257   # one 16-image vision chunk's tokens
QUANT_LINEAR_CPU_ROWS = 2 * 257


def int8_search_row(q, q8, sc, db, k) -> dict:
    """mips_topk_int8 (true-row re-rank) on the card against its plain
    version (the stage-1 product in float64) on the same inputs: indices
    equal but for near-ties (re-ranked scores within NEAR_TIE), values, the
    top-k overlap with B1's exact search, times and the bound."""
    from keds_tpu_torch.ops.quant import INT8_MM
    from keds_tpu_torch.ops.topk import mips_topk, mips_topk_int8

    B, D = q.shape
    N = q8.shape[0]
    qf = q.float()
    before = INT8_MM.launches["retrieval"]
    vals, idx = mips_topk_int8(qf, q8, sc, k, INT8_OVERSAMPLE, db=db)
    launches = INT8_MM.launches["retrieval"] - before
    pv, pi = mips_topk_int8(qf, q8, sc, k, INT8_OVERSAMPLE, db=db, plain=True)
    ei = mips_topk(q, db, k)[1]
    torch.cuda.synchronize()
    differ = idx != pi
    near = differ & ((vals - pv).abs() <= NEAR_TIE)
    err = (vals - pv).abs().max().item()
    overlap = float(np.mean([len(set(a) & set(b)) / k for a, b in
                             zip(idx.cpu().tolist(), ei.cpu().tolist())]))
    # inputs read once (int8 DB, its scales, the queries, the candidates'
    # true rows), the output written once; 2 B N D int8 operations
    nbytes = N * D + N * 4 + B * D * 4 + B * k * INT8_OVERSAMPLE * D * db.element_size() \
        + B * k * 8
    ops = 2 * B * N * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_PEAK_OPS
    # the (B, N) int32 scores and their f32 copy, written and read once each
    materialized = (nbytes + 2 * 2 * B * N * 4) / HBM_BYTES_PER_S
    row = dict(shape=[B, N, D, k], oversample=INT8_OVERSAMPLE, rerank="true rows",
               max_abs_err=err, tol=NEAR_TIE, entries_differing=int(differ.sum()),
               near_ties=int(near.sum()), b1_exact_overlap=overlap,
               kernel_ms=time_ms(lambda: mips_topk_int8(qf, q8, sc, k, INT8_OVERSAMPLE,
                                                         db=db)),
               plain_ms=time_ms(lambda: mips_topk_int8(qf, q8, sc, k, INT8_OVERSAMPLE,
                                                        db=db, plain=True), iters=3),
               b1_bf16_ms=time_ms(lambda: mips_topk(q, db, k)),
               int_mm_ms=time_ms(lambda: torch._int_mm(
                   torch.zeros((max(B, 17), D), dtype=torch.int8, device=DEV), q8.T)),
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bound_ms_scores_materialized=max(materialized, t_ops) * 1e3,
               launches=launches)
    if int(differ.sum()) != int(near.sum()) or not err <= NEAR_TIE:
        raise AssertionError(f"int8 search {B, N, D, k}: {int(differ.sum())} entries differ "
                             f"from the plain version, {int(near.sum())} near-ties; "
                             f"max_abs_err {err}")
    return row


def int8_retrieval(db) -> list:
    """The int8 backend over the main path's 0.5M x 768 bf16 DB (image
    table): quantize_int8 on the card against the CPU bit for bit on an
    INT8_SLICE-row slice, then mips_topk_int8 against its plain version at
    the serving and train batches (k = 16), the caption neighbours (k = 2),
    rows padded for torch._int_mm (B = 17 and 1 over 4096 rows) and
    duplicated rows (index for index, ties to the lower row)."""
    from keds_tpu_torch.ops.topk import mips_topk_int8, quantize_int8

    t = time.perf_counter()
    part = db.image_db[:INT8_SLICE]
    c8, csc = quantize_int8(part)
    p8, psc = quantize_int8(part.cpu())
    quant_equal = bool(torch.equal(c8.cpu(), p8) and torch.equal(csc.cpu(), psc))
    q8, sc = quantize_int8(db.image_db)
    quantize_ms = time_ms(lambda: quantize_int8(db.image_db), iters=3)
    emit("int8_quantize", rows=DB_ROWS, dim=db.dim, slice_rows=INT8_SLICE,
         card_equals_cpu=quant_equal, quantize_ms=quantize_ms,
         quantize_bound_ms=(DB_ROWS * db.dim * 3 + DB_ROWS * 4) / HBM_BYTES_PER_S * 1e3)
    if not quant_equal:
        raise AssertionError("quantize_int8 on the card differs from the CPU's")
    rows = []
    for B, k in ((QUERY_BATCH, 16), (TRAIN_BATCH, 16), (TRAIN_BATCH, 2)):
        q = _unit_rows(B, db.dim, torch.bfloat16, seed=B + k)
        rows.append(int8_search_row(q, q8, sc, db.image_db, k))
        emit("int8_retrieval", **rows[-1])
    small, s8, ssc = db.image_db[:4096], q8[:4096], sc[:4096]
    for B in (17, 1):
        q = _unit_rows(B, db.dim, torch.bfloat16, seed=B)
        rows.append(int8_search_row(q, s8, ssc, small, 16))
        emit("int8_retrieval", case="rows padded for torch._int_mm", **rows[-1])
    half = db.image_db[:2048]
    dup = torch.cat([half, half])
    d8, dsc = quantize_int8(dup)
    q = _unit_rows(QUERY_BATCH, db.dim, torch.bfloat16, seed=5)
    vals, idx = mips_topk_int8(q.float(), d8, dsc, 16, INT8_OVERSAMPLE, db=dup)
    pv, pi = mips_topk_int8(q.float(), d8, dsc, 16, INT8_OVERSAMPLE, db=dup, plain=True)
    torch.cuda.synchronize()
    pairs = bool(torch.equal(idx[:, 1::2], idx[:, 0::2] + 2048) and (idx[:, 0::2] < 2048).all())
    emit("int8_retrieval", case="every row twice", shape=[QUERY_BATCH, 4096, db.dim, 16],
         index_for_index=bool(torch.equal(idx, pi)), lower_row_first=pairs,
         seconds=time.perf_counter() - t)
    if not (torch.equal(idx, pi) and torch.equal(vals, pv) and pairs):
        raise AssertionError("int8 search over duplicated rows differs from the plain "
                             "version or does not keep the lower row first")
    del q8, sc, c8, p8
    torch.cuda.empty_cache()
    return rows


def int8_linear_rows() -> list:
    """int8_linear on a ViT-L/14 block's four GEMM shapes (a 16-image chunk's
    4112 tokens) on the card against the CPU on the same bf16 input, bit for
    bit; times beside the bf16 addmm of the same work and the bound."""
    from keds_tpu_torch.ops.quant import (INT8_MM, int8_linear, int8_matmul_plain,
                                          quantize_activations, quantize_weight)

    rows = []
    M = QUANT_LINEAR_ROWS
    gen = torch.Generator(device=DEV).manual_seed(70)
    for name, (K, N) in (("qkv_w", (1024, 3072)), ("out_w", (1024, 1024)),
                         ("fc_w", (1024, 4096)), ("proj_w", (4096, 1024))):
        x = torch.randn((M, K), generator=gen, device=DEV).to(torch.bfloat16)
        w = (torch.randn((K, N), generator=gen, device=DEV) * K ** -0.5).to(torch.bfloat16)
        b = (torch.randn((N,), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
        wq = quantize_weight(w)
        before = INT8_MM.launches["linear"]
        card = int8_linear(x, wq, b)
        launches = INT8_MM.launches["linear"] - before
        # each token is quantized alone, so the first QUANT_LINEAR_CPU_ROWS
        # rows of the card's result are the CPU's result on those rows
        n = QUANT_LINEAR_CPU_ROWS
        cpu = int8_linear(x[:n].cpu(), {k: v.cpu() for k, v in wq.items()}, b.cpu())
        torch.cuda.synchronize()
        equal = bool(torch.equal(card[:n].cpu(), cpu))
        err = (card[:n].cpu().float() - cpu.float()).abs().max().item()
        xq, xs = quantize_activations(x)

        def plain():
            acc = int8_matmul_plain(xq, wq["q"])
            return ((acc.float() * xs) * wq["s"] + b.float()).to(x.dtype)

        nbytes = M * K * 2 + K * N + N * 4 + N * 2 + M * N * 2
        ops = 2 * M * K * N
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_PEAK_OPS
        row = dict(weight=name, shape=[M, K, N], cpu_rows=n, card_equals_cpu=equal,
                   max_abs_err=err,
                   kernel_ms=time_ms(lambda: int8_linear(x, wq, b)),
                   plain_ms=time_ms(plain, iters=3),
                   int_mm_ms=time_ms(lambda: torch._int_mm(xq, wq["q"])),
                   bf16_addmm_ms=time_ms(lambda: torch.addmm(b, x, w)),
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bf16_bound_ms=max((M * K * 2 + K * N * 2 + N * 2 + M * N * 2)
                                     / HBM_BYTES_PER_S, ops / PEAK_FLOPS[torch.bfloat16]) * 1e3,
                   launches=launches)
        emit("int8_linear", **row)
        rows.append(row)
        if not equal:
            raise AssertionError(f"int8_linear {name} {M, K, N}: card differs from the CPU "
                                 f"by {err}")
    torch.cuda.empty_cache()
    return rows


def _scales_permuted(params: dict) -> dict:
    """A control: each int8 block weight with its scales permuted across its
    output channels (the int8 values kept), a quantizer fault that keeps
    every scale's statistics."""
    from keds_tpu_torch.ops.quant import is_quantized

    gen = torch.Generator().manual_seed(71)
    out = dict(params)
    for tower in ("visual", "text"):
        blocks = dict(params[tower]["blocks"])
        for key, w in blocks.items():
            if is_quantized(w):
                perm = torch.randperm(w["s"].shape[-1], generator=gen).to(w["s"].device)
                blocks[key] = {"q": w["q"], "s": w["s"][..., perm]}
        out[tower] = dict(params[tower], blocks=blocks)
    return out


def quant_path(clip_params, heads, db, cpu_clip, cpu_heads, cpu_db, kernels) -> dict:
    """ViT-L/14 serving with --quant-towers int8 and the int8 Retriever over
    the 0.5M DB (ComposedQueryEngine, 3 batches of 64; launch counts zeroed
    just before and read just after), the profile of one batch, the check
    of QUANT_CHECK_QUERIES composed queries against the card's bf16 towers
    and the CPU's f32 int8 run (centred cosines, with the control), and
    RN50's text tower quantized with its visual tower skipped."""
    import logging

    from keds_tpu_torch import synth
    from keds_tpu_torch.engine import ComposedQueryEngine
    from keds_tpu_torch.models import clip as mclip
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.ops.quant import INT8_MM, is_quantized, quantize_clip_blocks
    from keds_tpu_torch.retrieval.database import Retriever

    t = time.perf_counter()
    counted = {**kernels, "int8_mm": INT8_MM}
    engine = ComposedQueryEngine(clip_params, VIT_L_14, heads, db, split_id=SPLIT_ID,
                                 retriever=Retriever(db, "int8"), quant_towers="int8",
                                 device=DEV)
    torch.cuda.synchronize()
    run = serving_run("quant_path", engine, counted, seed=0, model="ViT-L/14",
                      quant_towers="int8", retrieval_backend="int8", db_rows=DB_ROWS,
                      build_s=time.perf_counter() - t,
                      want={**SERVING_WANT, ("mips_topk", "bf16_tc"): 0,
                            ("int8_mm", "retrieval"): 2 * N_QUERY_BATCHES},
                      positive=(("attention", "bf16_tc"), ("mips_topk", "f32"),
                                ("int8_mm", "linear")))
    profile_batch(engine, run.q_images[1], run.q_texts[1], run.dcorpus, phase="profile_quant",
                  groups=[("int8 GEMM (torch._int_mm)", ("imma", "i8", "int8", "s8"))])

    # the check: 4 queries, three ways
    tc = time.perf_counter()
    qi, qt = [run.q_images[0][:QUANT_CHECK_QUERIES]], [run.q_texts[0][:QUANT_CHECK_QUERIES]]
    int8_card = torch.from_numpy(engine.compose(qi, qt)).double()
    control = ComposedQueryEngine(_scales_permuted(engine.clip_c), VIT_L_14, heads, db,
                                  split_id=SPLIT_ID, retriever=engine.retriever, device=DEV)
    control_card = torch.from_numpy(control.compose(qi, qt)).double()
    del control
    bf16 = ComposedQueryEngine(clip_params, VIT_L_14, heads, db, split_id=SPLIT_ID, device=DEV)
    bf16_card = torch.from_numpy(bf16.compose(qi, qt)).double()
    del bf16
    cpu = ComposedQueryEngine(cpu_clip, VIT_L_14, cpu_heads, cpu_db, split_id=SPLIT_ID,
                              compute_dtype=torch.float32, device="cpu",
                              retriever=Retriever(cpu_db, "int8"), quant_towers="int8")
    int8_cpu = torch.from_numpy(cpu.compose(qi, qt)).double()
    del cpu
    mean = int8_cpu.mean(dim=0)
    readings = {
        "int8_vs_bf16": (_cosines(int8_card, bf16_card),
                         _cosines(int8_card - mean, bf16_card - mean),
                         _cosines(control_card - mean, bf16_card - mean)),
        "int8_vs_cpu_int8": (_cosines(int8_card, int8_cpu),
                             _cosines(int8_card - mean, int8_cpu - mean),
                             _cosines(control_card - mean, int8_cpu - mean))}
    check = {name: dict(cosine=c, centred_cosine=cc, control_centred_cosine=ctl,
                        centred_threshold=QUANT_CENTRED_MIN[name],
                        passes=min(cc) >= QUANT_CENTRED_MIN[name] > max(ctl))
             for name, (c, cc, ctl) in readings.items()}
    emit("quant_check", queries=QUANT_CHECK_QUERIES, checks=check,
         int8_feature_spread=feature_spread(int8_cpu.numpy()),
         seconds=time.perf_counter() - tc)
    if not all(c["passes"] for c in check.values()):
        raise AssertionError(f"quant_check: {check}")
    del engine
    torch.cuda.empty_cache()

    # RN50: the text tower quantized, the ModifiedResNet visual tower skipped
    cfg = synth.RN_CONFIGS["RN50"]
    rn = synth.init_clip(cfg, 30, torch.device(DEV), torch.bfloat16)
    seen = []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    logging.getLogger().addHandler(handler)
    try:
        rq = quantize_clip_blocks(rn)
    finally:
        logging.getLogger().removeHandler(handler)
    text = torch.from_numpy(prompt_batch(np.random.default_rng(72), 4)).long().to(DEV)
    with torch.inference_mode():
        tq = mclip.encode_text(rq, cfg, text)
        tb = mclip.encode_text(rn, cfg, text)
    rn_ok = dict(visual_kept=rq["visual"] is rn["visual"],
                 text_quantized=all(is_quantized(rq["text"]["blocks"][k])
                                    for k in ("qkv_w", "out_w", "fc_w", "proj_w")),
                 warning_seen=any("leaving it unquantized" in m for m in seen))
    emit("quant_rn50", model="RN50", checks=rn_ok, warning=seen[:1],
         text_int8_vs_bf16_cosine=_cosines(tq, tb))
    if not all(rn_ok.values()):
        raise AssertionError(f"quant_rn50: {rn_ok}")
    del rn, rq
    torch.cuda.empty_cache()
    return run.launches


def serve_quant(f, kernels, exact_out) -> dict:
    """The serve CLI with --quant-towers int8 --retrieval-backend int8 over
    the smoke files' 4096-image folder, SERVE_WIDE_QUERIES queries at --topn
    10 (launch counts zeroed just before and read just after); its top-10
    overlap with the exact bf16 run of the same queries (serve_path's
    --topn 300 file)."""
    from keds_tpu_torch.cli import serve
    from keds_tpu_torch.ops.quant import INT8_MM

    counted = {**kernels, "int8_mm": INT8_MM}
    for k in counted.values():
        k.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out_path = f.root / "served_int8.jsonl"
    with contextlib.redirect_stdout(sys.stderr):
        out = serve.main(_serve_args(f, out_path, f.wide_queries, 10)
                         + ["--quant-towers", "int8", "--retrieval-backend", "int8"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {n: dict(k.launches) for n, k in counted.items()}
    n_batches = -(-SERVE_WIDE_QUERIES // QUERY_BATCH)
    check_path_launches("serve --quant-towers int8 --retrieval-backend int8", launches,
                        {("mips_topk", "bf16_tc"): 0, ("mips_topk", "f32"): n_batches,
                         ("int8_mm", "retrieval"): 2 * n_batches},
                        [("attention", "bf16_tc"), ("int8_mm", "linear")])
    got, exact = served_results(out_path), served_results(exact_out)
    overlap = [len({r["name"] for r in g["results"]} & {r["name"] for r in e["results"][:10]})
               / 10 for g, e in zip(got, exact)]
    top1 = [g["results"][0]["name"] == e["results"][0]["name"] for g, e in zip(got, exact)]
    emit("serve_quant", queries=len(got), topn=10, corpus_images=out["corpus_images"],
         corpus_images_per_s=out["corpus_images"] / out["corpus_s"],
         queries_per_s=out["queries"] / out["queries_s"], wall_s=wall,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         top10_overlap_with_exact=float(np.mean(overlap)), top1_agree=float(np.mean(top1)),
         launches=launches)
    if len(got) != SERVE_WIDE_QUERIES or not all(len(g["results"]) == 10 for g in got):
        raise AssertionError("serve --quant-towers int8 output malformed")
    return launches


# --- the RN towers, ViT-L/14 at 336 px and the rest of the model surface ------

RN_FAMILY = ("RN101", "RN50x4", "RN50x16", "RN50x64")
RN_FAMILY_BATCH = 64   # encode images/s at this batch, or the largest that fits
RN_CHECK_IMAGES = 4
# rn_family: the least centred cosine (bf16 vs f32 with the f32 batch mean
# taken out of both) a model's sound tower must reach.  Each lies between
# the sound tower's reading and the control's (its 3x3 kernels transposed):
# random towers map noise images to nearly one direction, less so the
# shallower ones, so what tells images apart is a small part of each feature.
RN_CENTRED_MIN = {"RN101": 0.8, "RN50x4": 0.8, "RN50x16": 0.6, "RN50x64": 0.4}
VIT336_IMAGES = 4      # the CPU's f32 encode of ViT-L/14 at 577 tokens
VIT336_CHUNK = 16      # images/s of the card's encode at the serving chunk
# the card's f32 encode vs the CPU's (cosine, centred cosine): the same f32
# math in another order; B2 at TF32's precision (the control) misses them
# (PERF.md)
F32_COSINE_MIN = 1 - 1e-10
F32_CENTRED_MIN = 1 - 1e-7
SURFACE_ROWS = 2


def rn_path(kernels) -> dict:
    """RN50 at its published shapes (synthetic weights, BatchNorms
    calibrated; IM2TEXT 1024 -> 512 -> 512 -> 512, CrossFormers at 512)
    over a 0.5M x 1024 bf16 DB a modality: the serving run, the profile
    of one batch and the CPU f32 check of two queries."""
    from keds_tpu_torch import synth
    from keds_tpu_torch.engine import ComposedQueryEngine

    cfg = synth.RN_CONFIGS["RN50"]
    t = time.perf_counter()
    clip_params, heads, db = synth.build(cfg, db_rows=DB_ROWS, dtype=torch.bfloat16, seed=30,
                                         device=DEV)
    engine = ComposedQueryEngine(clip_params, cfg, heads, db, split_id=SPLIT_ID, device=DEV)
    torch.cuda.synchronize()
    run = serving_run("rn_path", engine, kernels, seed=31, model="RN50", db_rows=DB_ROWS,
                      db_dim=cfg.embed_dim, build_model_s=time.perf_counter() - t,
                      img2text=[cfg.embed_dim, 512, 512, cfg.transformer_width])
    profile_batch(engine, run.q_images[1], run.q_texts[1], run.dcorpus, phase="profile_rn",
                  groups=[("convolution (cuDNN)", ("conv", "fprop", "cudnn", "implicit"))])
    compose_check("rn_check", engine, cfg, clip_params, heads, db, run.q_images, run.q_texts)
    return run.launches


def _encode_rate(clip_params, cfg, batch: int) -> tuple:
    """(images/s, ms) of one bf16 encode of ``batch`` uint8 images (normalised
    on the card), the median of three after a warm-up."""
    from keds_tpu_torch.models import clip as mclip

    px = cfg.image_resolution
    gen = torch.Generator(device=DEV).manual_seed(batch)
    images = torch.randint(0, 256, (batch, px, px, 3), generator=gen, device=DEV,
                           dtype=torch.uint8)
    times = []
    with torch.inference_mode():
        for i in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            mclip.encode_image_chunked(clip_params, cfg, images, None)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
    ms = float(np.median(times[1:])) * 1e3
    return batch / ms * 1e3, ms


def _cosines(a: torch.Tensor, b: torch.Tensor) -> list:
    """Row cosines of two (rows, ...) tensors, each row flattened, in f64."""
    a, b = a.double().flatten(1).cpu(), b.double().flatten(1).cpu()
    return ((a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))).tolist()


def _kernels_transposed(tree):
    """``tree`` with every convolution kernel's H and W swapped: a converter
    fault (HWIO read as WHIO) that keeps each weight's statistics."""
    if isinstance(tree, dict):
        return {k: _kernels_transposed(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_kernels_transposed(v) for v in tree]
    return tree.transpose(2, 3) if torch.is_tensor(tree) and tree.dim() == 4 else tree


def rn_family() -> None:
    """RN101, RN50x4, RN50x16 and RN50x64, one at a time (synthetic weights
    at the published shapes): bf16 encode images/s at RN_FAMILY_BATCH (halved
    until it fits), peak memory, and the card's bf16 encode of
    RN_CHECK_IMAGES images against its own f32 encode (cuDNN TF32 off):
    cosine >= COSINE_MIN, and centred cosine >= RN_CENTRED_MIN[model], a
    limit the control (the bf16 tower with its kernels transposed) must
    stay below in the same run."""
    from keds_tpu_torch import synth
    from keds_tpu_torch.models import clip as mclip
    from keds_tpu_torch.models.convert import cast_floating
    from keds_tpu_torch.runtime import disable_tf32

    disable_tf32()
    for i, name in enumerate(RN_FAMILY):
        cfg = synth.RN_CONFIGS[name]
        t = time.perf_counter()
        p32 = synth.init_clip(cfg, 40 + i, torch.device(DEV), torch.float32)
        p16 = cast_floating(p32, torch.bfloat16, DEV)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats()
        batch = RN_FAMILY_BATCH
        while True:
            try:
                rate, ms = _encode_rate(p16, cfg, batch)
                break
            except torch.cuda.OutOfMemoryError:
                if batch == 1:
                    raise
                batch //= 2
                torch.cuda.empty_cache()
        peak = torch.cuda.max_memory_allocated() / 1e9
        px = cfg.image_resolution
        x = torch.randn((RN_CHECK_IMAGES, px, px, 3),
                        generator=torch.Generator(device=DEV).manual_seed(i), device=DEV)
        with torch.inference_mode():
            f32 = mclip.encode_image(p32, cfg, x)
            bf16 = mclip.encode_image(p16, cfg, x)
            control = mclip.encode_image(
                dict(p16, visual=_kernels_transposed(p16["visual"])), cfg, x)
        cos = _cosines(bf16, f32)
        mean = f32.mean(dim=0)
        centred = _cosines(bf16 - mean, f32 - mean)
        control_centred = _cosines(control - mean, f32 - mean)
        limit = RN_CENTRED_MIN[name]
        emit("rn_family", model=name, resolution=px, vision_layers=list(cfg.vision_layers),
             vision_width=cfg.vision_width, pool_tokens=(px // 32) ** 2 + 1,
             embed_dim=cfg.embed_dim, build_s=build_s, batch=batch,
             encode_images_per_s=rate, encode_ms=ms, peak_mem_gb=peak,
             cudnn_tf32=torch.backends.cudnn.allow_tf32, bf16_vs_f32_cosine=cos,
             threshold=COSINE_MIN, centred_cosine=centred, centred_threshold=limit,
             control_cosine=_cosines(control, f32), control_centred_cosine=control_centred,
             f32_feature_spread=feature_spread(f32.cpu()))
        if torch.backends.cudnn.allow_tf32 or not min(cos) >= COSINE_MIN:
            raise AssertionError(f"rn_family {name}: bf16 vs f32 cosine {cos}")
        if not min(centred) >= limit > max(control_centred):
            raise AssertionError(f"rn_family {name}: centred cosine {centred}, control "
                                 f"{control_centred}, limit {limit}")
        del p32, p16, x, f32, bf16, control, mean
        torch.cuda.empty_cache()


def _tf32_attention(q, k, v, causal=False):
    """B2 on q, k and v with their low 13 mantissa bits cleared: attention
    at TF32's precision, the control of the f32 encode gates."""
    from keds_tpu_torch.ops.attention import attention

    def cut(x):
        return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)

    return attention(cut(q), cut(k), cut(v), causal)


def f32_encode_check(phase: str, params, cfg, x, cpu, kernels) -> dict:
    """The card's f32 encode (``--precision fp32``: B2 in f32 in every
    block, launch counts zeroed just before and read just after) of the
    uint8 images ``x`` against the CPU's f32 encode ``cpu``: each cosine, and
    each centred cosine (the CPU batch mean taken out of both), at least
    F32_COSINE_MIN and F32_CENTRED_MIN, which the control (the same encode
    with B2's inputs cut to TF32) must miss.  Returns the launches."""
    from unittest import mock

    from keds_tpu_torch.models import clip as mclip, layers
    from keds_tpu_torch.models.convert import cast_floating
    from keds_tpu_torch.runtime import disable_tf32

    t = time.perf_counter()
    disable_tf32()
    p32 = cast_floating(params, torch.float32, DEV)
    for k in kernels.values():
        k.reset()
    with torch.inference_mode():
        card = mclip.encode_image_chunked(p32, cfg, x.to(DEV), None)
    torch.cuda.synchronize()
    launches = {name: dict(k.launches) for name, k in kernels.items()}
    with torch.inference_mode(), mock.patch.object(layers, "attention", _tf32_attention):
        control = mclip.encode_image_chunked(p32, cfg, x.to(DEV), None)
    mean = cpu.mean(dim=0)
    cos, control_cos = _cosines(card, cpu), _cosines(control, cpu)
    centred = _cosines(card.cpu() - mean, cpu - mean)
    control_centred = _cosines(control.cpu() - mean, cpu - mean)
    emit(phase, model=f"ViT-L/14@{cfg.image_resolution}px", tokens=cfg.n_patches + 1,
         images=len(x), one_minus_cosine=[1 - c for c in cos],
         one_minus_centred=[1 - c for c in centred],
         control_one_minus_cosine=[1 - c for c in control_cos],
         control_one_minus_centred=[1 - c for c in control_centred],
         thresholds=[F32_COSINE_MIN, F32_CENTRED_MIN], launches=launches,
         seconds=time.perf_counter() - t)
    check_path_launches(phase, launches, {("attention", "f32"): cfg.vision_layers,
                                          ("attention", "bf16_tc"): 0})
    if not (min(cos) >= F32_COSINE_MIN and min(centred) >= F32_CENTRED_MIN):
        raise AssertionError(f"{phase}: card f32 vs CPU f32 cosine {cos}, centred {centred}")
    if min(control_cos) >= F32_COSINE_MIN and min(control_centred) >= F32_CENTRED_MIN:
        raise AssertionError(f"{phase}: the TF32 control passes: {control_cos}, "
                             f"{control_centred}")
    return launches


def vit336_check(kernels) -> tuple:
    """ViT-L/14 at 336 px (577 tokens, synthetic weights): the bf16 encode
    of a VIT336_CHUNK chunk timed, then VIT336_IMAGES images encoded on the
    card in bf16 (launch counts zeroed just before and read just after: B2
    bf16_tc at S = 577, one a block) and on the CPU in f32, cosine >=
    COSINE_MIN.  Then the card's f32 encode of the same images against the
    CPU's (:func:`f32_encode_check`).  Returns the two launch counts."""
    from keds_tpu_torch import synth
    from keds_tpu_torch.models import clip as mclip
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.models.convert import cast_floating

    t = time.perf_counter()
    cfg = dataclasses.replace(VIT_L_14, image_resolution=336)
    params = synth.init_clip(cfg, 50, torch.device(DEV), torch.bfloat16)
    rate, ms = _encode_rate(params, cfg, VIT336_CHUNK)
    x = torch.randint(0, 256, (VIT336_IMAGES, 336, 336, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(51))
    for k in kernels.values():
        k.reset()
    with torch.inference_mode():
        card = mclip.encode_image_chunked(params, cfg, x.to(DEV), None)
    torch.cuda.synchronize()
    launches = {name: dict(k.launches) for name, k in kernels.items()}
    cpu = mclip.encode_image_chunked(cast_floating(params, torch.float32, "cpu"), cfg, x, None)
    cos = _cosines(card, cpu)
    emit("vit336_check", model="ViT-L/14@336px", tokens=cfg.n_patches + 1,
         encode_images_per_s=rate, encode_ms=ms, chunk=VIT336_CHUNK, cosine=cos,
         threshold=COSINE_MIN, feature_spread=feature_spread(cpu), launches=launches,
         seconds=time.perf_counter() - t)
    check_path_launches("vit336_check", launches,
                        {("attention", "bf16_tc"): cfg.vision_layers, ("attention", "f32"): 0})
    if not min(cos) >= COSINE_MIN:
        raise AssertionError(f"vit336_check: cosine {cos} < {COSINE_MIN}")
    return launches, f32_encode_check("vit336_f32_check", params, cfg, x, cpu, kernels)


def vit224_f32_check(clip_params, cpu_clip, kernels) -> dict:
    """The main path's ViT-L/14 (224 px, 257 tokens) encoding VIT336_IMAGES
    images in f32 on the card against the CPU's f32 copy of the same weights
    (:func:`f32_encode_check`).  Returns the launches."""
    from keds_tpu_torch.models import clip as mclip
    from keds_tpu_torch.models.clip import VIT_L_14

    x = torch.randint(0, 256, (VIT336_IMAGES, 224, 224, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(53))
    cpu = mclip.encode_image_chunked(cpu_clip, VIT_L_14, x, None)
    return f32_encode_check("vit224_f32_check", clip_params, VIT_L_14, x, cpu, kernels)


def surface_path(clip_params, cpu_clip, kernels) -> dict:
    """The rest of the model surface at ViT-L/14 full width, SURFACE_ROWS
    rows each, on the card in bf16 (the main path's weights) and on the CPU
    in f32: each output's row cosine >= COSINE_MIN.  The visual-invert
    composition at mask_ratio 1 runs the vision blocks over the CLS token
    alone (B2 at S = 1, one a block); at 0.75 both devices keep the same
    64 patches (S = 65); the textual-invert feature runs the text blocks at
    S = 77.  Launch counts are zeroed just before each of these three and
    read just after."""
    from unittest import mock

    from keds_tpu_torch import synth
    from keds_tpu_torch.models import clip as mclip, heads as mheads
    from keds_tpu_torch.models.clip import VIT_L_14 as cfg
    from keds_tpu_torch.models.convert import cast_floating

    t = time.perf_counter()
    n, bf16, f32 = SURFACE_ROWS, torch.bfloat16, torch.float32
    rng = np.random.default_rng(60)
    px = cfg.image_resolution
    images = torch.from_numpy(rng.integers(0, 256, (n, px, px, 3), dtype=np.uint8))
    text = torch.from_numpy(prompt_batch(rng, n)).long()
    vis_text = text.clone()
    vis_text[1, 6] = SPLIT_ID          # row 1 has two stars: the token takes the first
    feats = torch.from_numpy(rng.standard_normal((n, cfg.embed_dim)).astype(np.float32))
    tokens = torch.from_numpy(rng.standard_normal((n, 5, cfg.transformer_width))
                              .astype(np.float32))
    vis_tok = torch.from_numpy(rng.standard_normal((n, cfg.transformer_width))
                               .astype(np.float32))
    noise = torch.from_numpy(rng.random((n, cfg.n_patches)))
    vis_cross = synth.init_crossformer(cfg.vision_width, cfg.embed_dim, 1, seed=61,
                                       device=torch.device("cpu"), dtype=f32)
    text_cross = synth.init_crossformer(cfg.transformer_width, cfg.transformer_width, 2,
                                        seed=62, device=torch.device("cpu"), dtype=f32)

    def masking(gen, x, ratio):        # the same noise on both devices
        return mclip.masking_from_noise(x, noise.to(x.device), ratio)

    def outputs(dev, dtype, params):
        vc, tc = cast_floating(vis_cross, dtype, dev), cast_floating(text_cross, dtype, dev)
        im = mclip.device_normalize(images.to(dev))
        cross = lambda q, k, v: mheads.crossformer_apply(vc, q, k, v)   # noqa: E731
        out, launches = {}, {}

        def counted(name, fn):
            for k in kernels.values():
                k.reset()
            out[name] = fn()
            launches[name] = {kn: dict(k.launches) for kn, k in kernels.items()}

        with torch.inference_mode(), mock.patch.object(mclip, "random_masking", masking):
            out["encode_image_tokens"] = mclip.encode_image_tokens(params, cfg, im)
            emb, mids = mclip.encode_image_mid_features(params, cfg, im)
            out["encode_image_mid_features"] = emb
            out["mid_features"] = mids.transpose(0, 1)           # rows first
            for ratio in (1.0, 0.75):
                counted(f"visual_composed_{ratio}", lambda: mclip.get_visual_composed_features(
                    params, cfg, feats.to(dev, dtype), im, cross, None, ratio))
            out["encode_text_img_vis"] = mclip.encode_text_img_vis(
                params, cfg, vis_text.to(dev), vis_tok.to(dev, dtype), SPLIT_ID)
            counted("get_text_mid_cross_feature", lambda: mclip.get_text_mid_cross_feature(
                params, cfg, text.to(dev), tokens.to(dev, dtype), tc, mheads.crossformer_apply))
            img, txt, _ = mclip.clip_forward(params, cfg, im, text.to(dev))
            out["clip_forward_image"], out["clip_forward_text"] = img, txt
        return out, {"mask_ratio_1": launches["visual_composed_1.0"],
                     "mask_ratio_0.75": launches["visual_composed_0.75"],
                     "text_mid_cross": launches["get_text_mid_cross_feature"]}

    card, launches = outputs(DEV, bf16, clip_params)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    cpu, _ = outputs("cpu", f32, cpu_clip)
    cos = {name: _cosines(card[name], cpu[name]) for name in cpu}
    mins = {name: min(c) for name, c in cos.items()}
    emit("surface_path", model="ViT-L/14", rows=n, min_cosine=mins, threshold=COSINE_MIN,
         shapes={name: list(a.shape) for name, a in card.items()},
         launches=launches, card_s=card_s, seconds=time.perf_counter() - t)
    for run, layers in (("mask_ratio_1", cfg.vision_layers),
                        ("mask_ratio_0.75", cfg.vision_layers),
                        ("text_mid_cross", cfg.transformer_layers)):
        check_path_launches(f"surface_path {run}", launches[run],
                            {("attention", "bf16_tc"): layers, ("attention", "f32"): 0})
    if min(mins.values()) < COSINE_MIN:
        raise AssertionError(f"surface_path: cosines {mins} < {COSINE_MIN}")
    return launches


# --- any D, the tools, --profile-dir and the artifact gate ---------------------

ANY_D_ROWS = 100_000       # the B1 rows and Retrievers at D off the kernels' steps
ANY_D_CASES = ((100, torch.float32), (96, torch.bfloat16), (1280, torch.bfloat16))
INT8_ANY_D = (32, 100, 4096)   # int8_matmul (M, K) x (K, N), K off torch._int_mm's 8
EXTRACT_BATCH = 256        # the JAX tool's default --batch-size
EXTRACT_CHECK_ROWS = 64
EXTRACT_TOL = 2e-2         # the JAX tool's own test tolerance (tests/test_data_tools.py)
PROFILE_BATCH = 128        # 4096 feature pairs: 32 steps, the window 10-20 inside
VALIDATE_IMAGES = 256      # a CIRR val tree of this many PNGs and as many queries
FULLSCALE_CIRR_EPOCHS = 1  # of the protocol's 30 sweep epochs a branch
FULLSCALE_COCO_ROWS = 2500     # half the protocol's val2017 split: the run's time limit
FULLSCALE_COCO_EPOCHS = 1  # of 25: the sweep's first two checkpoints
FULLSCALE_WORKERS = 8      # the eval CLI's decode threads (--workers)


def _separated_agree(idx, pv, pi, tol: float) -> bool:
    """Indices equal to the reference's ``pi`` wherever its score ``pv`` is
    apart from both neighbours by more than ``tol``."""
    idx, pv, pi = (torch.as_tensor(x).cpu() for x in (idx, pv, pi))
    gaps = (pv[:, :-1] - pv[:, 1:]).abs() > tol
    sep = torch.ones_like(pi, dtype=torch.bool)
    sep[:, :-1] &= gaps
    sep[:, 1:] &= gaps
    return bool(((idx == pi) | ~sep).all())


def any_depth_path(kernels) -> dict:
    """D off the kernels' steps through the entry points, launch and pad
    counts zeroed just before and read just after: the exact Retriever's
    neighbour search (both tables, 64 queries, k = 16) over an
    ANY_D_ROWS-row DB at each ANY_D_CASES width (B1 with D zero-padded, or
    B1's bf16 score route at 1280) against the plain version; int8_matmul at
    INT8_ANY_D exactly equal to its plain version; an int8 Retriever over
    a 4096 x 100 DB with the CPU's neighbours but for near-ties."""
    from keds_tpu_torch.ops.quant import INT8_MM, int8_matmul, int8_matmul_plain
    from keds_tpu_torch.ops.topk import mips_topk_plain
    from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever, unit_rows

    t = time.perf_counter()
    out, launches = {}, {}
    for D, dtype in ANY_D_CASES:
        table = _unit_rows(ANY_D_ROWS, D, dtype, seed=D)
        retr = Retriever(KnowledgeDB(table, table, [str(i) for i in range(ANY_D_ROWS)]))
        q = _unit_rows(QUERY_BATCH, D, torch.float32, seed=D + 1)
        for k in kernels.values():
            k.reset()
        img_idx, txt_idx = retr.neighbour_indices(q, 16)
        torch.cuda.synchronize()
        launches[f"D{D}"] = {**{n: dict(k.launches) for n, k in kernels.items()},
                             "mips_topk_pads": dict(kernels["mips_topk"].pads)}
        pv, pi = mips_topk_plain(unit_rows(q).to(dtype), table, 16)
        if not (torch.equal(img_idx, txt_idx) and _separated_agree(img_idx, pv, pi, TOPK_TOL)):
            raise AssertionError(f"any_depth D={D} {dtype}: neighbours differ from the plain "
                                 "version")
        out[f"D{D}"] = dict(dtype=str(dtype), idx_equal_share=float(
            (img_idx == pi).float().mean()), launches=launches[f"D{D}"]["mips_topk"],
            pads=launches[f"D{D}"]["mips_topk_pads"])
        del retr, table
        torch.cuda.empty_cache()
    M, K, N = INT8_ANY_D
    gen = torch.Generator(device=DEV).manual_seed(K)
    a = torch.randint(-127, 128, (M, K), generator=gen, device=DEV).to(torch.int8)
    b = torch.randint(-127, 128, (N, K), generator=gen, device=DEV).to(torch.int8).T
    INT8_MM.reset()
    got = int8_matmul(a, b)
    torch.cuda.synchronize()
    if not torch.equal(got, int8_matmul_plain(a, b)) or INT8_MM.pads["linear"] != 1:
        raise AssertionError(f"int8_matmul {INT8_ANY_D}: not equal to its plain version")
    out["int8_matmul"] = dict(shape=list(INT8_ANY_D), equal=True, pads=dict(INT8_MM.pads),
                              ms=time_ms(lambda: int8_matmul(a, b)),
                              plain_ms=time_ms(lambda: int8_matmul_plain(a, b)))
    rng = np.random.default_rng(100)
    img, txt = (rng.standard_normal((N, K)).astype(np.float32) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((QUERY_BATCH, K)).astype(np.float32))
    card = Retriever(KnowledgeDB.from_arrays(img, txt, dtype=torch.float32, device=DEV), "int8")
    cpu = Retriever(KnowledgeDB.from_arrays(img, txt, dtype=torch.float32, device="cpu"), "int8")
    INT8_MM.reset()
    agree = []
    for name in ("image", "text"):
        vals, idx = card.search(q.to(DEV), getattr(card.db, f"{name}_db"), 16, name)
        pv, pi = cpu.search(q, getattr(cpu.db, f"{name}_db"), 16, name)
        differ, near = ties_apart(vals.cpu().numpy(), idx.cpu().numpy(), pv.numpy(),
                                  pi.numpy(), NEAR_TIE)
        agree.append(differ == near)
    torch.cuda.synchronize()
    out["int8_retriever"] = dict(db=[N, K], depth=int(card.quant_arrays()[0][0].shape[1]),
                                 launches=dict(INT8_MM.launches), pads=dict(INT8_MM.pads),
                                 neighbours_equal_but_near_ties=all(agree))
    if not all(agree) or INT8_MM.pads["retrieval"] != 0 or INT8_MM.pads["queries"] != 2:
        raise AssertionError(f"int8 Retriever at D = {K}: {out['int8_retriever']}")
    emit("any_depth_path", seconds=time.perf_counter() - t, **out)
    return launches


# tests/test_api_surface.py's tiny config (a text tower of two 32-wide heads:
# the tuned kernels, bf16 at the heads' own width, the f32 backward on heads
# zero-padded to 64) and the same with two 160-wide heads (the wide-head
# kernels, f32 too: above its kernel's 128)
HEAD_WIDTH_CFGS = {"tiny": dict(embed_dim=64, image_resolution=32, vision_layers=2,
                                vision_width=64, vision_patch_size=16, transformer_width=64,
                                transformer_heads=2, transformer_layers=2)}
HEAD_WIDTH_CFGS["wide"] = dict(HEAD_WIDTH_CFGS["tiny"], transformer_width=320)
HEAD_WIDTH_DB_ROWS = 4096
# each path's counts: these exactly (a step's backward once a text layer),
# and those at least once
HEAD_WIDTH_WANT = {
    "tiny": ({("attention", "bf16_wide"): 0, ("attention", "f32_wide"): 0,
              ("attention_bwd", "bf16_wide"): 0, ("attention_bwd", "f32_wide"): 0,
              ("attention_pads", "bf16_tc"): 0, ("attention_bwd", "bf16"): 2,
              ("attention_bwd_pads", "bf16"): 0, ("attention_bwd_pads", "f32"): 2},
             [("attention", "bf16_tc")]),
    "wide": ({("attention_pads", "bf16_tc"): 0, ("attention_bwd_pads", "bf16"): 0,
              ("attention_bwd_pads", "f32"): 0, ("attention_bwd", "bf16_wide"): 2,
              ("attention_bwd", "f32_wide"): 2},
             [("attention", "bf16_wide"), ("attention", "f32_wide")]),
}
PREPROCESS_SHAPE = (8, 480, 640, 3)    # a batch of VGA photos to 224 px
PREPROCESS_TOL = 1e-4    # normalised units: the card's resize sums in another order


def head_width_path(name: str, kernels) -> dict:
    """A HEAD_WIDTH_CFGS config through the entry points on the card: one
    bf16 ComposedQueryEngine batch of 64 composed queries (S=32 prompts)
    and a bf16 and an f32 image-stream train step (64 feature pairs, the
    card's neighbours fed to every step), launch and pad counts zeroed just
    before and read just after (HEAD_WIDTH_WANT); then the same on the CPU
    in f32 from the same weights: composed features at cosine >=
    COSINE_MIN, the bf16 step within train_check's limits, the f32 step
    within TRAIN_F32_LIMITS.  Returns the counts."""
    from keds_tpu_torch import synth
    from keds_tpu_torch.engine import ComposedQueryEngine
    from keds_tpu_torch.models.clip import ClipConfig
    from keds_tpu_torch.models.convert import cast_floating
    from keds_tpu_torch.ops.topk import mips_topk
    from keds_tpu_torch.retrieval.database import KnowledgeDB

    t = time.perf_counter()
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = ClipConfig(**HEAD_WIDTH_CFGS[name])
    clip_params, heads, db = synth.build(cfg, db_rows=HEAD_WIDTH_DB_ROWS, dtype=bf16, seed=31,
                                         device=DEV)
    rng = np.random.default_rng(32)
    px = cfg.image_resolution
    images = rng.integers(0, 256, (QUERY_BATCH, px, px, 3), dtype=np.uint8)
    texts = prompt_batch(rng, QUERY_BATCH)
    img, cap = synth.feature_pairs(QUERY_BATCH, cfg.embed_dim, seed=33, device=db.image_db.device)
    q = (img / img.norm(dim=1, keepdim=True)).to(bf16)
    inputs = (img, cap, [mips_topk(q, a, 16)[1] for a in (db.image_db, db.text_db)])
    engine = ComposedQueryEngine(clip_params, cfg, heads, db, split_id=SPLIT_ID, device=DEV)
    torch.cuda.synchronize()
    for k in kernels.values():
        k.reset()
    card = engine.compose([images], [texts])
    steps = {dt: train_reading(clip_params, heads, db, dt, inputs, cfg=cfg) for dt in (bf16, f32)}
    torch.cuda.synchronize()
    launches = {n: dict(k.launches) for n, k in kernels.items()}
    launches.update({f"{n}_pads": dict(kernels[n].pads) for n in ("attention", "attention_bwd")})
    check_path_launches(f"head_widths_{name}", launches, *HEAD_WIDTH_WANT[name])

    cpu_clip, cpu_heads = cast_floating(clip_params, f32, "cpu"), cast_floating(heads, f32, "cpu")
    cpu_db = KnowledgeDB(db.image_db.cpu().float(), db.text_db.cpu().float(), db.names)
    cpu = ComposedQueryEngine(cpu_clip, cfg, cpu_heads, cpu_db, split_id=SPLIT_ID,
                              compute_dtype=f32, device="cpu").compose([images], [texts])
    cos = (card * cpu).sum(1) / (np.linalg.norm(card, axis=1) * np.linalg.norm(cpu, axis=1))
    cpu_step = train_reading(cpu_clip, cpu_heads, cpu_db, f32, inputs, cfg=cfg)
    r16 = compare_readings(steps[bf16], cpu_step)
    r32 = compare_readings(steps[f32], cpu_step, TRAIN_F32_LIMITS, "f32")
    out = dict(config=HEAD_WIDTH_CFGS[name], text_head_width=cfg.transformer_width // 2,
               compose_min_cosine=float(cos.min()), cosine_min=COSINE_MIN, bf16_step=r16,
               f32_step=r32, launches=launches, seconds=time.perf_counter() - t)
    emit(f"head_widths_{name}", **out)
    if not (np.isfinite(cos).all() and cos.min() >= COSINE_MIN and r16["passes"]
            and r32["passes"]):
        raise AssertionError(f"head_widths_{name}: card vs CPU {out}")
    return launches


def empty_shape_check(kernels) -> None:
    """Empty shapes on the card, as keds_tpu answers them: top-k at k = 0
    and at no query through each tiling of B1 and through mips_topk, and B2
    and B2' at B * H = 0 (forward, backward and through autograd, bf16 and
    f32); each result of its shape, dtype and layout on the card, and no
    launch counted."""
    from keds_tpu_torch.ops import attention as att_mod, topk as topk_mod

    before = {n: (dict(k.launches), dict(k.pads)) for n, k in kernels.items()}
    grid = dict(topk_mod.GRID_LAUNCHES)
    checked = []
    for tiling in topk_mod.TILINGS:
        dtype = torch.bfloat16 if tiling.variant.startswith("bf16") else torch.float32
        db = _unit_rows(300, 128, dtype, seed=300)
        for b, k in ((4, 0), (0, 4), (0, 0)):
            q = _unit_rows(4, 128, dtype, seed=b)[:b]
            for vals, idx in (topk_mod.launch(q, db, k, tiling, 1), topk_mod.mips_topk(q, db, k)):
                if not (vals.shape == idx.shape == (b, k) and vals.device == idx.device == db.device
                        and (vals.dtype, idx.dtype) == (torch.float32, torch.int32)):
                    raise AssertionError(f"empty top-k {tiling} B={b} k={k}: {vals.shape} "
                                         f"{vals.dtype} {idx.shape} {idx.dtype}")
            checked.append(f"mips_topk code {tiling.code} B={b} k={k}")
    for B, H, S, Dh in ((0, 2, 5, 64), (2, 0, 77, 32), (0, 3, 300, 24), (0, 1, 9, 80)):
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.zeros((B, S, 3, H, Dh), device=DEV, dtype=dtype, requires_grad=True)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            out = att_mod.attention(q, k, v, True)
            grads = att_mod.attention_backward(q, k, v, out.detach(), True)
            out.sum().backward()
            # the card's result: a view of a (B, S, H, Dh) buffer
            want = torch.empty((B, S, H, Dh)).transpose(1, 2).stride() if qkv.is_cuda \
                else out.stride()
            if not (all(t.shape == (B, H, S, Dh) and t.device == qkv.device and t.dtype == dtype
                        for t in (out, *grads)) and out.stride() == want
                    and qkv.grad.shape == qkv.shape):
                raise AssertionError(f"empty attention {(B, H, S, Dh)} {dtype}")
            checked.append(f"attention {(B, H, S, Dh)} {str(dtype)[6:]}")
    torch.cuda.synchronize()
    after = {n: (dict(k.launches), dict(k.pads)) for n, k in kernels.items()}
    if after != before or topk_mod.GRID_LAUNCHES != grid:
        raise AssertionError(f"an empty shape launched or padded: {before} -> {after}")
    emit("empty_shapes", checked=checked, launches="none")


def preprocess_check() -> dict:
    """transforms.device_preprocess on a PREPROCESS_SHAPE uint8 batch on the
    card, held against the same call on the CPU within PREPROCESS_TOL."""
    from keds_tpu_torch.transforms import device_preprocess

    images = np.random.default_rng(34).integers(0, 256, PREPROCESS_SHAPE, dtype=np.uint8)
    on_card = torch.from_numpy(images).to(DEV)
    card = device_preprocess(on_card, 224, device=DEV)
    err = (card.cpu() - device_preprocess(images, 224, device="cpu")).abs().max().item()
    # eager calls on the card's uint8 batch (its CLIP constants are copied
    # in each call, which a CUDA graph cannot capture), host launches in
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        device_preprocess(on_card, 224, device=DEV)
    end.record()
    torch.cuda.synchronize()
    row = dict(shape=list(PREPROCESS_SHAPE), n_px=224, max_abs_err=err, tol=PREPROCESS_TOL,
               eager_ms=start.elapsed_time(end) / 20)
    emit("device_preprocess", **row)
    if not (tuple(card.shape) == (8, 224, 224, 3) and err <= PREPROCESS_TOL):
        raise AssertionError(f"device_preprocess card vs CPU: {row}")
    return row


def extract_features_path(f, kernels) -> dict:
    """``keds_tpu_torch.tools.extract_features`` over the SERVE_CORPUS JPEGs
    and their captions with the ViT-L/14 checkpoint (launch counts zeroed
    just before and read just after): images/s ("DB encode imgs/sec"), the
    names in folder order, and EXTRACT_CHECK_ROWS sampled rows of both
    arrays against a direct bf16 encode_image / encode_text of the same
    inputs (EXTRACT_TOL, each row closest to its own direct row).  Returns
    (launch counts, the output directory)."""
    import os

    from keds_tpu_torch.models import clip as mclip
    from keds_tpu_torch.models.convert import cast_floating
    from keds_tpu_torch.models.loader import load_clip
    from keds_tpu_torch.tokenizer import tokenize
    from keds_tpu_torch.tools.extract_features import main as extract
    from keds_tpu_torch.transforms import device_normalize

    out_dir = f.root / "features"
    for k in kernels.values():
        k.reset()
    stats = extract(["--images", str(f.corpus), "--captions", str(f.captions),
                     "--clip-weights", str(f.mlp), "--out", str(out_dir),
                     "--batch-size", str(EXTRACT_BATCH), "--workers", "8"])
    torch.cuda.synchronize()
    launches = {n: dict(k.launches) for n, k in kernels.items()}
    check_path_launches("extract_features", launches,
                        {("mips_topk", "bf16_tc"): 0, ("attention_bwd", "bf16"): 0},
                        positive=(("attention", "bf16_tc"),))
    names = json.loads((out_dir / "names.json").read_text())
    want_names = sorted(p.split(".")[0] for p in os.listdir(f.corpus))
    img_f = np.load(out_dir / "image_features.npy", mmap_mode="r")
    txt_f = np.load(out_dir / "text_features.npy", mmap_mode="r")
    rows = np.sort(np.random.default_rng(5).choice(len(names), EXTRACT_CHECK_ROWS,
                                                   replace=False))
    clip_params, cfg, _, t_val = load_clip(str(f.mlp), normalize_on_host=False, device=DEV)
    clip_c = cast_floating(clip_params, torch.bfloat16, DEV)
    del clip_params
    from PIL import Image

    caps = json.loads(f.captions.read_text())
    images = np.stack([t_val(Image.open(f.corpus / f"{names[r]}.jpg")) for r in rows])
    with torch.inference_mode():
        ref_img = mclip.encode_image(clip_c, cfg, device_normalize(
            torch.from_numpy(images).to(DEV))).float().cpu().numpy()
        ref_txt = mclip.encode_text(clip_c, cfg, torch.from_numpy(
            tokenize([caps[names[r]] for r in rows])).to(DEV)).float().cpu().numpy()
    del clip_c
    torch.cuda.empty_cache()

    def aligned(got, want):
        g = got / np.linalg.norm(got, axis=1, keepdims=True)
        w = want / np.linalg.norm(want, axis=1, keepdims=True)
        return bool((np.argmax(g @ w.T, axis=1) == np.arange(len(got))).all())

    got_img, got_txt = np.asarray(img_f[rows]), np.asarray(txt_f[rows])
    row = dict(images=stats["rows"], seconds=stats["seconds"],
               images_per_s=stats["images_per_s"], batch=EXTRACT_BATCH,
               names_in_folder_order=names == want_names,
               img_max_abs_err=float(np.abs(got_img - ref_img).max()),
               txt_max_abs_err=float(np.abs(got_txt - ref_txt).max()),
               rows_aligned=aligned(got_img, ref_img) and aligned(got_txt, ref_txt),
               tol=EXTRACT_TOL, launches=launches["attention"])
    emit("extract_features", **row)
    close = all(np.allclose(g, w, rtol=EXTRACT_TOL, atol=EXTRACT_TOL)
                for g, w in ((got_img, ref_img), (got_txt, ref_txt)))
    if not (close and row["rows_aligned"] and row["names_in_folder_order"]
            and stats["rows"] == SERVE_CORPUS):
        raise AssertionError(f"extract_features: {row}")
    return launches, out_dir


def profile_dir_path(f, features) -> dict:
    """The train CLI on ``features`` (extract_features' output: 32 steps of
    PROFILE_BATCH) over the 1000-row DB, with --profile-dir under build/
    and without: the trace exists, holds 11 train_step_e0 ranges (steps
    10-20), and its CUDA kernels include the port's own (B2, B2′, B1);
    the two runs' losses agree within TRAIN_LOSS_RTOL."""
    import glob
    import os

    from keds_tpu_torch.cli.main import main as train_main

    t = time.perf_counter()
    prof_dir = f.root / "profile"
    losses, walls = {}, {}
    for name, extra in (("traced", ["--profile-dir", str(prof_dir)]), ("plain", [])):
        t1 = time.perf_counter()
        train_main(["--train-data", str(features), "--dataset-type", "directory",
                    "--clip-weights", str(f.mlp), "--database-path", str(f.tiny_db),
                    "--batch-size", str(PROFILE_BATCH), "--epochs", "1", "--warmup", "2",
                    "--workers", "4", "--logs", str(f.root / "logs"),
                    "--name", f"profile_{name}", *extra])
        walls[name] = time.perf_counter() - t1
        scalars = (f.root / "logs" / f"profile_{name}" / "scalars.jsonl").read_text()
        losses[name] = [json.loads(x)["train/loss"] for x in scalars.splitlines()]
    files = glob.glob(str(prof_dir / "*.pt.trace.json"))
    events = json.loads(open(files[0]).read())["traceEvents"] if len(files) == 1 else []
    ranges = sum(e.get("name") == "train_step_e0" and e.get("cat") == "user_annotation"
                 for e in events)
    kernels_ev = [e for e in events if e.get("cat") == "kernel"]
    kernel_names = {e["name"] for e in kernels_ev}
    ours = {word: sorted(n for n in kernel_names if word in n)[:3]
            for word in ("attention_tc", "attention_bwd", "topk_")}
    # what the trace shows of the 11 steps: device ms by group, the steps'
    # host span, and the device's busy share of it
    steps = [e for e in events if e.get("name") == "train_step_e0"
             and e.get("cat") == "user_annotation"]
    span_us = (max(e["ts"] + e["dur"] for e in steps) - min(e["ts"] for e in steps)
               if steps else 0.0)
    groups = {"port_kernels": ("attention_tc", "attention_bwd", "topk_"),
              "gemm": GEMM_WORDS}
    device_ms = {g: 0.0 for g in (*groups, "other")}
    for e in kernels_ev:
        g = next((g for g, words in groups.items()
                  if any(w in e["name"].lower() for w in words)), "other")
        device_ms[g] += e.get("dur", 0.0) / 1e3
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(losses["traced"],
                                                              losses["plain"]))
    row = dict(trace_files=len(files), train_step_ranges=ranges, kernels_in_trace=ours,
               n_kernel_names=len(kernel_names), steps_span_ms=span_us / 1e3,
               device_ms_by_group=device_ms,
               device_busy_share=sum(device_ms.values()) / max(span_us / 1e3, 1e-9),
               losses=losses, loss_rel_diff=rel,
               loss_rtol=TRAIN_LOSS_RTOL, trace_mb=(os.path.getsize(files[0]) / 1e6
                                                    if files else 0.0),
               walls_s=walls, seconds=time.perf_counter() - t)
    emit("profile_dir", **row)
    if not (len(files) == 1 and ranges == 11 and all(ours.values())
            and len(losses["traced"]) == len(losses["plain"]) > 0 and rel <= TRAIN_LOSS_RTOL):
        raise AssertionError(f"--profile-dir: {row}")
    return row


def validate_path(f) -> dict:
    """``keds_tpu_torch.tools.validate_artifacts`` in CIRR mode on the card
    over a CIRR val tree of VALIDATE_IMAGES of the smoke JPEGs (as PNGs)
    and as many queries, the 0.5M DB and the ViT-L/14 checkpoint as both
    fixed streams, with --expected set to the port's eval CLI table on the
    same streams and files (epoch 1 of the sweep): it must return with
    parity_ok true."""
    from PIL import Image

    from keds_tpu_torch.cli.eval_retrieval import main as eval_main
    from keds_tpu_torch.evalkit import evaluators
    from keds_tpu_torch.tools.validate_artifacts import main as validate

    t = time.perf_counter()
    root = f.root / "cirr_data"
    base = root / "CIRR"
    for sub in ("dev", "captions", "image_splits"):
        (base / sub).mkdir(parents=True)
    names = [f"img{i:05d}" for i in range(VALIDATE_IMAGES)]
    for n in names:
        Image.open(f.corpus / f"{n}.jpg").save(base / "dev" / f"{n}.png")
    rng = np.random.default_rng(31)
    caps = [{"reference": names[q], "target_hard": names[int(rng.integers(VALIDATE_IMAGES))],
             "caption": caption(rng)} for q in range(VALIDATE_IMAGES)]
    (base / "captions" / "cap.rc2.val.json").write_text(json.dumps(caps))
    (base / "image_splits" / "split.rc2.val.json").write_text(
        json.dumps({n: f"dev/{n}.png" for n in names}))
    tables = []
    real = evaluators.evaluate_cirr

    def epoch_one(ctx, src, tgt, epochs=None):
        tables.append(real(ctx, src, tgt, epochs=[1]))
        return tables[-1]

    evaluators.evaluate_cirr = epoch_one
    try:
        eval_main(["--eval-mode", "cirr", "--resume", str(f.mlp), "--root-data", str(root),
                   "--database-path", str(f.db), "--image-branch", str(f.mlp),
                   "--text-branch", str(f.mlp), "--batch-size", str(QUERY_BATCH),
                   "--logs", str(f.root / "logs"), "--name", "validate_expected"])
    finally:
        evaluators.evaluate_cirr = real
    expected = {"cirr": {key: m for (_, key), m in tables[0].items()}}
    (f.root / "expected.json").write_text(json.dumps(expected))
    report = f.root / "report.json"
    t1 = time.perf_counter()
    validate(["--image-stream", str(f.mlp), "--text-stream", str(f.mlp),
              "--db-image", str(f.db / "image_db.npy"), "--db-text", str(f.db / "text_db.npy"),
              "--data-root", str(root), "--eval-mode", "cirr",
              "--batch-size", str(QUERY_BATCH), "--expected", str(f.root / "expected.json"),
              "--out", str(report)])
    rep = json.loads(report.read_text())
    row = dict(images=VALIDATE_IMAGES, queries=VALIDATE_IMAGES, parity_ok=rep["parity_ok"],
               table=rep["table"], expected=expected["cirr"], exit_code=0,
               validate_s=time.perf_counter() - t1, seconds=time.perf_counter() - t)
    emit("validate_artifacts", **row)
    if rep["parity_ok"] is not True or set(rep["table"]) != set(expected["cirr"]):
        raise AssertionError(f"validate_artifacts: {row}")
    return row


def batch_rows(n: int) -> list:
    """The row counts of the loader's batches of QUERY_BATCH over n rows."""
    return [min(QUERY_BATCH, n - i) for i in range(0, n, QUERY_BATCH)]


def encode_launches(rows: list) -> int:
    """B2 launches of the ViT-L/14 vision tower over batches of ``rows``
    images: one a layer a chunk (encode_image_chunked cuts a batch into
    chunks only where the chunk size divides it)."""
    from keds_tpu_torch.models import clip as mclip

    c = mclip.DEFAULT_ENCODE_CHUNK
    return mclip.VIT_L_14.vision_layers * sum(n // c if n > c and n % c == 0 else 1
                                              for n in rows)


def fullscale_want(launches: dict, image_rows: list, query_batches: int, epochs: int,
                   rank_f32: int) -> dict:
    """An eval CLI run's launches: B2 bf16_tc in the vision tower over the
    encoded images and in the 12-layer text tower twice a query batch an
    epoch (both branches), B1 bf16_tc twice a query batch (image and caption
    DB), B1 f32 ``rank_f32`` times, nothing else."""
    from keds_tpu_torch.models import clip as mclip

    want = {(name, v): 0 for name, counts in launches.items() for v in counts}
    want.update({("mips_topk", "f32"): rank_f32, ("mips_topk", "bf16_tc"): 2 * query_batches,
                 ("attention", "bf16_tc"): encode_launches(image_rows)
                 + mclip.VIT_L_14.transformer_layers * 2 * epochs * query_batches})
    return want


def fullscale_path(kernels, root: pathlib.Path) -> dict:
    """The two full-scale eval benches as a user runs them, each in a
    workdir under ``root``: bench_cirr_fullscale at the CIRR val protocol
    (4181 queries, 2297 PNGs at 224 px, the 0.5M x 768 DB, ViT-L/14 bf16,
    batches of 64) over FULLSCALE_CIRR_EPOCHS epochs, staged once, then
    device- and host-ranked, the two tables held to each other but for
    near-ties; then bench_coco_fullscale at FULLSCALE_COCO_ROWS rows over
    FULLSCALE_COCO_EPOCHS epoch, device-ranked.  Launch counts are zeroed
    just before and read just after each run and must equal what its
    batches give (all positive); the text buckets the prompts took are
    recorded."""
    import os

    from keds_tpu_torch.evalkit import evaluators as ev
    from keds_tpu_torch.tools import bench_cirr_fullscale, bench_coco_fullscale

    write_vocab(root / "merges.txt.gz")
    buckets = set()
    real_bucket = ev._bucket

    def bucket(text):
        out = real_bucket(text)
        buckets.add(out.shape[1])
        return out

    def run_tool(main, argv):
        for k in kernels.values():
            k.reset()
        ev._bucket = bucket
        try:
            with eval_capture() as run:
                run["rec"] = main(argv)    # ends with the tables on the host
        finally:
            ev._bucket = real_bucket
        run["launches"] = {n: dict(k.launches) for n, k in kernels.items()}
        return run

    out = dict(card=nvidia_smi(), model="ViT-L/14", dtype="bf16")
    wd = root / "cirr"
    argv = ["--workdir", str(wd), "--epochs", str(FULLSCALE_CIRR_EPOCHS),
            "--workers", str(FULLSCALE_WORKERS), "--device", DEV]
    t = time.perf_counter()
    bench_cirr_fullscale.main(argv + ["--build-only"])
    stage_s = time.perf_counter() - t
    runs = {r: run_tool(bench_cirr_fullscale.main, argv + ["--eval-ranking", r])
            for r in ("device", "host")}
    caps = json.loads((wd / "data" / "CIRR" / "captions" / "cap.rc2.val.json").read_text())
    index = {os.path.basename(p): i for i, p in enumerate(runs["host"]["names"])}
    split = SimpleNamespace(ref=np.array([index[c["reference"] + ".png"] for c in caps]),
                            target=np.array([index[c["target_hard"] + ".png"] for c in caps]))
    q_rows, c_rows = batch_rows(len(caps)), batch_rows(len(index))
    for r, run in runs.items():
        check_path_launches(f"fullscale_cirr_{r}", run["launches"],
                            fullscale_want(run["launches"], c_rows + q_rows, len(q_rows),
                                           FULLSCALE_CIRR_EPOCHS,
                                           3 * FULLSCALE_CIRR_EPOCHS if r == "device" else 0))
    gate = near_tie_gate(split, runs)
    out["cirr"] = dict(stage_s=stage_s, corpus_images=len(index), queries=len(caps),
                       text_buckets=sorted(buckets), gate=gate,
                       **{r: dict(line=run["rec"], launches=run["launches"])
                          for r, run in runs.items()})
    del runs

    wd = root / "coco"
    argv = ["--workdir", str(wd), "--rows", str(FULLSCALE_COCO_ROWS),
            "--epochs", str(FULLSCALE_COCO_EPOCHS), "--workers", str(FULLSCALE_WORKERS),
            "--device", DEV, "--eval-ranking", "device"]
    t = time.perf_counter()
    bench_coco_fullscale.main(argv + ["--build-only"])
    stage_s = time.perf_counter() - t
    buckets.clear()
    coco = run_tool(bench_coco_fullscale.main, argv)
    q_rows = batch_rows(FULLSCALE_COCO_ROWS)
    check_path_launches("fullscale_coco", coco["launches"],
                        fullscale_want(coco["launches"], q_rows + q_rows, len(q_rows),
                                       FULLSCALE_COCO_EPOCHS, 0))
    keys = {(j, k) for j in range(1, FULLSCALE_COCO_EPOCHS + 1)
            for k in ("composed", "image", "mixture")}
    tables = coco["tables"]
    ok = set(tables) == keys and all(np.isfinite(v) for m in tables.values() for v in m.values())
    out["coco"] = dict(stage_s=stage_s, rows=FULLSCALE_COCO_ROWS, text_buckets=sorted(buckets),
                       line=coco["rec"], launches=coco["launches"], tables_ok=ok)
    emit("fullscale_path", **out)
    if not ok:
        raise AssertionError(f"fullscale_path: COCO tables malformed: {tables}")
    if not gate["passes"]:
        raise AssertionError(f"fullscale_path: CIRR host and device rankings differ beyond "
                             f"near-ties at {gate['n_other']} queries: "
                             f"{gate['other_differences']}")
    return {"cirr_device": out["cirr"]["device"]["launches"],
            "cirr_host": out["cirr"]["host"]["launches"], "coco": coco["launches"]}


def full_sweeps() -> None:
    """The protocols' full sweeps with the benches' defaults (ViT-L/14
    bf16, batches of 64, 2 decode threads): bench_cirr_fullscale over 30
    epochs x 2 branches and bench_coco_fullscale over 25 epochs (50
    checkpoints), each staged once under build/ and run device- then
    host-ranked; each run's JSON line, then its launch counts and the
    staging's seconds."""
    import shutil

    from keds_tpu_torch.ops import attention as att_mod, topk as topk_mod
    from keds_tpu_torch.ops.cuda_build import build_all
    from keds_tpu_torch.tools import bench_cirr_fullscale, bench_coco_fullscale

    kernels = {"attention": att_mod.KERNEL, "attention_bwd": att_mod.BWD_KERNEL,
               "mips_topk": topk_mod.KERNEL}
    build_all(kernels.values())
    build = pathlib.Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        write_vocab(pathlib.Path(d) / "merges.txt.gz")
        for name, tool in (("cirr", bench_cirr_fullscale), ("coco", bench_coco_fullscale)):
            argv = ["--workdir", str(pathlib.Path(d) / name), "--device", DEV]
            t = time.perf_counter()
            tool.main(argv + ["--build-only"])
            emit(f"full_sweep_{name}_staging", seconds=time.perf_counter() - t)
            for ranking in ("device", "host"):
                for k in kernels.values():
                    k.reset()
                tool.main(argv + ["--eval-ranking", ranking])
                emit(f"full_sweep_{name}_{ranking}",
                     launches={n: dict(k.launches) for n, k in kernels.items()})
            shutil.rmtree(pathlib.Path(d) / name)
    print(nvidia_smi(), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["dist-rank"]:       # one rank of dist_path
        dist_rank(pathlib.Path(sys.argv[2]), sys.argv[3])
        return 0
    if sys.argv[1:2] == ["full-sweeps"]:     # outside the smoke run: the benches' sweeps
        full_sweeps()
        return 0
    from keds_tpu_torch import synth
    from keds_tpu_torch.engine import ComposedQueryEngine
    from keds_tpu_torch.models.clip import VIT_L_14
    from keds_tpu_torch.ops import attention as att_mod, topk as topk_mod
    from keds_tpu_torch.ops.cuda_build import build_all

    kernels = {"attention": att_mod.KERNEL, "attention_bwd": att_mod.BWD_KERNEL,
               "mips_topk": topk_mod.KERNEL}
    card = nvidia_smi()
    walls = Walls()
    t = time.perf_counter()
    build_all(kernels.values())
    ptxas = [ln.strip() for k in kernels.values() for ln in k.build_log.splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    emit("build", build_s=time.perf_counter() - t, card=card,
         torch=torch.__version__, cuda=torch.version.cuda, ptxas=ptxas)
    walls("build")

    bf16, f32 = torch.bfloat16, torch.float32
    att_rows = check_attention([(16, 16, 257, 64, bf16, False),    # vision chunk
                                (64, 12, 32, 64, bf16, True),      # text, S=32 bucket
                                (2, 4, 77, 64, f32, True),
                                (2 * TRAIN_BATCH, 12, 32, 64, bf16, True),  # text stream
                                # above 288 (K and V streamed): ViT-L/14 at 336 px
                                (16, 16, 577, 64, bf16, False),
                                (4, 12, 1025, 64, bf16, False),
                                (2, 4, 577, 64, f32, False),
                                (2, 4, 289, 64, f32, False),
                                (64, 8, 32, 64, bf16, True),       # RN50 text, S=32
                                # the model surface: the CLS token alone (mask
                                # ratio 1), 64 patches kept (0.75), text at 77
                                (2, 16, 1, 64, bf16, False),
                                (2, 16, 65, 64, bf16, False),
                                (2, 12, 77, 64, bf16, True),
                                # the eval benches' prompts at the S=77 bucket
                                (QUERY_BATCH, 12, 77, 64, bf16, True),
                                # --precision fp32: ViT-L/14 at 224 and 336 px,
                                # the text tower at S=77
                                (16, 16, 257, 64, f32, False), (16, 16, 577, 64, f32, False),
                                (64, 12, 77, 64, f32, True),
                                # the f32 paths' own shapes: the image step's prompt,
                                # the encodes of VIT336_IMAGES at 224 and 336 px
                                (TRAIN_BATCH, 12, 8, 64, f32, True),
                                (VIT336_IMAGES, 16, 257, 64, f32, False),
                                (VIT336_IMAGES, 16, 577, 64, f32, False),
                                # the bf16 336 px check's own shape (streamed)
                                (VIT336_IMAGES, 16, 577, 64, bf16, False),
                                # graft_entry: entry()'s vision blocks; the dry
                                # run's train-step prompt (a rank's 4 rows, one
                                # 64-wide head)
                                (8, 16, 257, 64, bf16, False),
                                (4, 1, 8, 64, f32, True),
                                # bench_entry: --latency at b1 (vision, text)
                                # and b32's text (its vision the 16-image chunk)
                                (1, 16, 257, 64, bf16, False),
                                (1, 12, 32, 64, bf16, True),
                                (32, 12, 32, 64, bf16, True),
                                # and its text stream's neighbour templates
                                # (bench.py's, EOT at 14: the S=16 bucket)
                                (2 * TRAIN_BATCH, 12, 16, 64, bf16, True)])
    bwd_rows = check_attention_bwd([(TRAIN_BATCH, 12, 8, 64, bf16, True),   # train prompt
                                    (64, 12, 16, 64, bf16, True),    # text buckets
                                    (64, 12, 32, 64, bf16, True),
                                    (64, 12, 77, 64, bf16, True),
                                    (2, 4, 77, 64, f32, True),
                                    (2 * TRAIN_BATCH, 12, 32, 64, bf16, True),
                                    # above 128: the streamed launches
                                    (4, 16, 257, 64, bf16, False),
                                    (4, 16, 577, 64, bf16, False),
                                    (2, 4, 289, 64, f32, False),
                                    # f32 training: the image stream's prompt, the
                                    # text stream's neighbour templates, S=577
                                    (TRAIN_BATCH, 12, 8, 64, f32, True),
                                    (2 * TRAIN_BATCH, 12, 32, 64, f32, True),
                                    (4, 16, 577, 64, f32, False),
                                    (4, 12, 1025, 64, bf16, False),   # streamed
                                    (4, 1, 8, 64, f32, True),    # graft_entry's dry run
                                    # bench_entry's text-stream templates
                                    (2 * TRAIN_BATCH, 12, 16, 64, bf16, True)])
    topk_rows = check_topk([(256, DB_ROWS, 768, 16, bf16),
                            (QUERY_BATCH, DB_ROWS, 768, 16, bf16),   # retrieval
                            (QUERY_BATCH, DB_ROWS // DIST_RANKS, 768, 16, bf16),  # a shard
                            (TRAIN_BATCH, DB_ROWS, 768, 16, bf16),   # train-step search
                            (QUERY_BATCH, 10_000, 768, 10, f32),
                            (QUERY_BATCH, N_CORPUS, 768, 10, f32),   # ranking
                            (TRAIN_BATCH, DB_ROWS, 768, 2, bf16),    # caption neighbours
                            (EVAL_QUERIES, EVAL_CORPUS, 768, 101, f32),   # CIRR ranking
                            (2048, 4096, 768, 100, f32),             # Fashion-IQ-like
                            (1024, 10_000, 768, 200, f32),           # ImageNet-like
                            (QUERY_BATCH, DB_ROWS, 768, 64, bf16),   # --db-topk 64
                            (QUERY_BATCH, 10_000, 768, 300, f32),    # k > 256
                            (QUERY_BATCH, DB_ROWS, 768, 300, bf16),
                            (8, 1000, 768, 1000, f32),               # k = N
                            (QUERY_BATCH, SERVE_CORPUS, 768, SERVE_WIDE_TOPN, f32),  # serve
                            (QUERY_BATCH, DB_ROWS, 1024, 16, bf16),  # RN50 retrieval
                            (QUERY_BATCH, N_CORPUS, 1024, 10, f32),  # RN50 ranking
                            # any D: padded to the step (f32 16, bf16 64), or
                            # bf16 above 1024 on the BF16 score route
                            *((QUERY_BATCH, ANY_D_ROWS, d, 16, dt) for d, dt in ANY_D_CASES),
                            # graft_entry: entry()'s search; the dry run's over a
                            # shard (both ranks' 8 queries, 64 rows of 64)
                            (8, 16384, 768, 16, bf16), (8, 64, 64, 16, f32),
                            # bench_entry over BENCH_QUICK_ROWS: the macro
                            # batch, --latency's b1 and b32, the train steps
                            # (k=16, and the text stream's captions at k=2)
                            *((B, BENCH_QUICK_ROWS, 768, k, bf16)
                              for B, k in ((256, 16), (1, 16), (32, 16), (TRAIN_BATCH, 16),
                                           (TRAIN_BATCH, 2)))])
    any_d_launches = any_depth_path(kernels)
    walls("kernel_rows")

    # --- every head width: B2 and B2' off Dh = 64 ------------------------------
    head_width_cases = [(4, 16, 257, 80, bf16, False), (4, 8, 77, 128, bf16, True),
                        (2, 4, 77, 256, f32, True),     # the wide-head kernels
                        (64, 2, 32, 32, bf16, True)]    # the tiny config's text, at Dh = 32
    # the shapes head_width_path gives the kernels: each config's engine
    # batch (S=32 prompts) and its train steps' prompts (S=8), bf16 and f32
    hw_path_cases = [(QUERY_BATCH, 2, 32, 160, bf16, True),
                     *((QUERY_BATCH, 2, 8, dh, dt, True) for dh in (160, 32) for dt in (bf16, f32))]
    # the main path's widths re-split into 128-wide heads (the same bytes as
    # their Dh = 64 rows in step 2): ViT-L/14's vision chunk, the text
    # tower's engine batch, the image stream's prompt, the neighbour templates
    wide128_fwd = [(16, 8, 257, 128, bf16, False), (QUERY_BATCH, 6, 32, 128, bf16, True),
                   (TRAIN_BATCH, 6, 8, 128, bf16, True)]
    wide128_bwd = [(TRAIN_BATCH, 6, 8, 128, bf16, True),
                   (2 * TRAIN_BATCH, 6, 32, 128, bf16, True)]
    # the f32 wide-head kernels at the same bytes: the vision chunk in
    # 256-wide heads, and the backward's prompt and templates in 128-wide ones
    wide_f32_fwd = [(16, 4, 257, 256, f32, False)]
    wide_f32_bwd = [(16, 4, 257, 256, f32, False), (TRAIN_BATCH, 6, 8, 128, f32, True),
                    (2 * TRAIN_BATCH, 6, 32, 128, f32, True)]
    hw_att_rows = check_attention(head_width_cases + hw_path_cases + wide128_fwd + wide_f32_fwd)
    hw_bwd_rows = check_attention_bwd(head_width_cases + hw_path_cases[1:] + wide128_bwd
                                      + wide_f32_bwd)
    hw_launches = {name: head_width_path(name, kernels) for name in HEAD_WIDTH_CFGS}
    empty_shape_check(kernels)
    preprocess_check()
    torch.cuda.empty_cache()
    walls("head_widths")

    # --- main path ---------------------------------------------------------
    t = time.perf_counter()
    clip_params, heads, db = synth.build(VIT_L_14, db_rows=DB_ROWS, dtype=bf16, seed=0)
    engine = ComposedQueryEngine(clip_params, VIT_L_14, heads, db, split_id=SPLIT_ID)
    torch.cuda.synchronize()
    run = serving_run("main_path", engine, kernels, seed=0, model="ViT-L/14",
                      db_rows=DB_ROWS, build_model_s=time.perf_counter() - t)
    launches = run.launches
    profile_batch(engine, run.q_images[1], run.q_texts[1], run.dcorpus)
    cpu_clip, cpu_heads, cpu_db = compose_check("e2e_check", engine, VIT_L_14, clip_params,
                                                heads, db, run.q_images, run.q_texts)
    del engine, run
    torch.cuda.empty_cache()
    walls("main_path")

    # --- int8 retrieval and the W8A8 towers ------------------------------------
    int8_rows = int8_retrieval(db)
    linear_rows = int8_linear_rows()
    quant_launches = quant_path(clip_params, heads, db, cpu_clip, cpu_heads, cpu_db, kernels)
    torch.cuda.empty_cache()
    walls("int8")

    # --- the RN towers, ViT-L/14 at 336 px, the rest of the model surface ----
    rn_launches = rn_path(kernels)
    torch.cuda.empty_cache()
    walls("rn_path")
    rn_family()
    walls("rn_family")
    vit336_launches, vit336_f32_launches = vit336_check(kernels)
    torch.cuda.empty_cache()
    walls("vit336_check")
    vit224_f32_launches = vit224_f32_check(clip_params, cpu_clip, kernels)
    torch.cuda.empty_cache()
    walls("vit224_f32_check")
    surface_launches = surface_path(clip_params, cpu_clip, kernels)
    torch.cuda.empty_cache()
    walls("surface_path")

    # --- training path ------------------------------------------------------
    theads, opt, step, batch, train_launches = train_path(clip_params, heads, db, kernels)
    profile_train(step, theads, batch)
    del theads, opt, step, batch
    walls("train_path")
    train_f32_launches = train_check(clip_params, heads, db, cpu_clip, cpu_heads, cpu_db,
                                     kernels)
    walls("train_check")

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
    walls("train_text")

    # --- evaluation path ------------------------------------------------------
    build = pathlib.Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        split, profile, corpus_dev, eval_launches, eval_ref = eval_path(
            clip_params, db, kernels, pathlib.Path(d))
        profile_eval(split, profile, corpus_dev)
    del split, profile, corpus_dev
    torch.cuda.empty_cache()
    walls("eval_path")

    # --- the serve and demo CLIs and raw-image training -----------------------
    with tempfile.TemporaryDirectory(dir=build) as d:
        files = write_smoke_files(pathlib.Path(d), clip_params, heads, db)
        emit("smoke_files", seconds=files.seconds, corpus_jpegs=SERVE_CORPUS,
             shards=len(files.shards), vocab="synthetic merges, '*' = 265")
        serve_launches = serve_path(files, kernels)
        serve_int8_launches = serve_quant(files, kernels, files.root / "served_wide.jsonl")
        demo_launches = demo_path(files, kernels)
        theads, step, batch, raw_launches = raw_train_path(files, clip_params, heads, db,
                                                           kernels)
        profile_train_raw(step, theads, batch)
        del theads, step, batch
        torch.cuda.empty_cache()
        raw_train_check(files, clip_params, heads, db, cpu_clip, cpu_heads, cpu_db)
        del cpu_clip, cpu_heads, cpu_db
        raw_cli_runs(files)
        torch.cuda.empty_cache()
        walls("cli_and_raw_train")
        extract_launches, features = extract_features_path(files, kernels)
        profile_dir_path(files, features)
        validate_path(files)
    walls("tools")

    # --- two ranks sharing the card over gloo ----------------------------------
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=build) as d:
        dist_launches = dist_path(clip_params, heads, db, eval_ref, pathlib.Path(d))
    walls("dist_path")

    # --- graft_entry_torch.py: entry() and the 2-rank dry run -------------------
    torch.cuda.empty_cache()
    graft_launches = graft_entry_path(kernels)
    walls("graft_entry")

    # --- bench_torch.py's six modes at --quick on the main path's weights --------
    torch.cuda.empty_cache()
    bench_launches = bench_entry_path(clip_params, heads, db, kernels)
    walls("bench_entry")

    # --- the full-scale CIRR and COCO eval benches ------------------------------
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=build) as d:
        fullscale_launches = fullscale_path(kernels, pathlib.Path(d))
    walls("fullscale_path")

    att = ("attention", "keds_tpu_torch/csrc/attention.cu", "keds_tpu/ops/attention.py:122")
    bwd = ("attention_bwd", "keds_tpu_torch/csrc/attention_bwd.cu",
           "keds_tpu/ops/attention.py:134")
    top = ("mips_topk", "keds_tpu_torch/csrc/topk.cu", "keds_tpu/ops/pallas_topk.py:93")
    # launches: the serving main path's, the image-stream training path's for
    # the backward, the f32 paths' for B2 and B2' in f32, the evaluation
    # path's for the f32 ranking at k = 101 and the serve CLI's --topn 300
    # run for the passes; each path's beside them
    entries = [(att, "bf16_tc", att_rows[0], launches),
               (bwd, "bf16", bwd_rows[0], train_launches),
               # the backward above 128 keys (two streamed launches a call)
               (bwd, "bf16_stream", bwd_rows[6], train_launches),
               (bwd, "bf16_stream", bwd_rows[7], train_launches),
               (bwd, "bf16_stream", bwd_rows[12], train_launches),
               # --precision fp32, each path beside its own shape: the f32
               # image-stream step's prompt and the f32 encodes at 224 and 336 px
               (att, "f32", att_rows[16], train_f32_launches),
               (bwd, "f32", bwd_rows[9], train_f32_launches),
               (att, "f32", att_rows[17], vit224_f32_launches),
               (att, "f32", att_rows[18], vit336_f32_launches),
               (top, "bf16_tc", topk_rows[1], launches),
               (top, "f32", topk_rows[7], eval_launches),
               (top, "bf16", topk_rows[10], launches),
               (top, "f32", topk_rows[14], serve_launches["serve_topn300"]),
               (top, "bf16", topk_rows[12], serve_launches["serve_topn300"]),
               (top, "f32", topk_rows[5], launches),    # the served corpus ranking
               # RN50's serving (the D = 1024 rows) and the streamed
               # attention above 288 keys (ViT-L/14 at 336 px: the bf16
               # check encodes VIT336_IMAGES images, its own row's shape)
               (att, "bf16_tc", att_rows[8], rn_launches),
               (top, "bf16_tc", topk_rows[15], rn_launches),
               (top, "f32", topk_rows[16], rn_launches),
               (att, "bf16_tc", att_rows[19], vit336_launches),
               (att, "bf16_tc", att_rows[9], surface_launches["mask_ratio_1"]),
               (att, "bf16_tc", att_rows[10], surface_launches["mask_ratio_0.75"]),
               (att, "bf16_tc", att_rows[11], surface_launches["text_mid_cross"]),
               # any D: the Retriever's searches at D = 100, 96 and 1280, and
               # the tool's encodes
               (top, "f32", topk_rows[17], any_d_launches["D100"]),
               (top, "bf16_tc", topk_rows[18], any_d_launches["D96"]),
               (top, "bf16", topk_rows[19], any_d_launches["D1280"]),
               (att, "bf16_tc", att_rows[0], extract_launches),
               # the full-scale CIRR bench's text tower at S=77
               (att, "bf16_tc", att_rows[12], fullscale_launches["cirr_device"]),
               # every head width, each path beside its own shapes: the wide
               # config's engine batch and bf16 and f32 train steps on the
               # wide-head kernels, the tiny config's on the tuned kernels at
               # Dh = 32 (the f32 backward on heads padded to 64)
               (att, "bf16_wide", hw_att_rows[4], hw_launches["wide"]),
               (att, "bf16_wide", hw_att_rows[5], hw_launches["wide"]),
               (att, "f32_wide", hw_att_rows[6], hw_launches["wide"]),
               # the f32 wide-head kernels' other rows, beside the path that
               # runs them: (2, 4, 77, 256) and the vision chunk in 256-wide heads
               (att, "f32_wide", hw_att_rows[2], hw_launches["wide"]),
               (att, "f32_wide", hw_att_rows[12], hw_launches["wide"]),
               (att, "bf16_tc", hw_att_rows[3], hw_launches["tiny"]),
               (att, "bf16_tc", hw_att_rows[7], hw_launches["tiny"]),
               (att, "f32", hw_att_rows[8], hw_launches["tiny"]),
               (bwd, "bf16_wide", hw_bwd_rows[4], hw_launches["wide"]),
               (bwd, "f32_wide", hw_bwd_rows[5], hw_launches["wide"]),
               (bwd, "f32_wide", hw_bwd_rows[2], hw_launches["wide"]),
               *((bwd, "f32_wide", hw_bwd_rows[i], hw_launches["wide"]) for i in (10, 11, 12)),
               (bwd, "bf16", hw_bwd_rows[3], hw_launches["tiny"]),
               (bwd, "bf16", hw_bwd_rows[6], hw_launches["tiny"]),
               (bwd, "f32", hw_bwd_rows[7], hw_launches["tiny"]),
               # graft_entry_torch.py: entry() in bf16, the dry run's rank 0 in f32
               (att, "bf16_tc", att_rows[20], graft_launches["entry"]),
               (top, "bf16_tc", topk_rows[20], graft_launches["entry"]),
               (att, "f32", att_rows[21], graft_launches["dryrun_rank0"]),
               (bwd, "f32", bwd_rows[13], graft_launches["dryrun_rank0"]),
               (top, "f32", topk_rows[21], graft_launches["dryrun_rank0"]),
               # bench_torch.py at --quick, each mode beside its own shapes
               (top, "bf16_tc", topk_rows[22], bench_launches["headline"]),
               (att, "bf16_tc", att_rows[0], bench_launches["headline"]),
               (att, "bf16_tc", att_rows[3], bench_launches["headline"]),
               (top, "bf16_tc", topk_rows[23], bench_launches["latency"]),
               (top, "bf16_tc", topk_rows[24], bench_launches["latency"]),
               (att, "bf16_tc", att_rows[22], bench_launches["latency"]),
               (att, "bf16_tc", att_rows[23], bench_launches["latency"]),
               (att, "bf16_tc", att_rows[24], bench_launches["latency"]),
               (top, "bf16_tc", topk_rows[25], bench_launches["train"]),
               (bwd, "bf16", bwd_rows[0], bench_launches["train"]),
               (top, "bf16_tc", topk_rows[26], bench_launches["train_text"]),
               (att, "bf16_tc", att_rows[25], bench_launches["train_text"]),
               (bwd, "bf16", bwd_rows[14], bench_launches["train_text"]),
               (bwd, "bf16", bwd_rows[0], bench_launches["train_neighbors"]),
               (att, "bf16_tc", att_rows[0], bench_launches["train_raw"]),
               (bwd, "bf16", bwd_rows[0], bench_launches["train_raw"])]
    # a row's own launch named its variant: it must be the one the entry
    # prints its times under
    wrong = [(name, variant, row["shape"], row["variant"])
             for (name, _, _), variant, row, _ in entries if row["variant"] != variant]
    if wrong:
        raise AssertionError(f"kernels line: rows timed on another variant {wrong}")
    paths = {"serving": launches, "rn_serving": rn_launches, "vit336": vit336_launches,
             "vit336_f32": vit336_f32_launches, "vit224_f32": vit224_f32_launches,
             "train_image_f32": train_f32_launches,
             **{f"surface_{p}": c for p, c in surface_launches.items()},
             "train_image": train_launches, "train_text": text_launches,
             "eval": eval_launches, "serve_cli": serve_launches["serve"],
             "serve_cli_topn300": serve_launches["serve_topn300"],
             "demo_mlp": demo_launches["mlp"], "demo_crossformer": demo_launches["crossformer"],
             "train_raw": raw_launches, "quant_serving": quant_launches,
             "serve_cli_int8": serve_int8_launches, "extract_features": extract_launches,
             **{f"any_depth_{p}": c for p, c in any_d_launches.items()},
             **{f"fullscale_{p}": c for p, c in fullscale_launches.items()},
             **{f"head_widths_{p}": c for p, c in hw_launches.items()},
             **{f"dist_{p}_rank0": c for p, c in dist_launches.items()},
             "graft_entry": graft_launches["entry"],
             "graft_entry_dryrun_rank0": graft_launches["dryrun_rank0"],
             **{f"bench_{m}": c for m, c in bench_launches.items()}}
    print(json.dumps({"kernels": [
        {"name": f"{name}/{variant}", "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name][variant], "max_abs_err": row["max_abs_err"],
         "ms": row["kernel_ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": row["library_ms"],
         **({"bound_fma_ms": row["bound_fma_ms"]} if "bound_fma_ms" in row else {}),
         "shape": row["shape"], "dtype": row["dtype"], "tiling": row.get("tiling"),
         **({"cuda_kernels_per_search": row["cuda_kernels"]} if "cuda_kernels" in row else {}),
         **({"padded_to": row["padded_to"], "pads": counts[f"{name}_pads"][variant],
             **({"pad_ms": row["pad_ms"]} if "pad_ms" in row else {})}
            if "padded_to" in row else {}),
         "launches_by_path": {p: c[name][variant] for p, c in paths.items()}}
        for (name, src, rep), variant, row, counts in entries]}), flush=True)
    emit("library_calls", note="int8 products of the int8 retrieval backend and the W8A8 "
         "towers: torch._int_mm (cuBLASLt), not TPU kernels; launches by path",
         int8_retrieval=[{k: r[k] for k in ("shape", "kernel_ms", "plain_ms", "b1_bf16_ms",
                                            "int_mm_ms", "bound_ms", "bound_by",
                                            "bound_ms_scores_materialized")}
                         for r in int8_rows],
         int8_linear=[{k: r[k] for k in ("weight", "shape", "kernel_ms", "plain_ms",
                                         "int_mm_ms", "bf16_addmm_ms", "bound_ms", "bound_by",
                                         "bf16_bound_ms")} for r in linear_rows],
         launches_by_path={p: c["int8_mm"] for p, c in paths.items() if "int8_mm" in c})
    emit("walls", seconds=walls.seconds, total_s=sum(walls.seconds.values()))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
