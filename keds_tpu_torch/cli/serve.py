"""Batch serving CLI (counterpart of ``keds_tpu/cli/serve.py``): rank a
folder of corpus images for a file of composed queries.

    python -m keds_tpu_torch.cli.serve \\
        --resume <ckpt.pt> --database-path <db> \\
        --target-data <corpus image dir> \\
        --query_file queries.jsonl --demo-out results.jsonl

``queries.jsonl``: one ``{"image": <path>, "text": "<prompt with *>"}`` per
line.  Output: one ``{"query", "text", "results": [{"name", "score"}, ...]}``
per line, ``--topn`` results each, written and flushed batch by batch;
the throughput summary goes to the log (stderr) and the output path to
stdout.  ``--resume`` is a reference-layout train checkpoint (CLIP and the
heads).  The prompts need the CLIP BPE vocab (``KEDS_TPU_BPE_VOCAB``).
Images are decoded with PIL on ``--workers`` threads (processes with
``--worker-processes``) and sent as uint8; the corpus is encoded in
``--batch-size`` batches (the ragged tail padded) and ranked on the device
once it has ``DEVICE_RANK_MIN_ROWS`` rows, on the host below that.  Runs on
the CUDA device unless ``--device cpu``.  ``--profile-dir`` writes a
``torch.profiler`` trace of the query batches 1-10 (all of them if there
are fewer), the engine's spans among its ranges
(:mod:`keds_tpu_torch.profiling`).

With ``--distributed`` every rank reads the same corpus and queries and
computes its block of each batch (``--db-shard`` splits the DB, and the
device-ranked corpus is split too); the results are the same on every rank
and rank 0 alone writes them.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

import numpy as np

# Corpora of at least this many rows rank on the device (the fused top-k in
# f32; only (B, topn) comes back); smaller ones rank on the host.
DEVICE_RANK_MIN_ROWS = 4096
# --profile-dir traces the first this many query batches.
PROFILE_BATCHES = 10


class _QueryDataset:
    """queries.jsonl rows -> (transformed image, prompt tokens)."""

    def __init__(self, queries, transform):
        self.queries = queries
        self.transform = transform

    def __len__(self):
        return len(self.queries)

    def __getitem__(self, i):
        from PIL import Image

        from keds_tpu_torch.tokenizer import tokenize

        q = self.queries[i]
        img = self.transform(Image.open(q["image"]))
        return img, np.asarray(tokenize(str(q.get("text", "a photo of *"))))[0]


def main(argv: Optional[list] = None) -> dict:
    """Serve the queries; returns the run's counts and walls (corpus and
    query images, seconds, where the ranking ran)."""
    from keds_tpu_torch.cli.common import run_logging
    from keds_tpu_torch.config import ORBAX_LEFT_OUT, parse_args

    cfg = parse_args(argv, prog="keds_tpu_torch.cli.serve")
    if not cfg.resume:
        raise SystemExit("--resume <checkpoint.pt> is required (heads + CLIP)")
    if os.path.isdir(cfg.resume):
        raise SystemExit(f"--resume {cfg.resume}: a directory (an orbax checkpoint?); "
                         f"pass a reference-layout .pt: orbax is {ORBAX_LEFT_OUT}")
    if not cfg.target_data:
        raise SystemExit("--target-data <corpus image dir> is required")
    if not cfg.query_file:
        raise SystemExit("--query_file <queries.jsonl> is required")
    with run_logging(cfg, require_fresh=False):
        return _serve(cfg)


def _serve(cfg) -> dict:
    from keds_tpu_torch.cli.common import (compute_dtype, load_database, pad_batch,
                                           setup_runtime)
    from keds_tpu_torch.data.datasets import CustomFolder
    from keds_tpu_torch.data.loader import DataLoader
    from keds_tpu_torch.engine import ComposedQueryEngine
    from keds_tpu_torch.io.checkpoint import load_heads_checkpoint
    from keds_tpu_torch.models.loader import load_clip
    from keds_tpu_torch.profiling import start_trace, stop_trace

    device, mesh = setup_runtime(cfg)
    clip_params, clip_cfg, _, t_val = load_clip(
        cfg.resume, target_pad=1.25 if cfg.target_pad else None, normalize_on_host=False,
        device=device)
    heads, _ = load_heads_checkpoint(cfg.resume, device)
    retriever = load_database(cfg, mesh)
    engine = ComposedQueryEngine(clip_params, clip_cfg, heads, retriever.db,
                                 retriever=retriever, db_topk=cfg.db_topk,
                                 compute_dtype=compute_dtype(cfg),
                                 quant_towers=cfg.quant_towers, device=device, mesh=mesh)
    del clip_params, heads

    # ---- corpus: streamed one batch at a time -------------------------------
    loader = DataLoader(CustomFolder(cfg.target_data, transform=t_val), cfg.batch_size,
                        num_workers=cfg.workers, worker_processes=cfg.worker_processes)
    names: list = []

    def corpus_batches():
        for images, paths in loader:
            names.extend(os.path.basename(p) for p in paths)
            yield pad_batch(images, cfg.batch_size)

    t0 = time.perf_counter()
    try:
        corpus = engine.encode_corpus(corpus_batches())[:len(names)]   # the padded tail
    finally:
        loader.close()
    corpus_s = time.perf_counter() - t0
    logging.info("corpus: %d images encoded in %.1fs", len(names), corpus_s)
    device_rank = len(names) >= DEVICE_RANK_MIN_ROWS
    ranked = engine.corpus_to_device(corpus) if device_rank else corpus

    # ---- queries: macro batches; the next one decodes meanwhile -------------
    with open(cfg.query_file) as f:
        queries = [json.loads(line) for line in f if line.strip()]
    out_path = cfg.demo_out if cfg.demo_out.endswith(".jsonl") else cfg.demo_out + ".jsonl"
    macro = cfg.batch_size
    chunks = [queries[lo:lo + macro] for lo in range(0, len(queries), macro)]
    q_loader = DataLoader(_QueryDataset(queries, t_val), macro, num_workers=cfg.workers,
                          worker_processes=cfg.worker_processes)
    topn = min(cfg.topn, len(names))
    primary = mesh.rank == 0
    prof = start_trace(cfg.profile_dir) if cfg.profile_dir else None
    t0 = time.perf_counter()
    with open(out_path if primary else os.devnull, "w") as out:
        for b, (chunk, (imgs, text)) in enumerate(zip(chunks, q_loader)):
            scores, idx = engine.search([pad_batch(imgs, macro)], [pad_batch(text, macro)],
                                        ranked, topn)
            if prof is not None and b + 1 == PROFILE_BATCHES:
                stop_trace(prof, cfg.profile_dir)
                prof = None
            for qi, q in enumerate(chunk):
                out.write(json.dumps({
                    "query": q["image"], "text": q.get("text", "a photo of *"),
                    "results": [{"name": names[j], "score": float(scores[qi][r])}
                                for r, j in enumerate(idx[qi])]}) + "\n")
            out.flush()
    if prof is not None:
        stop_trace(prof, cfg.profile_dir)
    q_loader.close()
    queries_s = time.perf_counter() - t0
    logging.info("served %d composed queries in %.2fs (%.1f q/s incl. decode)",
                 len(queries), queries_s, len(queries) / max(queries_s, 1e-9))
    if primary:
        print(out_path)
    return dict(corpus_images=len(names), corpus_s=corpus_s, queries=len(queries),
                queries_s=queries_s, topn=topn, device_ranking=device_rank,
                out_path=out_path)


if __name__ == "__main__":
    main()
