"""Accuracy of the approx and int8 serving modes on realistic data
(counterpart of ``keds_tpu/tools/quant_accuracy.py``).

Three parts, each measured against the exact, unquantized run on the same
inputs:

1. ``retrieval``: top-k overlap and top-1 agreement of each retrieval
   backend with the exact scan, on Gaussian corpora and on correlated
   corpora of each ``--spreads`` (:mod:`keds_tpu_torch.retrieval.synth`):
   approx, int8 without a re-rank, int8 re-ranked against dequantized rows
   and int8 re-ranked against the true rows;
2. ``towers``: embedding cosine and neighbour overlap of the W8A8 int8
   image tower against its unquantized self on structured images, with and
   without injected outlier channels;
3. ``pipeline``: the whole composed query (encode, retrieve, fuse, compose,
   rank a corpus) exact against each serving mode, as top-1 agreement and
   top-10 overlap of the final ranking.  It runs on the port's own seeded
   weights (:func:`keds_tpu_torch.synth.build`).

``approx`` is the exact search off the TPU (``approx_max_k`` lowers to an
exact top-k there, and the port maps it to B1), so its rows read 1.0 here.
Results: one JSON line on stdout with the JAX tool's keys, a table on
stderr.

    python -m keds_tpu_torch.tools.quant_accuracy [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

QUICK_CFG = dict(embed_dim=64, image_resolution=64, vision_layers=3, vision_width=128,
                 vision_patch_size=16, transformer_width=64, transformer_heads=2,
                 transformer_layers=3)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _overlap(a: np.ndarray, b: np.ndarray) -> float:
    k = a.shape[1]
    return float(np.mean([len(set(a[i].tolist()) & set(b[i].tolist())) / k
                          for i in range(len(a))]))


def _clip_cfg(args):
    from keds_tpu_torch.models import clip as mclip

    return mclip.VIT_L_14 if not args.quick else mclip.ClipConfig(**QUICK_CFG)


def bench_retrieval_backends(args, device) -> dict:
    from keds_tpu_torch.ops.topk import (mips_topk, mips_topk_approx, mips_topk_int8,
                                         quantize_int8)
    from keds_tpu_torch.retrieval.synth import correlated_embeddings, shared_geometry

    k = args.k
    out = {}
    cases = [("gaussian", None)] + [("correlated", s) for s in args.spreads]
    for name, spread in cases:
        rng = np.random.default_rng(0)
        if name == "gaussian":
            db = rng.standard_normal((args.rows, args.dim)).astype(np.float32)
            q = rng.standard_normal((args.queries, args.dim)).astype(np.float32)
            db /= np.linalg.norm(db, axis=1, keepdims=True)
            q /= np.linalg.norm(q, axis=1, keepdims=True)
            tag = "gaussian"
        else:
            geom = shared_geometry(rng, args.dim)
            db = correlated_embeddings(rng, args.rows, args.dim, spread=spread, basis=geom)
            q = correlated_embeddings(np.random.default_rng(1), args.queries, args.dim,
                                      spread=spread, basis=geom)
            tag = f"correlated s={spread}"
        tq, tdb = torch.from_numpy(q).to(device), torch.from_numpy(db).to(device)
        meancos = float((db[:256] @ db[256:512].T).mean())
        ei = mips_topk(tq, tdb, k)[1].cpu().numpy()
        q8, sc = quantize_int8(tdb)
        row = {"mean_cos": round(meancos, 3)}
        row["approx"] = _overlap(ei, mips_topk_approx(tq, tdb, k)[1].cpu().numpy())
        row["int8_raw"] = _overlap(
            ei, mips_topk_int8(tq, q8, sc, k, oversample=1)[1].cpu().numpy())
        row["int8_deq_rescore"] = _overlap(
            ei, mips_topk_int8(tq, q8, sc, k, oversample=4)[1].cpu().numpy())
        ai = mips_topk_int8(tq, q8, sc, k, oversample=4, db=tdb)[1].cpu().numpy()
        row["int8_true_rescore"] = _overlap(ei, ai)
        row["int8_true_top1"] = float(np.mean(ai[:, 0] == ei[:, 0]))
        # the exact search in another accumulation order: overlap below this
        # is tie noise
        exact_np = q.astype(np.float64) @ db.T.astype(np.float64)
        ni = np.argsort(-exact_np, axis=1, kind="stable")[:, :k]
        row["f32_tie_floor"] = _overlap(ei, ni)
        out[tag] = {m: round(v, 4) if isinstance(v, float) else v for m, v in row.items()}
        log(f"[retrieval] {tag:18s} " + "  ".join(f"{m}={v}" for m, v in out[tag].items()))
    return out


def bench_int8_towers(args, device) -> dict:
    from keds_tpu_torch import synth
    from keds_tpu_torch.models import clip as mclip
    from keds_tpu_torch.ops.quant import quantize_clip_blocks
    from keds_tpu_torch.ops.topk import mips_topk
    from keds_tpu_torch.retrieval.synth import inject_outlier_channels, structured_images

    cfg = _clip_cfg(args)
    params = synth.init_clip(cfg, 0, device, torch.bfloat16)
    rng = np.random.default_rng(2)
    n_corpus, n_q = (256, 64) if args.quick else (1024, 128)
    res = cfg.image_resolution
    corpus_imgs = structured_images(rng, n_corpus, res)
    query_imgs = structured_images(np.random.default_rng(3), n_q, res)

    @torch.inference_mode()
    def embed(p, imgs):
        outs = []
        for i in range(0, len(imgs), 32):
            x = torch.from_numpy(imgs[i:i + 32]).to(device, torch.bfloat16)
            f = mclip.encode_image(p, cfg, x).float().cpu().numpy()
            outs.append(f / np.linalg.norm(f, axis=1, keepdims=True))
        return np.concatenate(outs)

    out = {}
    for variant in ("plain", "outlier"):
        p = params if variant == "plain" else inject_outlier_channels(params)
        pq = quantize_clip_blocks(p)
        f_ref, f_q = embed(p, query_imgs), embed(pq, query_imgs)
        cos = np.sum(f_ref * f_q, axis=1)
        db_ref = torch.from_numpy(embed(p, corpus_imgs)).to(device)
        ei = mips_topk(torch.from_numpy(f_ref).to(device), db_ref, args.k)[1]
        qi = mips_topk(torch.from_numpy(f_q).to(device), db_ref, args.k)[1]
        out[variant] = {"cos_mean": round(float(cos.mean()), 5),
                        "cos_min": round(float(cos.min()), 5),
                        "nbr_overlap": round(_overlap(ei.cpu().numpy(), qi.cpu().numpy()), 4)}
        log(f"[int8 towers] {variant:8s} {out[variant]}")
    return out


def bench_pipeline(args, device) -> dict:
    from keds_tpu_torch import synth
    from keds_tpu_torch.models import clip as mclip
    from keds_tpu_torch.models.composition import compose_pseudo_tokens
    from keds_tpu_torch.ops.quant import maybe_quantize_clip
    from keds_tpu_torch.ops.topk import mips_topk
    from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever
    from keds_tpu_torch.retrieval.synth import (correlated_embeddings, shared_geometry,
                                                structured_images)

    cfg = _clip_cfg(args)
    batch = 64
    clip_params, heads, _ = synth.build(cfg, db_rows=8, dtype=torch.bfloat16, device=device)
    # the knowledge DB and the ranked corpus share the correlated geometry
    rng = np.random.default_rng(5)
    geom = shared_geometry(rng, cfg.embed_dim)
    img_db = correlated_embeddings(rng, args.rows, cfg.embed_dim, spread=0.35, basis=geom)
    txt_db = correlated_embeddings(rng, args.rows, cfg.embed_dim, spread=0.35, basis=geom)
    corpus = torch.from_numpy(correlated_embeddings(
        rng, args.corpus_rows, cfg.embed_dim, spread=0.35, basis=geom)).to(device)
    db = KnowledgeDB.from_arrays(img_db, txt_db, dtype=torch.float32, device=device)
    images = torch.from_numpy(structured_images(np.random.default_rng(6), batch,
                                                cfg.image_resolution)).to(device, torch.bfloat16)
    text = np.zeros((batch, 77), np.int64)
    text[:, :8] = [49406, 320, 1125, 539, 265, 267, 1929, 49407]
    text = torch.from_numpy(text).to(device)

    @torch.inference_mode()
    def run(backend: str, quant_towers: str) -> np.ndarray:
        retr = Retriever(db, backend)
        cp = maybe_quantize_clip(clip_params, quant_towers)
        f = mclip.encode_image_chunked(cp, cfg, images, mclip.DEFAULT_ENCODE_CHUNK)
        ti, tt = retr.retrieve_features(f.float(), k=16)
        tok = compose_pseudo_tokens(heads, f, ti.to(f.dtype), tt.to(f.dtype))
        out = mclip.encode_text_img_retrieval(cp, cfg, text, tok, split_id=265)
        out = out / out.norm(dim=-1, keepdim=True)
        return mips_topk(out.float().contiguous(), corpus, 10)[1].cpu().numpy()

    ref = run("xla", "none")
    out = {}
    for tag, backend, qt in (("approx", "approx", "none"), ("int8_db", "int8", "none"),
                             ("int8_towers", "xla", "int8"), ("int8_both", "int8", "int8")):
        idx = run(backend, qt)
        out[tag] = {"top1_agree": round(float(np.mean(idx[:, 0] == ref[:, 0])), 4),
                    "top10_overlap": round(_overlap(ref, idx), 4)}
        log(f"[pipeline] {tag:12s} {out[tag]}")
    return out


def main(argv=None) -> None:
    from keds_tpu_torch.runtime import resolve_device

    p = argparse.ArgumentParser(prog="keds_tpu_torch.tools.quant_accuracy",
                                description=__doc__.split("\n")[0])
    p.add_argument("--rows", type=int, default=200_000,
                   help="knowledge-DB rows (retrieval + pipeline parts)")
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--queries", type=int, default=256)
    p.add_argument("--k", type=int, default=16)
    p.add_argument("--spreads", type=float, nargs="+", default=[0.35, 0.15, 0.05],
                   help="correlated-corpus cluster tightness sweep (0.35 ~ real CLIP "
                        "corpora; smaller = harder)")
    p.add_argument("--corpus-rows", type=int, default=4096,
                   help="final-ranking corpus size for the pipeline part")
    p.add_argument("--parts", nargs="+", default=["retrieval", "towers", "pipeline"],
                   choices=["retrieval", "towers", "pipeline"])
    p.add_argument("--quick", action="store_true", help="small sizes and a tiny tower")
    p.add_argument("--device", default=None,
                   help="torch device; default the current CUDA device")
    args = p.parse_args(argv)
    if args.quick:
        args.rows = min(args.rows, 20_000)
        args.queries = min(args.queries, 64)
        args.corpus_rows = min(args.corpus_rows, 512)
    device = resolve_device(args.device)
    log(f"quant_accuracy: device={device} rows={args.rows} (approx is the exact search "
        f"off the TPU)")
    results = {}
    if "retrieval" in args.parts:
        results["retrieval"] = bench_retrieval_backends(args, device)
    if "towers" in args.parts:
        results["towers"] = bench_int8_towers(args, device)
    if "pipeline" in args.parts:
        results["pipeline"] = bench_pipeline(args, device)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
