"""Benchmark evaluators (counterpart of ``keds_tpu/evalkit/evaluators.py``;
reference ``src/eval_utils.py:291-1005``), on one device.

Protocols, as in the JAX package:

* **CIRR**: corpus pass, then a checkpoint sweep j=1..30 loading
  ``<image_branch>/epoch_j.pt`` and ``<text_branch>/epoch_j.pt``; the
  reported "image" features are the text-branch composed features and
  "mixture" is 0.5/0.5.
* **CIRR test**: fixed epochs (image 10, text 13); the test-server dicts.
* **Fashion-IQ**: fusion without ``text_condition`` (2 pseudo tokens), the
  ``encode_text_img_train`` splice, sweep j=1..15 over epochs 2j-1 / 2j,
  mixture 0.05j.
* **COCO**: region-crop queries, both members loaded from the image branch
  (epochs 2j-1 / 2j), sweep j=1..25, mixture 0.05j.
* **ImageNet domain transfer**: prompts "a {domain} of *", labels offset by
  1000 per domain, sweep j=5..9 (epochs 2j-1 / 2j), mixture 0.1j.

What does not depend on the swept heads (image features, knowledge-DB
neighbours, prompt tokens) is computed once and kept on the device; each
sweep epoch runs only the heads and the text tower.

Ranking: ``eval_ranking="host"`` fetches the composed features and ranks
with the numpy formulas of :mod:`.metrics`.  ``"device"`` forms the mixture
on the device and ranks with :func:`~keds_tpu_torch.ops.topk.mips_topk` in
f32 (the fused kernel on the card, with TF32 off) at k = min(101 / 100 /
200, T), fetching only the int32 indices; COCO's diagonal ranks are torch
ops on the device.  The head-independent ground-truth contracts are checked
once, up front.  The two paths agree except on scores tied to within f32
summation order, or distinct scores that ``1 - s`` rounds into a tie
(:mod:`.metrics`).

Under a ``mesh`` of several ranks every rank iterates the same loaders (the
global feed): each rank encodes, retrieves and composes its block of every
batch, the corpus is gathered to every rank (replicated for device
ranking), and only the results cross the ranks: the composed features for
host ranking, the int32 indices for device ranking (COCO's diagonal ranks
gather the composed features).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from keds_tpu_torch.evalkit import metrics as M
from keds_tpu_torch.io.checkpoint import load_heads_checkpoint
from keds_tpu_torch.models import clip as mclip
from keds_tpu_torch.models.composition import FusionHeads, compose_pseudo_tokens
from keds_tpu_torch.models.convert import cast_floating
from keds_tpu_torch.ops.topk import mips_topk
from keds_tpu_torch.parallel.mesh import fetch_batches, shard_global_batch
from keds_tpu_torch.retrieval.database import Retriever, unit_rows
from keds_tpu_torch.runtime import DeviceLike, resolve_device
from keds_tpu_torch.tokenizer import bucket_text, star_token_id, tokenize


def get_templates() -> List[str]:
    """PALAVRA prompt templates (reference eval_utils.py:88-118)."""
    return [
        "This is a photo of a {}", "This photo contains a {}", "A photo of a {}",
        "This is an illustration of a {}", "This illustration contains a {}",
        "An illustrations of a {}", "This is a sketch of a {}",
        "This sketch contains a {}", "A sketch of a {}",
        "This is a diagram of a {}", "This diagram contains a {}",
        "A diagram of a {}", "A {}", "We see a {}", "{}",
        "We see a {} in this photo", "We see a {} in this image",
        "We see a {} in this illustration", "We see a {} photo",
        "We see a {} image", "We see a {} illustration",
        "{} photo", "{} image", "{} illustration",
    ]


def _is_orbax_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and (
        os.path.exists(os.path.join(path, "_CHECKPOINT_METADATA"))
        or os.path.exists(os.path.join(path, "_METADATA")))


@dataclass
class EvalContext:
    """Frozen CLIP, knowledge DB and head-checkpoint branches of an
    evaluation.  ``split_id`` None reads the ``*`` id from the BPE vocab;
    ``device`` None is the CUDA device.  ``mesh`` splits every batch over
    the ranks (the module docstring); ``quant_towers`` (W8A8 towers) is not
    ported yet (refused)."""

    clip_params: dict
    cfg: mclip.ClipConfig
    retriever: Retriever
    image_branch: str = "./image_branch/checkpoints"
    text_branch: str = "./text_branch/checkpoints"
    db_topk: int = 16
    compute_dtype: torch.dtype = torch.bfloat16
    mesh: object = None
    quant_towers: str = "none"
    eval_ranking: str = "host"
    split_id: Optional[int] = None
    device: DeviceLike = None
    _heads_cache: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.mesh is not None and self.mesh.size == 1:
            self.mesh = None
        if self.quant_towers != "none":
            raise NotImplementedError(f"quant_towers={self.quant_towers!r}: W8A8 towers are "
                                      "ROADMAP.md section A item 15, not ported yet")
        if self.eval_ranking not in ("host", "device"):
            raise ValueError(f"eval_ranking must be 'host' or 'device', got "
                             f"{self.eval_ranking!r}")
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(self.device))
        if self.retriever.db.image_db.device != self.device:
            raise ValueError(f"knowledge DB is on {self.retriever.db.image_db.device}, "
                             f"evaluation runs on {self.device}")
        self.clip_c = cast_floating(self.clip_params, self.compute_dtype, self.device)
        self.logit_scale = float(np.exp(np.asarray(
            torch.as_tensor(self.clip_params["logit_scale"]).float().cpu())).ravel()[0])
        self.split_id = int(star_token_id() if self.split_id is None else self.split_id)

    def to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def rows(self, a) -> torch.Tensor:
        """This rank's block of a global batch on the device (the whole
        batch without a mesh)."""
        return shard_global_batch(self.mesh, a, self.device)[0]

    def fetch(self, x: torch.Tensor, counts: Sequence[int]) -> torch.Tensor:
        """The global rows, in dataset order, of ``x``: this rank's blocks
        of batches of ``counts`` rows, concatenated (``x`` without a mesh)."""
        return fetch_batches(self.mesh, x, counts)

    def encode_text(self, text) -> torch.Tensor:
        """Text features of this rank's block of a token batch already on
        the device."""
        return mclip.encode_text(self.clip_c, self.cfg, text)

    # -- cached query-side precomputation -----------------------------------
    def image_features(self, images) -> torch.Tensor:
        """Image features of this rank's block of a global batch."""
        return mclip.encode_image_chunked(self.clip_c, self.cfg, self.rows(images),
                                          mclip.DEFAULT_ENCODE_CHUNK)

    def retrieved(self, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.retriever.retrieve_features(feats.float(), k=self.db_topk)

    # -- head-dependent composition -------------------------------------------
    def composed_fn(self, mode: str, use_text_condition: bool) -> Callable:
        """``fn(heads, feats, topk_img, topk_txt, text)`` -> unit-norm f32
        composed features: ``mode`` "retrieval" splices the pseudo tokens at
        ``*``; "train" replaces the stars in place (Fashion-IQ)."""
        encode = {"retrieval": mclip.encode_text_img_retrieval,
                  "train": mclip.encode_text_img_train}[mode]

        def fn(heads: FusionHeads, feats, topk_img, topk_txt, text):
            tokens = compose_pseudo_tokens(heads, feats, topk_img.to(feats.dtype),
                                           topk_txt.to(feats.dtype),
                                           use_text_condition=use_text_condition)
            out = encode(self.clip_c, self.cfg, text, tokens, split_id=self.split_id)
            return unit_rows(out.float())

        return fn

    def load_heads(self, directory: str, epoch: int) -> FusionHeads:
        """``directory`` is a branch of ``epoch_N.pt`` files, or one
        checkpoint file whose heads every sweep epoch then uses (the
        published ``image_stream.pt`` / ``text_stream.pt``).  Fixed files
        are cached by path; sweep epochs are read once each."""
        fixed = os.path.isfile(directory) or _is_orbax_checkpoint(directory)
        path = directory if fixed else os.path.join(directory, f"epoch_{epoch}.pt")
        if os.path.isdir(path):
            raise ValueError(f"{path} is a directory (an orbax checkpoint?): the port "
                             "reads .pt checkpoint files only")
        if fixed and path in self._heads_cache:
            return self._heads_cache[path]
        heads, _ = load_heads_checkpoint(path, self.device)
        if fixed:
            self._heads_cache[path] = heads
        return heads


def extract_image_features(ctx: EvalContext, dataset, batch_size: int = 128,
                           num_workers: int = 0) -> Tuple[np.ndarray, List[str]]:
    """Encode a dataset's images into a feature matrix and name list
    (reference extract_image_features, eval_utils.py:1138-1173)."""
    from keds_tpu_torch.data.loader import DataLoader

    feats, names, counts = [], [], []
    with torch.inference_mode():
        for batch in DataLoader(dataset, batch_size, num_workers=num_workers):
            images, batch_names = batch[0], batch[1]
            feats.append(ctx.image_features(images).float())
            names.extend(batch_names)
            counts.append(len(batch_names))
    return ctx.fetch(torch.cat(feats), counts).cpu().numpy(), names


def _bucket(text) -> np.ndarray:
    """Trim a (B, 77) token batch to the shortest text bucket: exact by
    causality (the retrieval splice pools at EOT+2, the in-place splice at
    EOT, both within the bucket)."""
    return bucket_text(np.asarray(text))


def _encode_corpus(ctx: EvalContext, target_loader) -> Tuple[np.ndarray, List[str]]:
    feats, names, counts = [], [], []
    for images, paths in target_loader:
        feats.append(unit_rows(ctx.image_features(images).float()))
        names.extend(paths)
        counts.append(len(paths))
    return ctx.fetch(torch.cat(feats), counts).cpu().numpy(), names


def _precompute_queries(ctx: EvalContext, query_loader, unpack) -> List[dict]:
    """The head-independent query side, once: image features, neighbours
    and whatever per-batch metadata ``unpack`` returns, and the batch's
    row count ``n``."""
    cache = []
    for batch in query_loader:
        images, meta = unpack(batch)
        feats = ctx.image_features(images)
        topk_img, topk_txt = ctx.retrieved(feats)
        cache.append(dict(feats=feats, topk_img=topk_img, topk_txt=topk_txt,
                          n=len(images), **meta))
    return cache


def _counts(cache: List[dict]) -> List[int]:
    return [b["n"] for b in cache]


def _compose_all(ctx: EvalContext, compose, heads_ib, heads_tb, cache,
                 texts=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both branches' composed features of every cached batch, concatenated
    on the device; ``texts`` overrides the batches' own tokens."""
    composed, composed_tb = [], []
    for i, b in enumerate(cache):
        args = (b["feats"], b["topk_img"], b["topk_txt"],
                b["text"] if texts is None else texts[i])
        composed.append(compose(heads_ib, *args))
        composed_tb.append(compose(heads_tb, *args))
    return torch.cat(composed), torch.cat(composed_tb)


def _mix(a: torch.Tensor, b: torch.Tensor, w_b: float, w_a: float) -> torch.Tensor:
    """Unit-norm ``w_b * b + w_a * a`` on the device; both weights arrive
    rounded to f32, as the host computes them."""
    mix = w_b * b + w_a * a
    return mix / mix.norm(dim=-1, keepdim=True)


def _rank_topk(feats: Sequence[torch.Tensor], corpus_dev: torch.Tensor,
               k: int) -> List[torch.Tensor]:
    """Indices of the top ``k`` corpus rows of each feature set, best first,
    ties to the lower index, on the device: B1's f32 kernel on the card."""
    return [mips_topk(f.contiguous(), corpus_dev, k)[1] for f in feats]


def _ranked(ctx: EvalContext, feats: Sequence[torch.Tensor], corpus_dev: torch.Tensor,
            k: int, counts: Sequence[int]) -> List[np.ndarray]:
    """:func:`_rank_topk` of this rank's rows, then every rank's indices in
    dataset order on the host."""
    return [ctx.fetch(i, counts).cpu().numpy() for i in _rank_topk(feats, corpus_dev, k)]


def _f32(x: float) -> float:
    return float(np.float32(x))


def _log_metrics(tag: str, key: str, m: Dict[str, float]) -> None:
    logging.info(
        f"{tag} Eval {key} Feature " + "\t".join(f"{k}: {v:.4f}" for k, v in m.items())
    )


# ---------------------------------------------------------------------------
# CIRR
# ---------------------------------------------------------------------------

# Phase walls of the most recent evaluate_cirr call (corpus encode, query
# precompute, per-sweep-step load/compose/metrics accumulators), logged at
# INFO; observational only.
last_cirr_walls: Dict[str, float] = {}


@torch.inference_mode()
def evaluate_cirr(ctx: EvalContext, query_loader, target_loader,
                  epochs: Sequence[int] = range(1, 31)) -> Dict:
    walls = {"corpus_s": 0.0, "queries_s": 0.0, "sweep_s": 0.0,
             "sweep_load_s": 0.0, "sweep_compose_s": 0.0,
             "sweep_metrics_s": 0.0, "epochs": 0}
    t0 = time.perf_counter()
    corpus, target_paths = _encode_corpus(ctx, target_loader)
    walls["corpus_s"] = time.perf_counter() - t0

    def unpack(batch):
        # the caption-only tokens are not kept: only evaluate_cirr_test
        # encodes them
        ref_images, text_with_blank, _caption_only, ref_paths, answer_paths, _, _ = batch
        return ref_images, dict(text=ctx.rows(_bucket(text_with_blank)),
                                ref_paths=list(ref_paths), answer_paths=list(answer_paths))

    t1 = time.perf_counter()
    cache = _precompute_queries(ctx, query_loader, unpack)
    walls["queries_s"] = time.perf_counter() - t1
    ref_paths = [p for b in cache for p in b["ref_paths"]]
    answer_paths = [p for b in cache for p in b["answer_paths"]]
    counts = _counts(cache)
    compose = ctx.composed_fn("retrieval", use_text_condition=True)

    device_rank = ctx.eval_ranking == "device"
    if device_rank:
        base_names = [os.path.basename(n) for n in target_paths]
        M.check_cirr_gt_unique(base_names, ref_paths, answer_paths)
        corpus_dev = ctx.to_device(corpus)
        top_k = min(101, corpus.shape[0])

    results = {}
    t2 = time.perf_counter()
    for j in epochs:
        ta = time.perf_counter()
        heads_ib = ctx.load_heads(ctx.image_branch, j)
        heads_tb = ctx.load_heads(ctx.text_branch, j)
        tb_ = time.perf_counter()
        composed, composed_tb = _compose_all(ctx, compose, heads_ib, heads_tb, cache)
        if device_rank:
            idx3 = _ranked(ctx, (composed, composed_tb,
                                 _mix(composed, composed_tb, 0.5, 0.5)),
                           corpus_dev, top_k, counts)
            tc = time.perf_counter()
            for key, ti in zip(("composed", "image", "mixture"), idx3):
                m = M.get_metrics_cirr_from_topk(
                    ti, base_names, ref_paths, answer_paths, corpus.shape[0])
                _log_metrics(f"CIRR[j={j}]", key, m)
                results[(j, key)] = m
        else:
            composed = ctx.fetch(composed, counts).cpu().numpy()
            composed_tb = ctx.fetch(composed_tb, counts).cpu().numpy()
            mixture = composed * 0.5 + composed_tb * 0.5
            mixture /= np.linalg.norm(mixture, axis=-1, keepdims=True)
            tc = time.perf_counter()
            feats = {"composed": composed, "image": composed_tb, "mixture": mixture}
            metric_fn = partial(M.get_metrics_cirr, corpus, reference_names=ref_paths,
                                index_names=target_paths, target_names=answer_paths)
            for key, value in feats.items():
                m = metric_fn(ref_features=value)
                _log_metrics(f"CIRR[j={j}]", key, m)
                results[(j, key)] = m
        td = time.perf_counter()
        walls["sweep_load_s"] += tb_ - ta
        walls["sweep_compose_s"] += tc - tb_
        walls["sweep_metrics_s"] += td - tc
        walls["epochs"] += 1
    walls["sweep_s"] = time.perf_counter() - t2
    last_cirr_walls.clear()
    last_cirr_walls.update(walls)
    n_ep = max(walls["epochs"], 1)
    logging.info(
        "CIRR phase walls: corpus %.2f s (%d imgs), queries %.2f s (%d q), "
        "sweep %.2f s over %d epoch(s) (per epoch: load %.2f, "
        "compose+fetch %.2f, metrics %.2f)",
        walls["corpus_s"], len(target_paths), walls["queries_s"],
        len(ref_paths), walls["sweep_s"], walls["epochs"],
        walls["sweep_load_s"] / n_ep, walls["sweep_compose_s"] / n_ep,
        walls["sweep_metrics_s"] / n_ep,
    )
    return results


@torch.inference_mode()
def evaluate_cirr_test(ctx: EvalContext, query_loader, target_loader,
                       image_epoch: int = 10, text_epoch: int = 13) -> Dict:
    corpus, target_paths = _encode_corpus(ctx, target_loader)

    def unpack(batch):
        ref_images, text_with_blank, caption_only, ref_paths, pairids, _ = batch
        return ref_images, dict(text=ctx.rows(_bucket(text_with_blank)),
                                # encode_text pools at EOT
                                caption_only=ctx.rows(_bucket(caption_only)),
                                ref_paths=list(ref_paths), pairids=list(pairids))

    cache = _precompute_queries(ctx, query_loader, unpack)
    ref_paths = [p for b in cache for p in b["ref_paths"]]
    pairids = [int(p) for b in cache for p in b["pairids"]]
    heads_ib = ctx.load_heads(ctx.image_branch, image_epoch)
    heads_tb = ctx.load_heads(ctx.text_branch, text_epoch)
    compose = ctx.composed_fn("retrieval", use_text_condition=True)
    counts = _counts(cache)
    composed, composed_tb = (ctx.fetch(c, counts).cpu().numpy() for c in
                             _compose_all(ctx, compose, heads_ib, heads_tb, cache))
    captions = ctx.fetch(torch.cat([unit_rows(ctx.encode_text(b["caption_only"]).float())
                                    for b in cache]), counts).cpu().numpy()
    mixture = 0.5 * composed_tb + 0.5 * composed
    mixture /= np.linalg.norm(mixture, axis=-1, keepdims=True)
    out_fn = partial(M.get_cirr_testoutput, corpus, reference_names=ref_paths,
                     index_names=target_paths, id_names=pairids)
    return {
        "composed": out_fn(ref_features=composed),
        "image": out_fn(ref_features=composed_tb),
        "text": out_fn(ref_features=captions),
        "mixture": out_fn(ref_features=mixture),
    }


# ---------------------------------------------------------------------------
# Fashion-IQ
# ---------------------------------------------------------------------------

@torch.inference_mode()
def evaluate_fashion(ctx: EvalContext, source_loader, target_loader,
                     epochs: Sequence[int] = range(1, 16)) -> Dict:
    corpus, target_paths = _encode_corpus(ctx, target_loader)

    def unpack(batch):
        ref_images, _tar, target_caption, _cap, answer_paths, _ref_names, _caps = batch
        return ref_images, dict(text=ctx.rows(_bucket(target_caption)),
                                answer_paths=list(answer_paths))

    cache = _precompute_queries(ctx, source_loader, unpack)
    answer_paths = [p for b in cache for p in b["answer_paths"]]
    counts = _counts(cache)
    compose = ctx.composed_fn("train", use_text_condition=False)

    device_rank = ctx.eval_ranking == "device"
    if device_rank:
        M.check_fashion_gt_unique(target_paths, answer_paths)
        corpus_dev = ctx.to_device(corpus)
        top_k = min(100, corpus.shape[0])

    results = {}
    for j in epochs:
        heads_ib = ctx.load_heads(ctx.image_branch, 2 * j - 1)
        heads_tb = ctx.load_heads(ctx.text_branch, 2 * j)
        composed, composed_tb = _compose_all(ctx, compose, heads_ib, heads_tb, cache)
        if device_rank:
            # both weights rounded to f32 as the host computes them: the
            # host forms (1 - 0.05*j) in f64 before its f32 multiply
            mix = _mix(composed, composed_tb, _f32(0.05 * j), _f32(1 - 0.05 * j))
            for key, ti in zip(("composed", "image", "mixture"),
                               _ranked(ctx, (composed, composed_tb, mix), corpus_dev, top_k,
                                       counts)):
                m = M.get_metrics_fashion_from_topk(ti, target_paths, answer_paths)
                _log_metrics(f"Fashion[j={j}]", key, m)
                results[(j, key)] = m
            continue
        composed = ctx.fetch(composed, counts).cpu().numpy()
        composed_tb = ctx.fetch(composed_tb, counts).cpu().numpy()
        mixture = 0.05 * j * composed_tb + (1 - 0.05 * j) * composed
        mixture /= np.linalg.norm(mixture, axis=-1, keepdims=True)
        feats = {"composed": composed, "image": composed_tb, "mixture": mixture}
        metric_fn = partial(M.get_metrics_fashion, corpus, target_names=target_paths,
                            answer_names=answer_paths)
        for key, value in feats.items():
            m = metric_fn(ref_features=value)
            _log_metrics(f"Fashion[j={j}]", key, m)
            results[(j, key)] = m
    return results


# ---------------------------------------------------------------------------
# COCO
# ---------------------------------------------------------------------------

# Phase walls of the most recent evaluate_coco call, logged at INFO;
# observational only (queries and corpus share one loader pass here).
last_coco_walls: Dict[str, float] = {}


def _diag_ranks(logits: torch.Tensor) -> torch.Tensor:
    """0-based rank a stable descending argsort gives each row's diagonal
    entry: the strictly greater entries, plus equal ones at lower index."""
    n = logits.shape[0]
    gt = torch.diagonal(logits)[:, None]
    idx = torch.arange(n, device=logits.device)
    greater = (logits > gt).sum(dim=1)
    eq_before = ((logits == gt) & (idx[None, :] < idx[:, None])).sum(dim=1)
    return greater + eq_before


@torch.inference_mode()
def evaluate_coco(ctx: EvalContext, loader, epochs: Sequence[int] = range(1, 26)) -> Dict:
    walls = {"queries_s": 0.0, "corpus_s": 0.0, "sweep_s": 0.0,
             "sweep_load_s": 0.0, "sweep_compose_s": 0.0,
             "sweep_metrics_s": 0.0, "epochs": 0}

    def unpack(batch):
        # text_full is not kept: the reference encodes it but its metrics
        # entry is commented out (eval_utils.py:543,566)
        (images, region_images, _text_full, _twb, text_with_queryclass,
         _fn, _raw, _base) = batch
        return region_images, dict(target_images=images,
                                   text=ctx.rows(_bucket(text_with_queryclass)))

    t0 = time.perf_counter()
    cache = _precompute_queries(ctx, loader, unpack)
    walls["queries_s"] = time.perf_counter() - t0
    counts = _counts(cache)
    t1 = time.perf_counter()
    corpus = ctx.fetch(torch.cat([unit_rows(ctx.image_features(b.pop("target_images")).float())
                                  for b in cache]), counts).cpu().numpy()
    walls["corpus_s"] = time.perf_counter() - t1
    compose = ctx.composed_fn("retrieval", use_text_condition=True)
    logit_scale = ctx.logit_scale

    device_rank = ctx.eval_ranking == "device"
    if device_rank:
        corpus_dev = ctx.to_device(corpus)

    results = {}
    t2 = time.perf_counter()
    for j in epochs:
        ta = time.perf_counter()
        heads_ib = ctx.load_heads(ctx.image_branch, 2 * j - 1)
        # the reference loads the second member from the image branch too
        # (eval_utils.py:483)
        heads_tb = ctx.load_heads(ctx.image_branch, 2 * j)
        tb_ = time.perf_counter()
        composed, composed_tb = (ctx.fetch(c, counts) for c in
                                 _compose_all(ctx, compose, heads_ib, heads_tb, cache))
        if device_rank:
            mix = _mix(composed, composed_tb, _f32(0.05 * j), _f32(1 - 0.05 * j))
            preds3 = []
            for f in (composed, composed_tb, mix):
                # the host's logits_per_image, ranked per row (image_to_ref)
                # and per column (ref_to_image)
                logits = logit_scale * torch.matmul(corpus_dev, f.T)
                preds3.append((_diag_ranks(logits).cpu().numpy(),
                               _diag_ranks(logits.T).cpu().numpy()))
            tc = time.perf_counter()
            for key, (p_i2r, p_r2i) in zip(("composed", "image", "mixture"), preds3):
                m = M.get_metrics_coco_from_preds(p_i2r, p_r2i)
                _log_metrics(f"COCO[j={j}]", key, m)
                results[(j, key)] = m
        else:
            composed = composed.cpu().numpy()
            composed_tb = composed_tb.cpu().numpy()
            mixture = 0.05 * j * composed_tb + (1 - 0.05 * j) * composed
            mixture /= np.linalg.norm(mixture, axis=-1, keepdims=True)
            tc = time.perf_counter()
            feats = {"composed": composed, "image": composed_tb, "mixture": mixture}
            metric_fn = partial(M.get_metrics_coco, corpus, logit_scale=logit_scale)
            for key, value in feats.items():
                m = metric_fn(ref_features=value)
                _log_metrics(f"COCO[j={j}]", key, m)
                results[(j, key)] = m
        td = time.perf_counter()
        walls["sweep_load_s"] += tb_ - ta
        walls["sweep_compose_s"] += tc - tb_
        walls["sweep_metrics_s"] += td - tc
        walls["epochs"] += 1
    walls["sweep_s"] = time.perf_counter() - t2
    last_coco_walls.clear()
    last_coco_walls.update(walls)
    n_ep = max(walls["epochs"], 1)
    logging.info(
        "COCO phase walls: queries %.2f s, corpus %.2f s (%d rows), sweep "
        "%.2f s over %d epoch(s) (per epoch: load %.2f, compose+fetch %.2f, "
        "metrics %.2f)",
        walls["queries_s"], walls["corpus_s"], corpus.shape[0],
        walls["sweep_s"], walls["epochs"], walls["sweep_load_s"] / n_ep,
        walls["sweep_compose_s"] / n_ep, walls["sweep_metrics_s"] / n_ep,
    )
    return results


# ---------------------------------------------------------------------------
# ImageNet domain transfer
# ---------------------------------------------------------------------------

@torch.inference_mode()
def evaluate_imgnet_retrieval(ctx: EvalContext, prompts: Sequence[str],
                              query_loader, target_loader,
                              epochs: Sequence[int] = range(5, 10),
                              n_class: int = 1000) -> Dict:
    target_feats, target_labels = [], []
    for images, labels, _ in target_loader:
        target_feats.append(unit_rows(ctx.image_features(images).float()))
        target_labels.append(np.asarray(labels))
    target_feats = ctx.fetch(torch.cat(target_feats),
                             [len(t) for t in target_labels]).cpu().numpy()
    target_labels = np.concatenate(target_labels)

    def unpack(batch):
        images, labels, _ = batch
        return images, dict(labels=np.asarray(labels))

    cache = _precompute_queries(ctx, query_loader, unpack)
    counts = _counts(cache)
    compose = ctx.composed_fn("retrieval", use_text_condition=True)

    device_rank = ctx.eval_ranking == "device"
    if device_rank:
        target_dev = ctx.to_device(target_feats)
        top_k = min(200, target_feats.shape[0])

    results = {}
    for j in epochs:
        heads_ib = ctx.load_heads(ctx.image_branch, 2 * j - 1)
        heads_tb = ctx.load_heads(ctx.text_branch, 2 * j)
        for p_ind, p in enumerate(prompts):
            text = ctx.to_device(_bucket(tokenize(p)))   # 'a {domain} of *': S=16
            texts = [text.expand(b["feats"].shape[0], text.shape[1]) for b in cache]
            composed, composed_tb = _compose_all(ctx, compose, heads_ib, heads_tb, cache,
                                                 texts)
            labels_all = np.concatenate([b["labels"] + n_class * p_ind for b in cache])
            if device_rank:
                mix = _mix(composed, composed_tb, _f32(0.1 * j), _f32(1 - 0.1 * j))
                for key, ti in zip(("composed", "image", "mixture"),
                                   _ranked(ctx, (composed, composed_tb, mix), target_dev,
                                           top_k, counts)):
                    m = M.get_metrics_imgnet_from_topk(ti, labels_all, target_labels)
                    _log_metrics(f"ImgNet[j={j}, prompt={p!r}]", key, m)
                    results[(j, p, key)] = m
                continue
            composed = ctx.fetch(composed, counts).cpu().numpy()
            composed_tb = ctx.fetch(composed_tb, counts).cpu().numpy()
            mixture = 0.1 * j * composed_tb + (1 - 0.1 * j) * composed
            mixture /= np.linalg.norm(mixture, axis=-1, keepdims=True)
            feats = {"composed": composed, "image": composed_tb, "mixture": mixture}
            metric_fn = partial(M.get_metrics_imgnet, image_features=target_feats,
                                query_labels=labels_all, target_labels=target_labels)
            for key, value in feats.items():
                m = metric_fn(value)
                _log_metrics(f"ImgNet[j={j}, prompt={p!r}]", key, m)
                results[(j, p, key)] = m
    return results
