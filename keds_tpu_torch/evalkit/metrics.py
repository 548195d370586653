"""Benchmark metric functions (a copy of ``keds_tpu/evalkit/metrics.py``,
numpy only): formula-exact rebuilds of the reference
(``src/eval_utils.py:1008-1134``).

The host metrics rank by ``1 - s`` with a stable ascending argsort, the
reference's formula.  In f32, ``1 - s`` rounds scores with |s| < 2^-25 to
1.0, so distinct scores near 0 can tie there and keep corpus order.  The
``*_from_topk`` functions read a ranking by descending score ``s`` itself
(the device path's top-k), where those scores stay distinct; each says
which of the two orders it follows.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32) if not isinstance(x, np.ndarray) else x


def get_metrics_coco(image_features, ref_features, logit_scale) -> Dict[str, float]:
    """Mean/median rank + R@k in both directions (reference
    eval_utils.py:1008-1022); ground truth is the diagonal pairing."""
    image_features, ref_features = _np(image_features), _np(ref_features)
    scale = float(np.asarray(logit_scale))
    logits_per_image = scale * image_features @ ref_features.T
    logits = {"image_to_ref": logits_per_image, "ref_to_image": logits_per_image.T}
    n = len(ref_features)
    ground_truth = np.arange(n)[:, None]
    preds = {}
    for name, logit in logits.items():
        ranking = np.argsort(-logit, axis=1, kind="stable")
        preds[name] = np.where(ranking == ground_truth)[1]
    return get_metrics_coco_from_preds(preds["image_to_ref"],
                                       preds["ref_to_image"])


def get_metrics_coco_from_preds(preds_image_to_ref: np.ndarray,
                                preds_ref_to_image: np.ndarray) -> Dict[str, float]:
    """COCO stats from the 0-based rank of each ground-truth diagonal entry
    per direction.  Shared by the host path (ranks via full argsort) and the
    device-ranking path (ranks computed on device as
    ``#{j: logit_j > gt} + #{j < i: logit_j == gt}`` — the position a stable
    descending argsort assigns the diagonal, so both paths agree exactly,
    including under exact score ties)."""
    metrics: Dict[str, float] = {}
    for name, preds in (("image_to_ref", np.asarray(preds_image_to_ref)),
                        ("ref_to_image", np.asarray(preds_ref_to_image))):
        metrics[f"{name}_mean_rank"] = float(preds.mean() + 1)
        metrics[f"{name}_median_rank"] = float(np.floor(np.median(preds)) + 1)
        for k in (1, 5, 10, 50, 100):
            metrics[f"{name}_R@{k}"] = float(np.mean(preds < k))
    return metrics


def get_metrics_fashion(image_features, ref_features,
                        target_names: Sequence[str],
                        answer_names: Sequence[str]) -> Dict[str, float]:
    """Fashion-IQ recalls (reference eval_utils.py:1025-1037)."""
    image_features, ref_features = _np(image_features), _np(ref_features)
    distances = 1 - ref_features @ image_features.T
    sorted_indices = np.argsort(distances, axis=-1, kind="stable")
    sorted_index_names = np.asarray(target_names)[sorted_indices]
    labels = sorted_index_names == np.asarray(answer_names)[:, None]
    if not (labels.sum(axis=-1) == 1).all():
        raise AssertionError("each query must have exactly one ground-truth target")
    metrics = {}
    for k in (1, 5, 10, 50, 100):
        metrics[f"R@{k}"] = float(labels[:, :k].sum() / len(labels)) * 100
    return metrics


def check_fashion_gt_unique(target_names: Sequence[str],
                            answer_names: Sequence[str]) -> None:
    """One-time equivalent of get_metrics_fashion's per-epoch 'exactly one
    ground truth' assertion for rankings truncated to top-K: the full-width
    assertion holds for EVERY score matrix iff each query's answer occurs
    exactly once in the target corpus.  Head-independent, so checked once
    per eval by the device-ranking path."""
    from collections import Counter

    counts = Counter(target_names)
    for a in answer_names:
        if counts.get(a, 0) != 1:
            raise AssertionError("each query must have exactly one ground-truth target")


def get_metrics_fashion_from_topk(top_idx: np.ndarray,
                                  target_names: Sequence[str],
                                  answer_names: Sequence[str]) -> Dict[str, float]:
    """Fashion-IQ recalls from a (Q, K) matrix of top-K corpus indices
    (scores descending, ties toward lower index — ``jax.lax.top_k``'s order
    and the port's ``mips_topk``'s, equal to get_metrics_fashion's stable
    ascending-distance argsort except where ``1 - s`` rounds distinct
    scores near 0 into a tie: this function follows the scores).
    Exact for R@k, k<=100, when K = min(100, n_corpus); requires
    ``check_fashion_gt_unique`` (run once per eval by the device path)."""
    names = np.asarray(target_names)[np.asarray(top_idx)]  # (Q, K)
    labels = names == np.asarray(answer_names)[:, None]
    metrics = {}
    for k in (1, 5, 10, 50, 100):
        metrics[f"R@{k}"] = float(labels[:, :k].sum() / len(labels)) * 100
    return metrics


def _masked_cirr_ranking(image_features, ref_features,
                         reference_names, index_names) -> np.ndarray:
    """Ranked target basenames per query with the query's own reference image
    removed (shared by CIRR val metrics and the test-server output)."""
    distances = 1 - _np(ref_features) @ _np(image_features).T
    sorted_indices = np.argsort(distances, axis=-1, kind="stable")
    # basename() is applied to the n_t corpus names BEFORE fancy-indexing:
    # basename(names[idx]) == basename(names)[idx] elementwise, and at real
    # CIRR scale (4181 x 2297) the post-index form is ~9.6M Python-level
    # basename calls per metric call (x3 feature types x30 sweep epochs).
    base_names = np.asarray([os.path.basename(n) for n in index_names])
    sorted_index_names = base_names[sorted_indices]
    reference_mask = sorted_index_names != np.asarray(reference_names)[:, None]
    n_q, n_t = sorted_index_names.shape
    return sorted_index_names[reference_mask].reshape(n_q, n_t - 1)


def get_metrics_cirr(image_features, ref_features,
                     reference_names: Sequence[str],
                     index_names: Sequence[str],
                     target_names: Sequence[str]) -> Dict[str, float]:
    """CIRR recalls with reference-image masking (reference
    eval_utils.py:1040-1067)."""
    ranked = _masked_cirr_ranking(image_features, ref_features,
                                  reference_names, index_names)
    labels = ranked == np.asarray(target_names)[:, None]
    if not (labels.sum(axis=-1) == 1).all():
        raise AssertionError("each query must have exactly one ground-truth target")
    metrics = {}
    for k in (1, 5, 10, 50, 100):
        metrics[f"recall_R@{k}"] = float(labels[:, :k].sum() / len(labels)) * 100
    return metrics


def check_cirr_gt_unique(corpus_base_names: Sequence[str],
                         reference_names: Sequence[str],
                         target_names: Sequence[str]) -> None:
    """One-time equivalent of get_metrics_cirr's per-epoch 'exactly one
    ground truth' assertion, for rankings truncated to top-K: the full-width
    assertion holds for EVERY score matrix iff each target basename occurs
    exactly once in the corpus and never equals its query's reference (the
    mask would remove it).  Head-independent, so checked once per eval."""
    from collections import Counter

    counts = Counter(corpus_base_names)
    for t, r in zip(target_names, reference_names):
        if counts.get(t, 0) != 1 or t == r:
            raise AssertionError("each query must have exactly one ground-truth target")
        if counts.get(r, 0) != 1:
            # the full-width path fails its (n_q, n_t-1) reshape here: the
            # mask must remove exactly one entry per row
            raise AssertionError(
                "each query's reference image must appear exactly once in the corpus")


def get_metrics_cirr_from_topk(top_idx: np.ndarray,
                               corpus_base_names: Sequence[str],
                               reference_names: Sequence[str],
                               target_names: Sequence[str],
                               n_corpus: int) -> Dict[str, float]:
    """CIRR recalls from a (Q, K) matrix of top-K corpus indices (scores
    descending, ties broken toward lower index — ``jax.lax.top_k``'s order
    and the port's ``mips_topk``'s, which equals get_metrics_cirr's stable
    ascending-distance argsort except where ``1 - s`` rounds distinct
    scores near 0 into a tie: this function follows the scores).

    Exact for R@k, k<=100, when K = min(101, n_corpus): after removing the
    query's own reference (present in the corpus exactly once —
    ``check_cirr_gt_unique``), every row retains >= min(100, n_corpus-1)
    entries, the full prefix the R@100 metric reads.  Used by the device-
    ranking eval path (EvalContext.eval_ranking='device'): the (Q, T) score
    matmul + top-k run on the device and only the index matrix is fetched."""
    base = np.asarray(corpus_base_names)
    names = base[np.asarray(top_idx)]  # (Q, K)
    keep = names != np.asarray(reference_names)[:, None]
    out_w = min(100, n_corpus - 1)
    # kept entries first, original order preserved (stable argsort of ~keep)
    order = np.argsort(~keep, axis=1, kind="stable")[:, :out_w]
    ranked = np.take_along_axis(names, order, axis=1)
    labels = ranked == np.asarray(target_names)[:, None]
    metrics = {}
    for k in (1, 5, 10, 50, 100):
        metrics[f"recall_R@{k}"] = float(labels[:, :k].sum() / len(labels)) * 100
    return metrics


def get_cirr_testoutput(image_features, ref_features,
                        reference_names: Sequence[str],
                        index_names: Sequence[str],
                        id_names: Sequence) -> Dict[str, object]:
    """CIRR test-server submission dict: top-50 target names per pairid
    (reference eval_utils.py:1070-1087)."""
    ranked = _masked_cirr_ranking(image_features, ref_features,
                                  reference_names, index_names)
    result: Dict[str, object] = {"version": "rc2", "metric": "recall"}
    for i, pairid in enumerate(id_names):
        result[str(int(pairid))] = [
            ranked[i][t].replace(".png", "") for t in range(50)
        ]
    return result


def get_metrics_imgnet(query_features, image_features,
                       query_labels, target_labels,
                       num_classes: int = 7000) -> Dict[str, float]:
    """ImageNet domain-transfer R@k / P@k over one-hot class matches,
    processed in query batches of 100 (reference eval_utils.py:1090-1134).
    Labels are already offset by 1000*domain by the evaluator."""
    query_features, image_features = _np(query_features), _np(image_features)
    query_labels = np.asarray(query_labels)
    target_labels = np.asarray(target_labels)
    ks = (1, 5, 10, 50, 100, 200)
    metrics = {f"Real2Sketch_R@{k}": 0.0 for k in ks}
    metrics.update({f"Real2Sketch_P@{k}": 0.0 for k in ks})
    n_targets = len(target_labels)
    for start in range(0, len(query_features), 100):
        feats = query_features[start:start + 100]
        labels = query_labels[start:start + 100]
        logits = feats @ image_features.T
        # label match matrix == (one_hot(q) @ one_hot(t).T)
        label_matrix = (labels[:, None] == target_labels[None, :]).astype(np.float32)
        ranking = np.argsort(-logits, axis=1, kind="stable")
        for k in ks:
            rank_k = ranking[:, :k]
            matrix_k = np.zeros_like(label_matrix)
            matrix_k[np.arange(len(feats))[:, None], rank_k] = 1
            consistency = matrix_k * label_matrix
            num_correct = consistency.sum(axis=1)
            num_predicted = matrix_k.sum(axis=1)
            num_total = label_matrix.sum(axis=1)
            recall = float(np.mean(num_correct / (num_total + 1e-5)))
            precision = float(np.mean(num_correct / num_predicted))
            metrics[f"Real2Sketch_R@{k}"] += recall * len(feats)
            metrics[f"Real2Sketch_P@{k}"] += precision * len(feats)
    for k in ks:
        metrics[f"Real2Sketch_R@{k}"] /= len(query_features)
        metrics[f"Real2Sketch_P@{k}"] /= len(query_features)
    return metrics


def get_metrics_imgnet_from_topk(top_idx: np.ndarray,
                                 query_labels, target_labels) -> Dict[str, float]:
    """ImageNet domain-transfer metrics from a (Q, K) top-K index matrix,
    K = min(200, n_targets).  Value-identical to get_metrics_imgnet given
    the same ranking prefix (both rank by descending score, so no ``1 - s``
    tie class separates them): every quantity it reads is recoverable from the
    top-K indices — num_correct(k) = label matches within top-k,
    num_predicted(k) = min(k, n_targets) (the scatter writes exactly that
    many ones), num_total = per-query label population (rank-independent).
    The 100-query chunking and f32 arithmetic are replicated expression-for-
    expression so the floating-point accumulation matches bitwise."""
    query_labels = np.asarray(query_labels)
    target_labels = np.asarray(target_labels)
    ks = (1, 5, 10, 50, 100, 200)
    metrics = {f"Real2Sketch_R@{k}": 0.0 for k in ks}
    metrics.update({f"Real2Sketch_P@{k}": 0.0 for k in ks})
    n_targets = len(target_labels)
    top_labels = target_labels[np.asarray(top_idx)]  # (Q, K)
    for start in range(0, len(query_labels), 100):
        labels = query_labels[start:start + 100]
        n_b = len(labels)
        match = (top_labels[start:start + 100] ==
                 labels[:, None]).astype(np.float32)
        num_total = (labels[:, None] ==
                     target_labels[None, :]).astype(np.float32).sum(axis=1)
        for k in ks:
            num_correct = match[:, :k].sum(axis=1)
            num_predicted = np.float32(min(k, n_targets))
            recall = float(np.mean(num_correct / (num_total + 1e-5)))
            precision = float(np.mean(num_correct / num_predicted))
            metrics[f"Real2Sketch_R@{k}"] += recall * n_b
            metrics[f"Real2Sketch_P@{k}"] += precision * n_b
    for k in ks:
        metrics[f"Real2Sketch_R@{k}"] /= len(query_labels)
        metrics[f"Real2Sketch_P@{k}"] /= len(query_labels)
    return metrics
