"""Dual-stream knowledge-fusion composition (counterpart of
``keds_tpu/models/composition.py``):

    mapped = IM2TEXT(image_embedding)
    fused  = retrieval_fuse(mapped[:, None], IM2TEXT(topk_image_neighbours))
    cond   = text_condition(mapped[:, None], IM2TEXT(topk_text_neighbours))
    tokens = [fused, cond, mapped]    (K=3, image stream)
    tokens = [fused, mapped]          (K=2, text stream)
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from keds_tpu_torch.models.heads import crossformer_apply, im2text_apply


class FusionHeads(NamedTuple):
    """The three trainable modules of one stream."""

    img2text: dict
    retrieval_fuse: list
    text_condition: list


def compose_pseudo_tokens(heads: FusionHeads, image_features: torch.Tensor,
                          topk_image: torch.Tensor, topk_text: torch.Tensor,
                          use_text_condition: bool = True,
                          generator: Optional[torch.Generator] = None,
                          train: bool = False, dropout: float = 0.1,
                          rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(B, D) features and (B, k, D) neighbours -> pseudo tokens (B, 3, D),
    or (B, 2, D) without the text condition.  With ``train`` and a
    ``generator``, IM2TEXT drops at rate ``dropout``; the CrossFormers drop
    nothing (their rate is 0.0 in the reference).  ``rows=(start, total)``
    places these rows in a global batch for the masks
    (:func:`~keds_tpu_torch.models.heads.dropout`)."""
    q = im2text_apply(heads.img2text, image_features, generator, train, dropout,
                      rows)[:, None, :]
    ti = im2text_apply(heads.img2text, topk_image, generator, train, dropout, rows)
    parts = [crossformer_apply(heads.retrieval_fuse, q, ti, ti)]
    if use_text_condition:
        tt = im2text_apply(heads.img2text, topk_text, generator, train, dropout, rows)
        parts.append(crossformer_apply(heads.text_condition, q, tt, tt))
    parts.append(q)
    return torch.cat(parts, dim=1)
