"""Training losses of the two streams (counterpart of
``keds_tpu/train/losses.py``), on precomputed CLIP features.

* The image stream (the reference's ``get_loss_img2text_image``) retrieves
  the top-16 neighbours of each image feature, fuses them into 3
  pseudo-tokens, splices those into the "a photo of" prompt, runs the frozen
  text tower and takes the symmetric InfoNCE between the image features and
  the composed text features over the batch.
* The text stream (``get_loss_img2text``) fuses without the text condition
  into 2 pseudo-tokens, writes them in place over the stars of the sample's
  own "a photo of * * * {other}" template and of its top-2 caption
  neighbours' "a photo of * * {other}" templates, and takes the cosine loss
  against the caption features: own + 0.5 x neighbours.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from keds_tpu_torch.models import clip as mclip
from keds_tpu_torch.models.composition import FusionHeads, compose_pseudo_tokens


def no_mark(stage: str) -> None:
    """The default stage-end callback of the train step: does nothing."""


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True)


def info_nce(image_features: torch.Tensor, text_features: torch.Tensor,
             logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric cross-entropy over the (B, B) similarity matrix with the
    diagonal as ground truth, (loss_img + loss_txt) / 2.  Inputs must be
    unit-norm; the logits are f32."""
    logits = logit_scale * torch.matmul(image_features.float(), text_features.float().T)
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2.0


def cosine_embedding_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch CosineEmbeddingLoss with target 1: mean(1 - cos(a, b))."""
    return torch.mean(1.0 - (_normalize(a) * _normalize(b)).sum(dim=-1))


class TrainBatch(NamedTuple):
    """One precomputed-feature batch.  The optional index fields carry
    precomputed knowledge-DB neighbour rows (all of a stream's or none);
    None keeps the in-step search.  ``other_tokens`` and ``cap2_idx`` belong
    to the text stream, which the image stream does not read."""

    image_features: torch.Tensor              # (B, D) CLIP image embeddings
    caption_features: torch.Tensor            # (B, D) CLIP caption embeddings
    img_idx: Optional[torch.Tensor] = None    # (B, k) image-DB neighbour rows
    txt_idx: Optional[torch.Tensor] = None    # (B, k) text-DB neighbour rows
    other_tokens: Optional[torch.Tensor] = None   # (B, S) "a photo of * * * {other}"
    cap2_idx: Optional[torch.Tensor] = None   # (B, 2) caption-DB neighbour rows


def image_stream_loss(heads: FusionHeads, clip_params: dict, cfg: mclip.ClipConfig,
                      batch: TrainBatch, topk_image: torch.Tensor,
                      topk_text: torch.Tensor, prompt_tokens: torch.Tensor,
                      generator: Optional[torch.Generator] = None, train: bool = True,
                      dropout: float = 0.1,
                      mark: Callable[[str], None] = no_mark) -> torch.Tensor:
    """InfoNCE between the image features and the text tower over the
    prompt (``prompt_tokens``, (1, S)) with the fused pseudo-tokens spliced
    in before its EOT.  ``mark("heads_forward")`` is called once the
    pseudo-tokens are made."""
    tokens = compose_pseudo_tokens(heads, batch.image_features, topk_image, topk_text,
                                   True, generator, train, dropout)
    mark("heads_forward")
    B = batch.image_features.shape[0]
    text = prompt_tokens.expand(B, prompt_tokens.shape[1])
    text_features = mclip.encode_text_img(clip_params, cfg, text, tokens)
    scale = torch.exp(clip_params["logit_scale"])
    return info_nce(_normalize(batch.image_features), _normalize(text_features), scale)


def text_stream_loss(heads: FusionHeads, clip_params: dict, cfg: mclip.ClipConfig,
                     batch: TrainBatch, topk_image: torch.Tensor,
                     topk_text: Optional[torch.Tensor], top2_caption_features: torch.Tensor,
                     top2_other_tokens: torch.Tensor, split_id: int,
                     generator: Optional[torch.Generator] = None, train: bool = True,
                     dropout: float = 0.1,
                     mark: Callable[[str], None] = no_mark) -> torch.Tensor:
    """Cosine loss of the own templates (``batch.other_tokens``) with the 2
    pseudo-tokens written over their stars against the caption features,
    plus 0.5 x the same over the top-2 neighbours' templates
    (``top2_other_tokens``, (B, 2, S)) against their caption rows
    (``top2_caption_features``, (B, 2, D)): 2B rows through the tower, each
    sample's pseudo-tokens repeated for its two neighbours.  ``topk_text``
    is not read (no text condition) and may be None.
    ``mark("heads_forward")`` is called once the pseudo-tokens are made.

    The reference weighs the two terms one way in its single-process branch
    and the other in its distributed one; the distributed branch is the
    trained configuration: own + 0.5 x neighbours."""
    tokens = compose_pseudo_tokens(heads, batch.image_features, topk_image, topk_text,
                                   False, generator, train, dropout)   # (B, 2, D)
    mark("heads_forward")
    own = mclip.encode_text_img_train(clip_params, cfg, batch.other_tokens, tokens,
                                      split_id=split_id)
    loss_main = cosine_embedding_loss(own, batch.caption_features)
    B, L, D = tokens.shape
    rep = tokens[:, None].expand(B, 2, L, D).reshape(2 * B, L, D)
    neigh = mclip.encode_text_img_train(clip_params, cfg,
                                        top2_other_tokens.reshape(2 * B, -1), rep,
                                        split_id=split_id)
    loss_extra = cosine_embedding_loss(neigh, top2_caption_features.reshape(2 * B, D))
    return loss_main + 0.5 * loss_extra
