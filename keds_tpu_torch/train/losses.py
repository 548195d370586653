"""Training losses (counterpart of ``keds_tpu/train/losses.py``), image
stream.

The image stream (the reference's ``get_loss_img2text_image``) retrieves
the top-16 neighbours of each precomputed image feature, fuses them into 3
pseudo-tokens, splices those into the "a photo of" prompt, runs the frozen
text tower and takes the symmetric InfoNCE between the image features and
the composed text features over the batch.
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
    """One precomputed-feature batch of the image stream.  The optional
    index fields carry precomputed knowledge-DB neighbour rows; None keeps
    the in-step search.  (The text stream's template and caption-neighbour
    fields come with that stream.)"""

    image_features: torch.Tensor             # (B, D) CLIP image embeddings
    caption_features: torch.Tensor           # (B, D) CLIP caption embeddings
    img_idx: Optional[torch.Tensor] = None   # (B, k) image-DB neighbour rows
    txt_idx: Optional[torch.Tensor] = None   # (B, k) text-DB neighbour rows


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
