"""Training losses of the two streams (counterpart of
``keds_tpu/train/losses.py``), on precomputed CLIP features, and the
frozen-CLIP encode that turns a raw-image batch into features
(:func:`encode_raw_batch`).

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

Under a mesh each rank passes its own rows and gets the GLOBAL batch's
loss, with a gradient through its own rows only, so that the gradients
summed over the ranks are the global loss's (the reference all-gathers the
features, gradient through the local block, then DDP averages; PARITY.md
"Distributed loss semantics"): the image stream's InfoNCE runs over the
all-gathered features, the text stream's means add the other ranks' terms
as constants.  Dropout masks follow each row's global position.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from keds_tpu_torch.models import clip as mclip
from keds_tpu_torch.models.composition import FusionHeads, compose_pseudo_tokens
from keds_tpu_torch.parallel.mesh import Mesh, all_reduce_sum, batch_rows, gather_with_grad


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


class RawBatch(NamedTuple):
    """A raw (image, caption) batch of the csv or tar-stream loaders; the
    train step computes its CLIP features (the reference's webdataset mode,
    src/data.py:938-953)."""

    images: torch.Tensor          # (B, H, W, 3) uint8 (normalised on the device) or float
    caption_tokens: torch.Tensor  # (B, S) caption tokens, S a causal-prefix bucket


def encode_raw_batch(clip_params: dict, cfg: mclip.ClipConfig, batch: RawBatch,
                     encode_chunk: Optional[int] = mclip.DEFAULT_ENCODE_CHUNK,
                     captions: bool = True) -> TrainBatch:
    """Frozen-CLIP features of a raw batch under ``torch.no_grad()`` (the
    reference's torch.no_grad, src/trainer.py:48-52): the image tower in
    ``encode_chunk``-image chunks (uint8 normalised on the device) and the
    text tower over the captions, both returned in f32.

    The image stream reads no caption feature.  XLA drops the JAX step's
    caption encode as dead code; here the train step passes
    ``captions=False`` so that eager PyTorch does not run a text tower each
    step for nothing, and ``caption_features`` is then None.  The step's
    results are the same either way."""
    with torch.no_grad():
        img = mclip.encode_image_chunked(clip_params, cfg, batch.images, encode_chunk)
        txt = mclip.encode_text(clip_params, cfg, batch.caption_tokens) if captions else None
    return TrainBatch(image_features=img.float(),
                      caption_features=txt.float() if captions else None)


def image_stream_loss(heads: FusionHeads, clip_params: dict, cfg: mclip.ClipConfig,
                      batch: TrainBatch, topk_image: torch.Tensor,
                      topk_text: torch.Tensor, prompt_tokens: torch.Tensor,
                      generator: Optional[torch.Generator] = None, train: bool = True,
                      dropout: float = 0.1,
                      mark: Callable[[str], None] = no_mark,
                      mesh: Optional[Mesh] = None) -> torch.Tensor:
    """InfoNCE between the image features and the text tower over the
    prompt (``prompt_tokens``, (1, S)) with the fused pseudo-tokens spliced
    in before its EOT, over the features of every rank of ``mesh``.
    ``mark("heads_forward")`` is called once the pseudo-tokens are made."""
    B = batch.image_features.shape[0]
    tokens = compose_pseudo_tokens(heads, batch.image_features, topk_image, topk_text,
                                   True, generator, train, dropout, batch_rows(mesh, B))
    mark("heads_forward")
    text = prompt_tokens.expand(B, prompt_tokens.shape[1])
    text_features = mclip.encode_text_img(clip_params, cfg, text, tokens)
    scale = torch.exp(clip_params["logit_scale"])
    return info_nce(gather_with_grad(mesh, _normalize(batch.image_features)),
                    gather_with_grad(mesh, _normalize(text_features)), scale)


def text_stream_loss(heads: FusionHeads, clip_params: dict, cfg: mclip.ClipConfig,
                     batch: TrainBatch, topk_image: torch.Tensor,
                     topk_text: Optional[torch.Tensor], top2_caption_features: torch.Tensor,
                     top2_other_tokens: torch.Tensor, split_id: int,
                     generator: Optional[torch.Generator] = None, train: bool = True,
                     dropout: float = 0.1,
                     mark: Callable[[str], None] = no_mark,
                     mesh: Optional[Mesh] = None) -> torch.Tensor:
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
    trained configuration: own + 0.5 x neighbours.  Under ``mesh`` the
    value is the global batch's (every rank's rows the same count), the
    gradient this rank's share of it."""
    B = batch.image_features.shape[0]
    tokens = compose_pseudo_tokens(heads, batch.image_features, topk_image, topk_text,
                                   False, generator, train, dropout,
                                   batch_rows(mesh, B))   # (B, 2, D)
    mark("heads_forward")
    own = mclip.encode_text_img_train(clip_params, cfg, batch.other_tokens, tokens,
                                      split_id=split_id)
    loss_main = cosine_embedding_loss(own, batch.caption_features)
    _, L, D = tokens.shape
    rep = tokens[:, None].expand(B, 2, L, D).reshape(2 * B, L, D)
    neigh = mclip.encode_text_img_train(clip_params, cfg,
                                        top2_other_tokens.reshape(2 * B, -1), rep,
                                        split_id=split_id)
    loss_extra = cosine_embedding_loss(neigh, top2_caption_features.reshape(2 * B, D))
    loss = loss_main + 0.5 * loss_extra
    if batch_rows(mesh, B) is None:
        return loss
    total = all_reduce_sum(mesh, loss.detach().clone())   # the ranks' means, summed
    return (loss + (total - loss.detach())) / mesh.size
