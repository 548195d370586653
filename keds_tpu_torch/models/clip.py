"""CLIP image and text towers over parameter dicts (counterpart of the
composed-query subset of ``keds_tpu/models/clip.py``).

Parameters are the JAX pytree as a nested dict of tensors (see
:mod:`keds_tpu_torch.models.convert`): the image tower is patchify (im2row +
matmul) -> CLS -> pos-embed -> pre-LN -> blocks -> post-LN on CLS ->
projection, the text tower token + pos embed -> causal blocks -> final LN ->
pool -> projection.  Images are NHWC, tokens (B, S) integers.  The final
block of both towers runs pooled (:func:`layers.transformer_pooled`).  Three
splices put pseudo-tokens into the text: before a fixed prompt's EOT
(image-stream training), at a ``*`` (composed queries) and in place over
template stars (text-stream training).  The
causal mask (``causal_mask`` in the JAX package's clip module) lives with
the attention op, which applies it itself.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from keds_tpu_torch.models.layers import layer_norm, transformer_pooled
from keds_tpu_torch.transforms import device_normalize


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    embed_dim: int = 768
    image_resolution: int = 224
    # int = ViT depth; tuple = ModifiedResNet stage counts (not ported yet)
    vision_layers: object = 24
    vision_width: int = 1024
    vision_patch_size: int = 14
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 768
    transformer_heads: int = 12
    transformer_layers: int = 12

    @property
    def is_vit(self) -> bool:
        return not isinstance(self.vision_layers, (tuple, list))

    @property
    def vision_heads(self) -> int:
        return (self.vision_width // 64 if self.is_vit
                else self.vision_width * 32 // 64)

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch_size

    @property
    def n_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def eot_id(self) -> int:
        return self.vocab_size - 1


VIT_L_14 = ClipConfig()
VIT_B_32 = ClipConfig(embed_dim=512, vision_layers=12, vision_width=768,
                      vision_patch_size=32, transformer_width=512,
                      transformer_heads=8)
VIT_B_16 = ClipConfig(embed_dim=512, vision_layers=12, vision_width=768,
                      vision_patch_size=16, transformer_width=512,
                      transformer_heads=8)
VIT_H_14 = ClipConfig(embed_dim=1024, vision_layers=32, vision_width=1280,
                      vision_patch_size=14, transformer_width=1024,
                      transformer_heads=16, transformer_layers=24)

MODEL_CONFIGS = {
    "ViT-L/14": VIT_L_14,
    "ViT-B/32": VIT_B_32,
    "ViT-B/16": VIT_B_16,
    "ViT-H-14": VIT_H_14,
}

# Images per encode chunk in encode_image_chunked (the serving engine's
# default, as in the JAX package).
DEFAULT_ENCODE_CHUNK = 16


# --------------------------------------------------------------------------
# Image tower
# --------------------------------------------------------------------------

def _patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """NHWC images -> (B, n_patches, patch*patch*3) rows in (ky, kx, c) order."""
    B, H, W, C = images.shape
    gy, gx = H // patch, W // patch
    x = images.reshape(B, gy, patch, gx, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gy * gx, patch * patch * C)


def vision_tokens(params: dict, cfg: ClipConfig, images: torch.Tensor) -> torch.Tensor:
    """Embedded token sequence before the transformer: (B, 1+N, width)."""
    v = params["visual"]
    dtype = v["patch_w"].dtype
    x = torch.matmul(_patchify(images.to(dtype), cfg.vision_patch_size), v["patch_w"])
    cls = v["cls"].expand(x.shape[0], 1, cfg.vision_width)
    x = torch.cat([cls, x], dim=1) + v["pos"].to(dtype)
    return layer_norm(x, v["ln_pre_g"], v["ln_pre_b"])


def encode_image(params: dict, cfg: ClipConfig, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, embed_dim); ViT towers only."""
    if not cfg.is_vit:
        raise NotImplementedError("ModifiedResNet image towers are not ported yet")
    v = params["visual"]
    x = vision_tokens(params, cfg, images)
    cls = transformer_pooled(x, v["blocks"], cfg.vision_heads, 0, causal=False)
    cls = layer_norm(cls, v["ln_post_g"], v["ln_post_b"])
    return torch.matmul(cls, v["proj"].to(cls.dtype))


def encode_image_chunked(params: dict, cfg: ClipConfig, images: torch.Tensor,
                         chunk: Optional[int] = None) -> torch.Tensor:
    """:func:`encode_image` over the batch in ``chunk``-sized pieces (one
    shot when ``chunk`` is None or does not divide the batch); uint8 inputs
    are normalised on the device."""
    B = images.shape[0]
    if chunk and B > chunk and B % chunk == 0:
        return torch.cat([encode_image(params, cfg, device_normalize(im))
                          for im in images.split(chunk)])
    return encode_image(params, cfg, device_normalize(images))


# --------------------------------------------------------------------------
# Text tower
# --------------------------------------------------------------------------

def eot_indices(text: torch.Tensor, eot_id: int) -> torch.Tensor:
    """Index of the first EOT token per row."""
    return torch.argmax((text == eot_id).int(), dim=1)


def _text_tail_pooled(params: dict, cfg: ClipConfig, x: torch.Tensor,
                      pool_idx) -> torch.Tensor:
    """Positional embedding, causal blocks with a pooled final block, final
    LN and projection at ``pool_idx``.  S comes from the input, not the
    config: a causal tower over a prefix gives the same outputs at those
    positions, so callers may truncate.  The pool index is clamped to S-1
    (a truncated caption's splice can push EOT+K-1 past the end)."""
    t = params["text"]
    B, S, _ = x.shape
    x = x + t["pos"][:S].to(x.dtype)
    idx = torch.as_tensor(pool_idx, device=x.device).long().expand(B).clamp(0, S - 1)
    row = transformer_pooled(x, t["blocks"], cfg.transformer_heads, idx, causal=True)
    row = layer_norm(row, t["ln_final_g"], t["ln_final_b"])
    return torch.matmul(row, t["proj"].to(row.dtype))


def encode_text(params: dict, cfg: ClipConfig, text: torch.Tensor) -> torch.Tensor:
    """(B, S) int tokens -> (B, embed_dim), pooled at the first EOT."""
    text = text.long()
    x = params["text"]["tok_emb"][text]
    return _text_tail_pooled(params, cfg, x, eot_indices(text, cfg.eot_id))


# --------------------------------------------------------------------------
# Pseudo-token splicing
# --------------------------------------------------------------------------

def splice_tokens(embeds: torch.Tensor, pseudo: torch.Tensor, insert_pos,
                  n_replace: int) -> torch.Tensor:
    """Insert ``pseudo`` (B, K, D) into ``embeds`` (B, S, D) at ``insert_pos``
    (scalar or (B,)), replacing ``n_replace`` tokens; the rest shifts right
    and the tail is dropped, so the shape is unchanged."""
    B, S, D = embeds.shape
    K = pseudo.shape[1]
    dev = embeds.device
    ins = torch.as_tensor(insert_pos, device=dev).long().expand(B)[:, None]
    pos = torch.arange(S, device=dev)[None, :]
    tail_src = (pos - (K - n_replace)).clamp(0, S - 1)
    gather_idx = torch.where(pos < ins, pos, tail_src)
    base = torch.gather(embeds, 1, gather_idx[:, :, None].expand(B, S, D))
    pseudo_idx = (pos - ins).clamp(0, K - 1)
    pseudo_vals = torch.gather(pseudo.to(embeds.dtype), 1,
                               pseudo_idx[:, :, None].expand(B, S, D))
    in_pseudo = (pos >= ins) & (pos < ins + K)
    return torch.where(in_pseudo[:, :, None], pseudo_vals, base)


def encode_text_img(params: dict, cfg: ClipConfig, text: torch.Tensor,
                    img_tokens: torch.Tensor) -> torch.Tensor:
    """Insert K pseudo-tokens immediately before the EOT of a fixed prompt
    (the image-stream train prompt "a photo of"): the splice point is row
    0's EOT, nothing is replaced, and each row pools at its EOT + K.
    Gradients reach ``img_tokens`` through the splice and the tower."""
    K = img_tokens.shape[1]
    text = text.long()
    x = params["text"]["tok_emb"][text]
    eot = eot_indices(text, cfg.eot_id)
    x = splice_tokens(x, img_tokens, eot[0], n_replace=0)
    return _text_tail_pooled(params, cfg, x, eot + K)


def encode_text_img_retrieval(params: dict, cfg: ClipConfig, text: torch.Tensor,
                              img_tokens: torch.Tensor, split_id: int) -> torch.Tensor:
    """Replace the ``*`` placeholder (``split_id``; its position is taken from
    row 0) with K pseudo-tokens and pool at EOT + K - 1.  A single text row is
    broadcast over the image batch."""
    B, K = img_tokens.shape[:2]
    text = text.long()
    if text.shape[0] == 1 and B > 1:
        text = text.expand(B, text.shape[1])
    x = params["text"]["tok_emb"][text]
    eot = eot_indices(text, cfg.eot_id)
    star = torch.argmax((text[0] == split_id).int())
    x = splice_tokens(x, img_tokens, star, n_replace=1)
    return _text_tail_pooled(params, cfg, x, eot + (K - 1))


def encode_text_img_train(params: dict, cfg: ClipConfig, text: torch.Tensor,
                          img_tokens: torch.Tensor, split_id: int) -> torch.Tensor:
    """Replace K consecutive slots in place, from the first ``*`` of row 0
    (the text stream's "a photo of * * * {other}" templates); the length and
    each row's EOT are unchanged and each row pools at its EOT.  A template
    with more stars than K keeps the rest as tokens."""
    K = img_tokens.shape[1]
    text = text.long()
    x = params["text"]["tok_emb"][text]
    star = torch.argmax((text[0] == split_id).int())
    x = splice_tokens(x, img_tokens, star, n_replace=K)
    return _text_tail_pooled(params, cfg, x, eot_indices(text, cfg.eot_id))
