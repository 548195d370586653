"""CLIP image and text towers over parameter dicts (counterpart of
``keds_tpu/models/clip.py``).

Parameters are the JAX pytree as a nested dict of tensors (see
:mod:`keds_tpu_torch.models.convert`): the ViT image tower is patchify
(im2row + matmul) -> CLS -> pos-embed -> pre-LN -> blocks -> post-LN on
CLS -> projection; an RN config (tuple ``vision_layers``) runs the
ModifiedResNet tower of :mod:`keds_tpu_torch.models.resnet` instead.  The
text tower is token + pos embed -> causal blocks -> final LN -> pool ->
projection.  Images are NHWC, tokens (B, S) integers.  The final block of
both towers runs pooled (:func:`layers.transformer_pooled`);
:func:`get_text_tokens` keeps the whole final-LN sequence instead.  Three
splices put pseudo-tokens into the text: before a fixed prompt's EOT
(image-stream training), at a ``*`` (composed queries) and in place over
template stars (text-stream training); a fourth replaces each row's own
``*`` (:func:`encode_text_img_vis`).  The rest of the model surface: the
full token sequence and every block's output of the ViT tower, the
visual-invert and textual-invert compositions, MAE masking and
:func:`clip_forward`.  The causal mask (:func:`causal_mask`, as in the JAX
package's clip module) lives with the attention op, which applies it
itself; it is re-exported here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from keds_tpu_torch.models.layers import (_layer, _n_layers, layer_norm, residual_block,
                                          transformer, transformer_collect,
                                          transformer_pooled)
from keds_tpu_torch.models.resnet import encode_image_resnet
from keds_tpu_torch.ops.attention import causal_mask  # noqa: F401  (public name)
from keds_tpu_torch.transforms import device_normalize


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    embed_dim: int = 768
    image_resolution: int = 224
    # int = ViT depth; tuple = ModifiedResNet stage counts
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



def model_config_for(name: str) -> ClipConfig:
    """The from-scratch architecture preset of ``--model``."""
    if name in MODEL_CONFIGS:
        return MODEL_CONFIGS[name]
    raise KeyError(
        f"no from-scratch config for {name!r} (RN-family towers load from "
        "checkpoints only; their BatchNorm runs in inference mode)"
    )


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
    """(B, H, W, 3) -> (B, embed_dim) through the ViT or the ModifiedResNet
    tower, as the config says."""
    if not cfg.is_vit:
        return encode_image_resnet(params, images, cfg.vision_heads)
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


def encode_image_tokens(params: dict, cfg: ClipConfig, images: torch.Tensor) -> torch.Tensor:
    """The ViT tower's whole post-transformer sequence (B, 1+N, width),
    without post-LN or projection (reference ``VisualTransformer.get_tokens``)."""
    return transformer(vision_tokens(params, cfg, images), params["visual"]["blocks"],
                       cfg.vision_heads, causal=False)


def _visual_tail(params: dict, x: torch.Tensor) -> torch.Tensor:
    v = params["visual"]
    cls = layer_norm(x[:, 0, :], v["ln_post_g"], v["ln_post_b"])
    return torch.matmul(cls, v["proj"].to(cls.dtype))


def encode_image_mid_features(params: dict, cfg: ClipConfig, images: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The projected CLS embedding and every ViT block's output
    (L, B, 1+N, width): the reference's ``mid_feature`` mode."""
    x, mids = transformer_collect(vision_tokens(params, cfg, images),
                                  params["visual"]["blocks"], cfg.vision_heads)
    return _visual_tail(params, x), mids


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


def _pool_project(params: dict, x: torch.Tensor, pool_idx: torch.Tensor) -> torch.Tensor:
    """The row of each sequence at ``pool_idx`` (clamped into the sequence)
    through the text projection."""
    idx = pool_idx.clamp(0, x.shape[1] - 1)
    pooled = x[torch.arange(x.shape[0], device=x.device), idx]
    return torch.matmul(pooled, params["text"]["proj"].to(x.dtype))


def encode_text(params: dict, cfg: ClipConfig, text: torch.Tensor) -> torch.Tensor:
    """(B, S) int tokens -> (B, embed_dim), pooled at the first EOT."""
    text = text.long()
    x = params["text"]["tok_emb"][text]
    return _text_tail_pooled(params, cfg, x, eot_indices(text, cfg.eot_id))


def get_text_tokens(params: dict, cfg: ClipConfig,
                    text: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The final-LN token sequence (B, S, width) of the causal text tower
    and each row's EOT index (reference ``get_text_tokens``,
    model.py:592-605): the keys and values of the demo's late fusion."""
    t = params["text"]
    text = text.long()
    S = text.shape[1]
    x = t["tok_emb"][text]
    x = transformer(x + t["pos"][:S].to(x.dtype), t["blocks"], cfg.transformer_heads,
                    causal=True)
    return layer_norm(x, t["ln_final_g"], t["ln_final_b"]), eot_indices(text, cfg.eot_id)


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


def encode_text_img_vis(params: dict, cfg: ClipConfig, text: torch.Tensor,
                        img_tokens, split_id: int) -> torch.Tensor:
    """Each row's own ``*`` replaced in place by that row's image token (the
    demo's visualisation splice): ``img_tokens`` is (B, D), or a tuple of
    (B, D) for the first, second, ... ``*``.  Each row pools at its EOT.  A
    row with fewer stars than tokens raises ``ValueError``."""
    t = params["text"]
    text = text.long()
    x = t["tok_emb"][text]
    toks = img_tokens if isinstance(img_tokens, tuple) else (img_tokens,)
    is_star = (text == split_id).int()
    n_stars = is_star.sum(dim=1)
    short = n_stars < len(toks)
    if bool(short.any()):
        bad = int(torch.argmax(short.int()))
        raise ValueError(
            f"encode_text_img_vis: row {bad} has {int(n_stars[bad])} "
            f"'*' placeholder(s) but {len(toks)} image tokens were given")
    cum = torch.cumsum(is_star, dim=1)
    for n, tok in enumerate(toks):
        pos = torch.argmax(((is_star == 1) & (cum == n + 1)).int(), dim=1)
        x = splice_tokens(x, tok[:, None, :], pos, n_replace=1)
    return _text_tail_pooled(params, cfg, x, eot_indices(text, cfg.eot_id))


def get_text_mid_cross_feature(params: dict, cfg: ClipConfig, text: torch.Tensor,
                               img_tokens: torch.Tensor, cross_params: list,
                               crossformer_apply: Callable) -> torch.Tensor:
    """Textual-invert mode: before each of text blocks 0..5 (never the
    last), the EOT position of row 0, taken for every row, cross-attends
    over ``img_tokens`` and the result is added back; the tower runs over
    the full context (``text`` is (B, context_length)) and pools at each
    row's EOT.  ``crossformer_apply(cross_params, q, k, v)``."""
    t = params["text"]
    text = text.long()
    x = t["tok_emb"][text]
    eot = eot_indices(text, cfg.eot_id)
    x = x + t["pos"].to(x.dtype)
    n = _n_layers(t["blocks"])
    ci = int(eot[0])
    for i in range(n):
        if i != n - 1 and i <= 5:
            eos = crossformer_apply(cross_params, x[:, ci:ci + 1], img_tokens, img_tokens)
            x = torch.cat([x[:, :ci], x[:, ci:ci + 1] + eos.to(x.dtype), x[:, ci + 1:]],
                          dim=1)
        x = residual_block(x, _layer(t["blocks"], i), cfg.transformer_heads, causal=True)
    x = layer_norm(x, t["ln_final_g"], t["ln_final_b"])
    return _pool_project(params, x, eot)


# --------------------------------------------------------------------------
# Visual-invert composition
# --------------------------------------------------------------------------

def masking_from_noise(x: torch.Tensor, noise: torch.Tensor, mask_ratio: float):
    """MAE-style per-sample masking by ``noise`` (N, L): the tokens of the
    ``int(L * (1 - mask_ratio))`` smallest noise values are kept, in that
    order.  Returns (kept tokens, binary mask (1 = removed) in the original
    order, restore indices)."""
    N, L, D = x.shape
    len_keep = max(int(L * (1.0 - mask_ratio)), 0)
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    x_masked = torch.gather(x, 1, ids_keep[:, :, None].expand(N, len_keep, D))
    mask = torch.ones((N, L), dtype=x.dtype, device=x.device)
    mask[:, :len_keep] = 0
    return x_masked, torch.gather(mask, 1, ids_restore), ids_restore


def random_masking(generator: Optional[torch.Generator], x: torch.Tensor,
                   mask_ratio: float):
    """:func:`masking_from_noise` with uniform noise drawn from
    ``generator`` (on x's device)."""
    noise = torch.rand(x.shape[:2], generator=generator, device=x.device)
    return masking_from_noise(x, noise, mask_ratio)


def get_visual_composed_features(params: dict, cfg: ClipConfig, text_feature: torch.Tensor,
                                 images: torch.Tensor, img2text_cross: Callable,
                                 generator: Optional[torch.Generator] = None,
                                 mask_ratio: float = 1.0) -> torch.Tensor:
    """Visual-invert composition: MAE-mask the patch tokens (at the live
    mask_ratio = 1 the tower runs over the CLS token alone), and before
    block L - 6 add ``img2text_cross(cls, text_feature, text_feature)``, a
    (B, 1, width) cross-attention of the CLS row against the text feature
    (B, D_text), into the CLS position.  Returns the projected CLS."""
    v = params["visual"]
    x = vision_tokens(params, cfg, images)
    x_masked, _, _ = random_masking(generator, x[:, 1:, :], mask_ratio)
    x = torch.cat([x[:, :1], x_masked], dim=1)
    inject = cfg.vision_layers - 6
    tf = text_feature[:, None, :]
    for i in range(_n_layers(v["blocks"])):
        if i == inject:
            fused = img2text_cross(x[:, :1], tf, tf)
            x = torch.cat([x[:, :1] + fused, x[:, 1:]], dim=1)
        x = residual_block(x, _layer(v["blocks"], i), cfg.vision_heads, causal=False)
    return _visual_tail(params, x)


def get_visual_composed_features_eval(params: dict, cfg: ClipConfig,
                                      text_feature: torch.Tensor, images: torch.Tensor,
                                      img2text_cross: Callable,
                                      generator: Optional[torch.Generator] = None,
                                      mask_ratio: float = 1.0) -> torch.Tensor:
    """The eval twin of :func:`get_visual_composed_features` (the same
    computation)."""
    return get_visual_composed_features(params, cfg, text_feature, images, img2text_cross,
                                        generator, mask_ratio)


def clip_forward(params: dict, cfg: ClipConfig, images: Optional[torch.Tensor],
                 text: Optional[torch.Tensor]):
    """Image features alone, text features alone, or both unit-normalised
    with exp(logit_scale)."""
    if images is None:
        return encode_text(params, cfg, text)
    if text is None:
        return encode_image(params, cfg, images)
    img = encode_image(params, cfg, images)
    txt = encode_text(params, cfg, text)
    img = img / img.norm(dim=-1, keepdim=True)
    txt = txt / txt.norm(dim=-1, keepdim=True)
    return img, txt, params["logit_scale"].exp()
