"""Transformer building blocks over parameter dicts (counterpart of
``keds_tpu/models/layers.py``).

Parameters keep the JAX layout: weights are ``(in, out)`` and every
per-layer tensor of a tower carries a leading layer axis.  LayerNorm is a
float32 island; QuickGELU is ``x * sigmoid(1.702 x)``; blocks are pre-LN
residual attention blocks with a 4x MLP.

The only attention masks in this model family are none and causal, so a
block takes ``causal: bool`` and the attention op masks keys itself: the
JAX package's 257 -> 264 sequence padding (a TPU sublane trick) has no
counterpart here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from keds_tpu_torch.ops.attention import attention
from keds_tpu_torch.ops.quant import int8_linear


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense layer, ``w`` is (in, out); computes in ``x``'s dtype.  The bias
    rides in the matrix product (one kernel: it is added in the f32
    accumulator before the output is rounded).  A ``{"q": int8, "s": f32}``
    weight (:func:`keds_tpu_torch.ops.quant.quantize_weight`) runs the W8A8
    int8 product instead (:func:`~keds_tpu_torch.ops.quant.int8_linear`)."""
    if isinstance(w, dict):
        return int8_linear(x, w, b)
    w = w.to(x.dtype)
    if b is None:
        return torch.matmul(x, w)
    y = torch.addmm(b.to(x.dtype), x.reshape(-1, x.shape[-1]), w)
    return y.view(*x.shape[:-1], w.shape[1])


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Float32-island LayerNorm: statistics, normalisation and the affine
    map in f32 (PyTorch's fused kernel accumulates a bf16 input in f32),
    result rounded once to x.dtype."""
    return F.layer_norm(x, (x.shape[-1],), scale.to(x.dtype), bias.to(x.dtype), eps)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _attention_ctx(x: torch.Tensor, qkv_w: torch.Tensor, qkv_b: torch.Tensor,
                   n_heads: int, causal: bool) -> torch.Tensor:
    """Attention context before the output projection, (B, S, D) -> (B, S, D).
    q, k and v stay strided views of the fused projection's output."""
    B, S, D = x.shape
    qkv = linear(x, qkv_w, qkv_b).view(B, S, 3, n_heads, D // n_heads)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    ctx = attention(q, k, v, causal)
    return ctx.transpose(1, 2).reshape(B, S, D)


def multi_head_attention(x: torch.Tensor, qkv_w: torch.Tensor, qkv_b: torch.Tensor,
                         out_w: torch.Tensor, out_b: torch.Tensor, n_heads: int,
                         causal: bool = False) -> torch.Tensor:
    """Batched self-attention, (B, S, D) -> (B, S, D); ``qkv_w`` is (D, 3D)."""
    return linear(_attention_ctx(x, qkv_w, qkv_b, n_heads, causal), out_w, out_b)


def residual_block(x: torch.Tensor, blk: dict, n_heads: int,
                   causal: bool = False) -> torch.Tensor:
    """One pre-LN residual attention block."""
    h = layer_norm(x, blk["ln1_g"], blk["ln1_b"])
    x = x + multi_head_attention(h, blk["qkv_w"], blk["qkv_b"], blk["out_w"],
                                 blk["out_b"], n_heads, causal)
    h = layer_norm(x, blk["ln2_g"], blk["ln2_b"])
    h = quick_gelu(linear(h, blk["fc_w"], blk["fc_b"]))
    return x + linear(h, blk["proj_w"], blk["proj_b"])


def _layer(blocks: dict, i: int) -> dict:
    """Layer ``i`` of stacked blocks; a quantized weight's ``q`` and ``s``
    are sliced on their layer axis too."""
    return {name: {k: v[i] for k, v in a.items()} if isinstance(a, dict) else a[i]
            for name, a in blocks.items()}


def _n_layers(blocks: dict) -> int:
    return blocks["ln1_g"].shape[0]


def transformer(x: torch.Tensor, blocks: dict, n_heads: int,
                causal: bool = False) -> torch.Tensor:
    """Run the stacked residual blocks (leading layer axis) in order."""
    for i in range(_n_layers(blocks)):
        x = residual_block(x, _layer(blocks, i), n_heads, causal)
    return x


def transformer_collect(x: torch.Tensor, blocks: dict, n_heads: int,
                        causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`transformer` that also returns every block's output, stacked
    (L, B, S, D): the reference's ``mid_feature`` mode."""
    outs = []
    for i in range(_n_layers(blocks)):
        x = residual_block(x, _layer(blocks, i), n_heads, causal)
        outs.append(x)
    return x, torch.stack(outs)


def final_block_pooled(x: torch.Tensor, blk: dict, n_heads: int, pool_idx,
                       causal: bool = False) -> torch.Tensor:
    """A residual block whose out-projection and MLP run only at the pooled
    row: (B, S, D) -> (B, D).  Attention runs over the full sequence (shared
    with :func:`residual_block`); after it nothing mixes tokens, so the other
    rows cannot change the pooled one.  ``pool_idx`` is a scalar or (B,)
    row index, already clamped by the caller.  A Python int index is filled
    in on the device, not copied from the host, so that a CUDA graph can
    capture the block."""
    B = x.shape[0]
    h = layer_norm(x, blk["ln1_g"], blk["ln1_b"])
    ctx = _attention_ctx(h, blk["qkv_w"], blk["qkv_b"], n_heads, causal)
    if isinstance(pool_idx, int):
        idx = torch.full((B,), pool_idx, dtype=torch.long, device=x.device)
    else:
        idx = torch.as_tensor(pool_idx, device=x.device).long().expand(B)
    rows = torch.arange(B, device=x.device)
    x_row = x[rows, idx] + linear(ctx[rows, idx], blk["out_w"], blk["out_b"])
    h2 = layer_norm(x_row, blk["ln2_g"], blk["ln2_b"])
    h2 = quick_gelu(linear(h2, blk["fc_w"], blk["fc_b"]))
    return x_row + linear(h2, blk["proj_w"], blk["proj_b"])


def transformer_pooled(x: torch.Tensor, blocks: dict, n_heads: int, pool_idx,
                       causal: bool = False) -> torch.Tensor:
    """:func:`transformer` whose final block runs its out-projection and MLP
    only at ``pool_idx``: (B, S, D) -> (B, D)."""
    n = _n_layers(blocks)
    for i in range(n - 1):
        x = residual_block(x, _layer(blocks, i), n_heads, causal)
    return final_block_pooled(x, _layer(blocks, n - 1), n_heads, pool_idx, causal)
