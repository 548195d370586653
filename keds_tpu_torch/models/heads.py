"""Trainable heads (counterpart of ``keds_tpu/models/heads.py``).

* ``IM2TEXT``: n x [Linear -> Dropout -> ReLU] + output Linear, mapping a
  CLIP image embedding into the text-token space.
* ``CrossAttention``: q/k/v linears into heads * dim_head, scaled
  dot-product, output projection; no residual, no LayerNorm, no FFN.  (The
  reference follows ``to_out`` with a dropout whose rate is 0.0 on every
  path, so none is applied here.)
* ``CrossFormer``: a stack of CrossAttention layers with the query re-fed.

Parameters are the JAX pytree layout: ``{"w": (in, out), "b": (out,)}``
linears.  Dropout is explicit: it runs only with ``train=True`` and a
``torch.Generator`` on the tensors' device, which draws the masks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _proj(p: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p["w"].to(x.dtype)) + p["b"].to(x.dtype)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            train: bool, rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inverted dropout: each element is kept with probability 1 - rate and
    scaled by 1 / (1 - rate); a no-op unless ``train`` with a generator.
    ``rows=(start, total)`` says that ``x``'s rows are rows start.. of a
    batch of ``total``: the mask is drawn for the whole batch and this
    block's rows kept, so that each row's mask follows its global position
    and W ranks drop what one process drops."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    start, total = rows if rows is not None else (0, x.shape[0])
    mask = torch.rand((total,) + tuple(x.shape[1:]), generator=generator,
                      device=x.device)[start:start + x.shape[0]] < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def im2text_apply(params: dict, x: torch.Tensor,
                  generator: Optional[torch.Generator] = None, train: bool = False,
                  rate: float = 0.1, rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(..., embed_dim) -> (..., output_dim); ``rows`` places a batch's
    rows for :func:`dropout`."""
    for layer in params["layers"]:
        x = torch.relu(dropout(_proj(layer, x), rate, generator, train, rows))
    return _proj(params["fc_out"], x)


def crossattention_apply(params: dict, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, dim_head: int = 64) -> torch.Tensor:
    """q (B, Nq, Dq), k/v (B, Nk, Dk/Dv) -> (B, Nq, Dq).  Scores in f32,
    softmax over keys, probabilities cast back to q's dtype."""
    H = params["to_q"]["w"].shape[1] // dim_head
    B, Nq, _ = q.shape
    Nk = k.shape[1]

    def heads(p, x, n):
        return _proj(p, x).reshape(B, n, H, dim_head).transpose(1, 2)

    qh, kh, vh = heads(params["to_q"], q, Nq), heads(params["to_k"], k, Nk), heads(params["to_v"], v, Nk)
    dots = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * dim_head ** -0.5
    attn = torch.softmax(dots, dim=-1).to(q.dtype)
    out = torch.matmul(attn, vh).transpose(1, 2).reshape(B, Nq, H * dim_head)
    return _proj(params["to_out"], out)


def crossformer_apply(params: list, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, dim_head: int = 64) -> torch.Tensor:
    for layer in params:
        q = crossattention_apply(layer, q, k, v, dim_head)
    return q
