"""Work counts as plain functions of shapes, and the card's peaks.

Model FLOPs count the published model's forward: every layer of a tower
at every token (the program's pooled last block saves some of it; that
saving is the program's, not less work of the model), a multiply-add as 2.
Attention over S keys counts 2·S·Dh per query row for q·kᵀ and as much for
P·V; a causal row i sees i + 1 keys.  Kernel work (the roofline rule):
each input read once, each output written once, operations over the
dtype's peak, the larger of the two times.
"""

from __future__ import annotations

from typing import Iterable, List, NamedTuple, Optional, Sequence

# Published peaks of one H100 SXM (dense; NVIDIA's data sheet).
PEAK_BF16 = 989e12
PEAK_TF32x3 = 494.7e12 / 3        # f32 products as three TF32 terms on tensor cores
PEAK_F32_FMA = 67e12              # f32 on CUDA cores
HBM_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


class Call(NamedTuple):
    """One kernel call's work: operations, bytes and the operations' peak."""

    flops: float
    bytes: float
    peak: float

    @property
    def bound_s(self) -> float:
        return max(self.bytes / HBM_BYTES_PER_S, self.flops / self.peak)


def bound_s(calls: Iterable[Call]) -> float:
    return sum(c.bound_s for c in calls)


def roofline_pct(calls: Sequence[Call], seconds: float) -> Optional[float]:
    """The share of their roofline that kernels reach: the least time of
    ``calls`` over the device seconds they took; None where none ran."""
    return 100.0 * bound_s(calls) / seconds if calls and seconds > 0 else None


# -- attention ---------------------------------------------------------------

def key_pairs(S: int, causal: bool) -> int:
    """(query, key) pairs of one head over S tokens."""
    return S * (S + 1) // 2 if causal else S * S


def attention_flops(pairs: int, heads: int, dh: int) -> float:
    return 4.0 * pairs * heads * dh


def b2_call(B: int, H: int, S: int, dh: int, causal: bool, dtype: str) -> Call:
    """B2, the fused attention forward: q, k, v read, the output written."""
    peak = PEAK_BF16 if dtype != "float32" else PEAK_TF32x3
    return Call(B * attention_flops(key_pairs(S, causal), H, dh),
                4.0 * B * H * S * dh * DTYPE_BYTES[dtype], peak)


def b2_rows(lengths: Sequence[int], H: int, dh: int, dtype: str) -> Call:
    """B2 over causal rows of their own real lengths (a text batch)."""
    pairs = sum(key_pairs(int(n), True) for n in lengths)
    tokens = sum(int(n) for n in lengths)
    peak = PEAK_BF16 if dtype != "float32" else PEAK_TF32x3
    return Call(attention_flops(pairs, H, dh), 4.0 * tokens * H * dh * DTYPE_BYTES[dtype],
                peak)


def b2bwd_call(B: int, H: int, S: int, dh: int, causal: bool, dtype: str) -> Call:
    """B2′, the attention backward: P recomputed (q·kᵀ), dV = Pᵀ·dO,
    dP = dO·Vᵀ, dQ = dS·K, dK = dSᵀ·Q, five products; q, k, v, dO read and
    dq, dk, dv written."""
    peak = PEAK_BF16 if dtype != "float32" else PEAK_TF32x3
    return Call(2.5 * B * attention_flops(key_pairs(S, causal), H, dh),
                7.0 * B * H * S * dh * DTYPE_BYTES[dtype], peak)


def b2bwd_rows(lengths: Sequence[int], H: int, dh: int, dtype: str) -> Call:
    """B2′ over causal rows of their own real lengths."""
    pairs = sum(key_pairs(int(n), True) for n in lengths)
    tokens = sum(int(n) for n in lengths)
    peak = PEAK_BF16 if dtype != "float32" else PEAK_TF32x3
    return Call(2.5 * attention_flops(pairs, H, dh), 7.0 * tokens * H * dh * DTYPE_BYTES[dtype],
                peak)


# -- B1, the top-k search ----------------------------------------------------

def b1_call(B: int, N: int, D: int, k: int, dtype: str) -> Call:
    """B1, exact top-k by inner product: 2·B·N·D operations; the queries
    and the table read once, k f32 values and int32 indices a query written.
    f32 scores run on CUDA cores (exact FMA), bf16 on tensor cores."""
    peak = PEAK_BF16 if dtype != "float32" else PEAK_F32_FMA
    return Call(2.0 * B * N * D, (B + N) * D * DTYPE_BYTES[dtype] + 8.0 * B * k, peak)


# -- whole models ------------------------------------------------------------

def tower_flops(tokens: int, width: int, layers: int, pairs: int) -> float:
    """Residual attention blocks over ``tokens`` tokens: q, k, v, out (8·W²
    a token), the 4x MLP (16·W²), and attention over ``pairs`` (query, key)
    pairs of every head (4·W a pair, over all heads)."""
    return layers * (24.0 * tokens * width * width + 4.0 * pairs * width)


def vit_block_flops(cfg: dict) -> float:
    """The ViT's blocks for one image (GEMMs and attention)."""
    S = (cfg["image_resolution"] // cfg["vision_patch_size"]) ** 2 + 1
    return tower_flops(S, cfg["vision_width"], cfg["vision_layers"], S * S)


def vit_flops(cfg: dict) -> float:
    """One image through the image tower: patch embedding, blocks, proj."""
    P, W = cfg["vision_patch_size"], cfg["vision_width"]
    n = (cfg["image_resolution"] // P) ** 2
    return 2.0 * n * P * P * 3 * W + vit_block_flops(cfg) + 2.0 * W * cfg["embed_dim"]


def text_flops(cfg: dict, lengths: Iterable[int]) -> float:
    """The causal text tower over rows of these real token counts, each
    pooled row projected."""
    W = cfg["transformer_width"]
    return sum(tower_flops(int(n), W, cfg["transformer_layers"], key_pairs(int(n), True))
               + 2.0 * W * cfg["embed_dim"] for n in lengths)


def heads_flops(cfg: dict, k: int) -> float:
    """KEDs' heads for one query: IM2TEXT over the feature and its 2k
    neighbours, and two CrossFormers of one query over k keys."""
    h, e, tw = cfg["heads"], cfg["embed_dim"], cfg["transformer_width"]
    m = h["im2text_middle_dim"]
    dims = [e] + [m] * h["im2text_layers"] + [tw]
    i2t = sum(2.0 * a * b for a, b in zip(dims[:-1], dims[1:]))
    inner = h["crossformer_heads"] * h["crossformer_dim_head"]
    layer = (2.0 * tw * inner * (1 + 2 * k) + 2.0 * inner * tw + 4.0 * k * inner)
    return (1 + 2 * k) * i2t + 2 * h["crossformer_layers"] * layer


def search_flops(B: int, N: int, D: int) -> float:
    return 2.0 * B * N * D


# -- a step's shapes ---------------------------------------------------------
# A driver describes each traced batch, request or training step by what it
# sent, as a dict: ``images`` through the image tower in calls of
# ``encode_chunk`` images; ``searches``, each [B, N, D, k, dtype]; ``heads``,
# [queries, k] through KEDs' heads; ``text``, the real token count of each
# row through the text tower; ``backward``, true where the heads and the
# text tower are differentiated (a training step).  Each reader computes its
# kernels' calls from these with the functions here.

def step_flops(cfg: dict, step: dict) -> float:
    """A step's model FLOPs: every forward, and in a training step the
    heads' backward (twice their forward) and the frozen text tower's input
    gradient (once its forward)."""
    back = bool(step.get("backward"))
    queries, k = step.get("heads", (0, 0))
    return (step.get("images", 0) * vit_flops(cfg)
            + sum(search_flops(B, N, D) for B, N, D, _, _ in step.get("searches", ()))
            + (3 if back else 1) * queries * heads_flops(cfg, k)
            + (2 if back else 1) * text_flops(cfg, step.get("text", ())))


def vision_b2_calls(cfg: dict, images: int, chunk: int) -> List[Call]:
    """B2 in every vision block over ``chunk``-image pieces."""
    S = (cfg["image_resolution"] // cfg["vision_patch_size"]) ** 2 + 1
    H = cfg["vision_width"] // 64
    return [b2_call(chunk, H, S, 64, False, cfg["compute_dtype"])
            for _ in range(cfg["vision_layers"] * (images // chunk))]


def text_b2_calls(cfg: dict, lengths: Sequence[int]) -> List[Call]:
    H = cfg["transformer_width"] // 64
    return [b2_rows(lengths, H, 64, cfg["compute_dtype"])] * cfg["transformer_layers"]


def text_b2bwd_calls(cfg: dict, lengths: Sequence[int]) -> List[Call]:
    H = cfg["transformer_width"] // 64
    return [b2bwd_rows(lengths, H, 64, cfg["compute_dtype"])] * cfg["transformer_layers"]
