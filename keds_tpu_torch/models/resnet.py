"""ModifiedResNet image tower (counterpart of ``keds_tpu/models/resnet.py``).

CLIP's anti-aliased ResNet for the RN50 family: a 3-conv stem with an
average pool, bottleneck blocks where a stride above 1 is an average pool
before the third conv (and before the downsample conv of the shortcut),
and a QKV attention pool over the spatial mean and the positions.

Inference only: BatchNorm uses its running statistics, folded as the JAX
package folds them (``scale = g / sqrt(var + 1e-5)``, then ``x * scale +
(b - mean * scale)`` in the activation dtype).  Images come in as
(B, H, W, 3), as for every tower; the convolutions run in NCHW shape with
``channels_last`` memory (a free permute of NHWC) on OIHW weights, which
the converters keep in ``channels_last`` memory too, so cuDNN copies
neither.  The JAX tower runs its convolutions and its attention pool as
XLA ops, outside any Pallas kernel, so here they are ``F.conv2d`` and plain
matmul / softmax.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from keds_tpu_torch.models.layers import linear


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding)


def _bn(x: torch.Tensor, p: dict) -> torch.Tensor:
    scale = p["g"] / torch.sqrt(p["var"] + 1e-5)
    shift = p["b"] - p["mean"] * scale
    return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """VALID k x k windows at stride k, their sum over k * k."""
    return F.avg_pool2d(x, k, k)


BatchNorm = Callable[[torch.Tensor, dict], torch.Tensor]


def _bottleneck(x: torch.Tensor, p: dict, stride: int, bn: BatchNorm = _bn) -> torch.Tensor:
    """1x1 -> 3x3 -> avgpool(stride) -> 1x1 (x4), with an avgpool-prefixed
    downsample shortcut."""
    out = torch.relu(bn(_conv(x, p["conv1_w"]), p["bn1"]))
    out = torch.relu(bn(_conv(out, p["conv2_w"], padding=1), p["bn2"]))
    if stride > 1:
        out = _avg_pool(out, stride)
    out = bn(_conv(out, p["conv3_w"]), p["bn3"])
    identity = x
    if "down_conv_w" in p:
        if stride > 1:
            identity = _avg_pool(identity, stride)
        identity = bn(_conv(identity, p["down_conv_w"]), p["down_bn"])
    return torch.relu(out + identity)


def attention_pool_2d(x: torch.Tensor, p: dict, num_heads: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, out): the spatial mean prepended, the positions
    added, one attention step whose query is the mean token alone (scores
    and softmax in f32, probabilities in x's dtype), then ``c_proj``."""
    B, H, W, C = x.shape
    seq = x.reshape(B, H * W, C)
    seq = torch.cat([seq.mean(dim=1, keepdim=True), seq], dim=1) + p["pos"].to(x.dtype)
    S, Dh = seq.shape[1], C // num_heads
    q = linear(seq[:, :1], p["q_w"], p["q_b"]).view(B, 1, num_heads, Dh).transpose(1, 2)
    k = linear(seq, p["k_w"], p["k_b"]).view(B, S, num_heads, Dh).transpose(1, 2)
    v = linear(seq, p["v_w"], p["v_b"]).view(B, S, num_heads, Dh).transpose(1, 2)
    scores = torch.matmul((q / math.sqrt(Dh)).float(), k.float().transpose(-1, -2))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.matmul(probs, v).transpose(1, 2).reshape(B, C)
    return linear(ctx, p["c_w"], p["c_b"])


def encode_image_resnet(params: dict, images: torch.Tensor, num_heads: int,
                        bn: BatchNorm = _bn) -> torch.Tensor:
    """(B, H, W, 3) -> (B, embed_dim) through the ModifiedResNet tower;
    ``num_heads`` is the attention pool's (vision_width * 32 // 64).  ``bn``
    replaces the BatchNorm (``synth`` calibrates random weights with it)."""
    v = params["visual"]
    stem = v["stem"]
    x = images.to(stem["conv1_w"].dtype).permute(0, 3, 1, 2)     # NCHW, channels_last
    x = torch.relu(bn(_conv(x, stem["conv1_w"], stride=2, padding=1), stem["bn1"]))
    x = torch.relu(bn(_conv(x, stem["conv2_w"], padding=1), stem["bn2"]))
    x = torch.relu(bn(_conv(x, stem["conv3_w"], padding=1), stem["bn3"]))
    x = _avg_pool(x, 2)
    for li, layer in enumerate(v["layers"]):
        for bi, block in enumerate(layer):
            x = _bottleneck(x, block, 2 if (li > 0 and bi == 0) else 1, bn)
    return attention_pool_2d(x.permute(0, 2, 3, 1), v["attnpool"], num_heads)


def channels_last(visual: dict) -> dict:
    """The RN visual tree with its (OIHW) conv weights in ``channels_last``
    memory, the layout cuDNN takes them in beside channels_last images."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(a) for k, a in t.items()}
        if isinstance(t, list):
            return [walk(a) for a in t]
        return t.contiguous(memory_format=torch.channels_last) if t.ndim == 4 else t

    return walk(visual)


# --------------------------------------------------------------------------
# Reference state-dict layout (the JAX package's resnet_state_dict_to_pytree
# and resnet_pytree_to_state_dict, with OIHW weights kept)
# --------------------------------------------------------------------------

_BN_KEYS = (("weight", "g"), ("bias", "b"), ("running_mean", "mean"), ("running_var", "var"))


def _block_parts(has_down: bool):
    """(torch module, port name) of a bottleneck's convs and BatchNorms."""
    parts = [(f"conv{i}", f"conv{i}_w", f"bn{i}", f"bn{i}") for i in (1, 2, 3)]
    if has_down:
        parts.append(("downsample.0", "down_conv_w", "downsample.1", "down_bn"))
    return parts


def resnet_from_state_dict(sd: dict, get) -> dict:
    """The RN visual tree of a reference CLIP state dict; ``get(key)`` reads
    one entry as an f32 array (Linear weights are transposed to (in, out),
    conv weights stay OIHW)."""
    def bn(prefix):
        return {ours: get(f"{prefix}.{name}") for name, ours in _BN_KEYS}

    stem = {}
    for i in (1, 2, 3):
        stem[f"conv{i}_w"], stem[f"bn{i}"] = get(f"visual.conv{i}.weight"), bn(f"visual.bn{i}")
    layers = []
    for li in (1, 2, 3, 4):
        n = len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{li}.")})
        blocks = []
        for bi in range(n):
            pre = f"visual.layer{li}.{bi}"
            blk = {}
            for conv, ours, norm, ours_bn in _block_parts(f"{pre}.downsample.0.weight" in sd):
                blk[ours], blk[ours_bn] = get(f"{pre}.{conv}.weight"), bn(f"{pre}.{norm}")
            blocks.append(blk)
        layers.append(blocks)
    ap = {"pos": get("visual.attnpool.positional_embedding")}
    for name in ("q", "k", "v", "c"):
        ap[f"{name}_w"] = get(f"visual.attnpool.{name}_proj.weight").T
        ap[f"{name}_b"] = get(f"visual.attnpool.{name}_proj.bias")
    return {"stem": stem, "layers": layers, "attnpool": ap}


def resnet_to_state_dict(visual: dict, cpu) -> dict:
    """Inverse of :func:`resnet_from_state_dict`: reference keys in the JAX
    converter's order, ``cpu(tensor)`` giving each value; each BatchNorm
    carries ``num_batches_tracked`` = 0 as the reference module does."""
    sd: dict = {}

    def bn(p, prefix):
        for name, ours in _BN_KEYS:
            sd[f"{prefix}.{name}"] = cpu(p[ours])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    stem = visual["stem"]
    for i in (1, 2, 3):
        sd[f"visual.conv{i}.weight"] = cpu(stem[f"conv{i}_w"])
        bn(stem[f"bn{i}"], f"visual.bn{i}")
    for li, layer in enumerate(visual["layers"], start=1):
        for bi, blk in enumerate(layer):
            pre = f"visual.layer{li}.{bi}"
            for conv, ours, norm, ours_bn in _block_parts("down_conv_w" in blk):
                sd[f"{pre}.{conv}.weight"] = cpu(blk[ours])
                bn(blk[ours_bn], f"{pre}.{norm}")
    ap = visual["attnpool"]
    sd["visual.attnpool.positional_embedding"] = cpu(ap["pos"])
    for name in ("q", "k", "v", "c"):
        sd[f"visual.attnpool.{name}_proj.weight"] = cpu(ap[f"{name}_w"].T)
        sd[f"visual.attnpool.{name}_proj.bias"] = cpu(ap[f"{name}_b"])
    return sd
