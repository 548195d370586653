"""Parameters carried into the port (counterpart of
``keds_tpu/models/convert.py``).

The port keeps the JAX parameter layout: nested dicts with ``(in, out)``
weights and per-layer tensors stacked on a leading layer axis.  So the JAX
pytrees (as numpy arrays) convert leaf by leaf (:func:`clip_from_numpy`,
:func:`heads_from_numpy`), and the reference / OpenAI CLIP torch
state-dict layout and the heads' state dicts are read here too
(:func:`clip_from_state_dict`, :func:`heads_from_checkpoint`), so that real
checkpoints load with ``torch.load``.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

from keds_tpu_torch.models.clip import ClipConfig
from keds_tpu_torch.models.composition import FusionHeads
from keds_tpu_torch.models.resnet import (channels_last, resnet_from_state_dict,
                                          resnet_to_state_dict)
from keds_tpu_torch.runtime import DeviceLike, resolve_device

StateDict = Dict[str, object]


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _tensor(a, device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    # contiguous: a transposed (out, in) weight must not keep transposed
    # strides, or its products round differently from a freshly made one's
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=dtype).contiguous()
    a = np.asarray(a, np.float32)       # ascontiguousarray alone makes a 0-d array 1-d
    return torch.as_tensor(np.ascontiguousarray(a).reshape(a.shape)).to(device=device,
                                                                        dtype=dtype)


def cast_floating(tree, dtype: torch.dtype, device: DeviceLike = None):
    """Every floating tensor of a parameter tree cast to ``dtype`` on
    ``device``; integer tensors only move."""
    dev = resolve_device(device)

    def cast(a: torch.Tensor) -> torch.Tensor:
        return a.to(device=dev, dtype=dtype if a.is_floating_point() else a.dtype)

    return _map(tree, cast)


def params_from_numpy(tree, device: DeviceLike = None, dtype: torch.dtype = torch.float32):
    """A parameter tree of arrays (nested dicts and lists) as tensors."""
    dev = resolve_device(device)
    return _map(tree, lambda a: _tensor(a, dev, dtype))


def _is_resnet(params: dict) -> bool:
    return "stem" in params["visual"]


def _rn_channels_last(params: dict) -> dict:
    if _is_resnet(params):
        params = dict(params, visual=channels_last(params["visual"]))
    return params


def clip_from_numpy(params: dict, device: DeviceLike = None,
                    dtype: torch.dtype = torch.float32) -> dict:
    """The JAX CLIP pytree (nested dicts of arrays; an RN tower's blocks as
    lists of lists of dicts) as port parameters: an RN tower's HWIO conv
    kernels become OIHW weights (``channels_last`` memory)."""
    if _is_resnet(params):
        params = dict(params, visual=_map(
            params["visual"], lambda a: np.asarray(a).transpose(3, 2, 0, 1)
            if np.ndim(a) == 4 else a))
    return _rn_channels_last(params_from_numpy(params, device, dtype))


def heads_from_numpy(heads, device: DeviceLike = None,
                     dtype: torch.dtype = torch.float32) -> FusionHeads:
    """JAX ``FusionHeads`` (or any (img2text, retrieval_fuse, text_condition)
    triple of array trees) as port :class:`FusionHeads`."""
    dev = resolve_device(device)
    img2text, retrieval_fuse, text_condition = heads
    return FusionHeads(*(_map(t, lambda a: _tensor(a, dev, dtype))
                         for t in (img2text, retrieval_fuse, text_condition)))


# --------------------------------------------------------------------------
# Torch state-dict layouts
# --------------------------------------------------------------------------

def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().float().numpy()
    return np.asarray(a, np.float32)


def strip_module_prefix(sd: StateDict) -> StateDict:
    """Remove DDP 'module.' prefixes."""
    if sd and next(iter(sd)).startswith("module."):
        return {k[len("module."):]: v for k, v in sd.items()}
    return sd


def infer_clip_config(sd: StateDict) -> ClipConfig:
    """Architecture of a CLIP state dict (the reference ``build_model`` shape
    inference): ViT when ``visual.proj`` exists, ModifiedResNet otherwise."""
    sd = strip_module_prefix(sd)
    if "visual.proj" in sd:
        vision_width = sd["visual.conv1.weight"].shape[0]
        vision_layers = len([k for k in sd if k.startswith("visual.")
                             and k.endswith(".attn.in_proj_weight")])
        vision_patch_size = sd["visual.conv1.weight"].shape[-1]
        grid_size = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        image_resolution = vision_patch_size * grid_size
    else:
        vision_layers = tuple(
            len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}")})
            for b in (1, 2, 3, 4))
        vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
        output_width = round(
            (sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
        image_resolution = output_width * 32
        vision_patch_size = 0
    transformer_width = sd["ln_final.weight"].shape[0]
    return ClipConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=image_resolution,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch_size,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=transformer_width,
        transformer_heads=transformer_width // 64,
        transformer_layers=len({k.split(".")[2] for k in sd
                                if k.startswith("transformer.resblocks")}),
    )


_BLOCK_KEYS = (   # (torch name, port name, transposed)
    ("ln_1.weight", "ln1_g", False), ("ln_1.bias", "ln1_b", False),
    ("attn.in_proj_weight", "qkv_w", True), ("attn.in_proj_bias", "qkv_b", False),
    ("attn.out_proj.weight", "out_w", True), ("attn.out_proj.bias", "out_b", False),
    ("ln_2.weight", "ln2_g", False), ("ln_2.bias", "ln2_b", False),
    ("mlp.c_fc.weight", "fc_w", True), ("mlp.c_fc.bias", "fc_b", False),
    ("mlp.c_proj.weight", "proj_w", True), ("mlp.c_proj.bias", "proj_b", False),
)


def _stack_blocks(sd: StateDict, prefix: str, n_layers: int) -> dict:
    """Per-layer resblock tensors stacked on a leading layer axis, torch
    Linear weights (out, in) transposed to (in, out)."""
    def get(i, name, transpose):
        a = _np(sd[f"{prefix}.resblocks.{i}.{name}"])
        return a.T if transpose else a

    return {ours: np.stack([get(i, name, tr) for i in range(n_layers)])
            for name, ours, tr in _BLOCK_KEYS}


def clip_from_state_dict(sd: StateDict, cfg: Optional[ClipConfig] = None,
                         device: DeviceLike = None,
                         dtype: torch.dtype = torch.float32):
    """A reference-layout CLIP state dict (tensors or arrays) -> (port
    parameters, config), ViT or ModifiedResNet image tower."""
    sd = strip_module_prefix(sd)
    cfg = cfg or infer_clip_config(sd)
    if cfg.is_vit:
        P = cfg.vision_patch_size
        conv = _np(sd["visual.conv1.weight"])                  # (width, 3, P, P)
        visual = {
            "patch_w": conv.transpose(2, 3, 1, 0).reshape(P * P * 3, cfg.vision_width),
            "cls": _np(sd["visual.class_embedding"]),
            "pos": _np(sd["visual.positional_embedding"]),
            "ln_pre_g": _np(sd["visual.ln_pre.weight"]),
            "ln_pre_b": _np(sd["visual.ln_pre.bias"]),
            "blocks": _stack_blocks(sd, "visual.transformer", cfg.vision_layers),
            "ln_post_g": _np(sd["visual.ln_post.weight"]),
            "ln_post_b": _np(sd["visual.ln_post.bias"]),
            "proj": _np(sd["visual.proj"]),
        }
    else:
        visual = resnet_from_state_dict(sd, lambda key: _np(sd[key]))
    params = {
        "visual": visual,
        "text": {
            "tok_emb": _np(sd["token_embedding.weight"]),
            "pos": _np(sd["positional_embedding"]),
            "blocks": _stack_blocks(sd, "transformer", cfg.transformer_layers),
            "ln_final_g": _np(sd["ln_final.weight"]),
            "ln_final_b": _np(sd["ln_final.bias"]),
            "proj": _np(sd["text_projection"]),
        },
        "logit_scale": _np(sd["logit_scale"]),
    }
    return _rn_channels_last(params_from_numpy(params, device, dtype)), cfg


def _linear(sd: StateDict, pre: str) -> dict:
    return {"w": _np(sd[f"{pre}.weight"]).T, "b": _np(sd[f"{pre}.bias"])}


def im2text_from_state_dict(sd: StateDict) -> dict:
    """IM2TEXT keys ``layers.{i}.0.{weight,bias}``, ``fc_out.{weight,bias}``
    -> a numpy parameter tree."""
    sd = strip_module_prefix(sd)
    n = len({m.group(1) for k in sd if (m := re.match(r"layers\.(\d+)\.", k))})
    return {"layers": [_linear(sd, f"layers.{i}.0") for i in range(n)],
            "fc_out": _linear(sd, "fc_out")}


def crossformer_from_state_dict(sd: StateDict) -> list:
    """CrossFormer keys ``cross_layers.{i}.to_{q,k,v}`` and
    ``cross_layers.{i}.to_out.0`` -> a numpy parameter tree."""
    sd = strip_module_prefix(sd)
    n = len({m.group(1) for k in sd if (m := re.match(r"cross_layers\.(\d+)\.", k))})
    return [{"to_q": _linear(sd, f"cross_layers.{i}.to_q"),
             "to_k": _linear(sd, f"cross_layers.{i}.to_k"),
             "to_v": _linear(sd, f"cross_layers.{i}.to_v"),
             "to_out": _linear(sd, f"cross_layers.{i}.to_out.0")} for i in range(n)]


def heads_from_checkpoint(ckpt: dict, device: DeviceLike = None,
                          dtype: torch.dtype = torch.float32) -> FusionHeads:
    """The reference train checkpoint's heads (``state_dict_img2text``,
    ``state_dict_retrieval_fuse``, ``state_dict_text_condition``) as port
    :class:`FusionHeads`."""
    return heads_from_numpy(
        (im2text_from_state_dict(ckpt["state_dict_img2text"]),
         crossformer_from_state_dict(ckpt["state_dict_retrieval_fuse"]),
         crossformer_from_state_dict(ckpt["state_dict_text_condition"])),
        device, dtype)


# --------------------------------------------------------------------------
# Port parameters -> reference state dicts (for writing checkpoints)
# --------------------------------------------------------------------------

HEAD_MODULES = ("img2text", "retrieval_fuse", "text_condition")


def head_parameters(heads: FusionHeads):
    """``(module, torch name, tensor)`` of every head parameter in the
    reference's ``named_parameters`` order: the optimizer sees img2text,
    retrieval_fuse, text_condition; IM2TEXT registers ``fc_out`` before
    ``layers``; each CrossAttention ``to_q, to_k, to_v, to_out.0``.  The
    tensors are the port's, so weights are (in, out): the reference's are
    their transposes."""
    out = [("img2text", f"fc_out.{n}", heads.img2text["fc_out"][p])
           for n, p in (("weight", "w"), ("bias", "b"))]
    for i, layer in enumerate(heads.img2text["layers"]):
        out += [("img2text", f"layers.{i}.0.{n}", layer[p])
                for n, p in (("weight", "w"), ("bias", "b"))]
    for mod in HEAD_MODULES[1:]:
        for i, layer in enumerate(getattr(heads, mod)):
            for part, torch_part in (("to_q", "to_q"), ("to_k", "to_k"),
                                     ("to_v", "to_v"), ("to_out", "to_out.0")):
                out += [(mod, f"cross_layers.{i}.{torch_part}.{n}", layer[part][p])
                        for n, p in (("weight", "w"), ("bias", "b"))]
    return out


def weight_decay_mask(params):
    """True for matrix-shaped weights, False for biases and gains (the
    reference's bn/ln/bias/logit_scale exclusion)."""
    return _map(params, lambda a: a.ndim >= 2)


def head_parameter_groups(heads: FusionHeads):
    """The reference optimizer's two param groups as ``(module, torch name,
    tensor)`` lists: group 0 the biases and gains (no weight decay,
    :func:`weight_decay_mask` False), group 1 the weights, each in
    :func:`head_parameters` order.  An optimizer's state ids number group
    0's parameters, then group 1's."""
    params = head_parameters(heads)
    decay = [weight_decay_mask(t) for _, _, t in params]
    return ([p for p, d in zip(params, decay) if not d],
            [p for p, d in zip(params, decay) if d])


def heads_to_state_dicts(heads: FusionHeads) -> Dict[str, StateDict]:
    """Inverse of :func:`heads_from_checkpoint`: the three heads as
    reference-layout state dicts of CPU f32 tensors (weights (out, in)),
    keyed ``state_dict_img2text``, ``state_dict_retrieval_fuse`` and
    ``state_dict_text_condition``."""
    sds: Dict[str, StateDict] = {f"state_dict_{m}": {} for m in HEAD_MODULES}
    for mod, name, t in head_parameters(heads):
        t = t.detach().to("cpu", torch.float32)
        sds[f"state_dict_{mod}"][name] = (t.T if t.ndim == 2 else t).contiguous()
    return sds


def clip_to_state_dict(params: dict, cfg: ClipConfig) -> StateDict:
    """Inverse of :func:`clip_from_state_dict`: port CLIP parameters as a
    reference-layout state dict of CPU f32 tensors (an RN tower's
    BatchNorms with ``num_batches_tracked``), keyed as the JAX package's
    ``clip_pytree_to_state_dict`` keys it."""
    def cpu(a: torch.Tensor) -> torch.Tensor:
        return a.detach().to("cpu", torch.float32).contiguous()

    def blocks(tree: dict, prefix: str, sd: StateDict) -> None:
        for name, ours, transpose in _BLOCK_KEYS:
            for i, a in enumerate(tree[ours]):
                sd[f"{prefix}.resblocks.{i}.{name}"] = cpu(a.T if transpose else a)

    v, t = params["visual"], params["text"]
    if cfg.is_vit:
        P = cfg.vision_patch_size
        sd: StateDict = {
            "visual.conv1.weight": cpu(v["patch_w"].reshape(P, P, 3, cfg.vision_width)
                                       .permute(3, 2, 0, 1)),
            "visual.class_embedding": cpu(v["cls"]),
            "visual.positional_embedding": cpu(v["pos"]),
            "visual.ln_pre.weight": cpu(v["ln_pre_g"]),
            "visual.ln_pre.bias": cpu(v["ln_pre_b"]),
            "visual.ln_post.weight": cpu(v["ln_post_g"]),
            "visual.ln_post.bias": cpu(v["ln_post_b"]),
            "visual.proj": cpu(v["proj"]),
        }
        blocks(v["blocks"], "visual.transformer", sd)
    else:
        sd = resnet_to_state_dict(v, cpu)
    sd.update({
        "token_embedding.weight": cpu(t["tok_emb"]),
        "positional_embedding": cpu(t["pos"]),
        "ln_final.weight": cpu(t["ln_final_g"]), "ln_final.bias": cpu(t["ln_final_b"]),
        "text_projection": cpu(t["proj"]),
        "logit_scale": cpu(params["logit_scale"]),
    })
    blocks(t["blocks"], "transformer", sd)
    return sd
