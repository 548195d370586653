"""Weights and tables made on the device from a seed, in the layouts that
users' checkpoints come in: OpenAI CLIP's state dict (``clip/model.py``,
``build_model``) and the KEDs train checkpoint's three head state dicts
(``state_dict_img2text``, ``state_dict_retrieval_fuse``,
``state_dict_text_condition``).

Every Gaussian leaf of a model is a slice of one ``torch.randn`` call and
every uniform leaf a slice of one ``torch.rand`` call, made with a
``torch.Generator`` on the device; each leaf is then scaled to its
initialisation's spread (OpenAI CLIP's ``initialize_parameters``,
``torch.nn.Linear``'s default range for the heads) and cast to the dtype
it is served in.  The program and the plain reference read the same
tensors.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

StateDict = Dict[str, torch.Tensor]

# Sub-streams of one run's seed: each kind of input has its own generator.
STREAM_CLIP, STREAM_HEADS, STREAM_DB, STREAM_IMAGES, STREAM_GALLERY = range(5)


def stream_seed(seed: int, stream: int) -> int:
    """The seed of ``stream`` for a run's ``seed`` (any whole number below
    2**59)."""
    return (int(seed) << 4) + stream


def generator(seed: int, stream: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


class _Plan:
    """Leaves laid out over one flat buffer: (name, shape, fill), where fill
    is ('normal', std), ('uniform', bound) or ('const', value)."""

    def __init__(self):
        self.leaves: List[Tuple[str, tuple, tuple]] = []

    def add(self, name: str, shape: tuple, kind: str, value: float) -> None:
        self.leaves.append((name, tuple(shape), (kind, float(value))))

    def make(self, gen: torch.Generator, device: torch.device,
             dtype: torch.dtype) -> StateDict:
        sizes = {kind: sum(math.prod(s) for _, s, (k, _) in self.leaves if k == kind)
                 for kind in ("normal", "uniform")}
        bufs = {"normal": torch.randn(sizes["normal"], generator=gen, device=device),
                "uniform": torch.rand(sizes["uniform"], generator=gen, device=device)}
        offset = dict.fromkeys(bufs, 0)
        out: StateDict = {}
        for name, shape, (kind, v) in self.leaves:
            if kind == "const":
                out[name] = torch.full(shape, v, dtype=dtype, device=device)
                continue
            n = math.prod(shape)
            x = bufs[kind][offset[kind]:offset[kind] + n].view(shape)
            offset[kind] += n
            out[name] = (x * v if kind == "normal" else (2 * x - 1) * v).to(dtype)
        return out


def _resblocks(plan: _Plan, prefix: str, layers: int, width: int) -> None:
    attn_std = width ** -0.5
    proj_std = width ** -0.5 * (2 * layers) ** -0.5
    fc_std = (2 * width) ** -0.5
    for i in range(layers):
        p = f"{prefix}.resblocks.{i}."
        plan.add(p + "ln_1.weight", (width,), "const", 1.0)
        plan.add(p + "ln_1.bias", (width,), "const", 0.0)
        plan.add(p + "attn.in_proj_weight", (3 * width, width), "normal", attn_std)
        plan.add(p + "attn.in_proj_bias", (3 * width,), "const", 0.0)
        plan.add(p + "attn.out_proj.weight", (width, width), "normal", proj_std)
        plan.add(p + "attn.out_proj.bias", (width,), "const", 0.0)
        plan.add(p + "ln_2.weight", (width,), "const", 1.0)
        plan.add(p + "ln_2.bias", (width,), "const", 0.0)
        plan.add(p + "mlp.c_fc.weight", (4 * width, width), "normal", fc_std)
        plan.add(p + "mlp.c_fc.bias", (4 * width,), "const", 0.0)
        plan.add(p + "mlp.c_proj.weight", (width, 4 * width), "normal", proj_std)
        plan.add(p + "mlp.c_proj.bias", (width,), "const", 0.0)


def clip_state_dict(cfg: dict, seed: int, device: torch.device,
                    dtype: torch.dtype) -> StateDict:
    """A ViT CLIP state dict of ``cfg``'s widths, OpenAI's keys and shapes."""
    vw, tw, P = cfg["vision_width"], cfg["transformer_width"], cfg["vision_patch_size"]
    grid = cfg["image_resolution"] // P
    plan = _Plan()
    plan.add("visual.conv1.weight", (vw, 3, P, P), "normal", vw ** -0.5)
    plan.add("visual.class_embedding", (vw,), "normal", vw ** -0.5)
    plan.add("visual.positional_embedding", (grid * grid + 1, vw), "normal", vw ** -0.5)
    plan.add("visual.ln_pre.weight", (vw,), "const", 1.0)
    plan.add("visual.ln_pre.bias", (vw,), "const", 0.0)
    _resblocks(plan, "visual.transformer", cfg["vision_layers"], vw)
    plan.add("visual.ln_post.weight", (vw,), "const", 1.0)
    plan.add("visual.ln_post.bias", (vw,), "const", 0.0)
    plan.add("visual.proj", (vw, cfg["embed_dim"]), "normal", vw ** -0.5)
    plan.add("token_embedding.weight", (cfg["vocab_size"], tw), "normal", 0.02)
    plan.add("positional_embedding", (cfg["context_length"], tw), "normal", 0.01)
    _resblocks(plan, "transformer", cfg["transformer_layers"], tw)
    plan.add("ln_final.weight", (tw,), "const", 1.0)
    plan.add("ln_final.bias", (tw,), "const", 0.0)
    plan.add("text_projection", (tw, cfg["embed_dim"]), "normal", tw ** -0.5)
    sd = plan.make(generator(seed, STREAM_CLIP, device), device, dtype)
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07), dtype=dtype, device=device)
    return sd


def _linear(plan: _Plan, prefix: str, d_in: int, d_out: int) -> None:
    bound = d_in ** -0.5          # torch.nn.Linear's default range
    plan.add(prefix + ".weight", (d_out, d_in), "uniform", bound)
    plan.add(prefix + ".bias", (d_out,), "uniform", bound)


def heads_checkpoint(cfg: dict, seed: int, device: torch.device,
                     dtype: torch.dtype) -> Dict[str, StateDict]:
    """KEDs' heads (``src/model/model.py``): IM2TEXT embed_dim -> middle ->
    ... -> transformer_width and two CrossFormers of ``crossformer_layers``
    CrossAttention layers (``to_q``, ``to_k``, ``to_v``, ``to_out.0``)."""
    h = cfg["heads"]
    e, m, tw = cfg["embed_dim"], h["im2text_middle_dim"], cfg["transformer_width"]
    inner = h["crossformer_heads"] * h["crossformer_dim_head"]
    plan = _Plan()
    dims = [e] + [m] * h["im2text_layers"]
    _linear(plan, "img2text.fc_out", m, tw)
    for i in range(h["im2text_layers"]):
        _linear(plan, f"img2text.layers.{i}.0", dims[i], dims[i + 1])
    for mod in ("retrieval_fuse", "text_condition"):
        for i in range(h["crossformer_layers"]):
            p = f"{mod}.cross_layers.{i}"
            for part in ("to_q", "to_k", "to_v"):
                _linear(plan, f"{p}.{part}", tw, inner)
            _linear(plan, f"{p}.to_out.0", inner, tw)
    flat = plan.make(generator(seed, STREAM_HEADS, device), device, dtype)
    ckpt: Dict[str, StateDict] = {}
    for key, t in flat.items():
        mod, name = key.split(".", 1)
        ckpt.setdefault(f"state_dict_{mod}", {})[name] = t
    return ckpt


def unit_table(rows: int, dim: int, gen: torch.Generator, device: torch.device,
               dtype: torch.dtype, block: int = 1 << 17) -> torch.Tensor:
    """(rows, dim) Gaussian rows over their f32 norms, cast to ``dtype``,
    made in blocks so that no f32 copy of the whole table is held."""
    out = torch.empty((rows, dim), dtype=dtype, device=device)
    for r0 in range(0, rows, block):
        a = torch.randn((min(block, rows - r0), dim), generator=gen, device=device)
        out[r0:r0 + a.shape[0]] = (a / a.norm(dim=1, keepdim=True)).to(dtype)
    return out


def knowledge_tables(cfg: dict, seed: int, device: torch.device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The knowledge DB's image and caption tables: unit rows at the
    configuration's row count, width and dtype."""
    db = cfg["db"]
    gen = generator(seed, STREAM_DB, device)
    dtype = getattr(torch, db["dtype"])
    return (unit_table(db["rows"], db["dim"], gen, device, dtype),
            unit_table(db["rows"], db["dim"], gen, device, dtype))
