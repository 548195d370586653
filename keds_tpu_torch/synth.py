"""Random-initialised model and synthetic knowledge DB at a real size.

:func:`build` gives CLIP parameters (the JAX package's ``init_clip``
initialisation scheme), the fusion heads of the serving path (IM2TEXT
D -> 512 -> 512 -> D, two 3-layer CrossFormers) and a unit-norm bf16
knowledge DB, all generated on the device from ``seed`` with explicit
``torch.Generator``s; :func:`feature_pairs` makes precomputed-feature
training pairs the same way.  No weights or data are read: a 0.5M-row DB
made on the card costs no host-to-device copy.  The random streams differ from
``jax.random``'s, so tests that compare with the JAX package build their
parameters with numpy instead.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from keds_tpu_torch.models.clip import ClipConfig, VIT_L_14
from keds_tpu_torch.models.composition import FusionHeads
from keds_tpu_torch.retrieval.database import KnowledgeDB
from keds_tpu_torch.runtime import DeviceLike, resolve_device


class _Init:
    def __init__(self, seed: int, device: torch.device, dtype: torch.dtype):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.device, self.dtype = device, dtype

    def normal(self, shape, std: float) -> torch.Tensor:
        x = torch.randn(shape, generator=self.gen, device=self.device)
        return (x * std).to(self.dtype)

    def uniform(self, shape, bound: float) -> torch.Tensor:
        x = torch.rand(shape, generator=self.gen, device=self.device)
        return ((2 * x - 1) * bound).to(self.dtype)

    def const(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=self.dtype, device=self.device)

    def blocks(self, n: int, width: int) -> dict:
        proj_std = width ** -0.5 * (2 * n) ** -0.5
        return {
            "ln1_g": self.const((n, width), 1.0), "ln1_b": self.const((n, width), 0.0),
            "qkv_w": self.normal((n, width, 3 * width), width ** -0.5),
            "qkv_b": self.const((n, 3 * width), 0.0),
            "out_w": self.normal((n, width, width), proj_std),
            "out_b": self.const((n, width), 0.0),
            "ln2_g": self.const((n, width), 1.0), "ln2_b": self.const((n, width), 0.0),
            "fc_w": self.normal((n, width, 4 * width), (2 * width) ** -0.5),
            "fc_b": self.const((n, 4 * width), 0.0),
            "proj_w": self.normal((n, 4 * width, width), proj_std),
            "proj_b": self.const((n, width), 0.0),
        }

    def linear(self, d_in: int, d_out: int) -> dict:
        bound = 1.0 / math.sqrt(d_in)   # torch.nn.Linear's default range
        return {"w": self.uniform((d_in, d_out), bound), "b": self.uniform((d_out,), bound)}

    def crossformer(self, d: int, n_layers: int, heads: int = 8, dim_head: int = 64) -> list:
        inner = heads * dim_head
        return [{"to_q": self.linear(d, inner), "to_k": self.linear(d, inner),
                 "to_v": self.linear(d, inner), "to_out": self.linear(inner, d)}
                for _ in range(n_layers)]


def init_clip(cfg: ClipConfig, seed: int, device: torch.device,
              dtype: torch.dtype) -> dict:
    ini = _Init(seed, device, dtype)
    vw, tw = cfg.vision_width, cfg.transformer_width
    patch_dim = cfg.vision_patch_size ** 2 * 3
    return {
        "visual": {
            "patch_w": ini.normal((patch_dim, vw), vw ** -0.5),
            "cls": ini.normal((vw,), vw ** -0.5),
            "pos": ini.normal((cfg.n_patches + 1, vw), vw ** -0.5),
            "ln_pre_g": ini.const((vw,), 1.0), "ln_pre_b": ini.const((vw,), 0.0),
            "blocks": ini.blocks(cfg.vision_layers, vw),
            "ln_post_g": ini.const((vw,), 1.0), "ln_post_b": ini.const((vw,), 0.0),
            "proj": ini.normal((vw, cfg.embed_dim), vw ** -0.5),
        },
        "text": {
            "tok_emb": ini.normal((cfg.vocab_size, tw), 0.02),
            "pos": ini.normal((cfg.context_length, tw), 0.01),
            "blocks": ini.blocks(cfg.transformer_layers, tw),
            "ln_final_g": ini.const((tw,), 1.0), "ln_final_b": ini.const((tw,), 0.0),
            "proj": ini.normal((tw, cfg.embed_dim), tw ** -0.5),
        },
        "logit_scale": torch.tensor(math.log(1 / 0.07), device=device),
    }


def init_heads(d: int, seed: int, device: torch.device, dtype: torch.dtype) -> FusionHeads:
    ini = _Init(seed, device, dtype)
    mid = 512 if d >= 512 else d
    return FusionHeads(
        img2text={"layers": [ini.linear(d, mid), ini.linear(mid, mid)],
                  "fc_out": ini.linear(mid, d)},
        retrieval_fuse=ini.crossformer(d, 3),
        text_condition=ini.crossformer(d, 3),
    )


def synthetic_db(rows: int, dim: int, seed: int, device: torch.device,
                 dtype: torch.dtype) -> KnowledgeDB:
    """Two (rows, dim) unit-norm Gaussian tables made on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def table() -> torch.Tensor:
        a = torch.randn((rows, dim), generator=gen, device=device)
        return (a / a.norm(dim=1, keepdim=True)).to(dtype)

    image = table()
    return KnowledgeDB(image, table(), [str(i) for i in range(rows)])


def feature_pairs(n: int, dim: int, seed: int,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(image, caption) unit-norm f32 feature pairs (n, dim) made on
    ``device``, each caption its image plus Gaussian noise of half its norm:
    stand-ins for precomputed CLIP features."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    image = torch.randn((n, dim), generator=gen, device=device)
    image = image / image.norm(dim=1, keepdim=True)
    text = image + 0.5 * dim ** -0.5 * torch.randn((n, dim), generator=gen, device=device)
    return image, text / text.norm(dim=1, keepdim=True)


def build(cfg: ClipConfig = VIT_L_14, db_rows: int = 500_000,
          dtype: torch.dtype = torch.bfloat16, seed: int = 0,
          device: DeviceLike = None) -> Tuple[dict, FusionHeads, KnowledgeDB]:
    """(clip params, fusion heads, knowledge DB) for ``cfg`` on ``device``."""
    dev = resolve_device(device)
    return (init_clip(cfg, seed, dev, dtype),
            init_heads(cfg.embed_dim, seed + 1, dev, dtype),
            synthetic_db(db_rows, cfg.embed_dim, seed + 2, dev, dtype))
