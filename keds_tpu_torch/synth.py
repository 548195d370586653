"""Random-initialised model and synthetic knowledge DB at a real size.

:func:`build` gives CLIP parameters (the JAX package's ``init_clip``
initialisation scheme for a ViT; for an RN config, random convolutions
whose BatchNorm statistics are those of a seeded calibration batch), the
fusion heads of the serving path (IM2TEXT embed_dim -> 512 -> 512 ->
transformer_width, two 3-layer CrossFormers at transformer_width) and a
unit-norm bf16 knowledge DB of width embed_dim, all generated on the
device from ``seed`` with explicit ``torch.Generator``s;
:func:`feature_pairs` makes precomputed-feature training pairs the same
way.  :data:`RN_CONFIGS` holds the published shapes of the five RN
towers, which load from checkpoints only (``model_config_for`` refuses
them).  No weights or data are read: a 0.5M-row DB
made on the card costs no host-to-device copy.  The random streams differ from
``jax.random``'s, so tests that compare with the JAX package build their
parameters with numpy instead.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from keds_tpu_torch.models import resnet
from keds_tpu_torch.models.clip import ClipConfig, VIT_L_14
from keds_tpu_torch.models.composition import FusionHeads
from keds_tpu_torch.models.convert import cast_floating
from keds_tpu_torch.retrieval.database import KnowledgeDB
from keds_tpu_torch.runtime import DeviceLike, resolve_device


def _rn(embed_dim, resolution, layers, width, text_width):
    return ClipConfig(embed_dim=embed_dim, image_resolution=resolution, vision_layers=layers,
                      vision_width=width, vision_patch_size=0, transformer_width=text_width,
                      transformer_heads=text_width // 64)


# The shapes of CLIP's RN checkpoints, as infer_clip_config reads them.
RN_CONFIGS = {
    "RN50": _rn(1024, 224, (3, 4, 6, 3), 64, 512),
    "RN101": _rn(512, 224, (3, 4, 23, 3), 64, 512),
    "RN50x4": _rn(640, 288, (4, 6, 10, 6), 80, 640),
    "RN50x16": _rn(768, 384, (6, 8, 18, 8), 96, 768),
    "RN50x64": _rn(1024, 448, (3, 15, 36, 10), 128, 1024),
}
CALIBRATION_IMAGES = 8
# The gain of each bottleneck's last BatchNorm.  Trained ResNets hold small
# gains there (the reference initialises them at zero); at gain 1 a random
# tower of 16 or more bottlenecks is chaotic, and the bf16 rounding of the
# first blocks grows layer by layer (kernel_sweeps.py rn_gain_controls).
RESIDUAL_GAIN = 0.25


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

    def crossformer(self, d: int, n_layers: int, heads: int = 8, dim_head: int = 64,
                    kv_dim: Optional[int] = None) -> list:
        inner, kv = heads * dim_head, kv_dim or d
        return [{"to_q": self.linear(d, inner), "to_k": self.linear(kv, inner),
                 "to_v": self.linear(kv, inner), "to_out": self.linear(inner, d)}
                for _ in range(n_layers)]

    def conv(self, c_in: int, c_out: int, k: int) -> torch.Tensor:
        return self.normal((c_out, c_in, k, k), (c_in * k * k) ** -0.5)

    def bn(self, c: int, gain: float = 1.0) -> dict:
        return {"g": self.const((c,), gain), "b": self.const((c,), 0.0),
                "mean": self.const((c,), 0.0), "var": self.const((c,), 1.0)}

    def text(self, cfg: ClipConfig) -> dict:
        tw = cfg.transformer_width
        return {
            "tok_emb": self.normal((cfg.vocab_size, tw), 0.02),
            "pos": self.normal((cfg.context_length, tw), 0.01),
            "blocks": self.blocks(cfg.transformer_layers, tw),
            "ln_final_g": self.const((tw,), 1.0), "ln_final_b": self.const((tw,), 0.0),
            "proj": self.normal((tw, cfg.embed_dim), tw ** -0.5),
        }


def _resnet_visual(ini: _Init, cfg: ClipConfig) -> dict:
    """A ModifiedResNet tower of ``cfg``'s shapes: OIHW convs at std
    fan_in^-0.5, BatchNorms at b = 0 and g = 1 but for each bottleneck's
    last, at :data:`RESIDUAL_GAIN` (their statistics are set by
    :func:`_calibrate`), the attention pool as the reference initialises it."""
    w = cfg.vision_width
    stem = {"conv1_w": ini.conv(3, w // 2, 3), "bn1": ini.bn(w // 2),
            "conv2_w": ini.conv(w // 2, w // 2, 3), "bn2": ini.bn(w // 2),
            "conv3_w": ini.conv(w // 2, w, 3), "bn3": ini.bn(w)}
    layers, inplanes = [], w
    for li, n_blocks in enumerate(cfg.vision_layers):
        planes, blocks = w * 2 ** li, []
        for bi in range(n_blocks):
            blk = {"conv1_w": ini.conv(inplanes, planes, 1), "bn1": ini.bn(planes),
                   "conv2_w": ini.conv(planes, planes, 3), "bn2": ini.bn(planes),
                   "conv3_w": ini.conv(planes, 4 * planes, 1),
                   "bn3": ini.bn(4 * planes, RESIDUAL_GAIN)}
            if (li > 0 and bi == 0) or inplanes != 4 * planes:
                blk["down_conv_w"], blk["down_bn"] = (ini.conv(inplanes, 4 * planes, 1),
                                                      ini.bn(4 * planes))
            blocks.append(blk)
            inplanes = 4 * planes
        layers.append(blocks)
    d, grid = 32 * w, cfg.image_resolution // 32
    std = d ** -0.5
    ap = {"pos": ini.normal((grid * grid + 1, d), std)}
    for name, d_out in (("q", d), ("k", d), ("v", d), ("c", cfg.embed_dim)):
        ap[f"{name}_w"], ap[f"{name}_b"] = ini.normal((d, d_out), std), ini.uniform((d_out,), std)
    return {"stem": stem, "layers": layers, "attnpool": ap}


def _calibrate(params: dict, cfg: ClipConfig, gen: torch.Generator) -> None:
    """Set every BatchNorm's running mean and variance, in tower order, to
    the statistics its input has for one seeded batch of N(0, 1) images
    (what a trained BN holds): random convolutions under identity
    statistics would blow activations up or make them vanish over 16 to 64
    bottlenecks."""
    def calibrating_bn(x: torch.Tensor, p: dict) -> torch.Tensor:
        xf = x.float()
        p["mean"] = xf.mean(dim=(0, 2, 3)).to(p["mean"].dtype)
        p["var"] = xf.var(dim=(0, 2, 3), unbiased=False).to(p["var"].dtype)
        return resnet._bn(x, p)

    res = cfg.image_resolution
    images = torch.randn((CALIBRATION_IMAGES, res, res, 3), generator=gen,
                         device=gen.device)
    with torch.no_grad():
        resnet.encode_image_resnet(params, images, cfg.vision_heads, bn=calibrating_bn)


def init_clip(cfg: ClipConfig, seed: int, device: torch.device, dtype: torch.dtype) -> dict:
    """CLIP parameters of ``cfg``; an RN tower is built and calibrated in
    f32, then cast to ``dtype``."""
    if not cfg.is_vit:
        ini = _Init(seed, device, torch.float32)
        params = {"visual": _resnet_visual(ini, cfg), "text": ini.text(cfg),
                  "logit_scale": torch.tensor(math.log(1 / 0.07), device=device)}
        _calibrate(params, cfg, ini.gen)
        params = cast_floating(params, dtype, device)
        return dict(params, visual=resnet.channels_last(params["visual"]))
    ini = _Init(seed, device, dtype)
    vw = cfg.vision_width
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
        "text": ini.text(cfg),
        "logit_scale": torch.tensor(math.log(1 / 0.07), device=device),
    }


def init_heads(embed_dim: int = 768, middle_dim: int = 512, out_dim: int = 768,
               n_layer: int = 2, *, seed: int, device: torch.device,
               dtype: torch.dtype) -> FusionHeads:
    """IM2TEXT embed_dim -> middle_dim (x n_layer) -> out_dim and two
    3-layer CrossFormers at out_dim (the text tower's width), with the JAX
    package's defaults and torch.nn.Linear's initialisation range."""
    ini = _Init(seed, device, dtype)
    dims = [embed_dim] + [middle_dim] * n_layer
    return FusionHeads(
        img2text={"layers": [ini.linear(dims[i], dims[i + 1]) for i in range(n_layer)],
                  "fc_out": ini.linear(middle_dim, out_dim)},
        retrieval_fuse=ini.crossformer(out_dim, 3),
        text_condition=ini.crossformer(out_dim, 3),
    )


def init_crossformer(q_dim: int, kv_dim: int, n_layers: int, *, seed: int,
                     device: torch.device, dtype: torch.dtype) -> list:
    """A CrossFormer of ``n_layers`` whose queries are ``q_dim`` wide and
    keys and values ``kv_dim`` (the model surface's fusions)."""
    return _Init(seed, device, dtype).crossformer(q_dim, n_layers, kv_dim=kv_dim)


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
    """(clip params, fusion heads, knowledge DB) for ``cfg`` on ``device``;
    IM2TEXT's hidden width is 512, or embed_dim where that is smaller."""
    dev = resolve_device(device)
    return (init_clip(cfg, seed, dev, dtype),
            init_heads(cfg.embed_dim, min(512, cfg.embed_dim), cfg.transformer_width,
                       seed=seed + 1, device=dev, dtype=dtype),
            synthetic_db(db_rows, cfg.embed_dim, seed + 2, dev, dtype))
