"""Image preprocessing (counterpart of ``keds_tpu/transforms.py``).

Host path, with PIL as the JAX package decodes and resizes (parity with the
reference torchvision pipeline, ``src/model/clip.py:107-123`` and
``src/utils.py:20-42``):

* val: Resize(shorter -> n_px, BICUBIC) -> CenterCrop(n_px) -> RGB ->
  [0, 1] -> CLIP mean/std, or uint8 without the last two steps
  (``normalize=False``: :func:`device_normalize` does them on the device);
* optional TargetPad(1.25) aspect-ratio padding (``--target-pad``);
* train: RandomResizedCrop(n_px, scale=(0.9, 1.0), BICUBIC), then as val;
* COCO region queries: resize to (n_px, n_px), no crop.

Device path: :func:`device_normalize` (uint8 in, the CLIP normalisation on
the device: the main path's), and :func:`device_preprocess`, the JAX
package's batched resize, centre crop and normalisation on the device.

The train crop draws from a ``random.Random`` (``rng``; the module's
global generator when None, as the JAX package's CLI runs it) in the JAX
package's order, so one seeded generator gives both packages the same crops.
PIL is imported inside the functions that need it, so importing this module
loads no PIL.  Arrays are NHWC.
"""

from __future__ import annotations

import math
import random
from typing import Callable, Optional

import numpy as np
import torch

from keds_tpu_torch.runtime import DeviceLike, resolve_device

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _bicubic():
    from PIL import Image

    return Image.BICUBIC


def _to_array(img) -> np.ndarray:
    arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
    return (arr - np.array(CLIP_MEAN, np.float32)) / np.array(CLIP_STD, np.float32)


def _to_u8(img) -> np.ndarray:
    """RGB uint8 HWC, the wire format that :func:`device_normalize` takes."""
    return np.asarray(img.convert("RGB"), np.uint8)


def _resize_shorter(img, n_px: int):
    w, h = img.size
    if w <= h:
        new = (n_px, max(1, round(h * n_px / w)))
    else:
        new = (max(1, round(w * n_px / h)), n_px)
    return img.resize(new, _bicubic())


def _center_crop(img, n_px: int):
    w, h = img.size
    left = (w - n_px) // 2
    top = (h - n_px) // 2
    return img.crop((left, top, left + n_px, top + n_px))


class TargetPad:
    """Pad images whose aspect ratio exceeds ``target_ratio`` out to that
    ratio (combiner's padding augmentation, reference src/utils.py:20-42)."""

    def __init__(self, target_ratio: float = 1.25):
        self.target_ratio = target_ratio

    def __call__(self, img):
        from PIL import Image

        w, h = img.size
        actual = max(w, h) / min(w, h)
        if actual < self.target_ratio:
            return img
        scaled = max(w, h) / self.target_ratio
        hp = max(int((scaled - w) / 2), 0)
        vp = max(int((scaled - h) / 2), 0)
        out = Image.new(img.mode, (w + 2 * hp, h + 2 * vp), 0)
        out.paste(img, (hp, vp))
        return out


def _random_resized_crop(img, n_px: int, scale=(0.9, 1.0),
                         ratio=(3.0 / 4.0, 4.0 / 3.0),
                         rng: Optional[random.Random] = None):
    """torchvision's RandomResizedCrop: up to 10 draws of an area share and
    a log aspect ratio, then a corner, for a crop inside the image, resized
    to (n_px, n_px); else the val centre crop."""
    rng = rng or random
    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = rng.randint(0, w - cw)
            top = rng.randint(0, h - ch)
            return img.crop((left, top, left + cw, top + ch)).resize((n_px, n_px),
                                                                     _bicubic())
    return _center_crop(_resize_shorter(img, n_px), n_px)


class _ImageTransform:
    """Picklable PIL-image transform."""

    def __init__(self, n_px: int, is_train: bool, target_pad: Optional[float],
                 rng: Optional[random.Random], normalize: bool):
        self.n_px = n_px
        self.is_train = is_train
        self.pad = TargetPad(target_pad) if target_pad else None
        self.rng = rng
        self.normalize = normalize

    def __call__(self, img):
        if self.pad is not None:
            img = self.pad(img)
        if self.is_train:
            img = _random_resized_crop(img, self.n_px, rng=self.rng)
        else:
            img = _center_crop(_resize_shorter(img, self.n_px), self.n_px)
        return _to_array(img) if self.normalize else _to_u8(img)


def image_transform(n_px: int, is_train: bool = False,
                    target_pad: Optional[float] = None,
                    rng: Optional[random.Random] = None,
                    normalize: bool = True) -> Callable:
    """PIL image -> normalised float32 HWC array, or (``normalize=False``)
    the resized and cropped uint8 HWC image.  ``is_train`` takes the random
    crop, drawn from ``rng``."""
    return _ImageTransform(n_px, is_train, target_pad, rng, normalize)


class _RegionTransform:
    def __init__(self, n_px: int, normalize: bool):
        self.n_px = n_px
        self.normalize = normalize

    def __call__(self, img):
        img = img.resize((self.n_px, self.n_px), _bicubic())
        return _to_array(img) if self.normalize else _to_u8(img)


def region_transform(n_px: int, normalize: bool = True) -> Callable:
    """COCO region-query transform: resize to (n_px, n_px) directly, no crop
    (reference src/eval_retrieval.py:311-314)."""
    return _RegionTransform(n_px, normalize)


def device_normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC batches are scaled to [0, 1] and CLIP-normalised in float32
    on the images' device; float inputs pass through unchanged.  The
    channel constants are filled in on the device, not copied from the
    host, so that a CUDA graph can capture the call."""
    if images.dtype != torch.uint8:
        return images

    def channels(values) -> torch.Tensor:
        return torch.stack([torch.full((), v, dtype=torch.float32, device=images.device)
                            for v in values])

    return (images.to(torch.float32) / 255.0 - channels(CLIP_MEAN)) / channels(CLIP_STD)


def device_preprocess(images_u8, n_px: int = 224, device: DeviceLike = None) -> torch.Tensor:
    """Batched preprocessing on the device: (B, H, W, 3) uint8 (array or
    tensor) -> (B, n_px, n_px, 3) float32, as the JAX package's
    ``device_preprocess``: [0, 1], a bicubic resize of the shorter side to
    ``n_px`` (the other side Python-``round``ed), a centre crop and the CLIP
    normalisation.  ``jax.image.resize``'s bicubic is Keys' cubic at a =
    -0.5, antialiased when it shrinks, its weights renormalised at the
    borders: ``interpolate``'s bicubic with ``antialias=True`` (its default,
    a = -0.75 without antialiasing, is not).  Runs on the current CUDA
    device unless ``device`` says otherwise; the main path sends uint8 and
    calls :func:`device_normalize` instead."""
    device = resolve_device(device)
    x = torch.as_tensor(images_u8).to(device).permute(0, 3, 1, 2).to(torch.float32) / 255.0
    h, w = x.shape[2:]
    scale = n_px / min(h, w)
    nh, nw = round(h * scale), round(w * scale)
    if (nh, nw) != (h, w):
        x = torch.nn.functional.interpolate(x, size=(nh, nw), mode="bicubic",
                                            align_corners=False, antialias=True)
    top, left = (nh - n_px) // 2, (nw - n_px) // 2
    x = x[:, :, top:top + n_px, left:left + n_px].permute(0, 2, 3, 1)
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=device)
    return (x - mean) / std
