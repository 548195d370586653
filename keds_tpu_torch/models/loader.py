"""CLIP weights from a local file (counterpart of ``keds_tpu/models/loader.py``).

:func:`load_clip` reads a reference-layout ``.pt``: a raw OpenAI state dict,
the OpenAI TorchScript archive, or a train checkpoint that holds
``state_dict``.  It takes a path, or one of the five OpenAI model names
(:data:`OPENAI_MODEL_URLS`), read from the file the OpenAI release caches
under ``download_root`` (default ``~/.cache/clip``).  Nothing is
downloaded: where the JAX package would fetch the file, this raises
``FileNotFoundError`` naming the path it looked for.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import torch

from keds_tpu_torch.models.clip import ClipConfig
from keds_tpu_torch.models.convert import clip_from_state_dict
from keds_tpu_torch.runtime import DeviceLike
from keds_tpu_torch.transforms import image_transform

# The official OpenAI CLIP artifacts; only their basenames are read here
# (the file names the release caches under ~/.cache/clip).
OPENAI_MODEL_URLS = {
    "RN50": "https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
    "RN101": "https://openaipublic.azureedge.net/clip/models/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
    "ViT-B/32": "https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "ViT-B/16": "https://openaipublic.azureedge.net/clip/models/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
    "ViT-L/14": "https://openaipublic.azureedge.net/clip/models/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
}


def state_dict_from_file(path: str) -> dict:
    """The CLIP state dict of a ``.pt`` file: ``torch.load`` hands a
    TorchScript archive (the OpenAI release) to ``torch.jit.load``; a train
    checkpoint carries the CLIP weights under ``state_dict``."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    return sd.get("state_dict", sd)


def resolve_clip_weights(name_or_path: str, download_root: Optional[str] = None) -> str:
    """The file to read: an existing file as it is, or a model name's
    cached release file ``<download_root or ~/.cache/clip>/<basename>``."""
    if os.path.isfile(name_or_path):
        return name_or_path
    url = OPENAI_MODEL_URLS.get(name_or_path)
    if url is None:
        raise FileNotFoundError(
            f"CLIP weights {name_or_path!r}: not a file and not a known model name")
    cached = os.path.join(download_root or os.path.expanduser("~/.cache/clip"),
                          os.path.basename(url))
    if os.path.isfile(cached):
        return cached
    raise FileNotFoundError(f"CLIP weights {name_or_path!r}: no cached file at {cached} "
                            "(the port downloads nothing; put the release file there or "
                            "pass a local path)")


def load_clip(name_or_path: str, target_pad: Optional[float] = None,
              normalize_on_host: bool = True, device: DeviceLike = None,
              download_root: Optional[str] = None
              ) -> Tuple[dict, ClipConfig, object, object]:
    """(f32 parameters on ``device``, config, train transform, val
    transform) of a path or model name (:func:`resolve_clip_weights`).
    ``normalize_on_host=False`` gives uint8 transforms whose normalisation
    runs on the device."""
    path = resolve_clip_weights(name_or_path, download_root)
    params, cfg = clip_from_state_dict(state_dict_from_file(path), device=device)
    t_train = image_transform(cfg.image_resolution, is_train=True, target_pad=target_pad,
                              normalize=normalize_on_host)
    t_val = image_transform(cfg.image_resolution, is_train=False, target_pad=target_pad,
                            normalize=normalize_on_host)
    logging.info("loaded CLIP %s from %s", cfg, path)
    return params, cfg, t_train, t_val
