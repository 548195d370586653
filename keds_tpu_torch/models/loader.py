"""CLIP weights from a local file (counterpart of ``keds_tpu/models/loader.py``).

:func:`load_clip` reads a reference-layout ``.pt``: a raw OpenAI state dict,
the OpenAI TorchScript archive, or a train checkpoint that holds
``state_dict``.  Nothing is downloaded: a name or path that is not a local
file raises ``FileNotFoundError``.
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


def state_dict_from_file(path: str) -> dict:
    """The CLIP state dict of a ``.pt`` file: ``torch.load`` hands a
    TorchScript archive (the OpenAI release) to ``torch.jit.load``; a train
    checkpoint carries the CLIP weights under ``state_dict``."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    return sd.get("state_dict", sd)


def load_clip(name_or_path: str, target_pad: Optional[float] = None,
              normalize_on_host: bool = True, device: DeviceLike = None
              ) -> Tuple[dict, ClipConfig, object, object]:
    """(f32 parameters on ``device``, config, train transform, val
    transform).  ``normalize_on_host=False`` gives uint8 transforms whose
    normalisation runs on the device."""
    if not os.path.isfile(name_or_path):
        raise FileNotFoundError(f"CLIP weights {name_or_path!r}: not a local file (the "
                                "port downloads nothing)")
    params, cfg = clip_from_state_dict(state_dict_from_file(name_or_path), device=device)
    t_train = image_transform(cfg.image_resolution, is_train=True, target_pad=target_pad,
                              normalize=normalize_on_host)
    t_val = image_transform(cfg.image_resolution, is_train=False, target_pad=target_pad,
                            normalize=normalize_on_host)
    logging.info("loaded CLIP %s from %s", cfg, name_or_path)
    return params, cfg, t_train, t_val
