"""Train checkpoints in the reference ``.pt`` layout (counterpart of
``keds_tpu/io/checkpoint.py``), written with ``torch.save``:

    {epoch, name, state_dict (CLIP), state_dict_img2text,
     state_dict_retrieval_fuse, state_dict_text_condition, optimizer}

``optimizer`` is a torch ``AdamW.state_dict()`` in the reference's
parameter order and groups (group 0 the biases, group 1 the weights;
IM2TEXT's ``fc_out`` before ``layers``), with each weight's moments
transposed like the weight to (out, in).  The reference's
``optimizer.load_state_dict`` and the JAX package's ``restore_opt_state``
can both resume from it.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Optional, Tuple

import torch

from keds_tpu_torch.models.composition import FusionHeads
from keds_tpu_torch.models.convert import (clip_from_state_dict, clip_to_state_dict,
                                           head_parameter_groups, head_parameters,
                                           heads_from_checkpoint, heads_to_state_dicts)
from keds_tpu_torch.runtime import DeviceLike


def _transposed_moments(opt_sd: dict, heads: FusionHeads) -> dict:
    """``opt_sd`` with every 2-D moment transposed (port <-> reference
    layout; the map is its own inverse).  State ids follow the optimizer's
    param groups (``head_parameter_groups``)."""
    no_decay, decay = head_parameter_groups(heads)
    by_id = [t for _, _, t in no_decay + decay]
    state = {}
    for pid, entry in opt_sd["state"].items():
        entry = dict(entry)
        if by_id[int(pid)].ndim >= 2:
            for key in ("exp_avg", "exp_avg_sq"):
                entry[key] = entry[key].T.contiguous()
        state[int(pid)] = entry
    return {"state": state, "param_groups": opt_sd["param_groups"]}


def save_train_checkpoint(path: str, *, epoch: int, name: str, clip_params: dict,
                          clip_cfg, heads: FusionHeads,
                          optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    """Write one reference-layout checkpoint (tensors on the CPU, f32),
    atomically: a temporary file renamed into place."""
    opt_payload = {}
    if optimizer is not None:
        sd = optimizer.state_dict()
        sd["state"] = {pid: {k: v.detach().cpu() if torch.is_tensor(v) else v
                             for k, v in entry.items()}
                       for pid, entry in sd["state"].items()}
        opt_payload = _transposed_moments(sd, heads)
    payload = {"epoch": epoch, "name": name,
               "state_dict": clip_to_state_dict(clip_params, clip_cfg),
               **heads_to_state_dicts(heads), "optimizer": opt_payload}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    logging.info("saved checkpoint %s (epoch %d)", path, epoch)


def load_checkpoint(path: str) -> dict:
    # not weights_only: a checkpoint the JAX package wrote holds numpy
    # scalars (its optimizer steps)
    return torch.load(path, map_location="cpu", weights_only=False)


def load_heads_checkpoint(path: str, device: DeviceLike = None,
                          ckpt: Optional[dict] = None) -> Tuple[FusionHeads, int]:
    """The three heads (f32, on ``device``) and the epoch of a reference-
    layout checkpoint; ``ckpt`` reuses a dict already loaded from ``path``."""
    ckpt = ckpt if ckpt is not None else load_checkpoint(path)
    heads = heads_from_checkpoint(ckpt, device)
    epoch = int(ckpt.get("epoch", 0))
    logging.info("=> loaded checkpoint '%s' (epoch %d)", path, epoch)
    return heads, epoch


def load_full_checkpoint(path: str, device: DeviceLike = None):
    """(CLIP parameters, config, heads, epoch) of a train checkpoint, f32 on
    ``device``, from one read of the file."""
    ckpt = load_checkpoint(path)
    clip_params, cfg = clip_from_state_dict(ckpt["state_dict"], device=device)
    heads, epoch = load_heads_checkpoint(path, device, ckpt=ckpt)
    return clip_params, cfg, heads, epoch


def restore_optimizer(optimizer: torch.optim.Optimizer, ckpt: dict,
                      heads: FusionHeads) -> bool:
    """Load a checkpoint's torch AdamW state (reference layout) into
    ``optimizer``, built by ``make_optimizer`` over ``heads``.  Returns
    False, leaving the optimizer fresh, when the checkpoint has none or its
    parameter count differs."""
    payload = ckpt.get("optimizer") or {}
    if "state" not in payload or "param_groups" not in payload:
        logging.warning("checkpoint has no torch optimizer state; starting fresh")
        return False
    n = len(head_parameters(heads))
    if sum(len(g["params"]) for g in payload["param_groups"]) != n:
        logging.warning("checkpoint optimizer holds another parameter census; "
                        "starting fresh")
        return False
    sd = _transposed_moments(payload, heads)
    for entry in sd["state"].values():
        # a step written as a plain number (the JAX package's export) loads
        # as the 0-d tensor torch's AdamW expects
        entry["step"] = torch.as_tensor(entry["step"], dtype=torch.float32)
    optimizer.load_state_dict(sd)
    return True


def resolve_resume(resume: Optional[str], checkpoint_dir: str) -> Optional[str]:
    """``--resume auto``: the highest ``epoch_N.pt`` in ``checkpoint_dir``."""
    if resume != "auto":
        return resume
    if not os.path.isdir(checkpoint_dir):
        return None
    best, best_epoch = None, -1
    for fn in os.listdir(checkpoint_dir):
        m = re.match(r"epoch_(\d+)\.pt$", fn)
        if m and int(m.group(1)) > best_epoch:
            best_epoch, best = int(m.group(1)), os.path.join(checkpoint_dir, fn)
    return best
