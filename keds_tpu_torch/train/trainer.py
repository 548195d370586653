"""Training step and epoch loop (counterpart of ``keds_tpu/train/trainer.py``),
both streams on precomputed features, and the image stream on raw images.

One step runs on the device: the top-k search of the knowledge DB (the
fused kernel on the card), one permutation of the image neighbours, the
fusion heads in f32 with dropout, the frozen text tower in the compute
dtype (its attention is the fused kernel, with the backward kernel on the
gradient path of the pseudo-tokens), the stream's loss, backward and an
AdamW update of the heads in place.

    opt, schedule = make_optimizer(cfg, total_steps, heads)
    step = make_train_step(clip_params, clip_cfg, retriever, opt, schedule,
                           stream="image", prompt_tokens=prompt, split_id=265)
    loss = step(heads, batch, global_step)

The image stream searches both DB modalities at k=16.  The text stream
searches the image DB at k=16 and the caption DB at k=2 (its fusion reads
no caption neighbours, so that search is skipped) and gathers the
neighbours' templates from ``db_other_tokens``; it never updates
``text_condition``, which gets no gradient, so AdamW keeps no state for it.

Randomness: the generator of global step ``t`` (updates counted from 0 over
the whole run) on device ``dev`` is
``torch.Generator(dev).manual_seed((seed << 32) + t)``, the counterpart of
``jax.random.fold_in(key(seed), t)``.  It draws the image-neighbour
permutation first, then the dropout masks.

Data parallelism (``mesh``): every rank holds the same heads and steps on
its own rows of the global batch; the loss is the global batch's
(:mod:`.losses`), the head gradients are summed over the ranks after
backward and multiplied by ``grad_scale`` (1/world in the CLI), so that the
update is the JAX package's ``jax.grad(loss * grad_scale)`` of its
global-batch step, and every rank applies the same AdamW update.
"""

from __future__ import annotations

import logging
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from keds_tpu_torch.models import clip as mclip
from keds_tpu_torch.models.composition import FusionHeads
from keds_tpu_torch.models.convert import cast_floating, head_parameter_groups
from keds_tpu_torch.parallel.mesh import Mesh, all_reduce_sum
from keds_tpu_torch.profiling import span, stage_spans
from keds_tpu_torch.retrieval.database import Retriever, unit_rows
from keds_tpu_torch.runtime import DeviceLike, resolve_device
from keds_tpu_torch.tokenizer import bucket_text
from keds_tpu_torch.train.losses import (RawBatch, TrainBatch, encode_raw_batch,
                                         image_stream_loss, no_mark, text_stream_loss)
from keds_tpu_torch.train.schedule import cosine_lr

# The pseudo-tokens of the image stream: fused + text-condition + mapped.
K_PSEUDO = 3

# The train step's stage spans: the span that opens as each ``mark`` stage
# ends (``backward`` opens ``all_reduce`` under a mesh of several ranks).
STAGE_AFTER = {"encode": "retrieve", "retrieval": "fuse", "heads_forward": "text",
               "text_tower_forward": "backward", "backward": "optimizer",
               "all_reduce": "optimizer"}


def make_optimizer(cfg, total_steps: int,
                   heads: FusionHeads) -> Tuple[torch.optim.AdamW, Callable[[int], float]]:
    """torch AdamW over the heads' tensors (made trainable and updated in
    place) and the LR schedule.  ``cfg`` carries lr, beta1, beta2, eps, wd,
    warmup and skip_scheduler.

    The param groups are the reference's (:func:`head_parameter_groups`),
    so that ``state_dict()`` has the reference's layout.  This is optax's adamw:
    decoupled decay masked to ndim >= 2, eps outside the square root, bias
    correction on the update count t + 1.  The train step sets each group's
    LR to ``schedule(t)`` before update t, as optax reads its schedule at
    the update count."""
    no_decay, decay = head_parameter_groups(heads)
    for _, _, t in no_decay + decay:
        t.requires_grad_(True)
    groups = [{"params": [t for _, _, t in no_decay], "weight_decay": 0.0},
              {"params": [t for _, _, t in decay], "weight_decay": cfg.wd}]
    opt = torch.optim.AdamW(groups, lr=cfg.lr, betas=(cfg.beta1, cfg.beta2), eps=cfg.eps)
    if cfg.skip_scheduler:
        return opt, lambda step: cfg.lr
    return opt, cosine_lr(cfg.lr, cfg.warmup, total_steps)


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of global step ``step`` (see the module docstring)."""
    return torch.Generator(device=device).manual_seed((seed << 32) + step)


def truncated_prompt(prompt_tokens, eot_id: int) -> np.ndarray:
    """The fixed image-stream prompt cut to the next multiple of 8 that
    covers EOT + K + 1: the splice pools at EOT + K, and a causal tower's
    pooled output does not depend on later positions (S=8 for "a photo of").
    A prompt given without its padding (``--prompt-tokens``, SOT to EOT) is
    zero-padded to that width, as the tokenizer pads, so that the splice
    keeps EOT in the sequence."""
    prompt = np.asarray(prompt_tokens)
    eot_pos = int(np.argmax(prompt[0] == eot_id))
    s_t = -(-(eot_pos + K_PSEUDO + 1) // 8) * 8
    if s_t > prompt.shape[1]:
        prompt = np.pad(prompt, ((0, 0), (0, s_t - prompt.shape[1])))
    return prompt[:, :s_t]


def frozen_clip(clip_params: dict, compute_dtype: torch.dtype, device: torch.device) -> dict:
    """CLIP as the train step runs it: every tensor in ``compute_dtype`` but
    ``logit_scale``, which stays f32 (it scales the f32 logits)."""
    clip_c = cast_floating(clip_params, compute_dtype, device)
    clip_c["logit_scale"] = clip_params["logit_scale"].to(device, torch.float32)
    return clip_c


def neighbour_templates(db_other_tokens, n_rows: int, device: torch.device) -> torch.Tensor:
    """The text stream's (N, 77) neighbour-template table, checked against
    the DB's ``n_rows`` and trimmed once to the shortest bucket covering
    every row's EOT (the in-place splice pools there), on ``device``."""
    if db_other_tokens is None:
        raise ValueError("stream='text' requires db_other_tokens (the tokenized "
                         "'a photo of * * {other}' templates for every DB row)")
    table = np.asarray(db_other_tokens)
    if table.shape[0] != n_rows:
        raise ValueError(f"db_other_tokens has {table.shape[0]} rows but the knowledge "
                         f"DB has {n_rows}; the template cache is stale: rebuild it "
                         "(delete db_other_tokens.npy)")
    return torch.as_tensor(bucket_text(table, n_pseudo=1), device=device)


def make_train_step(clip_params: dict, cfg: mclip.ClipConfig, retriever: Retriever,
                    optimizer: torch.optim.Optimizer, schedule: Callable[[int], float],
                    *, stream: str, prompt_tokens, split_id: int, seed: int = 0,
                    dropout: float = 0.1, db_topk: int = 16, db_other_tokens=None,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    encode_chunk: Optional[int] = mclip.DEFAULT_ENCODE_CHUNK,
                    device: DeviceLike = None, grad_scale: float = 1.0,
                    mesh: Optional[Mesh] = None):
    """The train step of one stream: ``step(heads, batch, t) -> loss``.

    ``heads`` are the optimizer's tensors (f32) and are updated in place;
    ``t`` is the global update count, which picks the LR and the
    generator.  CLIP is cast to ``compute_dtype`` once and stays frozen
    (no tensor of it requires grad); ``logit_scale`` stays f32.  The
    returned loss is detached and stays on the device.  ``prompt_tokens``
    is the image stream's prompt; ``split_id`` (the ``*`` token) and
    ``db_other_tokens`` ((N, 77) "a photo of * * {other}" templates of every
    DB row, required) are the text stream's.  The image stream also takes a
    :class:`RawBatch`, whose image features the frozen image tower computes
    first (in ``encode_chunk``-image chunks).  ``step(..., mark=f)`` calls
    ``f(stage)`` as each stage ends (``encode`` for a raw batch,
    ``retrieval``, ``heads_forward``, ``text_tower_forward``, ``backward``,
    ``all_reduce`` under a mesh of several ranks, ``optimizer``), for a
    caller that times them.  While a profile runs the step is a
    ``train.step`` span and its stages the spans of :data:`STAGE_AFTER`
    (:mod:`keds_tpu_torch.profiling`).

    Under ``mesh`` the batch is this rank's rows (every rank the same
    count) and the step is the global batch's; ``grad_scale`` multiplies
    the summed gradients before the update (the returned loss is
    unscaled).  The gradients stay in ``.grad`` after the step."""
    if stream not in ("image", "text"):
        raise ValueError(f"unknown stream {stream!r}")
    text = stream == "text"
    dev = resolve_device(device)
    if text:
        db_other = neighbour_templates(db_other_tokens, len(retriever.db.names), dev)
    else:
        prompt = torch.as_tensor(truncated_prompt(prompt_tokens, cfg.eot_id), device=dev).long()
    clip_c = frozen_clip(clip_params, compute_dtype, dev)
    index_fields = ("img_idx", "txt_idx") + (("cap2_idx",) if text else ())
    after = dict(STAGE_AFTER)
    if mesh is not None and mesh.size > 1:
        after["backward"] = "all_reduce"

    def train_step(heads: FusionHeads, batch: TrainBatch, step: int,
                   mark: Callable[[str], None] = no_mark) -> torch.Tensor:
        with span("train.step", step=True):
            first = "encode" if isinstance(batch, RawBatch) else "retrieve"
            return staged_step(heads, batch, step, stage_spans(mark, first, after))

    def staged_step(heads: FusionHeads, batch: TrainBatch, step: int,
                    mark: Callable[[str], None]) -> torch.Tensor:
        if isinstance(batch, RawBatch):
            if text:
                raise ValueError("a RawBatch trains the image stream only: the text "
                                 "stream needs precomputed features and templates")
            batch = encode_raw_batch(clip_c, cfg, batch, encode_chunk, captions=False)
            mark("encode")
        elif not isinstance(batch, TrainBatch):
            raise TypeError(f"{type(batch).__name__}: the train step takes a TrainBatch "
                            "of features or a RawBatch of images")
        given = [n for n in index_fields if getattr(batch, n) is not None]
        if given and len(given) < len(index_fields):
            raise ValueError(
                f"precomputed-neighbour batch carries {given} but not "
                f"{[n for n in index_fields if n not in given]} (stream={stream!r}); a "
                "pack from tools/precompute_neighbors.py holds them all: feed the "
                "whole pack or none of it")
        precomputed = bool(given)
        gen = step_generator(seed, step, dev)
        for group in optimizer.param_groups:
            group["lr"] = schedule(step)
        topk_img, topk_txt = retriever.retrieve_features(
            batch.image_features, k=db_topk, generator=gen,
            idx=(batch.img_idx, batch.txt_idx) if precomputed else None, text=not text)
        if text:
            # normalised here and again in the caption search, as the
            # reference does: the second rounding can flip near-tie picks
            top2, top2_idx = retriever.retrieve_caption_neighbors(
                unit_rows(batch.caption_features), k=2, idx=batch.cap2_idx)
            mark("retrieval")
            loss = text_stream_loss(heads, clip_c, cfg, batch, topk_img, topk_txt, top2,
                                    db_other[top2_idx.long()], split_id, generator=gen,
                                    train=True, dropout=dropout, mark=mark, mesh=mesh)
        else:
            mark("retrieval")
            loss = image_stream_loss(heads, clip_c, cfg, batch, topk_img, topk_txt, prompt,
                                     generator=gen, train=True, dropout=dropout, mark=mark,
                                     mesh=mesh)
        mark("text_tower_forward")
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        mark("backward")
        grads = [p.grad for g in optimizer.param_groups for p in g["params"]
                 if p.grad is not None]
        if mesh is not None and mesh.size > 1:
            # one flat all-reduce: the ranks hold the same parameters, and
            # the same of them (all but text_condition in the text stream)
            # have a gradient
            flat = all_reduce_sum(mesh, torch.cat([g.flatten() for g in grads]))
            for g, f in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(f.view_as(g))
            mark("all_reduce")
        if grad_scale != 1.0:
            for g in grads:
                g.mul_(grad_scale)
        optimizer.step()
        mark("optimizer")
        return loss.detach()

    return train_step


def train_epoch(train_step, heads: FusionHeads, data_iter: Iterable, epoch: int,
                steps_per_epoch: int, *, log_every: int = 500,
                schedule: Optional[Callable[[int], float]] = None,
                writers: Sequence[Callable] = (),
                world_size: int = 1, profile_dir: Optional[str] = None,
                profile_window: Tuple[int, int] = (10, 20)) -> Optional[torch.Tensor]:
    """One epoch with the reference's logging cadence (data time, batch time,
    loss, LR every ``log_every`` steps).  The card is synchronised only at
    those log steps (reading the loss).  The samples seen count global
    rows: each rank's batch times ``world_size``.  ``profile_dir`` writes a
    torch.profiler trace (:mod:`keds_tpu_torch.profiling`) of steps
    ``profile_window[0]..profile_window[1]``, each step a
    ``train_step_e{epoch}`` range; an epoch shorter than the window starts
    it at step ``steps_per_epoch - 2`` and closes it at its end.  Returns
    the last step's loss (on the device), or None for an empty epoch."""
    from keds_tpu_torch.profiling import StepTimer, annotate, start_trace, stop_trace

    timer = StepTimer()
    loss = None
    prof = None
    for i, batch in enumerate(data_iter):
        if i >= steps_per_epoch:
            break
        step = epoch * steps_per_epoch + i
        timer.data_ready()
        if profile_dir and prof is None and i == min(profile_window[0],
                                                     max(steps_per_epoch - 2, 0)):
            prof = start_trace(profile_dir)
        with annotate(f"train_step_e{epoch}"):
            loss = train_step(heads, batch, step)
        if prof is not None and i >= profile_window[1]:
            float(loss)            # the step's work completes inside the trace
            stop_trace(prof, profile_dir)
            prof, profile_dir = None, None
        if i % log_every == 0:
            loss_val = float(loss)
            timer.step_done()
            lr = schedule(step) if schedule else float("nan")
            pct = 100.0 * i / max(steps_per_epoch, 1)
            logging.info(
                f"Train Epoch: {epoch} [{i * batch[0].shape[0] * world_size}"
                f" ({pct:.0f}%)]\tLoss: {loss_val:.6f}\tData (t) {timer.data_time:.3f}"
                f"\tBatch (t) {timer.batch_time:.3f}\tLR: {lr:5f}")
            scalars = {"train/loss": loss_val, "train/data_time": timer.data_time,
                       "train/batch_time": timer.batch_time, "train/lr": lr}
            for w in writers:
                w(scalars, step)
        else:
            timer.step_done()
    if prof is not None:
        float(loss)
        stop_trace(prof, profile_dir)
    return loss
