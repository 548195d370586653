"""Training CLI (counterpart of ``keds_tpu/cli/main.py``), features mode,
both streams.

Trains IM2TEXT and the two CrossFormers against a frozen CLIP on
precomputed feature pairs, with the knowledge DB resident on the card:

    python -m keds_tpu_torch.cli.main \\
        --train-data /path/to/features --dataset-type directory \\
        --clip-weights /path/to/ViT-L-14.pt --database-path /path/to/db \\
        --batch-size 128 --epochs 30 --warmup 10000 --lr 1e-4 --wd 0.1 \\
        --stream image

``--stream text`` trains the text stream.  It needs the CLIP BPE vocab
(``KEDS_TPU_BPE_VOCAB``), from which it takes the ``*`` id, and
``cc_other.json`` in the feature folder: the own templates are tokenized
per sample, the neighbour templates of every DB row once into
``<train-data>/db_other_tokens.npy`` (rebuilt when its fingerprint no
longer matches the DB).  Checkpoints go to
``<logs>/<name>/checkpoints/epoch_N.pt`` in the reference layout;
``--resume auto`` continues from the newest one.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch


def _experiment_name(cfg) -> str:
    if cfg.name:
        return cfg.name
    name = (f"lr={cfg.lr}_wd={cfg.wd}_model={cfg.model}"
            f"_batchsize={cfg.batch_size}_workers={cfg.workers}")
    if cfg.time_suffix:
        name += time.strftime("_date=%Y-%m-%d-%H-%M-%S", time.gmtime())
    return name.replace("/", "-")


def _load_clip(cfg, device: torch.device):
    from keds_tpu_torch import synth
    from keds_tpu_torch.models.clip import MODEL_CONFIGS
    from keds_tpu_torch.models.convert import clip_from_state_dict

    if not cfg.clip_weights:
        clip_cfg = MODEL_CONFIGS[cfg.model]
        logging.info("initialized %s from scratch (no --clip-weights)", cfg.model)
        return synth.init_clip(clip_cfg, cfg.seed, device, torch.float32), clip_cfg
    # torch.load hands a TorchScript archive (the OpenAI release) to
    # torch.jit.load; a plain checkpoint is a state dict
    obj = torch.load(cfg.clip_weights, map_location="cpu", weights_only=False)
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    sd = sd.get("state_dict", sd)
    return clip_from_state_dict(sd, device=device)


def _load_neighbors(cfg, dataset, db, device: torch.device) -> None:
    """Attach a precomputed-neighbour pack after checking its fingerprint
    against this DB, this feature set, the precision and the platform: the
    image stream takes ``img_idx`` and ``txt_idx``, the text stream also
    ``cap2_idx``."""
    from keds_tpu_torch.retrieval.database import db_fingerprint
    from keds_tpu_torch.tools.precompute_neighbors import dataset_fingerprint, load_neighbors

    path = (os.path.join(cfg.train_data, "neighbors.npz") if cfg.neighbors == "auto"
            else cfg.neighbors)
    if not os.path.isfile(path):
        raise SystemExit(f"--neighbors: no pack at {path}; build it with "
                         "python -m keds_tpu_torch.tools.precompute_neighbors")
    img_idx, txt_idx, cap2_idx, meta = load_neighbors(path)
    want = dict(db_fingerprint(db), k=meta.get("k"),
                precision="fp32" if cfg.precision == "fp32" else "bf16",
                backend=device.type, **dataset_fingerprint(dataset.names))
    if meta != want:
        raise SystemExit(f"--neighbors: {path} is stale for this DB/feature set "
                         f"(fingerprint {meta} vs {want}); rebuild it")
    if meta["k"] < cfg.db_topk:
        raise SystemExit(f"--neighbors: pack holds top-{meta['k']} rows but "
                         f"--db-topk is {cfg.db_topk}")
    pack = (img_idx[:, :cfg.db_topk], txt_idx[:, :cfg.db_topk])
    if cfg.stream == "text":
        if cap2_idx is None:
            raise SystemExit(f"--neighbors: {path} holds no cap2_idx, which the text "
                             "stream needs; rebuild it")
        pack += (cap2_idx,)
    dataset.attach_neighbors(pack)
    logging.info("precomputed neighbours: %s (k=%d); the step gathers instead of "
                 "searching", path, meta["k"])


def _neighbour_templates(cfg, dataset, db) -> np.ndarray:
    """The text stream's neighbour templates of every DB row, from the cache
    ``<train-data>/db_other_tokens.npy`` when its fingerprint (the DB's and
    the template prefix) matches, else tokenized and cached (temp file, then
    rename; the meta lands after its array)."""
    from keds_tpu_torch.data.datasets import build_other_tokens
    from keds_tpu_torch.retrieval.database import db_fingerprint

    prefix = "a photo of * * "
    cache = os.path.join(cfg.train_data, "db_other_tokens.npy")
    meta_path = cache + ".meta.json"
    want = dict(db_fingerprint(db), template_prefix=prefix)
    have = None
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            have = json.load(f)
    if os.path.isfile(cache) and have == want:
        table = np.load(cache)
    else:
        if os.path.isfile(cache):
            logging.warning("db_other_tokens.npy is stale for this knowledge DB "
                            "(fingerprint %s vs %s); rebuilding", have, want)
        logging.info("tokenizing neighbour templates for %d DB rows", len(db.names))
        table = build_other_tokens(db.names, dataset.other, template_prefix=prefix)
        tmp = f"{cache}.{os.getpid()}.tmp.npy"
        np.save(tmp, table)
        os.replace(tmp, cache)
        tmp_m = f"{meta_path}.{os.getpid()}.tmp"
        with open(tmp_m, "w") as f:
            json.dump(want, f)
        os.replace(tmp_m, meta_path)
    return table    # make_train_step refuses a row count other than the DB's


def _stream_tokens(cfg):
    """(prompt tokens (1, S), ``*`` id) of the stream: the image stream's
    come from ``--prompt-tokens`` and ``--split-id`` (no vocab needed); the
    text stream takes both from the BPE vocab and refuses a ``--split-id``
    that disagrees."""
    if cfg.stream == "image":
        return np.asarray([cfg.prompt_tokens]), 265 if cfg.split_id is None else cfg.split_id
    from keds_tpu_torch.tokenizer import star_token_id, tokenize

    try:
        star, prompt = star_token_id(), tokenize("a photo of")
    except FileNotFoundError as e:
        raise SystemExit(f"--stream text: {e}") from e
    if cfg.split_id is not None and cfg.split_id != star:
        raise SystemExit(f"--split-id {cfg.split_id} disagrees with the vocab's '*' "
                         f"token {star}")
    return prompt, star


def main(argv: Optional[list] = None) -> None:
    from keds_tpu_torch.config import parse_args

    cfg = parse_args(argv)
    dataset_type = cfg.dataset_type
    if dataset_type == "auto" and cfg.train_data and os.path.isdir(cfg.train_data):
        dataset_type = "directory"
    if dataset_type != "directory":
        raise SystemExit(f"--dataset-type {cfg.dataset_type}: only precomputed features "
                         "(--dataset-type directory) are ported; raw csv/webdataset "
                         "training is ROADMAP.md section A item 11")
    if not cfg.database_path:
        raise SystemExit("--database-path is required")

    cfg.name = _experiment_name(cfg)
    log_dir = os.path.join(cfg.logs, cfg.name)
    log_path = os.path.join(log_dir, "out.log")
    if cfg.resume is None and os.path.exists(log_path):
        raise SystemExit(f"Error. Experiment already exists at {log_dir}. "
                         "Use --name for a new one.")
    checkpoint_path = cfg.checkpoint_path or os.path.join(log_dir, "checkpoints")
    os.makedirs(checkpoint_path, exist_ok=True)
    handler = logging.FileHandler(log_path)
    logging.getLogger().addHandler(handler)
    logging.getLogger().setLevel(logging.INFO)
    try:
        with open(os.path.join(log_dir, "params.txt"), "w") as f:
            for k, v in sorted(vars(cfg).items()):
                f.write(f"{k}: {v}\n")
        _train(cfg, checkpoint_path, log_dir)
    finally:
        logging.getLogger().removeHandler(handler)
        handler.close()


def _train(cfg, checkpoint_path: str, log_dir: str) -> None:
    from keds_tpu_torch import synth
    from keds_tpu_torch.data.datasets import FeaturePairDataset
    from keds_tpu_torch.data.loader import DataLoader
    from keds_tpu_torch.io.checkpoint import (load_checkpoint, load_heads_checkpoint,
                                              resolve_resume, restore_optimizer,
                                              save_train_checkpoint)
    from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever
    from keds_tpu_torch.runtime import resolve_device
    from keds_tpu_torch.tokenizer import bucket_text
    from keds_tpu_torch.train.losses import TrainBatch
    from keds_tpu_torch.train.trainer import make_optimizer, make_train_step, train_epoch

    text = cfg.stream == "text"
    prompt, split_id = _stream_tokens(cfg)
    device = resolve_device(cfg.device)
    dtype = torch.float32 if cfg.precision == "fp32" else torch.bfloat16
    clip_params, clip_cfg = _load_clip(cfg, device)
    heads = synth.init_heads(clip_cfg.embed_dim, cfg.seed + 1, device, torch.float32)
    db = KnowledgeDB.from_directory(cfg.database_path, dtype, device)
    dataset = FeaturePairDataset(cfg.train_data, templates=text)
    if cfg.neighbors:
        _load_neighbors(cfg, dataset, db, device)
    db_other_tokens = _neighbour_templates(cfg, dataset, db) if text else None
    loader = DataLoader(dataset, cfg.batch_size, shuffle=True, seed=cfg.seed,
                        drop_last=True, num_workers=cfg.workers)
    steps_per_epoch = loader.num_batches
    if steps_per_epoch == 0:
        raise SystemExit(f"{len(dataset)} samples make no batch of {cfg.batch_size}")

    start_epoch = 0
    resume = resolve_resume(cfg.resume, checkpoint_path)
    ckpt = None
    if resume and os.path.exists(resume):
        ckpt = load_checkpoint(resume)
        heads, start_epoch = load_heads_checkpoint(resume, device, ckpt)
    optimizer, schedule = make_optimizer(cfg, steps_per_epoch * cfg.epochs, heads)
    if ckpt is not None:
        restore_optimizer(optimizer, ckpt, heads)
        logging.info("resumed from %s at epoch %d", resume, start_epoch)

    step_fn = make_train_step(clip_params, clip_cfg, Retriever(db), optimizer, schedule,
                              stream=cfg.stream, prompt_tokens=prompt, split_id=split_id,
                              seed=cfg.seed, dropout=cfg.droprate, db_topk=cfg.db_topk,
                              db_other_tokens=db_other_tokens, compute_dtype=dtype,
                              device=device)
    scalars = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def write_scalars(values: dict, step: int) -> None:
        scalars.write(json.dumps({"step": step, **values}) + "\n")
        scalars.flush()

    seen_buckets = set()

    def batches():
        for row in loader:
            extra = {}
            if text:
                # causal-prefix bucket of the own templates: the in-place
                # splice pools at each row's EOT
                own = bucket_text(row[3], n_pseudo=1)
                if own.shape[1] not in seen_buckets:
                    seen_buckets.add(own.shape[1])
                    logging.info("causal-prefix bucket S=%d (text program width)",
                                 own.shape[1])
                extra["other_tokens"] = torch.as_tensor(own, device=device)
            # precomputed-neighbour index rows follow the sample's fields
            idx = row[4:] if text else row[2:]
            extra.update(zip(("img_idx", "txt_idx", "cap2_idx"),
                             (torch.as_tensor(a, device=device) for a in idx)))
            yield TrainBatch(image_features=torch.as_tensor(row[0], device=device),
                             caption_features=torch.as_tensor(row[1], device=device),
                             **extra)

    try:
        for epoch in range(start_epoch, cfg.epochs):
            logging.info("Start epoch %d", epoch)
            loader.set_epoch(epoch)
            train_epoch(step_fn, heads, batches(), epoch, steps_per_epoch,
                        schedule=schedule, writers=(write_scalars,))
            save = dict(epoch=epoch + 1, name=cfg.name, clip_params=clip_params,
                        clip_cfg=clip_cfg, heads=heads, optimizer=optimizer)
            if (epoch + 1) == cfg.epochs or (
                    cfg.save_frequency > 0 and (epoch + 1) % cfg.save_frequency == 0):
                save_train_checkpoint(os.path.join(checkpoint_path, f"epoch_{epoch + 1}.pt"),
                                      **save)
            if cfg.save_most_recent:
                save_train_checkpoint(os.path.join(checkpoint_path, "epoch_latest.pt"), **save)
    finally:
        scalars.close()


if __name__ == "__main__":
    main()
