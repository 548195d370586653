"""Training CLI (counterpart of ``keds_tpu/cli/main.py``), one process.

Trains IM2TEXT and the two CrossFormers against a frozen CLIP, with the
knowledge DB resident on the card, on precomputed feature pairs:

    python -m keds_tpu_torch.cli.main \\
        --train-data /path/to/features --dataset-type directory \\
        --clip-weights /path/to/ViT-L-14.pt --database-path /path/to/db \\
        --batch-size 128 --epochs 30 --warmup 10000 --lr 1e-4 --wd 0.1 \\
        --stream image

or, image stream only, on raw images whose features the frozen CLIP
computes in each step: ``--dataset-type csv`` (a csv/tsv of image paths
and captions, ``--csv-img-key``/``--csv-caption-key``/``--csv-separator``)
or ``--dataset-type webdataset`` (tar shards ``cc-{00000..00331}.tar`` of
``<key>.image_byte`` JPEGs, captions from ``--caption-map``, an epoch of
``--train-num-samples``).  ``auto`` takes csv for a .csv/.tsv file and
directory for a folder.  Raw images are decoded with PIL, train-cropped
and sent as uint8; the captions and the "a photo of" prompt are tokenized
with the CLIP BPE vocab (``KEDS_TPU_BPE_VOCAB``).

``--stream text`` trains the text stream on features.  It needs the vocab,
from which it takes the ``*`` id, and ``cc_other.json`` in the feature
folder: the own templates are tokenized per sample, the neighbour templates
of every DB row once into ``<train-data>/db_other_tokens.npy`` (rebuilt when
its fingerprint no longer matches the DB).  Checkpoints go to
``<logs>/<name>/checkpoints/epoch_N.pt`` in the reference layout;
``--resume auto`` continues from the newest one.

``--distributed`` trains data-parallel, one process per rank (RANK,
WORLD_SIZE and ``--dist-url``), ``--batch-size`` rows per rank: the step is
the global batch's (``train/trainer.py``), text widths are the global
batch's on every rank, ``--db-shard`` splits the DB over the ranks, and
rank 0 alone writes logs, scalars and checkpoints.  Two ranks on the CPU:

    RANK=0 WORLD_SIZE=2 python -m keds_tpu_torch.cli.main ... --device cpu \
        --distributed --dist-url tcp://127.0.0.1:29500 &
    RANK=1 WORLD_SIZE=2 python -m keds_tpu_torch.cli.main ... --device cpu \
        --distributed --dist-url tcp://127.0.0.1:29500
"""

from __future__ import annotations

import itertools
import json
import logging
import os
from typing import Optional

import numpy as np
import torch


def _copy_codebase(cfg, log_dir: str) -> None:
    """Copy the package source next to the run's logs (kept when resuming
    a run that has one)."""
    import shutil

    import keds_tpu_torch

    dst = os.path.join(log_dir, "code", "keds_tpu_torch")
    if os.path.exists(dst):
        if cfg.resume:
            logging.info("experiment code snapshot already at %s; keeping it", dst)
            return
        raise SystemExit(f"Error. Experiment code already exists at {dst}.")
    shutil.copytree(os.path.dirname(os.path.abspath(keds_tpu_torch.__file__)), dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    logging.info("copied codebase to %s", dst)


def _load_clip(cfg, device: torch.device):
    from keds_tpu_torch import synth
    from keds_tpu_torch.models.clip import model_config_for
    from keds_tpu_torch.models.convert import clip_from_state_dict
    from keds_tpu_torch.models.loader import state_dict_from_file

    if not cfg.clip_weights:
        clip_cfg = model_config_for(cfg.model)
        logging.info("initialized %s from scratch (no --clip-weights)", cfg.model)
        return synth.init_clip(clip_cfg, cfg.seed, device, torch.float32), clip_cfg
    return clip_from_state_dict(state_dict_from_file(cfg.clip_weights), device=device)


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


def _stream_tokens(cfg, raw: bool):
    """(prompt tokens (1, S), ``*`` id).  The image stream on features takes
    them from ``--prompt-tokens`` and ``--split-id`` (no vocab needed); the
    text stream and raw images take both from the BPE vocab (their
    captions need it too) and refuse a ``--split-id`` that disagrees."""
    if cfg.stream == "image" and not raw:
        return np.asarray([cfg.prompt_tokens]), 265 if cfg.split_id is None else cfg.split_id
    from keds_tpu_torch.tokenizer import star_token_id, tokenize

    try:
        star, prompt = star_token_id(), tokenize("a photo of")
    except FileNotFoundError as e:
        raise SystemExit(f"--stream {cfg.stream} on {'raw images' if raw else 'features'}: "
                         f"{e}") from e
    if cfg.split_id is not None and cfg.split_id != star:
        raise SystemExit(f"--split-id {cfg.split_id} disagrees with the vocab's '*' "
                         f"token {star}")
    return prompt, star


def resolve_dataset_type(cfg) -> str:
    """``--dataset-type``, with ``auto`` taking csv for a .csv/.tsv file and
    directory for a folder, and refusing anything else."""
    if cfg.dataset_type != "auto":
        return cfg.dataset_type
    if not cfg.train_data:
        raise SystemExit("--train-data is required for training")
    ext = cfg.train_data.rsplit(".", 1)[-1].lower()
    if ext in ("csv", "tsv"):
        return "csv"
    if os.path.isdir(cfg.train_data):
        return "directory"
    raise SystemExit(f"--dataset-type auto: cannot infer dataset type from extension "
                     f"{ext!r}; pass --dataset-type directory/webdataset/csv explicitly")


def main(argv: Optional[list] = None) -> None:
    from keds_tpu_torch.cli.common import run_logging
    from keds_tpu_torch.config import parse_args

    cfg = parse_args(argv)
    if cfg.load_feature and cfg.dataset_type == "webdataset":
        raise SystemExit("--load-feature trains on precomputed features (the default "
                         "path here); it is incompatible with --dataset-type webdataset")
    dataset_type = resolve_dataset_type(cfg)
    if dataset_type not in ("directory", "csv", "webdataset"):
        raise SystemExit(f"--dataset-type {dataset_type}: training reads directory "
                         "(features), csv or webdataset")
    raw = dataset_type != "directory"
    if cfg.neighbors and raw:
        raise SystemExit("--neighbors requires precomputed features (the raw-image modes "
                         "compute features on the fly, so neighbors cannot be "
                         "precomputed); use --dataset-type directory")
    if cfg.neighbors and cfg.retrieval_backend not in ("auto", "xla"):
        raise SystemExit(f"--neighbors replaces the in-step search entirely, which would "
                         f"silently override --retrieval-backend {cfg.retrieval_backend}; "
                         "drop one of the two flags (precomputed neighbors are exact)")
    if cfg.quant_towers != "none":
        logging.warning("--quant-towers %s: the towers train unquantized (int8 towers "
                        "serve inference only, as in the JAX package)", cfg.quant_towers)
    if cfg.stream == "text" and raw:
        raise SystemExit("--stream text requires precomputed features (subject/other "
                         "templates); use --dataset-type directory")
    if not cfg.database_path:
        raise SystemExit("--database-path is required")

    with run_logging(cfg) as log_dir:
        checkpoint_path = cfg.checkpoint_path or os.path.join(log_dir, "checkpoints")
        if cfg.copy_codebase and (not torch.distributed.is_initialized()
                                  or torch.distributed.get_rank() == 0):
            _copy_codebase(cfg, log_dir)
        _train(cfg, dataset_type, checkpoint_path, log_dir)


def _raw_loader(cfg, dataset_type: str, clip_cfg, mesh):
    """The csv or tar-stream loader of this rank's (uint8 train-cropped
    images, caption tokens) batches."""
    from keds_tpu_torch.tokenizer import tokenize
    from keds_tpu_torch.transforms import image_transform

    n_px = clip_cfg.image_resolution
    if dataset_type == "webdataset":
        from keds_tpu_torch.data.tarstream import (TarShardDataset, load_caption_map,
                                                   pil_jpeg_decoder)

        return TarShardDataset(
            cfg.train_data, batch_size=cfg.batch_size,
            decode_image=pil_jpeg_decoder(n_px, is_train=True, normalize=False),
            caption_map=load_caption_map(cfg.caption_map), tokenize=tokenize,
            seed=cfg.seed, train_num_samples=cfg.train_num_samples or 2_803_766,
            resampled=cfg.dataset_resampled,
            upsampling_factors=cfg.train_data_upsampling_factors, workers=cfg.workers,
            rank=mesh.rank, world_size=mesh.size, worker_processes=cfg.worker_processes)
    from keds_tpu_torch.data.datasets import CsvDataset
    from keds_tpu_torch.data.loader import DataLoader

    dataset = CsvDataset(cfg.train_data, image_transform(n_px, is_train=True, normalize=False),
                         img_key=cfg.csv_img_key, caption_key=cfg.csv_caption_key,
                         sep=cfg.csv_separator)
    return DataLoader(dataset, cfg.batch_size, shuffle=True, seed=cfg.seed, drop_last=True,
                      num_workers=cfg.workers, rank=mesh.rank, world_size=mesh.size,
                      worker_processes=cfg.worker_processes)


def _sample_needs(cfg, dataset_type: str, loader, mesh) -> Optional[np.ndarray]:
    """Over several ranks, each sample's text bucket need (own templates of
    the text stream, csv captions), from the dataset alone, so that every
    rank takes a step's width from the global batch's samples.  None: each
    batch takes its own bucket (one rank; the image stream on features), or
    webdataset over several ranks, whose captions stay at full width (the
    ranks stream their own samples, so none knows the others' lengths)."""
    if mesh.size == 1:
        return None
    if dataset_type == "csv":
        return loader.dataset.caption_token_needs(n_pseudo=1)
    if dataset_type == "webdataset":
        logging.info("webdataset over several ranks: captions run at full width "
                     "(rank-local streams)")
        return None
    return loader.dataset.own_token_needs(n_pseudo=1) if cfg.stream == "text" else None


def _train(cfg, dataset_type: str, checkpoint_path: str, log_dir: str) -> None:
    from keds_tpu_torch import synth
    from keds_tpu_torch.cli.common import (ScalarWriters, compute_dtype, load_database,
                                           setup_runtime)
    from keds_tpu_torch.data.datasets import CsvDataset, FeaturePairDataset
    from keds_tpu_torch.data.loader import DataLoader
    from keds_tpu_torch.io.checkpoint import (load_checkpoint, load_heads_checkpoint,
                                              resolve_resume, restore_optimizer,
                                              save_train_checkpoint)
    from keds_tpu_torch.tokenizer import bucket_for, bucket_text
    from keds_tpu_torch.train.losses import RawBatch, TrainBatch
    from keds_tpu_torch.train.trainer import make_optimizer, make_train_step, train_epoch

    text = cfg.stream == "text"
    raw = dataset_type != "directory"
    prompt, split_id = _stream_tokens(cfg, raw)
    device, mesh = setup_runtime(cfg)
    primary = mesh.rank == 0
    # a seed of each rank's own, as the reference's seed_everything(rank * 10 + seed)
    np.random.seed(mesh.rank * 10 + cfg.seed)
    dtype = compute_dtype(cfg)
    clip_params, clip_cfg = _load_clip(cfg, device)
    # IM2TEXT maps image features (embed_dim) into the text tower's token
    # space (transformer_width), where the CrossFormers run
    heads = synth.init_heads(clip_cfg.embed_dim, cfg.middle_dim, clip_cfg.transformer_width,
                             cfg.n_layer, seed=cfg.seed + 1, device=device,
                             dtype=torch.float32)
    retriever = load_database(cfg, mesh)
    db = retriever.db
    db_other_tokens = None
    if raw:
        loader = _raw_loader(cfg, dataset_type, clip_cfg, mesh)
    else:
        dataset = FeaturePairDataset(cfg.train_data, templates=text)
        if cfg.neighbors:
            _load_neighbors(cfg, dataset, db, device)
        db_other_tokens = _neighbour_templates(cfg, dataset, db) if text else None
        loader = DataLoader(dataset, cfg.batch_size, shuffle=True, seed=cfg.seed,
                            drop_last=True, num_workers=cfg.workers, rank=mesh.rank,
                            world_size=mesh.size, worker_processes=cfg.worker_processes)
    if cfg.val_data:
        # the reference's one use of --val-data: its sample count in the log
        n_val = len(CsvDataset(cfg.val_data, None, img_key=cfg.csv_img_key,
                               caption_key=cfg.csv_caption_key, sep=cfg.csv_separator))
        logging.info("val data (%s, type %s): %d samples", cfg.val_data,
                     cfg.dataset_type_val, n_val)
    steps_per_epoch = loader.num_batches
    if steps_per_epoch == 0:
        raise SystemExit(f"the training data make no batch of {cfg.batch_size}")

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

    step_fn = make_train_step(clip_params, clip_cfg, retriever, optimizer, schedule,
                              stream=cfg.stream, prompt_tokens=prompt, split_id=split_id,
                              seed=cfg.seed, dropout=cfg.droprate, db_topk=cfg.db_topk,
                              db_other_tokens=db_other_tokens, compute_dtype=dtype,
                              device=device, grad_scale=1.0 / mesh.size, mesh=mesh)
    writers = [ScalarWriters(cfg, log_dir)] if primary else []
    seen_buckets = set()

    def bucketed(tokens, width: Optional[int]) -> torch.Tensor:
        """A batch's own templates or captions cut to ``width``, or to their
        own causal-prefix bucket (the tower pools at each row's EOT); each
        width logged once."""
        tokens = np.asarray(tokens)
        tokens = tokens[:, :width] if width else bucket_text(tokens, n_pseudo=1)
        if tokens.shape[1] not in seen_buckets:
            seen_buckets.add(tokens.shape[1])
            logging.info("causal-prefix bucket S=%d (text program width)", tokens.shape[1])
        return torch.as_tensor(tokens, device=device)

    full_width_captions = dataset_type == "webdataset" and mesh.size > 1
    needs = _sample_needs(cfg, dataset_type, loader, mesh)

    def batches():
        widths = (itertools.repeat(None) if needs is None else
                  (bucket_for(int(needs[g].max())) for g in loader.global_batch_indices()))
        for row, width in zip(loader, widths):
            first = torch.as_tensor(row[0], device=device)
            if raw:
                caps = (torch.as_tensor(row[1], device=device) if full_width_captions
                        else bucketed(row[1], width))
                yield RawBatch(images=first, caption_tokens=caps)
                continue
            extra = {}
            if text:
                extra["other_tokens"] = bucketed(row[3], width)
            # precomputed-neighbour index rows follow the sample's fields
            idx = row[4:] if text else row[2:]
            extra.update(zip(("img_idx", "txt_idx", "cap2_idx"),
                             (torch.as_tensor(a, device=device) for a in idx)))
            yield TrainBatch(image_features=first,
                             caption_features=torch.as_tensor(row[1], device=device),
                             **extra)

    try:
        for epoch in range(start_epoch, cfg.epochs):
            logging.info("Start epoch %d", epoch)
            loader.set_epoch(epoch)
            train_epoch(step_fn, heads, batches(), epoch, steps_per_epoch,
                        schedule=schedule, writers=writers, world_size=mesh.size)
            if not primary:
                continue
            save = dict(epoch=epoch + 1, name=cfg.name, clip_params=clip_params,
                        clip_cfg=clip_cfg, heads=heads, optimizer=optimizer)
            os.makedirs(checkpoint_path, exist_ok=True)
            if (epoch + 1) == cfg.epochs or (
                    cfg.save_frequency > 0 and (epoch + 1) % cfg.save_frequency == 0):
                save_train_checkpoint(os.path.join(checkpoint_path, f"epoch_{epoch + 1}.pt"),
                                      **save)
            if cfg.save_most_recent:
                save_train_checkpoint(os.path.join(checkpoint_path, "epoch_latest.pt"), **save)
    finally:
        for w in writers:
            w.close()
        loader.close()


if __name__ == "__main__":
    main()
