"""Benchmark evaluation CLI (counterpart of ``keds_tpu/cli/eval_retrieval.py``;
reference ``src/eval_retrieval.py``).

    python -m keds_tpu_torch.cli.eval_retrieval --eval-mode cirr \\
        --clip-weights /path/to/ViT-L-14.pt --root-data /path/to/comp_data \\
        --database-path /path/to/db \\
        --image-branch ./image_branch/checkpoints \\
        --text-branch ./text_branch/checkpoints [--eval-ranking device]

``--eval-mode`` is cirr, cirr_test, fashion (with ``--source-data dress``,
``shirt`` or ``toptee``), coco or imgnet; cirr_test writes
``res_cirr/{composed,image,text,mixture}.json`` in the working directory.
CLIP comes from ``--resume`` (a train checkpoint) or ``--clip-weights``, a
local file.  The prompts need the CLIP BPE vocab (``KEDS_TPU_BPE_VOCAB``),
and images are decoded with PIL (``--workers`` threads, processes with
``--worker-processes``) and normalised on the device.  The run logs to
``<logs>/<name>/out.log``.  With ``--distributed`` every rank reads the same
data and evaluates its block of each batch (``--db-shard`` splits the DB);
rank 0 alone writes.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional


def main(argv: Optional[list] = None) -> None:
    from keds_tpu_torch.cli.common import run_logging
    from keds_tpu_torch.config import parse_args

    cfg = parse_args(argv, prog="keds_tpu_torch.cli.eval_retrieval")
    if cfg.eval_mode == "fashion" and cfg.source_data not in ("dress", "shirt", "toptee"):
        raise SystemExit(f"--eval-mode fashion needs --source-data dress, shirt or "
                         f"toptee, got {cfg.source_data!r}")
    with run_logging(cfg, require_fresh=False):
        _evaluate(cfg)


def _evaluate(cfg) -> None:
    from keds_tpu_torch.cli.common import compute_dtype, load_database, setup_runtime
    from keds_tpu_torch.data.datasets import CIRR, CsvCOCO, FashionIQ, ImageList
    from keds_tpu_torch.data.loader import DataLoader
    from keds_tpu_torch.evalkit.evaluators import (EvalContext, evaluate_cirr,
                                                   evaluate_cirr_test, evaluate_coco,
                                                   evaluate_fashion,
                                                   evaluate_imgnet_retrieval)
    from keds_tpu_torch.models.loader import load_clip
    from keds_tpu_torch.transforms import region_transform

    device, mesh = setup_runtime(cfg)
    clip_params, clip_cfg, _, t_val = load_clip(
        cfg.resume or cfg.clip_weights or cfg.model,
        target_pad=1.25 if cfg.target_pad else None, normalize_on_host=False,
        device=device)
    ctx = EvalContext(clip_params=clip_params, cfg=clip_cfg, retriever=load_database(cfg, mesh),
                      image_branch=cfg.image_branch, text_branch=cfg.text_branch,
                      db_topk=cfg.db_topk, compute_dtype=compute_dtype(cfg), mesh=mesh,
                      eval_ranking=cfg.eval_ranking, split_id=cfg.split_id, device=device)
    root = cfg.root_data

    def loader(ds):
        return DataLoader(ds, cfg.batch_size, num_workers=cfg.workers,
                          worker_processes=cfg.worker_processes)

    if cfg.eval_mode == "cirr":
        evaluate_cirr(ctx, loader(CIRR(transforms=t_val, root=root)),
                      loader(CIRR(transforms=t_val, root=root, mode="imgs")))
    elif cfg.eval_mode == "cirr_test":
        results = evaluate_cirr_test(
            ctx, loader(CIRR(transforms=t_val, root=root, test=True)),
            loader(CIRR(transforms=t_val, root=root, mode="imgs", test=True)))
        if mesh.rank > 0:
            return
        os.makedirs("res_cirr", exist_ok=True)
        for key, value in results.items():
            with open(os.path.join("res_cirr", key + ".json"), "w") as f:
                json.dump(value, f)
        logging.info("wrote res_cirr/{composed,image,text,mixture}.json")
    elif cfg.eval_mode == "fashion":
        src = FashionIQ(cloth=cfg.source_data, transforms=t_val, root=root,
                        is_return_target_path=True)
        tgt = FashionIQ(cloth=cfg.source_data, transforms=t_val, root=root, mode="imgs")
        evaluate_fashion(ctx, loader(src), loader(tgt))
    elif cfg.eval_mode == "coco":
        src = CsvCOCO(transforms=t_val, root=root,
                      transforms_region=region_transform(clip_cfg.image_resolution,
                                                         normalize=False))
        evaluate_coco(ctx, loader(src))
    else:   # imgnet
        prompts = [f"a {d} of *" for d in ("cartoon", "origami", "toy", "sculpture")]
        src = ImageList(os.path.join(root, "imgnet", "imgnet_real_query.txt"), root=root,
                        transforms=t_val, is_labels=True)
        tgt = ImageList(os.path.join(root, "imgnet", "imgnet_targets.txt"), root=root,
                        transforms=t_val, is_labels=True)
        evaluate_imgnet_retrieval(ctx, prompts, loader(src), loader(tgt))


if __name__ == "__main__":
    main()
