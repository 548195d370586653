"""COCO composed-region eval at its protocol size through the port's eval
CLI (counterpart of ``keds_tpu/tools/bench_coco_fullscale.py``; the same
synthetic-at-real-scale method as ``bench_cirr_fullscale``, documented
there).

The COCO protocol (reference ``src/eval_utils.py:451-575`` +
``src/data.py:433-509``) runs the 5000-image val2017 split: every row is
both a composed query (masked-region crop + class prompt) and a corpus
member, so the score matrix is square (5000 x 5000), and host ranking pays
six full stable argsorts of 25M floats a sweep epoch (3 feature types x 2
directions).  ``--eval-ranking device`` ranks on the card instead
(``torch.matmul`` and the diagonal ranks) and fetches six (5000,) vectors.
The sweep is j = 1..25 over 50 image-branch checkpoints
(eval_utils.py:478-484).

    python -m keds_tpu_torch.tools.bench_coco_fullscale                  # host
    python -m keds_tpu_torch.tools.bench_coco_fullscale --eval-ranking device

Prints ONE JSON line on stdout with the wall-clock accounting.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time

import numpy as np
import torch

from keds_tpu_torch.tools.bench_cirr_fullscale import (add_common_flags, clip_cfg,
                                                       eval_argv, timed_eval, up_to_date,
                                                       write_checkpoints, write_db)

# COCO class-ish vocabulary for the query_class / classes prompts (the
# prompt's length picks the compose bucket, as in the real protocol).
_CLASSES = ("person dog cat car bus train boat bird horse sheep cow bottle "
            "chair couch bed tv laptop phone book clock vase fork knife bowl "
            "banana apple pizza donut cake sink bench kite skis surfboard").split()


def _fingerprint(args) -> dict:
    return {
        "rows": args.rows, "db_rows": args.db_rows, "epochs": args.epochs,
        "image_px": args.image_px, "model_scale": args.model_scale,
        "version": 1,
    }


def build_artifacts(args, device: torch.device) -> None:
    """Stage the synthetic COCO tree, the DB files and the image-branch
    sweep (2 x ``--epochs`` heads-only files) under ``--workdir``, unless its
    fingerprint matches the arguments."""
    from PIL import Image

    wd = args.workdir
    want = _fingerprint(args)
    if up_to_date(wd, want, "bench_coco_fullscale"):
        return
    os.makedirs(wd, exist_ok=True)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()

    base = os.path.join(wd, "data", "coco")
    val = os.path.join(base, "val2017")
    masked = os.path.join(base, "val2017_masked")
    os.makedirs(val, exist_ok=True)
    os.makedirs(masked, exist_ok=True)
    px = args.image_px
    rows = []
    for i in range(args.rows):
        name = f"{i:012d}.jpg"
        # noise JPEGs: the decode family of the real split (val2017 is JPEG)
        Image.fromarray(rng.integers(0, 255, (px, px, 3), dtype=np.uint8)
                        ).save(os.path.join(val, name), quality=90)
        Image.fromarray(rng.integers(0, 255, (px, px, 3), dtype=np.uint8)
                        ).save(os.path.join(masked, name), quality=90)
        x1 = int(rng.integers(0, px // 2))
        y1 = int(rng.integers(0, px // 2))
        w = int(rng.integers(px // 8, px // 2))
        h = int(rng.integers(px // 8, px // 2))
        n_others = int(rng.integers(1, 4))
        rows.append({
            "id": name,
            "query_regions": f"{x1};{y1};{min(px, x1 + w)};{min(px, y1 + h)}",
            "query_class": str(rng.choice(_CLASSES)),
            "classes": ";".join(rng.choice(_CLASSES, n_others)),
        })
    with open(os.path.join(base, "coco_eval.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    print(f"  tree: {args.rows} rows x 2 imgs ({time.perf_counter()-t0:.1f} s)",
          file=sys.stderr)

    cfg = clip_cfg(args.model_scale)
    write_db(wd, args.db_rows, cfg.embed_dim)
    # evaluate_coco loads both sweep members from the image branch
    # (eval_utils.py:478-484); the text branch argument is unused there
    write_checkpoints(wd, cfg, 50, {"image_branch": 2 * args.epochs}, device)
    with open(os.path.join(wd, "fingerprint.json"), "w") as f:
        json.dump(want, f)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_common_flags(p, "coco_fullscale")
    p.add_argument("--rows", type=int, default=5000,
                   help="val2017 split size (reference: 5000)")
    p.add_argument("--epochs", type=int, default=25,
                   help="sweep length (reference: 25, over 50 checkpoints)")
    args = p.parse_args(argv)

    from keds_tpu_torch.runtime import resolve_device

    args.device = resolve_device(args.device)
    build_artifacts(args, args.device)
    if args.build_only:
        return {}

    total, phases, setup = timed_eval(eval_argv(args, "coco", "image_branch"), "coco",
                                      args.epochs)
    rec = {
        "metric": "coco_fullscale_eval_wall_s",
        "value": round(total, 2),
        "unit": "s",
        "vs_baseline": None,
        "scale": _fingerprint(args),
        "batch_size": args.batch_size,
        "precision": args.precision,
        "eval_ranking": args.eval_ranking,
        "setup_s": round(setup, 2),
        **phases,
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
