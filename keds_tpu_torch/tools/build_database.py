"""Knowledge-database construction (counterpart of
``keds_tpu/tools/build_database.py``; reference ``database.py``).

Samples ``--size`` rows (default 500k) of a packed feature directory
(``image_features.npy``, ``text_features.npy``, ``names.json``) with
``np.random.default_rng(--seed)``, L2-normalizes them in f32 and writes

    cc_image_databases.pt   (N, D) float32, torch.save
    cc_text_databases.pt
    database_names.txt
    image_db.npy / text_db.npy   the same arrays for the fast path

and, with ``--int8``, the pre-quantized artifacts the int8 retrieval
backend reads (``{image,text}_db_int8.npy`` and ``*_db_scale.npy``:
per-row abs-max / 127 scales, values rounded half to even).  The sampling
and every array equal the JAX tool's for the same inputs and seed.

    python -m keds_tpu_torch.tools.build_database \\
        --features /data/cc3m_features --out /data/db --size 500000 --seed 0 [--int8]
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np


def quantize_rows_int8(arr: np.ndarray):
    """(int8 rows, f32 scales) of f32 ``arr``, as ``--int8`` writes them."""
    scale = np.abs(arr).max(axis=1) / 127.0
    q = np.round(arr / np.maximum(scale, 1e-12)[:, None]).astype(np.int8)
    return q, scale.astype(np.float32)


def main(argv=None) -> None:
    from keds_tpu_torch.logging_utils import setup_logging

    p = argparse.ArgumentParser(prog="keds_tpu_torch.tools.build_database")
    p.add_argument("--features", required=True,
                   help="packed feature dir (image_features.npy/...)")
    p.add_argument("--out", required=True)
    p.add_argument("--size", type=int, default=500_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-pt", action="store_true", help="skip the torch-format artifacts")
    p.add_argument("--int8", action="store_true",
                   help="also write pre-quantized int8 artifacts ({image,text}_db_int8.npy "
                        "+ *_scale.npy) for --retrieval-backend int8")
    args = p.parse_args(argv)
    setup_logging()

    img = np.load(os.path.join(args.features, "image_features.npy"), mmap_mode="r")
    txt = np.load(os.path.join(args.features, "text_features.npy"), mmap_mode="r")
    with open(os.path.join(args.features, "names.json")) as f:
        names = json.load(f)
    n = len(names)
    size = min(args.size, n)
    rng = np.random.default_rng(args.seed)
    pick = np.sort(rng.choice(n, size=size, replace=False))
    logging.info("sampling %d of %d rows", size, n)

    img_s = np.asarray(img[pick], np.float32)
    txt_s = np.asarray(txt[pick], np.float32)
    img_s /= np.linalg.norm(img_s, axis=1, keepdims=True)
    txt_s /= np.linalg.norm(txt_s, axis=1, keepdims=True)
    picked_names = [names[i] for i in pick]

    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "image_db.npy"), img_s)
    np.save(os.path.join(args.out, "text_db.npy"), txt_s)
    with open(os.path.join(args.out, "database_names.txt"), "w") as f:
        f.write("\n".join(picked_names) + "\n")
    if not args.no_pt:
        import torch

        torch.save(torch.from_numpy(img_s), os.path.join(args.out, "cc_image_databases.pt"))
        torch.save(torch.from_numpy(txt_s), os.path.join(args.out, "cc_text_databases.pt"))
    if args.int8:
        for name, arr in (("image", img_s), ("text", txt_s)):
            q, scale = quantize_rows_int8(arr)
            np.save(os.path.join(args.out, f"{name}_db_int8.npy"), q)
            np.save(os.path.join(args.out, f"{name}_db_scale.npy"), scale)
        logging.info("wrote int8 artifacts")
    logging.info("wrote knowledge DB (%d x %d) to %s", size, img_s.shape[1], args.out)


if __name__ == "__main__":
    main()
