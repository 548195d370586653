"""Offline neighbour packs for features-mode training (counterpart of
``keds_tpu/tools/precompute_neighbors.py``).

The training features are frozen CLIP embeddings and the knowledge DB is
frozen, so each sample's top-k image and caption neighbours and its top-2
caption neighbours (the text stream's) are the same at every step.  This
tool searches them once, with the train step's own query arithmetic, and
``cli/main.py --neighbors <path|auto>`` then gathers instead of searching;
the trajectory is bit-identical.

    python -m keds_tpu_torch.tools.precompute_neighbors \\
        --train-data /data/cc3m_features --database-path /data/db \\
        [--out /data/cc3m_features/neighbors.npz] [--precision bf16] [--device cuda]

The ``.npz`` holds ``img_idx`` and ``txt_idx`` (N, k), ``cap2_idx`` (N, 2)
and ``meta_json``, a fingerprint of the DB, the feature set, the precision
and the device type the search ran on (``backend``: bf16 scores round
differently on another device, so the CLI refuses a pack from elsewhere).
It is written to a temporary file and renamed into place.  On the card
every search is the fused top-k kernel.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
from typing import Optional

import numpy as np
import torch

META_KEY = "meta_json"


def dataset_fingerprint(names) -> dict:
    return {"dataset_len": len(names),
            "dataset_names_sha1": hashlib.sha1("\n".join(names).encode()).hexdigest()}


def load_neighbors(path: str):
    """A pack -> (img_idx, txt_idx, cap2_idx or None, meta dict)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z[META_KEY]).decode())
        return (z["img_idx"], z["txt_idx"], z["cap2_idx"] if "cap2_idx" in z.files else None,
                meta)


def precompute(dataset, retriever, k: int, batch: int = 1024):
    """(img_idx, txt_idx, cap2_idx) of every sample of ``dataset``, searched
    on the DB's device ``batch`` queries at a time, with the train step's
    arithmetic: the image query normalised once
    (:meth:`Retriever.neighbour_indices`), the caption query twice (the
    trainer's normalisation, then :meth:`Retriever.caption_indices`')."""
    from keds_tpu_torch.retrieval.database import unit_rows

    dev = retriever.db.image_db.device
    n = len(dataset)
    img_idx = np.empty((n, k), np.int32)
    txt_idx = np.empty((n, k), np.int32)
    cap2_idx = np.empty((n, 2), np.int32)
    for lo in range(0, n, batch):
        hi = min(lo + batch, n)
        img, cap = (torch.from_numpy(np.array(a, np.float32)).to(dev)
                    for a in dataset.features(lo, hi))
        ii, ti = retriever.neighbour_indices(img, k)
        ci = retriever.caption_indices(unit_rows(cap), 2)
        img_idx[lo:hi], txt_idx[lo:hi], cap2_idx[lo:hi] = (a.cpu().numpy() for a in (ii, ti, ci))
        if (lo // batch) % 50 == 0:
            logging.info("neighbours: %d / %d samples", hi, n)
    return img_idx, txt_idx, cap2_idx


def main(argv: Optional[list] = None) -> None:
    from keds_tpu_torch.data.datasets import FeaturePairDataset
    from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever, db_fingerprint
    from keds_tpu_torch.runtime import resolve_device

    p = argparse.ArgumentParser(prog="keds_tpu_torch.tools.precompute_neighbors")
    p.add_argument("--train-data", required=True,
                   help="feature dir (packed image_features.npy/... or the reference "
                        "per-file layout)")
    p.add_argument("--database-path", required=True)
    p.add_argument("--out", default=None,
                   help="output .npz (default <train-data>/neighbors.npz)")
    p.add_argument("--db-topk", type=int, default=16)
    p.add_argument("--batch", type=int, default=1024, help="queries per search")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"],
                   help="DB and search dtype; must match the --precision you train "
                        "with (checked at train time through the fingerprint)")
    p.add_argument("--device", default=None,
                   help="torch device; default the current CUDA device")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    device = resolve_device(args.device)
    dtype = torch.float32 if args.precision == "fp32" else torch.bfloat16
    ds = FeaturePairDataset(args.train_data)
    db = KnowledgeDB.from_directory(args.database_path, dtype, device)
    img_idx, txt_idx, cap2_idx = precompute(ds, Retriever(db), args.db_topk, args.batch)
    meta = dict(db_fingerprint(db), k=args.db_topk, precision=args.precision,
                backend=device.type, **dataset_fingerprint(ds.names))
    out = args.out or os.path.join(args.train_data, "neighbors.npz")
    tmp = out + ".tmp.npz"
    np.savez(tmp, img_idx=img_idx, txt_idx=txt_idx, cap2_idx=cap2_idx,
             **{META_KEY: np.frombuffer(json.dumps(meta).encode(), np.uint8)})
    os.replace(tmp, out)
    logging.info("wrote %s: image/caption top-%d and caption top-2 of %d samples (%s)",
                 out, args.db_topk, len(ds), meta)


if __name__ == "__main__":
    main()
