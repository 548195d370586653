"""Offline CLIP feature extraction (counterpart of
``keds_tpu/tools/extract_features.py``; the reference's ``save_feature``
pass, ``src/trainer.py:511-585`` + ``src/main.py:319-321``).

Encodes a folder of images and a caption map into packed features:

    image_features.npy  (N, D) float32/float16
    text_features.npy   (N, D)
    names.json          [basename, ...] in the folder's sorted order

These feed :class:`keds_tpu_torch.data.datasets.FeaturePairDataset` and
``build_database``.  CLIP runs in bf16 on the device; images are decoded
and resized on ``--workers`` host threads, sent as uint8 and normalised on
the device, and encoded in chunks of ``DEFAULT_ENCODE_CHUNK``.  Two batches
are in flight: batch i + 1 is dispatched before batch i's features are
copied back (pinned host buffers and an event per batch on the card), so
the copy and the file writes overlap the encode.  The captions need the
CLIP BPE vocab (``KEDS_TPU_BPE_VOCAB``).

    python -m keds_tpu_torch.tools.extract_features \\
        --images /data/cc3m_images --captions captions.json \\
        --clip-weights ViT-L-14.pt --out /data/cc3m_features --batch-size 256 \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import json
import logging
import os
import time


def _read_captions(path: str) -> dict:
    """{basename: caption} from a json map or a cc3m_have*.pkl-style list of
    ``{filename, text}``."""
    if path.endswith(".pkl"):
        import pickle

        with open(path, "rb") as f:
            return {e["filename"]: e["text"] for e in pickle.load(f)}
    with open(path) as f:
        return json.load(f)


def _to_host(features):
    """The f32 host copies of ``features`` (device tensors) and an event
    that marks them complete (None on the CPU, where they are at once)."""
    import torch

    feats = [f.float() for f in features]
    if feats[0].device.type != "cuda":
        return feats, None
    host = [torch.empty(f.shape, dtype=torch.float32, pin_memory=True) for f in feats]
    for h, f in zip(host, feats):
        h.copy_(f, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def main(argv=None) -> dict:
    """Run the tool; returns ``{"rows", "seconds", "images_per_s"}``."""
    import numpy as np
    import torch

    from keds_tpu_torch.config import UNPORTED
    from keds_tpu_torch.data.datasets import CustomFolder
    from keds_tpu_torch.data.loader import DataLoader
    from keds_tpu_torch.logging_utils import setup_logging
    from keds_tpu_torch.models import clip as mclip
    from keds_tpu_torch.models.convert import cast_floating
    from keds_tpu_torch.models.loader import load_clip
    from keds_tpu_torch.runtime import resolve_device
    from keds_tpu_torch.tokenizer import tokenize

    p = argparse.ArgumentParser()
    p.add_argument("--images", required=True, help="folder of images")
    p.add_argument("--captions", required=True,
                   help="json {basename: caption} (or cc3m_have*.pkl-style list)")
    p.add_argument("--clip-weights", required=True,
                   help="reference-layout CLIP .pt, or an OpenAI model name cached "
                        "under ~/.cache/clip")
    p.add_argument("--out", required=True)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--dtype", choices=["float32", "float16"], default="float32")
    p.add_argument("--no-device-preprocess", dest="device_preprocess",
                   action="store_false", default=True)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the current CUDA device")
    args = p.parse_args(argv)
    if not args.device_preprocess:
        item = next(it for field, _, it in UNPORTED if field == "device_preprocess")
        raise SystemExit(f"--no-device-preprocess: not ported, {item}")
    setup_logging()
    device = resolve_device(args.device)

    clip_params, cfg, _, t_val = load_clip(args.clip_weights, normalize_on_host=False,
                                           device=device)
    clip_c = cast_floating(clip_params, torch.bfloat16, device)
    del clip_params
    cap_map = _read_captions(args.captions)

    dataset = CustomFolder(args.images, transform=t_val)
    loader = DataLoader(dataset, args.batch_size, num_workers=args.workers)
    os.makedirs(args.out, exist_ok=True)
    n = len(dataset)
    out_dtype = np.dtype(args.dtype)
    img_mm, txt_mm = (np.lib.format.open_memmap(os.path.join(args.out, name), mode="w+",
                                                dtype=out_dtype, shape=(n, cfg.embed_dim))
                      for name in ("image_features.npy", "text_features.npy"))
    names: list = []
    row = 0
    inflight: collections.deque = collections.deque()
    t0 = time.time()

    def drain_one() -> None:
        nonlocal row
        (img_h, txt_h), done, r0, b = inflight.popleft()
        if done is not None:
            done.synchronize()
        img_mm[r0:r0 + b] = img_h.numpy().astype(out_dtype)
        txt_mm[r0:r0 + b] = txt_h.numpy().astype(out_dtype)
        row = r0 + b
        if row % (args.batch_size * 20) == 0:
            logging.info("encoded %d/%d (%.0f imgs/s)", row, n, row / (time.time() - t0))

    next_row = 0
    with torch.inference_mode():
        for images, paths in loader:
            basenames = [os.path.basename(path).split(".")[0] for path in paths]
            caps = [str(cap_map.get(b, "")) for b in basenames]
            images = torch.from_numpy(np.asarray(images)).to(device)
            text = torch.from_numpy(tokenize(caps)).to(device)
            img_f = mclip.encode_image_chunked(clip_c, cfg, images, mclip.DEFAULT_ENCODE_CHUNK)
            txt_f = mclip.encode_text(clip_c, cfg, text)
            inflight.append((*_to_host((img_f, txt_f)), next_row, len(basenames)))
            names.extend(basenames)
            next_row += len(basenames)
            if len(inflight) >= 2:
                drain_one()
        while inflight:
            drain_one()
    seconds = time.time() - t0
    img_mm.flush()
    txt_mm.flush()
    with open(os.path.join(args.out, "names.json"), "w") as f:
        json.dump(names, f)
    rate = row / seconds if seconds > 0 else float("nan")
    logging.info("done: %d pairs -> %s (%.0f imgs/s overall)", row, args.out, rate)
    return {"rows": row, "seconds": seconds, "images_per_s": rate}


if __name__ == "__main__":
    main()
