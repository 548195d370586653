"""Retrieval demo producing an HTML page (counterpart of
``keds_tpu/cli/demo.py``; reference ``src/demo.py`` and ``make_html``,
``src/eval_utils.py:192-287``).

    python -m keds_tpu_torch.cli.demo --query_file q.jpg --prompts "a cartoon of *" \\
        --retrieval-data imgnet --resume /path/to/ckpt.pt --root-data ./data

``--retrieval-data`` is a csv (``--csv-img-key`` paths), imgnet, cirr,
dress, shirt, toptee or coco under ``--root-data``.  Corpus features are
computed once and cached as ``./data/<name>-<fingerprint>.pkl`` in the
reference's ``{feats, path}`` pickle layout; the fingerprint is the JAX
package's (the CLIP source with its size and mtime, the precision), so a
checkpoint switch invalidates the cache and either package reads the
other's.  Each query image (``--query_file``, comma-separated) is composed
with every prompt and ranked against the cache on the host; the top-10
images go to ``<demo-out>/index.html``.

The checkpoint's ``state_dict_img2text`` picks the composition: a
CrossFormer means late fusion (the image feature attends over the prompt's
final-LN token sequence, :func:`models.clip.get_text_tokens`), an MLP the
pic2word map spliced in at ``*`` (PARITY.md #5).  The prompts need the
CLIP BPE vocab.  Runs on the CUDA device unless ``--device cpu``.
"""

from __future__ import annotations

import hashlib
import html as _html
import logging
import os
import pickle
import shutil
from typing import Optional

import numpy as np
import torch


def make_html(prompts, query_image, image_paths_per_prompt, out_dir) -> str:
    """Result table HTML (reference make_html, eval_utils.py:268-287); the
    query and result images are copied under ``<out_dir>/images``."""
    rows = []
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    q_local = os.path.join("images", os.path.basename(query_image))
    shutil.copy(query_image, os.path.join(out_dir, q_local))
    for prompt, image_list in zip(prompts, image_paths_per_prompt):
        cells = [
            f'<td><p style="font-size:20px">{_html.escape(prompt)}</p></td>',
            f'<td><p style="margin-right:50px"><img src="{q_local}" height="100"></p></td>',
        ]
        for path in image_list:
            local = os.path.join("images", os.path.basename(path))
            shutil.copy(path, os.path.join(out_dir, local))
            cells.append(f'<td><img src="{local}" height="200"></td>')
        rows.append("<table><tr>" + "".join(cells) + "</tr></table>")
    return "".join(rows)


def cache_path(cfg, clip_source: str) -> str:
    """``./data/<retrieval-data name>-<fingerprint>.pkl``, the JAX package's
    fingerprint of the weights and the numerics (``--quant-towers``,
    ``--precision``, and 1 for uint8 images normalised on the device)."""
    ident = f"{clip_source}:{cfg.quant_towers}:{cfg.precision}:1"
    if os.path.isfile(str(clip_source)):
        st = os.stat(clip_source)
        ident += f":{st.st_mtime_ns}:{st.st_size}"
    fp = hashlib.sha1(ident.encode()).hexdigest()[:10]
    name = os.path.basename(cfg.retrieval_data or "").split(".")[0]
    return os.path.join("./data", f"{name}-{fp}.pkl")


def _corpus_dataset(cfg, t_val):
    from keds_tpu_torch.data.datasets import (CIRR, CsvDataset, CustomFolder, FashionIQ,
                                              ImageList)

    root, rd = cfg.root_data, cfg.retrieval_data or ""
    if "csv" in rd:
        return CsvDataset(rd, t_val, img_key=cfg.csv_img_key, caption_key=cfg.csv_caption_key,
                          sep=cfg.csv_separator, return_filename=True)
    if rd == "imgnet":
        return ImageList(os.path.join(root, "imgnet", "imgnet_targets.txt"), root=root,
                         transforms=t_val, is_labels=True, return_filename=True)
    if rd == "cirr":
        return CIRR(transforms=t_val, root=root, mode="caps", vis_mode=True)
    if rd in ("dress", "shirt", "toptee"):
        return FashionIQ(cloth=rd, transforms=t_val, root=root, mode="caps", vis_mode=True)
    if rd == "coco":
        return CustomFolder(os.path.join(root, "coco/val2017"), transform=t_val)
    raise SystemExit(f"unsupported --retrieval-data {rd!r}")


def main(argv: Optional[list] = None) -> dict:
    """Write the demo page; returns the cache path, the composition and each
    query's top-10 file names per prompt."""
    from keds_tpu_torch.cli.common import run_logging
    from keds_tpu_torch.config import ORBAX_LEFT_OUT, parse_args

    cfg = parse_args(argv, prog="keds_tpu_torch.cli.demo")
    if cfg.resume and os.path.isdir(cfg.resume):
        raise SystemExit(f"--resume {cfg.resume}: a directory (an orbax checkpoint?); "
                         f"pass a reference-layout .pt: orbax is {ORBAX_LEFT_OUT}")
    with run_logging(cfg, require_fresh=False):
        return _demo(cfg)


def _demo(cfg) -> dict:
    from PIL import Image

    from keds_tpu_torch.cli.common import compute_dtype, pad_batch, setup_runtime
    from keds_tpu_torch.data.loader import DataLoader
    from keds_tpu_torch.io.checkpoint import load_checkpoint
    from keds_tpu_torch.models import clip as mclip, heads as mheads
    from keds_tpu_torch.models.convert import (cast_floating, crossformer_from_state_dict,
                                               im2text_from_state_dict, params_from_numpy)
    from keds_tpu_torch.models.loader import load_clip
    from keds_tpu_torch.ops.quant import maybe_quantize_clip
    from keds_tpu_torch.tokenizer import star_token_id, tokenize

    device = setup_runtime(cfg)[0]   # the demo runs on one device
    clip_source = cfg.resume or cfg.clip_weights or cfg.model
    clip_params, ccfg, _, t_val = load_clip(clip_source, normalize_on_host=False,
                                            device=device)
    clip_c = maybe_quantize_clip(cast_floating(clip_params, compute_dtype(cfg), device),
                                 cfg.quant_towers)
    del clip_params

    # img2text from the checkpoint: CrossFormer -> late fusion, MLP -> splice
    img2text, late_fusion = None, False
    if cfg.resume:
        sd = load_checkpoint(cfg.resume).get("state_dict_img2text", {})
        if any(k.startswith(("cross_layers", "module.cross_layers")) for k in sd):
            img2text, late_fusion = crossformer_from_state_dict(sd), True
        elif sd:
            img2text = im2text_from_state_dict(sd)
        if img2text is not None:
            img2text = params_from_numpy(img2text, device)

    def encode(images) -> torch.Tensor:
        with torch.inference_mode():
            return mclip.encode_image_chunked(clip_c, ccfg, torch.as_tensor(images, device=device),
                                              mclip.DEFAULT_ENCODE_CHUNK)

    # ---- retrieval corpus: cached features ---------------------------------
    dataset = _corpus_dataset(cfg, t_val)
    cache = cache_path(cfg, clip_source)
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            data = pickle.load(f)
        corpus, filenames = np.asarray(data["feats"], np.float32), data["path"]
    else:
        feats, filenames = [], []
        loader = DataLoader(dataset, cfg.batch_size, num_workers=cfg.workers,
                            worker_processes=cfg.worker_processes)
        for images, names in loader:
            n = len(names)
            f = encode(pad_batch(images, cfg.batch_size))[:n]
            feats.append((f / f.norm(dim=-1, keepdim=True)).float().cpu().numpy())
            filenames.extend(names)
        loader.close()
        corpus = np.concatenate(feats)
        os.makedirs("./data", exist_ok=True)
        with open(cache, "wb") as f:
            pickle.dump({"feats": corpus, "path": filenames}, f)

    # ---- per query: compose with every prompt, rank on the host -------------
    prompts = (cfg.prompts or "a photo of *").split(",")
    text = torch.as_tensor(tokenize(prompts), device=device)
    os.makedirs(cfg.demo_out, exist_ok=True)
    html_txt, tops = "", []
    for query in (cfg.query_file or "").split(","):
        logging.info("retrieve image of %s", query)
        feat = encode(np.array(t_val(Image.open(query))[None]))   # a writable copy
        with torch.inference_mode():
            if late_fusion:
                # the image feature attends over all 77 positions of each
                # prompt (padding included: they are real keys and values in
                # the reference), so the prompts are not bucketed here
                tok_seq, _ = mclip.get_text_tokens(clip_c, ccfg, text)
                q = feat[:, None, :].expand(text.shape[0], 1, feat.shape[-1])
                fused = mheads.crossformer_apply(img2text, q, tok_seq, tok_seq)
                composed = fused[:, 0] @ clip_c["text"]["proj"].to(fused.dtype)
            else:
                mapped = (mheads.im2text_apply(img2text, feat) if img2text is not None
                          else feat)
                pseudo = mapped[:, None, :].expand(text.shape[0], 1, mapped.shape[-1])
                composed = mclip.encode_text_img_retrieval(clip_c, ccfg, text, pseudo,
                                                           split_id=star_token_id())
            composed = composed / composed.norm(dim=-1, keepdim=True)
        sims = composed.float().cpu().numpy() @ corpus.T
        order = np.argsort(-sims, axis=1)
        top10 = [[filenames[j] for j in order[i][:10]] for i in range(len(prompts))]
        for i, prompt in enumerate(prompts):
            logging.info("for prompt %r", prompt)
            for rank, name in enumerate(top10[i]):
                logging.info("top %d filename %s", rank, name)
        html_txt += make_html(prompts, query, top10, cfg.demo_out)
        tops.append(top10)

    index = os.path.join(cfg.demo_out, "index.html")
    with open(index, "w") as f:
        f.write(html_txt)
    logging.info("wrote %s", index)
    return dict(cache=cache, late_fusion=late_fusion, top10=tops, index=index)


if __name__ == "__main__":
    main()
