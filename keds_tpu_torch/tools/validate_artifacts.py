"""Turnkey real-artifact parity gate (counterpart of
``keds_tpu/tools/validate_artifacts.py``).

Given the reference's published artifacts — ``image_stream.pt`` /
``text_stream.pt`` checkpoints and the ``cc_{image,text}_databases.pt``
knowledge DB of the HuggingFace repo (reference ``README.md:17``,
https://huggingface.co/LionheartzzZ/KEDs) — as local files, plus a real
CIRR, Fashion-IQ, COCO or ImageNet data tree, run the full pipeline
(checkpoint load -> DB load -> eval dispatch) and emit the R@k table in one
command:

    python -m keds_tpu_torch.tools.validate_artifacts \
        --image-stream image_stream.pt --text-stream text_stream.pt \
        --db ./db_dir --data-root /path/to/comp_data \
        --eval-mode cirr --out report.json [--device cpu]

The port downloads nothing: an ``hf:<filename>`` spec exits with code 2
and a message that names the ``--hf-repo`` file to fetch by hand and pass
as a local path, as the JAX tool does where it has no egress.

The published streams are SINGLE checkpoints (not epoch sweeps), so both
branches are passed as fixed files — ``EvalContext.load_heads`` pins every
sweep epoch to them; CIRR runs one pass (mixture is the fixed 0.5/0.5,
eval_utils.py:709), ImageNet sweeps only the mixture weight 0.1j
(eval_utils.py:333-341), Fashion-IQ and COCO sweep the 0.05j mixture
(eval_utils.py:946-947,536-537; default j=10 — the 0.5/0.5 midpoint —
override with ``--sweep-epochs``).  ``cirr_test`` writes the four
submission JSONs for the CIRR test server (eval_utils.py:743-860) instead
of a recall table, so ``--expected`` does not apply there.

``--quant-towers int8`` and ``--retrieval {xla,approx,int8,pallas}`` drive
the quantized serving modes through the same gate.  The prompts need the
CLIP BPE vocab (``KEDS_TPU_BPE_VOCAB``).

``--expected expected.json`` compares the measured table against target
numbers (e.g. the paper's) — the reference repo publishes none in-repo, so
no defaults are shipped; format:
``{"cirr": {"mixture": {"recall_R@1": 26.4}}, "imgnet": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys


def _resolve_artifact(spec: str, hf_repo: str) -> str:
    """A local path; an ``hf:<filename>`` spec exits with code 2."""
    if not spec.startswith("hf:"):
        if not os.path.exists(spec):
            raise SystemExit(f"artifact not found: {spec}")
        return spec
    logging.error("%s: the port downloads nothing; fetch %s from "
                  "https://huggingface.co/%s by hand and pass the local path",
                  spec, spec[3:], hf_repo)
    sys.exit(2)


def _flatten(results: dict, fixed_epoch_label: bool) -> dict:
    """{(j, [prompt,] key): metrics} -> {"j=..|key": {metric: val}}."""
    out = {}
    for k, metrics in results.items():
        parts = [str(p) for p in k] if isinstance(k, tuple) else [str(k)]
        if fixed_epoch_label and parts and parts[0] == "0":
            parts = parts[1:]  # single-pass: the j=0 label is noise
        out["|".join(parts)] = metrics
    return out


def _print_table(title: str, table: dict, expected: dict,
                 tol: float = 0.5) -> bool:
    """Emit the R@k table (and deltas vs expected, if given).  Returns True
    when every expected number is met within ``tol`` recall points AND every
    expected entry was actually found in the measured table — an expected
    row/metric the evaluator never emitted (typo'd key, wrong eval mode)
    must fail the gate, not pass it by never being compared."""
    ok = True
    print(f"\n== {title} ==")
    matched = set()
    for row, metrics in table.items():
        cells = []
        for name, val in metrics.items():
            exp = expected.get(row, {}).get(name) if expected else None
            if exp is None:
                cells.append(f"{name}: {val:.2f}"
                             if isinstance(val, (int, float))
                             else f"{name}: {val}")
            else:
                matched.add((row, name))
                delta = val - float(exp)
                mark = "OK" if delta >= -tol else "MISS"
                ok = ok and delta >= -tol
                cells.append(f"{name}: {val:.2f} (paper {exp:.2f}, "
                             f"{delta:+.2f} {mark})")
        print(f"  {row:30s} " + "  ".join(cells))
    for row, metrics in (expected or {}).items():
        for name in metrics:
            if (row, name) not in matched:
                print(f"  EXPECTED ENTRY NOT MEASURED: {row} / {name} "
                      "(no such row/metric in the evaluator output)")
                ok = False
    return ok


def main(argv=None) -> None:
    from keds_tpu_torch.logging_utils import setup_logging

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--image-stream", required=True,
                   help="image-branch checkpoint (path or hf:<filename>)")
    p.add_argument("--text-stream", required=True,
                   help="text-branch checkpoint (path or hf:<filename>)")
    p.add_argument("--db", default=None,
                   help="knowledge-DB directory (cc_{image,text}_databases.pt"
                        " + optional database_names.txt)")
    p.add_argument("--db-image", default=None,
                   help="image DB file (path or hf:<filename>); overrides --db")
    p.add_argument("--db-text", default=None,
                   help="text DB file (path or hf:<filename>); overrides --db")
    p.add_argument("--data-root", required=True,
                   help="benchmark data root (CIRR tree / imgnet lists)")
    p.add_argument("--eval-mode", default="cirr",
                   choices=["cirr", "imgnet", "fashion", "coco", "cirr_test"])
    p.add_argument("--source-data", default="dress,shirt,toptee",
                   help="fashion mode: comma-separated cloth splits to run")
    p.add_argument("--sweep-epochs", default="",
                   help="fashion/coco mixture sweep j's (weight 0.05*j; heads "
                        "are the fixed artifacts at every j; default 10 = the "
                        "0.5/0.5 midpoint)")
    p.add_argument("--submission-dir", default="res_cirr",
                   help="cirr_test mode: where the four submission JSONs go")
    p.add_argument("--hf-repo", default="LionheartzzZ/KEDs")
    p.add_argument("--hf-cache", default="", help="inert: the port downloads nothing")
    p.add_argument("--expected", default=None,
                   help="json of target numbers to compare against")
    p.add_argument("--tolerance", type=float, default=0.5,
                   help="max allowed shortfall (recall points) vs --expected")
    p.add_argument("--out", default=None, help="write the table as json")
    p.add_argument("--imgnet-epochs", default="5,6,7,8,9",
                   help="imgnet mixture sweep j's (mixture weight 0.1*j; "
                        "heads are the fixed artifacts at every j)")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--db-topk", type=int, default=16)
    p.add_argument("--precision", default="bf16",
                   choices=["bf16", "fp32", "amp", "fp16"])
    p.add_argument("--workers", type=int, default=0)
    p.add_argument("--num-partitions", type=int, default=0)
    p.add_argument("--quant-towers", default="none", choices=["none", "int8"],
                   help="quantize the CLIP tower matmuls (the max-serving "
                        "accuracy question — run once per value and compare)")
    p.add_argument("--retrieval", default="xla",
                   choices=["xla", "approx", "int8", "pallas"],
                   help="DB top-k backend (int8 quantizes at load)")
    p.add_argument("--device", default=None,
                   help="torch device; default the current CUDA device")
    args = p.parse_args(argv)
    setup_logging()
    if args.precision in ("amp", "fp16"):
        # The gate is exactly where near-tie rankings depend on score dtype —
        # make the bf16 policy mapping impossible to miss.
        logging.warning("--precision %s maps to bf16; near-tie rankings are "
                        "evaluated at bf16 — pass fp32 for the exact-score table",
                        args.precision)

    img_ckpt = _resolve_artifact(args.image_stream, args.hf_repo)
    txt_ckpt = _resolve_artifact(args.text_stream, args.hf_repo)
    if args.db_image and args.db_text:
        db_img = _resolve_artifact(args.db_image, args.hf_repo)
        db_txt = _resolve_artifact(args.db_text, args.hf_repo)
        names = os.path.join(os.path.dirname(db_img), "database_names.txt")
    elif args.db:
        base = args.db
        db_img = os.path.join(base, "cc_image_databases.pt")
        db_txt = os.path.join(base, "cc_text_databases.pt")
        names = os.path.join(base, "database_names.txt")
    else:
        raise SystemExit("pass --db <dir> or --db-image/--db-text")

    import torch

    from keds_tpu_torch.data.loader import DataLoader
    from keds_tpu_torch.evalkit.evaluators import (
        EvalContext,
        evaluate_cirr,
        evaluate_imgnet_retrieval,
    )
    from keds_tpu_torch.models.loader import load_clip
    from keds_tpu_torch.parallel.mesh import make_mesh
    from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever
    from keds_tpu_torch.runtime import disable_tf32, resolve_device

    disable_tf32()
    device = resolve_device(args.device)
    dtype = torch.float32 if args.precision == "fp32" else torch.bfloat16
    mesh = make_mesh(args.num_partitions, device)

    # The image-stream checkpoint carries the full frozen CLIP state_dict
    # (reference save layout, src/main.py:330-341) — CLIP comes from there;
    # images go to the device as uint8 and are normalised there.
    clip_params, clip_cfg, _, t_val = load_clip(img_ckpt, normalize_on_host=False,
                                                device=device)
    db = KnowledgeDB.load(db_img, db_txt, names, dtype=dtype, device=device)
    ctx = EvalContext(
        clip_params=clip_params, cfg=clip_cfg,
        retriever=Retriever(db, backend=args.retrieval),
        image_branch=img_ckpt, text_branch=txt_ckpt, db_topk=args.db_topk,
        compute_dtype=dtype, mesh=mesh, quant_towers=args.quant_towers, device=device,
    )
    mk_loader = lambda ds: DataLoader(  # noqa: E731
        ds, args.batch_size, num_workers=args.workers)

    if args.eval_mode == "cirr":
        from keds_tpu_torch.data.datasets import CIRR

        src = CIRR(transforms=t_val, root=args.data_root)
        tgt = CIRR(transforms=t_val, root=args.data_root, mode="imgs")
        # Single pass: both branches are fixed files, mixture is 0.5/0.5.
        results = evaluate_cirr(ctx, mk_loader(src), mk_loader(tgt),
                                epochs=[0])
        table = _flatten(results, fixed_epoch_label=True)
    elif args.eval_mode == "cirr_test":
        from keds_tpu_torch.data.datasets import CIRR
        from keds_tpu_torch.evalkit.evaluators import evaluate_cirr_test

        src = CIRR(transforms=t_val, root=args.data_root, test=True)
        tgt = CIRR(transforms=t_val, root=args.data_root, mode="imgs",
                   test=True)
        results = evaluate_cirr_test(ctx, mk_loader(src), mk_loader(tgt))
        os.makedirs(args.submission_dir, exist_ok=True)
        table = {}
        for key, value in results.items():
            path = os.path.join(args.submission_dir, key + ".json")
            with open(path, "w") as f:
                json.dump(value, f)
            table[key] = {"submission": path,
                          "n_queries": len(value) - 2}  # minus version/metric
        logging.info("wrote %s/{composed,image,text,mixture}.json — submit "
                     "to the CIRR test server for the recall table",
                     args.submission_dir)
        if args.expected:
            raise SystemExit("--expected does not apply to cirr_test: the "
                             "recall table only exists server-side")
    elif args.eval_mode == "fashion":
        from keds_tpu_torch.data.datasets import FashionIQ
        from keds_tpu_torch.evalkit.evaluators import evaluate_fashion

        sweep = [int(x) for x in (args.sweep_epochs or "10").split(",")]
        table = {}
        for cloth in args.source_data.split(","):
            src = FashionIQ(cloth=cloth, transforms=t_val,
                            root=args.data_root, is_return_target_path=True)
            tgt = FashionIQ(cloth=cloth, transforms=t_val,
                            root=args.data_root, mode="imgs")
            results = evaluate_fashion(ctx, mk_loader(src), mk_loader(tgt),
                                       epochs=sweep)
            for row, metrics in _flatten(results, False).items():
                table[f"{cloth}|{row}"] = metrics
    elif args.eval_mode == "coco":
        from keds_tpu_torch.data.datasets import CsvCOCO
        from keds_tpu_torch.evalkit.evaluators import evaluate_coco
        from keds_tpu_torch.transforms import region_transform

        sweep = [int(x) for x in (args.sweep_epochs or "10").split(",")]
        src = CsvCOCO(transforms=t_val,
                      transforms_region=region_transform(
                          clip_cfg.image_resolution, normalize=False),
                      root=args.data_root)
        results = evaluate_coco(ctx, mk_loader(src), epochs=sweep)
        table = _flatten(results, fixed_epoch_label=False)
    else:
        from keds_tpu_torch.data.datasets import ImageList

        domains = ["cartoon", "origami", "toy", "sculpture"]
        prompts = [f"a {d} of *" for d in domains]
        src = ImageList(os.path.join(args.data_root, "imgnet",
                                     "imgnet_real_query.txt"),
                        root=args.data_root, transforms=t_val, is_labels=True)
        tgt = ImageList(os.path.join(args.data_root, "imgnet",
                                     "imgnet_targets.txt"),
                        root=args.data_root, transforms=t_val, is_labels=True)
        epochs = [int(x) for x in args.imgnet_epochs.split(",")]
        results = evaluate_imgnet_retrieval(ctx, prompts, mk_loader(src),
                                            mk_loader(tgt), epochs=epochs)
        table = _flatten(results, fixed_epoch_label=False)

    expected = None
    if args.expected:
        with open(args.expected) as f:
            expected = json.load(f).get(args.eval_mode, {})
    ok = _print_table(f"{args.eval_mode.upper()} — measured vs expected",
                      table, expected, tol=args.tolerance)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"eval_mode": args.eval_mode, "table": table,
                       "artifacts": {"image_stream": img_ckpt,
                                     "text_stream": txt_ckpt,
                                     "db_image": db_img, "db_text": db_txt},
                       "precision": args.precision,
                       "quant_towers": args.quant_towers,
                       "retrieval": args.retrieval,
                       "parity_ok": None if expected is None else ok}, f,
                      indent=2)
        logging.info("wrote %s", args.out)
    if expected is not None and not ok:
        logging.error("parity gate FAILED (see MISS rows above)")
        sys.exit(1)
    logging.info("parity gate %s",
                 "PASSED" if expected is not None else
                 "measured (no --expected numbers supplied)")


if __name__ == "__main__":
    main()
