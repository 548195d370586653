"""CIRR val at its protocol size through the port's eval CLI (counterpart
of ``keds_tpu/tools/bench_cirr_fullscale.py``).

The CIRR val protocol (reference ``src/eval_utils.py:578-740`` +
``src/data.py:233-333``) is 4181 composed queries over a 2297-image target
corpus, retrieval from the 0.5M-row CC3M knowledge DB, and a 30-checkpoint
x 2-branch sweep.  This tool stages a synthetic tree of that size under
``--workdir`` and drives ``keds_tpu_torch.cli.eval_retrieval`` end to end on
it, reporting the total wall and the phase walls ``evaluate_cirr`` records.

Synthetic-vs-real deviations (none changes the measured path):

* Images are random-noise PNGs at ``--image-px`` (default 224); decode cost
  follows the pixel count, not the content.  The loader, transform and
  device path are the real ones.
* Branch checkpoints are heads-only files (epoch, name and the three head
  state dicts) read through ``load_heads_checkpoint``.  The resume
  checkpoint is a full reference-format file (CLIP embedded, about 1.7 GB
  at ViT-L/14): the eval CLI reads CLIP from it, and its ``torch.load`` is
  timed once as ``full_ckpt_probe_s``.
* Weights are random (``synth.init_clip`` / ``synth.init_heads``); wall
  clocks do not depend on weight values.

The tree, caption and split JSON and DB arrays are drawn from numpy with
the JAX tool's generators in its order, so both tools write equal files
for the same arguments.  The staging runs in this process (numpy for the
files, the tool's device for the weights, saved from the CPU) and is
skipped when ``fingerprint.json`` matches the arguments; it is timed on
stderr and not counted in ``value``.

    python -m keds_tpu_torch.tools.bench_cirr_fullscale              # card
    python -m keds_tpu_torch.tools.bench_cirr_fullscale --epochs 2 \\
        --eval-ranking device
    python -m keds_tpu_torch.tools.bench_cirr_fullscale --model-scale tiny \\
        --queries 6 --corpus 8 --db-rows 64 --epochs 2 --image-px 32 \\
        --precision fp32 --device cpu

The prompts need the CLIP BPE vocab (``KEDS_TPU_BPE_VOCAB``).  Prints ONE
JSON line on stdout with the wall-clock accounting.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

# 8-14 word relative captions (typical CIRR length: the S=32 compose
# bucket); about 3 % of queries get a 30-word caption, so the sweep also
# runs a longer bucket (a batch's bucket is its longest caption's).
_WORDS = ("remove change swap the a one two red blue green small large dog "
          "cat bird table chair plate glass window tree person car sign wall "
          "light left right background holding standing sitting near behind "
          "with without into onto under over against beside").split()


def _fingerprint(args) -> dict:
    return {
        "queries": args.queries, "corpus": args.corpus,
        "db_rows": args.db_rows, "epochs": args.epochs,
        "image_px": args.image_px, "model_scale": args.model_scale,
        "version": 2,
    }


def clip_cfg(model_scale: str):
    """ViT-L/14, or the JAX tool's two-layer test config for 'tiny'."""
    from keds_tpu_torch.models.clip import VIT_L_14, ClipConfig

    if model_scale == "vitl":
        return VIT_L_14
    return ClipConfig(
        embed_dim=64, image_resolution=32, vision_layers=2, vision_width=128,
        vision_patch_size=16, transformer_width=64, transformer_heads=1,
        transformer_layers=2,
    )


def up_to_date(wd: str, want: dict, tool: str) -> bool:
    fp_path = os.path.join(wd, "fingerprint.json")
    if os.path.exists(fp_path) and os.path.exists(os.path.join(wd, "resume.pt")):
        with open(fp_path) as f:
            if json.load(f) == want:
                print(f"{tool}: artifacts up to date in {wd}", file=sys.stderr)
                return True
    return False


def write_db(wd: str, rows: int, dim: int) -> None:
    """Unit-norm f32 (rows, dim) tables in the reference's layout
    (``cc_{image,text}_databases.pt``, ``database_names.txt``) under
    ``wd/db``, from seeds 1 and 2."""
    t1 = time.perf_counter()
    db_dir = os.path.join(wd, "db")
    os.makedirs(db_dir, exist_ok=True)
    for fname, seed in (("cc_image_databases.pt", 1), ("cc_text_databases.pt", 2)):
        r = np.random.default_rng(seed)
        a = r.standard_normal((rows, dim), dtype=np.float32)
        a /= np.linalg.norm(a, axis=1, keepdims=True)
        _save(torch.from_numpy(a), os.path.join(db_dir, fname))
        del a
    with open(os.path.join(db_dir, "database_names.txt"), "w") as f:
        f.write("\n".join(f"cc3m_{i}" for i in range(rows)))
    print(f"  db: 2 x {rows} x {dim} f32 ({time.perf_counter()-t1:.1f} s)", file=sys.stderr)


def write_checkpoints(wd: str, cfg, resume_epoch: int, branches: dict,
                      device: torch.device) -> None:
    """``resume.pt`` in the full reference format (CLIP from seed 0, heads
    from seed 10), then heads-only ``<branch>/epoch_N.pt`` for N in
    1..``branches[branch]``, alternating the heads of seeds 11 and 12 as
    ``head_sds[N % 2]``.  Weights are made on ``device`` in f32."""
    from keds_tpu_torch import synth
    from keds_tpu_torch.io.checkpoint import save_train_checkpoint
    from keds_tpu_torch.models.convert import heads_to_state_dicts

    t2 = time.perf_counter()
    d = cfg.embed_dim

    def mk_heads(seed):
        return synth.init_heads(d, 512 if d >= 512 else d, d, seed=seed, device=device,
                                dtype=torch.float32)

    save_train_checkpoint(os.path.join(wd, "resume.pt"), epoch=resume_epoch, name="fs",
                          clip_params=synth.init_clip(cfg, 0, device, torch.float32),
                          clip_cfg=cfg, heads=mk_heads(10))
    head_sds = [heads_to_state_dicts(mk_heads(seed)) for seed in (11, 12)]
    for branch, n in branches.items():
        bdir = os.path.join(wd, branch)
        os.makedirs(bdir, exist_ok=True)
        for ep in range(1, n + 1):
            _save({"epoch": ep, "name": "fs", "optimizer": {}, **head_sds[ep % 2]},
                  os.path.join(bdir, f"epoch_{ep}.pt"))
    print(f"  checkpoints: resume (full) + {sum(branches.values())} heads-only "
          f"({time.perf_counter()-t2:.1f} s)", file=sys.stderr)


def _save(obj, path: str) -> None:
    """``torch.save`` to a temporary file renamed into place."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def build_artifacts(args, device: torch.device) -> None:
    """Stage the synthetic CIRR tree, the DB files and the checkpoint sweep
    under ``--workdir``, unless its fingerprint matches the arguments."""
    from PIL import Image

    wd = args.workdir
    want = _fingerprint(args)
    if up_to_date(wd, want, "bench_cirr_fullscale"):
        return
    os.makedirs(wd, exist_ok=True)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()

    base = os.path.join(wd, "data", "CIRR")
    dev = os.path.join(base, "dev")
    os.makedirs(dev, exist_ok=True)
    os.makedirs(os.path.join(base, "captions"), exist_ok=True)
    os.makedirs(os.path.join(base, "image_splits"), exist_ok=True)
    names = [f"img{i:05d}" for i in range(args.corpus)]
    px = args.image_px
    for n in names:
        arr = rng.integers(0, 255, (px, px, 3), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(dev, f"{n}.png"))
    caps = []
    for _ in range(args.queries):
        r = int(rng.integers(0, args.corpus))
        t = int(rng.integers(0, args.corpus - 1))
        if t >= r:
            t += 1  # target != reference (the metric masks the reference)
        n_words = 30 if rng.random() < 0.03 else int(rng.integers(8, 15))
        cap = " ".join(rng.choice(_WORDS, n_words))
        caps.append({"reference": names[r], "target_hard": names[t], "caption": cap})
    with open(os.path.join(base, "captions", "cap.rc2.val.json"), "w") as f:
        json.dump(caps, f)
    with open(os.path.join(base, "image_splits", "split.rc2.val.json"), "w") as f:
        json.dump({n: f"dev/{n}.png" for n in names}, f)
    print(f"  tree: {args.corpus} imgs / {args.queries} queries "
          f"({time.perf_counter()-t0:.1f} s)", file=sys.stderr)

    cfg = clip_cfg(args.model_scale)
    write_db(wd, args.db_rows, cfg.embed_dim)
    write_checkpoints(wd, cfg, 30, {"image_branch": args.epochs, "text_branch": args.epochs},
                      device)
    with open(os.path.join(wd, "fingerprint.json"), "w") as f:
        json.dump(want, f)


def with_sweep(evaluate, n_epochs: int):
    """``evaluate`` with its sweep defaulting to epochs 1..``n_epochs``; an
    ``epochs`` its caller passes goes through unchanged."""
    def run(*args, epochs=None, **kw):
        return evaluate(*args, epochs=range(1, n_epochs + 1) if epochs is None else epochs,
                        **kw)
    return run


def add_common_flags(p: argparse.ArgumentParser, workdir: str) -> None:
    p.add_argument("--workdir", default=os.path.expanduser(f"~/.cache/keds_tpu/{workdir}"))
    p.add_argument("--db-rows", type=int, default=500_000)
    p.add_argument("--image-px", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--workers", type=int, default=2, help="loader decode threads")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--eval-ranking", default="host", choices=["host", "device"],
                   help="pass-through to the eval CLI: 'device' ranks the sweep on "
                        "the card")
    p.add_argument("--model-scale", default="vitl", choices=["vitl", "tiny"],
                   help="'tiny' is the two-layer test config; walls only mean "
                        "something at 'vitl'")
    p.add_argument("--build-only", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the current CUDA device")


def eval_argv(args, mode: str, text_branch: str) -> list:
    """The eval CLI's argv for the staged workdir."""
    wd = args.workdir
    return [
        "--eval-mode", mode,
        "--resume", os.path.join(wd, "resume.pt"),
        "--root-data", os.path.join(wd, "data"),
        "--database-path", os.path.join(wd, "db"),
        "--image-branch", os.path.join(wd, "image_branch"),
        "--text-branch", os.path.join(wd, text_branch),
        "--batch-size", str(args.batch_size),
        "--workers", str(args.workers),
        "--db-topk", "16",
        "--precision", args.precision,
        "--logs", os.path.join(wd, "logs"),
        "--name", f"{mode}_fullscale",
        "--eval-ranking", args.eval_ranking,
        "--device", str(args.device),
    ]


def timed_eval(argv_eval: list, mode: str, n_epochs: int) -> tuple:
    """Run the eval CLI with ``evaluate_<mode>`` sweeping 1..n_epochs;
    returns its wall, the evaluator's phase walls and the rest (setup)."""
    import keds_tpu_torch.evalkit.evaluators as ev
    from keds_tpu_torch.cli.eval_retrieval import main as eval_main

    name = f"evaluate_{mode}"
    orig = getattr(ev, name)
    setattr(ev, name, with_sweep(orig, n_epochs))
    try:
        t0 = time.perf_counter()
        eval_main(argv_eval)
        total = time.perf_counter() - t0
    finally:
        setattr(ev, name, orig)
    walls = dict(getattr(ev, f"last_{mode}_walls"))
    phases = {k: round(v, 2) for k, v in walls.items() if k != "epochs"}
    setup = total - walls.get("corpus_s", 0) - walls.get("queries_s", 0) \
        - walls.get("sweep_s", 0)
    return total, phases, setup


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_common_flags(p, "cirr_fullscale")
    p.add_argument("--queries", type=int, default=4181)
    p.add_argument("--corpus", type=int, default=2297)
    p.add_argument("--epochs", type=int, default=30,
                   help="sweep length per branch (reference: 30)")
    p.add_argument("--no-device-preprocess", dest="device_preprocess",
                   action="store_false",
                   help="refused: the port sends uint8 and normalises on the device")
    p.add_argument("--db-shard", action="store_true")
    args = p.parse_args(argv)
    if not args.device_preprocess:
        from keds_tpu_torch.config import UNPORTED

        item = next(it for field, _, it in UNPORTED if field == "device_preprocess")
        raise SystemExit(f"--no-device-preprocess: not ported, {item}")

    from keds_tpu_torch.io.checkpoint import load_checkpoint
    from keds_tpu_torch.runtime import resolve_device

    args.device = resolve_device(args.device)
    build_artifacts(args, args.device)
    if args.build_only:
        return {}

    t0 = time.perf_counter()
    ck = load_checkpoint(os.path.join(args.workdir, "resume.pt"))
    full_ckpt_probe_s = time.perf_counter() - t0
    del ck

    argv_eval = eval_argv(args, "cirr", "text_branch")
    if args.db_shard:
        argv_eval.append("--db-shard")
    total, phases, setup = timed_eval(argv_eval, "cirr", args.epochs)
    rec = {
        "metric": "cirr_fullscale_eval_wall_s",
        "value": round(total, 2),
        "unit": "s",
        "vs_baseline": None,
        "scale": _fingerprint(args),
        "batch_size": args.batch_size,
        "precision": args.precision,
        "device_preprocess": args.device_preprocess,
        "db_shard": args.db_shard,
        "eval_ranking": args.eval_ranking,
        "setup_s": round(setup, 2),  # CLIP resume load + upload, DB load + upload
        "full_ckpt_probe_s": round(full_ckpt_probe_s, 2),
        **phases,
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
