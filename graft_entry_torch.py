"""The composed-query forward and a data-parallel dry run of keds_tpu_torch
(the port's counterpart of ``__graft_entry__.py``).

``entry()``             the composed-query forward of ViT-L/14 in bf16 and
                        its example arguments: encode the reference image,
                        take the top-16 rows of each modality of a 16384-row
                        knowledge DB, fuse them into 3 pseudo-tokens, splice
                        those in at ``*`` of the prompt, run the text tower
                        and unit-normalise.  On the card unless asked.
``dryrun_multichip(n)`` a data-parallel dry run over ``n`` ranks at tiny
                        shapes: the image-stream train step with the DB
                        row-sharded, the same step from precomputed
                        neighbour indices (its loss bit-equal), the
                        text-stream step and the sharded composed query.

    python graft_entry_torch.py [--device cpu]              # entry(), one call
    python graft_entry_torch.py multichip N [--device cpu]  # dryrun_multichip(N)

The dry run starts its ranks as child processes of this file (gloo when
the ranks share one card or run on the CPU, NCCL when each has a card of
its own).  Imports torch, numpy, the standard library and keds_tpu_torch.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from keds_tpu_torch import synth
from keds_tpu_torch.config import Config
from keds_tpu_torch.models import clip as mclip
from keds_tpu_torch.models.composition import compose_pseudo_tokens
from keds_tpu_torch.models.convert import cast_floating
from keds_tpu_torch.ops import attention as att_mod, topk as topk_mod
from keds_tpu_torch.parallel.mesh import fetch_global, make_mesh, maybe_init_distributed
from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever, unit_rows
from keds_tpu_torch.runtime import DeviceLike, resolve_device
from keds_tpu_torch.tokenizer import bucket_text
from keds_tpu_torch.train.losses import TrainBatch
from keds_tpu_torch.train.trainer import make_optimizer, make_train_step

SPLIT_ID = 265            # '*' in the CLIP BPE vocab
ENTRY_DB_ROWS = 16384
RANK_TIMEOUT_S = 600.0    # a rank that fails leaves the others in a collective


def _build(cfg: mclip.ClipConfig, db_rows: int, *, dtype: torch.dtype, seed: int = 0,
           device: DeviceLike = None):
    """(CLIP params, fusion heads, knowledge DB) of ``cfg`` made from
    ``seed`` on ``device`` (:func:`keds_tpu_torch.synth.build`: IM2TEXT's
    hidden width 512 or ``embed_dim``, two 3-layer CrossFormers, unit-norm
    tables of ``db_rows`` rows made on the device)."""
    return synth.build(cfg, db_rows=db_rows, dtype=dtype, seed=seed, device=device)


def composed_query(clip_params: dict, heads, db_img: torch.Tensor, db_txt: torch.Tensor,
                   images: torch.Tensor, text: torch.Tensor, *,
                   cfg: Optional[mclip.ClipConfig] = None, k: int = 16, mesh=None
                   ) -> torch.Tensor:
    """The composed-query forward: ``images`` (B, H, W, 3) through the image
    tower, the top-``k`` rows of ``db_img`` and ``db_txt`` for each feature,
    the fusion heads' pseudo-tokens spliced in at ``*`` of ``text`` (B, S),
    the text tower and unit rows (B, embed_dim).  ``cfg`` defaults to
    ``models.clip.VIT_L_14`` as it stands at call time.  With ``mesh`` the
    tables are this rank's shards of a DB split over it (every row real) and
    the batch is this rank's rows.  Runs eagerly where its tensors live."""
    cfg = cfg or mclip.VIT_L_14
    rows = db_img.shape[0] * (mesh.size if mesh is not None else 1)
    retriever = Retriever(KnowledgeDB(db_img, db_txt, [str(i) for i in range(rows)], mesh))
    feats = mclip.encode_image(clip_params, cfg, images)
    topk_img, topk_txt = retriever.retrieve_features(feats.float(), k=k)
    tokens = compose_pseudo_tokens(heads, feats, topk_img.to(feats.dtype),
                                   topk_txt.to(feats.dtype), train=False)
    out = mclip.encode_text_img_retrieval(clip_params, cfg, text, tokens, split_id=SPLIT_ID)
    return out / out.norm(dim=-1, keepdim=True)


def entry(device: DeviceLike = None):
    """``(fn, args)``: :func:`composed_query` and its example arguments,
    ViT-L/14 (``models.clip.VIT_L_14`` at call time) in bf16 with a
    16384-row DB (:func:`_build`, seed 0), 8 zero images and 8 "a photo of
    * , <14-token caption>" prompts bucketed to S=32, the bucket serving
    runs them in.  ``device`` None is the card (``RuntimeError`` without
    one)."""
    dev = resolve_device(device)
    cfg = mclip.VIT_L_14
    dtype = torch.bfloat16
    clip_params, heads, db = _build(cfg, ENTRY_DB_ROWS, dtype=dtype, device=dev)
    text = np.zeros((8, 77), np.int32)
    text[:, 0] = 49406
    text[:, 1:4] = [320, 1125, 539]
    text[:, 4:6] = [SPLIT_ID, 267]
    text[:, 6:20] = np.random.default_rng(0).integers(1000, 40000, (8, 14))
    text[:, 20] = 49407
    text = bucket_text(text)
    px = cfg.image_resolution
    images = torch.zeros((8, px, px, 3), dtype=dtype, device=dev)
    return composed_query, (clip_params, heads, db.image_db, db.text_db, images,
                            torch.as_tensor(text, device=dev))


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> List[dict]:
    """A data-parallel dry run over ``n_devices`` ranks (:func:`_dryrun_rank`),
    one process each, started here as children of this file unless a
    process group is up already (then this process is one rank of it).
    ``device`` None puts every rank on the card (``RuntimeError`` without
    one; ranks sharing one card take turns on it over gloo); ``"cpu"`` runs
    them on the CPU.  A rank that fails, or a run past RANK_TIMEOUT_S,
    stops every rank and raises ``RuntimeError`` with their output.  Prints
    rank 0's output; returns each rank's result."""
    if dist.is_initialized():
        return [_dryrun_rank(n_devices, device)]
    resolve_device(device)
    return _run_ranks(n_devices, device)


def _free_url() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def _run_ranks(n: int, device: DeviceLike, timeout: float = RANK_TIMEOUT_S) -> List[dict]:
    """``n`` children ``graft_entry_torch.py multichip n --rank-dir ...``, each
    with RANK, WORLD_SIZE, LOCAL_RANK and LOCAL_WORLD_SIZE, over one free
    localhost port; each writes ``rank<r>.json`` in a temporary directory."""
    cmd = [sys.executable, str(pathlib.Path(__file__).resolve()), "multichip", str(n),
           "--dist-url", _free_url()]
    if device is not None:
        cmd += ["--device", str(device)]
    with tempfile.TemporaryDirectory(prefix="dryrun_") as d:
        procs, logs = [], []
        try:
            for r in range(n):
                env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                           LOCAL_WORLD_SIZE=str(n))
                logs.append(open(os.path.join(d, f"rank{r}.log"), "w"))
                procs.append(subprocess.Popen(cmd + ["--rank-dir", d], env=env,
                                              stdout=logs[-1], stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline or any(p.poll() for p in procs):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            for log in logs:
                log.close()
        out = [pathlib.Path(d, f"rank{r}.log").read_text() for r in range(n)]
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(
                f"dryrun_multichip({n}): rank(s) {failed} failed or ran past {timeout} s\n"
                + "\n".join(f"--- rank {r} (exit {p.returncode})\n{out[r][-4000:]}"
                            for r, p in enumerate(procs)))
        sys.stdout.write(out[0])
        sys.stdout.flush()
        return [json.loads(pathlib.Path(d, f"rank{r}.json").read_text()) for r in range(n)]


def _check(ok: bool, message: str) -> None:
    if not ok:
        raise AssertionError(message)


def _dryrun_rank(n: int, device: DeviceLike) -> dict:
    """One rank of the dry run, at tiny shapes in f32 (embed 64, 32 px,
    two 128-wide vision layers of patch 16, two 64-wide text layers of one
    head) with the 64·n-row DB split over the ranks and a global batch of
    4·n feature pairs, this rank's block of it:

    (a) the image-stream train step (finite loss);
    (b) the same step from the same initial heads and a fresh optimizer,
        the neighbours given as indices from the sharded search: its loss
        equals (a)'s bit for bit;
    (c) the text-stream step after (a), templates tiled from one prompt row;
    (d) the composed query over the sharded DB at k=8: finite unit rows.

    Rank 0 prints a line a step.  Kernel launch counts are zeroed before
    (a) and read after (d).  Returns the losses, the lines and the counts."""
    mesh = make_mesh(n, device)
    _check(mesh.size == n, f"dryrun_multichip({n}): {mesh.size} rank(s) in the group")
    dev, tag, lines = mesh.device, f"dryrun_multichip({n})", []

    def say(line: str) -> None:
        lines.append(line)
        if mesh.rank == 0:
            print(line, flush=True)

    kernels = {"attention": att_mod.KERNEL, "attention_bwd": att_mod.BWD_KERNEL,
               "mips_topk": topk_mod.KERNEL}
    f32 = torch.float32
    cfg = mclip.ClipConfig(embed_dim=64, image_resolution=32, vision_layers=2,
                           vision_width=128, vision_patch_size=16, transformer_width=64,
                           transformer_heads=1, transformer_layers=2)
    clip_params, heads, db = _build(cfg, 64 * n, dtype=f32, device=dev)
    db = db.shard_over(mesh)
    retriever = Retriever(db)
    opt_cfg = Config(lr=1e-4, beta1=0.9, beta2=0.98, eps=1e-6, wd=0.1, warmup=10)
    prompt = np.zeros((1, 77), np.int64)
    prompt[0, :5] = [49406, 320, 1125, 539, 49407]
    common = dict(prompt_tokens=prompt, split_id=SPLIT_ID, compute_dtype=f32, device=dev,
                  grad_scale=1.0 / n, mesh=mesh)

    def image_step():
        """Trainable copies of the initial heads (the step updates them in
        place), a fresh optimizer and the image-stream step over them."""
        theads = cast_floating(copy.deepcopy(heads), f32, dev)
        opt, sched = make_optimizer(opt_cfg, 100, theads)
        return theads, opt, sched, make_train_step(clip_params, cfg, retriever, opt, sched,
                                                   stream="image", **common)

    heads_a, opt, sched, step_a = image_step()
    heads_b, _, _, step_b = image_step()

    b = 4 * n
    rng = np.random.default_rng(0)
    other = np.zeros((b, 77), np.int64)
    other[:, :9] = [49406, 320, 1125, 539, SPLIT_ID, SPLIT_ID, SPLIT_ID, 1929, 49407]
    image_features = rng.standard_normal((b, 64)).astype(np.float32)
    caption_features = rng.standard_normal((b, 64)).astype(np.float32)
    own = slice(4 * mesh.rank, 4 * (mesh.rank + 1))

    def local(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a[own], device=dev)

    batch = TrainBatch(image_features=local(image_features),
                       caption_features=local(caption_features), other_tokens=local(other))
    for k in kernels.values():
        k.reset()

    loss = float(step_a(heads_a, batch, 0))
    _check(np.isfinite(loss), f"non-finite image-stream loss {loss}")
    say(f"{tag}: image-stream step OK, loss={loss:.4f}")

    q = unit_rows(batch.image_features).to(db.image_db.dtype)
    _, img_idx = retriever.search(q, db.image_db, 16, "image")
    _, txt_idx = retriever.search(q, db.text_db, 16, "text")
    loss_nb = float(step_b(heads_b, batch._replace(img_idx=img_idx, txt_idx=txt_idx), 0))
    _check(loss_nb == loss, f"neighbours-mode loss {loss_nb!r} != search-mode loss {loss!r}")
    say(f"{tag}: precomputed-neighbour step OK (bit-equal, loss={loss_nb:.4f})")

    step_t = make_train_step(clip_params, cfg, retriever, opt, sched, stream="text",
                             db_other_tokens=np.tile(other[:1], (64 * n, 1)), **common)
    loss_t = float(step_t(heads_a, batch, 1))
    _check(np.isfinite(loss_t), f"non-finite text-stream loss {loss_t}")
    say(f"{tag}: text-stream step OK, loss={loss_t:.4f}")

    prompt_q = np.zeros((b, 77), np.int64)
    prompt_q[:, :8] = [49406, 320, 1125, 539, SPLIT_ID, 267, 1929, 49407]
    images_q = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        out = composed_query(clip_params, heads_a, db.image_db, db.text_db, local(images_q),
                             local(prompt_q), cfg=cfg, k=8, mesh=mesh)
    out = fetch_global(mesh, out, b).cpu().numpy()
    _check(out.shape == (b, cfg.embed_dim) and bool(np.isfinite(out).all())
           and np.allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5),
           f"sharded composed query: {out.shape}, finite {np.isfinite(out).all()}")
    say(f"{tag}: sharded composed-query OK, out {out.shape}")
    return dict(rank=mesh.rank, device=str(dev), backend=mesh.backend,
                losses=dict(image=loss, neighbours=loss_nb, text=loss_t), lines=lines,
                launches={name: dict(k.launches) for name, k in kernels.items()})


def _rank_main(n: int, device: Optional[str], url: str, rank_dir: str) -> None:
    """A child of :func:`_run_ranks`: joins the group, runs its rank and
    writes ``rank<r>.json``."""
    maybe_init_distributed(Config(distributed=True, dist_url=url, device=device))
    try:
        result = _dryrun_rank(n, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    pathlib.Path(rank_dir, f"rank{result['rank']}.json").write_text(json.dumps(result))


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="The composed-query forward once, or the "
                                "data-parallel dry run over N ranks (multichip N).")
    p.add_argument("mode", nargs="?", choices=["multichip"])
    p.add_argument("n", nargs="?", type=int, default=8)
    p.add_argument("--device", default=None, help="cpu, or the card (default)")
    p.add_argument("--dist-url", help=argparse.SUPPRESS)
    p.add_argument("--rank-dir", help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.mode == "multichip":
        if a.rank_dir:
            _rank_main(a.n, a.device, a.dist_url, a.rank_dir)
        else:
            dryrun_multichip(a.n, a.device)
        return 0
    fn, args = entry(a.device)
    with torch.no_grad():
        out = fn(*args)
    if out.is_cuda:
        torch.cuda.synchronize()
    print("entry() ran:", tuple(out.shape), out.dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
