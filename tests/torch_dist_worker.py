"""One rank of the port's multi-process tests (tests/test_torch_dist*.py).

    RANK=r WORLD_SIZE=2 python tests/torch_dist_worker.py <scenario> <dir> <dist-url>

(:func:`run_ranks` starts them.)  Imports keds_tpu_torch, torch and numpy
only, never jax: the test process makes the inputs (``<dir>/inputs.npz``
and files beside it) and the JAX references, each rank writes
``<dir>/out_rank<r>.npz``.  ``core`` runs the sharded top-k, the sharded
retriever, the engine with a mesh and the train steps of the three batch
kinds; ``cli`` runs the train, eval and serve command lines with
``--distributed``; both on the CPU over gloo.  ``cuda_topk`` runs the
sharded top-k at the serving size on ``cuda:0``, two gloo ranks sharing it.
"""

from __future__ import annotations

import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

torch.set_num_threads(1)

from keds_tpu_torch.parallel.mesh import (fetch_global, make_mesh,  # noqa: E402
                                          maybe_init_distributed)

OPT = dict(lr=1e-3, beta1=0.9, beta2=0.98, eps=1e-6, wd=0.1, warmup=2,
           skip_scheduler=False)
SPLIT_ID = 265


WORKER = os.path.abspath(__file__)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(scenario: str, workdir, world: int = 2, timeout: float = 300.0,
              env=None) -> list:
    """This script's ``scenario`` as ``world`` gloo ranks, each a child
    process; returns each rank's outputs (``out_rank<r>.npz``).  A rank that
    fails, or a run past ``timeout`` seconds (a hung collective), kills
    every rank and fails with the ranks' output."""
    import subprocess
    import time

    url = f"tcp://127.0.0.1:{free_port()}"
    repo = os.path.dirname(os.path.dirname(WORKER))
    procs, logs = [], []
    for r in range(world):
        e = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                 LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
                 PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
                 **(env or {}))
        logs.append(open(os.path.join(workdir, f"rank{r}.log"), "w"))
        procs.append(subprocess.Popen([sys.executable, WORKER, scenario, str(workdir), url],
                                      env=e, stdout=logs[-1], stderr=subprocess.STDOUT,
                                      cwd=repo))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        for log in logs:
            log.close()
    text = [open(os.path.join(workdir, f"rank{r}.log")).read() for r in range(world)]
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode} (limit {timeout} s):\n"
                                 + "\n".join(f"--- rank {i}\n{t[-3000:]}"
                                             for i, t in enumerate(text)))
    return [dict(np.load(os.path.join(workdir, f"out_rank{r}.npz"))) for r in range(world)]


def leaves(tree):
    """A pytree's tensors in jax.tree.leaves order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def block(mesh, a):
    """This rank's contiguous block of a global batch."""
    m = len(a) // mesh.size
    return a[mesh.rank * m:(mesh.rank + 1) * m]


def core(mesh, d: str, out: dict) -> None:
    from keds_tpu_torch.engine import ComposedQueryEngine
    from keds_tpu_torch.io.checkpoint import load_heads_checkpoint
    from keds_tpu_torch.models.loader import load_clip
    from keds_tpu_torch.ops.topk import mips_topk_sharded
    from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever, db_fingerprint

    z = dict(np.load(os.path.join(d, "inputs.npz")))

    def db_of(img, txt):
        return KnowledgeDB.from_arrays(img, txt, dtype=torch.float32, normalize=False,
                                       device="cpu").shard_over(mesh)

    for i in range(int(z["n_topk"])):
        q, rows, k = z[f"topk{i}_q"], z[f"topk{i}_db"], int(z[f"topk{i}_k"])
        v, ix = mips_topk_sharded(torch.from_numpy(q), db_of(rows, rows).image_db, k, mesh,
                                  len(rows))
        out[f"topk{i}_vals"], out[f"topk{i}_idx"] = v.numpy(), ix.numpy()

    db = KnowledgeDB.from_arrays(z["ret_img"], z["ret_txt"], dtype=torch.float32,
                                 device="cpu").shard_over(mesh)
    retr = Retriever(db)
    f = torch.from_numpy(block(mesh, z["ret_feat"]))
    ti, tt = retr.retrieve_features(f, k=int(z["ret_k"]))
    cap, cap_idx = retr.retrieve_caption_neighbors(f, k=2)
    n = len(z["ret_feat"])
    for name, t in (("ret_topk_img", ti), ("ret_topk_txt", tt), ("ret_cap", cap),
                    ("ret_cap_idx", cap_idx)):
        out[name] = fetch_global(mesh, t, n).numpy()
    out["ret_fingerprint"] = np.array(json.dumps(db_fingerprint(db), sort_keys=True))

    ckpt = os.path.join(d, "model.pt")
    params, cfg, _, _ = load_clip(ckpt, device="cpu")
    heads, _ = load_heads_checkpoint(ckpt, "cpu")
    engine = ComposedQueryEngine(params, cfg, heads, db_of(z["eng_img"], z["eng_txt"]),
                                 split_id=SPLIT_ID, compute_dtype=torch.float32, db_topk=8,
                                 encode_chunk=None, device="cpu", mesh=mesh)
    ims, txs = [z["eng_q0"], z["eng_q1"]], [z["eng_t0"], z["eng_t1"]]
    out["eng_composed"] = engine.compose(ims, txs)
    corpus = engine.encode_corpus([z["eng_c0"], z["eng_c1"]])
    out["eng_corpus"] = corpus
    dc = engine.corpus_to_device(corpus)
    out["eng_corpus_rows"] = np.array(dc.array.shape[0])
    out["eng_scores"], out["eng_idx"] = engine.search(ims, txs, dc, topn=int(z["eng_topn"]))
    train(mesh, z, params, cfg, heads, out)


def train(mesh, z: dict, params, cfg, heads, out: dict) -> None:
    """Per stream: three steps at dropout 0 (the step-0 gradients, the
    losses, the heads after the third) and one step at dropout 0.1."""
    import copy

    from keds_tpu_torch.models.convert import cast_floating
    from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever
    from keds_tpu_torch.train.losses import RawBatch, TrainBatch
    from keds_tpu_torch.train.trainer import make_optimizer, make_train_step

    db = KnowledgeDB.from_arrays(z["tr_img_db"], z["tr_txt_db"], dtype=torch.float32,
                                 device="cpu").shard_over(mesh)
    retr = Retriever(db)

    def batch(stream, t):
        b = lambda a: torch.from_numpy(block(mesh, a[t]))   # noqa: E731
        if stream == "raw":
            return RawBatch(images=b(z["tr_images"]), caption_tokens=b(z["tr_caps"]))
        extra = {"other_tokens": b(z["tr_other"]).long()} if stream == "text" else {}
        return TrainBatch(b(z["tr_feat_img"]), b(z["tr_feat_cap"]), **extra)

    for stream in ("image", "text", "raw"):
        for dropout, steps in ((0.0, 3), (0.1, 1)):
            theads = cast_floating(copy.deepcopy(heads), torch.float32, "cpu")
            opt, sched = make_optimizer(SimpleNamespace(**OPT), 10, theads)
            step = make_train_step(params, cfg, retr, opt, sched,
                                   stream="text" if stream == "text" else "image",
                                   prompt_tokens=z["tr_prompt"], split_id=SPLIT_ID,
                                   dropout=dropout, db_topk=int(z["tr_k"]),
                                   db_other_tokens=z["tr_db_other"] if stream == "text"
                                   else None, compute_dtype=torch.float32, device="cpu",
                                   grad_scale=0.5, mesh=mesh, seed=3)
            tag = f"tr_{stream}_d{int(dropout * 10)}"
            losses = []
            for t in range(steps):
                losses.append(float(step(theads, batch(stream, t), t)))
                if t == 0:
                    for i, p in enumerate(leaves(theads)):
                        if p.grad is not None:
                            out[f"{tag}_grad{i}"] = p.grad.numpy().copy()
            out[f"{tag}_losses"] = np.array(losses)
            for i, p in enumerate(leaves(theads)):
                out[f"{tag}_param{i}"] = p.detach().numpy().copy()


def cli(d: str, out: dict, url: str) -> None:
    """The train CLI (text stream on features, buckets), the eval CLI
    (CIRR, --db-shard, device ranking, epochs 1 and 2) and the serve CLI
    (--db-shard, the corpus ranked on the device), one process group."""
    from keds_tpu_torch.cli import serve
    from keds_tpu_torch.cli.eval_retrieval import main as eval_main
    from keds_tpu_torch.cli.main import main as train_main
    from keds_tpu_torch.evalkit import evaluators as tev

    spec = json.load(open(os.path.join(d, "cli.json")))
    dist = ["--distributed", "--dist-url", url, "--device", "cpu"]
    train_main(spec["train"] + dist)
    tables = []
    real = tev.evaluate_cirr

    def two_epochs(ctx, src, tgt, epochs=None):
        tables.append(real(ctx, src, tgt, epochs=[1, 2]))
        return tables[-1]

    tev.evaluate_cirr = two_epochs
    os.chdir(spec["eval_cwd"])
    eval_main(spec["eval"] + dist)
    out["eval_tables"] = np.array(json.dumps(
        {f"{j}/{key}": m for (j, key), m in tables[0].items()}, sort_keys=True))
    serve.DEVICE_RANK_MIN_ROWS = 1       # rank the small corpus on the device, split
    serve.main(spec["serve"] + dist)


def cuda_topk(out: dict, url: str) -> None:
    """B1 over a 500 000 x 768 bf16 DB split over the ranks of cuda:0, and
    (rank 0) over the whole DB."""
    from keds_tpu_torch.ops import topk as topk_mod
    from keds_tpu_torch.retrieval.database import KnowledgeDB

    maybe_init_distributed(SimpleNamespace(distributed=True, dist_url=url, device="cuda"))
    mesh = make_mesh()
    gen = torch.Generator(mesh.device).manual_seed(0)

    def unit(n):
        x = torch.randn((n, 768), generator=gen, device=mesh.device)
        return (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)

    q, rows = unit(64), unit(500_000)
    shard = KnowledgeDB(rows, rows, [str(i) for i in range(len(rows))]).shard_over(mesh)
    before = topk_mod.KERNEL.launches["bf16_tc"]
    vals, idx = topk_mod.mips_topk_sharded(q, shard.image_db, 16, mesh, len(rows))
    out.update(vals=vals.cpu().numpy(), idx=idx.cpu().numpy(),
               launches=np.array(topk_mod.KERNEL.launches["bf16_tc"] - before),
               shard_rows=np.array(shard.size), backend=np.array(mesh.backend),
               device=np.array(str(mesh.device)))
    if mesh.rank == 0:
        whole_vals, whole_idx = topk_mod.mips_topk(q, rows, 16)
        out.update(whole_vals=whole_vals.cpu().numpy(), whole_idx=whole_idx.cpu().numpy())


def int8(mesh, d: str, out: dict) -> None:
    """The sharded int8 search (true-row and dequantized re-rank, at k = 5
    and k = 0), its pad rows against negative scores, and the int8 and approx Retrievers over a
    sharded DB (tests/test_torch_int8_retrieval.py)."""
    from keds_tpu_torch.ops.topk import mips_topk_int8_sharded, quantize_int8
    from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever

    z = dict(np.load(os.path.join(d, "inputs.npz")))
    q = torch.from_numpy(z["q"])
    db = KnowledgeDB.from_arrays(z["rows"], z["txt"], dtype=torch.float32, normalize=False,
                                 device="cpu").shard_over(mesh)
    q8, sc = quantize_int8(db.image_db)
    for tag, rows in (("true", db.image_db), ("deq", None)):
        for k, key in ((5, tag), (0, tag + "_k0")):
            v, ix = mips_topk_int8_sharded(q, q8, sc, k, mesh, len(z["rows"]), db_shard=rows)
            out[f"sharded_{key}_vals"], out[f"sharded_{key}_idx"] = v.numpy(), ix.numpy()
    neg = KnowledgeDB.from_arrays(z["neg"], z["neg"], dtype=torch.float32, normalize=False,
                                  device="cpu").shard_over(mesh)
    v, ix = mips_topk_int8_sharded(torch.ones((1, 16)), *quantize_int8(neg.image_db), 4, mesh,
                                   len(z["neg"]), db_shard=neg.image_db)
    out["pad_vals"], out["pad_idx"] = v.numpy(), ix.numpy()
    n = len(z["q"])
    for backend in ("int8", "approx"):
        retr = Retriever(KnowledgeDB.from_arrays(z["rows"], z["txt"], dtype=torch.float32,
                                                 device="cpu").shard_over(mesh), backend)
        ti, tt = retr.retrieve_features(torch.from_numpy(block(mesh, z["q"])), k=4)
        out[f"{backend}_img"] = fetch_global(mesh, ti, n).numpy()
        out[f"{backend}_txt"] = fetch_global(mesh, tt, n).numpy()


def main() -> int:
    scenario, d, url = sys.argv[1:4]
    if scenario in ("core", "int8"):
        maybe_init_distributed(SimpleNamespace(distributed=True, dist_url=url, device="cpu"))
    out: dict = {}
    if scenario == "core":
        core(make_mesh(device="cpu"), d, out)
    elif scenario == "int8":
        int8(make_mesh(device="cpu"), d, out)
        # both ranks done with the group before either exits: a rank that
        # exits while the other's gloo threads still talk to it aborts
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    elif scenario == "cuda_topk":
        cuda_topk(out, url)
    else:
        # the first CLI brings the group up, the others find it up
        cli(d, out, url)
    rank = int(os.environ["RANK"])
    np.savez(os.path.join(d, f"out_rank{rank}.npz"), **out)
    print(f"rank {rank} done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
