"""The port's serve CLI against keds_tpu's on the same checkpoint, DB,
corpus folder and queries (f32 on the CPU): the same result names in the
same order and scores within 1e-5, under host ranking and under device
ranking (DEVICE_RANK_MIN_ROWS patched to 1), with --topn above the corpus
size, and above 256 over a corpus of 300 images.  Entries whose scores lie
within 1e-5 of each other may swap: the two packages sum the towers in
another order."""

import json

import numpy as np
import pytest
import torch

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from keds_tpu import tokenizer as jtok  # noqa: E402
from keds_tpu.cli import serve as jserve  # noqa: E402
from keds_tpu.io.checkpoint import save_train_checkpoint  # noqa: E402

from keds_tpu_torch.cli import serve as tserve  # noqa: E402
from torch_port_helpers import (D, JCFG, jax_models, write_synthetic_vocab)  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-5


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Checkpoint, DB, corpora of 9 and 300 images, queries, vocab."""
    root = tmp_path_factory.mktemp("serve")
    params, heads = jax_models()
    ckpt = root / "ckpt.pt"
    save_train_checkpoint(str(ckpt), epoch=1, name="t", clip_params=params, clip_cfg=JCFG,
                          heads=heads)
    rng = np.random.default_rng(0)
    db = root / "db"
    db.mkdir()
    np.save(db / "image_db.npy", rng.standard_normal((64, D)).astype(np.float32))
    np.save(db / "text_db.npy", rng.standard_normal((64, D)).astype(np.float32))
    (db / "database_names.txt").write_text("\n".join(f"n{i}" for i in range(64)))
    for name, n in (("small", 9), ("large", 300)):
        (root / name).mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (40, 36 + i % 9, 3), np.uint8)).save(
                root / name / f"c{i:03d}.png")
    qimgs = [str(root / "small" / f"c{i:03d}.png") for i in (0, 4, 7)]
    (root / "queries.jsonl").write_text("\n".join(
        json.dumps({"image": q, "text": f"a photo of * , the {w} dog"})
        for q in qimgs for w in ("red", "cat")) + "\n" + json.dumps({"image": qimgs[1]}))
    vocab = write_synthetic_vocab(root / "merges.txt.gz")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KEDS_TPU_BPE_VOCAB", vocab)
        jtok.get_tokenizer.cache_clear()
        jtok.star_token_id.cache_clear()
        try:
            yield root
        finally:
            jtok.get_tokenizer.cache_clear()
            jtok.star_token_id.cache_clear()


def _serve(mod, root, corpus, topn, name, extra=()):
    out = root / f"{name}.jsonl"
    mod.main(["--resume", str(root / "ckpt.pt"), "--database-path", str(root / "db"),
              "--target-data", str(root / corpus), "--query_file", str(root / "queries.jsonl"),
              "--demo-out", str(out), "--batch-size", "4", "--db-topk", "4",
              "--topn", str(topn), "--precision", "fp32", "--logs", str(root / "logs"),
              "--name", name, "--workers", "2", *extra])
    return [json.loads(line) for line in out.read_text().splitlines()]


def assert_same_results(got, want, n_results):
    """Per query: the same prompt and length, scores by rank within TOL, and
    the same names but for swaps between entries within TOL of each other."""
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert (g["query"], g["text"]) == (w["query"], w["text"])
        gn, wn = [r["name"] for r in g["results"]], [r["name"] for r in w["results"]]
        gs, ws = (np.array([r["score"] for r in x["results"]]) for x in (g, w))
        assert len(gn) == len(wn) == n_results
        np.testing.assert_allclose(gs, ws, atol=TOL, rtol=0)
        assert (np.diff(gs) <= 0).all()
        for r in np.nonzero(np.array(gn) != np.array(wn))[0]:
            j = wn.index(gn[r]) if gn[r] in wn else len(wn) - 1
            assert abs(ws[j] - ws[r]) <= TOL, (r, gn[r], wn[r])


@pytest.mark.parametrize("ranking", ["host", "device"])
@pytest.mark.parametrize("corpus,topn,n_results", [("small", 5, 5), ("small", 50, 9),
                                                    ("large", 280, 280)])
def test_serve_cli_equals_jax(run, monkeypatch, ranking, corpus, topn, n_results):
    if ranking == "device":
        monkeypatch.setattr(jserve, "DEVICE_RANK_MIN_ROWS", 1)
        monkeypatch.setattr(tserve, "DEVICE_RANK_MIN_ROWS", 1)
    name = f"{corpus}_{topn}_{ranking}"
    want = _serve(jserve, run, corpus, topn, "jax_" + name)
    got = _serve(tserve, run, corpus, topn, "port_" + name, ["--device", "cpu"])
    assert_same_results(got, want, n_results)


@pytest.mark.parametrize("ranking", ["host", "device"])
def test_serve_cli_topn_zero_writes_what_jax_writes(run, monkeypatch, ranking):
    """--topn 0: every query's line is keds_tpu's, line for line, with
    "results": [] (device ranking: a top-k at k = 0, which launches
    nothing on the card)."""
    if ranking == "device":
        monkeypatch.setattr(jserve, "DEVICE_RANK_MIN_ROWS", 1)
        monkeypatch.setattr(tserve, "DEVICE_RANK_MIN_ROWS", 1)
    want = _serve(jserve, run, "small", 0, "jax_zero_" + ranking)
    got = _serve(tserve, run, "small", 0, "port_zero_" + ranking, ["--device", "cpu"])
    assert len(got) == 7 and got == want
    assert all(line["results"] == [] for line in got)


def test_serve_cli_refuses_what_it_does_not_take(run, tmp_path):
    """What the serve CLI refuses; and --num-partitions 2 on one process,
    which it takes as the JAX CLI does: clamped to the one rank with the
    warning, the results those of the JAX CLI."""
    base = ["--target-data", "x", "--query_file", "q", "--logs", str(tmp_path)]
    with pytest.raises(SystemExit, match="--resume"):
        tserve.main(base)
    with pytest.raises(SystemExit, match="orbax .*OCDBT"):
        tserve.main(base + ["--resume", str(tmp_path)])
    with pytest.raises(SystemExit, match="left out on purpose"):
        tserve.main(base + ["--resume", "c.pt", "--no-device-preprocess"])
    got = _serve(tserve, run, "small", 5, "port_np2", ["--device", "cpu",
                                                       "--num-partitions", "2"])
    assert "2 devices requested, 1 available — using all" in (
        run / "logs" / "port_np2" / "out.log").read_text()
    assert_same_results(got, _serve(jserve, run, "small", 5, "jax_np2"), 5)


@pytest.mark.parametrize("ranking,batches", [("host", 10), ("device", 1)])
def test_serve_cli_profile_dir_traces_the_query_batches(run, monkeypatch, ranking, batches):
    """--profile-dir: one trace of the first ``PROFILE_BATCHES`` query
    batches (all 2 of them at 10, the first at 1), each an engine.search
    range with its engine.batch, stages and fetch; the results those of
    the run without it."""
    import glob

    if ranking == "device":
        monkeypatch.setattr(tserve, "DEVICE_RANK_MIN_ROWS", 1)
    monkeypatch.setattr(tserve, "PROFILE_BATCHES", batches)
    prof = run / f"prof_{ranking}"
    got = _serve(tserve, run, "small", 5, f"port_prof_{ranking}",
                 ["--device", "cpu", "--profile-dir", str(prof)])
    assert got == _serve(tserve, run, "small", 5, f"port_noprof_{ranking}", ["--device", "cpu"])
    (path,) = glob.glob(str(prof / "*.pt.trace.json"))
    names = [e["name"] for e in json.loads(open(path).read())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    stages = ["engine.search", "engine.batch", "input", "encode", "retrieve", "fuse", "text",
              "fetch"] + (["rank"] if ranking == "device" else ["engine.compose"])
    for stage in stages:
        assert names.count(stage) == min(batches, 2), stage
