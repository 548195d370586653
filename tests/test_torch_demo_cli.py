"""The port's demo CLI against keds_tpu's (f32 on the CPU), both intents of
the checkpoint's img2text: an MLP (the pic2word splice at ``*``) and a
CrossFormer (late fusion over get_text_tokens).  The feature cache (its
file name, i.e. the fingerprint, its paths, and its features within 1e-5)
and index.html (the top-10 of every prompt) equal JAX's; the fingerprint
follows the checkpoint."""

import os
import pickle

import numpy as np
import pytest
import torch

import jax

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from keds_tpu import tokenizer as jtok  # noqa: E402
from keds_tpu.cli import demo as jdemo  # noqa: E402
from keds_tpu.io.checkpoint import save_train_checkpoint  # noqa: E402
from keds_tpu.models import clip as jclip  # noqa: E402
from keds_tpu.models.convert import crossformer_pytree_to_state_dict  # noqa: E402

from keds_tpu_torch.cli import demo as tdemo  # noqa: E402
from keds_tpu_torch.config import parse_args  # noqa: E402
from keds_tpu_torch.models import clip as tclip  # noqa: E402
from torch_port_helpers import (JCFG, TCFG, jax_models, port_models, prompt_tokens,  # noqa: E402
                                to_numpy, write_synthetic_vocab)

torch.set_num_threads(1)
PROMPTS = "a cartoon of *,a photo of * and the red dog"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """An MLP and a CrossFormer checkpoint, a 14-image csv corpus, two query
    images and the synthetic vocab."""
    root = tmp_path_factory.mktemp("demo")
    params, heads = jax_models()
    mlp = root / "mlp.pt"
    save_train_checkpoint(str(mlp), epoch=1, name="t", clip_params=params, clip_cfg=JCFG,
                          heads=heads)
    ckpt = torch.load(mlp, map_location="cpu", weights_only=False)
    ckpt["state_dict_img2text"] = {
        k: torch.from_numpy(np.array(v)) for k, v in
        crossformer_pytree_to_state_dict(to_numpy(heads.retrieval_fuse)).items()}
    torch.save(ckpt, root / "cross.pt")
    rng = np.random.default_rng(4)
    (root / "imgs").mkdir()
    rows = ["filepath\ttitle"]
    for i in range(14):
        p = root / "imgs" / f"r{i:02d}.png"
        Image.fromarray(rng.integers(0, 255, (40, 32 + i, 3), np.uint8)).save(p)
        rows.append(f"{p}\tan image {i}")
    (root / "corpus.csv").write_text("\n".join(rows))
    for q in ("q0", "q1"):
        Image.fromarray(rng.integers(0, 255, (44, 40, 3), np.uint8)).save(root / f"{q}.png")
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


def _demo(mod, root, ckpt, cwd, monkeypatch, extra=()):
    cwd.mkdir(exist_ok=True)
    monkeypatch.chdir(cwd)
    out = mod.main(["--retrieval-data", str(root / "corpus.csv"),
                    "--query_file", f"{root / 'q0.png'},{root / 'q1.png'}",
                    "--prompts", PROMPTS, "--resume", str(root / ckpt),
                    "--demo-out", str(cwd / "demo"), "--precision", "fp32",
                    "--batch-size", "4", "--logs", str(cwd / "logs"), "--name", "demo",
                    *extra])
    (cache,) = os.listdir(cwd / "data")
    with open(cwd / "data" / cache, "rb") as f:
        return out, cache, pickle.load(f), (cwd / "demo" / "index.html").read_text()


@pytest.mark.parametrize("ckpt,late", [("mlp.pt", False), ("cross.pt", True)])
def test_demo_cli_equals_jax(run, tmp_path, monkeypatch, ckpt, late):
    _, jcache, jdata, jhtml = _demo(jdemo, run, ckpt, tmp_path / "jax", monkeypatch)
    out, tcache, tdata, thtml = _demo(tdemo, run, ckpt, tmp_path / "port", monkeypatch,
                                      ["--device", "cpu"])
    assert out["late_fusion"] is late
    assert tcache == jcache and os.path.basename(out["cache"]) == tcache
    assert tdata["path"] == jdata["path"] and len(tdata["path"]) == 14
    assert tdata["feats"].dtype == np.float32
    np.testing.assert_allclose(tdata["feats"], np.asarray(jdata["feats"]), atol=1e-5, rtol=0)
    assert thtml == jhtml
    assert thtml.count("<table>") == 4 and PROMPTS.split(",")[1] in thtml
    # the page lists what the run returned: 10 per prompt per query
    names = [os.path.basename(p) for q in out["top10"] for top in q for p in top]
    assert len(names) == 40 and all(f'src="images/{n}"' in thtml for n in names)
    # a second run reads the cache and ranks the same
    again = _demo(tdemo, run, ckpt, tmp_path / "port", monkeypatch, ["--device", "cpu"])
    assert again[0]["top10"] == out["top10"]


def test_demo_cache_fingerprint_follows_the_checkpoint(run, tmp_path):
    cfg = parse_args(["--retrieval-data", "coco", "--precision", "fp32"])
    a = tdemo.cache_path(cfg, str(run / "mlp.pt"))
    assert a == tdemo.cache_path(cfg, str(run / "mlp.pt"))
    assert a != tdemo.cache_path(cfg, str(run / "cross.pt"))
    copy = tmp_path / "mlp.pt"
    copy.write_bytes((run / "mlp.pt").read_bytes() + b"\0")
    assert tdemo.cache_path(cfg, str(copy)) != tdemo.cache_path(cfg, str(run / "mlp.pt"))
    assert tdemo.cache_path(parse_args(["--retrieval-data", "coco"]),
                            str(run / "mlp.pt")) != a   # the precision too
    assert os.path.basename(a).startswith("coco-")


def test_demo_refuses_orbax_directories(tmp_path):
    with pytest.raises(SystemExit, match="orbax .*OCDBT"):
        tdemo.main(["--resume", str(tmp_path), "--logs", str(tmp_path / "l")])


def test_get_text_tokens_equals_jax():
    """The late fusion's keys and values: the final-LN token sequence and
    the EOT indices, at the full width 77."""
    params, heads = jax_models()
    tparams, _ = port_models(params, heads)
    text = prompt_tokens(3, 9)
    jseq, jeot = jclip.get_text_tokens(params, JCFG, jax.numpy.asarray(text))
    tseq, teot = tclip.get_text_tokens(tparams, TCFG, torch.from_numpy(text))
    assert tseq.shape == (3, 77, 64)
    np.testing.assert_allclose(tseq.numpy(), np.asarray(jseq), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(teot.numpy(), np.asarray(jeot))
