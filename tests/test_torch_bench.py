"""bench_torch.py against bench.py on the CPU (CLIP's VIT_L_14 patched to a
tiny 224 px config in both packages): the JSON line's keys, metric, unit,
method and curve, vs_baseline over bench.py's base, the arrays each bench
feeds its steps (bit for bit), the timed composed step against
__graft_entry__'s forward on the same weights, the refusals, the flags, and
the refusal without CUDA."""

import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as gj
import bench
import keds_tpu.engine as jengine
import keds_tpu.tokenizer as jtokenizer
import keds_tpu.train.trainer as jtrainer
from keds_tpu.models import clip as jclip

import bench_torch as bt
from keds_tpu_torch import tokenizer as ttokenizer
from keds_tpu_torch.models import clip as tclip
from keds_tpu_torch.models.convert import clip_from_numpy, heads_from_numpy
from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever
from keds_tpu_torch.train import trainer as ttrainer

from torch_port_helpers import to_numpy

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
ATOL = 1e-4          # the engine parity tests' (tests/test_torch_engine.py)
TINY = dict(embed_dim=64, image_resolution=224, vision_layers=2, vision_width=64,
            vision_patch_size=32, transformer_width=64, transformer_heads=1,
            transformer_layers=2)
SMALL = ["--batch", "32", "--db-rows", "64", "--iters", "2"]
SERVE_KEYS = {"metric", "value", "unit", "vs_baseline"}
TRAIN_KEYS = {"metric", "value", "unit", "method", "vs_baseline"}
CURVE_KEYS = {"two_prog_chained_ms", "fused_chained_ms", "fused_device_ms"}
# bench.py's train lines: metric, method and A100 base of each form (bench.py:598-611)
TRAIN_FORMS = {
    "image": ([], "train_samples_per_sec_per_chip", "chained", 2000.0),
    "text": (["--stream", "text"], "text_stream_train_samples_per_sec_per_chip",
             "chained", 810.0),
    "raw": (["--raw"], "raw_train_samples_per_sec_per_chip", "chained", 490.0),
    "neighbors": (["--neighbors"], "neighbors_train_samples_per_sec_per_chip",
                  "x8-scan", 2000.0),
    "scan": (["--scan"], "train_samples_per_sec_per_chip", "x8-scan", 2000.0),
}
REFUSALS = {"neighbors_retrieval": ["--neighbors", "--retrieval", "approx"],
            "neighbors_raw": ["--neighbors", "--raw"],
            "scan_raw": ["--scan", "--raw"],
            "text_raw": ["--stream", "text", "--raw"]}


def _bits(a) -> np.ndarray:
    """A JAX array or a tensor as numpy, bf16 as its bit pattern."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


class Capture:
    """Records bucket_text's results, the pipelined inputs and the batches
    the train steps are called with, wrapping each original."""

    def __init__(self):
        self.texts, self.inputs, self.batches, self.tables = [], [], [], []

    def bucket_text(self, orig):
        def wrapped(*a, **kw):
            out = orig(*a, **kw)
            self.texts.append(np.array(out))
            return out
        return wrapped

    def pipelined(self, orig):
        def wrapped(step, inputs, *a, **kw):
            self.inputs.append(list(inputs))
            return orig(step, inputs, *a, **kw)
        return wrapped

    def train_factory(self, orig):
        def factory(*a, **kw):
            self.tables.append(kw.get("db_other_tokens"))
            step = orig(*a, **kw)

            def wrapped(*sa, **skw):
                # JAX's step takes (heads, opt, batch, key), the port's (heads, batch, t)
                if not self.batches:
                    self.batches.append(next(x for x in sa if hasattr(x, "_fields") and
                                             x._fields[0] in ("images", "image_features")))
                return step(*sa, **skw)
            wrapped.__dict__.update(step.__dict__)
            return wrapped
        return factory


def _line(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


@pytest.fixture(scope="module")
def tiny():
    """Both packages' VIT_L_14 patched to TINY for the module."""
    mp = pytest.MonkeyPatch()
    mp.setenv("KEDS_TPU_JAX_CACHE", "0")      # _build's setup_jax: no cache under HOME
    mp.setattr(jclip, "VIT_L_14", jclip.ClipConfig(**TINY))
    mp.setattr(tclip, "VIT_L_14", tclip.ClipConfig(**TINY))
    yield mp
    mp.undo()


def _run_jax(mp, argv):
    cap = Capture()
    with mp.context() as m:
        m.setattr(sys, "argv", ["bench.py", *argv])
        m.setattr(jengine, "bucket_text", cap.bucket_text(jengine.bucket_text))
        m.setattr(jtokenizer, "bucket_text", cap.bucket_text(jtokenizer.bucket_text))
        m.setattr(bench, "timeit_pipelined", cap.pipelined(bench.timeit_pipelined))
        m.setattr(jtrainer, "make_train_step", cap.train_factory(jtrainer.make_train_step))
        bench.main()
    return cap


def _run_port(mp, argv):
    cap = Capture()
    with mp.context() as m:
        m.setattr(ttokenizer, "bucket_text", cap.bucket_text(ttokenizer.bucket_text))
        m.setattr(bt, "timeit_pipelined", cap.pipelined(bt.timeit_pipelined))
        m.setattr(ttrainer, "make_train_step", cap.train_factory(ttrainer.make_train_step))
        bt.run([*argv, "--device", "cpu"])
    return cap


@pytest.fixture(scope="module")
def runs(tiny):
    """bench.py and bench_torch.py, headline and --train, each line with
    what it captured."""
    out = {}
    for mode, extra in (("serve", []), ("train", ["--train"])):
        for name, run in (("jax", _run_jax), ("port", _run_port)):
            with _capsys() as cs:
                cap = run(tiny, SMALL + extra)
            out[mode, name] = (cs.line(), cap)
    return out


class _capsys:
    """stdout of a block (the module fixture cannot take capsys)."""

    def __enter__(self):
        import io
        self._old, self._buf = sys.stdout, io.StringIO()
        sys.stdout = self._buf
        return self

    def __exit__(self, *exc):
        sys.stdout = self._old

    def line(self) -> dict:
        out = self._buf.getvalue().strip().splitlines()
        assert len(out) == 1, out
        return json.loads(out[0])


@pytest.mark.parametrize("mode", ["serve", "train"])
def test_line_matches_bench(runs, mode):
    (jline, _), (tline, _) = runs[mode, "jax"], runs[mode, "port"]
    assert set(tline) == set(jline) == (SERVE_KEYS if mode == "serve" else TRAIN_KEYS)
    for key in ("metric", "unit", "method"):
        assert tline.get(key) == jline.get(key)
    base = bench.A100_BASELINE_QPS if mode == "serve" else 2000.0
    assert tline["value"] > 0 and np.isfinite(tline["value"])
    assert tline["vs_baseline"] == round(tline["value"] / base, 3)
    # bench.py divides its unrounded rate: the same ratio within the rounding
    assert abs(jline["vs_baseline"] - jline["value"] / base) <= 5e-4 + 0.005 / base


def test_serving_inputs_bit_equal(runs):
    """The query text (bucketed to S=32) and every pipelined image batch."""
    (_, jcap), (_, tcap) = runs["serve", "jax"], runs["serve", "port"]
    assert len(jcap.texts) == len(tcap.texts) == 1
    np.testing.assert_array_equal(tcap.texts[0], jcap.texts[0])
    assert tcap.texts[0].shape == (32, 32)
    assert len(jcap.inputs) == len(tcap.inputs) == 1
    (jin,), (tin,) = jcap.inputs, tcap.inputs
    assert len(jin) == len(tin) == 2
    for j, t in zip(jin, tin):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == (32, 224, 224, 3)
        np.testing.assert_array_equal(_bits(t), _bits(j))


def test_train_inputs_bit_equal(runs):
    (_, jcap), (_, tcap) = runs["train", "jax"], runs["train", "port"]
    (jb,), (tb,) = jcap.batches, tcap.batches
    for field in ("image_features", "caption_features", "other_tokens"):
        t, j = getattr(tb, field), getattr(jb, field)
        assert t.dtype == {"other_tokens": torch.int32}.get(field, torch.float32)
        np.testing.assert_array_equal(_bits(t), _bits(j))
    assert all(getattr(tb, f) is None and getattr(jb, f) is None
               for f in ("img_idx", "txt_idx", "cap2_idx"))


@pytest.mark.parametrize("form", ["text", "raw", "neighbors", "scan"])
def test_port_train_forms(tiny, capsys, form):
    """The forms bench.py is not run at here: bench.py's metric, method and
    base; the text stream's own templates and the raw captions are bucketed
    to S=16; the neighbours are valid rows of the 64-row DB."""
    extra, metric, method, base = TRAIN_FORMS[form]
    cap = _run_port(tiny, SMALL + ["--train", *extra])
    line = _line(capsys)
    assert set(line) == TRAIN_KEYS
    assert (line["metric"], line["unit"], line["method"]) == (metric, "sample/s", method)
    assert line["value"] > 0 and line["vs_baseline"] == round(line["value"] / base, 3)
    (batch,) = cap.batches
    if form == "raw":
        assert batch.images.dtype == torch.uint8 and tuple(batch.images.shape) == (32, 224, 224, 3)
        assert [t.shape for t in cap.texts] == [(32, 16)]
    elif form == "text":
        assert [t.shape for t in cap.texts] == [(32, 16)]
        table = cap.tables[0]
        assert table.shape == (64, 77) and (table[:, 4:6] == bt.SPLIT_ID).all()
    elif form == "neighbors":
        for f, k in (("img_idx", 16), ("txt_idx", 16), ("cap2_idx", 2)):
            idx = getattr(batch, f)
            assert tuple(idx.shape) == (32, k) and 0 <= int(idx.min()) <= int(idx.max()) < 64


def test_port_latency_line(tiny, capsys):
    _run_port(tiny, SMALL + ["--latency"])
    line = _line(capsys)
    assert set(line) == {"metric", "value", "unit", "method", "curve", "vs_baseline"}
    assert (line["metric"], line["unit"], line["method"], line["vs_baseline"]) == (
        "composed_query_latency_ms_per_batch", "ms/b32",
        "two-program request, sync fetch per batch", None)
    assert set(line["curve"]) == {"1", "32"}
    for point in line["curve"].values():
        assert set(point) == CURVE_KEYS and all(v > 0 for v in point.values())
    assert line["value"] == line["curve"]["32"]["two_prog_chained_ms"]


@pytest.fixture(scope="module")
def graft_ref(tiny, runs):
    """__graft_entry__'s forward on its own f32 weights and a 64-row DB, at
    the headline's first image batch (as f32) and query text; the same
    weights and DB in the port."""
    fn, _ = gj.entry()
    params, heads, db = gj._build(jclip.VIT_L_14, db_rows=64, dtype=jnp.float32)
    _, jcap = runs["serve", "jax"]
    images = np.asarray(jcap.inputs[0][0], np.float32)
    text = jcap.texts[0]
    ref = np.asarray(jax.jit(fn)(params, heads, db.image_db, db.text_db, jnp.asarray(images),
                                 jnp.asarray(text)))
    tdb = KnowledgeDB(*(torch.from_numpy(np.array(a)) for a in (db.image_db, db.text_db)),
                      [str(i) for i in range(64)])
    port = (clip_from_numpy(to_numpy(params), device="cpu"),
            heads_from_numpy(to_numpy(heads), device="cpu"), Retriever(tdb))
    return port, torch.from_numpy(images), torch.from_numpy(text), ref


@pytest.mark.parametrize("chunk", [16, None])
def test_composed_step_matches_graft_entry_f32(graft_ref, chunk):
    """The port's timed step (the encode in chunks, or in one piece, then
    retrieval, fusion and the text tower) against __graft_entry__'s forward
    on the same f32 weights and DB."""
    (params, heads, retriever), images, text, ref = graft_ref
    with torch.no_grad():
        out = bt.composed_step(params, tclip.VIT_L_14, heads, retriever, images, text,
                               chunk).numpy()
    assert out.shape == ref.shape == (32, 64)
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_bench(tiny, monkeypatch, case):
    argv = ["--train", "--db-rows", "64", *REFUSALS[case]]
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    with pytest.raises(SystemExit) as jexc:
        bench.main()
    monkeypatch.setattr(bt.ge, "_build", lambda *a, **kw: pytest.fail("built before refusing"))
    with pytest.raises(SystemExit) as texc:
        bt.run([*argv, "--device", "cpu"])
    assert isinstance(texc.value.code, str) and texc.value.code == jexc.value.code


def _bench_parser(monkeypatch):
    """bench.py's parser, taken when main() parses its arguments."""
    import argparse

    class Got(Exception):
        pass

    def grab(self, *a, **kw):
        raise Got(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(Got) as got:
        bench.main()
    return got.value.args[0]


def test_flags_match_bench(monkeypatch):
    """The option names of ``python bench.py --help`` are the port's less
    --device, with the same defaults, choices and types."""
    def names(script):
        out = subprocess.run([sys.executable, script, "--help"], cwd=REPO, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        return set(re.findall(r"^  (--[\w-]+)", out.stdout, re.M))

    jnames, tnames = names("bench.py"), names("bench_torch.py")
    assert len(jnames) == 16 and tnames == jnames | {"--device"}

    def actions(p):
        return {a.option_strings[0]: (a.dest, a.default, a.choices, a.type, a.nargs, a.const)
                for a in p._actions if a.option_strings[0] != "-h"}

    jp = actions(_bench_parser(monkeypatch))
    tp = actions(bt.parser())
    assert tp.pop("--device") == ("device", None, None, None, None, None)
    assert tp == jp


@pytest.mark.parametrize("argv", [["--quick"], ["--train", "--quick"], ["--latency"]],
                         ids=["serve", "train", "latency"])
def test_refuses_without_cuda(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bt.ge, "_build", lambda *a, **kw: pytest.fail("built without a device"))
    with pytest.raises(RuntimeError, match="CUDA"):
        bt.run(argv)
