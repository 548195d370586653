"""The port's artifact gate (python -m keds_tpu_torch.tools.validate_artifacts)
against keds_tpu's on tests/test_validate_artifacts.py's CIRR fixture, f32
on the CPU with the synthetic BPE vocab: the same report table within
1e-4, the --expected gate passing and failing as JAX's does, an hf: spec
exiting 2 without a download, a missing local path refused."""

import json

import numpy as np
import pytest
import torch

pytest.importorskip("PIL")

from keds_tpu import tokenizer as jtok  # noqa: E402
from keds_tpu.tools.validate_artifacts import main as jvalidate  # noqa: E402

from keds_tpu_torch.tools.validate_artifacts import _print_table, main as tvalidate  # noqa: E402
from torch_port_helpers import write_artifact_fixture, write_synthetic_vocab  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-4


@pytest.fixture
def artifacts(tmp_path, monkeypatch):
    monkeypatch.setenv("KEDS_TPU_BPE_VOCAB", write_synthetic_vocab(tmp_path / "v.txt.gz"))
    jtok.get_tokenizer.cache_clear()
    jtok.star_token_id.cache_clear()
    yield write_artifact_fixture(tmp_path)
    jtok.get_tokenizer.cache_clear()
    jtok.star_token_id.cache_clear()


def _argv(art, out, *extra):
    img, txt, db, root = art
    return ["--image-stream", img, "--text-stream", txt, "--db", db, "--data-root", root,
            "--eval-mode", "cirr", "--batch-size", "4", "--db-topk", "4",
            "--precision", "fp32", "--out", str(out), *extra]


def _assert_tables_close(got: dict, want: dict):
    assert set(got) == set(want)
    for row, metrics in want.items():
        assert set(got[row]) == set(metrics), row
        for name, v in metrics.items():
            np.testing.assert_allclose(got[row][name], v, rtol=0, atol=TOL, err_msg=row + name)


def test_validate_artifacts_cirr_equals_jax(artifacts, tmp_path, capsys):
    tvalidate(_argv(artifacts, tmp_path / "port.json", "--device", "cpu"))
    jvalidate(_argv(artifacts, tmp_path / "jax.json", "--num-partitions", "1"))
    got, want = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("port", "jax"))
    assert "recall_R@1" in capsys.readouterr().out
    assert set(got["table"]) == {"composed", "image", "mixture"}
    _assert_tables_close(got["table"], want["table"])
    for key in ("eval_mode", "precision", "quant_towers", "retrieval", "parity_ok"):
        assert got[key] == want[key], key
    assert got["parity_ok"] is None


def test_validate_artifacts_expected_gate_as_jax(artifacts, tmp_path):
    tvalidate(_argv(artifacts, tmp_path / "base.json", "--device", "cpu"))
    table = json.loads((tmp_path / "base.json").read_text())["table"]
    exp = tmp_path / "expected.json"
    exp.write_text(json.dumps({"cirr": {"mixture": {
        "recall_R@1": table["mixture"]["recall_R@1"]}}}))
    tvalidate(_argv(artifacts, tmp_path / "gate.json", "--device", "cpu", "--expected", str(exp)))
    assert json.loads((tmp_path / "gate.json").read_text())["parity_ok"] is True
    exp.write_text(json.dumps({"cirr": {"mixture": {"recall_R@1": 200.0}}}))
    for tool, extra in ((tvalidate, ["--device", "cpu"]), (jvalidate, ["--num-partitions", "1"])):
        with pytest.raises(SystemExit) as e:
            tool(_argv(artifacts, tmp_path / "miss.json", "--expected", str(exp), *extra))
        assert e.value.code == 1


def test_validate_artifacts_quant_modes_run_the_gate(artifacts, tmp_path):
    """--quant-towers int8 --retrieval int8 through the same gate."""
    exp = tmp_path / "expected.json"
    exp.write_text(json.dumps({"cirr": {"mixture": {"recall_R@50": 0.0}}}))
    tvalidate(_argv(artifacts, tmp_path / "q.json", "--device", "cpu", "--quant-towers",
                    "int8", "--retrieval", "int8", "--expected", str(exp)))
    rep = json.loads((tmp_path / "q.json").read_text())
    assert (rep["quant_towers"], rep["retrieval"], rep["parity_ok"]) == ("int8", "int8", True)
    assert set(rep["table"]) == {"composed", "image", "mixture"}


def test_validate_artifacts_hf_spec_exits_2(tmp_path, caplog):
    with pytest.raises(SystemExit) as e:
        tvalidate(["--image-stream", "hf:x.pt", "--text-stream", "hf:y.pt",
                   "--db", str(tmp_path), "--data-root", str(tmp_path)])
    assert e.value.code == 2
    assert "LionheartzzZ/KEDs" in caplog.text and "local path" in caplog.text


def test_validate_artifacts_missing_local_path(tmp_path):
    with pytest.raises(SystemExit, match="artifact not found"):
        tvalidate(["--image-stream", str(tmp_path / "nope.pt"),
                   "--text-stream", str(tmp_path / "nope2.pt"),
                   "--db", str(tmp_path), "--data-root", str(tmp_path)])


def test_print_table_fails_on_unmatched_expected(capsys):
    table = {"mixture": {"recall_R@1": 30.0}}
    assert _print_table("t", table, {"mixture": {"recall_R@1": 29.9}}, tol=0.5)
    assert not _print_table("t", table, {"mixure": {"recall_R@1": 29.9}}, tol=0.5)
    assert not _print_table("t", table, {"mixture": {"recall_R@7": 1.0}}, tol=0.5)
    assert "EXPECTED ENTRY NOT MEASURED" in capsys.readouterr().out
