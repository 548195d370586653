"""keds_tpu_torch stands alone: no jax, no keds_tpu (nor the tokenizer's
regex and ftfy), no PIL at import time (the image datasets open it when
they read an image), CUDA unless asked."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "keds_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py"))


def test_import_loads_no_jax_and_no_keds_tpu():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'keds_tpu' or m.startswith('keds_tpu.')"
        " or m.split('.')[0] in ('triton', 'regex', 'ftfy', 'PIL')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(MODULES) >= 38
    # every subpackage is walked, the training and evaluation slices' included
    assert {m.split(".")[1] for m in MODULES if m.count(".") >= 2} >= {
        "models", "ops", "retrieval", "train", "io", "data", "cli", "evalkit", "parallel"}
    assert {"keds_tpu_torch.train.trainer", "keds_tpu_torch.io.checkpoint",
            "keds_tpu_torch.data.loader", "keds_tpu_torch.cli.main",
            "keds_tpu_torch.config", "keds_tpu_torch.tokenizer",
            "keds_tpu_torch.tools.precompute_neighbors",
            "keds_tpu_torch.evalkit.metrics", "keds_tpu_torch.evalkit.evaluators",
            "keds_tpu_torch.cli.eval_retrieval", "keds_tpu_torch.models.loader",
            "keds_tpu_torch.data.datasets", "keds_tpu_torch.transforms",
            "keds_tpu_torch.cli.serve", "keds_tpu_torch.cli.demo",
            "keds_tpu_torch.cli.common", "keds_tpu_torch.logging_utils",
            "keds_tpu_torch.data.tarstream", "keds_tpu_torch.parallel.mesh",
            "keds_tpu_torch.ops.quant", "keds_tpu_torch.retrieval.synth",
            "keds_tpu_torch.tools.build_database",
            "keds_tpu_torch.tools.quant_accuracy", "keds_tpu_torch.profiling",
            "keds_tpu_torch.tools.extract_features", "keds_tpu_torch.tools.validate_artifacts",
            "keds_tpu_torch.tools.extract_nouns",
            "keds_tpu_torch.tools.prep_imagenet_val"} <= set(MODULES)


@pytest.mark.parametrize("path", [*sorted(PORT.rglob("*.py")), REPO / "chip_smoke.py",
                                  REPO / "kernel_sweeps.py",
                                  REPO / "tests" / "torch_dist_worker.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_sources_import_neither_jax_nor_keds_tpu(path):
    src = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", src, re.M)
    assert not re.search(r"^\s*(import|from)\s+keds_tpu(\.|\s|$)", src, re.M)
    assert not re.search(r"^\s*(import|from)\s+(regex|ftfy)\b", src, re.M)
    # PIL only inside functions (indented), never at module level
    assert not re.search(r"^(import|from)\s+PIL\b", src, re.M)


def test_entry_points_default_to_cuda(monkeypatch):
    from keds_tpu_torch import synth
    from keds_tpu_torch.models.clip import ClipConfig
    from keds_tpu_torch.retrieval.database import KnowledgeDB

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ClipConfig(embed_dim=32, image_resolution=32, vision_layers=1,
                     vision_width=64, vision_patch_size=16, transformer_width=64,
                     transformer_heads=1, transformer_layers=1, vocab_size=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        synth.build(cfg, db_rows=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        KnowledgeDB.from_arrays(torch.ones(4, 32).numpy(), torch.ones(4, 32).numpy())
    params, heads, db = synth.build(cfg, db_rows=8, dtype=torch.float32, device="cpu")
    assert db.image_db.device.type == "cpu" and db.size == 8


@pytest.mark.parametrize("cli", ["serve", "demo", "main"])
def test_command_lines_default_to_cuda(monkeypatch, tmp_path, cli):
    """Without --device the serve, demo and train CLIs want the CUDA device
    and raise on a host without one."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "feats").mkdir()
    args = {"serve": ["--resume", "ckpt.pt", "--target-data", "corpus",
                      "--query_file", "q.jsonl"],
            "demo": ["--resume", "ckpt.pt", "--retrieval-data", "coco"],
            "main": ["--train-data", "feats", "--database-path", "db"]}[cli]
    main = importlib.import_module(f"keds_tpu_torch.cli.{cli}").main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(args + ["--logs", str(tmp_path / "logs"), "--name", cli])


@pytest.mark.parametrize("arg", [None, "cuda", torch.device("cuda")])
def test_resolved_cuda_device_carries_its_index(monkeypatch, arg):
    """An engine compares its device with tensor.device, which is always
    indexed ("cuda:0"), so the resolved device must be indexed too."""
    from keds_tpu_torch.runtime import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device(arg) == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
