"""What the benchmark imports, how it finds a cell's pieces, the shape of
BENCHMARK.json, and that it refuses to run without a card."""

import ast
import json
import pathlib
import re
import subprocess
import sys

import pytest

from benchmark.harness import core

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "keds_tpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    # whole top-level names: keds_tpu_torch is not keds_tpu
    assert not top_level_imports(path) & FORBIDDEN


def test_the_reference_imports_torch_and_the_standard_library_only():
    names = top_level_imports(BENCH / "harness" / "reference.py")
    assert names <= {"__future__", "contextlib", "math", "typing", "torch"}
    assert not names & {"keds_tpu_torch", "chip_smoke", "bench_torch", "graft_entry_torch",
                        "benchmark", "numpy"}


def test_loading_every_piece_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.harness import core\n"
            "b = core.spec()\n"
            "for w in b['workloads']:\n"
            "    core.driver(core.traffic(w['traffic']))\n"
            "    for t in (0, 1):\n"
            "        [core.reader(m['name']) for m in core.cell_metrics(b, w['name'], t) if m['name'] != 'setup_s']\n"
            "import keds_tpu_torch.engine, keds_tpu_torch.train.trainer\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))" % (str(ROOT), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    assert out.strip() == "[]"


SPEC = core.spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_finds_its_pieces_by_name(cell):
    w = core.find_cell(SPEC, cell)
    cfg = core.config(w["config"])
    mix = core.traffic(w["traffic"])
    drv = core.driver(mix)
    for hook in ("make_inputs", "setup", "call", "shapes", "release", "check"):
        assert callable(getattr(drv, hook))
    assert core.limits(cell)
    assert cfg["name"] == w["config"]
    e2e = core.cell_metrics(SPEC, cell, False)
    per = core.cell_metrics(SPEC, cell, True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per
    for m in e2e + per:
        if m["name"] != "setup_s":
            assert callable(core.reader(m["name"]).read)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_to_its_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(SPEC["command"]) <= 32 and all(map(one_line, SPEC["command"]))
    assert 1 <= len(SPEC["configs"]) <= 24 and 1 <= len(SPEC["workloads"]) <= 24
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["why"]) and one_line(c["source"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == json.loads((ROOT / c["file"]).read_text())["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["name"] in {w["config"] for w in SPEC["workloads"]}
    assert len({c["file"] for c in SPEC["configs"]}) == len(SPEC["configs"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and one_line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(CELLS)
    assert 1 <= len(SPEC["end_to_end"]) <= 16 and 1 <= len(SPEC["per_layer"]) <= 128
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) - {"workloads"} == (
            {"name", "unit", "better", "bound", "source"} if m["name"] in e2e
            else {"name", "unit", "better", "source", "layer", "moves"})
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert one_line(m["layer"]) and m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        reporting = [w for w in CELLS if w in next(
            e for e in SPEC["end_to_end"] if e["name"] == m["moves"]).get("workloads", CELLS)]
        assert set(m["workloads"]) <= set(reporting)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_a_run_without_a_card_exits_non_zero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", CELLS[0],
                        "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert p.returncode != 0 and p.stdout == ""
