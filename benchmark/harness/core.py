"""One run of one cell: find its pieces by name, set up, measure, check, and
print the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the mix names its driver
(``drivers/<driver>.py``), the general code that sets up the program for
such traffic, runs one call of it and checks what the calls produced.
Each metric is read by ``metrics/<name>.py``, or where there is none by
``metrics/<name up to its first dot>.py``; a cell's limits are in
``limits/<cell>.json``.  Adding any of these is adding files.

The run: set-up (kernels built or loaded, weights and tables made on the
device from the seed, the program built from them, every shape of the
traffic warmed), then the window (``--trace 0``: a closed loop for
``--seconds``; ``--trace 1``: the mix's ``trace_calls`` calls under the
profiler), then the program freed and the plain reference run over a
sample of what the window produced.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import pathlib
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "keds_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def process_start() -> float:
    """The process's start on the ``time.time()`` clock (Linux), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path):
    """A piece of the benchmark loaded from its file, once a process."""
    name = "benchmark_" + path.parent.name + "_" + path.stem.replace(".", "_")
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod               # dataclasses look their module up
        spec.loader.exec_module(mod)
    return sys.modules[name]


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def driver(mix: dict):
    return load_module(BENCH / "drivers" / f"{mix['driver']}.py")


def reader(metric: str):
    """The reader of ``metric``: its own file, else its family's."""
    for stem in (metric, metric.split(".")[0]):
        path = BENCH / "metrics" / f"{stem}.py"
        if path.is_file():
            return load_module(path)
    raise SystemExit(f"no reader for metric {metric!r} in benchmark/metrics/")


def limits(cell: str) -> dict:
    return load_json(BENCH / "limits" / f"{cell}.json")["limits"]


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones (those that list the cell, or that
    list no cells and move an end-to-end metric the cell reports)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


@dataclasses.dataclass
class Record:
    """One call of the closed loop: what it counted, when, what it made."""

    units: int
    t0: float = 0.0
    t1: float = 0.0
    out: Any = None


@dataclasses.dataclass
class Window:
    """What a reader of the window takes: its records and times, the cell's
    configuration and mix, and in a traced run the timeline, the traced
    steps' shapes as the driver sent them (``steps``: one dict a batch,
    request or training step, see ``drivers/``) and the program's spans."""

    records: List[Record]
    t_start: float
    t_end: float
    config: dict = dataclasses.field(default_factory=dict)
    mix: dict = dataclasses.field(default_factory=dict)
    timeline: Any = None
    steps: List[dict] = dataclasses.field(default_factory=list)
    marks: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Context:
    """What a driver is given: the run's arguments and the cell's pieces."""

    cell: str
    seed: int
    device: Any
    config: dict
    mix: dict
    limits: dict
    fault: Optional[str] = None     # a planted fault (the harness's own tests)
    control: Optional[str] = None   # a lower-precision path of the program (the limits
                                    # file names the cell's)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(call: Callable[[int], Record], seconds: float, device) -> Window:
    """Calls back to back until ``seconds`` have passed; the window ends
    when the last call has delivered."""
    records: List[Record] = []
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        rec = call(len(records))
        rec.t0, rec.t1 = t0, time.perf_counter()
        records.append(rec)
        if rec.t1 - t_start >= seconds:
            break
    sync(device)
    return Window(records, t_start, time.perf_counter())


def traced(drv, state, ctx: Context) -> Window:
    from benchmark.harness import tracing

    n = int(ctx.mix["trace_calls"])
    records: List[Record] = []

    def body():
        for i in range(n):
            t0 = time.perf_counter()
            rec = drv.call(state, i, traced=True)
            rec.t0, rec.t1 = t0, time.perf_counter()
            records.append(rec)

    _, tl = tracing.capture(body, ctx.device)
    return Window(records, records[0].t0, records[-1].t1, ctx.config, ctx.mix, tl,
                  drv.shapes(state, records),
                  drv.spans(state) if hasattr(drv, "spans") else {})


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(device, trace_window: Optional[Window]) -> dict:
    import torch

    if device.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    if trace_window is not None:
        info["busy_s"] = trace_window.timeline.busy_s
        info["window_s"] = trace_window.timeline.window_s
    return info


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device, t_process: float,
             *, bench: Optional[dict] = None, config_override: Optional[dict] = None,
             mix_override: Optional[dict] = None, fault: Optional[str] = None,
             control: Optional[str] = None) -> Tuple[dict, List[Check]]:
    """One run of ``cell``; returns (the result line's object, the checks)."""
    import torch

    bench = bench or spec()
    entry = find_cell(bench, cell)
    cfg = config_override or config(entry["config"])
    mix = mix_override or traffic(entry["traffic"])
    ctx = Context(cell, seed, device, cfg, mix, limits(cell), fault, control)
    drv = driver(mix)
    build_s = 0.0
    if device.type == "cuda":
        from keds_tpu_torch.ops import attention, topk
        from keds_tpu_torch.ops.cuda_build import build_all

        t = time.perf_counter()
        build_all([attention.KERNEL, attention.BWD_KERNEL, topk.KERNEL])
        build_s = time.perf_counter() - t
        log(f"bench: kernels built or loaded in {build_s:.2f} s (part of setup_s)")
    inputs = drv.make_inputs(ctx)
    state = drv.setup(ctx, inputs)
    sync(device)
    setup_s = time.time() - t_process
    log(f"bench: {cell} seed {seed} set up in {setup_s:.2f} s")
    if trace:
        window = traced(drv, state, ctx)
    else:
        window = closed_loop(lambda i: drv.call(state, i), seconds, device)
        window.config, window.mix = cfg, mix
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        value = setup_s if m["name"] == "setup_s" else reader(m["name"]).read(window)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    info = device_info(device, window if trace else None)
    attempted = sum(r.units for r in window.records)
    drv.release(state)
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = drv.check(ctx, inputs, window.records)
    log(f"bench: reference check in {time.perf_counter() - t:.2f} s")
    result = {"correct": all(c.ok for c in checks), "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": info}
    if trace:
        result["breakdown"] = window.timeline.breakdown()
    result["build_s"] = build_s          # the kernels' build or load, inside setup_s
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result, checks


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    t_process = process_start()
    p = argparse.ArgumentParser(description="One run of one benchmark cell on the card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = spec()
    entry = find_cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        log(f"bench: the cell needs {entry['chips']} CUDA device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device, t_process, bench=bench)
    found = forbidden_modules()
    if found:
        log(f"bench: the run loaded {', '.join(found)}, which the port must not use")
        return 3
    for c in checks:
        log(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0
