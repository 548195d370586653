"""Readings that set a cell's limits: the compared numbers of sound runs of
the program, of its control (a lower-precision path: ``--control int8``,
the W8A8 towers; ``bf16``, the trained heads one precision down) and of a
fault planted underneath (``--fault``) over many seeds, in one process,
each run as ``run.py`` makes it at the cell's own size with a short
window.  The benchmark's own runs never run a control or a fault.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 \
        [--control int8|bf16] [--fault half] [--seconds 3] [--out cal.jsonl]

Prints one JSON line a run: the seed, the control, each compared number.
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark.harness import core  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--control", default=None, choices=(None, "int8", "bf16"))
    p.add_argument("--fault", default=None)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        core.log("calibrate: needs a CUDA device")
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        result, checks = core.run_cell(args.workload, seed, args.seconds, False, device,
                                       time.time(), control=args.control, fault=args.fault)
        line = json.dumps({"cell": args.workload, "seed": seed, "control": args.control,
                           "fault": args.fault,
                           "checks": {c.name: c.value for c in checks},
                           "metrics": {k: v["value"] for k, v in result["metrics"].items()}})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
