"""The benchmark of keds_tpu_torch on the card: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line on stdout (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with its limit); everything else goes to
stderr.  Exits 2 without enough CUDA devices and 3 when a forbidden module
(jax, jaxlib, flax, keds_tpu) was loaded.  See ``harness/core.py``.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
