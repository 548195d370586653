"""LR schedule: cosine decay with linear warmup (counterpart of
``keds_tpu/train/schedule.py``, the reference's open_clip scheduler):

    step < warmup:  lr = base * (step + 1) / warmup
    else:           lr = 0.5 * base * (1 + cos(pi * e / es))
"""

from __future__ import annotations

import math
from typing import Callable


def cosine_lr(base_lr: float, warmup: int, total_steps: int) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        if step < warmup:
            return base_lr * (step + 1.0) / max(warmup, 1)
        e = step - warmup
        es = max(total_steps - warmup, 1)
        return 0.5 * (1.0 + math.cos(math.pi * e / es)) * base_lr

    return schedule
