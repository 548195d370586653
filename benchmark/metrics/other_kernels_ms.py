"""Device ms per step of everything on the device that no other reader in
this folder names by its ``PATTERN`` (the GEMMs, B1, B2, B2′ and whatever
a later reader names): elementwise kernels, norms, casts, gathers, copies
and memsets."""

import pathlib

from benchmark.harness.core import load_module


def patterns():
    here = pathlib.Path(__file__)
    mods = (load_module(p) for p in sorted(here.parent.glob("*.py")) if p != here)
    return tuple(m.PATTERN for m in mods if hasattr(m, "PATTERN"))


def read(window):
    if window.timeline is None or not window.steps:
        return None
    return window.timeline.seconds(None, patterns()) * 1e3 / len(window.steps)
