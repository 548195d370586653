"""Composed queries whose features reached the host in the window, over the
window's host-clock seconds."""


def read(window):
    return sum(r.units for r in window.records) / window.seconds
