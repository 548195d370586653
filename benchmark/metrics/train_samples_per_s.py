"""Training samples of the steps completed in the window, over the window's
host-clock seconds (the window ends once the device has finished them)."""


def read(window):
    return sum(r.units for r in window.records) / window.seconds
