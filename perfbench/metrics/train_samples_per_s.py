"""Samples of the optimizer steps that completed on the device inside the
window, over the window's seconds."""


def read(run):
    return run.window.units / run.window.seconds
