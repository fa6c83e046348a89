"""Detections posed (and scored, in an eval cell) whose results reached the
host inside the window, over the window's seconds."""


def read(run):
    return run.window.units / run.window.seconds
