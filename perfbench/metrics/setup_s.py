"""Seconds from the start of the process to the first timed request or
step: imports, the card's start, kernel builds and loads, weights and
input pools, warm-up and the checked first steps."""


def read(run):
    return run.setup_s
