"""Seconds from process start to the start of the timed call: imports, the
card's context, the kernel library's build (first run in a checkout) and
load, and the warm-up calls."""


def read(run):
    return run.setup_s
