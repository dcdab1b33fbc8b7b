"""Seconds from the process start to the window's start: imports, the
libraries, the panel, the warm-up item and, in the resolve cell, the index."""


def read(run):
    return run.setup_s
