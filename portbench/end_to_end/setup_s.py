"""Seconds from process start to the window's start: imports, inputs and
graph build, weights, warm-up (and, in a checkout's first run, the kernels'
build)."""


def read(w):
    return w["setup_s"]
