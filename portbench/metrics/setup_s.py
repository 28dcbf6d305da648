"""Seconds from the start of the process's Python code to the window:
imports, CUDA start-up, the build of the port's kernels (a cached build
after a checkout's first run), the frames, the weights, the warm-up
session."""


def read(run):
    return run.setup_s
