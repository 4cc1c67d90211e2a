"""Seconds from the start of the process to the start of the window:
the interpreter, imports, the collection, the kernels' build where it
is not cached, and the warm-up build."""


def read(w):
    return w.setup_s
