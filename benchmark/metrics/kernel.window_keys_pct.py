"""Percent of its bound that kernel 1 (kernels/window_keys.py,
csrc/window_keys.cu) reaches: the bytes one key for each text position
needs, (N + w - 1)/4 + 8N with w = m, at the card's bandwidth, over the
device time of the kernels named below. A tier that computes the keys
more than once a build (the grouped tier: once per group) reads lower."""

from benchmark.measure.roofline import window_keys_bytes
from benchmark.measure.readers import share_of_bound

KERNELS = ("window_keys_kernel",)


def read(w):
    return share_of_bound(w, KERNELS, window_keys_bytes(w.N, w.m))
