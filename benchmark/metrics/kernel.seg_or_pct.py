"""Percent of its bound that kernel 2 (kernels/seg_or.py, csrc/seg_or.cu)
reaches on the fused engine: four scans a build, each of the rows the
input needs (measure/roofline.seg_or_rows: N + n_reads (m - 1)) at 8
bytes a row, at the card's bandwidth, over the device time of the
kernels named below."""

from benchmark.measure.roofline import seg_or_bytes, seg_or_rows
from benchmark.measure.readers import share_of_bound

KERNELS = ("seg_or_scan",)
SCANS = 4


def read(w):
    return share_of_bound(w, KERNELS, SCANS * seg_or_bytes(seg_or_rows(w.N, w.n_reads, w.m)))
