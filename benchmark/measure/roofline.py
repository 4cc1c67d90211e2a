"""The yardstick of the kernel metrics: the card's peak, and the bytes
each kernel's work needs for a collection.

Shares are by bytes: both kernels move bytes and do a few integer
operations a byte, which no integer rate of the card binds (chip_smoke's
ALU_OPS_PER_S, the float32 non-tensor rate, is not an integer rate and
is not used).
"""

from __future__ import annotations

# H100 SXM device memory bandwidth (NVIDIA data sheet), at a power limit
# of 700 W
HBM_BYTES_PER_S = 3.35e12


def bound_s(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S


def window_keys_bytes(N: int, w: int) -> float:
    """Kernel 1, one key for each text position: the 2-bit text read
    once ((N + w - 1) / 4 bytes) and N 8-byte keys written once."""
    return (N + w - 1) / 4 + 8 * N


def seg_or_bytes(R: int) -> float:
    """Kernel 2, one scan of R rows: a 4-byte word read and one written
    a row."""
    return 8 * R


def seg_or_rows(N: int, n_reads: int, m: int) -> int:
    """The rows a fused build's scans need: one a text position and the
    special rows, m - 1 a read. The engine scans more (it pads to a
    bucketed row count); the padding is its own cost, not the input's."""
    return N + n_reads * (m - 1)
