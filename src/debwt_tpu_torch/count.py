"""On-device (k+1)-mer (edge) extraction, sorting and counting.

The PyTorch counterpart of the JAX package's count.py. Replaces the
reference's Jellyfish subprocess + text-dump re-parse + bucketed qsort
(src/kmercounting.sh, src/mySort.c) with a single device pass: windowed
2-bit key extraction (kernel 1, through ops.window_keys) and one sort
of the int64 keys.

Keys are one int64 holding the 64 bits of the JAX package's (hi, lo)
uint32 pair. At m = 32 the window fills all 64 bits, so keys are
flipped at the top bit for the signed sort and flipped back: what is
returned is in unsigned order, as the JAX functions return it.
"""

from __future__ import annotations

import numpy as np
import torch

from debwt_tpu_torch import constants as K
from debwt_tpu_torch import ops
from debwt_tpu_torch.pipeline import resolve_device


def extract_and_sort_edges(x2p: torch.Tensor, dist: torch.Tensor, m: int,
                           n_edges: int):
    """Sorted edge keys for all separator-free m-windows.

    x2p: uint8[N + pad] 2-bit codes (separators stored as T).
    dist: int32[N] distance to the next separator at or after p.
    n_edges: count = N - n_reads * m.

    Returns (key, pos): int64 edge keys in unsigned order, with the
    originating text position (int32) carried through; equal keys keep
    ascending positions.
    """
    N = dist.shape[0]
    key = ops.window_keys(x2p[: N + m - 1], m)
    pos = torch.nonzero(dist >= m).squeeze(1)
    assert pos.shape[0] == n_edges, (pos.shape[0], n_edges)
    key_s, order = torch.sort(key[pos] ^ ops.SIGN, stable=True)
    return key_s ^ ops.SIGN, pos[order].to(torch.int32)


def distance_to_separator(sep: torch.Tensor, n_positions: int) -> torch.Tensor:
    """dist[p] = sep[searchsorted(sep, p)] - p for p in [0, N), int32."""
    p = torch.arange(n_positions, dtype=sep.dtype, device=sep.device)
    nxt = torch.searchsorted(sep, p, side="left")
    return (sep[nxt] - p).to(torch.int32)


def count_kmers(coll, m: int = 32, device=None):
    """Jellyfish-equivalent: exact (k+1)-mer counts of a read collection,
    computed on the device (sort + run-length reduction). Returns
    (kmers uint64[:], counts int64[:]) sorted by k-mer value — the
    content of the reference's `bin/kmerInfo` after mySort
    (src/mySort.c:26-201), with no external process or text dump.
    Runs on the CUDA card unless device="cpu" is passed.
    """
    dev = resolve_device(device)
    N = coll.bwt_len
    n = coll.n_reads
    x2p = np.concatenate(
        [coll.x2, np.full(K.TAIL_PAD, K.T, dtype=np.uint8)]
    )
    d_x2p = torch.from_numpy(x2p).to(dev)
    d_sep = torch.from_numpy(coll.sep.astype(np.int64)).to(dev)
    dist = distance_to_separator(d_sep, N)
    key, _pos = extract_and_sort_edges(d_x2p, dist, m, N - n * m)
    kmers, counts = torch.unique_consecutive(key, return_counts=True)
    return kmers.cpu().numpy().view(np.uint64), counts.cpu().numpy()


def read_kmer_dump(path: str, m: int = 32):
    """Ingest an existing Jellyfish text dump (`kmer\\tcount` lines,
    the format the reference's mySort re-parses with fscanf,
    src/mySort.c:54) — interop for users who already ran counting.
    Returns (kmers uint64[:], counts int64[:]) sorted by k-mer value,
    i.e. exactly count_kmers' output format. The 'N'->G quirk of the
    reference's private trans table (src/mySort.c:33) is applied for
    byte-for-byte interop. Sized for convenience-scale dumps (a plain
    per-line parse); the primary path counts on device and never
    materializes a text dump.
    """
    with open(path, "rb") as f:
        raw = f.read()
    if not raw:
        return np.empty(0, np.uint64), np.empty(0, np.int64)
    lut = np.full(256, 255, np.uint8)
    for i, ch in enumerate(b"ACGT"):
        lut[ch] = i
        lut[ch + 32] = i
    lut[ord("N")] = 2   # the mySort 'N'->G quirk
    lut[ord("n")] = 2
    lines = raw.splitlines()
    keys = np.empty(len(lines), np.uint64)
    counts = np.empty(len(lines), np.int64)
    w = 0
    for ln in lines:
        if not ln:
            continue
        kmer, _, cnt = ln.partition(b"\t")
        if not cnt:
            kmer, _, cnt = ln.partition(b" ")
        if len(kmer) != m:
            raise ValueError(
                f"dump k-mer length {len(kmer)} != m={m} (line {w})"
            )
        codes = lut[np.frombuffer(kmer, np.uint8)]
        if (codes == 255).any():
            raise ValueError(f"invalid character in k-mer (line {w})")
        k = np.uint64(0)
        for c in codes:
            k = (k << np.uint64(2)) | np.uint64(c)
        keys[w] = k
        counts[w] = int(cnt)
        w += 1
    order = np.argsort(keys[:w], kind="stable")
    return keys[order], counts[order]
