"""Reference-format output: `<obj>` packed BWT + `.#`/`.$` sidecars.

Byte-for-byte the reference's on-disk layout (src/insertCase3.c:115-131):
  <obj>    little-endian u64 words, 32 bases/word, first base in bits
           63:62, zero-padded to a whole word; separators as 'T'
  <obj>.#  (n_reads - 1) little-endian u64 BWT positions of '#'
  <obj>.$  one little-endian u64 BWT position of '$'
"""

from __future__ import annotations

import numpy as np

from debwt_tpu_torch.golden import pack_2bit_u64, unpack_2bit_u64


def write_bwt(result, obj_path: str) -> None:
    with open(obj_path, "wb") as f:
        f.write(result.packed())
    with open(obj_path + ".#", "wb") as f:
        f.write(np.asarray(result.sharp_pos, dtype="<u8").tobytes())
    with open(obj_path + ".$", "wb") as f:
        f.write(np.uint64(result.dollar_pos).astype("<u8").tobytes())


def read_bwt(obj_path: str, bwt_len: int):
    """Returns (bwt6 uint8[bwt_len], sharp_pos, dollar_pos) — the
    6-letter BWT reconstructed from the packed file + sidecars."""
    raw = open(obj_path, "rb").read()
    bwt2 = unpack_2bit_u64(raw, bwt_len)
    sharp = np.frombuffer(open(obj_path + ".#", "rb").read(), dtype="<u8")
    dollar = int(
        np.frombuffer(open(obj_path + ".$", "rb").read(), dtype="<u8")[0]
    )
    bwt6 = bwt2.astype(np.uint8).copy()
    bwt6[sharp.astype(np.int64)] = 4
    bwt6[dollar] = 5
    return bwt6, sharp.astype(np.int64), dollar
