"""Reference-format output: `<obj>` packed BWT + `.#`/`.$` sidecars.

Byte-for-byte the reference's on-disk layout (src/insertCase3.c:115-131):
  <obj>    little-endian u64 words, 32 bases/word, first base in bits
           63:62, zero-padded to a whole word; separators as 'T'
  <obj>.#  (n_reads - 1) little-endian u64 BWT positions of '#'
  <obj>.$  one little-endian u64 BWT position of '$'
"""

from __future__ import annotations

import numpy as np

from debwt_tpu_torch.golden import unpack_2bit_u64


def write_bwt(result, obj_path: str) -> None:
    with open(obj_path, "wb") as f:
        f.write(result.packed())
    with open(obj_path + ".#", "wb") as f:
        f.write(np.asarray(result.sharp_pos, dtype="<u8").tobytes())
    with open(obj_path + ".$", "wb") as f:
        f.write(np.uint64(result.dollar_pos).astype("<u8").tobytes())


def read_sidecars(obj_path: str):
    """(sharp_pos int64, dollar_pos) from `<obj>.#` and `<obj>.$`."""
    sharp = np.fromfile(obj_path + ".#", dtype="<u8").astype(np.int64)
    dollar = int(np.fromfile(obj_path + ".$", dtype="<u8")[0])
    return sharp, dollar


def read_bwt(obj_path: str, bwt_len: int):
    """Returns (bwt6 uint8[bwt_len], sharp_pos, dollar_pos) — the
    6-letter BWT reconstructed from the packed file + sidecars."""
    with open(obj_path, "rb") as f:
        bwt6 = unpack_2bit_u64(f.read(), bwt_len)
    sharp, dollar = read_sidecars(obj_path)
    bwt6[sharp] = 4
    bwt6[dollar] = 5
    return bwt6, sharp, dollar
