"""FASTA/FASTQ ingest with N-policy (a copy of the JAX package's
io/fasta.py).

The reference parses with the vendored kseq.h (src/kseq.h) and demands
N-free input (README "shouldn't contain any uncertain char"), shipping
a separate prep tool that substitutes IUPAC ambiguity codes with random
compatible bases (otherTool/transferN.c). Here both live behind one
reader:

  NPolicy.REJECT — error on any non-ACGT char (reference default)
  NPolicy.RANDOM — transferN-equivalent seeded substitution
                   (otherTool/transferN.c:8-11 randTable)
  NPolicy.TO_G   — map N to G, reproducing the quirk in mySort's
                   private trans table (src/mySort.c:33); other IUPAC
                   codes are still rejected

FASTA goes through the native parser (io/native.py,
csrc/fasta_parser.cpp): read_fasta's whole-file parse under reject and
to-g, and read_collection's streaming scan under every policy (random
draws its bases here, in NumPy). FASTQ, read_reads and the random
policy of read_fasta are vectorized NumPy over the raw bytes (no
per-line Python loop); so are the plain versions the tests hold the
native paths against.

A record whose header holds no name is called read<record index> on
every path. The JAX package's native path numbers such a record by its
line instead, and both its paths raise IndexError on a header of
blanks only.
"""

from __future__ import annotations

import enum
import gzip
import mmap
import os
from typing import List, Tuple

import numpy as np

from debwt_tpu_torch import constants as K
from debwt_tpu_torch import tracing

# IUPAC ambiguity codes -> compatible base sets (transferN randTable)
IUPAC = {
    "R": "AG", "Y": "CT", "S": "GC", "W": "AT", "K": "GT", "M": "AC",
    "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG", "N": "ACGT",
}


class NPolicy(enum.Enum):
    REJECT = "reject"
    RANDOM = "random"
    TO_G = "to-g"


_CODE = np.full(256, 255, dtype=np.uint8)
for i, cs in enumerate("ACGT"):
    _CODE[ord(cs)] = i
    _CODE[ord(cs.lower())] = i


def _read_raw(path: str) -> bytes:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def read_fasta(
    path: str,
    n_policy: NPolicy | str = NPolicy.REJECT,
    seed: int = 0,
) -> Tuple[List[np.ndarray], List[str]]:
    """Parse FASTA/FASTQ (optionally .gz) into per-read uint8 code
    arrays (0..3) plus names, from the whole file at once. FASTA goes
    through the native parser (io.native.parse_fasta; the random policy
    runs in NumPy there), FASTQ through NumPy. read_collection streams
    instead, for inputs too large to hold twice."""
    if isinstance(n_policy, str):
        n_policy = NPolicy(n_policy)
    raw = _read_raw(path)
    if not raw:
        raise ValueError(f"empty input: {path}")
    if raw[:1] == b"@":
        return _parse_fastq(raw, n_policy, seed)
    if raw[:1] != b">":
        raise ValueError(f"{path}: not FASTA/FASTQ (starts with {raw[:1]!r})")
    from debwt_tpu_torch.io import native

    return native.parse_fasta(raw, n_policy.value, seed)


def read_collection(
    path: str,
    n_policy: NPolicy | str = NPolicy.REJECT,
    seed: int = 0,
    chunk_bytes: int = 1 << 26,
):
    """Stream a FASTA/FASTQ file (optionally .gz) straight into a
    SequenceCollection, with no per-read Python objects: peak memory is
    the collection's x2 plus one chunk, not 2x the raw file.

    FASTA takes one native pass (io.native.FastaScan): each chunk of
    `chunk_bytes` is read into one reused buffer, behind the carry (the
    partial line the last chunk ended in), and its whole lines are
    written as codes and separators straight into x2, preallocated at
    the file's size + 1 (grown as it fills for .gz). Under the random
    policy the IUPAC bytes of the r-th region are drawn here with seed +
    r, in _encode's order, so every path gives the same bytes. FASTQ
    goes through the NumPy parser, _stream_reads, and from_concat
    (_read_collection_numpy, also the plain version of the FASTA pass).
    The counters ingest_native_bytes and ingest_numpy_bytes count the
    raw bytes each path read.

    The reference's analogue is kseq.h's buffered streaming
    (src/kseq.h:36-90) feeding collect's two-pass packer
    (src/collect#$.c:37-90); here one pass suffices because x2 is
    sized from the file before the first byte is encoded.

    Spans a chunk: ingest.read (the carry moved to the buffer's front,
    readinto), ingest.parse (the cut after the last newline),
    ingest.encode (the native scan and the random draws); once:
    ingest.join (the last record closed, the trim and the read-length
    check).
    """
    from debwt_tpu_torch.io.native import FastaScan
    from debwt_tpu_torch.types import SequenceCollection

    if isinstance(n_policy, str):
        n_policy = NPolicy(n_policy)
    gz = str(path).endswith(".gz")
    opener = gzip.open if gz else open
    # codes plus separators never outnumber the file's bytes (+ 1 for a
    # last line with no newline); for .gz a guess, grown as it fills
    cap = os.path.getsize(path) * (4 if gz else 1) + 1
    scan = None
    region_i = 0
    # anonymous memory: a page is touched only when a read fills it
    buf = mmap.mmap(-1, chunk_bytes)
    carry = cut = n = 0
    with opener(path, "rb") as f:
        while True:
            with tracing.span("ingest.read"):
                carry = n - cut
                if carry + chunk_bytes > len(buf):   # a line longer than a chunk
                    grown = mmap.mmap(-1, carry + chunk_bytes)
                    grown[:carry] = buf[cut:n]
                    buf = grown
                else:
                    buf[:carry] = buf[cut:n]
                got = _read_into(f, memoryview(buf)[carry : carry + chunk_bytes])
                n = carry + got
            if scan is None:
                if got == 0:
                    raise ValueError(f"empty input: {path}")
                if buf[:1] == b"@":
                    break
                if buf[:1] != b">":
                    raise ValueError(
                        f"{path}: not FASTA/FASTQ (starts with "
                        f"{buf[:1]!r})"
                    )
                scan = FastaScan(n_policy.value, cap)
            tracing.count("ingest_native_bytes", got)
            with tracing.span("ingest.parse"):
                if got == 0 and carry:   # a last line with no newline
                    buf[n] = ord("\n")
                    n += 1
                cut = buf.rfind(b"\n", 0, n) + 1
            if cut:
                with tracing.span("ingest.encode"):
                    start = scan.cursor
                    if scan.scan(np.frombuffer(buf, np.uint8, cut)):
                        _draw_iupac(scan.x2[start : scan.cursor],
                                    seed + region_i)
                region_i += 1
            if got == 0:
                break
    if scan is None:
        return _read_collection_numpy(path, n_policy, seed, chunk_bytes)
    with tracing.span("ingest.join"):
        scan.scan(np.zeros(0, np.uint8), last=True)
        x2, sep = scan.x2[: scan.cursor], scan.sep[: scan.n_sep]
        shortest = int((np.diff(sep, prepend=-1) - 1).min())
        if shortest < K.MIN_READ_LEN:
            raise ValueError(
                f"read length {shortest} <= 32; the reference "
                "enforces length > 32 (src/collect#$.c:41-45)"
            )
        return SequenceCollection(x2=x2, sep=sep)


def _read_into(f, view: memoryview) -> int:
    """Bytes read into `view`: all of it, unless the file ends first."""
    got = 0
    while got < len(view):
        k = f.readinto(view[got:])
        if not k:
            break
        got += k
    return got


def _draw_iupac(seg: np.ndarray, seed: int) -> None:
    """Replaces the IUPAC letters the native scan left in one region's
    codes by bases drawn as _encode draws them: a generator seeded with
    `seed`, the codes in IUPAC's order, positions ascending in each."""
    rng = np.random.default_rng(seed)
    at = np.flatnonzero(seg > 3)
    letters = seg[at]
    for code_char, bases in IUPAC.items():
        mask = at[letters == ord(code_char)]
        if mask.size:
            pool = np.frombuffer(bases.encode(), dtype=np.uint8)
            seg[mask] = _CODE[pool[rng.integers(0, len(bases), size=mask.size)]]


def _read_collection_numpy(path, n_policy, seed, chunk_bytes):
    """read_collection in NumPy: _stream_reads, then from_concat. The
    path of FASTQ input, and the plain version of the native pass."""
    from debwt_tpu_torch.types import SequenceCollection

    codes, lengths, _ = _stream_reads(path, n_policy, seed, chunk_bytes, False)
    with tracing.span("ingest.join"):
        return SequenceCollection.from_concat(codes, lengths)


def read_reads(
    path: str,
    n_policy: NPolicy | str = NPolicy.REJECT,
    seed: int = 0,
    chunk_bytes: int = 1 << 26,
):
    """The same streaming parse, for callers that need the records
    themselves: (codes uint8[total], lengths int64[n], names list[str]).
    Read j is codes[lengths[:j].sum():][:lengths[j]]; a record without a
    name is called read<j>. No read-length requirement is enforced."""
    return _stream_reads(path, n_policy, seed, chunk_bytes, True)


def _stream_reads(path, n_policy, seed, chunk_bytes, with_names):
    if isinstance(n_policy, str):
        n_policy = NPolicy(n_policy)
    opener = gzip.open if str(path).endswith(".gz") else open
    chunks: List[np.ndarray] = []    # per-region code arrays
    bound_parts: List[np.ndarray] = []  # read-start offsets, global
    names: List[str] = []
    base = 0                          # total kept (code) bytes so far
    lines_seen = 0                    # FASTQ phase carry
    region_i = 0
    fmt = None
    carry = b""

    def _region(region: bytes):
        nonlocal base, lines_seen, region_i
        with tracing.span("ingest.parse"):
            buf = np.frombuffer(region, dtype=np.uint8)
            starts, ends = _line_table(buf)
            if starts.size == 0:
                return
            if fmt == "fasta":
                is_rec = buf[starts] == ord(">")
                is_body = ~is_rec
                is_name = is_rec
            else:
                phase = (lines_seen + np.arange(starts.shape[0])) % 4
                is_rec = phase == 1       # the sequence line IS the record
                is_body = is_rec
                is_name = phase == 0
                lines_seen += starts.shape[0]
            if with_names:
                for s0, e0 in zip(starts[is_name], ends[is_name]):
                    names.append(_name(region[s0 + 1 : e0], len(names)))
            keep = _span_mask(buf, starts[is_body], ends[is_body])
            # kept length per line (line body minus CRs) -> record starts
            # by a LINE-level cumsum; no per-byte int64 scan
            crs = np.nonzero(buf == ord("\r"))[0]
            body_len = ends - starts
            if crs.size:
                body_len = body_len - (
                    np.searchsorted(crs, ends) - np.searchsorted(crs, starts)
                )
            body_len = np.where(is_body, body_len, 0)
            line_off = np.concatenate([[0], np.cumsum(body_len)[:-1]])
            rec_off = line_off[is_rec]
        with tracing.span("ingest.encode"):
            codes = _encode(buf[keep], n_policy, seed + region_i)
            bound_parts.append(base + rec_off)
            chunks.append(codes)
            base += codes.shape[0]
            region_i += 1

    # traced per chunk: the file read with the carry joined on
    # (ingest.read), the line table, span mask and CR count
    # (ingest.parse), the encoding (ingest.encode); the final
    # concatenation is ingest.join
    with opener(path, "rb") as f:
        while True:
            with tracing.span("ingest.read"):
                data = f.read(chunk_bytes)
                if not data:
                    break
                tracing.count("ingest_numpy_bytes", len(data))
                buf = carry + data
                if fmt is None:
                    if buf[:1] == b"@":
                        fmt = "fastq"
                    elif buf[:1] == b">":
                        fmt = "fasta"
                    else:
                        raise ValueError(
                            f"{path}: not FASTA/FASTQ (starts with "
                            f"{buf[:1]!r})"
                        )
                cut = buf.rfind(b"\n") + 1
                if cut == 0:
                    carry = buf
                    continue
                carry = buf[cut:]
                region = buf[:cut]
            _region(region)
            del region
    if carry:
        with tracing.span("ingest.read"):
            region = carry + b"\n"
        _region(region)
        del region
    if fmt is None:
        raise ValueError(f"empty input: {path}")
    with tracing.span("ingest.join"):
        codes = (np.concatenate(chunks) if chunks
                 else np.zeros(0, dtype=np.uint8))
        starts_all = (np.concatenate(bound_parts) if bound_parts
                      else np.zeros(0, dtype=np.int64))
    if starts_all.size == 0:
        raise ValueError(f"no records parsed from {path}")
    lengths = np.diff(np.concatenate([starts_all, [codes.shape[0]]]))
    return codes, lengths, names


def _name(header: bytes, j: int) -> str:
    """The first word of a header line's text, else read<j>."""
    tok = header.split()
    return tok[0].decode() if tok else f"read{j}"


def _parse_fasta_numpy(raw: bytes, n_policy: NPolicy, seed: int):
    """(reads, names) of FASTA bytes in NumPy: the plain version of the
    native parser, and the path of the random policy."""
    buf = np.frombuffer(raw, dtype=np.uint8)
    starts, ends = _line_table(buf)
    is_hdr = buf[starts] == ord(">")
    reads = _cut_reads(buf, starts[~is_hdr], ends[~is_hdr], starts[is_hdr],
                       n_policy, seed)
    names = [_name(raw[s0 + 1 : e0], j) for j, (s0, e0) in enumerate(
        zip(starts[is_hdr].tolist(), ends[is_hdr].tolist()))]
    return reads, names


def _parse_fastq(raw: bytes, n_policy: NPolicy, seed: int):
    """(reads, names) of FASTQ bytes: 4-line records (the reference reads
    these via kseq too), the second line of each the sequence."""
    buf = np.frombuffer(raw, dtype=np.uint8)
    starts, ends = _line_table(buf)
    phase = np.arange(starts.shape[0]) % 4
    is_seq = phase == 1
    if not is_seq.any():
        raise ValueError("no FASTQ records parsed")
    reads = _cut_reads(buf, starts[is_seq], ends[is_seq], starts[is_seq],
                       n_policy, seed)
    hdr_s, hdr_e = starts[phase == 0], ends[phase == 0]
    names = [_name(raw[hdr_s[j] + 1 : hdr_e[j]], j) for j in range(len(reads))]
    return reads, names


def _cut_reads(buf, body_starts, body_ends, rec_starts, n_policy, seed):
    """The sequence lines [body_starts, body_ends) of buf, CRs dropped,
    encoded in one pass and cut into one code array a record, a record
    starting at the first sequence byte at or after rec_starts[j]."""
    keep = _span_mask(buf, body_starts, body_ends)
    codes_all = _encode(buf[keep], n_policy, seed)
    excl = np.zeros(buf.shape[0] + 1, dtype=np.int64)
    np.cumsum(keep, out=excl[1:])
    bounds = np.concatenate([excl[rec_starts], [codes_all.shape[0]]])
    return [codes_all[bounds[j] : bounds[j + 1]]
            for j in range(bounds.shape[0] - 1)]


def _line_table(buf: np.ndarray):
    """(starts, ends) of every newline-terminated line in buf; a final
    unterminated line is included with end = len(buf)."""
    nl = np.nonzero(buf == ord("\n"))[0]
    starts = np.concatenate([[0], nl + 1]).astype(np.int64)
    ends = np.concatenate([nl, [buf.shape[0]]]).astype(np.int64)
    if starts[-1] >= buf.shape[0]:
        starts, ends = starts[:-1], ends[:-1]
    return starts, ends[: starts.shape[0]]


def _span_mask(buf: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    """Boolean mask covering [starts_i, ends_i) spans, minus CRs —
    one delta pass instead of a per-span Python loop. Spans never nest
    (they are disjoint line bodies), so int8 accumulators suffice and
    transients stay ~3x the buffer, not 8x."""
    delta = np.zeros(buf.shape[0] + 1, dtype=np.int8)
    delta[starts] = 1
    delta[ends] -= 1          # an end never equals another span's start
    keep = np.cumsum(delta[:-1], dtype=np.int8) > 0
    keep[buf == ord("\r")] = False
    return keep


def _bad_char(n_policy: NPolicy, ch: str) -> ValueError:
    """The error of a sequence character `ch` the policy cannot encode."""
    if n_policy is NPolicy.REJECT:
        return ValueError(
            f"non-ACGT character {ch!r}; rerun with an N-policy "
            "('random' for the transferN behavior, 'to-g' for the "
            "mySort quirk)"
        )
    if n_policy is NPolicy.TO_G:
        return ValueError(f"IUPAC code {ch!r} not covered by to-g policy")
    return ValueError(f"unrecognized sequence character {ch!r}")


def _encode(seq_bytes: np.ndarray, n_policy: NPolicy, seed: int) -> np.ndarray:
    codes = _CODE[seq_bytes]
    bad = codes == 255
    if not bad.any():
        return codes
    if n_policy is NPolicy.REJECT:
        raise _bad_char(n_policy, chr(int(seq_bytes[np.argmax(bad)])))
    if n_policy is NPolicy.TO_G:
        codes = codes.copy()
        isn = (seq_bytes == ord("N")) | (seq_bytes == ord("n"))
        codes[isn] = 2  # the src/mySort.c:33 'N'->G quirk
        still = codes == 255
        if still.any():
            raise _bad_char(n_policy, chr(int(seq_bytes[np.argmax(still)])))
        return codes
    # RANDOM: transferN-equivalent seeded substitution
    rng = np.random.default_rng(seed)
    codes = codes.copy()
    upper = np.where(
        (seq_bytes >= ord("a")), seq_bytes - 32, seq_bytes
    ).astype(np.uint8)
    for code_char, bases in IUPAC.items():
        mask = upper == ord(code_char)
        cnt = int(mask.sum())
        if cnt:
            pool = np.frombuffer(bases.encode(), dtype=np.uint8)
            codes[mask] = _CODE[pool[rng.integers(0, len(bases), size=cnt)]]
    still = codes == 255
    if still.any():
        raise _bad_char(n_policy, chr(int(seq_bytes[np.argmax(still)])))
    return codes
