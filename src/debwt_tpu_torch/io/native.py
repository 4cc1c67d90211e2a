"""ctypes bindings for the native host helpers: the LF walker and its
occ table (csrc/lf_walk.cpp), the out-of-core tier's pass-A binner
(csrc/ooc_binner.cpp) and the FASTA parser and region scan
(csrc/fasta_parser.cpp).

The counterpart of the JAX package's io/native.py. Each library is
built with the host C++ compiler at first use (kernels/_build.py) into
csrc/build/. A helper that does not build raises: verify.py never turns
into its Python loop, nor oocore into its NumPy binner, nor read_fasta
or read_collection into its NumPy parser, on its own. Those are the
versions the tests hold the helpers against; they select the walk loop
and the NumPy occ table by replacing `has_lf_walk` and call the NumPy
binner, oocore._bin_rows_numpy, and the NumPy parsers,
io.fasta._parse_fasta_numpy and io.fasta._read_collection_numpy,
directly.
"""

from __future__ import annotations

import ctypes

import numpy as np

from debwt_tpu_torch.kernels import _build


def _lib():
    lib = _build.load("lf_walk")
    if lib.debwt_lf_walk.argtypes is None:
        lib.debwt_lf_walk.restype = ctypes.c_int64
        lib.debwt_lf_walk.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.debwt_lf_walk_occ.restype = ctypes.c_int64
        lib.debwt_lf_walk_occ.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.debwt_occ6.restype = None
        lib.debwt_occ6.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
    return lib


def has_lf_walk() -> bool:
    """True: verify.py walks natively, building the walker if need be."""
    return True


def _checked(a: np.ndarray, dtype, what: str) -> np.ndarray:
    if a.dtype != dtype or not a.flags.c_contiguous:
        raise ValueError(f"{what} must be C-contiguous {np.dtype(dtype)}")
    return a


def lf_walk(lf, bwt6, x6, steps: int, start: int) -> int:
    """Native i <- lf[i] walk; returns -1 ok, else first-mismatch text
    position. Arrays must be C-contiguous (int64/uint8/uint8)."""
    n = lf.shape[0]
    _checked(lf, np.int64, "lf")
    _checked(bwt6, np.uint8, "bwt6")
    _checked(x6, np.uint8, "x6")
    if not (bwt6.shape[0] == x6.shape[0] == n and 0 <= steps <= n
            and 0 <= start < max(n, 1)):
        raise ValueError("lf_walk: sizes, steps or start out of range")
    return int(_lib().debwt_lf_walk(
        lf.ctypes.data, bwt6.ctypes.data, x6.ctypes.data, n, steps, start,
    ))


def lf_walk_occ(bwt6, x6, occ6, cum, sample: int, steps: int,
                start: int) -> int:
    """Native sampled-occ walk (bounded memory); same return contract."""
    n = bwt6.shape[0]
    _checked(bwt6, np.uint8, "bwt6")
    _checked(x6, np.uint8, "x6")
    _checked(cum, np.int64, "cum")
    if occ6.dtype not in (np.uint32, np.int64) or not occ6.flags.c_contiguous:
        raise ValueError("occ6 must be C-contiguous uint32 or int64")
    if not (x6.shape[0] == n and 0 <= steps <= n and 0 <= start < max(n, 1)
            and sample > 0 and cum.shape[0] >= 6
            and occ6.shape == ((n + sample - 1) // sample + 1, 6)):
        raise ValueError("lf_walk_occ: sizes, steps or start out of range")
    is_u32 = 1 if occ6.dtype == np.uint32 else 0
    return int(_lib().debwt_lf_walk_occ(
        bwt6.ctypes.data, x6.ctypes.data, occ6.ctypes.data, is_u32,
        cum.ctypes.data, sample, n, steps, start,
    ))


def occ6(bwt6, sample: int, dtype):
    """Native sampled occ table: (occ6[(n_s + 1), 6] of `dtype`, uint32
    or int64, and the six totals int64), as verify._build_occ6_numpy."""
    _checked(bwt6, np.uint8, "bwt6")
    if sample <= 0 or np.dtype(dtype) not in (np.uint32, np.int64):
        raise ValueError("occ6: sample must be positive, dtype uint32 or int64")
    n = bwt6.shape[0]
    occ = np.empty(((n + sample - 1) // sample + 1, 6), dtype=dtype)
    counts = np.empty(6, dtype=np.int64)
    _lib().debwt_occ6(bwt6.ctypes.data, n, sample, occ.ctypes.data,
                      1 if occ.dtype == np.uint32 else 0, counts.ctypes.data)
    return occ, counts


def _binner():
    lib = _build.load("ooc_binner")
    if lib.debwt_ooc_bin.argtypes is None:
        lib.debwt_ooc_bin.restype = ctypes.c_int64
        lib.debwt_ooc_bin.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
    return lib


def ooc_bin(key, c0: int, sep, x2p, N: int, splitters, split_c: int,
            k: int, threads: int = 0):
    """Native pass-A binner: the rows of the node keys `key` (int64,
    positions c0 .. c0 + len(key) - 1) whose k-window holds no
    separator, grouped by bucket. Returns (out_key int64, out_k16
    uint16, out_pos int64, counts int64[nb]); bucket b's rows are
    out_*[sum(counts[:b]) : sum(counts[:b + 1])], in ascending position.
    threads <= 0: min(hardware threads, 8); the output is the same for
    every count."""
    _checked(key, np.int64, "key")
    _checked(sep, np.int64, "sep")
    _checked(x2p, np.uint8, "x2p")
    _checked(splitters, np.uint32, "splitters")
    C_real = key.shape[0]
    nb = splitters.shape[0] + 1
    if not (0 < split_c <= k < 32 and 0 <= c0 and c0 + C_real <= N
            and x2p.shape[0] >= N and sep.shape[0] >= 1
            and sep[-1] == N - 1):
        raise ValueError("ooc_bin: sizes, k or positions out of range")
    out_key = np.empty(C_real, np.int64)
    out_k16 = np.empty(C_real, np.uint16)
    out_pos = np.empty(C_real, np.int64)
    counts = np.zeros(nb, np.int64)
    total = _binner().debwt_ooc_bin(
        key.ctypes.data, c0, C_real, sep.ctypes.data, sep.shape[0],
        x2p.ctypes.data, N, splitters.ctypes.data, nb, split_c, k, threads,
        out_key.ctypes.data, out_k16.ctypes.data, out_pos.ctypes.data,
        counts.ctypes.data,
    )
    if total != int(counts.sum()):
        raise RuntimeError("ooc_bin: row count and bucket counts disagree")
    return out_key[:total], out_k16[:total], out_pos[:total], counts


def _parser():
    lib = _build.load("fasta_parser")
    if lib.debwt_parse_fasta.argtypes is None:
        lib.debwt_parse_fasta.restype = ctypes.c_int
        lib.debwt_parse_fasta.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.debwt_scan_fasta_region.restype = ctypes.c_int
        lib.debwt_scan_fasta_region.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64, i64p, ctypes.c_void_p,
            ctypes.c_int64, i64p, ctypes.POINTER(ctypes.c_int), i64p, i64p,
            ctypes.POINTER(ctypes.c_int),
        ]
    return lib


def parse_fasta(raw: bytes, policy: str, seed: int):
    """(reads, names) of the FASTA bytes `raw`, as io.read_fasta returns
    them: reads are uint8 code arrays (views of one buffer), and a record
    whose header holds no name is called read<record index>. The
    policies reject and to-g run in the native parser; random runs in
    NumPy (io.fasta._parse_fasta_numpy) with `seed`, so that its
    substitution stream is the same on every path."""
    from debwt_tpu_torch.io.fasta import NPolicy, _name, _parse_fasta_numpy

    if NPolicy(policy) is NPolicy.RANDOM:
        return _parse_fasta_numpy(raw, NPolicy.RANDOM, seed)
    buf = np.frombuffer(raw, dtype=np.uint8)
    if buf.shape[0] == 0 or buf[0] != ord(">"):
        raise ValueError("parse_fasta: the input must start with '>'")
    # every '>' byte, a sequence's too, bounds the record count
    n_cap = int(np.count_nonzero(buf == ord(">"))) + 1
    out_codes = np.empty(buf.shape[0], dtype=np.uint8)
    out_bounds = np.empty(n_cap + 1, dtype=np.int64)
    n_records, total, err_pos = (ctypes.c_int64(0) for _ in range(3))
    rc = _parser().debwt_parse_fasta(
        buf.ctypes.data, buf.shape[0], 0 if policy == "reject" else 2,
        out_codes.ctypes.data, out_bounds.ctypes.data, n_cap,
        ctypes.byref(n_records), ctypes.byref(total), ctypes.byref(err_pos),
    )
    if rc == -2:
        ch = chr(raw[err_pos.value])
        raise ValueError(
            f"non-ACGT character {ch!r}; rerun with an N-policy "
            "('random' for the transferN behavior, 'to-g' for the "
            "mySort quirk)"
        )
    if rc != 0:
        raise RuntimeError(f"native FASTA parse failed (rc={rc})")
    nr = n_records.value
    reads = [out_codes[out_bounds[j] : out_bounds[j + 1]] for j in range(nr)]
    # the header lines, the lines that start with '>', name the records
    heads = np.nonzero(buf == ord(">"))[0]
    heads = heads[(heads == 0) | (buf[heads - 1] == ord("\n"))].tolist()
    if len(heads) != nr:
        raise RuntimeError("native FASTA parse: header and record counts differ")
    names = []
    for j, h in enumerate(heads):
        e = raw.find(b"\n", h)
        names.append(_name(raw[h + 1 : e if e >= 0 else len(raw)], j))
    return reads, names


class FastaScan:
    """io.read_collection's one streaming pass: FASTA regions of whole
    lines appended, as they are read, to the collection's `x2` (codes,
    and a T where each record ends) and `sep`, both grown only when full
    (x2 never is when its first capacity is the file's size + 1). Policy
    random leaves each IUPAC byte as its upper-case letter in x2 for the
    caller to replace; an invalid byte raises ValueError with the
    message io.fasta._encode gives."""

    _POLICY = {"reject": 0, "random": 1, "to-g": 2}

    def __init__(self, policy: str, x2_cap: int):
        self.policy = policy
        self.x2 = np.empty(max(x2_cap, 1), dtype=np.uint8)
        self.sep = np.empty(1024, dtype=np.int64)
        self._cursor = ctypes.c_int64(0)
        self._n_sep = ctypes.c_int64(0)
        self._open = ctypes.c_int(0)

    @property
    def cursor(self) -> int:
        """Bytes of x2 written."""
        return self._cursor.value

    @property
    def n_sep(self) -> int:
        return self._n_sep.value

    def scan(self, region: np.ndarray, last: bool = False) -> int:
        """Appends `region` (C-contiguous uint8, whole lines); with
        `last`, then closes the last record. Returns the count of IUPAC
        bytes left marked (policy random)."""
        from debwt_tpu_torch.io.fasta import NPolicy, _bad_char

        _checked(region, np.uint8, "region")
        n = region.shape[0]
        done = 0
        consumed, marked = ctypes.c_int64(0), ctypes.c_int64(0)
        err = ctypes.c_int(0)
        while True:
            rc = _parser().debwt_scan_fasta_region(
                region.ctypes.data + done, n - done,
                self._POLICY[self.policy], int(last),
                self.x2.ctypes.data, self.x2.shape[0], ctypes.byref(self._cursor),
                self.sep.ctypes.data, self.sep.shape[0], ctypes.byref(self._n_sep),
                ctypes.byref(self._open), ctypes.byref(consumed),
                ctypes.byref(marked), ctypes.byref(err),
            )
            if rc == -2:
                raise _bad_char(NPolicy(self.policy), chr(err.value))
            if rc != 1:
                break
            done += consumed.value
            if self.n_sep == self.sep.shape[0]:
                self.sep = _grown(self.sep, 2 * self.n_sep, self.n_sep)
            need = self.cursor + (n - done) + 1
            if need > self.x2.shape[0]:
                self.x2 = _grown(
                    self.x2, max(need, self.x2.shape[0] * 3 // 2), self.cursor)
        if rc != 0:
            raise RuntimeError(f"native FASTA scan failed (rc={rc})")
        return marked.value


def _grown(a: np.ndarray, size: int, keep: int) -> np.ndarray:
    """A larger array holding a's first `keep` items."""
    out = np.empty(size, dtype=a.dtype)
    out[:keep] = a[:keep]
    return out
