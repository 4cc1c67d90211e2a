"""Out-of-core chunked BWT construction (the PyTorch counterpart of the
JAX package's oocore.py) — the tier for texts the grouped tier cannot
take: N >= grouped.MAX_N, or a node key that outgrows a group.

The reference is an out-of-core pipeline by design: every stage
boundary is a 32 MiB-buffered disk file (src/collect#$.h:12), deleted
as consumed (src/INandOut.c:915-918). Here device memory is bounded by
two caps (the text chunk and the key bucket) however large the
collection is, and the working set between passes lives in host DRAM,
or on disk when a spill directory is given:

  text pack (host)        the text packed 2 bits a code, once, onto
                          the device (N/4 bytes), for both passes
  pass A  (text chunks)   device: k-char node keys per position
                          (kernel 1); host: the native binner
                          (csrc/ooc_binner.cpp) derives each row's
                          metadata and bins it into key-range buckets by
                          sampled splitters (the analogue of mySort's
                          bucket histogram prefix sums, src/mySort.c:98-110)
  pass B  (key buckets)   device: the rows' node keys again, from the
                          packed text at their positions (kernel 1's
                          gathered form, one launch), then ONE sort per
                          bucket + the engine's segment facts (kernel 2,
                          three launches); the
                          sorted row index inside bucket b plus the
                          bucket base IS the global BWT coordinate.
                          Buckets over the device bound take the
                          oversized fallback (host key sort into
                          node-boundary slabs; single-key giants reduced
                          directly)
  SP rank (device)        the SP string (branch events only) ranked by
                          prefix tripling
  blue fill               blue entries ordered by (block base, SP rank,
                          position) on the device, scattered on the host

Coordinates are int64: a text position past 2^32 is exact on the host
and on the device, where pass B moves a bucket's positions (int64) for
kernel 1's gathered form. The sort operands are bucket-local int32, and
global BWT bases are added in NumPy (int64).

Representation, against the JAX module's: a node key is one int64 (the
k <= 31 chars fill at most 62 bits, so it is non-negative and needs no
top-bit flip) where JAX keeps a (hi, lo) uint32 pair. A stored bucket row
is 6 bytes, against JAX's 18 (key, k16, pos): off uint32 (the position
less its chunk's base) and k16 uint16. The store's runs[b, c] (rows of
bucket b from chunk c) give each position back exactly, and pass B
derives the key from the position. Device arrays hold a bucket's own
rows, with no padding to a static cap. The spill layout differs from the
JAX package's, so the checkpoint fingerprint carries a version the JAX
package never writes: neither package resumes the other's spill
directory, nor the port one of its own older layout.

The grouped tier borrows the back half's ranking and blue order
(`sp_ranks`, `blue_order`) on the device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys

import numpy as np
import torch

from debwt_tpu_torch import constants as K
from debwt_tpu_torch import engine, ops, tracing
from debwt_tpu_torch.bluesort import sp_suffix_ranks
from debwt_tpu_torch.io import native
from debwt_tpu_torch.kernels.seg_or import seg_scan_or
from debwt_tpu_torch.kernels.window_keys import window_keys as _wk_counter
from debwt_tpu_torch.kernels.window_keys import window_keys_at as _wk_at_counter
from debwt_tpu_torch.pipeline import BwtResult, _bucket, _pow2, resolve_device
from debwt_tpu_torch.special import build_special
from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

U8 = torch.uint8

# Longest SP string ranked on one device (OocConfig.sp_cap's default);
# past it the ranking is sharded over devices.
SP_CAP = 1 << 28

# The JAX package's fingerprint ends in 2 (its splitter format); the
# port's spill layout is its own: version 1 of this tag held 18-byte
# rows (key, k16, pos), version 2 the 6-byte rows (off, k16) and runs.
_SPILL_LAYOUT = (1 << 32) | 2

def _malloc_trim():
    """Return freed arena pages to the OS. The pass loops allocate and
    free GB-scale transients; glibc keeps the high-water mark resident
    otherwise (the reference streams everything through 32 MiB buffers,
    src/collect#$.h:12, and this is the host-side analogue)."""
    try:
        import ctypes

        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass


@dataclasses.dataclass(frozen=True)
class OocConfig:
    """Knobs for the out-of-core tier (the JAX package's, same defaults).

    chunk:      text positions per pass-A device dispatch.
    n_buckets:  key-range buckets (pass-B sorts); device peak memory is
                O(max bucket size), so more buckets = less device memory.
    spill_dir:  when set, bucket rows spill to files under this
                directory instead of host DRAM lists; files are deleted
                as consumed, like the reference's temp files
                (src/INandOut.c:915-918).
    sp_cap:     max SP-string length ranked on one device.
    checkpoint: persist stage progress under spill_dir (manifest +
                per-bucket outputs) so an interrupted run resumes at the
                last completed bucket instead of restarting. Requires
                spill_dir.
    bucket_cap: ceiling on the rows of one device classification;
                buckets larger than this take the oversized fallback.
                None: 2^26 (the JAX package's bound, so that both send
                the same buckets there); tests shrink it.
    """

    chunk: int = 1 << 26
    n_buckets: int = 64
    spill_dir: str | None = None
    sp_cap: int = SP_CAP
    checkpoint: bool = False
    bucket_cap: int | None = None


# ---------------------------------------------------------------------------
# pass A: device node keys per text chunk, host binning
# ---------------------------------------------------------------------------


def _chunk_keys(kw: torch.Tensor, k: int, C: int) -> torch.Tensor:
    """int64 node keys (k chars, < 2^62) of the C positions of one text
    chunk: one launch of kernel 1.

    kw: int32 words of the packed text from the chunk's first position
    on, at least C + k - 1 codes (separators stored as T)."""
    return ops.window_keys_packed(kw, k, C)


def _row_keys(words: torch.Tensor, pos: np.ndarray, k: int) -> torch.Tensor:
    """int64 node keys of the rows at the text positions `pos` (host
    int64), on the device of the packed text `words`: one launch of
    kernel 1's gathered form."""
    pos_d = torch.from_numpy(np.ascontiguousarray(pos, dtype=np.int64))
    return ops.window_keys_at(words, pos_d.to(words.device), k)


def sample_splitters(x2: np.ndarray, n: int, c: int, seed: int = 17,
                     samples: int = 1 << 16) -> np.ndarray:
    """n-1 equal-depth uint32 splitters over c-char window prefixes
    (the balance role of mySort's cumulative bucket counts,
    src/mySort.c:104-110). c = min(16, k) chars: deep enough to split
    hot 8-char buckets under low-complexity skew; only a single k-mer
    with > 1/n mass is unsplittable (node groups must stay
    bucket-local by design). Same seed and sample count as the JAX
    package, so both cut the same buckets."""
    P = max(1, x2.shape[0] - c)
    idx = np.random.default_rng(seed).integers(0, P, size=samples)
    v = np.zeros(samples, dtype=np.uint32)
    for i in range(c):
        v = (v << 2) | x2[np.minimum(idx + i, x2.shape[0] - 1)].astype(np.uint32)
    v.sort()
    qs = (np.arange(1, n) * samples) // n
    return v[qs]


def _bin_rows_numpy(key, c0: int, sep, x2p, N: int, splitters,
                    split_c: int, k: int):
    """The plain version of the native binner (io.native.ooc_bin), same
    arguments and outputs: the rows of one chunk's node keys whose
    k-window holds no separator, with their metadata

      k16 = choice<<8 | bwt_char<<4 | head<<3 | predf

    grouped by bucket, ascending position inside each."""
    nb = splitters.shape[0] + 1
    pos = c0 + np.arange(key.shape[0], dtype=np.int64)
    nxt = np.searchsorted(sep, pos)
    dist = sep[nxt] - pos
    valid = dist >= k
    key, pos, dist, nxt = key[valid], pos[valid], dist[valid], nxt[valid]
    nextc = x2p[pos + k].astype(np.uint16)
    choice = np.where(
        dist == k, np.where(pos + k == N - 1, 5, 4), nextc
    ).astype(np.uint16)
    # a read head: text position 0, or the position after a separator
    head = (pos == 0) | ((nxt > 0) & (sep[np.maximum(nxt - 1, 0)] == pos - 1))
    prev = x2p[np.maximum(pos - 1, 0)].astype(np.uint16)
    bwt_char = np.where(pos == 0, 5, np.where(head, 4, prev)).astype(np.uint16)
    predf = np.where(head, 7, prev).astype(np.uint16)
    k16 = ((choice << 8) | (bwt_char << 4) | (head.astype(np.uint16) << 3)
           | predf).astype(np.uint16)
    topc = (key.view(np.uint64) >> np.uint64(2 * (k - split_c))).astype(np.uint32)
    dest = np.searchsorted(splitters, topc, side="right")
    order = np.argsort(dest, kind="stable")
    counts = np.bincount(dest, minlength=nb).astype(np.int64)
    return key[order], k16[order], pos[order], counts


class _BucketStore:
    """Per-bucket row spill: host-DRAM lists, or append-only files
    under spill_dir (one file per bucket per column). A row is 6 bytes:
    off (uint32, its position less its chunk's base) and k16 (uint16).
    Pass A appends each chunk's rows of a bucket as one run, chunks in
    order, so runs[b, c] (the rows of bucket b from chunk c) gives every
    position back exactly as int64. `reopen=True` attaches to a
    completed pass-A spill (checkpoint resume) instead of truncating it;
    the caller then sets `runs` from the manifest."""

    COLS = (("off", np.uint32), ("k16", np.uint16))

    def __init__(self, n_buckets: int, n_chunks: int, chunk: int,
                 spill_dir: str | None, reopen: bool = False):
        assert chunk <= 1 << 32, chunk
        self.n = n_buckets
        self.chunk = chunk
        self.dir = spill_dir
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
            self._fh = {} if reopen else {
                (b, c): open(self._path(b, c), "wb")
                for b in range(n_buckets) for c, _ in self.COLS
            }
        else:
            assert not reopen
            self._mem = [
                {c: [] for c, _ in self.COLS} for _ in range(n_buckets)
            ]
        self.runs = np.zeros((n_buckets, n_chunks), dtype=np.int64)

    @property
    def sizes(self) -> np.ndarray:
        return self.runs.sum(axis=1)

    def _path(self, b: int, c: str) -> str:
        return os.path.join(self.dir, f"bk{b}.{c}")

    def append(self, b: int, ci: int, k16, pos):
        """Bucket b's rows from chunk ci: int64 positions `pos`,
        ascending, in [ci * chunk, (ci + 1) * chunk), after every
        earlier chunk's rows of b and before any later one's."""
        n = pos.shape[0]
        c0 = ci * self.chunk
        assert not self.runs[b, ci:].any(), (b, ci)
        assert n == 0 or c0 <= pos[0] <= pos[-1] < c0 + self.chunk, (ci, pos[:1])
        self.runs[b, ci] = n
        cols = dict(off=(pos - np.int64(c0)).astype(np.uint32), k16=k16)
        for c, dt in self.COLS:
            if self.dir:
                self._fh[(b, c)].write(
                    np.ascontiguousarray(cols[c], dtype=dt).tobytes()
                )
            else:
                self._mem[b][c].append(cols[c].astype(dt))

    def load(self, b: int, consume: bool = True, staging: dict | None = None):
        """Bucket b's rows (k16 uint16, pos int64); consume=True deletes
        them (pass consume=False under checkpointing and call delete(b)
        after the manifest records the bucket complete). `staging`, when
        given, maps "off", "k16" and "pos" to preallocated arrays of >=
        bucket rows: files are read INTO them (bounded, alloc-free) and
        views are returned."""
        rows = int(self.runs[b].sum())
        if self.dir:
            cols = {}
            for c, dt in self.COLS:
                fh = self._fh.get((b, c))
                if fh is not None:
                    fh.close()
                path = self._path(b, c)
                if staging is not None:
                    view = staging[c][:rows]
                    with open(path, "rb") as f:
                        got = f.readinto(memoryview(view).cast("B"))
                    assert got == rows * view.dtype.itemsize, (got, rows)
                    cols[c] = view
                else:
                    cols[c] = np.fromfile(path, dtype=dt)
                if consume:
                    os.unlink(path)   # deleted as consumed
        else:
            cols = {
                c: np.concatenate(self._mem[b][c]) if self._mem[b][c]
                else np.empty(0, dt)
                for c, dt in self.COLS
            }
            self._mem[b] = None   # release as consumed
        assert cols["off"].shape[0] == rows, (cols["off"].shape, rows)
        pos = (staging["pos"][:rows] if staging is not None
               else np.empty(rows, dtype=np.int64))
        s = 0
        for ci in np.flatnonzero(self.runs[b]):
            e = s + int(self.runs[b, ci])
            np.add(cols["off"][s:e], np.int64(ci * self.chunk), out=pos[s:e],
                   dtype=np.int64)
            s = e
        return cols["k16"], pos

    def delete(self, b: int):
        if self.dir:
            for c, _ in self.COLS:
                path = self._path(b, c)
                if os.path.exists(path):
                    os.unlink(path)

    def close(self):
        if self.dir:
            for fh in self._fh.values():
                if not fh.closed:
                    fh.close()


# ---------------------------------------------------------------------------
# pass B: one sort + segment-fact classification per bucket
# ---------------------------------------------------------------------------


def _classify_bucket(r_key, r_k16, r_ord):
    """Classify one bucket of rows (same semantics as the wide path of
    engine.stage_graph, reference mergeKmer src/INandOut.c:252-445).

    Rows (all on one device):
      r_key  int64 node key
      r_k16  int32 main row: choice<<8 | bwt_char<<4 | head<<3 | predf
                   special:  1<<12  (its char rides in r_ord)
      r_ord  int32 main row: input row index; special: true_rank<<3 | char6

    Sorted by (key, k16, ord), the JAX module's 4-key (hi, lo, k16, ord)
    order; the per-node facts come from engine.segment_facts (three
    launches of kernel 2). Returns per SORTED row:
      fill6      uint8  partial BWT char (0 in blue slots)
      mo, mi     bool   per-node flags broadcast to node rows
      seg_start  int32  local sorted index of the row's segment start
      ord_s      int32  input row index (-1 for special rows)
      bwt3       uint8  the row's BWT char (blue char source)
      total      int    number of rows (== bucket coordinate span)
    """
    r_key, r_k16, r_ord = ops.msort((r_key, r_k16, r_ord), num_keys=3)
    r_spec = r_k16 >> 12
    is_node = r_spec == 0
    choice = (r_k16 >> 8) & 15
    newseg = engine._changed(r_key) | engine._changed(r_spec)
    newseg[0] = True
    mo_ind = ((engine._changed(choice) & ~newseg) | (choice >= 4)) & is_node
    del r_key, choice
    seg_start, mo_row, mi_row, pred_single_row = engine.segment_facts(
        newseg, is_node, r_k16 & 7, (r_k16 & 8) != 0, mo_ind
    )
    del newseg, mo_ind
    fill6 = engine.fill_chars(
        ~is_node, (r_ord & 7).to(U8), mi_row, pred_single_row
    )
    ord_s = torch.where(is_node, r_ord, -1)
    bwt3 = ((r_k16 >> 4) & 7).to(U8)
    return fill6, mo_row, mi_row, seg_start, ord_s, bwt3, int(r_ord.shape[0])


# ---------------------------------------------------------------------------
# checkpoint manifest (resume-by-stage)
# ---------------------------------------------------------------------------


def _fingerprint(coll, m: int, nb: int, C: int) -> str:
    h = hashlib.sha256()
    h.update(np.asarray(
        [coll.bwt_len, coll.n_reads, m, nb, C, _SPILL_LAYOUT], dtype=np.int64
    ).tobytes())
    h.update(coll.x2[:4096].tobytes())
    h.update(coll.x2[-4096:].tobytes())
    return h.hexdigest()


def _manifest_path(d):
    return os.path.join(d, "manifest.json")


def _ckpt_load(d, fp):
    p = _manifest_path(d)
    if not os.path.exists(p):
        return None
    try:
        with open(p) as f:
            st = json.loads(f.read())
    except (OSError, ValueError):
        return None
    if st.get("fingerprint") != fp or st.get("stage") == "done":
        return None
    return st


def _ckpt_save(d, st):
    tmp = _manifest_path(d) + ".tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(st))
    os.replace(tmp, _manifest_path(d))   # atomic: crash-safe manifest


# ---------------------------------------------------------------------------
# the back half: SP string, SP ranks, blue fill (the grouped tier's too)
# ---------------------------------------------------------------------------


def sp_string(sp_pos_parts: list, spec_branch_pos, sep, x2p, N: int,
              k: int):
    """The SP string in text order: (sp_pos int64, sp6 uint8), the
    event positions and, per event, the char k ahead ('#' or '$' where
    the k-window ends at a separator)."""
    parts = sp_pos_parts + [spec_branch_pos.astype(np.int64)]
    sp_pos = np.sort(np.concatenate(parts))
    nxt = np.searchsorted(sep, sp_pos)
    is_sepc = sep[nxt] - sp_pos == k
    sp6 = np.where(
        is_sepc, np.where(sp_pos + k == N - 1, 5, 4), x2p[sp_pos + k]
    ).astype(np.uint8)
    return sp_pos, sp6


def _sp_ranks_host(sp6: np.ndarray, L: int, sp_cap: int, device,
                   say, mesh=None) -> np.ndarray:
    """sp_ranks as a host int32 array."""
    return sp_ranks(sp6, L, sp_cap, device, say, mesh).cpu().numpy()


def sp_ranks(sp6, L: int, sp_cap: int, device,
             say, mesh=None) -> torch.Tensor:
    """Suffix ranks of sp6[:L] (uint8, a host array or a tensor) as an
    int32 tensor on `device`.

    L <= sp_cap: single-device prefix tripling (engine path) on
    `device`, over the eighth-power bucket of L (not a power of two,
    which would pad every rank-round sort by up to 2x).
    L  > sp_cap: the ooc x dist composition. The SP string is
    block-sharded over `mesh` (a parallel.mesh.Mesh; every rank holds
    the whole string on the host and calls this together) and ranked
    by parallel/sprank's sample-sort prefix tripling, so no device
    holds the whole string; the ranks are then gathered to every
    rank.
    """
    if L == 0:
        return torch.empty(0, dtype=torch.int32, device=device)
    if L <= sp_cap:
        ext = torch.zeros(_bucket(L), dtype=U8, device=device)
        ext[:L] = torch.as_tensor(sp6[:L], device=device)
        return sp_suffix_ranks(ext, L)[:L]
    if isinstance(sp6, torch.Tensor):
        sp6 = sp6.cpu().numpy()
    if mesh is None or mesh.n < 2:
        raise NotImplementedError(
            f"SP string ({L} events) exceeds the single-device rank cap "
            f"{sp_cap} and no multi-device mesh was given; pass mesh= "
            "(build_bwt_ooc) or route via api.build"
        )
    from debwt_tpu_torch.parallel.collectives import all_gather_rows
    from debwt_tpu_torch.parallel.sprank import sp_ranks_sharded

    n, r = mesh.n, mesh.rank
    Pb = max(8, _pow2(-(-L // n)))   # round 0 reads an 8-char halo
    blk = np.zeros(Pb, dtype=np.uint8)
    part = sp6[r * Pb : min(L, (r + 1) * Pb)]
    blk[: part.shape[0]] = part
    rank_blk = sp_ranks_sharded(mesh, torch.from_numpy(blk).to(mesh.device), L)
    say(f"SP ranks: sharded over {n} devices (block {Pb})")
    return all_gather_rows(mesh, rank_blk)[:L].to(device)


def blue_coordinates(b_base, b_pos, b_char, rank, sp_pos, device):
    """Final BWT coordinates of the case-3 (blue) entries: sort by
    (block base, SP-suffix rank, position) — position ascending for
    equal ranks is the reference's LIFO-queue drain discipline
    (src/generateSP.c:662-680) — then coordinate = base + index within
    the equal-base run. All arithmetic is int64: bases past 2^32 (the
    30 Gbp tier) are exact.

    Host arrays in, host arrays out (coords int64, chars), as in the
    JAX package; the searches and the three-key sort run in torch on
    `device` (the fused engine's blue sort, engine.stage_finish, on
    entries that come from the host)."""
    coords, chars = blue_order(b_base, b_pos, b_char, rank, sp_pos, device)
    return coords.cpu().numpy(), chars.cpu().numpy()


def blue_order(b_base, b_pos, b_char, rank, sp_pos, device):
    """blue_coordinates on `device`, its results (coords int64, chars)
    left there; each argument a host array or a tensor."""
    dev = torch.device(device)

    def put(a, dtype=None):
        return torch.as_tensor(a, device=dev, dtype=dtype)

    base, pos = put(b_base, torch.int64), put(b_pos, torch.int64)
    L = sp_pos.shape[0]
    sp_idx = torch.searchsorted(put(sp_pos, torch.int64), pos)
    b_rank = put(rank)[sp_idx.clamp_(max=max(0, L - 1))]
    del sp_idx
    base_s, _rank_s, _pos_s, char_s = ops.msort(
        (base, b_rank, pos, put(b_char)), num_keys=3
    )
    del base, b_rank, pos, _rank_s, _pos_s
    idx = torch.arange(base_s.shape[0], dtype=torch.int64, device=dev)
    first = base_s.new_ones(base_s.shape, dtype=torch.bool)
    first[1:] = base_s[1:] != base_s[:-1]
    within = idx - torch.cummax(torch.where(first, idx, 0), 0).values
    return base_s + within, char_s


def blue_fill(bwt6, blue_parts: list, rank, sp_pos, device) -> int:
    """Scatter the blue entries (base, pos, char) parts into bwt6 at
    their final coordinates; returns how many there were."""
    if not blue_parts:
        return 0
    b_base, b_pos, b_char = (
        np.concatenate([p[i] for p in blue_parts]) for i in range(3)
    )
    coords, chars = blue_coordinates(b_base, b_pos, b_char, rank, sp_pos, device)
    bwt6[coords] = chars
    return int(b_base.shape[0])


# characters a block of char_counts: at 3 Gbp np.bincount of the whole
# array would widen it to 24 GB of intp, and a block of 1 MiB keeps the
# six compare-and-count passes over it in the cache, not in memory
_COUNT_BLOCK = 1 << 20


def char_counts(a: np.ndarray) -> np.ndarray:
    """int64[6] counts of the codes 0..5 in `a`, a block at a time."""
    out = np.zeros(6, dtype=np.int64)
    for s in range(0, a.shape[0], _COUNT_BLOCK):
        blk = a[s : s + _COUNT_BLOCK]
        out += [np.count_nonzero(blk == c) for c in range(6)]
    return out


def expected_char_counts(coll: SequenceCollection) -> np.ndarray:
    """int64[6]: how often the BWT holds each character, as the text
    (coll.x6) does: the counts of x2, less what its separator positions
    hold, plus n_reads - 1 '#' and one '$' (no N-byte x6 copy)."""
    want = char_counts(coll.x2) - np.bincount(coll.x2[coll.sep], minlength=6)[:6]
    want[K.SHARP] += coll.n_reads - 1
    want[K.DOLLAR] += 1
    return want


def check_char_counts(bwt6: np.ndarray, coll: SequenceCollection):
    """The BWT holds each character as often as the text does."""
    want = expected_char_counts(coll)
    got = char_counts(bwt6)
    assert (got == want).all(), (got, want)


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------


@tracing.recorded
def build_bwt_ooc(
    coll: SequenceCollection,
    config: PipelineConfig | None = None,
    ooc: OocConfig | None = None,
    stats: dict | None = None,
    device=None,
    mesh=None,
) -> BwtResult:
    """Construct the BWT with device memory bounded by the chunk and the
    bucket, and the working set in host DRAM or under ooc.spill_dir.
    Runs on the CUDA card unless device="cpu" is passed. mesh (a
    parallel.mesh.Mesh, every rank calling with the same collection):
    past ooc.sp_cap the SP ranking is sharded over it (the ooc x dist
    composition); every other stage runs on each rank whole. With a
    mesh of two or more ranks each rank spills and checkpoints under
    its own ooc.spill_dir/rank{r}, so that ranks sharing a host (or a
    directory) never touch each other's buckets or manifest, and each
    resumes from its own.

    stats, when given, is filled with the JAX package's keys
    {'bucket_cap', 'chunk', 'n_chunks', 'sp_len', 'n_blue',
    'sharded_rank', 'stage_s'} and the port's 'launches' (the kernels'
    launches in this build: kernel 1 in pass A, its gathered form in
    pass B, kernel 2), 'n_buckets', 'max_bucket_rows',
    'classifications' (device classifications in this run) and
    'oversized_buckets'."""
    config = config or PipelineConfig()
    ooc = ooc or OocConfig()
    if ooc.spill_dir and mesh is not None and mesh.n > 1:
        ooc = dataclasses.replace(
            ooc, spill_dir=os.path.join(ooc.spill_dir, f"rank{mesh.rank}"))
    dev = resolve_device(device)
    m, k = config.m, config.k
    N = coll.bwt_len
    trace = os.environ.get("DEBWT_TRACE") == "1"
    timings = tracing.current().timings
    launches0 = (_wk_counter.launches, _wk_at_counter.launches,
                 seg_scan_or.launches)

    def _say(msg):
        if trace:
            print(f"[debwt-torch ooc] {msg}", file=sys.stderr)

    sp = build_special(coll, m)
    tracing.mark("special module (host)", dev)
    nb = ooc.n_buckets
    C = min(ooc.chunk, _pow2(N))
    n_chunks = -(-N // C)
    ckpt = bool(ooc.checkpoint and ooc.spill_dir)
    state = None
    fp = None
    if ckpt:
        os.makedirs(ooc.spill_dir, exist_ok=True)
        fp = _fingerprint(coll, m, nb, C)
        state = _ckpt_load(ooc.spill_dir, fp)
        if state is not None:
            _say(f"resuming from checkpoint: stage {state['stage']}"
                 + (f" bucket {state.get('next_bucket')}"
                    if state["stage"] == "B" else ""))
    split_c = min(16, k)
    if state is not None:
        splitters = np.asarray(state["splitters"], dtype=np.uint32)
    else:
        splitters = sample_splitters(coll.x2, nb, split_c)
    x2p = np.concatenate([coll.x2, np.full(K.TAIL_PAD, K.T, dtype=np.uint8)])
    sep = np.ascontiguousarray(coll.sep, dtype=np.int64)  # sep[-1] == N-1
    # the packed text on the device, for pass A's chunks (each reads C +
    # k - 1 codes from its base) and pass B's rows; a resume packs anew
    words = ops.pack_text(
        x2p, -(-max(x2p.shape[0], n_chunks * C + k) // 16), dev)
    tracing.mark("text pack (host)", dev)

    # ---- pass A: keys on the device, metadata + binning on the host ----
    if state is not None:
        store = _BucketStore(nb, n_chunks, C, ooc.spill_dir, reopen=True)
        store.runs = np.asarray(state["runs"], dtype=np.int64).reshape(nb, n_chunks)
    else:
        store = _BucketStore(nb, n_chunks, C, ooc.spill_dir)

    def _bin_rows(ci, C_real, keys_d):
        key = keys_d[:C_real].cpu().numpy()
        _o_key, o_k16, o_pos, cnts = native.ooc_bin(
            key, ci * C, sep, x2p, N, splitters, split_c, k
        )
        del key, _o_key
        s = 0
        for b in range(nb):
            e = s + int(cnts[b])
            if e > s:
                store.append(b, ci, o_k16[s:e], o_pos[s:e])
            s = e

    if state is None:
        pending = None   # (ci, C_real, device keys): one-deep pipeline,
        #                  chunk i+1's keys launch before chunk i's binning
        for ci in range(n_chunks):
            # the chunk's keys from the word that holds its first code
            j0, o = divmod(ci * C, 16)
            keys = _chunk_keys(
                words[j0 : j0 + -(-(o + C + k - 1) // 16)], k, o + C)[o:]
            if pending is not None:
                _bin_rows(*pending)
                _malloc_trim()
            pending = (ci, min(C, N - ci * C), keys)
        del keys
        _bin_rows(*pending)
        del pending
        _malloc_trim()
        store.close()
        tracing.mark("pass A (keys + binning)", dev)
        _say(f"pass A: {n_chunks} chunks of {C}, bucket rows "
             f"max={int(store.sizes.max())} total={int(store.sizes.sum())}")
        if ckpt:
            state = {
                "fingerprint": fp, "stage": "A",
                "runs": store.runs.tolist(),
                "splitters": splitters.tolist(),
            }
            _ckpt_save(ooc.spill_dir, state)
    else:
        # checkpoint resume skipped pass A — reset the timing origin so
        # the attach time doesn't get folded into "pass B"
        tracing.mark("pass A (resume attach)", dev)

    # special rows -> buckets (true suffix order preserved per bucket
    # because splitters partition the key space monotonically)
    n_spec = sp.spec_tfill.shape[0]
    # spec payload rank<<3|char must fit the int32 sort operand
    assert (n_spec << 3) < (1 << 31), n_spec
    spec_dest = np.searchsorted(
        splitters, (sp.spec_tfill >> np.uint64(2 * (k - split_c))).astype(np.uint32),
        side="right",
    )
    spec_key = sp.spec_tfill.view(np.int64)
    spec_rank = np.arange(n_spec, dtype=np.int64)
    spec_ord = ((spec_rank << 3) | sp.spec_bwt6).astype(np.int32)

    # ---- pass B: per-bucket sort + classification ----
    # buckets past the device bound (a hot shared prefix the uint32
    # splitters could not cut) take the oversized fallback below
    DEV_BOUND = min(1 << 26, ooc.bucket_cap or (1 << 26))
    sizes_tot = store.sizes + np.bincount(spec_dest, minlength=nb)
    max_rows = int(sizes_tot.max(initial=16))
    cap = DEV_BOUND if max_rows > DEV_BOUND else _pow2(max_rows)
    start_b = 0
    base = 0                      # int64 host coordinate — no 2^32 cap
    if ckpt:
        bwt_path = os.path.join(ooc.spill_dir, "bwt6.u8")
        sp_path = os.path.join(ooc.spill_dir, "sp_pos.i64")
        bl_paths = [os.path.join(ooc.spill_dir, f"blue.{c}")
                    for c in ("base.i64", "pos.i64", "char.u8")]
        resuming_b = (
            state["stage"] == "B" and os.path.exists(bwt_path)
        )
        if resuming_b:
            start_b = int(state["next_bucket"])
            base = int(state["base"])
            # a kill between a bucket's manifest bump and its delete()
            # below leaves that bucket's files behind
            for b in range(start_b):
                store.delete(b)
            bwt6 = np.memmap(bwt_path, dtype=np.uint8, mode="r+", shape=(N,))
            # drop any partial outputs from an interrupted bucket
            with open(sp_path, "ab") as f:
                f.truncate(int(state["sp_count"]) * 8)
            for p, w in zip(bl_paths, (8, 8, 1)):
                with open(p, "ab") as f:
                    f.truncate(int(state["blue_count"]) * w)
        else:
            bwt6 = np.memmap(bwt_path, dtype=np.uint8, mode="w+", shape=(N,))
            for p in [sp_path] + bl_paths:
                open(p, "wb").close()
        sp_f = open(sp_path, "ab")
        bl_f = [open(p, "ab") for p in bl_paths]
        counters = {"sp": int(state["sp_count"]) if resuming_b else 0,
                    "blue": int(state["blue_count"]) if resuming_b else 0}
    else:
        if ooc.spill_dir:
            # disk-spill mode memmaps the output too: the array pages to
            # the spill dir instead of pinning N bytes of RSS. Nothing
            # needs the path once the mapping exists, so the file is
            # unlinked at once: the mapping keeps its pages (and the
            # returned result readable) and the disk space goes with
            # the last reference, so no output outlives the build
            bwt_path = os.path.join(ooc.spill_dir, "bwt6.u8")
            bwt6 = np.memmap(bwt_path, dtype=np.uint8, mode="w+", shape=(N,))
            os.unlink(bwt_path)
        else:
            bwt6 = np.zeros(N, dtype=np.uint8)
        sp_pos_parts = []             # SP event positions (int64)
        blue_parts = []               # (base int64, pos int64, char u8)
    # reusable pass-B host buffers: bucket files are read INTO `staging`
    # and device operands are built in fixed buffers — no per-bucket
    # GB-scale allocations
    dev_rows = min(cap, max_rows)
    staging = (
        {c: np.empty(dev_rows, dt)
         for c, dt in _BucketStore.COLS + (("pos", np.int64),)}
        if store.dir else None
    )
    k16_b = np.empty(dev_rows, np.int32)
    ord_b = np.empty(dev_rows, np.int32)
    arange_b = np.arange(dev_rows, dtype=np.int32)
    n_classified = n_oversized = 0
    base_box = [base]

    def _emit(b_sp, b_blue):
        if ckpt:
            if b_sp is not None:
                sp_f.write(np.ascontiguousarray(b_sp).tobytes())
                counters["sp"] += b_sp.shape[0]
            if b_blue is not None:
                for f, arr in zip(bl_f, b_blue):
                    f.write(np.ascontiguousarray(arr).tobytes())
                counters["blue"] += b_blue[0].shape[0]
        else:
            if b_sp is not None:
                sp_pos_parts.append(b_sp)
            if b_blue is not None:
                blue_parts.append(b_blue)

    def _bucket_device(k16, pos, s_idx):
        """One device classification of <= cap rows (mains + specials),
        writing fills at base_box[0] and emitting SP/blue entries. The
        main rows' keys come from the packed text at their positions."""
        nonlocal n_classified
        nmain = pos.shape[0]
        n_rows = nmain + s_idx.shape[0]
        bb = base_box[0]
        r_key = torch.cat([_row_keys(words, pos, k),
                           torch.from_numpy(spec_key[s_idx]).to(dev)])
        k16_b[:nmain] = k16
        k16_b[nmain:n_rows] = 1 << 12
        ord_b[:nmain] = arange_b[:nmain]
        ord_b[nmain:n_rows] = spec_ord[s_idx]
        fill6, mo_row, mi_row, seg_start, ord_s, bwt3, total = _classify_bucket(
            r_key, *(torch.from_numpy(a[:n_rows]).to(dev) for a in (k16_b, ord_b))
        )
        del r_key
        n_classified += 1
        assert total == n_rows, (total, n_rows)
        bwt6[bb : bb + total] = fill6.cpu().numpy()
        mo_h = mo_row.cpu().numpy()
        mi_h = mi_row.cpu().numpy()
        ord_h = ord_s.cpu().numpy()
        b_sp = pos[ord_h[mo_h]] if mo_h.any() else None
        b_blue = None
        if mi_h.any():
            mrows = np.nonzero(mi_h)[0]
            b_blue = (
                bb + seg_start.cpu().numpy()[mrows].astype(np.int64),
                pos[ord_h[mrows]],
                bwt3.cpu().numpy()[mrows],
            )
        _emit(b_sp, b_blue)
        base_box[0] = bb + total

    def _giant_run(k16r, posr, s_idx):
        """A single node key with more rows than the device cap: its
        rows are ONE segment, so the per-node facts are plain
        reductions and the rows are order-free (case-2 rows all take
        the same char; case-3 rows are blue slots whose order the SP
        rank sort decides later). The reference cannot split a hot
        node either — its balance machinery (src/mySort.c:98-110)
        redistributes buckets, not nodes."""
        bb = base_box[0]
        cnt = k16r.shape[0]
        choice = (k16r >> 8) & 15
        predf = k16r & 7
        pv = np.unique(predf[predf < 4])
        mo = bool((choice >= 4).any()) or np.unique(choice).shape[0] >= 2
        mi = bool((k16r & 8).any()) or pv.shape[0] >= 2
        if mo:
            _emit(np.ascontiguousarray(posr), None)
        if mi:
            bwt6[bb : bb + cnt] = 0
            _emit(None, (
                np.full(cnt, bb, dtype=np.int64),
                np.ascontiguousarray(posr),
                ((k16r >> 4) & 7).astype(np.uint8),
            ))
        else:
            assert pv.shape[0] == 1, pv
            bwt6[bb : bb + cnt] = np.uint8(pv[0])
        bb += cnt
        if s_idx.shape[0]:
            order = np.argsort(spec_rank[s_idx], kind="stable")
            bwt6[bb : bb + s_idx.shape[0]] = sp.spec_bwt6[s_idx][order]
            bb += s_idx.shape[0]
        base_box[0] = bb

    def _oversized_bucket(b, s_idx_all):
        """Key-skew fallback: sort the bucket's rows by node key on the
        host, classify node-boundary slabs of <= cap rows through the
        device path, and reduce single-key giant runs directly."""
        k16, pos = store.load(b, consume=not ckpt)
        nmain = pos.shape[0]
        allk = np.empty(nmain + s_idx_all.shape[0], dtype=np.int64)
        for s in range(0, nmain, cap):    # device keys, cap rows at a time
            allk[s : min(s + cap, nmain)] = _row_keys(
                words, pos[s : s + cap], k).cpu().numpy()
        allk[nmain:] = spec_key[s_idx_all]
        order = np.argsort(allk, kind="stable")
        allk_s = allk[order]
        run_start = np.nonzero(np.concatenate(
            [[True], allk_s[1:] != allk_s[:-1]]
        ))[0]
        run_end = np.concatenate([run_start[1:], [allk_s.shape[0]]])
        i = 0
        n_runs = run_start.shape[0]
        while i < n_runs:
            s0 = run_start[i]
            if run_end[i] - s0 > cap:
                rows = order[s0 : run_end[i]]
                mrows = rows[rows < nmain]
                srows = rows[rows >= nmain] - nmain
                _giant_run(k16[mrows], pos[mrows], s_idx_all[srows])
                i += 1
                continue
            j = i
            while j + 1 < n_runs and run_end[j + 1] - s0 <= cap:
                j += 1
            rows = order[s0 : run_end[j]]
            mrows = rows[rows < nmain]
            srows = rows[rows >= nmain] - nmain
            _bucket_device(k16[mrows], pos[mrows], s_idx_all[srows])
            i = j + 1

    for b in range(start_b, nb):
        s_idx = np.nonzero(spec_dest == b)[0]
        n_tot = int(store.sizes[b]) + s_idx.shape[0]
        if n_tot > cap:
            _say(f"bucket {b}: {n_tot} rows exceed the device cap "
                 f"{cap} — oversized fallback (host key sort)")
            n_oversized += 1
            _oversized_bucket(b, s_idx)
        elif n_tot > 0:
            k16, pos = store.load(b, consume=not ckpt, staging=staging)
            _bucket_device(k16, pos, s_idx)
        if ckpt:
            sp_f.flush()
            for f in bl_f:
                f.flush()
            bwt6.flush()
            state = {
                "fingerprint": fp, "stage": "B", "next_bucket": b + 1,
                "base": int(base_box[0]), "sp_count": counters["sp"],
                "blue_count": counters["blue"],
                "runs": store.runs.tolist(),
                "splitters": splitters.tolist(),
            }
            _ckpt_save(ooc.spill_dir, state)
        # consumed files are gone already; an empty bucket's were never
        # loaded. Under checkpoints only after the manifest bump
        store.delete(b)
        _malloc_trim()
    assert base_box[0] == N, (base_box[0], N)
    del staging, k16_b, ord_b, arange_b, words
    tracing.mark("pass B (bucket sorts)", dev)
    _say(f"pass B: {nb} buckets, {n_classified} device classifications of "
         f"<= {dev_rows} rows, {n_oversized} oversized")

    # ---- SP string: events in text order, ranked on the device ----
    if ckpt:
        sp_f.close()
        for f in bl_f:
            f.close()
        sp_raw = np.fromfile(sp_path, dtype=np.int64)
        sp_pos_parts = [sp_raw] if sp_raw.size else []
        blue_arrs = (
            np.fromfile(bl_paths[0], dtype=np.int64),
            np.fromfile(bl_paths[1], dtype=np.int64),
            np.fromfile(bl_paths[2], dtype=np.uint8),
        )
        blue_parts = [blue_arrs] if blue_arrs[0].size else []
    sp_pos, sp6 = sp_string(sp_pos_parts, sp.spec_branch_pos, sep, x2p, N, k)
    del sp_pos_parts
    L = sp_pos.shape[0]
    rank = _sp_ranks_host(sp6, L, ooc.sp_cap, dev, _say, mesh)
    tracing.mark("SP rank", dev)
    _say(f"SP string: {L} events")

    # ---- blue fill: (block base, SP rank, position) order ----
    n_blue = blue_fill(bwt6, blue_parts, rank, sp_pos, dev)
    del blue_parts, rank
    tracing.mark("blue fill", dev)
    _say(f"blue entries: {n_blue}")
    tracing.count("sp_events", L)
    tracing.count("blue_entries", n_blue)

    if config.check:
        check_char_counts(bwt6, coll)
        tracing.mark("count check (host)", dev)
    if stats is not None:
        stats.update(
            bucket_cap=cap, chunk=C, n_chunks=n_chunks, sp_len=L,
            n_blue=n_blue, sharded_rank=L > ooc.sp_cap,
            stage_s={k_: round(v, 3) for k_, v in timings.items()},
            n_buckets=nb, max_bucket_rows=int(sizes_tot.max(initial=0)),
            classifications=n_classified, oversized_buckets=n_oversized,
            launches={
                "window_keys": _wk_counter.launches - launches0[0],
                "window_keys_at": _wk_at_counter.launches - launches0[1],
                "seg_scan_or": seg_scan_or.launches - launches0[2],
            },
        )
    if ckpt:
        # finished: the outputs live on in the mapping of bwt6.u8 and in
        # memory, so the spill directory is emptied. A crash before the
        # last unlink leaves a "done" manifest, which the next build
        # ignores like an absent one (_ckpt_load)
        bwt6.flush()
        _ckpt_save(ooc.spill_dir, {"fingerprint": fp, "stage": "done"})
        for p in [bwt_path, sp_path] + bl_paths + [_manifest_path(ooc.spill_dir)]:
            os.unlink(p)
    _malloc_trim()
    (sharp,) = np.nonzero(bwt6 == K.SHARP)
    (dollar,) = np.nonzero(bwt6 == K.DOLLAR)
    assert dollar.shape[0] == 1, dollar
    return BwtResult(
        sharp_pos=sharp.astype(np.int64),
        dollar_pos=int(dollar[0]),
        _bwt6=bwt6,
        _n=N,
        timings=timings,
        counters=tracing.current().counters,
    )
