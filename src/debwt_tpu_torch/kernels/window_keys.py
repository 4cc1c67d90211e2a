"""Kernel 1: the right-aligned 2-bit key of every w-char window, int64.

Replaces the Pallas TPU kernel
`src/debwt_tpu/kernels/window_keys.py::window_keys_pallas`, the core
primitive behind node and edge keys (the reference extracts windows
per position from packed u64 words, src/collect#$.c:243-251).

    key(p) = sum_{i < w} x2[p + i] * 4**(w - 1 - i),   0 <= p < n_out

The key holds the same 64 bits as the JAX package's (hi, lo) uint32
pair, (hi << 32) | lo; at w = 32 the top bit may be set, so the int64
reads negative.

Two entries, one kernel body (`csrc/window_keys.cu`): `window_keys`
takes uint8 codes, one a byte (any slice of a tensor: the fused
engine's codes), and `window_keys_packed` takes the 2-bit packed int32
words of `ops.pack_2bit_words_host` (16 codes a word, first code in
bits 31:30: what the grouped and out-of-core tiers hold). On a CUDA
tensor each launches the hand-written kernel, which stages packed words
in shared memory and builds a key from three of them with two funnel
shifts (bound by the bytes of the keys it writes). On a CPU tensor
each runs its plain version: `window_keys_plain`, the log-doubling of
the JAX package's ops.window_keys on int64, behind an unpack for the
packed entry.
`window_keys_words_replay` is the kernel's own index arithmetic in
torch, tested where the kernel cannot run. Both entries count their
launches in `window_keys.launches`.

`window_keys_at` is the same body at gathered positions: the key of the
w-char window at each of a tensor of int64 text positions, read from
the packed words (the out-of-core tier's pass B, which keeps positions
and not keys on disk). Its plain version `window_keys_at_plain` unpacks
the w codes at each position; it counts in `window_keys_at.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from debwt_tpu_torch.kernels import _build


def window_keys_plain(x2: torch.Tensor, w: int, n_out: int) -> torch.Tensor:
    """Log-doubling over whole arrays: D_2j[p] = D_j[p] << 2j | D_j[p+j],
    then w's binary decomposition appended greedily."""
    d = {1: x2[: n_out + w - 1].to(torch.int64)}
    p = 1
    while 2 * p <= min(w, 16):
        prev = d[p]
        m_len = prev.shape[0] - p
        d[2 * p] = (prev[:m_len] << (2 * p)) | prev[p : p + m_len]
        p *= 2
    parts = []
    rem = w
    for q in (16, 8, 4, 2, 1):
        while rem >= q and q in d:
            parts.append(q)
            rem -= q
    assert rem == 0, (w, parts)
    key = d[parts[0]][:n_out]
    off = parts[0]
    for q in parts[1:]:
        key = (key << (2 * q)) | d[q][off : off + n_out]
        off += q
    return key


def window_keys_packed_plain(x2w: torch.Tensor, w: int, n_out: int) -> torch.Tensor:
    """Unpack the words to one code a byte, then `window_keys_plain`."""
    from debwt_tpu_torch import ops   # ops imports this module

    return window_keys_plain(ops.unpack_2bit_words(x2w, n_out + w - 1), w, n_out)


def window_keys_words_replay(x2w: torch.Tensor, w: int, n_out: int) -> torch.Tensor:
    """The kernel's arithmetic in torch int64: for position p, word
    j = p >> 4 and offset o = p & 15; the key is the top 2w bits of the
    64-bit window that starts 2o bits into W[j], from two funnel shifts
    over W[j], W[j+1], W[j+2]. A word past the end of `x2w` is not read
    (it stands as 0), as in the kernel's loaders."""
    m32 = 0xFFFFFFFF
    W = x2w.to(torch.int64) & m32          # the words' uint32 bits
    n_words = W.shape[0]
    p = torch.arange(n_out, dtype=torch.int64, device=x2w.device)
    j = p >> 4
    sh = 2 * (p & 15)

    def word(i):
        return torch.where(i < n_words, W[i.clamp(max=n_words - 1)], 0)

    def funnel_l(lo, hi):                  # __funnelshift_l(lo, hi, sh)
        return ((hi << sh) | (lo >> (32 - sh))) & m32

    w0, w1, w2 = word(j), word(j + 1), word(j + 2)
    key = (funnel_l(w1, w0) << 32) | funnel_l(w2, w1)
    drop = 2 * (32 - w)
    if drop:                               # a logical right shift
        key = (key >> drop) & ((1 << (64 - drop)) - 1)
    return key


def window_keys_at_plain(x2w: torch.Tensor, pos: torch.Tensor, w: int) -> torch.Tensor:
    """The key of the w-char window at each text position pos[i], one
    code at a time: code q is bits 31 - 2 (q & 15) and 30 - 2 (q & 15)
    of word q >> 4. A word outside the words reads as 0, as in the
    kernel."""
    W = x2w.to(torch.int64) & 0xFFFFFFFF   # the words' uint32 bits
    n_words = W.shape[0]
    key = torch.zeros(pos.shape[0], dtype=torch.int64, device=pos.device)
    for t in range(w):
        q = pos + t
        g = q >> 4
        word = torch.where((g >= 0) & (g < n_words),
                           W[g.clamp(0, max(0, n_words - 1))], 0)
        key = (key << 2) | ((word >> (30 - 2 * (q & 15))) & 3)
    return key


def _lib():
    lib = _build.load("window_keys")
    for fn in (lib.debwt_window_keys, lib.debwt_window_keys_packed):
        if fn.argtypes is None:
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
    fn = lib.debwt_window_keys_at
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _check_w(w: int) -> None:
    if not 1 <= w <= 32:
        raise ValueError(f"window width must be in [1, 32], got {w}")


def _launch(entry: str, x: torch.Tensor, w: int, n_out: int) -> torch.Tensor:
    """Launch one of the kernel's two C entries on the CUDA tensor x."""
    if x.device.type != "cuda":
        raise ValueError(f"window_keys runs on cuda or cpu, not {x.device}")
    x = x.contiguous()
    out = torch.empty(n_out, dtype=torch.int64, device=x.device)
    if n_out == 0:
        return out
    rc = getattr(_lib(), entry)(
        x.data_ptr(), x.shape[0], out.data_ptr(), n_out, w,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, f"{entry} launch")
    window_keys.launches += 1
    return out


def window_keys(x2: torch.Tensor, w: int, n_out: int) -> torch.Tensor:
    """int64[n_out] window keys of uint8 codes x2 (values 0..3, at least
    n_out + w - 1 of them)."""
    _check_w(w)
    if x2.dim() != 1 or x2.dtype != torch.uint8:
        raise ValueError(f"x2 must be 1-D uint8, got {x2.dtype} {tuple(x2.shape)}")
    if x2.shape[0] < n_out + w - 1:
        raise ValueError(f"x2 holds {x2.shape[0]} codes, need {n_out + w - 1}")
    if x2.device.type == "cpu":
        return window_keys_plain(x2, w, n_out)
    return _launch("debwt_window_keys", x2, w, n_out)


def window_keys_packed(x2w: torch.Tensor, w: int, n_out: int) -> torch.Tensor:
    """int64[n_out] window keys of the packed text x2w: int32 words, 16
    codes a word, first code in bits 31:30, at least n_out + w - 1 codes."""
    _check_w(w)
    if x2w.dim() != 1 or x2w.dtype != torch.int32:
        raise ValueError(f"x2w must be 1-D int32, got {x2w.dtype} {tuple(x2w.shape)}")
    if 16 * x2w.shape[0] < n_out + w - 1:
        raise ValueError(
            f"x2w holds {16 * x2w.shape[0]} codes, need {n_out + w - 1}"
        )
    if x2w.device.type == "cpu":
        return window_keys_packed_plain(x2w, w, n_out)
    return _launch("debwt_window_keys_packed", x2w, w, n_out)


window_keys.launches = 0   # launches of either entry


def window_keys_at(x2w: torch.Tensor, pos: torch.Tensor, w: int) -> torch.Tensor:
    """int64 keys of the w-char windows at the text positions `pos`
    (1-D int64, any order) of the packed text x2w (1-D int32 words, the
    layout of window_keys_packed). A code past the words reads as 0."""
    _check_w(w)
    if x2w.dim() != 1 or x2w.dtype != torch.int32:
        raise ValueError(f"x2w must be 1-D int32, got {x2w.dtype} {tuple(x2w.shape)}")
    if pos.dim() != 1 or pos.dtype != torch.int64:
        raise ValueError(f"pos must be 1-D int64, got {pos.dtype} {tuple(pos.shape)}")
    if x2w.device != pos.device:
        raise ValueError(f"x2w on {x2w.device}, pos on {pos.device}")
    if x2w.shape[0] == 0:
        raise ValueError("x2w holds no words")
    if pos.device.type == "cpu":
        return window_keys_at_plain(x2w, pos, w)
    if pos.device.type != "cuda":
        raise ValueError(f"window_keys_at runs on cuda or cpu, not {pos.device}")
    x2w, pos = x2w.contiguous(), pos.contiguous()
    out = torch.empty(pos.shape[0], dtype=torch.int64, device=pos.device)
    if pos.shape[0] == 0:
        return out
    rc = _lib().debwt_window_keys_at(
        x2w.data_ptr(), x2w.shape[0], pos.data_ptr(), pos.shape[0], w,
        out.data_ptr(), torch.cuda.current_stream(pos.device).cuda_stream,
    )
    _build.check(rc, "debwt_window_keys_at launch")
    window_keys_at.launches += 1
    return out


window_keys_at.launches = 0
