"""Primitive ops shared by the pipeline stages (the PyTorch counterpart
of the JAX package's ops.py).

Conventions:
  * 64-bit window keys are int64 tensors holding the same 64 bits as
    the JAX package's (hi, lo) uint32 pair: key = (hi << 32) | lo. At
    m = 32 the top bit may be set, so a key that must sort in unsigned
    order is flipped (key ^ SIGN) before a signed sort or compare.
    `keys_from_pair` / `pair_from_keys` convert on the host.
  * msort is a lexicographic multi-key sort built from chained stable
    torch.sort passes (torch has no variadic sort).
  * packed text words are uint32 on the host and int32 on the device
    (same bits); every shift is masked, so arithmetic shifts are
    harmless.
"""

from __future__ import annotations

import numpy as np
import torch

from debwt_tpu_torch.kernels.window_keys import window_keys as _window_keys
from debwt_tpu_torch.kernels.window_keys import (
    window_keys_at as _window_keys_at,
)
from debwt_tpu_torch.kernels.window_keys import (
    window_keys_packed as _window_keys_packed,
)

SIGN = -(1 << 63)   # int64 with only the top bit set


def window_keys(x2: torch.Tensor, w: int) -> torch.Tensor:
    """int64 keys of the w-char windows at every position of uint8
    codes x2 (already tail-padded): n_out = len(x2) - w + 1 keys,
    key(p) = sum_i x2[p+i] * 4**(w-1-i). Kernel 1
    (kernels/window_keys.py) on CUDA, its plain version on the CPU."""
    return _window_keys(x2, w, x2.shape[0] - w + 1)


def window_keys_packed(x2w: torch.Tensor, w: int, n_out: int) -> torch.Tensor:
    """The first n_out of those keys straight from the 2-bit packed text
    x2w (int32 words, the layout of pack_2bit_words_host), without the
    unpack: kernel 1's packed entry on CUDA, unpack plus the plain
    version on the CPU."""
    return _window_keys_packed(x2w, w, n_out)


def window_keys_at(x2w: torch.Tensor, pos: torch.Tensor, w: int) -> torch.Tensor:
    """The keys of the w-char windows at the int64 text positions `pos`
    of the packed text x2w: kernel 1's gathered entry on CUDA, its plain
    version (an unpack of the w codes at each position) on the CPU."""
    return _window_keys_at(x2w, pos, w)


def _sort_words(keys):
    """int64 / int32 words whose lexicographic order is that of `keys`:
    a run of two int32 keys packs into one int64 word (first key high,
    second key biased by 2^31 low); any other key stands alone."""
    words = []
    i = 0
    while i < len(keys):
        a = keys[i]
        if (
            a.dtype == torch.int32
            and i + 1 < len(keys)
            and keys[i + 1].dtype == torch.int32
        ):
            b = keys[i + 1]
            words.append((a.to(torch.int64) << 32) | (b.to(torch.int64) + (1 << 31)))
            i += 2
        else:
            words.append(a)
            i += 1
    return words


def msort(operands, num_keys: int = 1):
    """Sort the tuple `operands` lexicographically by its first
    `num_keys` members (signed order); returns the permuted operands.
    Ties keep their input order (every pass is stable), which is more
    than the JAX msort promises — callers must not rely on it."""
    words = _sort_words(list(operands[:num_keys]))
    perm = None
    for word in reversed(words):
        if perm is not None:
            word = word[perm]
        order = torch.sort(word, stable=True).indices
        perm = order if perm is None else perm[order]
    return tuple(op[perm] for op in operands)


def pack_2bit_words_host(x2: np.ndarray) -> np.ndarray:
    """NumPy host-side 2-bit pack into uint32 words (16 codes/word,
    first code in bits 31:30) — shrinks the host->device text transfer
    4x; unpack_2bit_words inverts it on the device.

    Byte-at-a-time: 4 codes OR into one uint8 (code 0 in bits 7:6),
    then the 4 bytes of each word reinterpret as a big-endian uint32."""
    n = x2.shape[0]
    n_words = (n + 15) // 16
    pad = np.zeros(n_words * 16, dtype=np.uint8)
    pad[:n] = x2
    q = pad.reshape(-1, 4)
    b = (q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3]
    return b.view(">u4").astype(np.uint32)


def _shifts(device):
    return 2 * (15 - torch.arange(16, dtype=torch.int32, device=device))


def unpack_2bit_words(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of pack_2bit_words_host: int32 words (uint32 bits) ->
    uint8[n] codes."""
    codes = (words[:, None] >> _shifts(words.device)[None, :]) & 3
    return codes.to(torch.uint8).reshape(-1)[:n]


def pack_2bit_words(codes: torch.Tensor) -> torch.Tensor:
    """Pack uint8 2-bit codes into int32 words holding the uint32 bits
    of the JAX package's pack_2bit_words: 16 codes/word, first code in
    bits 31:30."""
    n = codes.shape[0]
    n_words = (n + 15) // 16
    padded = torch.zeros(n_words * 16, dtype=torch.int64, device=codes.device)
    padded[:n] = codes
    words = (padded.view(n_words, 16) << _shifts(codes.device)[None, :]).sum(1)
    return torch.where(words >= (1 << 31), words - (1 << 32), words).to(torch.int32)


# codes a step of pack_codes and pack_text (a multiple of 16): a step's
# transients are about 17 bytes a code
PACK_BLOCK = 1 << 26


def pack_codes(codes: torch.Tensor, out: torch.Tensor) -> None:
    """out[i] = the word of codes[16 i : 16 i + 16] clamped to 0..3
    (pack_2bit_words's layout; a short last word is padded with 0),
    packed on their device PACK_BLOCK codes at a time."""
    for s in range(0, codes.shape[0], PACK_BLOCK):
        blk = codes[s : s + PACK_BLOCK].clamp(max=3)
        out[s // 16 : s // 16 + -(-blk.shape[0] // 16)] = pack_2bit_words(blk)


def pack_text(x2: np.ndarray, n_words: int, dev, lead: int = 0) -> torch.Tensor:
    """int32[n_words] on `dev`: `lead` words of T's, then the packed
    words of the host codes x2 and of T's after them. The codes cross
    once, as they are, PACK_BLOCK at a time, and are packed on `dev`,
    so neither the host nor the device holds a second copy of the text."""
    words = torch.empty(n_words, dtype=torch.int32, device=dev)
    words[:lead] = -1                    # 16 T's: every bit set
    n = 16 * (n_words - lead)
    for s in range(0, n, PACK_BLOCK):
        e = min(s + PACK_BLOCK, n)
        take = max(0, min(e, x2.shape[0]) - s)
        blk = torch.empty(e - s, dtype=torch.uint8, device=dev)
        blk[:take].copy_(torch.from_numpy(x2[s : s + take]))
        blk[take:] = 3                   # T
        pack_codes(blk, words[lead + s // 16 : lead + e // 16])
    return words


def sample_splitters(x2: np.ndarray, n: int, c: int, seed: int,
                     samples: int) -> np.ndarray:
    """n-1 equal-depth uint64 splitters over the c-char windows at
    `samples` random positions of the host codes x2 (the balance role
    of mySort's cumulative bucket counts, src/mySort.c:104-110). The
    tiers cut their key ranges with them: the grouped tier on full
    k-char node keys, the out-of-core and multi-device tiers on
    c = min(16, k) chars (as uint32 there); same seeds and sample counts
    as the JAX package's samplers, so that both cut the same ranges."""
    P = max(1, x2.shape[0] - c)
    idx = np.random.default_rng(seed).integers(0, P, size=samples)
    v = np.zeros(samples, dtype=np.uint64)
    for i in range(c):
        v = (v << np.uint64(2)) | x2[
            np.minimum(idx + i, x2.shape[0] - 1)
        ].astype(np.uint64)
    v.sort()
    qs = (np.arange(1, n) * samples) // n
    return v[qs]


def keys_from_pair(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """JAX (hi, lo) uint32 key pairs -> the port's int64 keys."""
    key = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        lo
    ).astype(np.uint64)
    return key.view(np.int64)


def pair_from_keys(key: np.ndarray):
    """The port's int64 keys -> JAX (hi, lo) uint32 key pairs."""
    u = np.asarray(key, dtype=np.int64).view(np.uint64)
    return (
        (u >> np.uint64(32)).astype(np.uint32),
        (u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
    )
