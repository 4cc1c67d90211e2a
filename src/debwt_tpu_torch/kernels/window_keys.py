"""Kernel 1: the right-aligned 2-bit key of every w-char window, int64.

Replaces the Pallas TPU kernel
`src/debwt_tpu/kernels/window_keys.py::window_keys_pallas`, the core
primitive behind node and edge keys (the reference extracts windows
per position from packed u64 words, src/collect#$.c:243-251).

    key(p) = sum_{i < w} x2[p + i] * 4**(w - 1 - i),   0 <= p < n_out

The key holds the same 64 bits as the JAX package's (hi, lo) uint32
pair, (hi << 32) | lo; at w = 32 the top bit may be set, so the int64
reads negative.

On a CUDA tensor the wrapper launches the hand-written kernel in
`csrc/window_keys.cu` (one HBM read of the codes, one write of the
keys; bound by bytes). On a CPU tensor it runs `window_keys_plain`, the
log-doubling of the JAX package's ops.window_keys on int64.
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


def _lib():
    lib = _build.load("window_keys")
    fn = lib.debwt_window_keys
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def window_keys(x2: torch.Tensor, w: int, n_out: int) -> torch.Tensor:
    """int64[n_out] window keys of uint8 codes x2 (values 0..3, at least
    n_out + w - 1 of them)."""
    if not 1 <= w <= 32:
        raise ValueError(f"window width must be in [1, 32], got {w}")
    if x2.dim() != 1 or x2.dtype != torch.uint8:
        raise ValueError(f"x2 must be 1-D uint8, got {x2.dtype} {tuple(x2.shape)}")
    if x2.shape[0] < n_out + w - 1:
        raise ValueError(f"x2 holds {x2.shape[0]} codes, need {n_out + w - 1}")
    if x2.device.type == "cpu":
        return window_keys_plain(x2, w, n_out)
    if x2.device.type != "cuda":
        raise ValueError(f"window_keys runs on cuda or cpu, not {x2.device}")
    x2 = x2.contiguous()
    out = torch.empty(n_out, dtype=torch.int64, device=x2.device)
    if n_out == 0:
        return out
    rc = _lib()(
        x2.data_ptr(), x2.shape[0], out.data_ptr(), n_out, w,
        torch.cuda.current_stream(x2.device).cuda_stream,
    )
    _build.check(rc, "window_keys launch")
    window_keys.launches += 1
    return out


window_keys.launches = 0
