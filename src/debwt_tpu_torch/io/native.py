"""ctypes binding for the native LF walker (csrc/lf_walk.cpp).

The counterpart of the walker entries of the JAX package's
io/native.py. The library is built with the host C++ compiler at first
use (kernels/_build.py) into csrc/build/. A walker that does not build
raises: verify.py never turns into its Python loop on its own. The
Python loop is the version the tests hold the walker against; they
select it by replacing `has_lf_walk`.
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
