"""Build and load the port's CUDA kernels.

Each source `csrc/<name>.cu` is compiled by nvcc for sm_90a into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds) and loaded with ctypes. Libraries are built at first use
into `csrc/build/` (git-ignored), under a name that hashes the source
and the flags, so an edited source is rebuilt; nvcc's output is kept
beside each library as `.log`. `build_all` starts one
nvcc per source at once and waits for all of them.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("window_keys", "seg_or")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME or put nvcc on PATH"
        )
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every library in `names` that is not built yet, all at
    once. Returns nvcc's output (ptxas register and shared-memory
    report) per name; for a library already built, the output saved
    beside it when it was built. Raises on the first failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    logs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            logs[name] = log.read_text() if log.exists() else ""
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in running.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        log_tmp = tmp.with_suffix(".log")
        log_tmp.write_text(logs[name])
        os.replace(log_tmp, out.with_suffix(".log"))
        os.replace(tmp, out)      # atomic: concurrent builders agree
    if failed:
        raise RuntimeError(
            "nvcc failed for "
            + ", ".join(failed)
            + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
