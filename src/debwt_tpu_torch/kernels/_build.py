"""Build and load the port's CUDA kernels and its host helpers.

Each source `csrc/<name>.cu` is compiled by nvcc for sm_90a into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds) and loaded with ctypes. Libraries are built at first use
into `csrc/build/` (git-ignored), under a name that hashes the source
and the flags, so an edited source is rebuilt; the compiler's output is
kept beside each library as `.log`. `build_all` starts one compiler per
source at once and waits for all of them.

A name in HOST_SOURCES is a host helper, `csrc/<name>.cpp` (the LF
walker of verify.py, the out-of-core tier's pass-A binner, the FASTA
parser of io.read_fasta): the same
scheme with the host C++ compiler (`-pthread`: the binner starts
threads), so it also builds where there is no nvcc. A source that does
not build raises; nothing steps in for it.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("window_keys", "seg_or")
HOST_SOURCES = ("lf_walk", "ooc_binner", "fasta_parser")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME or put nvcc on PATH"
        )
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(
            "no host C++ compiler found: set CXX or put g++ on PATH"
        )
    return cxx


def _source(name: str) -> Path:
    return CSRC / f"{name}.{'cpp' if name in HOST_SOURCES else 'cu'}"


def _flags(name: str) -> tuple:
    return CXX_FLAGS if name in HOST_SOURCES else NVCC_FLAGS


def lib_path(name: str) -> Path:
    digest = hashlib.sha256(
        _source(name).read_bytes() + " ".join(_flags(name)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every library in `names` that is not built yet, all at
    once. Returns the compiler's output (for nvcc, ptxas's register and
    shared-memory report) per name; for a library already built, the
    output saved beside it when it was built. Raises if a build failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    logs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            logs[name] = log.read_text() if log.exists() else ""
            continue
        compiler = _cxx() if name in HOST_SOURCES else _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler, *_flags(name), "-o", str(tmp), str(_source(name))]
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
            "the build failed for "
            + ", ".join(failed)
            + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu (or .cpp), built on first use."""
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
