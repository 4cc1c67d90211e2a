"""Tier routing: one entry point that picks the execution path.

The JAX package covers its envelope with four tiers (single-device
fused engine, grouped device-resident, out-of-core, multi-device). The
port has the first so far: every collection under the single-device
row bound goes to pipeline.build_bwt, and a larger one raises
NotImplementedError naming the tiers still to port. On a CUDA device
the bound is also what the card's free memory holds.
"""

from __future__ import annotations

import sys

import torch

from debwt_tpu_torch.pipeline import (
    MAX_ROWS, BwtResult, build_bwt, resolve_device, rows_needed,
)
from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

# Single-device fused-engine row bound (engine.stage_graph packs
# segment facts beside row indices in int32 scans).
_SINGLE_ROWS = MAX_ROWS

# Device bytes one sorted row costs at the peak of a build: the larger
# of the caching allocator's reserved peaks over the rows of the 4.6 and
# 140 Mbp, m = 32 builds (chip_smoke.py's peak_reserved_bytes_per_row,
# 169.20 and 160.91 on an H100 80GB HBM3; see PERF.md), rounded up. At
# this rate 2^29 rows need 91.3 GB.
_BYTES_PER_ROW = 170


def _device_memory_bytes(dev: torch.device) -> int:
    """Bytes a build can get on `dev` now: what CUDA reports free
    (the CUDA context and other processes are already taken off) plus
    what this process's caching allocator holds but has not handed out."""
    free, _ = torch.cuda.mem_get_info(dev)
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return free + cached


def single_rows_bound(dev: torch.device) -> int:
    """Rows the single-device tier takes on `dev`: the engine's 2^29,
    and on a CUDA device no more than the card's free memory holds (the
    counterpart of the JAX package's `_single_rows_hbm`). The CPU is
    bound by the engine alone."""
    if dev.type != "cuda":
        return _SINGLE_ROWS
    return min(_SINGLE_ROWS, _device_memory_bytes(dev) // _BYTES_PER_ROW)


def build(
    coll: SequenceCollection,
    config: PipelineConfig | None = None,
    device=None,
    verbose: bool = False,
) -> BwtResult:
    """Construct the BWT on `device` (the CUDA card by default)."""
    config = config or PipelineConfig()
    dev = resolve_device(device)
    rows, bound = rows_needed(coll, config.m), single_rows_bound(dev)
    if rows < bound:
        if verbose:
            print("[debwt-torch] route: single-device fused engine",
                  file=sys.stderr)
        return build_bwt(coll, config, device=dev)
    raise NotImplementedError(
        f"N={coll.bwt_len} needs {rows} sorted rows, over the single-device "
        f"bound of {bound} on {dev} (the engine's 2^29 rows, or what the "
        "card's memory holds); the grouped, out-of-core and multi-device "
        "tiers are not ported yet"
    )
