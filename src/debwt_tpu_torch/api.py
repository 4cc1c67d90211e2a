"""Tier routing: one entry point that picks the execution path.

The JAX package covers its envelope with four tiers (single-device
fused engine, grouped device-resident, out-of-core, multi-device). The
port has the first three so far:

  single   fused one-sort engine (pipeline.build_bwt), every collection
           under the single-device row bound; on a CUDA device the bound
           is also what the card's free memory holds
  grouped  device-resident grouped engine (grouped.build_bwt_grouped):
           bounded device memory via key-range groups re-derived from
           the device-resident packed text; N < grouped.MAX_N. Built
           and verified on an H100 80GB up to 600 Mbp (PERF.md); a
           larger N is routed here but has not been measured
  ooc      out-of-core chunked tier (oocore.build_bwt_ooc) with host-DRAM
           buckets, where the grouped tier cannot go: N >= grouped.MAX_N,
           or a single node key that outgrows a group (GroupOverflow).
           Built on the card at 600 Mbp by calling it directly
           (PERF.md); the route from here is exercised by the CPU tests

The multi-device tier is not ported: there is no route to it.
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

# Device bytes one sorted row costs at the peak of a build: the largest
# of the caching allocator's reserved peaks over the rows of the 4.6,
# 140 and 410 Mbp, m = 32 builds (chip_smoke.py's
# peak_reserved_bytes_per_row on an H100 80GB HBM3 at 700 W; see
# PERF.md), rounded up. The three readings it was set from are 169.20,
# 160.91 and 160.58; since engine.segment_facts frees its temporaries
# as it goes they read 134.00, 129.02 and 128.67, and the constant
# keeps the older, larger value. At this rate 2^29 rows need 91.3 GB.
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
    gcfg=None,
    stats: dict | None = None,
) -> BwtResult:
    """Construct the BWT on `device` (the CUDA card by default).

    gcfg (a grouped.GroupedConfig) is handed to the grouped tier when
    the route takes it; stats to the grouped or the out-of-core tier,
    whichever builds. The fused engine reads neither."""
    config = config or PipelineConfig()
    dev = resolve_device(device)
    rows, bound = rows_needed(coll, config.m), single_rows_bound(dev)

    def _say(msg):
        if verbose:
            print(f"[debwt-torch] route: {msg}", file=sys.stderr)

    if rows < bound:
        _say("single-device fused engine")
        return build_bwt(coll, config, device=dev)

    from debwt_tpu_torch.grouped import (
        MAX_N, GroupOverflow, build_bwt_grouped,
    )

    if coll.bwt_len < MAX_N:
        _say(f"grouped device-resident tier (N={coll.bwt_len}, one device)")
        try:
            return build_bwt_grouped(coll, config, gcfg, stats, device=dev)
        except GroupOverflow as e:
            # a single node key outgrew the group cap (pathological
            # repeat mass); the out-of-core tier's giant-run path takes it
            _say(f"grouped tier overflow ({e}); out-of-core fallback")
    _say(f"out-of-core chunked tier (N={coll.bwt_len}, one device)")
    from debwt_tpu_torch.oocore import build_bwt_ooc

    return build_bwt_ooc(coll, config, stats=stats, device=dev)
