"""Tier routing: one entry point that picks the execution path.

The JAX package covers its envelope with four tiers, and so does the
port:

  single   fused one-sort engine (pipeline.build_bwt), every collection
           under the single-device row bound; on a CUDA device the bound
           is also what the card's free memory holds
  grouped  device-resident grouped engine (grouped.build_bwt_grouped):
           bounded device memory via key-range groups re-derived from
           the device-resident packed text; N < grouped.MAX_N. Built
           and verified on an H100 80GB up to 3 Gbp (PERF.md); an N
           between that and MAX_N is routed here but not measured
  ooc      out-of-core chunked tier (oocore.build_bwt_ooc) with host-DRAM
           buckets, where the grouped tier cannot go: N >= grouped.MAX_N,
           or a single node key that outgrows a group (GroupOverflow).
           Built on the card at 600 Mbp by calling it directly
           (PERF.md); the route from here is exercised by the CPU tests
  dist     multi-device tier (parallel.dist_build_bwt), one process a
           device over a torch.distributed group: when the caller names
           n_devices, or when the joined group has more than one rank
           and the text is over the single-device bound. The ooc and
           grouped tiers get that group's mesh for sharded SP ranking.

With no process group joined, every route is that of one device. In a
joined group of more than one rank, every route builds on the rank's
own device (parallel.mesh's choice: LOCAL_RANK, else the rank, modulo
the visible cards), the fused engine's too.

Three environment variables steer the route, read on every call as the
JAX package reads them; none can take a tier past what the card holds:

  DEBWT_SINGLE_MAX_ROWS  the fused tier's row bound is the smaller of
                         this and single_rows_bound(device)
  DEBWT_FORCE_OOC=1      skip the grouped tier: what the fused and dist
                         tiers do not take goes out of core
  DEBWT_GROUPED_CAP      the grouped tier's rows a group (grouped.py)
"""

from __future__ import annotations

import os
import sys

import torch
import torch.distributed as tdist

from debwt_tpu_torch import tracing
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
    n_devices: int | None = None,
) -> BwtResult:
    """Construct the BWT on `device` (the CUDA card by default).

    n_devices: build with the multi-device tier over that many ranks
    (the CLI's --dist; more than one needs a joined process group,
    parallel.init_distributed). gcfg (a grouped.GroupedConfig) is handed
    to the grouped tier when the route takes it; stats to the grouped or
    the out-of-core tier, whichever builds. The fused engine and the
    multi-device tier read neither.

    Traced as the span debwt.build, the decision as debwt.route and
    the tier taken as debwt.fused, .grouped, .ooc or .dist
    (tracing.py)."""
    with tracing.span("build"):
        return _route(coll, config or PipelineConfig(), device, verbose,
                      gcfg, stats, n_devices)


def _route(coll, config, device, verbose, gcfg, stats, n_devices):
    world = tdist.get_world_size() if tdist.is_initialized() else 1
    if world > 1:
        # a rank of a joined group builds on its own card on every
        # route (make_mesh's choice, made current as make_mesh does)
        from debwt_tpu_torch.parallel.mesh import _rank_device

        dev = _rank_device(device, tdist.get_rank())
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    else:
        dev = resolve_device(device)

    def _say(msg):
        if verbose:
            print(f"[debwt-torch] route: {msg}", file=sys.stderr)

    if n_devices:
        from debwt_tpu_torch.parallel import dist_build_bwt, make_mesh

        _say(f"distributed over {n_devices} devices (requested)")
        with tracing.span("dist"):
            return dist_build_bwt(coll, config,
                                  make_mesh(n_devices, device=dev))

    with tracing.span("route"):
        rows, bound = rows_needed(coll, config.m), single_rows_bound(dev)
        cap = os.environ.get("DEBWT_SINGLE_MAX_ROWS")
    if rows < (bound if cap is None else min(bound, int(cap))):
        _say("single-device fused engine")
        with tracing.span("fused"):
            return build_bwt(coll, config, device=dev)

    sharded = {}     # the mesh for sharded SP ranking, where there is one
    if world > 1:
        from debwt_tpu_torch.parallel import dist_build_bwt, make_mesh

        sharded["mesh"] = make_mesh(world, device=dev)
        # the dist tier's bound is per shard (shard-local int32 arrays)
        if -(-coll.bwt_len // world) < bound:
            _say(f"distributed over all {world} ranks (N={coll.bwt_len} "
                 "exceeds the single-device bound)")
            with tracing.span("dist"):
                return dist_build_bwt(coll, config, sharded["mesh"])

    from debwt_tpu_torch.grouped import (
        MAX_N, GroupOverflow, build_bwt_grouped,
    )

    if coll.bwt_len < MAX_N and os.environ.get("DEBWT_FORCE_OOC") != "1":
        _say(f"grouped device-resident tier (N={coll.bwt_len}, one device)")
        try:
            with tracing.span("grouped"):
                return build_bwt_grouped(coll, config, gcfg, stats,
                                         device=dev, **sharded)
        except GroupOverflow as e:
            # a single node key outgrew the group cap (pathological
            # repeat mass); the out-of-core tier's giant-run path takes it
            _say(f"grouped tier overflow ({e}); out-of-core fallback")
    _say(f"out-of-core chunked tier (N={coll.bwt_len}, {world} rank(s))")
    from debwt_tpu_torch.oocore import build_bwt_ooc

    with tracing.span("ooc"):
        return build_bwt_ooc(coll, config, stats=stats, device=dev, **sharded)
