"""Tier routing: one entry point that picks the execution path.

The JAX package covers its envelope with four tiers (single-device
fused engine, grouped device-resident, out-of-core, multi-device). The
port has the first so far: every collection under the single-device
row bound goes to pipeline.build_bwt, and a larger one raises
NotImplementedError naming the tiers still to port.
"""

from __future__ import annotations

import sys

from debwt_tpu_torch.pipeline import MAX_ROWS, BwtResult, build_bwt, rows_needed
from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

# Single-device fused-engine row bound (engine.stage_graph packs
# segment facts beside row indices in int32 scans). The JAX package
# lowers it further for a 16 GB TPU; an 80 GB H100 is not bound below
# it by memory at the sizes measured so far (see PERF.md).
_SINGLE_ROWS = MAX_ROWS


def build(
    coll: SequenceCollection,
    config: PipelineConfig | None = None,
    device=None,
    verbose: bool = False,
) -> BwtResult:
    """Construct the BWT on `device` (the CUDA card by default)."""
    config = config or PipelineConfig()
    if rows_needed(coll, config.m) < _SINGLE_ROWS:
        if verbose:
            print("[debwt-torch] route: single-device fused engine",
                  file=sys.stderr)
        return build_bwt(coll, config, device=device)
    raise NotImplementedError(
        f"N={coll.bwt_len} exceeds the single-device row bound (2^29 "
        "rows); the grouped, out-of-core and multi-device tiers are not "
        "ported yet"
    )
