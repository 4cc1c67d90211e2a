"""debwt_tpu_torch — the PyTorch/CUDA port of debwt_tpu for one NVIDIA
H100.

It builds the same BWT, byte for byte, as the JAX package (the
reference, which stays unchanged beside it): the BWT of the text
r_0 # r_1 # ... # r_{n-1} $ under lexicographic suffix order over
A < C < G < T < # < $, written in the reference deBWT's on-disk layout.

Layers (the single-device, the grouped, the out-of-core and the
multi-device tier):

  io.fasta / io.writer   ingest with N-policy, reference-format output
  io.native              bindings of the native host helpers: the LF
                         walker (csrc/lf_walk.cpp), the out-of-core
                         binner (csrc/ooc_binner.cpp)
  special                separator-window module (host, NumPy)
  ops                    window keys, lexicographic msort, 2-bit packing
  kernels                hand-written CUDA kernels (csrc/*.cu) with their
                         plain PyTorch versions: window_keys, seg_or
  engine                 fused one-sort classification + SP + blue
  grouped                device-resident grouped tier (key-range groups
                         re-derived from the resident packed text)
  oocore                 out-of-core tier (host-DRAM or disk buckets,
                         checkpoint/resume)
  bluesort               the back half the grouped, out-of-core and
                         multi-device tiers share: SP suffix ranks
                         (sp_ranks) and the blue-entry order (blue_order)
  parallel               multi-device tier over a torch.distributed group:
                         mesh, collectives, dist (dist_build_bwt), sprank
                         (sharded SP ranking, also for ooc x dist)
  count                  (k+1)-mer counting on the device
  verify                 LF-walk invertibility check
  model / transfer_n     NumPy stage model; N-removal prep tool
  pipeline / api / cli   build_bwt, tier routing, command line;
                         pipeline.BwtResult is every tier's result, made
                         by BwtResult.from_bwt6: the 2-bit words on the
                         build's device and the '#'/'$' sidecars
  tracing                one recorder for every tier: profiler spans,
                         stage seconds (timings) and counts (counters)

The package imports torch, numpy and the standard library only.
Entry points run on the CUDA card unless the caller passes
device="cpu".
"""

from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

__version__ = "0.1.0"

__all__ = [
    "PipelineConfig",
    "SequenceCollection",
    "build",
    "build_bwt",
    "BwtResult",
    "count_kmers",
    "read_kmer_dump",
    "OocConfig",
    "build_bwt_ooc",
    "make_mesh",
    "dist_build_bwt",
    "__version__",
]


def __getattr__(name):
    if name in ("build_bwt", "BwtResult"):
        from debwt_tpu_torch import pipeline

        return getattr(pipeline, name)
    if name == "build":
        from debwt_tpu_torch import api

        return api.build
    if name in ("count_kmers", "read_kmer_dump"):
        from debwt_tpu_torch import count

        return getattr(count, name)
    if name in ("make_mesh", "dist_build_bwt"):
        from debwt_tpu_torch import parallel

        return getattr(parallel, name)
    if name in ("OocConfig", "build_bwt_ooc"):
        from debwt_tpu_torch import oocore

        return getattr(oocore, name)
    raise AttributeError(name)
