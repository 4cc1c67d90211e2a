"""The multi-device tier's mesh: a torch.distributed process group (the
PyTorch counterpart of the JAX package's parallel/mesh.py).

The JAX mesh is one 1-D logical axis "d" over devices that one
controller drives. Here one PROCESS drives one device, and the axis is
the process group: rank r of the group is position r of the axis. The
axis keeps both of its roles:

  * text-parallel: the text is sharded by contiguous position ranges
    (rank r holds [r*Ns, (r+1)*Ns) plus an (m + pad)-wide forward halo);
  * key-parallel: the k-mer/node key space is split by sampled
    splitters, so rank r owns one contiguous key range and therefore
    one contiguous segment of the BWT.

To run N ranks, start N processes, each with

    DEBWT_COORDINATOR    host:port of rank 0 (or a full init URL such as
                         file:///shared/path)
    DEBWT_NUM_PROCESSES  N
    DEBWT_PROCESS_ID     this process's rank, 0 .. N-1

and call init_distributed() (the CLI's --dist does) before make_mesh().
A rank's device is cuda:(LOCAL_RANK, else rank, modulo the visible
cards) unless the caller names one.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from debwt_tpu_torch.pipeline import resolve_device

ENV_VARS = ("DEBWT_COORDINATOR", "DEBWT_NUM_PROCESSES", "DEBWT_PROCESS_ID")

# how long a collective may wait for the other ranks before it raises
TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the 1-D mesh."""

    group: object            # the torch.distributed process group
    rank: int
    n: int                   # ranks in the group (the JAX mesh's size)
    device: torch.device     # the device this rank drives
    backend: str             # "nccl" or "gloo"


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> bool:
    """Join the process group named by the arguments, or by the
    DEBWT_COORDINATOR / DEBWT_NUM_PROCESSES / DEBWT_PROCESS_ID
    variables where an argument is omitted. Returns False (and joins
    nothing) when neither a coordinator nor a process count is given,
    else whether the group has more than one rank. backend: "nccl" (the
    default: ranks on CUDA cards) or "gloo" (ranks on the CPU, or ranks
    that share one card, whose tensors then go through host memory)."""
    coordinator = coordinator or os.environ.get("DEBWT_COORDINATOR")
    if num_processes is None:
        v = os.environ.get("DEBWT_NUM_PROCESSES")
        num_processes = int(v) if v else None
    if process_id is None:
        v = os.environ.get("DEBWT_PROCESS_ID")
        process_id = int(v) if v else None
    if coordinator is None and num_processes is None:
        return False
    missing = [name for name, v in zip(
        ENV_VARS, (coordinator, num_processes, process_id)) if v is None]
    if missing:
        raise ValueError(f"joining a process group needs {', '.join(missing)}")
    url = coordinator if "://" in coordinator else "tcp://" + coordinator
    dist.init_process_group(
        backend or "nccl", init_method=url, world_size=num_processes,
        rank=process_id, timeout=TIMEOUT,
    )
    return dist.get_world_size() > 1


def _rank_device(device, rank: int) -> torch.device:
    """The device rank `rank` drives: `device` when it names one,
    else a CUDA card chosen by the local rank; raises without a card
    unless the caller asked for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """This rank's mesh over the joined process group. With no group
    joined, a one-rank group of this process alone is made (n_devices
    None or 1); more ranks need one process each, joined first by
    init_distributed()."""
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        dev = _rank_device(device, rank)
    else:
        if n_devices not in (None, 1):
            raise ValueError(
                f"a mesh of {n_devices} devices needs one process a device: "
                f"start {n_devices} processes with {', '.join(ENV_VARS)} set "
                "and call init_distributed() in each (the CLI's --dist does)"
            )
        rank, world = 0, 1
        dev = _rank_device(device, 0)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1, timeout=TIMEOUT,
        )
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"requested {n_devices} devices, the process group has {world}"
        )
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(group=dist.group.WORLD, rank=rank, n=world, device=dev,
                backend=dist.get_backend())
