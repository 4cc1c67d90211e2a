"""Collective building blocks of the multi-device tier (the PyTorch
counterpart of the JAX package's parallel/collectives.py).

| JAX                     | here                                        |
| ----------------------- | ------------------------------------------- |
| pack_by_dest + a2a      | pack_by_dest + a2a (all_to_all_single with  |
|                         | uneven split sizes)                         |
| all_gather              | all_gather; all_gather_ints (host integers) |
| exclusive_scan_i32      | exclusive_scan_i32 (host sums)              |
| psum / pmin             | psum / pmin (all_reduce)                    |
| ppermute                | p2p (batch_isend_irecv)                     |

The JAX exchanges pad every destination to a static power-of-two slot
count and mark pads with a sentinel value. Here only real rows travel:
the split sizes come from an exchanged count vector, so no pad and no
sentinel exists, and within a destination rows keep their source order.
A response that travels back with the split sizes swapped lands at its
source in the order the source sent (the echo pattern).

Host staging: where the group's backend is gloo and a tensor lies on a
CUDA card (two ranks sharing one card), each collective copies it
through host memory explicitly. That follows the backend the caller
chose; it is not a fallback taken after an NCCL error.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from debwt_tpu_torch.parallel.mesh import Mesh


def _staged(mesh: Mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.is_cuda


def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """t as the backend takes it: contiguous, on the host under gloo."""
    return t.contiguous().cpu() if _staged(mesh, t) else t.contiguous()


def pack_by_dest(dest: torch.Tensor, valid: torch.Tensor | None, n: int, *payload):
    """Order rows by destination rank (stable: source order within a
    destination) for a2a. Invalid rows are dropped. Returns (send
    counts as a host list, order, the payload arrays permuted and
    trimmed to the valid rows); order[i] is the source row of sent row
    i."""
    if valid is not None:
        dest = torch.where(valid, dest, n)
    order = torch.sort(dest, stable=True).indices
    counts = torch.bincount(dest, minlength=n + 1)[:n].tolist()
    order = order[: sum(counts)]
    return counts, order, [p[order] for p in payload]


def exchange_counts(mesh: Mesh, send_counts: list) -> list:
    """Rows each rank will receive from every source, given what each
    sends to every destination (one all_to_all of n integers)."""
    t = torch.tensor(send_counts, dtype=torch.int64, device=mesh.device)
    out = torch.empty_like(t)
    wt, wo = _wire(mesh, t), _wire(mesh, out)
    dist.all_to_all_single(wo, wt, group=mesh.group)
    return wo.tolist()


def a2a(mesh: Mesh, x: torch.Tensor, send_counts: list, recv_counts: list):
    """all_to_all over dim 0 with uneven splits: send_counts[d] rows of
    x (in order) go to rank d; the result holds recv_counts[s] rows
    from each source s, sources in rank order."""
    out = x.new_empty((sum(recv_counts),) + tuple(x.shape[1:]))
    wx, wo = _wire(mesh, x), _wire(mesh, out)
    dist.all_to_all_single(wo, wx, recv_counts, send_counts, group=mesh.group)
    return _home(wo, x)


def route(mesh: Mesh, dest, valid, *payload):
    """pack_by_dest + exchange_counts + a2a of every payload array.
    Returns (received payloads, send counts, receive counts, order)."""
    send, order, packed = pack_by_dest(dest, valid, mesh.n, *payload)
    recv = exchange_counts(mesh, send)
    return [a2a(mesh, p, send, recv) for p in packed], send, recv, order


def _home(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return w.to(like.device) if w.device != like.device else w


def all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """(n, *x.shape): every rank's x (one shape on every rank), in rank
    order, on x's device."""
    w = _wire(mesh, x)
    outs = [torch.empty_like(w) for _ in range(mesh.n)]
    dist.all_gather(outs, w, group=mesh.group)
    return _home(torch.stack(outs), x)


def all_gather_ints(mesh: Mesh, values) -> list:
    """Every rank's list of len(values) integers, as host lists in rank
    order (the host waits for them)."""
    t = torch.tensor(list(values), dtype=torch.int64, device=mesh.device)
    return all_gather(mesh, t).tolist()


def exclusive_scan_i32(mesh: Mesh, total: int):
    """(exclusive prefix over the ranks, grand total, every rank's
    value) of a per-rank count that device arrays index as int32 (SP
    events): raises past 2^31. The sums are host integers."""
    allv = [v[0] for v in all_gather_ints(mesh, [total])]
    grand = sum(allv)
    if grand >= 1 << 31:
        raise OverflowError(f"{grand} does not fit the int32 device arrays")
    return sum(allv[: mesh.rank]), grand, allv


def _all_reduce(mesh: Mesh, t: torch.Tensor, op) -> torch.Tensor:
    w = _wire(mesh, t)
    dist.all_reduce(w, op=op, group=mesh.group)
    return _home(w, t)


def psum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    return _all_reduce(mesh, t, dist.ReduceOp.SUM)


def pmin(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    return _all_reduce(mesh, t, dist.ReduceOp.MIN)


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's 1-D x, concatenated in rank order (lengths may
    differ), on x's device."""
    sizes = [v[0] for v in all_gather_ints(mesh, [x.shape[0]])]
    width = max(sizes)
    buf = x.new_zeros(width)
    buf[: x.shape[0]] = x
    outs = all_gather(mesh, buf)
    return torch.cat([o[:s] for o, s in zip(outs, sizes)])


def p2p(mesh: Mesh, sends, recvs) -> None:
    """Point-to-point exchange in one batch: sends is a list of (peer,
    tensor), recvs a list of (peer, tensor) that is filled in place. A
    transfer to this rank itself is a local copy; every rank must post
    the matching half of each transfer."""
    ops, copies = [], []
    own = {p: t for p, t in sends if p == mesh.rank}
    for peer, t in recvs:
        if peer == mesh.rank:
            t.copy_(own.pop(peer))
            continue
        w = t.new_empty(t.shape, device="cpu") if _staged(mesh, t) else t
        if w is not t:
            copies.append((t, w))
        ops.append(dist.P2POp(dist.irecv, w, peer, group=mesh.group))
    for peer, t in sends:
        if peer != mesh.rank:
            ops.append(dist.P2POp(dist.isend, _wire(mesh, t), peer,
                                  group=mesh.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for t, w in copies:
        t.copy_(w)
