"""Moves between the processes of a mesh, on torch.distributed (the port's
counterpart of the cross-process legs that XLA's collectives carry for the
reference under jax.distributed).

The process group's backend chooses how a tensor travels, and nothing
else does: never a fallback after a failure.
  * NCCL: contiguous CUDA tensors go directly, on the current stream (a
    wait on a request makes the stream, not the host, wait).
  * gloo: CPU tensors go directly; a CUDA tensor is staged through a
    pinned host buffer (copied to the host, sent; received, copied to the
    device), the one-card rehearsal of a multi-process run.

`exchange` posts one phase of halo strips as one `batch_isend_irecv`;
`all_to_all` moves the slices of a layout change between processes, as
one exchange; `all_gather_owned` assembles tensors that each process owns
part of; `all_reduce_max` reduces a tensor elementwise over the
processes; `sum_over_processes` adds every process's partial sums in rank
order, so every process gets the same bits. Every
process of the world calls each of them, in the same order. `counts`
adds up what crossed the process boundary from this process, and the
host seconds spent in the exchanges and the gathers (staging copies and
waits included).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

# Bytes this process sent through `exchange`, how many exchanges it posted,
# and the host seconds of the exchanges and of `all_gather_owned` (phase
# 24 of chip_smoke.py reads them; set them to 0 to count).
counts = {"sent_bytes": 0, "exchanges": 0, "exchange_s": 0.0, "gather_s": 0.0}


def _staged(t: torch.Tensor) -> bool:
    """Whether `t` travels through a host buffer: a CUDA tensor in a world
    whose backend does not carry CUDA tensors (gloo)."""
    return t.is_cuda and "nccl" not in dist.get_backend()


def _buffer(likes: Sequence[torch.Tensor]) -> tuple[torch.Tensor, list]:
    """One contiguous buffer for tensors shaped as `likes` (all of one dtype
    and device): pinned host memory when staged, else on their device; and
    a contiguous view of it for each."""
    n = sum(t.numel() for t in likes)
    if _staged(likes[0]):
        flat = torch.empty(n, dtype=likes[0].dtype, pin_memory=True)
    else:
        flat = torch.empty(n, dtype=likes[0].dtype, device=likes[0].device)
    views, o = [], 0
    for t in likes:
        views.append(flat[o:o + t.numel()].view(t.shape))
        o += t.numel()
    return flat, views


def _wires(ts: Sequence[torch.Tensor]) -> list:
    """The contiguous tensors that carry `ts`: views of one pinned host
    buffer filled by one copy (one host sync) when staged, else each tensor
    made contiguous."""
    if not ts or not _staged(ts[0]):
        return [t.contiguous() for t in ts]
    flat, views = _buffer(ts)
    flat.copy_(torch.cat([t.reshape(-1) for t in ts]))
    return views


def _wire(t: torch.Tensor) -> torch.Tensor:
    return _wires([t])[0]


def _land(flat: torch.Tensor, views: list, dsts: Sequence[torch.Tensor]) -> None:
    """Copy received `views` (of `flat`) into `dsts`: a staged buffer goes
    to the device in one copy that the host does not wait for."""
    if flat.is_cuda or not dsts[0].is_cuda:
        for v, d in zip(views, dsts):
            d.copy_(v)
        return
    on_dev = flat.to(dsts[0].device, non_blocking=True)
    o = 0
    for d in dsts:
        d.copy_(on_dev[o:o + d.numel()].view(d.shape))
        o += d.numel()


def exchange(sends: Sequence, recvs: Sequence) -> None:
    """Post every (peer, tag, tensor) send and every (peer, tag, dst) receive
    as one batch, wait for all of them, and copy each received strip into
    its `dst` view. Both sides list the transfers between two processes in
    the same order (NCCL matches them by order, gloo by tag). Staged
    strips leave in one device-to-host copy and arrive in one
    host-to-device copy."""
    if not sends and not recvs:
        return
    t0 = time.perf_counter()
    wires = _wires([t for _, _, t in sends])
    flat, lands = _buffer([d for _, _, d in recvs]) if recvs else (None, [])
    ops = ([dist.P2POp(dist.isend, w, peer, tag=tag) for (peer, tag, _), w in zip(sends, wires)]
           + [dist.P2POp(dist.irecv, buf, peer, tag=tag)
              for (peer, tag, _), buf in zip(recvs, lands)])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if recvs:
        _land(flat, lands, [d for _, _, d in recvs])
    counts["sent_bytes"] += sum(w.numel() * w.element_size() for w in wires)
    counts["exchanges"] += 1
    counts["exchange_s"] += time.perf_counter() - t0


def all_to_all(transfers: Sequence, me: int) -> None:
    """Every (source rank, destination rank, source, destination) of
    `transfers` between two processes, listed in one order by every
    process (its position is its tag): this process sends the source of
    each transfer it is the source of and receives into the destination of
    each it is the destination of, all as one exchange. The other entries
    (None for the tensors this process does not hold) only keep the
    positions; a transfer within one process is the caller's copy."""
    exchange([(d, tag, src) for tag, (s, d, src, _) in enumerate(transfers) if s == me],
             [(s, tag, dst) for tag, (s, d, _, dst) in enumerate(transfers) if d == me])


def sum_over_processes(t: torch.Tensor) -> torch.Tensor:
    """The elementwise sum of `t` over every process, on t's device, the
    same bits on every process: each process's `t` is all-gathered and the
    parts are added in rank order (an all_reduce's order is the
    backend's)."""
    size = dist.get_world_size()
    w = _wire(t)
    bufs = _buffer([t] * size)[1]
    dist.all_gather(bufs, w)
    acc = bufs[0].to(t.device)
    for b in bufs[1:]:
        acc = acc + b.to(t.device)
    return acc


def all_reduce_max(t: torch.Tensor) -> torch.Tensor:
    """The elementwise max of `t` over every process, on t's device."""
    w = _wire(t)
    if w is t:
        w = t.clone()
    dist.all_reduce(w, op=dist.ReduceOp.MAX)
    return w.to(t.device)


def all_gather_owned(items: dict, keys: Sequence, owner: Callable[[object], int],
                     device: torch.device, like: Optional[tuple] = None) -> dict:
    """Every key's tensor on every process: `items` holds this process's
    own tensors (key -> tensor; owner(key) is this rank), all of one shape
    and dtype; the result maps every key in `keys` to its tensor on
    `device` (this process's own stay as they are). `like` is the (shape,
    dtype) of the tensors when every process knows it; without it the
    owners publish theirs first. One broadcast when one process owns every
    key, else one all_gather of each process's tensors, padded to the
    largest count."""
    t0 = time.perf_counter()
    rank, size = dist.get_rank(), dist.get_world_size()
    if size > 1 and any(t.requires_grad for t in items.values()) and torch.is_grad_enabled():
        raise ValueError("a mesh that spans processes does not differentiate: the "
                         "tensors cross the processes outside autograd; call under "
                         "torch.no_grad()")
    by_rank = [[k for k in keys if owner(k) == r] for r in range(size)]
    if like is None:
        mine = next(iter(items.values()), None)
        meta = [None] * size
        dist.all_gather_object(meta, None if mine is None else
                               (tuple(mine.shape), str(mine.dtype).split(".")[-1]))
        shape, dtype = next(m for m in meta if m is not None)
        like = (shape, getattr(torch, dtype))
    shape, dtype = like
    out = {k: items[k] for k in by_rank[rank]}
    n_max = max(len(ks) for ks in by_rank)
    pack = torch.zeros((n_max,) + tuple(shape), dtype=dtype, device=device)
    for q, k in enumerate(by_rank[rank]):
        pack[q].copy_(items[k])
    owners = [r for r in range(size) if by_rank[r]]
    w = _wire(pack)
    if len(owners) == 1:
        dist.broadcast(w, src=owners[0])
        parts = {owners[0]: w}
    else:
        bufs = _buffer([pack] * size)[1]
        dist.all_gather(bufs, w)
        parts = dict(enumerate(bufs))
    for r, ks in enumerate(by_rank):
        if r == rank:
            continue
        for q, k in enumerate(ks):
            out[k] = parts[r][q].to(device, non_blocking=True)
    counts["gather_s"] += time.perf_counter() - t0
    return out
