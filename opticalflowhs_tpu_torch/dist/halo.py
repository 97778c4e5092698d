"""Halo exchange between the shards of a mesh, mirroring opticalflowhs_tpu/dist/halo.py.

The reference runs inside `shard_map` and moves halos with `lax.ppermute`,
XLA's collective; it has no Pallas kernel here, so plain tensor copies are
the port. A grid is the (y, x) nested list of one batch group's shard
tensors, each (..., th, tw) on its mesh device; a strip moves with `copy_`
from the neighbour's tensor into a view of the padded output. A strip
between shards of two processes (a mesh that spans processes) goes as a
send and a receive through dist/transport.py instead.

The exchange is two-phase, x (columns) first and then y (rows) on the
column-extended shards, so corners arrive without diagonal copies. At the
global image boundary the halo is the shard's own replicated edge, the
clamp of the untiled stencils; a 1 x 1 mesh therefore reproduces the
untiled solve bitwise.

Across devices each copy is ordered explicitly: an event recorded on the
source device's stream, waited on by the destination's (torch's own peer
copy adds its barriers on top). Nothing synchronises the host.
"""

from __future__ import annotations

import torch

from opticalflowhs_tpu_torch.dist import transport

# Fault-injection hook: tests install a halo-corrupting callable (padded
# shard -> padded shard) to check that a bad halo changes the result.
_FAULT_HOOK = None


def set_fault_hook(fn) -> None:
    """Install (or clear, with None) a halo corruption hook for fault tests."""
    global _FAULT_HOOK
    _FAULT_HOOK = fn


def move(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst.copy_(src); across CUDA devices the destination's stream first
    waits for an event recorded on the source's."""
    if src.device != dst.device and src.is_cuda and dst.is_cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(src.device))
        torch.cuda.current_stream(dst.device).wait_event(ev)
    dst.copy_(src)


def _replicate(dst: torch.Tensor, edge: torch.Tensor) -> None:
    dst.copy_(edge.expand(dst.shape))


def _transfer(pairs, src_grid, dst_grid, owner, me: int) -> None:
    """Move each ((si, sj), src index, (di, dj), dst index) strip of `pairs`
    from src_grid's shard to dst_grid's: a copy when this process owns both,
    else this process's side of a send or receive, all posted as one
    exchange (dist/transport.py). Every process lists the same pairs in the
    same order, so a pair's position is its tag."""
    sends, recvs = [], []
    for tag, ((si, sj), sidx, (di, dj), didx) in enumerate(pairs):
        rs, rd = owner(si, sj), owner(di, dj)
        if rs == me and rd == me:
            move(dst_grid[di][dj][didx], src_grid[si][sj][sidx])
        elif rd == me:
            recvs.append((rs, tag, dst_grid[di][dj][didx]))
        elif rs == me:
            sends.append((rd, tag, src_grid[si][sj][sidx]))
    transport.exchange(sends, recvs)


def pad_grid(tiles, sy: int, sx: int, out=None, ranks=None, me: int = 0):
    """Each (..., th, tw) shard of the (y, x) grid `tiles` -> (..., th+2sy,
    tw+2sx) with neighbour halos, corners included, written into `out` (a
    grid of views of that shape) or into new tensors; returns the grid. sy
    or sx may be 0 (no exchange along that axis).

    `ranks` (a (y, x) nested list) names the process that owns each shard
    when the grid spans processes, `me` the calling one; another process's
    shard is None in `tiles` and `out`, and the strips to and from it cross
    through dist/transport.py, each phase one exchange that ends before the
    next phase starts."""
    my, mx = len(tiles), len(tiles[0])
    mine = [(i, j) for i in range(my) for j in range(mx) if tiles[i][j] is not None]
    if not mine:
        return out
    th, tw = tiles[mine[0][0]][mine[0][1]].shape[-2:]
    if sy > th or sx > tw:
        raise ValueError(f"halo ({sy}, {sx}) exceeds the {th}x{tw} shard")
    if out is None:
        out = [[None if t is None else
                torch.empty(t.shape[:-2] + (th + 2 * sy, tw + 2 * sx),
                            dtype=t.dtype, device=t.device) for t in row]
               for row in tiles]

    def owner(i, j):
        return me if ranks is None else ranks[i][j]

    rows, e = slice(sy, sy + th), Ellipsis
    # Phase x: the owned rows, with sx columns from the left and right
    # neighbours (the shard's own edge column at the global edge).
    for i, j in mine:
        t, o = tiles[i][j], out[i][j]
        move(o[..., rows, sx:sx + tw], t)
        if sx and j == 0:
            _replicate(o[..., rows, :sx], t[..., :, :1])
        if sx and j == mx - 1:
            _replicate(o[..., rows, sx + tw:], t[..., :, tw - 1:])
    if sx:
        _transfer([((i, j + dj), (e, slice(None), cols), (i, j), (e, rows, dst))
                   for i in range(my) for j in range(mx)
                   for dj, cols, dst in ((-1, slice(tw - sx, tw), slice(0, sx)),
                                         (1, slice(0, sx), slice(sx + tw, None)))
                   if 0 <= j + dj < mx], tiles, out, owner, me)
    # Phase y: sy rows of the neighbours' column-extended shards.
    if sy:
        for i, j in mine:
            o = out[i][j]
            if i == 0:
                _replicate(o[..., :sy, :], o[..., sy:sy + 1, :])
            if i == my - 1:
                _replicate(o[..., sy + th:, :], o[..., sy + th - 1:sy + th, :])
        _transfer([((i + di, j), (e, src, slice(None)), (i, j), (e, dst, slice(None)))
                   for i in range(my) for j in range(mx)
                   for di, src, dst in ((-1, slice(th, th + sy), slice(0, sy)),
                                        (1, slice(sy, 2 * sy), slice(sy + th, None)))
                   if 0 <= i + di < my], out, out, owner, me)
    if _FAULT_HOOK is not None:
        for i, j in mine:
            o = out[i][j]
            bad = _FAULT_HOOK(o)
            if bad is not o:
                o.copy_(bad)
    return out


def halo_pad(tiles, s: int = 1, out=None):
    """(..., h, w) shards of a (y, x) grid -> (..., h+2s, w+2s) with
    neighbour halos and corners (`pad_grid` with s on both axes)."""
    return pad_grid(tiles, s, s, out)


def unpad(t: torch.Tensor, s: int) -> torch.Tensor:
    """Drop the s-px halo ring: inverse of halo_pad's extension (a view)."""
    return t[..., s:t.shape[-2] - s, s:t.shape[-1] - s]


def replicate_global_edges(tiles, s: int):
    """Re-assert the clamp on the global-boundary halo of padded shards (in
    place on each shard of the grid; returns the grid): the ghost ring at the
    true image boundary takes the current edge row or column. Halos that face
    another shard are left alone."""
    my, mx = len(tiles), len(tiles[0])
    for i in range(my):
        for j in range(mx):
            t = tiles[i][j]
            h2, w2 = t.shape[-2:]
            if i == 0:
                _replicate(t[..., :s, :], t[..., s:s + 1, :])
            if i == my - 1:
                _replicate(t[..., h2 - s:, :], t[..., h2 - s - 1:h2 - s, :])
            if j == 0:
                _replicate(t[..., :, :s], t[..., :, s:s + 1])
            if j == mx - 1:
                _replicate(t[..., :, w2 - s:], t[..., :, w2 - s - 1:w2 - s])
    return tiles
