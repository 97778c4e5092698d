"""Halo exchange between the shards of a mesh, mirroring opticalflowhs_tpu/dist/halo.py.

The reference runs inside `shard_map` and moves halos with `lax.ppermute`,
XLA's collective; it has no Pallas kernel here, so plain tensor copies are
the port. A grid is the (y, x) nested list of one batch group's shard
tensors, each (..., th, tw) on its mesh device; a strip moves with `copy_`
from the neighbour's tensor into a view of the padded output.

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


def pad_grid(tiles, sy: int, sx: int, out=None):
    """Each (..., th, tw) shard of the (y, x) grid `tiles` -> (..., th+2sy,
    tw+2sx) with neighbour halos, corners included, written into `out` (a
    grid of views of that shape) or into new tensors; returns the grid. sy
    or sx may be 0 (no exchange along that axis)."""
    my, mx = len(tiles), len(tiles[0])
    th, tw = tiles[0][0].shape[-2:]
    if sy > th or sx > tw:
        raise ValueError(f"halo ({sy}, {sx}) exceeds the {th}x{tw} shard")
    if out is None:
        out = [[torch.empty(t.shape[:-2] + (th + 2 * sy, tw + 2 * sx),
                            dtype=t.dtype, device=t.device) for t in row]
               for row in tiles]
    rows = slice(sy, sy + th)
    # Phase x: the owned rows, with sx columns from the left and right
    # neighbours (the shard's own edge column at the global edge).
    for i in range(my):
        for j in range(mx):
            t, o = tiles[i][j], out[i][j]
            move(o[..., rows, sx:sx + tw], t)
            if not sx:
                continue
            if j > 0:
                move(o[..., rows, :sx], tiles[i][j - 1][..., :, tw - sx:])
            else:
                _replicate(o[..., rows, :sx], t[..., :, :1])
            if j < mx - 1:
                move(o[..., rows, sx + tw:], tiles[i][j + 1][..., :, :sx])
            else:
                _replicate(o[..., rows, sx + tw:], t[..., :, tw - 1:])
    # Phase y: sy rows of the neighbours' column-extended shards.
    if sy:
        for i in range(my):
            for j in range(mx):
                o = out[i][j]
                if i > 0:
                    move(o[..., :sy, :], out[i - 1][j][..., th:th + sy, :])
                else:
                    _replicate(o[..., :sy, :], o[..., sy:sy + 1, :])
                if i < my - 1:
                    move(o[..., sy + th:, :], out[i + 1][j][..., sy:2 * sy, :])
                else:
                    _replicate(o[..., sy + th:, :], o[..., sy + th - 1:sy + th, :])
    if _FAULT_HOOK is not None:
        for row in out:
            for o in row:
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
