"""Layout changes between pipeline phases, mirroring opticalflowhs_tpu/dist/reshard.py.

Phases of a video pipeline want different layouts: decode and ingest are
naturally time-sharded (each batch group holds a contiguous run of frames),
the tiled solve is space-sharded. The reference expresses these as
`shard_map` collectives over jax arrays with a sharding. The port's mesh
lives in one process, so a sharded array is explicit here: `Sharded`, one
block a mesh coordinate, each on its mesh device, with its spec (which
mesh axis splits which dimension) and its true shape.

Copy discipline, as the reference's hand-written lowering: a layout change
slices each source block down to what a destination block needs, at the
source, and copies only that slice to the destination's device, so each
device receives only its own slices and no device ever holds the whole
tensor, except through the explicit `Sharded.gather`. Blocks are zero
padded up to the mesh grid, as the reference pads, and the padding is
cropped where the array is gathered.

A dimension the spec does not split is held once, at index 0 of that mesh
axis (the reference replicates it on every device of the axis; in one
process a copy a device buys nothing).

`timesharded_pairs` forms each group's frame pairs: its last pair needs
the next group's first frame, a one-frame temporal halo fetched from that
group's device, and the video's last pair is marked invalid.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from opticalflowhs_tpu_torch.dist.halo import move
from opticalflowhs_tpu_torch.dist.mesh import Mesh
from opticalflowhs_tpu_torch.dist.tiled_solver import Layout, gather, scatter

TIME = ("batch", None, None)
SPACE = (None, "y", "x")


def _spec3(spec: Sequence, rank: int) -> tuple:
    """A spec for an array of `rank` (1-3) as one for its (T, H, W) view:
    the leading entries name "batch" or None, the last two "y"/"x" or None."""
    spec = tuple(spec)
    if len(spec) != rank:
        raise ValueError(f"spec {spec} does not fit an array of rank {rank}")
    full = {1: spec + (None, None), 2: (None,) + spec, 3: spec}[rank]
    for ax, ok in zip(full, ("batch", "y", "x")):
        if ax not in (None, ok):
            raise ValueError(
                f"spec {spec}: a (T, H, W) array splits T over 'batch', H over "
                "'y' and W over 'x' (or leaves a dimension whole with None)"
            )
    return full


def _view3(shape: tuple) -> tuple[int, int, int]:
    """The (T, H, W) view of a rank-1 (T,), rank-2 (H, W) or rank-3 shape."""
    return {1: lambda: (shape[0], 1, 1), 2: lambda: (1,) + shape,
            3: lambda: shape}[len(shape)]()


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _layout_for(mesh: Mesh, spec3: tuple, shape3: tuple) -> Layout:
    """The `Layout` of a (T, H, W) array split by spec3 over the mesh: each
    split dimension zero-padded to the axis size, the others whole."""
    g = mesh.shape["batch"] if spec3[0] else 1
    my = mesh.shape["y"] if spec3[1] else 1
    mx = mesh.shape["x"] if spec3[2] else 1
    t, h, w = shape3
    return Layout(mesh, g, _ceil_div(t, g), _ceil_div(h, my), _ceil_div(w, mx), my, mx)


class Sharded:
    """An array split over a mesh: `blocks` maps each mesh coordinate
    (b, i, j) of the layout to its (bl, th, tw) block on
    mesh.devices[b, i, j]; `spec` says which mesh axis splits which
    dimension (the reference's PartitionSpec entries, None for a whole
    dimension); `shape` is the true shape (rank 1, 2 or 3; blocks hold its
    (T, H, W) view, zero-padded to the mesh grid)."""

    def __init__(self, blocks: dict, layout: Layout, spec: Sequence, shape: Sequence):
        self.blocks, self.layout = blocks, layout
        self.spec, self.shape = tuple(spec), tuple(shape)

    @property
    def mesh(self) -> Mesh:
        return self.layout.mesh

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.blocks.values())).dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def offset(self, c) -> tuple[int, int, int]:
        """Global (t, row, col) of block c's element (0, 0, 0)."""
        r, col = self.layout.origin(c)
        return c[0] * self.layout.bl, r, col

    def local(self, c) -> torch.Tensor:
        """Block c in the array's own rank: (bl,) for rank 1, (th, tw) for
        rank 2, (bl, th, tw) for rank 3."""
        blk = self.blocks[c]
        return {1: lambda: blk[:, 0, 0], 2: lambda: blk[0], 3: lambda: blk}[self.ndim]()

    def gather(self) -> torch.Tensor:
        """The whole array on the mesh's first device (the only copy that
        assembles it)."""
        t, h, w = _view3(self.shape)
        whole = gather(self.blocks, self.layout)[:t, :h, :w]
        return whole.reshape(self.shape)

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, spec={self.spec}, dtype={self.dtype}, "
                f"blocks={len(self.blocks)})")


def shard(x, mesh: Mesh, spec: Sequence) -> Sharded:
    """A whole array (tensor on any device, or numpy) -> `Sharded` by spec:
    each block's slice copied to its device."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    spec3 = _spec3(spec, x.ndim)
    shape3 = _view3(tuple(x.shape))
    lay = _layout_for(mesh, spec3, shape3)
    v = x.reshape(shape3)
    pad = (0, lay.mx * lay.tw - shape3[2], 0, lay.my * lay.th - shape3[1],
           0, lay.groups * lay.bl - shape3[0])
    if any(pad):
        v = torch.nn.functional.pad(v, pad)
    return Sharded(scatter(v, lay), lay, spec, x.shape)


def _span(c, lay: Layout) -> tuple[tuple[int, int], ...]:
    """Block c's global [start, stop) along T, H and W."""
    t0, (r0, c0) = c[0] * lay.bl, lay.origin(c)
    return (t0, t0 + lay.bl), (r0, r0 + lay.th), (c0, c0 + lay.tw)


def _relayout(x: Sharded, mesh: Mesh, spec: Sequence) -> Sharded:
    """x in another layout: each destination block takes, from every source
    block that overlaps it within the true shape, the overlapping slice,
    cut at the source and copied to the destination's device."""
    shape3 = _view3(x.shape)
    lay = _layout_for(mesh, _spec3(spec, x.ndim), shape3)
    src = [(c, _span(c, x.layout)) for c in x.blocks]
    out = {}
    for c in lay.coords:
        dst = torch.zeros((lay.bl, lay.th, lay.tw), dtype=x.dtype, device=mesh.devices[c])
        dspan = _span(c, lay)
        for sc, sspan in src:
            lo = [max(a[0], b[0]) for a, b in zip(dspan, sspan)]
            hi = [min(a[1], b[1], n) for a, b, n in zip(dspan, sspan, shape3)]
            if any(h <= l for l, h in zip(lo, hi)):
                continue
            d = tuple(slice(l - s[0], h - s[0]) for l, h, s in zip(lo, hi, dspan))
            s = tuple(slice(l - s[0], h - s[0]) for l, h, s in zip(lo, hi, sspan))
            move(dst[d], x.blocks[sc][s])
        out[c] = dst
    return Sharded(out, lay, spec, x.shape)


def reshard(x, mesh: Mesh, spec: Sequence) -> Sharded:
    """x in the layout `spec` over `mesh`: a whole array is split
    (`shard`), a `Sharded` one moved block by block. For the batch <-> space
    transition, `time_to_space` and `space_to_time` name the two layouts."""
    if isinstance(x, Sharded):
        return _relayout(x, mesh, spec)
    return shard(x, mesh, spec)


def _as_sharded(frames, mesh: Mesh, spec: tuple) -> Sharded:
    if isinstance(frames, Sharded):
        if frames.spec != spec:
            raise ValueError(f"expected frames sharded as {spec}, got {frames.spec}")
        return frames
    if frames.ndim != 3:
        raise ValueError(f"expected (T, H, W) frames, got {tuple(frames.shape)}")
    return shard(frames, mesh, spec)


def time_to_space(frames, mesh: Mesh) -> Sharded:
    """(T, H, W) frames time-sharded ("batch", None, None) -> space-sharded
    (None, "y", "x"). `frames` is a time-sharded `Sharded`, or a whole
    array that is time-sharded first. Each (y, x) block receives, from
    each batch group's run, only its own spatial slice of that run."""
    return _relayout(_as_sharded(frames, mesh, TIME), mesh, SPACE)


def space_to_time(frames, mesh: Mesh) -> Sharded:
    """(T, H, W) frames space-sharded (None, "y", "x") -> time-sharded
    ("batch", None, None), the inverse of `time_to_space`: each batch
    group receives, from each spatial block, only its run of frames."""
    return _relayout(_as_sharded(frames, mesh, SPACE), mesh, TIME)


def timesharded_pairs(frames: Sharded) -> tuple[Sharded, Sharded, Sharded]:
    """(i1, i2, valid) for time-sharded frames: each batch group's k frames
    give k pairs, pair j = (frame j, frame j + 1) in its own numbering; its
    last pair needs the next group's first frame, the one-frame temporal
    halo, copied from that group's device (zeros after the last group,
    where the video ends). i1 and i2 are time-sharded (T_pad, H, W), valid
    a time-sharded (T_pad,) bool: global pair t is valid when frame t + 1
    exists, t < T - 1 (the reference's rule, which assumes T divides by
    the groups; the padded frames' pairs are invalid too)."""
    if frames.spec != TIME:
        raise ValueError(f"expected frames sharded as {TIME}, got {frames.spec}")
    lay, t_true = frames.layout, frames.shape[0]
    i2, valid = {}, {}
    for g in range(lay.groups):
        c = (g, 0, 0)
        blk = frames.blocks[c]
        halo = torch.zeros_like(blk[:1])
        if g + 1 < lay.groups:
            move(halo, frames.blocks[(g + 1, 0, 0)][:1])
        i2[c] = torch.cat([blk[1:], halo])
        t = g * lay.bl + torch.arange(lay.bl, device=blk.device)
        valid[c] = (t < t_true - 1)[:, None, None]
    n = lay.groups * lay.bl
    vlay = Layout(lay.mesh, lay.groups, lay.bl, 1, 1, 1, 1)
    return (Sharded(dict(frames.blocks), lay, TIME, (n,) + frames.shape[1:]),
            Sharded(i2, lay, TIME, (n,) + frames.shape[1:]),
            Sharded(valid, vlay, ("batch",), (n,)))


def check_sharded(what: str, arrays: Sequence, axis_names: Sequence[str],
                  allowed: Sequence[str]) -> None:
    """The checks of a sum over `Sharded` fields with `axis_names` (the
    port's form of the reference's psum inside shard_map): TypeError
    unless every array is `Sharded`; ValueError unless they share a mesh,
    spec and shape, the names are among `allowed`, and every allowed axis
    that splits them is named (the sums then cover the whole field; a
    "batch" split that is not allowed keeps one result a frame)."""
    for x in arrays:
        if not isinstance(x, Sharded):
            raise TypeError(
                f"{what}: axis_names sums across the shards of a dist.reshard.Sharded "
                f"field (mesh coordinate -> block on its device); got {type(x).__name__}"
            )
    a = arrays[0]
    for b in arrays[1:]:
        if b.mesh is not a.mesh or b.spec != a.spec or b.shape != a.shape:
            raise ValueError(f"{what}: the fields differ in layout: {b!r} is not laid "
                             f"out as {a!r}")
    split = {ax for ax in a.spec if ax is not None}
    needed = split if "batch" in allowed else split - {"batch"}
    if set(axis_names) - set(allowed) or not needed <= set(axis_names):
        raise ValueError(
            f"{what}: axis_names {tuple(axis_names)} must name every mesh axis that "
            f"splits the field {a.spec}, from {tuple(allowed)}"
        )
