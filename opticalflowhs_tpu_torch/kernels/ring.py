"""K10-K12: the ring halo exchange, and the whole Jacobi solve of a mesh of
shards with the halo exchange inside the launch.

Port of opticalflowhs_tpu/kernels/rdma_halo.py:
  K10 `ring_halo_exchange`   (`_halo_kernel`): the periodic ring exchange
                             of `halo` rows along y, (h, w) -> (h + 2 halo, w)
  K11 `ring_fused_sweeps`    (`_fused_kernel`): all n sweeps of a
                             row-decomposed ring, a sigma-row u/v halo
                             exchanged with both neighbours every s sweeps
  K12 `ring_fused_sweeps_2d` (`_fused_kernel_2d`): the same on a (y, x)
                             mesh, row strips along y, then column strips
                             along x that carry the fresh corners
The CUDA source is csrc/ring.cu. A device runs one launch for all the shards
it holds, so a virtual mesh of 16 shards on one card is one launch; a shard
on another card is reached by peer stores over NVLink (`enable_peer`, which
raises where the cards cannot reach each other). K11 and K12 run K2's window
loop (csrc/k2_window.cuh) over the owned pixels of every image of a device,
stacked, with the halo exchanged straight into the halo rows and columns of
the neighbours' u/v pairs; `ring_schedule_plain` walks that schedule in
plain torch. A sweep block takes any depth the fields' halo allows, as the
reference's: one deeper than K2's window takes (RING_PASS_SWEEPS) runs as
passes of K2's walk inside the same launch (`ring_passes`).

Each ring wraps around (the reference's periodic ring): the top shard's
upper halo is the bottom shard's last rows. Those halo rows lie outside the
image, and true pixels never read them, because the clamps fire at the true
image edges from global coordinates.

A shard may carry a (B, th, tw) stack: image k of every shard forms its own
ring. The reference rounds sigma up to 8 rows and the column halo to 128
columns for the TPU's tiles; here sigma is the fields' own halo (at least
the block's sweeps), and the 2-D column halo is sigma wide.

Across the processes of one host (a mesh that spans processes) each
process launches K11/K12 on its own shards, and a shard whose neighbour
another process holds stores its halo into that neighbour's pairs and
flags through CUDA IPC: each process's ring buffers of a shape are one
exported arena (csrc/ring.cu), mapped by its neighbours once and kept; the
kernels themselves do not change (their flags are released and acquired
at system scope). The plain versions send those strips between the
processes instead (dist/transport.py).

On CPU tensors the wrappers run the plain versions (the halo as tensor
copies from the neighbours' shards, then masked sweeps over the extended
shard); on CUDA tensors the kernels, or they raise. There is no fallback.
The owned pixels of both are equal bitwise; the halo of the working shard
is discarded.

float32 or bfloat16: the bfloat16 builds (`hs_ring_halo_exchange_bf16`,
`hs_ring_fused_sweeps_bf16`) move 2-byte values and run K2's bfloat16 walk,
with the pairs P0 and P1 in bfloat16; the plain versions copy the same
values and sweep under the storage rule (`stencils.store`: u and v rounded
at the end of every sweep), so the exchange carries rounded values, as the
untiled solve reads them.
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import struct
import time
from dataclasses import dataclass

import torch

from opticalflowhs_tpu_torch.kernels import _build
from opticalflowhs_tpu_torch.kernels.derivatives import BF16_DTYPES, check_frames
from opticalflowhs_tpu_torch.kernels.jacobi import (
    K2_LANE_COLS,
    K2_MAX_SWEEPS,
    K2_WARP_ROWS,
    K2_WINDOW_H,
    K2_WINDOW_W,
    k2_launch_schedule_plain,
    k2_tile,
)
from opticalflowhs_tpu_torch.kernels.solve_fused import barrier_count
from opticalflowhs_tpu_torch.ops import stencils

# Most sweeps one pass of K2's walk runs inside a K11/K12 sweep block: K2's
# 48-row window leaves a 16-row tile at 16. A deeper block runs as passes.
RING_PASS_SWEEPS = K2_MAX_SWEEPS

_PEERS: set = set()
_FLAGS: dict = {}      # device -> persistent int64 epoch flags
_EPOCH = [0]           # last epoch handed out; flags only ever grow


# -- shared helpers --------------------------------------------------------------


def enable_peer(device: int, peer: int) -> None:
    """Let `device`'s kernels store into `peer`'s memory (once per pair);
    raise RuntimeError where the two cards cannot reach each other."""
    if device == peer or (device, peer) in _PEERS:
        return
    err = _build.library().hs_enable_peer(device, peer)
    if err != 0:
        msg = _build.library().hs_error_string(err).decode()
        raise RuntimeError(
            f"cuda:{device} cannot store into cuda:{peer} (peer access: {msg}); "
            "the ring kernels need every pair of neighbouring cards to reach "
            "each other"
        )
    _PEERS.add((device, peer))


def barrier(devices) -> None:
    """Make every CUDA device's current stream wait for the work queued so
    far on each other's: before a launch that stores into other devices'
    buffers (they were allocated on their own streams) and after it (their
    receivers read them)."""
    devs = []
    for d in devices:
        if d.type == "cuda" and d not in devs:
            devs.append(d)
    if len(devs) < 2:
        return
    events = {}
    for d in devs:
        events[d] = torch.cuda.Event()
        events[d].record(torch.cuda.current_stream(d))
    for d in devs:
        stream = torch.cuda.current_stream(d)
        for o in devs:
            if o != d:
                stream.wait_event(events[o])


def _device_kind(tensors) -> str:
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1:
        raise ValueError("the shards of a ring lie on CPU and CUDA devices; "
                         "a mesh takes one kind")
    return kinds.pop()


@functools.lru_cache(maxsize=64)
def _device_bytes(data: bytes, device: torch.device, stream: int) -> torch.Tensor:
    """A small read-only table on `device`, made on the stream whose handle
    is `stream` and read only by launches on it. The 64 most recent tables
    live as long as the process, for reuse: a call whose tables equal an
    earlier one's (the same layout and buffers, as a loop of solves on one
    mesh gets them from the allocator) copies nothing. A new one is copied
    from pageable memory, which waits for the work queued on the stream. The
    stream is part of the key, so an evicted table goes back to the pool of
    the one stream whose launches read it, and is reused only after them."""
    return torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device)


def _table(records: list[bytes], device) -> torch.Tensor:
    """`records` joined, as a table for launches on `device`'s current
    stream."""
    device = torch.device(device)
    return _device_bytes(b"".join(records), device,
                         torch.cuda.current_stream(device).cuda_stream)


# -- K10: the ring halo exchange ------------------------------------------------------


def ring_halo_exchange_plain(tiles, halo: int):
    """Each (..., h, w) shard of a ring (along y, in ring order) -> (..., h +
    2 halo, w): its upper neighbour's last `halo` rows above it, its lower
    neighbour's first rows below it, wrapping around."""
    n = len(tiles)
    out = []
    for i, t in enumerate(tiles):
        up, dn = tiles[(i - 1) % n], tiles[(i + 1) % n]
        out.append(torch.cat([up[..., -halo:, :].to(t.device), t,
                              dn[..., :halo, :].to(t.device)], dim=-2))
    return out


def ring_halo_exchange(tiles, halo: int):
    """K10 over a ring of shards (a sequence along y, each (h, w) or a
    (B, h, w) stack, one shape and one dtype, float32 or bfloat16, on CPU or
    CUDA devices): one launch a device
    reads each row of its shards once and stores it into the shard's own
    output and, for the edge rows, into the neighbours' halos (csrc/ring.cu:
    a block a row, 16-byte streaming copies where the rows allow them);
    `ring_halo_exchange_plain` on CPU tensors. Unlike the reference, any
    halo from 1 to h rows is taken."""
    tiles = list(tiles)
    for t in tiles:
        check_frames("ring_halo_exchange", t, dtypes=BF16_DTYPES)
        if t.shape != tiles[0].shape or t.dtype != tiles[0].dtype:
            raise ValueError("the shards of a ring differ in shape or dtype")
    h, w = tiles[0].shape[-2:]
    if halo < 1:
        raise ValueError(f"halo must be >= 1, got {halo}")
    if halo > h:
        raise ValueError(f"halo {halo} exceeds tile height {h}")
    if _device_kind(tiles) == "cpu":
        return ring_halo_exchange_plain(tiles, halo)
    n = len(tiles)
    nb = tiles[0].shape[0] if tiles[0].ndim == 3 else 1
    outs = [torch.empty(t.shape[:-2] + (h + 2 * halo, w), dtype=t.dtype,
                        device=t.device) for t in tiles]
    size = tiles[0].element_size()
    src_px, out_px = h * w * size, (h + 2 * halo) * w * size
    per_device: dict = {}
    for i, t in enumerate(tiles):
        up, dn = (i - 1) % n, (i + 1) % n
        dev = t.device.index
        for peer in (tiles[up].device.index, tiles[dn].device.index):
            enable_peer(dev, peer)
        for k in range(nb):
            per_device.setdefault(t.device, []).append(struct.pack(
                "<4Q", t.data_ptr() + k * src_px, outs[i].data_ptr() + k * out_px,
                outs[up].data_ptr() + k * out_px, outs[dn].data_ptr() + k * out_px))
    devices = list(per_device)
    barrier(devices)
    name = "hs_ring_halo_exchange" + _build.bf16_suffix(tiles[0].dtype)
    fn = getattr(_build.library(), name)
    for dev, recs in per_device.items():
        table = _table(recs, dev)
        err = fn(table.data_ptr(), len(recs), h, w, halo, dev.index,
                 torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, name)
        ring_halo_exchange.launches += 1
    barrier(devices)
    return outs


ring_halo_exchange.launches = 0


# -- K11 / K12: the fused ring solve ----------------------------------------------------


@dataclass
class Shard:
    """One shard of a ring solve: its owned start (th, tw), the four fields
    of the extended shard (th + 2 sy, tw + 2 sx), and the global (row, col)
    of owned pixel (0, 0)."""

    u: torch.Tensor
    v: torch.Tensor
    fields: tuple
    row0: int
    col0: int = 0


@dataclass(frozen=True)
class RemoteShard:
    """A shard of a ring that another process of the world holds (a mesh
    that spans processes): its owner's rank, its device in the owner's
    numbering, the shape of its owned u ((th, tw) or (B, th, tw)), its
    fields' (th + 2 sy, tw + 2 sx) and its dtype. Every process lists the
    same rings, so a shard's place in its owner's stack on its device is
    its position among that owner's shards of the device in ring order
    (the tiled solver's rings are in coordinate order, the order of every
    process's stacks): no index crosses the processes."""

    rank: int
    device: torch.device
    shape: tuple
    ext: tuple
    dtype: torch.dtype


def _dims(sh) -> tuple[tuple, tuple, torch.dtype]:
    """A shard's owned shape, its fields' last two dimensions and its
    dtype, whichever process holds it."""
    if isinstance(sh, Shard):
        return tuple(sh.u.shape), tuple(sh.fields[0].shape[-2:]), sh.u.dtype
    return tuple(sh.shape), tuple(sh.ext), sh.dtype


def _cells(rings) -> list:
    return [sh for grid in rings for row in grid for sh in row]


def _geometry(rings):
    shape, (eh, ew), _ = _dims(_cells(rings)[0])
    th, tw = shape[-2:]
    sy, sx = (eh - th) // 2, (ew - tw) // 2
    for sh in _cells(rings):
        if _dims(sh)[:2] != (shape, (eh, ew)) or isinstance(sh, Shard) and any(
                f.shape[-2:] != (eh, ew) or f.shape[:-2] != sh.u.shape[:-2]
                for f in sh.fields):
            raise ValueError("the shards of a ring solve differ in shape")
    if eh != th + 2 * sy or ew != tw + 2 * sx or sy < 1:
        raise ValueError(f"fields {eh}x{ew} must carry an even halo around the "
                         f"{th}x{tw} shard, at least one row deep")
    return th, tw, sy, sx


def _block_sweeps(n_sweeps: int, block_sweeps: int, sy: int, sx: int) -> int:
    """Sweeps a block: block_sweeps, at most n; no deeper than the fields'
    halo (the reference's rule)."""
    s = max(1, min(block_sweeps, n_sweeps))
    if s > sy or (sx and s > sx):
        raise ValueError(f"the fields' {sy}-row/{sx}-column halo is narrower "
                         f"than a block of {s} sweeps")
    return s


def ring_passes(s: int) -> list[int]:
    """The sweeps of each pass of K2's walk in a K11/K12 sweep block of s
    (csrc/ring.cu `ring_passes`): one pass up to RING_PASS_SWEEPS; deeper,
    the fewest passes, every pass but the first of q sweeps, q the multiple
    of 4 nearest s / passes (raised where the first would exceed
    RING_PASS_SWEEPS), and the first the rest. Pass p then walks the owned
    rectangle grown by the sweeps still to come, a multiple of 4: the
    columns keep their 16-byte alignment."""
    n = -(-s // RING_PASS_SWEEPS)
    if n == 1:
        return [s]
    near = (s + 2 * n) // (4 * n) * K2_LANE_COLS
    least = -(-(-(-(s - RING_PASS_SWEEPS) // (n - 1))) // K2_LANE_COLS) * K2_LANE_COLS
    q = min(max(near, least), RING_PASS_SWEEPS)
    return [s - (n - 1) * q] + [q] * (n - 1)


def _grown(s: int):
    """(sweeps, rows of halo the rectangle is grown by) of each pass of a
    sweep block of s."""
    left = s
    for d in ring_passes(s):
        left -= d
        yield d, left


def ring_barriers(n_sweeps: int, s: int, two_d: bool) -> int:
    """Grid barriers of one K11 (K12: two_d) launch of n sweeps in blocks
    of s: one after each pass but the launch's last, and on K12 one after
    each block's exchange."""
    blocks = [s] * (n_sweeps // s) + ([n_sweeps % s] if n_sweeps % s else [])
    return sum(len(ring_passes(k)) + int(two_d) for k in blocks) - 1


def ring_tiles(b: int, th: int, tw: int, two_d: bool, n_sweeps: int, s: int) -> int:
    """Most K2 tiles a pass of a launch walks over b images of th x tw
    owned pixels (the full blocks' and the remainder's passes): the grid
    that keeps every block busy."""
    most = 0
    for k in {s, n_sweeps % s} - {0}:
        for d, r in _grown(k):
            kth, ktw, _ = k2_tile(d)
            most = max(most, b * -(-(th + 2 * r) // kth)
                       * -(-(tw + (2 * r if two_d else 0)) // ktw))
    return most


def _owned(rings) -> list:
    """The (u, v) start of every shard this process holds, None for the
    others', grids like the input."""
    return [[[(sh.u, sh.v) if isinstance(sh, Shard) else None for sh in row]
             for row in grid] for grid in rings]


def _fetch(grid, items, shape, dtype) -> dict:
    """For each (key, destination cell, source cell, cut) of `items`, listed
    in one order by every process, whose destination this process holds:
    cut(source cell), the strip, on the destination's device, a copy when
    this process holds the source too, else received from its owner; the
    strips of the sources this process holds go to the other processes'
    destinations. The strips between processes travel as one exchange
    (dist/transport.py), a strip's position in `items` its tag; `shape`
    and `dtype` are a strip's."""
    got, sends, recvs = {}, [], []
    for tag, (key, d, s, cut) in enumerate(items):
        dst, src = grid[d[0]][d[1]], grid[s[0]][s[1]]
        if isinstance(dst, Shard):
            if isinstance(src, Shard):
                got[key] = cut(s).to(dst.u.device)
            else:
                got[key] = torch.empty(shape, dtype=dtype, device=dst.u.device)
                recvs.append((src.rank, tag, got[key]))
        elif isinstance(src, Shard):
            sends.append((dst.rank, tag, cut(s)))
    if sends or recvs:
        from opticalflowhs_tpu_torch.dist import transport

        transport.exchange(sends, recvs)
    return got


def ring_solve_plain(rings, n_sweeps: int, block_sweeps: int, h: int, w: int):
    """The plain version of K11/K12 on a list of rings, each a (y, x) grid
    of `Shard`s: every s sweeps the row halos (sy rows of the upper and
    lower neighbours' owned columns) and, when the fields carry a column
    halo, the column strips of the left and right neighbours' row-extended
    shards; then s masked sweeps over each extended shard. Returns the owned
    (u, v) of every shard, grids like the input.

    Across processes (a mesh that spans them) a grid holds `RemoteShard`s
    where another process holds the shard: every process calls with the
    same rings, the halo strips between two processes' shards cross as
    sends and receives in the kernels' schedule (each phase one exchange),
    and the result holds None where the shard is another process's."""
    th, tw, sy, sx = _geometry(rings)
    if n_sweeps == 0:
        return _owned(rings)
    s = _block_sweeps(n_sweeps, block_sweeps, sy, sx)
    shape, _, dtype = _dims(_cells(rings)[0])
    lead = shape[:-2]
    out = []
    for grid in rings:
        my, mx = len(grid), len(grid[0])
        cells = [(i, j) for i in range(my) for j in range(mx)]
        mine = [c for c in cells if isinstance(grid[c[0]][c[1]], Shard)]
        masks = {c: stencils.edge_masks(*_ext_grids(grid[c[0]][c[1]], th, tw, sy, sx), h, w)
                 for c in mine}
        state = {c: (grid[c[0]][c[1]].u, grid[c[0]][c[1]].v) for c in mine}
        left = n_sweeps
        while left > 0:
            ns = min(s, left)
            rows = _fetch(grid, [
                ((c, side, f), c, nb, lambda src, f=f, cut=cut: cut(state[src][f]))
                for c in cells
                for side, nb, cut in ((0, ((c[0] - 1) % my, c[1]), lambda t: t[..., th - sy:, :]),
                                      (1, ((c[0] + 1) % my, c[1]), lambda t: t[..., :sy, :]))
                for f in (0, 1)], lead + (sy, tw), dtype)
            ext = {c: tuple(torch.cat([rows[c, 0, f], state[c][f], rows[c, 1, f]], dim=-2)
                            for f in (0, 1)) for c in mine}
            if sx:
                cols = _fetch(grid, [
                    ((c, side, f), c, nb, lambda src, f=f, cut=cut: cut(ext[src][f]))
                    for c in cells
                    for side, nb, cut in ((0, (c[0], (c[1] - 1) % mx), lambda t: t[..., tw - sx:]),
                                          (1, (c[0], (c[1] + 1) % mx), lambda t: t[..., :sx]))
                    for f in (0, 1)], lead + (th + 2 * sy, sx), dtype)
                ext = {c: tuple(torch.cat([cols[c, 0, f], ext[c][f], cols[c, 1, f]], dim=-1)
                                for f in (0, 1)) for c in mine}
            for c in mine:
                uu, vv = ext[c]
                for _ in range(ns):
                    uu, vv = stencils.store(stencils.jacobi_step_masked, uu, vv,
                                            *grid[c[0]][c[1]].fields, masks[c])
                state[c] = (uu[..., sy:sy + th, sx:sx + tw], vv[..., sy:sy + th, sx:sx + tw])
            left -= ns
        out.append([[state.get((i, j)) for j in range(mx)] for i in range(my)])
    return out


def _ext_grids(sh: Shard, th: int, tw: int, sy: int, sx: int):
    dev = sh.u.device
    gr = sh.row0 - sy + torch.arange(th + 2 * sy, device=dev)[:, None]
    gc = sh.col0 - sx + torch.arange(tw + 2 * sx, device=dev)[None, :]
    return gr, gc


def ring_schedule_plain(rings, n_sweeps: int, block_sweeps: int, h: int, w: int,
                        window=(K2_WINDOW_H, K2_WINDOW_W), lane_cols: int = K2_LANE_COLS,
                        warp_rows: int = K2_WARP_ROWS):
    """K11's and K12's schedule in plain torch, on the rings of
    `ring_solve_plain`: each shard's u/v lives in an extended pair, NaN where
    nothing was written. Each sweep block first exchanges into the pairs
    (phase R: the sy edge rows of the owned columns of the upper and lower
    neighbours' pairs; phase C, with a column halo: the full-height column
    strips of the left and right neighbours' pairs, row halos included),
    then runs one K2 launch's walk (`jacobi.k2_launch_schedule_plain`) a
    pass (`ring_passes`): pass p over the owned rectangle grown by the
    sweeps still to come (the last pass over the owned rectangle only),
    with the shards' global origins, into a fresh pair that holds what it
    wrote and NaN elsewhere: the last pass writes no halo. Returns the owned
    (u, v) of every shard; equal to `ring_solve_plain` bitwise (the tests
    hold it to that). float32 only, as `k2_launch_schedule_plain`."""
    th, tw, sy, sx = _geometry(rings)
    if n_sweeps == 0:
        return [[[(sh.u, sh.v) for sh in row] for row in grid] for grid in rings]
    s = _block_sweeps(n_sweeps, block_sweeps, sy, sx)
    own = (Ellipsis, slice(sy, sy + th), slice(sx, sx + tw))
    out = []
    for grid in rings:
        my, mx = len(grid), len(grid[0])
        pairs = {}
        for i in range(my):
            for j in range(mx):
                sh = grid[i][j]
                pair = []
                for a in (sh.u, sh.v):
                    p = torch.full(a.shape[:-2] + (th + 2 * sy, tw + 2 * sx), float("nan"),
                                   dtype=a.dtype, device=a.device)
                    p[own] = a
                    pair.append(p)
                pairs[i, j] = pair
        left = n_sweeps
        while left > 0:
            ns = min(s, left)
            for i in range(my):
                for j in range(mx):
                    up, dn = pairs[(i - 1) % my, j], pairs[(i + 1) % my, j]
                    for f in (0, 1):
                        p = pairs[i, j][f]
                        p[..., :sy, sx:sx + tw] = up[f][..., th:th + sy, sx:sx + tw].to(p.device)
                        p[..., sy + th:, sx:sx + tw] = dn[f][..., sy:2 * sy, sx:sx + tw].to(
                            p.device)
            if sx:
                for i in range(my):
                    for j in range(mx):
                        lt, rt = pairs[i, (j - 1) % mx], pairs[i, (j + 1) % mx]
                        for f in (0, 1):
                            p = pairs[i, j][f]
                            p[..., :sx] = lt[f][..., tw:tw + sx].to(p.device)
                            p[..., sx + tw:] = rt[f][..., sx:2 * sx].to(p.device)
            new = {}
            for i in range(my):
                for j in range(mx):
                    sh = grid[i][j]
                    nb = sh.u.shape[0] if sh.u.ndim == 3 else 1
                    org = [(sh.row0 - sy, sh.col0 - sx)] * nb
                    pair = pairs[i, j]
                    for d, r in _grown(ns):
                        pair = list(k2_launch_schedule_plain(
                            *pair, *sh.fields, d, origins=org, img_hw=(h, w),
                            owned=(sy - r, sx - r if sx else 0), window=window,
                            lane_cols=lane_cols, warp_rows=warp_rows))
                    new[i, j] = pair
            pairs = new
            left -= ns
        out.append([[tuple(a[own] for a in pairs[i, j]) for j in range(mx)]
                    for i in range(my)])
    return out


@functools.cache
def resident_blocks(device: int, dtype=torch.float32) -> int:
    """The most K11/K12 blocks of the build for `dtype` resident at once on
    `device` (one an SM): the size of a cooperative grid."""
    out = ctypes.c_int(0)
    name = "hs_ring_blocks" + _build.bf16_suffix(dtype)
    err = getattr(_build.library(), name)(device, ctypes.byref(out))
    _build.check(err, name)
    return out.value


def ring_geometry(device, sweeps: int = 8, two_d: bool = False,
                  dtype=torch.float32) -> dict:
    """K11's (two_d=True: K12's; dtype=torch.bfloat16: the bfloat16 build's)
    build at `sweeps` on a CUDA device, as `solve_fused.build_geometry`
    reports K6's: K2's tile, threads, shared bytes, registers a thread,
    spilled bytes, resident blocks a multiprocessor, multiprocessors. Above
    RING_PASS_SWEEPS the deep kernel's build, with the tile of its passes
    of `ring_passes(sweeps)[-1]` sweeps."""
    out = (ctypes.c_int * 8)()
    name = "hs_ring_geometry" + _build.bf16_suffix(dtype)
    err = getattr(_build.library(), name)(
        sweeps, int(two_d), torch.device(device).index or 0,
        ctypes.cast(out, ctypes.POINTER(ctypes.c_int)))
    _build.check(err, name)
    keys = ("tile_h", "tile_w", "threads", "smem_bytes", "registers",
            "spill_bytes", "blocks_per_sm", "sms")
    return dict(zip(keys, list(out)))


def epoch_mark() -> int:
    """The mark above which this process hands out ring epochs: a solve of
    k sweep blocks that starts after it exchanges at epochs mark + 1 ..
    mark + k (across processes, above every process's mark)."""
    return _EPOCH[0]


def released_epoch(device) -> int:
    """The highest epoch any exchange has released into the flags of this
    process's images on `device` (its own flags and its arenas'): after a
    solve, the epoch of its last sweep block."""
    device = torch.device(device)
    bufs = [f for d, f in _FLAGS.items() if d == device]
    # An arena of 1 x 1 images is the IPC probe's (a ring's fields carry a
    # halo): its flags hold the probe's values, not epochs.
    bufs += [a.flags for a in _ARENAS.values()
             if a.device == device and a.pairs.shape[-2:] != (1, 1)]
    return max((int(f.max()) for f in bufs), default=0)


def _flags(device: torch.device, n: int) -> torch.Tensor:
    """n int64 epoch flags on `device`, kept from call to call: epochs only
    grow, so a flag never needs a reset."""
    buf = _FLAGS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int64, device=device)
        _FLAGS[device] = buf
    return buf


_FLAGS_PER_IMAGE = 8   # [phase: rows, columns][parity][side]
# csrc/ring.cu RingLink: the (0, 0) of each neighbour's image (up, down,
# left, right) in P0 u, P0 v, P1 u, P1 v; the neighbours' flags; my flags.
_LINK = struct.Struct("<21Q")


# -- K11/K12 across processes: ring arenas shared through CUDA IPC -------------------
#
# A process's ring buffers of one shape on one device (the pairs P0 and P1,
# (4, b, eh, ew), and b images' flags) are one cudaMalloc arena
# (csrc/ring.cu's hs_ipc_*), exported once; every process maps its neighbours' arenas
# once and keeps the mappings, so a solve opens and closes no handle. The
# arenas and mappings go at `release_arenas` (dist.multihost.shutdown, or
# the process's exit).

_ARENAS: dict = {}     # (device, b, eh, ew, dtype) -> this process's _Arena
_MAPPED: dict = {}     # (local device, rank, device, b, eh, ew, dtype) -> address
_SHARED: set = set()   # the calls' layouts whose handles every process has
_PROBE = [0]           # the IPC probe's flag values handed out
# Arenas this process exported, handles it opened, and handle exchanges
# (all_gather_object calls): set them to 0 to count.
ipc_counts = {"exported": 0, "opened": 0, "exchanges": 0}


class _Memory:
    """Device memory the library allocated, as torch takes it
    (__cuda_array_interface__, no stream to wait for)."""

    def __init__(self, ptr: int, shape: tuple, typestr: str):
        self.__cuda_array_interface__ = {"shape": tuple(shape), "typestr": typestr,
                                         "data": (ptr, False), "strides": None,
                                         "version": 2}


def _device_view(ptr: int, shape: tuple, dtype, device) -> torch.Tensor:
    """A tensor over `shape` elements of `dtype` at `ptr` on `device`, which
    owns nothing (the arena outlives it)."""
    typestr = {torch.float32: "<f4", torch.bfloat16: "<i2", torch.int64: "<i8"}[dtype]
    t = torch.as_tensor(_Memory(ptr, shape, typestr), device=device)
    return t.view(dtype)


def _arena_layout(b: int, eh: int, ew: int, dtype) -> tuple[int, int, int]:
    """An arena's bytes a pair plane (b images), its flags' offset and its
    size: the four planes as torch lays out a (4, b, eh, ew) tensor, then
    _FLAGS_PER_IMAGE int64 flags an image, 256-byte aligned."""
    plane = b * eh * ew * dtype.itemsize
    flags = -(-4 * plane // 256) * 256
    return plane, flags, flags + 8 * _FLAGS_PER_IMAGE * b


class _Arena:
    """This process's ring buffers of one shape on one device, exported."""

    def __init__(self, device: torch.device, b: int, eh: int, ew: int, dtype):
        lib = _build.library()
        _, flags, size = _arena_layout(b, eh, ew, dtype)
        n = ctypes.c_int(0)
        _build.check(lib.hs_ipc_handle_bytes(ctypes.byref(n)), "hs_ipc_handle_bytes")
        ptr, handle = ctypes.c_void_p(), ctypes.create_string_buffer(n.value)
        _build.check(lib.hs_ipc_alloc(device.index, size, ctypes.byref(ptr), handle),
                     "hs_ipc_alloc")
        self.device, self.ptr, self.handle = device, ptr.value, handle.raw
        self.pairs = _device_view(self.ptr, (4, b, eh, ew), dtype, device)
        self.flags = _device_view(self.ptr + flags, (_FLAGS_PER_IMAGE * b,), torch.int64,
                                  device)
        ipc_counts["exported"] += 1


def _arena(device: torch.device, b: int, eh: int, ew: int, dtype) -> _Arena:
    key = (device, b, eh, ew, dtype)
    if key not in _ARENAS:
        _ARENAS[key] = _Arena(device, b, eh, ew, dtype)
    return _ARENAS[key]


def _share_arenas(layout: tuple, mine: dict, needed: dict, eh: int, ew: int, dtype) -> None:
    """Make every remote arena in `needed` ((rank, device, b) -> the local
    device that maps it) mapped: the first call of a layout (every
    process's (rank, device, b), the same tuple on every process) exchanges
    the handles of `mine` ((device, b) -> _Arena) through all_gather_object
    and opens the neighbours' that are not mapped yet; a later call of it
    exchanges and opens nothing."""
    import torch.distributed as dist

    if layout in _SHARED:
        return
    lists = [None] * dist.get_world_size()
    dist.all_gather_object(lists, {(str(d), b): a.handle for (d, b), a in mine.items()})
    ipc_counts["exchanges"] += 1
    lib = _build.library()
    for (rank, dev, b), local in needed.items():
        key = (local, rank, str(dev), b, eh, ew, dtype)
        if key in _MAPPED:
            continue
        ptr = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(lists[rank][(str(dev), b)])
        _build.check(lib.hs_ipc_open(local.index, handle, ctypes.byref(ptr)), "hs_ipc_open")
        _MAPPED[key] = ptr.value
        ipc_counts["opened"] += 1
    _SHARED.add(layout)


def release_arenas(between=None) -> None:
    """Unmap every neighbour's arena, call `between` (dist.multihost.shutdown
    passes the world's barrier, so no arena is freed while another process
    still maps it), and free this process's; at the end of a world and at
    exit. No solve may run on them any more. A failed unmap or free raises,
    after the barrier (so it strands no other process) and after every
    other release was tried.

    An arena is kept for each (device, b, eh, ew, dtype) a ring solve
    across processes met, outside torch's caching allocator, until this
    call: the memory held grows with the number of distinct shapes (each
    level of a tiled pyramid is one)."""
    lib = _build.library() if _ARENAS or _MAPPED else None
    errs = [(lib.hs_ipc_close(key[0].index, ctypes.c_void_p(ptr)), "hs_ipc_close")
            for key, ptr in _MAPPED.items()]
    if between is not None:
        between()
    errs += [(lib.hs_ipc_free(a.device.index, ctypes.c_void_p(a.ptr)), "hs_ipc_free")
             for a in _ARENAS.values()]
    _MAPPED.clear()
    _ARENAS.clear()
    _SHARED.clear()
    for err, name in errs:
        _build.check(err, name)


atexit.register(release_arenas)


def _sync_processes(devices) -> None:
    """Every local device's work done, then every process of the world at
    this point: a neighbour's pairs hold their start before any launch
    stores into them, and no arena is reused while a neighbour still
    stores into it."""
    import torch.distributed as dist

    for d in devices:
        torch.cuda.synchronize(d)
    dist.barrier()


def ipc_round_trip(device, rounds: int = 20) -> float:
    """Seconds a round trip of the ring kernels' flag protocol takes between
    the two processes of a world of two (both call it): each holds one
    8-byte flag in an exported arena, maps the other's, and
    csrc/ring.cu's probe (hs_ipc_ping_pong) releases and acquires them `rounds` times (rank 0
    starts). Timed on the host from a barrier to the probe's end."""
    import torch.distributed as dist

    if dist.get_world_size() != 2:
        raise ValueError("the IPC probe runs between the two processes of a world of two")
    device = torch.device(device)
    rank = dist.get_rank()
    devs = [None, None]
    dist.all_gather_object(devs, str(device))
    mine = _arena(device, 1, 1, 1, torch.float32)
    _share_arenas(("probe", tuple(devs)), {(device, 1): mine},
                  {(1 - rank, devs[1 - rank], 1): device}, 1, 1, torch.float32)
    theirs = _MAPPED[(device, 1 - rank, devs[1 - rank], 1, 1, 1, torch.float32)]
    flag = _arena_layout(1, 1, 1, torch.float32)[1]
    # Both flags hold at most the last probe's values: every process starts
    # above the largest base handed out.
    base = _agree_max(_PROBE[0], device)
    _PROBE[0] = base + 2 * rounds
    lib = _build.library()
    _sync_processes([device])
    t0 = time.perf_counter()
    err = lib.hs_ipc_ping_pong(mine.flags.data_ptr(), theirs + flag, rounds, int(rank == 0),
                               base, device.index, torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "hs_ipc_ping_pong")
    torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    dist.barrier()
    return dt / rounds


def _agree_max(value: int, device) -> int:
    """The largest of every process's `value` (dist.transport.all_reduce_max
    on `device`)."""
    from opticalflowhs_tpu_torch.dist import transport

    return int(transport.all_reduce_max(torch.tensor([value], dtype=torch.int64,
                                                     device=device))[0])


def _stacked(parts: list, hw) -> torch.Tensor:
    """One device's per-shard tensors, in its image order, as one (B, h, w)
    stack: the tensor they are consecutive slices of when they are (the
    tiled solver builds its fields stacked per device), the one part itself,
    or else a copy."""
    if len(parts) == 1:
        return parts[0].reshape((-1,) + tuple(hw))
    base = parts[0]._base
    if base is not None and base.is_contiguous() and base.numel() == sum(
            p.numel() for p in parts):
        at = base.data_ptr()
        for p in parts:
            if p._base is not base or p.data_ptr() != at:
                break
            at += p.numel() * p.element_size()
        else:
            return base.view((-1,) + tuple(hw))
    return torch.cat([p.reshape((-1,) + tuple(hw)) for p in parts])


def ring_solve(rings, n_sweeps: int, block_sweeps: int, h: int, w: int,
               blocks: int = 0, collective: bool = False):
    """K11 (fields without a column halo) or K12 (with one) over a list of
    rings, each a (y, x) grid of `Shard`s of (th, tw) owned tensors or (B,
    th, tw) stacks (image k of every shard forms its own ring), on CPU or
    CUDA devices: one cooperative launch a device for every image it holds,
    `ring_solve_plain` on CPU tensors. `blocks` > 0 forces each launch's
    grid (a grid too large to be resident raises). Returns the owned (u, v)
    of every shard, views of the kernel's pairs. float32 or bfloat16, one
    dtype for every array. A sweep block deeper than RING_PASS_SWEEPS runs
    as `ring_passes` passes in the same launch, the passes but the last
    through a scratch pair of each device's stack allocated here.

    Across processes of one host (`collective`: a mesh that spans them,
    `RemoteShard`s where another process holds a shard; every process of
    the world calls with the same rings, also one that holds every shard
    or none) each process launches on its own shards, with its pairs and
    flags in its exported arena (`_Arena`) and a remote neighbour's
    entries of the link table its mapped arena's addresses; every process
    takes the same epochs, and the processes meet (a device sync and a
    barrier) before the launches and after them. The result holds None
    where the shard is another process's, and copies of the owned pixels
    (the arena is reused by the next call)."""
    th, tw, sy, sx = _geometry(rings)
    cells = _cells(rings)
    shards = [sh for sh in cells if isinstance(sh, Shard)]
    # Whether the processes meet is the mesh's to say, not this process's
    # shards: one that holds all or none of them still takes part.
    if len(shards) < len(cells) and not collective:
        raise ValueError("a ring with shards of other processes takes collective=True")
    shape, _, dtype = _dims(cells[0])
    for sh in shards:
        check_frames("ring_solve", sh.u, sh.v, dtypes=BF16_DTYPES)
        check_frames("ring_solve", *sh.fields, dtypes=BF16_DTYPES)
        if sh.fields[0].device != sh.u.device:
            raise ValueError("a shard's fields lie on another device than its flow")
        if sh.u.dtype != dtype or sh.fields[0].dtype != dtype:
            raise ValueError("the arrays of a ring solve differ in dtype")
    kinds = {sh.u.device.type if isinstance(sh, Shard) else sh.device.type for sh in cells}
    if len(kinds) != 1:
        raise ValueError("the shards of a ring lie on CPU and CUDA devices; "
                         "a mesh takes one kind")
    if kinds == {"cpu"}:
        return ring_solve_plain(rings, n_sweeps, block_sweeps, h, w)
    if n_sweeps == 0:
        return _owned(rings)
    s = _block_sweeps(n_sweeps, block_sweeps, sy, sx)
    n_blocks = -(-n_sweeps // s)
    nb = shape[0] if len(shape) == 3 else 1
    eh, ew = th + 2 * sy, tw + 2 * sx
    own = (slice(sy, sy + th), slice(sx, sx + tw))
    me = 0
    if collective:
        import torch.distributed as dist

        me = dist.get_rank()

    # Every shard's place, derived alike by every process: its owner and
    # device, and its index in that device's stack (ring order).
    slot: dict = {}
    count: dict = {}
    for sh in cells:
        key = (me, sh.u.device) if isinstance(sh, Shard) else (sh.rank, sh.device)
        slot[id(sh)] = (key, count.get(key, 0))
        count[key] = count.get(key, 0) + 1

    # Per device: its images stacked (shard by shard, a shard's stack in
    # order), the pairs P0 and P1 with the start in P0's owned pixels, the
    # fields, the origin table and the flags.
    local: dict = {}
    for sh in shards:
        local.setdefault(sh.u.device, []).append(sh)
    first: dict = {}
    state: dict = {}
    arenas: dict = {}
    for dev, members in local.items():
        b = len(members) * nb
        if collective:
            arenas[dev, b] = _arena(dev, b, eh, ew, dtype)
            pairs, flags_buf = arenas[dev, b].pairs, arenas[dev, b].flags
        else:
            pairs = torch.empty((4, b, eh, ew), dtype=dtype, device=dev)
            flags_buf = _flags(dev, _FLAGS_PER_IMAGE * b)
        for k, sh in enumerate(members):
            first[id(sh)] = k * nb
            pairs[0, k * nb:(k + 1) * nb][(Ellipsis,) + own] = sh.u.reshape(nb, th, tw)
            pairs[1, k * nb:(k + 1) * nb][(Ellipsis,) + own] = sh.v.reshape(nb, th, tw)
        fields = tuple(_stacked([sh.fields[q] for sh in members], (eh, ew)) for q in range(4))
        org = _table([struct.pack(f"<{2 * b}i", *(x for sh in members for _ in range(nb)
                                                  for x in (sh.row0 - sy, sh.col0 - sx)))],
                     dev).view(torch.int32)
        state[dev] = (pairs, fields, org, flags_buf)

    def neighbours(grid, i, j):
        my, mx = len(grid), len(grid[0])
        nbs = (grid[(i - 1) % my][j], grid[(i + 1) % my][j],
               grid[i][(j - 1) % mx], grid[i][(j + 1) % mx])
        return nbs if sx else nbs[:2]

    if collective:
        # The remote neighbours' arenas, mapped once (on the device of the
        # local shard that stores into them); the same epochs everywhere.
        needed = {}
        for grid in rings:
            for i, row in enumerate(grid):
                for j, sh in enumerate(row):
                    if isinstance(sh, Shard):
                        for n in neighbours(grid, i, j):
                            if not isinstance(n, Shard):
                                needed.setdefault((n.rank, n.device, count[n.rank, n.device] * nb),
                                                  sh.u.device)
        layout = (eh, ew, dtype, tuple(sorted((r, str(d), c * nb)
                                              for (r, d), c in count.items())))
        _share_arenas(layout, arenas, needed, eh, ew, dtype)
        dev0 = next(iter(local)) if local else torch.device("cuda", torch.cuda.current_device())
        epoch0 = _agree_max(_EPOCH[0], dev0) + 1
    else:
        epoch0 = _EPOCH[0] + 1
    if epoch0 + n_blocks >= 2 ** 63:
        raise RuntimeError("ring epochs exhausted")
    _EPOCH[0] = epoch0 + n_blocks
    plane, flags_off, _ = _arena_layout(1, eh, ew, dtype)  # the bytes of one image

    def image(sh, q: int, k: int) -> int:
        if isinstance(sh, Shard):
            pairs = state[sh.u.device][0]
            return pairs[q, first[id(sh)] + k].data_ptr()
        (rank, dev), idx = slot[id(sh)]
        b = count[rank, dev] * nb
        return remote_base(sh) + (q * b + idx * nb + k) * plane

    def flags(sh, k: int) -> int:
        if isinstance(sh, Shard):
            return (state[sh.u.device][3].data_ptr()
                    + 8 * _FLAGS_PER_IMAGE * (first[id(sh)] + k))
        (rank, dev), idx = slot[id(sh)]
        b = count[rank, dev] * nb
        return (remote_base(sh) + _arena_layout(b, eh, ew, dtype)[1]
                + 8 * _FLAGS_PER_IMAGE * (idx * nb + k))

    def remote_base(sh) -> int:
        return _MAPPED[(mapped_on[id(sh)], sh.rank, str(sh.device),
                        count[sh.rank, sh.device] * nb, eh, ew, dtype)]

    mapped_on: dict = {}  # a remote neighbour -> the local device it is mapped on
    links: dict = {dev: [None] * state[dev][0].shape[1] for dev in local}
    for grid in rings:
        for i, row in enumerate(grid):
            for j, sh in enumerate(row):
                if not isinstance(sh, Shard):
                    continue
                nbs = neighbours(grid, i, j)
                for n in nbs:
                    if isinstance(n, Shard):
                        enable_peer(sh.u.device.index, n.u.device.index)
                    else:
                        mapped_on[id(n)] = needed[n.rank, n.device,
                                                  count[n.rank, n.device] * nb]
                nbs = nbs + (sh, sh) if len(nbs) == 2 else nbs  # K11: no left or right
                for k in range(nb):
                    links[sh.u.device][first[id(sh)] + k] = _LINK.pack(
                        *(image(n, q, k) for n in nbs for q in range(4)),
                        *(flags(n, k) for n in nbs), flags(sh, k))
    devices = list(local)
    name = "hs_ring_fused_sweeps" + _build.bf16_suffix(dtype)
    fn = getattr(_build.library(), name)
    # A block deeper than one pass of K2's walk: the scratch pair Q of the
    # passes but the last, each device's own (never in an arena).
    deep = s > RING_PASS_SWEEPS
    scratch = {dev: tuple(torch.empty(state[dev][0].shape[1:], dtype=dtype, device=dev)
                          for _ in range(2)) if deep else (None, None)
               for dev in devices}
    if collective:
        _sync_processes(devices)
    else:
        barrier(devices)
    counter = ring_fused_sweeps_2d if sx else ring_fused_sweeps
    for dev in devices:
        pairs, fields, org, _ = state[dev]
        b = pairs.shape[1]
        table = _table(links[dev], dev)
        grid_blocks = blocks if blocks > 0 else min(ring_tiles(b, th, tw, bool(sx), n_sweeps, s),
                                                    resident_blocks(dev.index, dtype))
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            table.data_ptr(), org.data_ptr(), *(pairs[q].data_ptr() for q in range(4)),
            *(None if a is None else a.data_ptr() for a in scratch[dev]),
            *(f.data_ptr() for f in fields), barrier_count(dev.index, stream).data_ptr(),
            b, eh, ew, sy, sx, h, w, n_sweeps, s, epoch0, grid_blocks, dev.index, stream)
        _build.check(err, name)
        counter.launches += 1
    if collective:
        _sync_processes(devices)
    else:
        barrier(devices)
    q = 2 if n_blocks % 2 else 0
    out = []
    for grid in rings:
        res = []
        for row in grid:
            cells_out = []
            for sh in row:
                if not isinstance(sh, Shard):
                    cells_out.append(None)
                    continue
                pairs, k = state[sh.u.device][0], first[id(sh)]
                got = tuple(pairs[q + f, k:k + nb][(Ellipsis,) + own].reshape(sh.u.shape)
                            for f in (0, 1))
                cells_out.append(tuple(t.clone() for t in got) if collective else got)
            res.append(cells_out)
        out.append(res)
    return out


def _as_rings_1d(u, v, fields, row0):
    return [[[Shard(u[i], v[i], tuple(fields[i]), int(row0[i]), 0)] for i in range(len(u))]]


def ring_fused_sweeps_plain(u, v, fields, n_sweeps: int, block_sweeps: int, row0,
                            h: int, w: int):
    """The plain version of K11 on one row-decomposed ring: u, v sequences
    (ring order along y) of (th, w) shards or stacks, `fields` their
    (exh, eyh, eth, invdh) with a sigma-row halo, `row0` the global row of
    each shard's owned row 0. Returns lists of the owned u and v. On the
    1-shard ring this is the reference's `ring_fused_sweeps_logic_twin`."""
    res = ring_solve_plain(_as_rings_1d(u, v, fields, row0), n_sweeps,
                           block_sweeps, h, w)[0]
    return [r[0][0] for r in res], [r[0][1] for r in res]


def ring_fused_sweeps(u, v, fields, n_sweeps: int, block_sweeps: int, row0,
                      h: int, w: int, blocks: int = 0):
    """K11 on one row-decomposed ring (arguments as
    `ring_fused_sweeps_plain`): one launch a device, all n sweeps, a halo
    exchanged every `block_sweeps`; the plain version on CPU tensors."""
    if any(f.shape[-1] != u[0].shape[-1] for fs in fields for f in fs):
        raise ValueError("K11's fields carry a row halo only; use ring_fused_sweeps_2d")
    res = ring_solve(_as_rings_1d(u, v, fields, row0), n_sweeps, block_sweeps,
                     h, w, blocks)[0]
    return [r[0][0] for r in res], [r[0][1] for r in res]


def _as_rings_2d(u, v, fields, origins):
    return [[[Shard(u[i][j], v[i][j], tuple(fields[i][j]), int(origins[i][j][0]),
                    int(origins[i][j][1])) for j in range(len(u[0]))]
             for i in range(len(u))]]


def ring_fused_sweeps_2d_plain(u, v, fields, n_sweeps: int, block_sweeps: int,
                               origins, h: int, w: int):
    """The plain version of K12 on one (y, x) mesh: u, v (y, x) grids of
    (th, tw) shards or stacks, `fields` a grid of 4-tuples with a sigma-row
    and sigma-column halo, `origins` a grid of the global (row, col) of each
    owned (0, 0). Returns grids of the owned u and v."""
    res = ring_solve_plain(_as_rings_2d(u, v, fields, origins), n_sweeps,
                           block_sweeps, h, w)[0]
    return ([[c[0] for c in row] for row in res], [[c[1] for c in row] for row in res])


def ring_fused_sweeps_2d(u, v, fields, n_sweeps: int, block_sweeps: int, origins,
                         h: int, w: int, blocks: int = 0):
    """K12 on one (y, x) mesh (arguments as `ring_fused_sweeps_2d_plain`):
    one launch a device; the plain version on CPU tensors."""
    if any(f.shape[-1] == u[0][0].shape[-1] for row in fields for fs in row for f in fs):
        raise ValueError("K12's fields carry a column halo too; use ring_fused_sweeps")
    res = ring_solve(_as_rings_2d(u, v, fields, origins), n_sweeps, block_sweeps,
                     h, w, blocks)[0]
    return ([[c[0] for c in row] for row in res], [[c[1] for c in row] for row in res])


# Launches: K11 on ring_fused_sweeps, K12 on ring_fused_sweeps_2d, whichever
# entry (or ring_solve) made them.
ring_fused_sweeps.launches = 0
ring_fused_sweeps_2d.launches = 0
