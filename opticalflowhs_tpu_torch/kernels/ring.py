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
plain torch.

Each ring wraps around (the reference's periodic ring): the top shard's
upper halo is the bottom shard's last rows. Those halo rows lie outside the
image, and true pixels never read them, because the clamps fire at the true
image edges from global coordinates.

A shard may carry a (B, th, tw) stack: image k of every shard forms its own
ring. The reference rounds sigma up to 8 rows and the column halo to 128
columns for the TPU's tiles; here sigma is the fields' own halo (at least
the block's sweeps), and the 2-D column halo is sigma wide.

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

import ctypes
import functools
import struct
from dataclasses import dataclass
from typing import Optional

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

# Most sweeps a K11/K12 sweep block runs: K2's window takes at most 16
# (a 16-row tile), and the fields' halo must be at least as deep.
MAX_RING_SWEEPS = K2_MAX_SWEEPS

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


def _geometry(rings):
    first = rings[0][0][0]
    th, tw = first.u.shape[-2:]
    eh, ew = first.fields[0].shape[-2:]
    sy, sx = (eh - th) // 2, (ew - tw) // 2
    for grid in rings:
        for row in grid:
            for sh in row:
                if sh.u.shape != first.u.shape or any(
                        f.shape[-2:] != (eh, ew) or f.shape[:-2] != sh.u.shape[:-2]
                        for f in sh.fields):
                    raise ValueError("the shards of a ring solve differ in shape")
    if eh != th + 2 * sy or ew != tw + 2 * sx or sy < 1:
        raise ValueError(f"fields {eh}x{ew} must carry an even halo around the "
                         f"{th}x{tw} shard, at least one row deep")
    return th, tw, sy, sx


def _block_sweeps(n_sweeps: int, block_sweeps: int, sy: int, sx: int,
                  cap: Optional[int] = None) -> int:
    """Sweeps a block: block_sweeps, at most n; no deeper than the fields'
    halo, nor than `cap` (the kernels' MAX_RING_SWEEPS)."""
    s = max(1, min(block_sweeps, n_sweeps))
    if s > sy or (sx and s > sx):
        raise ValueError(f"the fields' {sy}-row/{sx}-column halo is narrower "
                         f"than a block of {s} sweeps")
    if cap is not None and s > cap:
        raise ValueError(f"a block of {s} sweeps is deeper than the ring kernels' "
                         f"K2 window takes (at most {cap})")
    return s


def ring_solve_plain(rings, n_sweeps: int, block_sweeps: int, h: int, w: int):
    """The plain version of K11/K12 on a list of rings, each a (y, x) grid
    of `Shard`s: every s sweeps the row halos (sy rows of the upper and
    lower neighbours' owned columns) and, when the fields carry a column
    halo, the column strips of the left and right neighbours' row-extended
    shards; then s masked sweeps over each extended shard. Returns the owned
    (u, v) of every shard, grids like the input."""
    th, tw, sy, sx = _geometry(rings)
    if n_sweeps == 0:
        return [[[(sh.u, sh.v) for sh in row] for row in grid] for grid in rings]
    s = _block_sweeps(n_sweeps, block_sweeps, sy, sx)
    out = []
    for grid in rings:
        my, mx = len(grid), len(grid[0])
        masks = [[stencils.edge_masks(*_ext_grids(sh, th, tw, sy, sx), h, w)
                  for sh in row] for row in grid]
        state = [[(sh.u, sh.v) for sh in row] for row in grid]
        left = n_sweeps
        while left > 0:
            ns = min(s, left)
            ext = []
            for i in range(my):
                ext.append([])
                for j in range(mx):
                    dev = grid[i][j].u.device
                    up, dn = state[(i - 1) % my][j], state[(i + 1) % my][j]
                    ext[i].append(tuple(
                        torch.cat([up[f][..., th - sy:, :].to(dev), state[i][j][f],
                                   dn[f][..., :sy, :].to(dev)], dim=-2)
                        for f in (0, 1)))
            if sx:
                ext = [[tuple(torch.cat([ext[i][(j - 1) % mx][f][..., tw - sx:].to(
                    grid[i][j].u.device), ext[i][j][f], ext[i][(j + 1) % mx][f][..., :sx].to(
                    grid[i][j].u.device)], dim=-1) for f in (0, 1))
                        for j in range(mx)] for i in range(my)]
            for i in range(my):
                for j in range(mx):
                    uu, vv = ext[i][j]
                    for _ in range(ns):
                        uu, vv = stencils.store(stencils.jacobi_step_masked, uu, vv,
                                                *grid[i][j].fields, masks[i][j])
                    state[i][j] = (uu[..., sy:sy + th, sx:sx + tw],
                                   vv[..., sy:sy + th, sx:sx + tw])
            left -= ns
        out.append(state)
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
    then runs one K2 launch's walk (`jacobi.k2_launch_schedule_plain`) over
    the owned rectangle only, with the shards' global origins, into a fresh
    pair that holds the owned pixels and NaN elsewhere: no sweep writes a
    halo. Returns the owned (u, v) of every shard; equal to
    `ring_solve_plain` bitwise (the tests hold it to that). float32 only,
    as `k2_launch_schedule_plain`."""
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
                    new[i, j] = list(k2_launch_schedule_plain(
                        *pairs[i, j], *sh.fields, ns, origins=org, img_hw=(h, w),
                        owned=(sy, sx), window=window, lane_cols=lane_cols,
                        warp_rows=warp_rows))
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
    spilled bytes, resident blocks a multiprocessor, multiprocessors."""
    out = (ctypes.c_int * 8)()
    name = "hs_ring_geometry" + _build.bf16_suffix(dtype)
    err = getattr(_build.library(), name)(
        sweeps, int(two_d), torch.device(device).index or 0,
        ctypes.cast(out, ctypes.POINTER(ctypes.c_int)))
    _build.check(err, name)
    keys = ("tile_h", "tile_w", "threads", "smem_bytes", "registers",
            "spill_bytes", "blocks_per_sm", "sms")
    return dict(zip(keys, list(out)))


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
               blocks: int = 0):
    """K11 (fields without a column halo) or K12 (with one) over a list of
    rings, each a (y, x) grid of `Shard`s of (th, tw) owned tensors or (B,
    th, tw) stacks (image k of every shard forms its own ring), on CPU or
    CUDA devices: one cooperative launch a device for every image it holds,
    `ring_solve_plain` on CPU tensors. `blocks` > 0 forces each launch's
    grid (a grid too large to be resident raises). Returns the owned (u, v)
    of every shard, views of the kernel's pairs. float32 or bfloat16, one
    dtype for every array."""
    th, tw, sy, sx = _geometry(rings)
    shards = [sh for grid in rings for row in grid for sh in row]
    dtype = shards[0].u.dtype
    for sh in shards:
        check_frames("ring_solve", sh.u, sh.v, dtypes=BF16_DTYPES)
        check_frames("ring_solve", *sh.fields, dtypes=BF16_DTYPES)
        if sh.fields[0].device != sh.u.device:
            raise ValueError("a shard's fields lie on another device than its flow")
        if sh.u.dtype != dtype or sh.fields[0].dtype != dtype:
            raise ValueError("the arrays of a ring solve differ in dtype")
    if _device_kind([sh.u for sh in shards]) == "cpu":
        return ring_solve_plain(rings, n_sweeps, block_sweeps, h, w)
    if n_sweeps == 0:
        return [[[(sh.u, sh.v) for sh in row] for row in grid] for grid in rings]
    s = _block_sweeps(n_sweeps, block_sweeps, sy, sx, MAX_RING_SWEEPS)
    n_blocks = -(-n_sweeps // s)
    nb = shards[0].u.shape[0] if shards[0].u.ndim == 3 else 1
    eh, ew = th + 2 * sy, tw + 2 * sx
    own = (slice(sy, sy + th), slice(sx, sx + tw))

    # Per device: its images stacked (shard by shard, a shard's stack in
    # order), the pairs P0 and P1 with the start in P0's owned pixels, the
    # fields, the origin table and the flags.
    local: dict = {}
    for sh in shards:
        local.setdefault(sh.u.device, []).append(sh)
    first: dict = {}
    state: dict = {}
    for dev, members in local.items():
        b = len(members) * nb
        pairs = torch.empty((4, b, eh, ew), dtype=dtype, device=dev)
        for k, sh in enumerate(members):
            first[id(sh)] = k * nb
            pairs[0, k * nb:(k + 1) * nb][(Ellipsis,) + own] = sh.u.reshape(nb, th, tw)
            pairs[1, k * nb:(k + 1) * nb][(Ellipsis,) + own] = sh.v.reshape(nb, th, tw)
        fields = tuple(_stacked([sh.fields[q] for sh in members], (eh, ew)) for q in range(4))
        org = _table([struct.pack(f"<{2 * b}i", *(x for sh in members for _ in range(nb)
                                                  for x in (sh.row0 - sy, sh.col0 - sx)))],
                     dev).view(torch.int32)
        state[dev] = (pairs, fields, org, _flags(dev, _FLAGS_PER_IMAGE * b))
    epoch0 = _EPOCH[0] + 1
    if epoch0 + n_blocks >= 2 ** 63:
        raise RuntimeError("ring epochs exhausted")
    _EPOCH[0] = epoch0 + n_blocks

    def image(sh, q: int, k: int) -> int:
        pairs = state[sh.u.device][0]
        return pairs[q, first[id(sh)] + k].data_ptr()

    def flags(sh, k: int) -> int:
        return state[sh.u.device][3].data_ptr() + 8 * _FLAGS_PER_IMAGE * (first[id(sh)] + k)

    links: dict = {dev: [None] * state[dev][0].shape[1] for dev in local}
    for grid in rings:
        my, mx = len(grid), len(grid[0])
        for i in range(my):
            for j in range(mx):
                sh = grid[i][j]
                nbs = (grid[(i - 1) % my][j], grid[(i + 1) % my][j],
                       grid[i][(j - 1) % mx], grid[i][(j + 1) % mx])
                for n in nbs[:2] + (nbs[2:] if sx else ()):
                    enable_peer(sh.u.device.index, n.u.device.index)
                for k in range(nb):
                    links[sh.u.device][first[id(sh)] + k] = _LINK.pack(
                        *(image(n, q, k) for n in nbs for q in range(4)),
                        *(flags(n, k) for n in nbs), flags(sh, k))
    devices = list(local)
    name = "hs_ring_fused_sweeps" + _build.bf16_suffix(dtype)
    fn = getattr(_build.library(), name)
    th_k, tw_k, _ = k2_tile(s)
    barrier(devices)
    counter = ring_fused_sweeps_2d if sx else ring_fused_sweeps
    for dev in devices:
        pairs, fields, org, _ = state[dev]
        b = pairs.shape[1]
        table = _table(links[dev], dev)
        tiles = b * -(-th // th_k) * -(-tw // tw_k)
        grid_blocks = blocks if blocks > 0 else min(tiles, resident_blocks(dev.index, dtype))
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            table.data_ptr(), org.data_ptr(), *(pairs[q].data_ptr() for q in range(4)),
            *(f.data_ptr() for f in fields), barrier_count(dev.index, stream).data_ptr(),
            b, eh, ew, sy, sx, h, w, n_sweeps, s, epoch0, grid_blocks, dev.index, stream)
        _build.check(err, name)
        counter.launches += 1
    barrier(devices)
    q = 2 if n_blocks % 2 else 0
    out = []
    for grid in rings:
        res = []
        for row in grid:
            cells = []
            for sh in row:
                pairs, k = state[sh.u.device][0], first[id(sh)]
                cells.append(tuple(
                    pairs[q + f, k:k + nb][(Ellipsis,) + own].reshape(sh.u.shape)
                    for f in (0, 1)))
            res.append(cells)
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
