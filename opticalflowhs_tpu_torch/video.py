"""Streaming video flow, mirroring opticalflowhs_tpu/video.py (config 4:
HD streaming).

Frames arrive on the host in windows of chunk+1 frames that overlap by
one, so the stream of pairs is seamless. While window k is solved on the
card, window k+1 is already on its way: its frames are copied straight
into pinned host memory (one host copy; no stacked pageable window first)
and sent with a non-blocking copy on a side stream; the compute stream
waits on that copy's event, not the host. A copy from pageable memory
would block the host until the stream drains, stalling the launch
pipeline behind the solve.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Union

import numpy as np
import torch

from opticalflowhs_tpu_torch.batch import check_family, solve_stack
from opticalflowhs_tpu_torch.config import HSConfig, PyramidConfig
from opticalflowhs_tpu_torch.consistency import occlusion_mask
from opticalflowhs_tpu_torch.io.host import host_array
from opticalflowhs_tpu_torch.pyramid import add_flows, hs_pyramid, warp
from opticalflowhs_tpu_torch.solver import Flow, as_frame, hs_solve, target_device

Frames = Union[np.ndarray, torch.Tensor, Iterable[np.ndarray]]


def _chunked_with_overlap(frames: Iterable[np.ndarray], chunk: int):
    """Yield windows of chunk+1 frames overlapping by one frame, as lists
    of (H, W) float32 arrays: the caller stacks each window where it goes."""
    buf: list[np.ndarray] = []
    for f in frames:
        buf.append(np.asarray(f, np.float32))
        if len(buf) == chunk + 1:
            yield buf
            buf = buf[-1:]
    if len(buf) >= 2:
        yield buf


def _prefetched_windows(frames: Frames, chunk: int,
                        device=None) -> Iterator[torch.Tensor]:
    """Yield (chunk+1)-frame float32 windows on the device. Window k+1 is
    staged when the consumer comes back for it, that is after it has
    queued its work on window k, so the host copy and the H2D copy overlap
    that work on the card.

    A (T, H, W) tensor is windowed where it lies. numpy frames (a (T, H, W)
    array or an iterator of (H, W) frames) go to `device`: cuda:0 when it
    is None, and RuntimeError without CUDA."""
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    if isinstance(frames, (np.ndarray, torch.Tensor)) and frames.ndim != 3:
        raise ValueError(f"expected (T, H, W) video, got {tuple(frames.shape)}")
    if isinstance(frames, torch.Tensor):
        frames = as_frame(frames, device)
        for s in range(0, frames.shape[0] - 1, chunk):
            yield frames[s:s + chunk + 1]
        return
    dev = target_device(device)
    windows = _chunked_with_overlap(iter(frames), chunk)
    if dev.type != "cuda":
        for win in windows:
            yield as_frame(np.stack(win), dev)
        return
    copy_stream = torch.cuda.Stream(dev)

    def stage(win):
        host = torch.empty((len(win),) + win[0].shape, dtype=torch.float32,
                           pin_memory=True)
        for k, f in enumerate(win):
            host[k].copy_(torch.from_numpy(f))
        with torch.cuda.stream(copy_stream):
            on_card = host.to(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return host, on_card, done

    nxt = next(windows, None)
    pending = stage(nxt) if nxt is not None else None
    while pending is not None:
        host, cur, done = pending
        compute = torch.cuda.current_stream(dev)
        compute.wait_event(done)
        # `cur` was allocated on the copy stream: keep its memory from
        # being reused while the compute stream still reads it.
        cur.record_stream(compute)
        yield cur
        # The consumer has queued its work on `cur`: stage the next window
        # on the host and the copy engine while the card runs that work.
        nxt = next(windows, None)
        pending = stage(nxt) if nxt is not None else None
        # The pinned buffer must outlive its copy; by now the copy has
        # long finished, so this wait costs nothing in practice.
        done.synchronize()
        del host


def _stream_device(frames, mesh, device):
    """Where numpy windows go: `device`, or the mesh's first device (a
    tensor's windows stay on its device)."""
    if device is None and mesh is not None and not isinstance(frames, torch.Tensor):
        return mesh.first
    return device


def _fits(mesh, n: int):
    """The mesh when its batch axis divides n pairs, else None (unsharded)."""
    if mesh is not None and n % mesh.shape["batch"]:
        return None
    return mesh


def flow_stream(
    frames: Frames,
    cfg: HSConfig = HSConfig(),
    pyr: Optional[PyramidConfig] = None,
    chunk: int = 8,
    mesh=None,
    lk=None,
    tvl1=None,
    device=None,
) -> Iterator[Flow]:
    """Stream dense flow over a video, yielding one batched Flow per chunk:
    a (n, H, W) stack for the window's n <= chunk pairs, on the device. The
    consumer chooses when to synchronise.

    `frames`: a (T, H, W) array or tensor, or an iterator of (H, W) numpy
    frames (what a camera or decoder feed looks like). `lk` / `tvl1`: solve
    with the Lucas-Kanade or TV-L1 family instead of HS (`cfg` is then
    ignored; `pyr` defaults to one level).

    `mesh`: split each chunk's pairs over the mesh's "batch" axis (the
    batched entries' `mesh=`); numpy frames go to the mesh's first device
    when `device` is None. A window whose pairs the batch axis does not
    divide (the stream's remainder) runs unsharded there, as the
    reference's."""
    check_family(lk, tvl1)
    for cur in _prefetched_windows(frames, chunk, _stream_device(frames, mesh, device)):
        n = cur.shape[0] - 1
        yield solve_stack(cur[:-1], cur[1:], cfg, pyr, tvl1, lk, mesh=_fits(mesh, n))


def flow_stream_warm(
    frames: Frames,
    cfg: HSConfig = HSConfig(),
    warm_scale: float = 1.0,
    chunk: int = 8,
    warp_prior: bool = False,
    fused: bool = True,
    device=None,
) -> Iterator[Flow]:
    """Sequential streaming flow with a temporal warm start: each pair's
    solve starts from the previous pair's flow times `warm_scale`. Yields
    one (H, W) Flow per pair. `chunk` only sizes the prefetch windows.

    `warp_prior=True` instead warps frame 2 by that prior, solves for the
    residual from zero and adds the prior back; the first pair, which has
    no prior, bootstraps with a 3-level pyramid (else with hs_solve).
    Composes with cfg.tol.

    `fused` is the reference's switch between one dispatch per window and
    one per pair; both settings run the same per-pair loop here, with
    bitwise equal results."""
    del fused
    prev: Optional[Flow] = None
    for cur in _prefetched_windows(frames, chunk, device):
        k0 = 0
        if prev is None:
            if warp_prior:
                prev = hs_pyramid(cur[0], cur[1], cfg, PyramidConfig(levels=3))
            else:
                prev = hs_solve(cur[0], cur[1], cfg)
            yield prev
            k0 = 1
        for k in range(k0, cur.shape[0] - 1):
            base = Flow(prev.u * warm_scale, prev.v * warm_scale)
            if warp_prior:
                d = hs_solve(cur[k], warp(cur[k + 1], base.u, base.v), cfg)
                prev = add_flows(base, d)
            else:
                prev = hs_solve(cur[k], cur[k + 1], cfg, init=base)
            yield prev


def flow_stream_occlusion(
    frames: Frames,
    cfg: HSConfig = HSConfig(),
    pyr: Optional[PyramidConfig] = None,
    chunk: int = 8,
    a: float = 0.01,
    b: float = 0.5,
    mesh=None,
    lk=None,
    tvl1=None,
    device=None,
) -> Iterator[tuple[Flow, torch.Tensor]]:
    """flow_stream plus per-pair occlusion masks: yields (forward Flow,
    boolean mask) per chunk. Both directions ride one 2n-image solve per
    window, then the forward-backward test (consistency.occlusion_mask)
    runs on the stack; thresholds (a, b) as there. `lk=`, `tvl1=` and
    `mesh=` as in flow_stream (the 2n images split over the batch axis, or
    unsharded when it does not divide them)."""
    check_family(lk, tvl1)
    for cur in _prefetched_windows(frames, chunk, _stream_device(frames, mesh, device)):
        n = cur.shape[0] - 1
        f = solve_stack(torch.cat([cur[:-1], cur[1:]]),
                        torch.cat([cur[1:], cur[:-1]]), cfg, pyr, tvl1, lk,
                        mesh=_fits(mesh, 2 * n))
        fwd = Flow(f.u[:n], f.v[:n])
        bwd = Flow(f.u[n:], f.v[n:])
        yield fwd, occlusion_mask(fwd, bwd, a=a, b=b)


def flow_video(
    frames: Frames,
    cfg: HSConfig = HSConfig(),
    pyr: Optional[PyramidConfig] = None,
    chunk: int = 8,
    mesh=None,
    lk=None,
    tvl1=None,
    device=None,
) -> Flow:
    """Whole video, (T, H, W) frames -> (T-1, H, W) Flow of numpy arrays.
    Each chunk's flow is copied to the host while the next window is
    already on its way, so device memory stays bounded by one window.
    `mesh=` as in flow_stream."""
    us, vs = [], []
    for f in flow_stream(frames, cfg, pyr, chunk, mesh=mesh, lk=lk, tvl1=tvl1,
                         device=device):
        us.append(host_array(f.u))
        vs.append(host_array(f.v))
    return Flow(np.concatenate(us, axis=0), np.concatenate(vs, axis=0))
