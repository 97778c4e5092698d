"""Multi-process entry, mirroring opticalflowhs_tpu/dist/multihost.py: one
process a card, on torch.distributed.

Run one process a card, on every host, with the same command:

    HSFLOW_COORD=10.0.0.2:8476 HSFLOW_NPROC=2 HSFLOW_PROC_ID=$I \\
        python -m opticalflowhs_tpu_torch.dist.multihost -o out.flo ...

`init_multihost()` joins the torch.distributed world (NCCL for a CUDA
device, gloo for the CPU). Afterwards `make_mesh` lays every process's
devices out rank-major, and the same `hs_solve_tiled` /
`hs_pyramid_tiled` call used in one process runs across processes: halo
strips between two processes' shards go as sends and receives, the tiles
are all-gathered, the solve-to-tolerance maxima all-reduced
(dist/transport.py), and every process returns the whole flow.

NCCL refuses two ranks on one card, and so does `init_multihost`, by name
and before any NCCL call; two processes that share a card take
`backend="gloo"`, whose CUDA strips go through pinned host buffers.
`shutdown()` leaves the world (the ring kernels' CUDA IPC arenas first).
"""

from __future__ import annotations

import argparse
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from opticalflowhs_tpu_torch.dist import mesh as mesh_mod
from opticalflowhs_tpu_torch.solver import target_device


def _card_id(dev: torch.device) -> str:
    """A card's identity: its UUID, else its PCI bus id."""
    props = torch.cuda.get_device_properties(dev)
    uuid = getattr(props, "uuid", None)
    if uuid is not None:
        return str(uuid)
    return f"{props.pci_domain_id:04x}:{props.pci_bus_id:02x}:{props.pci_device_id:02x}"


def shared_cards(cards: list[str]) -> Optional[tuple[int, int]]:
    """The first two ranks whose (host, card) entries in `cards` (one a
    rank) are equal, or None."""
    seen: dict = {}
    for r, c in enumerate(cards):
        if c in seen:
            return seen[c], r
        seen[c] = r
    return None


def _refuse_shared_cards(dev: torch.device) -> None:
    """ValueError, before any NCCL call, when another rank of the world uses
    the same card: each rank publishes (host, card) through the process
    group's store and reads every other rank's."""
    store = dist.distributed_c10d._get_default_store()
    rank, size = dist.get_rank(), dist.get_world_size()
    store.set(f"hsflow/card/{rank}", f"{socket.gethostname()}|{_card_id(dev)}")
    cards = [store.get(f"hsflow/card/{r}").decode() for r in range(size)]
    # Every rank has read every card before any rank leaves the world (rank
    # 0 serves the store).
    store.set(f"hsflow/card_read/{rank}", "1")
    store.wait([f"hsflow/card_read/{r}" for r in range(size)])
    pair = shared_cards(cards)
    if pair is not None:
        dist.destroy_process_group()
        raise ValueError(
            f"processes {pair[0]} and {pair[1]} would share card {cards[pair[0]]!r} "
            "under NCCL, which refuses two ranks on one card: give each process its "
            "own card, or pass backend='gloo' (halos staged through the host)"
        )


def init_multihost(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> Optional[torch.device]:
    """Join the torch.distributed world from the arguments or HSFLOW_COORD
    (host:port), HSFLOW_NPROC and HSFLOW_PROC_ID, and return this process's
    device.

    With none of them set and no argument given it does nothing: a world of
    one process (it returns `device`, None when none is given). The device
    is `device`, else cuda:(local rank % the CUDA device count), the local
    rank being HSFLOW_LOCAL_RANK or else the process id; with no CUDA
    device and no device="cpu" it raises RuntimeError. `backend` is "nccl"
    for a CUDA device and "gloo" for the CPU by default; two NCCL ranks on
    one card raise ValueError."""
    coordinator = coordinator or os.environ.get("HSFLOW_COORD")
    num_processes = num_processes or _int_env("HSFLOW_NPROC")
    process_id = process_id if process_id is not None else _int_env("HSFLOW_PROC_ID")
    if coordinator is None and num_processes is None:
        return None if device is None else torch.device(device)
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process run needs the coordinator (host:port), the number of "
            "processes and this process's id: HSFLOW_COORD, HSFLOW_NPROC, HSFLOW_PROC_ID"
        )
    local = _int_env("HSFLOW_LOCAL_RANK")
    local = process_id if local is None else local
    if device is None:
        if not torch.cuda.is_available():
            target_device(None)  # raises the entry points' RuntimeError
        device = torch.device("cuda", local % torch.cuda.device_count())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local % torch.cuda.device_count())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend='nccl' carries CUDA tensors; device {dev} takes 'gloo'")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    if backend == "nccl":
        _refuse_shared_cards(dev)
    mesh_mod._PROCESS_DEVICE = dev
    return dev


def shutdown() -> None:
    """Leave the world: the ring arenas shared through CUDA IPC
    (kernels/ring.py) are unmapped by every process, then freed, and the
    process group is destroyed. Every process calls it."""
    from opticalflowhs_tpu_torch.kernels import ring

    ring.release_arenas(dist.barrier)
    dist.destroy_process_group()


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def main(argv=None) -> int:
    import numpy as np

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frame1")
    p.add_argument("--frame2")
    p.add_argument("--shape", default="2160x3840", help="synthetic HxW if no frames")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--halo-sweeps", type=int, default=4)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--levels", type=int, default=3,
                   help="pyramid levels (1 = single-level tiled solve)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "jnp", "pallas"],
                   help="per-shard sweep backend, the reference's names: auto = the "
                        "tile kernel (K9) on CUDA shards, jnp = plain torch, pallas = "
                        "the kernel")
    p.add_argument("--dist-backend", choices=["nccl", "gloo"],
                   help="torch.distributed backend (default: nccl on CUDA, gloo on "
                        "the CPU; gloo when two processes share a card)")
    p.add_argument("--device", help="this process's device (default: "
                                     "cuda:<local rank %% cards>; cpu for the plain path)")
    p.add_argument("-o", "--output", help=".flo output (process 0 only)")
    args = p.parse_args(argv)

    dev = init_multihost(backend=args.dist_backend, device=args.device)
    dev = target_device(dev)
    world = dist.is_initialized()
    rank = dist.get_rank() if world else 0
    nproc = dist.get_world_size() if world else 1

    from opticalflowhs_tpu_torch.config import _BACKEND_FROM_REFERENCE, HSConfig, PyramidConfig
    from opticalflowhs_tpu_torch.dist import hs_pyramid_tiled, make_mesh
    from opticalflowhs_tpu_torch.dist.mesh import mesh_for_devices
    from opticalflowhs_tpu_torch.egomotion import estimate_egomotion
    from opticalflowhs_tpu_torch.io.host import host_array

    n = nproc  # one device a process
    mesh_cfg = mesh_for_devices(n, batch=args.batch)
    mesh = make_mesh(mesh_cfg, [dev])
    if rank == 0:
        print(f"{nproc} processes, {n} devices, mesh {mesh_cfg.shape}")

    if args.frame1:
        from opticalflowhs_tpu_torch.io.images import load_gray

        i1 = load_gray(args.frame1)
        i2 = load_gray(args.frame2)
    else:
        h, w = (int(t) for t in args.shape.split("x"))
        rng = np.random.default_rng(0)
        i1 = rng.uniform(0, 1, (h, w)).astype(np.float32)
        i2 = np.roll(i1, 2, axis=1)

    cfg = HSConfig(alpha=args.alpha, iters=args.iters,
                   backend=_BACKEND_FROM_REFERENCE[args.backend])
    pyr = PyramidConfig(levels=args.levels)
    flow = hs_pyramid_tiled(i1, i2, cfg, pyr, mesh=mesh, halo_sweeps=args.halo_sweeps)
    em = estimate_egomotion(flow)
    if rank == 0:
        print(
            f"ego-motion: t=({float(em.tx):+.3f}, {float(em.ty):+.3f}) px/frame, "
            f"omega={float(em.omega):+.5f} rad, scale={float(em.scale):+.5f}, "
            f"residual={float(em.residual):.4f}"
        )
        if args.output:
            from opticalflowhs_tpu_torch.io.flo import write_flo

            f = np.stack([host_array(flow.u), host_array(flow.v)], axis=-1)
            write_flo(args.output, f)
            print(f"wrote {args.output}")
    if world:
        shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
