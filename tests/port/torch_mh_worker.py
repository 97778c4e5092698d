"""One rank of tests/port/test_torch_multihost.py's torch.distributed worlds
(not collected: run as `python torch_mh_worker.py GROUP RANK WORLD RENDEZVOUS
OUTDIR`). gloo on the CPU, one thread, a file:// rendezvous. It imports
neither jax nor the reference package.

Groups:
  two   2 processes x 4 CPU shards: the (1, 2, 4) mesh, whose "y" boundary
        lies between the processes (the reference's mh_worker.py case:
        32x64 uniform frames from default_rng(0), alpha 0.5, i16, halo
        sweeps 2), with Jacobi, the L2 pyramid, to tolerance, SOR, bfloat16;
        a B=2 stack on a (2, 1, 2) mesh and a (1, 1, 4) mesh of 2 shards a
        process (the batch and the "x" boundary between the processes); a
        pair to tolerance on the (2, 1, 2) mesh (rank 1 owns no shard); the
        fault hook on rank 1; halo_impl="rdma" (the plain ring) on the
        (1, 2, 4) mesh in float32 and bfloat16, on a (1, 4, 1) mesh of 2
        shards a process, for a pair on the (2, 1, 2) mesh (rank 1 owns
        no shard), with sweep blocks of 20 (i45) on a (1, 1, 2) mesh and,
        padded as the reference pads it, a 10 x 64 crop on the (1, 4, 1)
        mesh at s 3 (rank 1's shards wholly below h);
        time_to_space / space_to_time of 5 x 12 x 20
        frames (default_rng(2)) on (2, 2, 2), split by batch, and
        timesharded_pairs on (2, 1, 1); the axis_names sums on (1, 2, 4).
  four  4 processes x 1 shard: the (1, 2, 2) mesh, both axes between the
        processes: Jacobi, a robust pair and a multigrid stack through the
        GSPMD routes, lk_solve_tiled, rdma in float32 and bfloat16, the
        axis_names sums.

Each case writes every rank's tiled flow and rank 0's untiled flow as
(2, ...) .npy files (u, v; bfloat16 widened, which is exact) and the mesh's
ranks as JSON; the layout changes every rank's gathered arrays and owned
blocks (.npz), the sums every rank's values (JSON).
"""

import sys

sys.modules["jax"] = None
sys.modules["opticalflowhs_tpu"] = None

import json  # noqa: E402
import os  # noqa: E402

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..")))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)

group, rank, world, rdv, out = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                                sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank, world_size=world)

from opticalflowhs_tpu_torch import (  # noqa: E402
    HSConfig,
    LKConfig,
    MeshConfig,
    PyramidConfig,
    hs_pyramid,
    hs_solve,
    hs_solve_batched,
    lk_solve,
)
from opticalflowhs_tpu_torch.dist import halo, hs_pyramid_tiled, hs_solve_tiled, make_mesh  # noqa: E402
from opticalflowhs_tpu_torch.dist import multihost, reshard  # noqa: E402
from opticalflowhs_tpu_torch.egomotion import estimate_egomotion  # noqa: E402
from opticalflowhs_tpu_torch.io.host import host_array  # noqa: E402
from opticalflowhs_tpu_torch.lucas_kanade import lk_solve_tiled  # noqa: E402
from opticalflowhs_tpu_torch.metrics import hs_energy  # noqa: E402
from opticalflowhs_tpu_torch.solver import Flow  # noqa: E402

CPU = torch.device("cpu")
meshes = {}


def frames(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))
                 for _ in range(2))


def save(case, mesh, tiled, untiled):
    np.save(os.path.join(out, f"{case}_tiled_r{rank}.npy"),
            np.stack([host_array(tiled.u), host_array(tiled.v)]))
    if rank == 0:
        np.save(os.path.join(out, f"{case}_untiled.npy"),
                np.stack([host_array(untiled.u), host_array(untiled.v)]))
        meshes[case] = mesh.ranks.tolist()
    assert tiled.u.device == CPU and tiled.u.dtype == untiled.u.dtype


def rdma(mesh, tag):
    """halo_impl="rdma" (the plain ring, its halos sent between the
    processes) against the untiled entry; `tag` "_bf16" in bfloat16."""
    c = HSConfig(alpha=0.5, iters=16, dtype="bfloat16" if tag == "_bf16" else "float32")
    save("rdma" + tag, mesh, hs_solve_tiled(i1, i2, c, mesh, halo_sweeps=2, halo_impl="rdma"),
         hs_solve(i1, i2, c))


def relayout(case, mesh, wholes, *arrays):
    """A layout change's gathered arrays and this rank's blocks."""
    blocks = {f"{k}_{'_'.join(map(str, c))}": x.blocks[c].numpy()
              for k, x in enumerate(arrays) for c in x.blocks}
    np.savez(os.path.join(out, f"{case}_r{rank}.npz"),
             **{k: v.numpy() for k, v in wholes.items()}, **blocks)
    if rank == 0:
        meshes[case] = mesh.ranks.tolist()


def sums(mesh):
    """estimate_egomotion and hs_energy with axis_names over the mesh's
    shards of an untiled flow, every rank's values and rank 0's
    whole-array ones."""
    flow = hs_solve(i1, i2, cfg)
    spec = ("y", "x")
    su, sv = reshard.shard(flow.u, mesh, spec), reshard.shard(flow.v, mesh, spec)
    f1, f2 = reshard.shard(i1, mesh, spec), reshard.shard(i2, mesh, spec)
    got = {"egomotion": [float(x) for x in estimate_egomotion(Flow(su, sv), axis_names=spec)],
           "energy": [float(hs_energy(f1, f2, Flow(su, sv), alpha=cfg.alpha, axis_names=spec))],
           "whole_egomotion": [float(x) for x in estimate_egomotion(flow)],
           "whole_energy": [float(hs_energy(i1, i2, flow, alpha=cfg.alpha))]}
    with open(os.path.join(out, f"sums_r{rank}.json"), "w") as f:
        json.dump(got, f)


i1, i2 = frames((32, 64), 0)
cfg = HSConfig(alpha=0.5, iters=16)

if group == "two":
    m124 = make_mesh(MeshConfig(batch=1, y=2, x=4), [CPU] * 4)
    save("jacobi", m124, hs_solve_tiled(i1, i2, cfg, m124, halo_sweeps=2), hs_solve(i1, i2, cfg))
    pyr = PyramidConfig(levels=2)
    save("pyramid", m124, hs_pyramid_tiled(i1, i2, cfg, pyr, m124, halo_sweeps=2),
         hs_pyramid(i1, i2, cfg, pyr))
    # To tolerance the untiled solve checks every block_sweeps sweeps, the
    # tiled one every halo block: the same cadence gives the same stop (at
    # sweep 58 of the budget of 100 on these frames).
    tol = HSConfig(alpha=0.5, iters=100, tol=1e-3)
    save("tol", m124, hs_solve_tiled(i1, i2, tol, m124, halo_sweeps=2),
         hs_solve(i1, i2, HSConfig(alpha=0.5, iters=100, tol=1e-3, block_sweeps=2)))
    sor = HSConfig(alpha=0.5, iters=16, solver="sor", omega=1.7)
    save("sor", m124, hs_solve_tiled(i1, i2, sor, m124, halo_sweeps=2), hs_solve(i1, i2, sor))
    b16 = HSConfig(alpha=0.5, iters=16, dtype="bfloat16")
    save("bf16", m124, hs_solve_tiled(i1, i2, b16, m124, halo_sweeps=2), hs_solve(i1, i2, b16))
    s1, s2 = frames((2, 32, 64), 1)
    m212 = make_mesh(MeshConfig(batch=2, y=1, x=2), [CPU] * 2)
    save("stack", m212, hs_solve_tiled(s1, s2, cfg, m212, halo_sweeps=2),
         hs_solve_batched(s1, s2, cfg))
    # A pair on the (2, 1, 2) mesh takes the first batch group only: rank 1
    # owns no shard and still takes part in every exchange and reduction.
    save("idle", m212, hs_solve_tiled(i1, i2, tol, m212, halo_sweeps=2),
         hs_solve(i1, i2, HSConfig(alpha=0.5, iters=100, tol=1e-3, block_sweeps=2)))
    m114 = make_mesh(MeshConfig(batch=1, y=1, x=4), [CPU] * 2)
    save("x", m114, hs_solve_tiled(i1, i2, cfg, m114, halo_sweeps=2), hs_solve(i1, i2, cfg))
    # Rank 1 corrupts its shards' top halo rows, which came from rank 0.
    if rank == 1:
        halo.set_fault_hook(lambda t: torch.cat([t[..., :2, :] + 1.0, t[..., 2:, :]], -2))
    bad = hs_solve_tiled(i1, i2, cfg, m124, halo_sweeps=2)
    halo.set_fault_hook(None)
    save("fault", m124, bad, hs_solve(i1, i2, cfg))
    rdma(m124, "")
    rdma(m124, "_bf16")
    m141 = make_mesh(MeshConfig(batch=1, y=4, x=1), [CPU] * 2)
    rdma(m141, "_k11")
    rdma(m212, "_idle")  # rank 0 owns every shard of the pair, rank 1 none
    # A 10 x 64 crop on the (1, 4, 1) mesh at s 3: its mesh-grid tiles of 3
    # rows are refused, so rdma pads it as the reference (tiles of 8 rows);
    # rank 1's two shards lie wholly below h.
    save("rdma_pad", m141, hs_solve_tiled(i1[:10], i2[:10], cfg, m141, halo_sweeps=3,
                                          halo_impl="rdma"),
         hs_solve(i1[:10], i2[:10], cfg))
    # A sweep block deeper than one pass of K2's walk (20 > 16 sweeps) on a
    # (1, 1, 2) mesh of 32 x 32 shards, one a process, i45: blocks of 20,
    # 20 and 5.
    m112 = make_mesh(MeshConfig(batch=1, y=1, x=2), [CPU])
    deep = HSConfig(alpha=0.5, iters=45)
    save("rdma_deep", m112, hs_solve_tiled(i1, i2, deep, m112, halo_sweeps=20, halo_impl="rdma"),
         hs_solve(i1, i2, deep))
    # The layout changes: C4-like frames split by batch between the
    # processes, all of the space layout on rank 0 (held once).
    vid = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (5, 12, 20))
                           .astype(np.float32))
    m222 = make_mesh(MeshConfig(batch=2, y=2, x=2), [CPU] * 4)
    sp = reshard.time_to_space(reshard.shard(vid, m222, reshard.TIME), m222)
    relayout("time_to_space", m222, {"whole": sp.gather()}, sp)
    back = reshard.space_to_time(sp, m222)
    relayout("space_to_time", m222, {"whole": back.gather()}, back)
    m211 = make_mesh(MeshConfig(batch=2, y=1, x=1), [CPU])
    a, b, ok = reshard.timesharded_pairs(reshard.shard(vid, m211, reshard.TIME))
    relayout("timesharded_pairs", m211, {"i1": a.gather(), "i2": b.gather(), "valid": ok.gather()},
             a, b, ok)
    sums(m124)
elif group == "four":
    m122 = make_mesh(MeshConfig(batch=1, y=2, x=2), [CPU])
    save("jacobi", m122, hs_solve_tiled(i1, i2, cfg, m122, halo_sweeps=2), hs_solve(i1, i2, cfg))
    rob = HSConfig(solver="robust", alpha=0.3, iters=6, robust_update_every=3)
    save("robust", m122, hs_solve_tiled(i1, i2, rob, m122), hs_solve(i1, i2, rob))
    s1, s2 = frames((2, 32, 64), 1)
    mg = HSConfig(solver="multigrid", alpha=1.0, iters=2)
    save("multigrid", m122, hs_solve_tiled(s1, s2, mg, m122), hs_solve_batched(s1, s2, mg))
    lk = LKConfig()
    save("lk", m122, lk_solve_tiled(i1, i2, lk, mesh=m122), lk_solve(i1, i2, lk))
    rdma(m122, "")
    rdma(m122, "_bf16")
    sums(m122)
else:
    raise SystemExit(f"unknown group {group!r}")

if rank == 0:
    with open(os.path.join(out, "meshes.json"), "w") as f:
        json.dump(meshes, f)
multihost.shutdown()
print(f"TORCH_MH_WORKER_OK {group} {rank}", flush=True)
