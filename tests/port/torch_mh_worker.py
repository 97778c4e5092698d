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
        fault hook on rank 1; the refusals.
  four  4 processes x 1 shard: the (1, 2, 2) mesh, both axes between the
        processes: Jacobi, a robust pair and a multigrid stack through the
        GSPMD routes, lk_solve_tiled.

Each case writes every rank's tiled flow and rank 0's untiled flow as
(2, ...) .npy files (u, v; bfloat16 widened, which is exact), the mesh's
ranks as JSON, and the refusals' messages as JSON.
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
from opticalflowhs_tpu_torch.dist import reshard  # noqa: E402
from opticalflowhs_tpu_torch.dist.tiled_solver import Layout  # noqa: E402
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


def refused(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "not refused"


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
    lay = Layout(m124, 1, 1, 16, 16)
    blocks = {c: i1[None, 16 * c[1]:16 * c[1] + 16, 16 * c[2]:16 * c[2] + 16] for c in lay.mine}
    sh = reshard.Sharded(blocks, lay, ("y", "x"), (32, 64))
    msgs = {
        "rdma": refused(lambda: hs_solve_tiled(i1, i2, cfg, m124, halo_sweeps=2,
                                               halo_impl="rdma")),
        "sharded": refused(lambda: reshard.shard(i1, m124, ("y", "x"))),
        "time_to_space": refused(lambda: reshard.time_to_space(s1, m124)),
        "egomotion": refused(lambda: estimate_egomotion(Flow(sh, sh), axis_names=("y", "x"))),
        "energy": refused(lambda: hs_energy(sh, sh, Flow(sh, sh), axis_names=("y", "x"))),
    }
    if rank == 0:
        with open(os.path.join(out, "refusals.json"), "w") as f:
            json.dump(msgs, f)
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
else:
    raise SystemExit(f"unknown group {group!r}")

if rank == 0:
    with open(os.path.join(out, "meshes.json"), "w") as f:
        json.dump(meshes, f)
dist.destroy_process_group()
print(f"TORCH_MH_WORKER_OK {group} {rank}", flush=True)
