"""Meshes that span processes (dist/multihost.py, dist/transport.py) on the
CPU: gloo worlds of 2 and 4 processes (tests/port/torch_mh_worker.py, one
spawn a world, every case of a world in that spawn), and the
`python -m opticalflowhs_tpu_torch.dist.multihost` entry as 2 processes.

Inputs come from seeded numpy generators: the reference's
tests/distributed/mh_worker.py case (32x64 uniform frames from
default_rng(0), alpha 0.5, i16, halo sweeps 2) and a B=2 stack from
default_rng(1). Bars, each with its reason:
  * every rank's tiled flow against the port's untiled entry: bitwise.
    The halos carry the stored values whichever process they come from,
    the tiles are all-gathered unchanged, and the GSPMD routes run the
    untiled entry on the owning process and broadcast its flow.
  * against the reference's untiled route (backend "jnp"; its tiled
    compiles are too slow here): Jacobi solves 2e-6, the pyramids and SOR
    1e-5 (ROADMAP.md queue 3's bars), robust 2e-6, multigrid 1e-5, LK 2e-6
    (test_torch_dist_gspmd.py's bars); bfloat16 against the reference's
    float32 solve by queue 3's bars for the storage rule (8 px in: mean
    0.02 px, max 0.1 px).
  * halo_impl="rdma" (the plain ring across processes) as the Jacobi
    solves: bitwise against the untiled entry, 2e-6 (bfloat16: the storage
    rule's bars) against the reference.
  * the layout changes: every rank's blocks and gathered arrays bitwise
    against the same calls in one process and against the numpy slices
    (they only move values).
  * the axis_names sums: bitwise equal on every rank (the partial sums are
    added in rank order); every rank's within 1e-5 relative of the port's
    whole-array call and of the reference's (the order of the float32
    sums), plus the flow's float32 rounding size (eps x max |u, v|), the
    floor for ego-motion's scale, a ratio of sums that cancel (1.8e-5 here).
"""

import functools
import json
import os
import re
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opticalflowhs_tpu.config as ref_config
from opticalflowhs_tpu.batch import hs_solve_batched as ref_batched
from opticalflowhs_tpu.egomotion import estimate_egomotion as ref_egomotion
from opticalflowhs_tpu.lucas_kanade import lk_solve as ref_lk_solve
from opticalflowhs_tpu.metrics import hs_energy as ref_hs_energy
from opticalflowhs_tpu.pyramid import hs_pyramid as ref_hs_pyramid
from opticalflowhs_tpu.solver import Flow as RefFlow
from opticalflowhs_tpu.solver import hs_solve as ref_hs_solve
from opticalflowhs_tpu_torch import HSConfig, MeshConfig, PyramidConfig, hs_pyramid, hs_solve
from opticalflowhs_tpu_torch.dist import hs_solve_tiled, make_mesh, multihost, reshard
from opticalflowhs_tpu_torch.dist.mesh import Mesh, require_one_host
from opticalflowhs_tpu_torch.io.flo import read_flo

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
WORKER = os.path.join(HERE, "torch_mh_worker.py")
TIMEOUT = 120

SOLVE_TOL = 2e-6
PYRAMID_TOL = 1e-5
SOR_TOL = 1e-5
ROBUST_TOL = 2e-6
MG_TOL = 1e-5
LK_TOL = 2e-6
MEAN_TOL = 0.02
MAX_TOL = 0.1
EDGE = 8
SUM_TOL = 1e-5

TWO = ["jacobi", "pyramid", "tol", "sor", "bf16", "stack", "x", "idle", "rdma", "rdma_bf16",
       "rdma_k11", "rdma_idle", "rdma_deep", "rdma_pad"]
FOUR = ["jacobi", "robust", "multigrid", "lk", "rdma", "rdma_bf16"]
# Which mesh axis each case's processes split: the mesh's ranks differ
# along it (and along no other for the 2-process meshes).
TWO_SPLIT = {"stack": 0, "idle": 0, "rdma_idle": 0, "x": 2, "rdma_deep": 2}
HS = dict(alpha=0.5, iters=16)


def _run(cmds, env=None, cwd=ROOT):
    """Start every command at once, wait for all (killing all past
    TIMEOUT), and return each one's (returncode, stdout, stderr)."""
    procs = [subprocess.Popen(c, cwd=cwd, env=env(k) if env else None, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for k, c in enumerate(cmds)]
    try:
        res = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, res)]


def _world(tmp_path_factory, group, n):
    out = tmp_path_factory.mktemp(f"mh_{group}")
    rdv = out / "rendezvous"
    res = _run([[sys.executable, WORKER, group, str(r), str(n), str(rdv), str(out)]
                for r in range(n)])
    for r, (rc, o, e) in enumerate(res):
        assert rc == 0 and f"TORCH_MH_WORKER_OK {group} {r}" in o, (r, rc, o, e[-3000:])
    return out


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _world(tmp_path_factory, "two", 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _world(tmp_path_factory, "four", 4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The entry point as 2 processes through HSFLOW_COORD (a free port on
    127.0.0.1, tried again once if the address is taken), each with its
    own -o path: (results, directory)."""
    out = tmp_path_factory.mktemp("mh_cli")
    for attempt in range(2):
        port = _free_port()

        def env(r):
            e = dict(os.environ, HSFLOW_COORD=f"127.0.0.1:{port}", HSFLOW_NPROC="2",
                     HSFLOW_PROC_ID=str(r))
            e.pop("HSFLOW_LOCAL_RANK", None)
            return e

        res = _run([[sys.executable, "-m", "opticalflowhs_tpu_torch.dist.multihost",
                     "--device", "cpu", "--shape", "64x96", "--levels", "2", "--iters", "10",
                     "-o", str(out / f"r{r}.flo")] for r in range(2)], env)
        if attempt == 0 and any("address already in use" in e.lower() for _, _, e in res):
            continue
        break
    for r, (rc, o, e) in enumerate(res):
        assert rc == 0, (r, rc, o, e[-3000:])
    return res, out


def _load(d, case, rank=None):
    return np.load(d / (f"{case}_untiled.npy" if rank is None else f"{case}_tiled_r{rank}.npy"))


def _ref_frames(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(0, 1, shape).astype(np.float32) for _ in range(2))


def _reference(case):
    """The reference's untiled flow of a case, as a (2, ...) array, and its bar."""
    if case == "rdma_deep":  # the Jacobi solve's at i45
        case = "jacobi45"
    elif case == "rdma_pad":  # the Jacobi solve's of the first 10 rows
        case = "jacobi_crop"
    elif case.startswith("rdma") or case in ("x", "bf16"):  # the Jacobi solve's
        case = "jacobi"
    return _reference_of(case)


@functools.cache
def _reference_of(case):
    i1, i2 = (jnp.asarray(a) for a in _ref_frames((32, 64), 0))
    hs = lambda **kw: ref_config.HSConfig(backend="jnp", **{**HS, **kw})  # noqa: E731
    if case == "jacobi":
        f, bar = ref_hs_solve(i1, i2, hs()), SOLVE_TOL
    elif case == "jacobi45":
        f, bar = ref_hs_solve(i1, i2, hs(iters=45)), SOLVE_TOL
    elif case == "jacobi_crop":
        f, bar = ref_hs_solve(i1[:10], i2[:10], hs()), SOLVE_TOL
    elif case == "pyramid":
        f, bar = ref_hs_pyramid(i1, i2, hs(), ref_config.PyramidConfig(levels=2)), PYRAMID_TOL
    elif case in ("tol", "idle"):
        f, bar = ref_hs_solve(i1, i2, hs(iters=100, tol=1e-3, block_sweeps=2)), SOLVE_TOL
    elif case == "sor":
        f, bar = ref_hs_solve(i1, i2, hs(solver="sor", omega=1.7)), SOR_TOL
    elif case == "stack":
        s1, s2 = (jnp.asarray(a) for a in _ref_frames((2, 32, 64), 1))
        f, bar = ref_batched(s1, s2, hs()), SOLVE_TOL
    elif case == "robust":
        cfg = ref_config.HSConfig(backend="jnp", solver="robust", alpha=0.3, iters=6,
                                  robust_update_every=3)
        f, bar = ref_hs_solve(i1, i2, cfg), ROBUST_TOL
    elif case == "multigrid":
        s1, s2 = (jnp.asarray(a) for a in _ref_frames((2, 32, 64), 1))
        cfg = ref_config.HSConfig(backend="jnp", solver="multigrid", alpha=1.0, iters=2)
        f, bar = ref_batched(s1, s2, cfg), MG_TOL
    else:  # lk
        f, bar = ref_lk_solve(i1, i2, ref_config.LKConfig(),
                              ref_config.PyramidConfig(levels=1, iters_per_level=())), LK_TOL
    return np.stack([np.asarray(f.u), np.asarray(f.v)]).astype(np.float64), bar


def _check_reference(got, case, record_property):
    want, bar = _reference(case)
    got = got.astype(np.float64)
    if case.endswith("bf16"):
        d = np.abs(got - want)[..., EDGE:-EDGE, EDGE:-EDGE]
        record_property("max_abs_diff", float(d.max()))
        assert d.mean(axis=(-2, -1)).max() <= MEAN_TOL and d.max() <= MAX_TOL
        return
    d = float(np.abs(got - want).max())
    record_property("max_abs_diff", d)
    assert d <= bar


def _ranks(d):
    return json.loads((d / "meshes.json").read_text())


# -- 2 processes x 4 CPU shards ---------------------------------------------------------------


@pytest.mark.parametrize("case", TWO)
def test_two_processes_equal_the_untiled_entry(two, case):
    ranks = np.asarray(_ranks(two)[case])
    axis = TWO_SPLIT.get(case, 1)
    assert np.ptp(ranks, axis=axis).max() == 1  # the processes split this axis
    assert all(np.ptp(ranks, axis=a).max() == 0 for a in range(3) if a != axis)
    want = _load(two, case)
    for r in range(2):
        got = _load(two, case, r)
        assert got.shape == want.shape and np.array_equal(got, want), (case, r)
    if case in ("tol", "idle"):  # the solve stopped before its budget of 100 sweeps
        i1, i2 = (torch.from_numpy(x) for x in _ref_frames((32, 64), 0))
        full = hs_solve(i1, i2, HSConfig(alpha=0.5, iters=100))
        assert not np.array_equal(want[0], full.u.numpy())


@pytest.mark.parametrize("case", TWO)
def test_two_processes_match_the_reference(two, case, record_property):
    _check_reference(_load(two, case, 1), case, record_property)


def test_fault_hook_across_processes(two):
    # Rank 1 corrupted the halo rows it received from rank 0: the flow
    # differs from the untiled solve, and both ranks hold the same flow.
    bad0, bad1, clean = _load(two, "fault", 0), _load(two, "fault", 1), _load(two, "fault")
    assert np.array_equal(bad0, bad1)
    assert float(np.abs(bad0 - clean).max()) > 1e-3
    assert np.array_equal(_load(two, "jacobi", 1), clean)


def _vid():
    return torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (5, 12, 20))
                            .astype(np.float32))


def _in_process(what):
    """The worker's layout change in one process, on CPU meshes of the same
    shapes: its arrays (Sharded), and the whole arrays from numpy slices."""
    vid = _vid()
    if what == "timesharded_pairs":
        m = make_mesh(MeshConfig(batch=2, y=1, x=1), ["cpu"] * 2)
        arrays = reshard.timesharded_pairs(reshard.shard(vid, m, reshard.TIME))
        n = arrays[0].shape[0]
        i1, i2 = np.zeros((2, n) + tuple(vid.shape[1:]), np.float32)
        i1[:5], i2[:4] = vid.numpy(), vid.numpy()[1:]
        return arrays, {"i1": i1, "i2": i2, "valid": np.arange(n) < 4}
    m = make_mesh(MeshConfig(batch=2, y=2, x=2), ["cpu"] * 8)
    sp = reshard.time_to_space(reshard.shard(vid, m, reshard.TIME), m)
    arrays = (sp,) if what == "time_to_space" else (reshard.space_to_time(sp, m),)
    return arrays, {"whole": vid.numpy()}


@pytest.mark.parametrize("what", ["time_to_space", "space_to_time", "timesharded_pairs"])
def test_layout_changes_across_processes(two, what):
    arrays, wholes = _in_process(what)
    ranks = np.asarray(_ranks(two)[what])
    assert np.ptp(ranks, axis=0).max() == 1  # the batch groups lie on both processes
    owned = set()
    for r in range(2):
        got = np.load(two / f"{what}_r{r}.npz")
        for k, want in wholes.items():
            assert np.array_equal(got[k], want), (what, r, k)
        for key in got.files:
            if key in wholes:
                continue
            k, *c = key.split("_")
            c = tuple(int(x) for x in c)
            assert ranks[c] == r and np.array_equal(got[key], arrays[int(k)].blocks[c].numpy())
            owned.add((int(k), c))
    # Every block of every array is held once, by its owner (the space
    # layout wholly by rank 0: held once at batch index 0).
    assert owned == {(k, c) for k, x in enumerate(arrays) for c in x.blocks}


def _reference_sums(d, what):
    """The reference's whole-array estimate_egomotion or hs_energy (alpha
    0.5) of the flow the worker took the sums over (its Jacobi case's
    untiled flow), and the float32 rounding size of that flow."""
    uv = _load(d, "jacobi")
    flow = RefFlow(jnp.asarray(uv[0]), jnp.asarray(uv[1]))
    if what == "egomotion":
        want = [float(x) for x in ref_egomotion(flow)]
    else:
        i1, i2 = (jnp.asarray(a) for a in _ref_frames((32, 64), 0))
        want = [float(ref_hs_energy(i1, i2, flow, alpha=HS["alpha"]))]
    return want, float(np.finfo(np.float32).eps * np.abs(uv).max())


@pytest.mark.parametrize("world", ["two", "four"])
@pytest.mark.parametrize("what", ["egomotion", "energy"])
def test_axis_name_sums_across_processes(request, world, what):
    d = request.getfixturevalue(world)
    n = {"two": 2, "four": 4}[world]
    sums = [json.loads((d / f"sums_r{r}.json").read_text()) for r in range(n)]
    got = [s[what] for s in sums]
    assert all(g == got[0] for g in got)  # the same bits on every rank
    ref, floor = _reference_sums(d, what)
    for r, g in enumerate(got):
        for want in (sums[0]["whole_" + what], ref):
            assert len(g) == len(want)
            for a, b in zip(g, want):
                assert abs(a - b) <= SUM_TOL * abs(b) + floor, (what, r, a, b)


def test_rdma_refused_across_hosts():
    # A mesh whose two processes lie on different hosts (identities faked,
    # no world needed: the refusal comes before any exchange).
    devices = np.empty((1, 2, 1), dtype=object)
    devices[0, 0, 0] = devices[0, 1, 0] = torch.device("cpu")
    ranks = np.asarray([[[0], [1]]])
    mesh = Mesh(devices, ranks=ranks, process_index=0, process_count=2, collective=True,
                hosts=["host-a", "host-b"])
    i1, i2 = (torch.from_numpy(x) for x in _ref_frames((32, 64), 0))
    with pytest.raises(ValueError, match="CUDA IPC does not reach another host"):
        hs_solve_tiled(i1, i2, HSConfig(**HS), mesh, halo_sweeps=2, halo_impl="rdma")
    require_one_host(Mesh(devices, ranks=ranks, process_index=0, process_count=2,
                          collective=True, hosts=["host-a", "host-a"]), "rdma")


# -- 4 processes x 1 CPU shard ------------------------------------------------------------------


@pytest.mark.parametrize("case", FOUR)
def test_four_processes_equal_the_untiled_entry(four, case):
    # Both mesh axes lie between the processes, corners included.
    assert _ranks(four)[case] == [[[0, 1], [2, 3]]]
    want = _load(four, case)
    for r in range(4):
        assert np.array_equal(_load(four, case, r), want), (case, r)


@pytest.mark.parametrize("case", FOUR)
def test_four_processes_match_the_reference(four, case, record_property):
    _check_reference(_load(four, case, 3), case, record_property)


# -- init_multihost ------------------------------------------------------------------------------


def _clear_env(monkeypatch):
    for k in ("HSFLOW_COORD", "HSFLOW_NPROC", "HSFLOW_PROC_ID", "HSFLOW_LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)


def test_init_multihost_with_nothing_set_does_nothing(monkeypatch):
    _clear_env(monkeypatch)
    assert multihost.init_multihost() is None
    assert multihost.init_multihost(device="cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()


def test_init_multihost_without_cuda_raises(monkeypatch):
    _clear_env(monkeypatch)
    monkeypatch.setenv("HSFLOW_COORD", "127.0.0.1:1")
    monkeypatch.setenv("HSFLOW_NPROC", "2")
    monkeypatch.setenv("HSFLOW_PROC_ID", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        multihost.init_multihost()
    monkeypatch.delenv("HSFLOW_PROC_ID")
    with pytest.raises(ValueError, match="needs the coordinator"):
        multihost.init_multihost(device="cpu")
    assert not torch.distributed.is_initialized()


def test_shared_cards_are_named():
    assert multihost.shared_cards(["a|GPU-1", "a|GPU-2", "b|GPU-1"]) is None
    assert multihost.shared_cards(["a|GPU-1", "a|GPU-2", "a|GPU-1"]) == (0, 2)


# -- python -m opticalflowhs_tpu_torch.dist.multihost ---------------------------------------------


def _cli_frames():
    rng = np.random.default_rng(0)
    i1 = rng.uniform(0, 1, (64, 96)).astype(np.float32)
    return i1, np.roll(i1, 2, axis=1)


def test_multihost_cli_rank0_prints_and_writes(cli):
    (rc0, out0, _), (rc1, out1, _) = cli[0]
    lines = out0.splitlines()
    assert lines[0] == "2 processes, 2 devices, mesh (1, 1, 2)"
    assert re.fullmatch(r"ego-motion: t=\([+-]\d+\.\d{3}, [+-]\d+\.\d{3}\) px/frame, "
                        r"omega=[+-]\d+\.\d{5} rad, scale=[+-]\d+\.\d{5}, "
                        r"residual=\d+\.\d{4}", lines[1]), lines[1]
    assert lines[2] == f"wrote {cli[1] / 'r0.flo'}" and len(lines) == 3
    assert out1 == "" and not (cli[1] / "r1.flo").exists()


def test_multihost_cli_flo_equals_hs_pyramid(cli):
    got = read_flo(cli[1] / "r0.flo")
    i1, i2 = _cli_frames()
    want = hs_pyramid(i1, i2, HSConfig(alpha=1.0, iters=10), PyramidConfig(levels=2),
                      device="cpu")
    assert got.shape == (64, 96, 2)
    assert np.array_equal(got[..., 0], want.u.numpy()) and np.array_equal(got[..., 1],
                                                                          want.v.numpy())


def test_multihost_cli_matches_reference(cli, record_property):
    got = read_flo(cli[1] / "r0.flo").astype(np.float64)
    i1, i2 = (jnp.asarray(a) for a in _cli_frames())
    want = ref_hs_pyramid(i1, i2, ref_config.HSConfig(alpha=1.0, iters=10, backend="jnp"),
                          ref_config.PyramidConfig(levels=2))
    d = max(float(np.abs(got[..., 0] - np.asarray(want.u)).max()),
            float(np.abs(got[..., 1] - np.asarray(want.v)).max()))
    record_property("max_abs_diff", d)
    assert d <= PYRAMID_TOL
