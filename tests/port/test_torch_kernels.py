"""The kernel modules' plain versions against the JAX package's Pallas
kernels, run in interpret mode on the CPU as the JAX package's own tests run
them; the nvcc build's command line and failure modes; and the no-fallback
rules of the wrappers.

Tolerance: 2e-6 max |diff|, the reference's own kernel-vs-oracle bar
(CLAUDE.md "Invariants"). The two sides compute the same float32 ops in the
same order, but XLA:CPU fuses the interpret-mode kernel body, so the last
ulp may differ."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opticalflowhs_tpu.kernels.derivatives as ref_deriv
import opticalflowhs_tpu.kernels.jacobi as ref_jacobi
import opticalflowhs_tpu.kernels.solve_resident as ref_resident
import opticalflowhs_tpu.solver as ref_solver
from opticalflowhs_tpu.config import HSConfig as RefHS
from opticalflowhs_tpu_torch.config import HSConfig
from opticalflowhs_tpu_torch.kernels import _build
from opticalflowhs_tpu_torch.kernels import derivatives as k1
from opticalflowhs_tpu_torch.kernels import jacobi as k2
from opticalflowhs_tpu_torch.kernels import solve_resident as sr
from opticalflowhs_tpu_torch.solver import hs_solve, precompute, sweeps

torch.set_num_threads(1)

TOL = 2e-6
SHAPES = [(64, 80), (67, 93)]


def _frames(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, shape).astype(np.float32) for _ in range(2)]


def _flow(shape, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.5, shape).astype(np.float32) for _ in range(2)]


def _max_diff(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", ["hs_cube", "central"])
def test_derivatives_plain_vs_pallas(shape, variant):
    i1, i2 = _frames(shape)
    got = k1.hs_derivatives(torch.from_numpy(i1), torch.from_numpy(i2), 0.5, variant)
    want = ref_deriv.derivatives_precompute(
        jnp.asarray(i1), jnp.asarray(i2), 0.5, variant, interpret=True
    )
    for g, w in zip(got, want):
        assert _max_diff(g.numpy(), w) <= TOL


@pytest.mark.parametrize("shape", SHAPES)
def test_zero_sweep_is_first_jacobi_step(shape):
    # The K1 zero-start output equals one plain sweep from zeros, bitwise.
    i1, i2 = (torch.from_numpy(a) for a in _frames(shape))
    ex, ey, et, invd, u1, v1 = k1.derivatives_plain(i1, i2, 0.5, zero_sweep=True)
    z = torch.zeros_like(ex)
    u, v = k2.jacobi_sweeps_plain(z, z, ex, ey, et, invd, 1)
    assert torch.equal(u1, u) and torch.equal(v1, v)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n,s", [(1, 0), (7, 3), (25, 0)])
def test_jacobi_sweeps_plain_vs_pallas(shape, n, s):
    i1, i2 = _frames(shape)
    u0, v0 = _flow(shape)
    ex, ey, et, invd = precompute(torch.from_numpy(i1), torch.from_numpy(i2),
                                  HSConfig(alpha=0.5))
    got = k2.jacobi_sweeps(torch.from_numpy(u0), torch.from_numpy(v0),
                           ex, ey, et, invd, n, block_sweeps=s)
    want = ref_jacobi.jacobi_sweeps(
        jnp.asarray(u0), jnp.asarray(v0),
        *(jnp.asarray(a.numpy()) for a in (ex, ey, et, invd)),
        n, block_sweeps=s, interpret=True,
    )
    for g, w in zip(got, want):
        assert _max_diff(g.numpy(), w) <= TOL


@pytest.mark.parametrize("variant", ["hs_cube", "central"])
def test_precompute_and_sweeps_match_reference_solver(variant):
    # The reference's fallback chain, solver.precompute + solver.sweeps.
    i1, i2 = _frames((67, 93), seed=2)
    u0, v0 = _flow((67, 93))
    cfg = HSConfig(alpha=0.7, deriv_variant=variant)
    fields = precompute(torch.from_numpy(i1), torch.from_numpy(i2), cfg)
    got = sweeps(torch.from_numpy(u0), torch.from_numpy(v0), *fields, 9, cfg)
    ref_cfg = RefHS(alpha=0.7, deriv_variant=variant, backend="jnp")
    ref_fields = ref_solver.precompute(jnp.asarray(i1), jnp.asarray(i2), ref_cfg)
    for g, w in zip(fields, ref_fields):
        assert _max_diff(g.numpy(), w) <= TOL
    want = ref_solver.sweeps(jnp.asarray(u0), jnp.asarray(v0), *ref_fields, 9, ref_cfg)
    for g, w in zip(got, want):
        assert _max_diff(g.numpy(), w) <= TOL


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("warm", [False, True])
def test_resident_plain_vs_pallas(shape, warm):
    i1, i2 = _frames(shape, seed=1)
    u0, v0 = _flow(shape) if warm else (None, None)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    j = (lambda a: None if a is None else jnp.asarray(a))
    got = sr.hs_solve_resident(t(i1), t(i2), 0.5, 12, "hs_cube", t(u0), t(v0))
    want = ref_resident.hs_solve_resident(
        j(i1), j(i2), 0.5, 12, "hs_cube", u0=j(u0), v0=j(v0), interpret=True
    )
    assert want is not None
    for g, w in zip(got, want):
        assert _max_diff(g.numpy(), w) <= TOL


def test_resident_requires_both_init_fields():
    i1, i2 = (torch.from_numpy(a) for a in _frames((8, 8)))
    with pytest.raises(ValueError):
        sr.hs_solve_resident(i1, i2, 0.5, 3, u0=torch.zeros(8, 8))


def test_nvcc_command_targets_hopper_without_fma():
    cmd = _build.nvcc_command("nvcc", _build.sources(), Path("lib.so"))
    line = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in line
    assert "--fmad=false" in cmd
    assert "fast_math" not in line and "fast-math" not in line
    assert [Path(s).name for s in _build.sources()] == ["derivatives.cu", "jacobi.cu"]


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    # A build that finds no compiler raises too; it never falls back.
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: bad kernel' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_cuda_backend_on_cpu_raises():
    i1, i2 = (torch.from_numpy(a) for a in _frames((16, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        hs_solve(i1, i2, HSConfig(backend="cuda", iters=2))


@pytest.mark.parametrize(
    "bad",
    [
        lambda a: a.double(),
        lambda a: a.t(),             # not contiguous
        lambda a: a[None],           # not 2-D
        lambda a: a.numpy(),         # not a tensor
    ],
)
def test_wrappers_check_inputs(bad):
    i1, i2 = (torch.from_numpy(a) for a in _frames((16, 24)))
    with pytest.raises(ValueError):
        k1.hs_derivatives(bad(i1), i2, 0.5)
    z = torch.zeros(16, 24)
    with pytest.raises(ValueError):
        k2.jacobi_sweeps(bad(z), z, z, z, z, z, 1)


def test_cpu_wrappers_launch_nothing():
    i1, i2 = (torch.from_numpy(a) for a in _frames((16, 24)))
    before = (k1.hs_derivatives.launches, k2.jacobi_sweeps.launches)
    hs_solve(i1, i2, HSConfig(iters=5))
    assert (k1.hs_derivatives.launches, k2.jacobi_sweeps.launches) == before


def test_sweeps_per_launch_fits_shared_memory():
    assert k2.sweeps_per_launch(0) == k2.AUTO_SWEEPS
    assert k2.smem_bytes(k2.AUTO_SWEEPS) <= k2.SMEM_BYTES
    s = k2.sweeps_per_launch(1000)
    assert k2.smem_bytes(s) <= k2.SMEM_BYTES < k2.smem_bytes(s + 1)
    assert k2.sweeps_per_launch(1) == 1
