"""The port's checkpointed solve (checkpoint.py) on the CPU, and its state
carried across from and to the JAX reference.

Tolerances, each with its reason:
  * chunked against uninterrupted, and resumed against uninterrupted: 0.0
    (bitwise). Chunked fixed-count Jacobi sweeps compose exactly;
  * the hashes: equal strings (the same formula over the same bytes);
  * a checkpoint that the reference wrote mid-solve, resumed here, against
    the reference's uninterrupted solve: 2e-6 max |diff|, the reference's
    kernel-vs-oracle bar (the sweeps after the resume run in PyTorch).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opticalflowhs_tpu.checkpoint as ref_ck
from opticalflowhs_tpu.config import HSConfig as RefHS
from opticalflowhs_tpu.config import config_hash as ref_config_hash
from opticalflowhs_tpu.solver import hs_solve as ref_hs_solve
from opticalflowhs_tpu_torch import HSConfig, hs_solve, hs_solve_checkpointed
from opticalflowhs_tpu_torch import checkpoint as ck
from opticalflowhs_tpu_torch.data.synthetic import translation_pair

torch.set_num_threads(1)

TOL = 2e-6

# Every |diff| a test measures, recorded as the junit property
# `max_abs_diff` (as in test_torch_batch.py).
_DIFFS: list[float] = []


@pytest.fixture(autouse=True)
def _report_max_diff(record_property):
    _DIFFS.clear()
    yield
    if _DIFFS:
        record_property("max_abs_diff", max(_DIFFS))


def _max_diff(got, want):
    d = max(float(np.abs(np.asarray(g) - np.asarray(w)).max()) for g, w in zip(got, want))
    _DIFFS.append(d)
    return d


def _pair(h=48, w=64, key=21):
    i1, i2, _ = translation_pair(h, w, 1.0, 0.5, key=key)
    return i1, i2


def _equal(a, b):
    assert _max_diff(a, b) == 0.0


@pytest.mark.parametrize("every", [1, 5, 7, 20, 50])
def test_chunked_equals_uninterrupted(tmp_path, every):
    i1, i2 = _pair()
    cfg = HSConfig(alpha=0.5, iters=20, checkpoint_every=every)
    got = hs_solve_checkpointed(i1, i2, cfg, str(tmp_path / "ck.npz"), device="cpu")
    want = hs_solve(i1, i2, dataclasses.replace(cfg, checkpoint_every=0), device="cpu")
    _equal(got, want)
    flow, done = ck.load_state(str(tmp_path / "ck.npz"), cfg, device="cpu")
    assert done == 20
    _equal(flow, want)


def test_resume_after_a_stop_equals_uninterrupted(tmp_path):
    i1, i2 = _pair()
    cfg = HSConfig(alpha=0.5, iters=20, checkpoint_every=5, deriv_variant="central")
    p = str(tmp_path / "ck.npz")
    seg = hs_solve(i1, i2, dataclasses.replace(cfg, iters=5), device="cpu")
    ck.save_state(p, seg, 5, cfg, input_hash=ck.frames_hash(i1, i2))  # sweeps 6-20 lost
    got = hs_solve_checkpointed(torch.from_numpy(i1), torch.from_numpy(i2), cfg, p)
    _equal(got, hs_solve(i1, i2, dataclasses.replace(cfg, checkpoint_every=0), device="cpu"))


def test_stale_or_wrong_checkpoints_raise(tmp_path):
    i1, i2 = _pair()
    cfg = HSConfig(alpha=0.5, iters=10, checkpoint_every=5)
    p = str(tmp_path / "ck.npz")
    hs_solve_checkpointed(i1, i2, cfg, p, device="cpu")
    with pytest.raises(ValueError, match="different config"):
        hs_solve_checkpointed(i1, i2, dataclasses.replace(cfg, alpha=0.6), p, device="cpu")
    j1, j2 = _pair(key=22)
    with pytest.raises(ValueError, match="different frame pair"):
        hs_solve_checkpointed(j1, j2, cfg, p, device="cpu")
    seg = hs_solve(i1, i2, dataclasses.replace(cfg, iters=5), device="cpu")
    ck.save_state(p, seg, 25, cfg)  # more sweeps than cfg.iters
    with pytest.raises(ValueError, match="over-iterated"):
        hs_solve_checkpointed(i1, i2, cfg, p, device="cpu")
    with pytest.raises(ValueError, match="checkpoint_every"):
        hs_solve_checkpointed(i1, i2, HSConfig(iters=10), p, device="cpu")
    # resume=False starts over and overwrites the stale state.
    got = hs_solve_checkpointed(i1, i2, cfg, p, resume=False, device="cpu")
    _equal(got, hs_solve(i1, i2, dataclasses.replace(cfg, checkpoint_every=0), device="cpu"))
    assert ck.checkpoint_path("run/ck.npz", 3) == "run/ck.3.npz"
    assert ck.checkpoint_path("run/ck", "a") == "run/ck.a.npz"


def test_zero_iters_and_numpy_without_device(tmp_path, monkeypatch):
    i1, i2 = _pair()
    got = hs_solve_checkpointed(i1, i2, HSConfig(iters=0, checkpoint_every=5),
                                str(tmp_path / "ck.npz"), device="cpu")
    assert not got.u.any() and not got.v.any()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        hs_solve_checkpointed(i1, i2, HSConfig(iters=5, checkpoint_every=5),
                              str(tmp_path / "ck2.npz"))


@pytest.mark.parametrize(
    "fields", [{}, {"alpha": 0.5, "iters": 20, "checkpoint_every": 5},
               {"solver": "sor", "omega": 1.7, "deriv_variant": "central"}])
def test_hashes_equal_the_reference(fields):
    i1, i2 = _pair()
    assert ck.frames_hash(i1, i2) == ref_ck.frames_hash(i1, i2)
    assert ck.frames_hash(torch.from_numpy(i1), torch.from_numpy(i2)) == ref_ck.frames_hash(
        jnp.asarray(i1), jnp.asarray(i2))
    assert ck.config_hash(HSConfig(**fields)) == ref_config_hash(RefHS(**fields))


def test_reference_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    i1, i2 = _pair()
    fields = dict(alpha=0.5, iters=20, checkpoint_every=5)
    p = str(tmp_path / "ref.npz")
    # Stop the reference after its second segment (its state then records
    # 10 sweeps), as a crash would.
    calls = []
    ref_solve = ref_ck.hs_solve

    def stop_on_third(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("stopped")
        return ref_solve(*a, **k)

    monkeypatch.setattr(ref_ck, "hs_solve", stop_on_third)
    with pytest.raises(RuntimeError, match="stopped"):
        ref_ck.hs_solve_checkpointed(jnp.asarray(i1), jnp.asarray(i2), RefHS(**fields), p)
    monkeypatch.setattr(ref_ck, "hs_solve", ref_solve)
    with np.load(p) as z:
        assert sorted(z.files) == ["cfg_hash", "input_hash", "sweeps_done", "u", "v"]
        assert int(z["sweeps_done"]) == 10
    got = hs_solve_checkpointed(i1, i2, HSConfig(**fields), p, device="cpu")
    want = ref_hs_solve(jnp.asarray(i1), jnp.asarray(i2),
                        RefHS(alpha=0.5, iters=20, backend="jnp"))
    assert _max_diff(got, want) <= TOL


def test_port_checkpoint_resumes_in_the_reference(tmp_path):
    i1, i2 = _pair()
    fields = dict(alpha=0.5, iters=20, checkpoint_every=10)
    p = str(tmp_path / "port.npz")
    seg = hs_solve(i1, i2, HSConfig(alpha=0.5, iters=10), device="cpu")
    ck.save_state(p, seg, 10, HSConfig(**fields), input_hash=ck.frames_hash(i1, i2))
    got = ref_ck.hs_solve_checkpointed(jnp.asarray(i1), jnp.asarray(i2), RefHS(**fields), p)
    want = hs_solve(i1, i2, HSConfig(alpha=0.5, iters=20), device="cpu")
    assert _max_diff(got, want) <= TOL
