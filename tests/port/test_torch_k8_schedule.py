"""K8's launch (csrc/sor_planes.cu) walked in plain torch against the plain
plane schedule and the plain SOR sweeps, bitwise.

`sor_planes.k8_schedule_plain` runs ceil(n/s) sweep blocks, each one K3
launch's walk (`sor.k3_launch_schedule_plain`: K3's tiles, windows staged
with NaN outside the array, only the owned tiles written), the last block
the remainder n mod s at its own tile; block 0 reads the start or zeros,
and the blocks write the pairs A and B in turn, which start as NaN, so a
pixel that no block wrote, or a read outside the array that reached an
owned pixel, shows. These tests hold it equal to `sor_planes_plain` and
`sor.sor_sweeps_plain` with max |diff| 0.0 at both parities of h and w, at
frames smaller than one window and of a few tiles, at n = 1, s - 1, s,
s + 1 and 2s + 3, from zero and from a warm start, and at the s K3's rule
picks.
"""

import numpy as np
import pytest
import torch

from opticalflowhs_tpu_torch.kernels import sor as k3
from opticalflowhs_tpu_torch.kernels import sor_planes as k8
from opticalflowhs_tpu_torch.kernels.derivatives import derivatives_plain

OMEGA = 1.7


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _problem(shape, seed):
    rng = np.random.default_rng(seed)
    i1, i2 = (torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)) for _ in range(2))
    fields = derivatives_plain(i1, i2, 0.5)
    u0, v0 = (torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32)) for _ in range(2))
    return u0, v0, fields


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w), float((g - w).abs().nan_to_num(float("inf")).max())


# Both parities of h and w around K3's tile at s = 3 (36 x 104; 2 x 2 tiles
# at 37 x 105), and frames smaller than one 48 x 128 window.
S = 3
SHAPES = [(36, 104), (37, 104), (36, 105), (37, 105), (7, 9), (20, 33), (1, 5), (6, 1)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n", [1, S - 1, S, S + 1, 2 * S + 3])
@pytest.mark.parametrize("warm", [False, True])
def test_k8_schedule_equals_plain(shape, n, warm):
    u0, v0, fields = _problem(shape, seed=sum(shape) + n)
    start = (u0, v0) if warm else (None, None)
    got = k8.k8_schedule_plain(*start, *fields, n, OMEGA, s=S)
    _equal(got, k8.sor_planes_plain(*start, *fields, n, OMEGA))
    z = torch.zeros(shape)
    _equal(got, k3.sor_sweeps_plain(*((u0, v0) if warm else (z, z)), *fields, n, OMEGA))


@pytest.mark.parametrize("shape,n", [((67, 93), 50), ((48, 128), 7)])
def test_k8_schedule_at_the_rules_s(shape, n):
    # The s K3's cost rule picks (the kernel's default), a remainder block
    # at its own tile where s does not divide n.
    u0, v0, fields = _problem(shape, seed=3)
    s = k3.sweeps_per_launch(0, shape, n)
    assert 1 <= s <= k3.K3_MAX_SWEEPS
    got = k8.k8_schedule_plain(None, None, *fields, n, OMEGA)
    z = torch.zeros(shape)
    _equal(got, k3.sor_sweeps_plain(z, z, *fields, n, OMEGA))
    _equal(got, k8.k8_schedule_plain(z, z, *fields, n, OMEGA))  # zeros staged = a zero start


def test_k8_schedule_refusals():
    _, _, fields = _problem((8, 8), seed=4)
    with pytest.raises(ValueError, match="together"):
        k8.k8_schedule_plain(fields[0], None, *fields, 3, OMEGA)
    with pytest.raises(ValueError, match=">= 1"):
        k8.k8_schedule_plain(None, None, *fields, 0, OMEGA)
