"""The port's configs against the reference's: same fields, defaults and
ValueErrors; `from_reference` on every configs/*.json section and on the
reference's HSConfig, PyramidConfig and TVL1Config."""

import dataclasses
import json
from pathlib import Path

import pytest

import opticalflowhs_tpu.config as ref
import opticalflowhs_tpu_torch.config as port

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs"


@pytest.mark.parametrize(
    "ref_cls,port_cls",
    [(ref.HSConfig, port.HSConfig), (ref.PyramidConfig, port.PyramidConfig),
     (ref.TVL1Config, port.TVL1Config), (ref.MeshConfig, port.MeshConfig)],
)
def test_fields_and_defaults_match(ref_cls, port_cls):
    ref_fields = [(f.name, f.default) for f in dataclasses.fields(ref_cls)]
    port_fields = [(f.name, f.default) for f in dataclasses.fields(port_cls)]
    # Backend names are the one deliberate difference ("auto" is shared).
    assert ref_fields == port_fields


def test_backend_names():
    assert port.BACKENDS == ("auto", "torch", "cuda")
    assert port.DERIV_VARIANTS == ref.DERIV_VARIANTS
    assert port.SOLVERS == ref.SOLVERS
    port.HSConfig(backend="cuda")
    with pytest.raises(ValueError):
        port.HSConfig(backend="pallas")
    port.TVL1Config(backend="cuda")
    with pytest.raises(ValueError):
        port.TVL1Config(backend="pallas")


@pytest.mark.parametrize(
    "kwargs",
    [
        {"deriv_variant": "sobel"},
        {"solver": "gauss"},
        {"omega": 2.0},
        {"omega": -0.5},
        {"tol": -1.0},
        {"tol": 1e-3, "checkpoint_every": 4},
        {"iters": -1},
        {"robust_eps_d": 0.0},
        {"robust_update_every": 0},
        {"block_sweeps": -1},
    ],
)
def test_hs_value_errors_match(kwargs):
    with pytest.raises(ValueError) as ref_err:
        ref.HSConfig(**kwargs)
    with pytest.raises(ValueError) as port_err:
        port.HSConfig(**kwargs)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize(
    "kwargs",
    [
        {"levels": 0},
        {"warp": "nearest"},
        {"warp_radius": 9},
        {"levels": 2, "iters_per_level": (10,)},
    ],
)
def test_pyramid_value_errors_match(kwargs):
    with pytest.raises(ValueError) as ref_err:
        ref.PyramidConfig(**kwargs)
    with pytest.raises(ValueError) as port_err:
        port.PyramidConfig(**kwargs)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize(
    "kwargs",
    [
        {"lambda_": 0.0},
        {"theta": -1.0},
        {"tau": 0.3},
        {"warps": 0},
        {"iters": 0},
        {"warps_per_level": (2, 0)},
        {"warp": "nearest"},
    ],
)
def test_tvl1_value_errors_match(kwargs):
    with pytest.raises(ValueError) as ref_err:
        ref.TVL1Config(**kwargs)
    with pytest.raises(ValueError) as port_err:
        port.TVL1Config(**kwargs)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize(
    "kwargs", [{"batch": 0}, {"y": 0}, {"x": -1}, {"halo_sweeps": 0}]
)
def test_mesh_value_errors_match(kwargs):
    with pytest.raises(ValueError) as ref_err:
        ref.MeshConfig(**kwargs)
    with pytest.raises(ValueError) as port_err:
        port.MeshConfig(**kwargs)
    assert str(port_err.value) == str(ref_err.value)
    cfg = port.MeshConfig(batch=2, y=4, x=4, halo_sweeps=4)
    assert cfg.shape == ref.MeshConfig(batch=2, y=4, x=4).shape == (2, 4, 4)
    assert cfg.axis_names == ref.MeshConfig().axis_names


@pytest.mark.parametrize("path", sorted(CONFIG_DIR.glob("*.json")), ids=lambda p: p.name)
def test_from_reference_on_config_files(path):
    data = json.loads(path.read_text())
    run = ref.load_config(str(path))
    hs = port.from_reference(data["hs"])
    assert isinstance(hs, port.HSConfig)
    # Same values as the reference's parse of the file, backend renamed.
    expect = dataclasses.asdict(run.hs)
    expect["backend"] = {"auto": "auto", "jnp": "torch", "pallas": "cuda"}[
        expect["backend"]
    ]
    assert dataclasses.asdict(hs) == expect
    pyr = port.from_reference(data["pyramid"])
    assert isinstance(pyr, port.PyramidConfig)
    assert dataclasses.asdict(pyr) == dataclasses.asdict(run.pyramid)
    if "mesh" in data:
        mesh = port.from_reference(data["mesh"])
        assert isinstance(mesh, port.MeshConfig)
        assert dataclasses.asdict(mesh) == dataclasses.asdict(run.mesh)


@pytest.mark.parametrize("backend,expect", [("jnp", "torch"), ("pallas", "cuda"), ("auto", "auto")])
def test_from_reference_on_asdict(backend, expect):
    hs = port.from_reference(dataclasses.asdict(
        ref.HSConfig(alpha=0.5, iters=37, backend=backend, block_sweeps=4)
    ))
    assert hs == port.HSConfig(alpha=0.5, iters=37, backend=expect, block_sweeps=4)
    pyr = port.from_reference(dataclasses.asdict(
        ref.PyramidConfig(levels=2, iters_per_level=(5, 9), warp="checked")
    ))
    assert pyr == port.PyramidConfig(levels=2, iters_per_level=(5, 9), warp="checked")


@pytest.mark.parametrize("backend,expect", [("jnp", "torch"), ("pallas", "cuda"), ("auto", "auto")])
def test_from_reference_on_tvl1_asdict(backend, expect):
    tv = port.from_reference(dataclasses.asdict(
        ref.TVL1Config(lambda_=0.2, warps_per_level=(3, 1), backend=backend, warp="gather")
    ))
    assert tv == port.TVL1Config(lambda_=0.2, warps_per_level=(3, 1), backend=expect,
                                 warp="gather")
    # A dict whose keys fit more than one class resolves to the first of
    # HSConfig, PyramidConfig, TVL1Config.
    assert isinstance(port.from_reference({"iters": 50}), port.HSConfig)
    assert isinstance(port.from_reference({"warp": "gather"}), port.PyramidConfig)
    assert isinstance(port.from_reference({"warps": 2}), port.TVL1Config)
    mesh = port.from_reference(dataclasses.asdict(ref.MeshConfig(batch=2, y=2, x=4, halo_sweeps=3)))
    assert mesh == port.MeshConfig(batch=2, y=2, x=4, halo_sweeps=3)


def test_from_reference_rejects_unknown_fields():
    with pytest.raises(ValueError):
        port.from_reference({"alpha": 1.0, "levels": 3})
    with pytest.raises(ValueError):
        port.from_reference({"backend": "tpu"})
