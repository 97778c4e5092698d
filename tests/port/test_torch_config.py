"""The port's configs against the reference's: same fields, defaults and
ValueErrors; `from_reference` on every configs/*.json section and on the
reference's HSConfig, PyramidConfig, TVL1Config and LKConfig;
`load_config`, `RunConfig` and `config_hash` as the reference's."""

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
     (ref.TVL1Config, port.TVL1Config), (ref.MeshConfig, port.MeshConfig),
     (ref.LKConfig, port.LKConfig)],
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


@pytest.mark.parametrize(
    "kwargs",
    [
        {"window": 4},
        {"window": 1},
        {"iters": 0},
        {"eps": 0.0},
        {"max_step": -1.0},
        {"warp": "nearest"},
        {"warp": "checked"},
    ],
)
def test_lk_value_errors_match(kwargs):
    with pytest.raises(ValueError) as ref_err:
        ref.LKConfig(**kwargs)
    with pytest.raises(ValueError) as port_err:
        port.LKConfig(**kwargs)
    assert str(port_err.value) == str(ref_err.value)


def test_from_reference_on_an_lk_section():
    lk = port.from_reference(dataclasses.asdict(
        ref.LKConfig(window=11, iters=2, eps=1e-2, max_step=0.5, smooth=False, warp="gather")
    ))
    assert lk == port.LKConfig(window=11, iters=2, eps=1e-2, max_step=0.5, smooth=False,
                               warp="gather")
    assert port.from_reference({"window": 7, "iters": 4}) == port.LKConfig(window=7, iters=4)
    # LKConfig is tried after TVL1Config: dicts that an earlier class fits
    # resolve as before.
    assert isinstance(port.from_reference({"iters": 3, "warp": "gather"}), port.TVL1Config)
    assert isinstance(port.from_reference({"eps": 0.01}), port.LKConfig)


def _translated(run) -> dict:
    """asdict of a reference RunConfig in the port's backend names."""
    d = dataclasses.asdict(run)
    for sect in ("hs", "tvl1"):
        d[sect]["backend"] = port._BACKEND_FROM_REFERENCE[d[sect]["backend"]]
    d["pyramid"]["iters_per_level"] = tuple(d["pyramid"]["iters_per_level"])
    return d


@pytest.mark.parametrize("path", sorted(CONFIG_DIR.glob("*.json")), ids=lambda p: p.name)
def test_load_config_on_config_files(path):
    got = port.load_config(str(path))
    assert isinstance(got, port.RunConfig) and isinstance(got.lk, port.LKConfig)
    assert dataclasses.asdict(got) == _translated(ref.load_config(str(path)))
    hash(got)  # nested frozen dataclasses hash


@pytest.mark.parametrize(
    "overrides",
    [
        {"hs.iters": "42", "mesh.y": "4", "hs.backend": "pallas"},
        {"pyramid.levels": "3", "pyramid.iters_per_level": "50,80,100"},
        {"lk.window": "11", "lk.iters": "2", "lk.smooth": "false", "method": "lk"},
        {"tvl1.warps_per_level": "3,1", "tvl1.lambda_": "0.2", "method": "tvl1"},
        {"hs.alpha": 0.5, "pyramid.iters_per_level": ""},
    ],
)
def test_load_config_overrides_match(tmp_path, overrides):
    f = tmp_path / "run.json"
    f.write_text(json.dumps({"hs": {"alpha": 1.0, "backend": "jnp"},
                             "pyramid": {"levels": 2, "iters_per_level": [5, 9]},
                             "lk": {"eps": 0.01}}))
    for path in (None, str(f)):
        got = port.load_config(path, overrides)
        assert dataclasses.asdict(got) == _translated(ref.load_config(path, overrides))


@pytest.mark.parametrize(
    "path_doc,overrides,err",
    [
        ({"gamma": {}}, None, KeyError),
        (None, {"hs.gamma": 1}, KeyError),
        (None, {"alpha": 1}, KeyError),
        (None, {"lk.smooth": "maybe"}, ValueError),
        (None, {"method": "farneback"}, ValueError),
        ({"method": "sift"}, None, ValueError),
    ],
)
def test_load_config_errors_match(tmp_path, path_doc, overrides, err):
    path = None
    if path_doc is not None:
        path = tmp_path / "bad.json"
        path.write_text(json.dumps(path_doc))
    with pytest.raises(err) as ref_err:
        ref.load_config(path and str(path), overrides)
    with pytest.raises(err) as port_err:
        port.load_config(path and str(path), overrides)
    assert str(port_err.value) == str(ref_err.value)


def test_load_config_takes_the_ports_backend_names():
    got = port.load_config(overrides={"hs.backend": "cuda", "tvl1.backend": "torch"})
    assert got.hs.backend == "cuda" and got.tvl1.backend == "torch"


def test_run_config_method_validation():
    for method in ("hs", "lk", "tvl1"):
        assert port.RunConfig(method=method).method == method
    with pytest.raises(ValueError) as ref_err:
        ref.RunConfig(method="farneback")
    with pytest.raises(ValueError) as port_err:
        port.RunConfig(method="farneback")
    assert str(port_err.value) == str(ref_err.value)
    assert [f.name for f in dataclasses.fields(port.RunConfig)] == [
        f.name for f in dataclasses.fields(ref.RunConfig)]
    assert dataclasses.asdict(port.RunConfig()) == _translated(ref.RunConfig())


def test_config_hash_is_the_references_and_unchanged():
    from opticalflowhs_tpu_torch import checkpoint

    # One definition, which checkpoints use.
    assert checkpoint.config_hash is port.config_hash
    # The hashes that tag existing checkpoints stay what they were.
    assert port.config_hash(port.HSConfig()) == "f215c91168ab1118"
    assert port.config_hash(port.RunConfig()) == "ef7a7a11ef4b9155"
    for cfg_port, cfg_ref in (
        (port.HSConfig(alpha=0.5, iters=200, checkpoint_every=100),
         ref.HSConfig(alpha=0.5, iters=200, checkpoint_every=100)),
        (port.LKConfig(window=11), ref.LKConfig(window=11)),
        (port.RunConfig(method="lk", lk=port.LKConfig(iters=2)),
         ref.RunConfig(method="lk", lk=ref.LKConfig(iters=2))),
    ):
        assert port.config_hash(cfg_port) == ref.config_hash(cfg_ref)
    assert port.config_hash(port.HSConfig(alpha=2.0)) != port.config_hash(port.HSConfig())
