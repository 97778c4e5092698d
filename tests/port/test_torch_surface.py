"""The port's public surface against the JAX reference's, read from both
packages' sources with `ast` (this file imports no JAX): every public
top-level name of a reference module outside kernels/ exists in the port's
module of the same path, every parameter name of a reference function is a
parameter of the port's, a literal default is the same value, and every
name a reference package `__init__` exports is exported by the port's.
kernels/ holds the TPU kernels and their wrappers, whose VMEM geometry,
`interpret` flags and class tests the port does not take (ROADMAP.md
queue 3); only its package export is compared.

What the port leaves out on purpose is written in ABSENT, each with its
reason. The keywords that exist for the reference's callers are pinned to
values bitwise unchanged on the CPU: `solver.solve_level(whole_solve_ok=)`,
`solver.sweeps_until(run_block=)`, `tvl1.tvl1_warp_iteration(kernel_ok=)`
and `ops.stencils.checkpointed_loop(step, uv, n)`
(`batch.solve_level_batched(stacked_ok=)`: test_torch_batch.py).
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from opticalflowhs_tpu_torch import HSConfig, TVL1Config
from opticalflowhs_tpu_torch import solver, tvl1
from opticalflowhs_tpu_torch.kernels import derivatives as k1
from opticalflowhs_tpu_torch.kernels import jacobi as k2
from opticalflowhs_tpu_torch.ops import stencils

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[2]
REF, PORT = ROOT / "opticalflowhs_tpu", ROOT / "opticalflowhs_tpu_torch"

# (module, name, parameter): a whole module (name None), a top-level name
# (parameter None) or one parameter the port leaves out on purpose.
ABSENT = {
    ("ops/golden.py", None, None):
        "the reference tests' NumPy oracle; the port's tests import it from the reference",
    ("solver.py", "resident_solve_enabled", None):
        "a TPU routing switch (HSFLOW_* and VMEM classes); the port routes by "
        "solver.whole_solve_route",
    ("solver.py", "fused_solve_enabled", None): "as resident_solve_enabled",
    ("solver.py", "skewed_solve_enabled", None): "as resident_solve_enabled",
    ("dist/halo.py", "halo_pad", "t"):
        "the reference's takes one tile inside shard_map and its mesh axis names; "
        "the port's takes the (y, x) grid of a mesh's shards",
    ("dist/halo.py", "halo_pad", "y_axis"): "as halo_pad's t",
    ("dist/halo.py", "halo_pad", "x_axis"): "as halo_pad's t",
    ("dist/halo.py", "replicate_global_edges", "t"): "as halo_pad's t",
    ("dist/halo.py", "replicate_global_edges", "y_axis"): "as halo_pad's t",
    ("dist/halo.py", "replicate_global_edges", "x_axis"): "as halo_pad's t",
}
# (module, function, parameter): a literal default the port sets otherwise.
OTHER_DEFAULTS = {
    ("bench.py", "roofline_gpx_sweeps", "device_kind"): "the card the port's roofline is for",
    ("bench.py", "compute_roofline_gpx_sweeps", "device_kind"): "as roofline_gpx_sweeps",
}


def _params(fn: ast.FunctionDef) -> dict:
    """Parameter name -> its default as source text (None: no default)."""
    a = fn.args
    pos = a.posonlyargs + a.args
    out = {x.arg: None for x in pos + a.kwonlyargs}
    for x, d in zip(pos[len(pos) - len(a.defaults):], a.defaults):
        out[x.arg] = ast.unparse(d)
    for x, d in zip(a.kwonlyargs, a.kw_defaults):
        if d is not None:
            out[x.arg] = ast.unparse(d)
    if a.vararg:
        out["*" + a.vararg.arg] = None
    if a.kwarg:
        out["**" + a.kwarg.arg] = None
    return out


def _surface(path: pathlib.Path) -> dict:
    """A module's public top-level names: functions -> their parameters,
    classes and assignments -> None."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = None
        elif isinstance(node, ast.Assign):
            out.update({t.id: None for t in node.targets if isinstance(t, ast.Name)})
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out[node.target.id] = None
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _exports(path: pathlib.Path) -> set:
    """The names a package `__init__` imports, defines or lists in __all__."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            out |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            out |= {e.value for e in node.value.elts}
    return out


def _literal(src):
    try:
        return True, ast.literal_eval(src)
    except (ValueError, SyntaxError):
        return False, None


MODULES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py")
                 if not p.relative_to(REF).as_posix().startswith("kernels/")
                 and p.name != "__init__.py")
PACKAGES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("__init__.py"))


@pytest.mark.parametrize("mod", MODULES)
def test_reference_names_and_parameters_exist_in_the_port(mod):
    if (mod, None, None) in ABSENT:
        assert not (PORT / mod).exists()
        return
    ref, port = _surface(REF / mod), _surface(PORT / mod)
    missing = []
    for name, params in ref.items():
        if (mod, name, None) in ABSENT:
            assert name not in port, f"{mod}: {name} is listed absent but exists"
            continue
        if name not in port:
            missing.append(name)
            continue
        if params is None:
            continue
        if port[name] is None:
            missing.append(f"{name} (a function in the reference)")
            continue
        for p, default in params.items():
            if (mod, name, p) in ABSENT:
                assert p not in port[name], f"{mod}: {name}({p}) is listed absent but exists"
            elif p not in port[name]:
                missing.append(f"{name}({p})")
            elif (mod, name, p) not in OTHER_DEFAULTS and default is not None:
                ok_r, want = _literal(default)
                ok_p, got = _literal(port[name][p])
                if ok_r and (not ok_p or got != want):
                    missing.append(f"{name}({p}={default}): the port's default is {port[name][p]}")
    assert not missing, f"{mod}: {missing}"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_exports_exist_in_the_port(pkg):
    missing = _exports(REF / pkg) - _exports(PORT / pkg)
    assert not missing, f"{pkg}: {sorted(missing)}"


def test_absences_are_still_absences():
    # Every entry names something the reference has; the list holds no
    # stale entry.
    for (mod, name, param), why in ABSENT.items():
        assert why
        assert (REF / mod).exists()
        if name is not None:
            ref = _surface(REF / mod)
            assert name in ref and (param is None or param in ref[name])


def test_exports_import_without_jax_or_a_build():
    # The new package exports load without JAX and build nothing: the
    # kernel modules stay lazy.
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['opticalflowhs_tpu'] = None\n"
        "from opticalflowhs_tpu_torch.ops import derivatives, neighbor_avg, jacobi_step\n"
        "from opticalflowhs_tpu_torch.kernels import jacobi_sweeps, _build\n"
        "from opticalflowhs_tpu_torch.batch import solve_level_batched\n"
        "import opticalflowhs_tpu_torch.ops as o\n"
        "assert o.__all__ == ['derivatives', 'neighbor_avg', 'jacobi_step']\n"
        "assert _build.library.cache_info().currsize == 0\n"
        "print('SURFACE_OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and "SURFACE_OK" in res.stdout, res.stderr[-3000:]


# -- the keywords, pinned ------------------------------------------------------------------


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)) for _ in range(2)]


def _equal(a, b):
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("kw", [dict(iters=30), dict(iters=60, tol=1e-3, block_sweeps=4),
                                dict(solver="sor", omega=1.6, iters=20),
                                dict(solver="robust", iters=12, robust_update_every=4)])
@pytest.mark.parametrize("shape", [(24, 40), (2, 24, 40)])
def test_whole_solve_ok_false_leaves_values_unchanged(kw, shape):
    i1, i2 = _pair(shape, 1)
    cfg = HSConfig(alpha=0.5, **kw)
    _equal(solver.solve_level(i1, i2, cfg, cfg.iters, whole_solve_ok=False),
           solver.solve_level(i1, i2, cfg, cfg.iters))


@pytest.mark.parametrize("shape", [(24, 40), (3, 24, 40)])
def test_custom_run_block_equals_the_default_runner(shape):
    # A runner of its own (the plain sweeps on fields it closes over) with
    # the field arguments None: the same stop, the same flow; on a stack
    # the converged images stay frozen in what it returns.
    i1, i2 = _pair(shape, 2)
    if len(shape) == 3:
        i2[1] = i1[1]  # a still pair: converges at the first check
    cfg = HSConfig(alpha=0.5, iters=80, tol=1e-3, block_sweeps=4)
    ex, ey, et, invd = k1.derivatives_plain(i1, i2, cfg.alpha)
    z = torch.zeros_like(ex)
    calls = []

    def run_block(u, v, n):
        calls.append(n)
        return k2.jacobi_sweeps_plain(u, v, ex, ey, et, invd, n)

    got = solver.sweeps_until(z, z, None, None, None, None, cfg, run_block=run_block)
    want = solver.sweeps_until(z, z, ex, ey, et, invd, cfg)
    _equal(got, want)
    assert calls and set(calls) == {4} and sum(calls) <= cfg.iters
    _equal(want, solver.solve_level(i1, i2, cfg, cfg.iters))


@pytest.mark.parametrize("median", [False, True])
def test_kernel_ok_leaves_values_unchanged(median):
    i1, i2 = (255.0 * a for a in _pair((32, 48), 3))
    rng = np.random.default_rng(4)
    u1, u2 = (torch.from_numpy(rng.normal(0, 0.5, (32, 48)).astype(np.float32))
              for _ in range(2))
    cfg = TVL1Config(iters=20, median=median)
    _equal(tvl1.tvl1_warp_iteration(i1, i2, u1, u2, cfg, kernel_ok=False),
           tvl1.tvl1_warp_iteration(i1, i2, u1, u2, cfg, kernel_ok=True))
    _equal(tvl1.tvl1_warp_iteration(i1, i2, u1, u2, cfg),
           tvl1.tvl1_warp_iteration(i1, i2, u1, u2, cfg, kernel_ok=True))


def test_checkpointed_loop_takes_uv_by_name():
    u, v = _pair((16, 24), 5)

    def step(uv):
        return uv[0] * 0.5 + uv[1], uv[1] - 0.25 * uv[0]

    _equal(stencils.checkpointed_loop(step, uv=(u, v), n=9),
           stencils.checkpointed_loop(step, (u, v), 9))
