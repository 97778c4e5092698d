"""Tiled multi-device Horn-Schunck solve, mirroring opticalflowhs_tpu/dist/tiled_solver.py.

The frames are split over a ("batch", "y", "x") mesh (dist/mesh.py): each
shard owns a tile of the image on its device. Every block of s sweeps is one
halo exchange (dist/halo.py: an s-px halo, two-phase, corners included)
followed by s sweeps on every shard: K9 (kernels/tile.py) on CUDA shards,
one launch a device for all the shards it holds, the plain masked sweeps on
CPU shards. Jacobi's order independence makes the tiled solve equal to the
untiled one given correct halos; the halo ring decays one ring a sweep
while the owned tile stays exact. SOR needs a 4s-px halo (one decaying ring
a color stage) and colors by global parity.

Any H x W: frames are zero-padded up to the mesh grid, every shard clamps
at the TRUE image edges from global coordinates, and the flow is cropped
back. Derivatives are computed once per shard from frames exchanged with an
(hw+1)-px halo, in plain torch, as the reference computes them in jnp.

halo_impl="rdma" runs the whole solve of every shard in one launch a device
(kernels/ring.py: K11 on a (y, 1) mesh, K12 on a (y, x) mesh) with the halo
exchange inside the launch; the fields' halo is exchanged once through
halo.py. On CPU shards it runs the kernels' plain versions, where the
reference raises off the TPU (ROADMAP.md queue 3).

float32 or bfloat16 (HSConfig.dtype): the frames are cast first, the
fields are stored as K1 stores them, and K9-K12's bfloat16 builds (or the
plain versions under the storage rule) round u and v where every sweep
stores them; the halos carry the stored values, so the tiled solve equals
the untiled one bitwise in both dtypes.

solver="robust" and "multigrid" take the reference's GSPMD route, which
the port runs as data parallelism over the mesh's batch axis
(dist/gspmd.py): each batch group solves its whole frames through the
untiled entry (K1 + K4, K1 + the plain V-cycles) on its first device, so
the values equal the untiled solve bitwise; they never fall through to
Jacobi.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from opticalflowhs_tpu_torch.config import HSConfig
from opticalflowhs_tpu_torch.dist import gspmd
from opticalflowhs_tpu_torch.dist.halo import move, pad_grid, unpad
from opticalflowhs_tpu_torch.dist.mesh import Mesh
from opticalflowhs_tpu_torch.kernels import ring, tile
from opticalflowhs_tpu_torch.ops import stencils
from opticalflowhs_tpu_torch.solver import Flow, resolve_backend, solve_level, storage_dtype

GSPMD_SOLVERS = ("multigrid", "robust")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class Layout:
    """Which shard lives where: batch groups x (y, x) coordinates, each a
    (bl, th, tw) tensor on its mesh device, and each device's shards in a
    fixed order (the slices of its stacked launches). `my` and `mx` (the
    mesh's y and x by default) may be 1 for a layout that does not split
    that axis: its shards then sit at y or x index 0 of the mesh."""

    def __init__(self, mesh: Mesh, groups: int, bl: int, th: int, tw: int,
                 my: Optional[int] = None, mx: Optional[int] = None):
        self.mesh, self.groups, self.bl, self.th, self.tw = mesh, groups, bl, th, tw
        self.my = mesh.shape["y"] if my is None else my
        self.mx = mesh.shape["x"] if mx is None else mx
        self.coords = [(b, i, j) for b in range(groups) for i in range(self.my)
                       for j in range(self.mx)]
        self.local: dict = {}
        for c in self.coords:
            self.local.setdefault(mesh.devices[c], []).append(c)

    def origin(self, c) -> tuple[int, int]:
        """Global (row, col) of shard c's owned pixel (0, 0)."""
        return c[1] * self.th, c[2] * self.tw

    def grid(self, shards: dict, b: int):
        return [[shards[(b, i, j)] for j in range(self.mx)] for i in range(self.my)]

    def slice_origins(self, dev, dr: int, dc: int):
        """Per-slice (rows, cols) origins of dev's stack, offset by (dr, dc)."""
        cs = [self.origin(c) for c in self.local[dev] for _ in range(self.bl)]
        return [r + dr for r, _ in cs], [c + dc for _, c in cs]

    def pad(self, shards: dict, sy: int, sx: int) -> dict:
        """Exchange (sy, sx) halos: a (n_local, bl, th+2sy, tw+2sx) stack a
        device, each shard a view of its slice."""
        first = next(iter(shards.values()))
        bufs = {dev: torch.empty((len(cs), self.bl, self.th + 2 * sy, self.tw + 2 * sx),
                                 dtype=first.dtype, device=dev)
                for dev, cs in self.local.items()}
        views = {c: bufs[dev][k] for dev, cs in self.local.items() for k, c in enumerate(cs)}
        for b in range(self.groups):
            pad_grid(self.grid(shards, b), sy, sx, out=self.grid(views, b))
        return bufs

    def split(self, stacks: dict, fn=lambda a: a) -> dict:
        """Per-device (n_local * bl, ...) stacks -> per-shard (bl, ...)."""
        out = {}
        for dev, cs in self.local.items():
            a = stacks[dev].reshape((len(cs), self.bl) + stacks[dev].shape[1:])
            for k, c in enumerate(cs):
                out[c] = fn(a[k])
        return out


def scatter(frames: torch.Tensor, lay: Layout) -> dict:
    """(B, Hp, Wp) frames -> each shard's (bl, th, tw) tile on its device."""
    out = {}
    for c in lay.coords:
        b, i, j = c
        part = frames[b * lay.bl:(b + 1) * lay.bl, i * lay.th:(i + 1) * lay.th,
                      j * lay.tw:(j + 1) * lay.tw]
        out[c] = part.to(lay.mesh.devices[c]).contiguous()
    return out


def gather(shards: dict, lay: Layout) -> torch.Tensor:
    """Each shard's (bl, th, tw) tile -> the (B, Hp, Wp) whole on the mesh's
    first device."""
    first = next(iter(shards.values()))
    out = torch.empty((lay.groups * lay.bl, lay.my * lay.th, lay.mx * lay.tw),
                      dtype=first.dtype, device=lay.mesh.first)
    for (b, i, j), t in shards.items():
        move(out[b * lay.bl:(b + 1) * lay.bl, i * lay.th:(i + 1) * lay.th,
                 j * lay.tw:(j + 1) * lay.tw], t)
    return out


def _fields(lay: Layout, f1: dict, f2: dict, cfg: HSConfig, hy: int, hx: int,
            h: int, w: int) -> dict:
    """Per device: (ex, ey, et, invd) stacks of the shards extended by (hy,
    hx), from frames exchanged with an (hy+1, hx+1)-px halo (hx = 0: no
    column halo) and the masked derivatives; plain torch on every device.
    bfloat16 frames give bfloat16 fields as K1 stores them
    (`derivatives_plain`): Ex, Ey and Et rounded, 1/den formed from the
    rounded Ex and Ey and rounded."""
    px = hx + 1 if hx else 0
    p1, p2 = lay.pad(f1, hy + 1, px), lay.pad(f2, hy + 1, px)
    out = {}
    for dev in lay.local:
        a, b = p1[dev].flatten(0, 1), p2[dev].flatten(0, 1)
        rows, cols = lay.slice_origins(dev, -(hy + 1), -px)
        masks = tile.tile_masks(a.shape, rows, cols, h, w, dev)
        ex, ey, et = stencils.store(
            lambda x, y: stencils.derivatives_masked(x, y, masks, cfg.deriv_variant), a, b)
        crop = (slice(1, -1), slice(1, -1) if hx else slice(None))
        ex, ey, et = (x[(Ellipsis,) + crop].contiguous() for x in (ex, ey, et))
        invd = stencils.store(lambda x, y: 1.0 / (cfg.alpha * cfg.alpha + x * x + y * y),
                              ex, ey)
        out[dev] = (ex, ey, et, invd)
    return out


def _per_image_delta(lay: Layout, nu, nv, u, v, h: int, w: int) -> torch.Tensor:
    """Max |update| of each image over its owned true pixels, on the first
    device: one value per image of the stack."""
    parts = []
    for c in lay.coords:
        r0, c0 = lay.origin(c)
        rows, cols = min(max(h - r0, 0), lay.th), min(max(w - c0, 0), lay.tw)
        d = torch.zeros(lay.bl, dtype=u[c].dtype, device=u[c].device)
        if rows and cols:  # a shard wholly in the zero pad owns no true pixel
            d = torch.maximum((nu[c] - u[c])[..., :rows, :cols].abs().amax(dim=(-2, -1)),
                              (nv[c] - v[c])[..., :rows, :cols].abs().amax(dim=(-2, -1)))
        parts.append(d.to(lay.mesh.first))
    d = torch.stack(parts).reshape(lay.groups, lay.my * lay.mx, lay.bl)
    return d.amax(dim=1).reshape(-1)


def tile_body(lay: Layout, f1: dict, f2: dict, cfg: HSConfig, s: int, h: int,
              w: int) -> tuple[dict, dict]:
    """The ppermute-path solve of every shard: (u, v) owned tiles."""
    is_sor = cfg.solver == "sor"
    # Halo width a block: Jacobi's halo decays one ring a sweep, SOR's one
    # ring a color stage, four a sweep.
    hw = 4 * s if is_sor else s
    fields = _fields(lay, f1, f2, cfg, hw, hw, h, w)
    probe = next(iter(f1.values()))
    cuda = resolve_backend(cfg.backend, probe) == "cuda"
    # The kernels take an origin table (built once), the plain versions the
    # (rows, cols) lists.
    origins = {}
    for dev in lay.local:
        rows, cols = lay.slice_origins(dev, -hw, -hw)
        origins[dev] = ((tile.origin_table(fields[dev][0], rows, cols),)
                        if cuda else (rows, cols))

    def block(u: dict, v: dict, n: int):
        pu, pv = lay.pad(u, hw, hw), lay.pad(v, hw, hw)
        ru, rv = {}, {}
        for dev in lay.local:
            a, b = pu[dev].flatten(0, 1), pv[dev].flatten(0, 1)
            if is_sor:
                sweep = tile.sor_tile_sweeps if cuda else tile.sor_tile_sweeps_plain
                ru[dev], rv[dev] = sweep(a, b, *fields[dev], n, cfg.omega, *origins[dev], h, w)
            else:
                sweep = tile.tile_sweeps if cuda else tile.tile_sweeps_plain
                ru[dev], rv[dev] = sweep(a, b, *fields[dev], n, *origins[dev], h, w)
        return (lay.split(ru, lambda t: unpad(t, hw)),
                lay.split(rv, lambda t: unpad(t, hw)))

    u = {c: torch.zeros((lay.bl, lay.th, lay.tw), dtype=probe.dtype, device=t.device)
         for c, t in f1.items()}
    v = {c: torch.zeros_like(t) for c, t in u.items()}
    if cfg.tol > 0:
        # Solve to tolerance: after each block every image's max |update|
        # over its owned true pixels, reduced over the mesh onto the first
        # device (one host sync a block); an image that has converged keeps
        # its flow, as the reference's vmapped while_loop keeps it. Budget:
        # cfg.iters rounded down to whole blocks. The updates are taken in
        # the flow's dtype, as `solver.sweeps_until` takes them.
        b = max(1, min(s, cfg.iters))
        first = lay.mesh.first
        delta = torch.full((lay.groups * lay.bl,), torch.finfo(probe.dtype).max,
                           dtype=probe.dtype, device=first)
        k = 0
        while k + b <= cfg.iters:
            active = delta > cfg.tol
            n_active = int(active.sum())  # the host sync of this block
            if n_active == 0:
                break
            nu, nv = block(u, v, b)
            d = _per_image_delta(lay, nu, nv, u, v, h, w)
            if n_active < active.numel():
                for c in lay.coords:
                    keep = active[c[0] * lay.bl:(c[0] + 1) * lay.bl].to(nu[c].device)
                    nu[c] = torch.where(keep[:, None, None], nu[c], u[c])
                    nv[c] = torch.where(keep[:, None, None], nv[c], v[c])
                d = torch.where(active, d, delta)
            u, v, delta = nu, nv, d
            k += b
        return u, v
    n_full, rem = divmod(cfg.iters, s)
    for _ in range(n_full):
        u, v = block(u, v, s)
    if rem:
        u, v = block(u, v, rem)
    return u, v


def tile_body_rdma(lay: Layout, f1: dict, f2: dict, cfg: HSConfig, s: int, h: int,
                   w: int) -> tuple[dict, dict]:
    """The rdma-path solve: the fields' halo once through halo.py, then all
    sweeps of every shard in one ring launch a device (K11 for x = 1, K12
    otherwise), or their plain versions."""
    sblk = max(1, min(s, cfg.iters if cfg.iters else 1))
    sx = sblk if lay.mx > 1 else 0
    fields = _fields(lay, f1, f2, cfg, sblk, sx, h, w)
    fs = [lay.split({dev: f[q] for dev, f in fields.items()}) for q in range(4)]
    probe = next(iter(f1.values()))
    shards = {}
    for c in lay.coords:
        z = torch.zeros((lay.bl, lay.th, lay.tw), dtype=probe.dtype,
                        device=lay.mesh.devices[c])
        shards[c] = ring.Shard(z, torch.zeros_like(z), tuple(f[c] for f in fs),
                               *lay.origin(c))
    solve = (ring.ring_solve if resolve_backend(cfg.backend, probe) == "cuda"
             else ring.ring_solve_plain)
    res = solve([lay.grid(shards, b) for b in range(lay.groups)], cfg.iters, sblk, h, w)
    u = {c: res[c[0]][c[1]][c[2]][0] for c in lay.coords}
    v = {c: res[c[0]][c[1]][c[2]][1] for c in lay.coords}
    return u, v


def _as_tensor(a, cfg: HSConfig) -> torch.Tensor:
    """Frames in the config's storage dtype (`solver.storage_dtype`)."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    elif not isinstance(a, torch.Tensor):
        raise TypeError(f"expected a torch tensor or numpy array, got {type(a)}")
    return a.to(storage_dtype(cfg))


def solve_gspmd(i1: torch.Tensor, i2: torch.Tensor, cfg: HSConfig, mesh: Mesh,
                iters: int) -> Flow:
    """The GSPMD route of solver="robust" and "multigrid" (and of a tiled
    pyramid's levels with them): an (H, W) pair solved whole on the mesh's
    first device, a (B, H, W) stack split over the batch groups
    (dist/gspmd.py), each through `solver.solve_level`, the untiled
    entry. To tolerance each image stops on its own, as the reference's
    vmapped `sweeps_until` with its `run_block` override."""
    return gspmd.run_pair_or_groups(lambda a, b: solve_level(a, b, cfg, iters),
                                    mesh, i1, i2)


def solve_padded(i1: torch.Tensor, i2: torch.Tensor, cfg: HSConfig, s: int,
                 mesh: Mesh, h: int, w: int, halo_impl: str = "ppermute") -> Flow:
    """(B, Hp, Wp) frames already padded to the mesh grid -> the (B, Hp, Wp)
    flow on the mesh's first device; the true image is h x w."""
    my, mx = mesh.shape["y"], mesh.shape["x"]
    bsz, hp, wp = i1.shape
    # A stack splits over the batch axis; a single pair takes its first group.
    groups = mesh.shape["batch"] if bsz % mesh.shape["batch"] == 0 else 1
    lay = Layout(mesh, groups, bsz // groups, hp // my, wp // mx)
    f1, f2 = scatter(i1, lay), scatter(i2, lay)
    body = tile_body_rdma if halo_impl == "rdma" else tile_body
    u, v = body(lay, f1, f2, cfg, s, h, w)
    return Flow(gather(u, lay), gather(v, lay))


def hs_solve_tiled(
    i1,
    i2,
    cfg: HSConfig = HSConfig(),
    mesh: Optional[Mesh] = None,
    halo_sweeps: int = 1,
    halo_impl: str = "ppermute",
) -> Flow:
    """Solve HS flow with the image tiled over the mesh axes ("y", "x").

    Takes (H, W) pairs or (B, H, W) stacks, as tensors on any device or
    numpy arrays; stacks are split over the "batch" axis too (a single pair
    uses the mesh's first batch group). Any H x W works: frames are
    zero-padded to the mesh grid, shards clamp at the true image edges, and
    the flow, on the mesh's first device, is cropped back to H x W, equal
    to the untiled solve. Shards (after padding) must be more than the halo
    wide on a side.

    halo_impl: "ppermute" (halo copies between K9 launches) or "rdma" (the
    whole solve of every shard in one ring launch a device, the exchange
    inside it: K11 on a (y, 1) mesh, K12 otherwise; Jacobi only, fixed
    sweep count). cfg.solver="sor" tiles with a 4*halo_sweeps-px halo and
    colors by global parity. cfg.solver="robust" and "multigrid" take the
    GSPMD route (`solve_gspmd`: the batch groups, each solved whole by the
    untiled entry; halo_sweeps does not enter, halo_impl must be
    "ppermute"). cfg.tol > 0 solves to tolerance: each block's
    max |update| over owned true pixels is reduced over the mesh, one host
    sync a block; each image of a stack stops on its own. cfg.dtype
    "bfloat16" solves in bfloat16 (the storage rule), equal to the untiled
    bfloat16 solve.
    """
    if mesh is None:
        raise ValueError("hs_solve_tiled requires a Mesh (dist.make_mesh)")
    if halo_sweeps < 1:
        raise ValueError("halo_sweeps must be >= 1")
    if halo_impl not in ("ppermute", "rdma"):
        raise ValueError("halo_impl must be 'ppermute' or 'rdma'")
    if cfg.solver in GSPMD_SOLVERS:
        # The GSPMD route: the whole IRLS loop or V-cycle per batch group
        # through the untiled entry (dist/gspmd.py), never Jacobi.
        if halo_impl != "ppermute":
            raise ValueError(f"tiled {cfg.solver} uses the GSPMD path; "
                             "halo_impl does not apply")
        i1, i2 = _as_tensor(i1, cfg), _as_tensor(i2, cfg)
        if i1.shape != i2.shape:
            raise ValueError(f"frame shapes differ: {tuple(i1.shape)} vs {tuple(i2.shape)}")
        return solve_gspmd(i1, i2, cfg, mesh, cfg.iters)
    if cfg.solver == "sor" and cfg.omega == 0.0:
        raise ValueError(
            "omega=0 (auto) is single-pair only — call solver.tune_omega on "
            "a representative pair and pass the result"
        )
    if cfg.solver == "sor" and halo_impl == "rdma":
        raise ValueError(
            "halo_impl='rdma' supports solver='jacobi' only (the fused ring "
            "kernel exchanges per-sweep halos, not per-color)"
        )
    if cfg.tol > 0 and halo_impl == "rdma":
        raise ValueError(
            "cfg.tol early stopping needs the ppermute halo path (the "
            "fused rdma kernel bakes a fixed sweep schedule)"
        )
    i1, i2 = _as_tensor(i1, cfg), _as_tensor(i2, cfg)
    if i1.shape != i2.shape:
        raise ValueError(f"frame shapes differ: {tuple(i1.shape)} vs {tuple(i2.shape)}")
    batched = i1.ndim == 3
    h, w = i1.shape[-2:]
    my, mx = mesh.shape["y"], mesh.shape["x"]
    if batched and i1.shape[0] % mesh.shape["batch"]:
        raise ValueError(
            f"batch {i1.shape[0]} not divisible by mesh batch {mesh.shape['batch']}"
        )
    hp, wp = _round_up(h, my), _round_up(w, mx)
    hwidth = 4 * halo_sweeps if cfg.solver == "sor" else halo_sweeps
    if hp // my <= hwidth or wp // mx <= hwidth:
        raise ValueError(
            f"tile {hp // my}x{wp // mx} too small for halo_sweeps="
            f"{halo_sweeps} (solver={cfg.solver}, halo width {hwidth})"
        )
    if not batched:
        i1, i2 = i1[None], i2[None]
    if (hp, wp) != (h, w):
        pad = (0, wp - w, 0, hp - h)
        i1 = torch.nn.functional.pad(i1, pad)
        i2 = torch.nn.functional.pad(i2, pad)
    flow = solve_padded(i1, i2, cfg, halo_sweeps, mesh, h, w, halo_impl)
    u, v = flow.u[..., :h, :w], flow.v[..., :h, :w]
    if not batched:
        u, v = u[0], v[0]
    return Flow(u.contiguous(), v.contiguous())
