"""Checkpoint and resume of a solve's state, mirroring
opticalflowhs_tpu/checkpoint.py.

A fixed-count solve is chunked into `cfg.checkpoint_every`-sweep segments,
each a warm-started `hs_solve`; after each segment the state (u, v, the
sweeps done, a hash of the config and one of the frames) is written as
.npz, atomically (a temporary file, then a rename). Chunked Jacobi sweeps
compose exactly, so a resumed solve equals an uninterrupted one bitwise.
On the card every segment after the first is a warm start: in the
4K class of K7 (and the fused class of K6) a resumed segment runs that
kernel's warm path.

The .npz keys (u, v, sweeps_done, cfg_hash, input_hash) and both hashes
are the reference's, computed the same way, so a checkpoint that the JAX
package wrote for a config whose backend is "auto" (the field values are
hashed, and the two packages name their other backends differently)
resumes here, and one written here resumes there.

bfloat16 state (HSConfig.dtype="bfloat16") is stored as its float32
widening, which is exact, under one more key, `dtype`, and read back to
bfloat16. The reference stores a bfloat16 flow as 2-byte values (numpy
reads them as |V2 without ml_dtypes); those are read exactly, as bfloat16.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from opticalflowhs_tpu_torch.config import HSConfig, config_hash
from opticalflowhs_tpu_torch.io.host import host_array
from opticalflowhs_tpu_torch.solver import Flow, as_frame, hs_solve, target_device


def checkpoint_path(path: str, tag) -> str:
    """Suffix `path` with a per-process tag (per-shard saves)."""
    root, ext = os.path.splitext(path)
    return f"{root}.{tag}{ext or '.npz'}"


def _host(a) -> np.ndarray:
    return host_array(a)


def frames_hash(i1, i2) -> str:
    """Short hash of a frame pair (shape, dtype and the host bytes), the
    reference's: the same numpy frames give the same hash in both packages.
    Tensors are hashed as their host copies."""
    m = hashlib.sha256()
    for a in (i1, i2):
        a = _host(a)
        m.update(str((a.shape, str(a.dtype))).encode())
        m.update(np.ascontiguousarray(a).tobytes())
    return m.hexdigest()[:16]


def save_state(path: str, flow: Flow, sweeps_done: int, cfg: HSConfig,
               input_hash: str = "") -> None:
    """Write the solver state as .npz, atomically (a temporary file in the
    same directory, then a rename)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                u=_host(flow.u),
                v=_host(flow.v),
                sweeps_done=np.int64(sweeps_done),
                cfg_hash=np.bytes_(config_hash(cfg).encode()),
                input_hash=np.bytes_(input_hash.encode()),
                dtype=np.bytes_(str(flow.u.dtype).removeprefix("torch.").encode()),
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_state(path: str, cfg: Optional[HSConfig] = None, input_hash: str = "",
               device=None):
    """-> (Flow on `device`, sweeps_done). `device` is cuda:0 when None, as
    for the entry points. Raises ValueError when `cfg` is given and its
    hash differs from the stored one, or when both the checkpoint and the
    caller have a frames hash and they differ."""
    dev = target_device(device)
    with np.load(path) as z:
        if cfg is not None:
            stored = bytes(z["cfg_hash"]).decode()
            if stored != config_hash(cfg):
                raise ValueError(
                    f"checkpoint {path} was written with a different config "
                    f"(hash {stored} != {config_hash(cfg)})"
                )
        if input_hash and "input_hash" in z:
            # An empty hash round-trips through npz as NUL padding.
            stored_ih = bytes(z["input_hash"]).decode().strip("\x00 ")
            if stored_ih and stored_ih != input_hash:
                raise ValueError(
                    f"checkpoint {path} was written for a different frame "
                    f"pair (input hash {stored_ih} != {input_hash})"
                )
        bf16 = "dtype" in z and bytes(z["dtype"]).decode() == "bfloat16"
        flow = Flow(*(_state_tensor(z[k], bf16).to(dev) for k in ("u", "v")))
        return flow, int(z["sweeps_done"])


def _state_tensor(a: np.ndarray, bf16: bool) -> torch.Tensor:
    """A stored u or v as a tensor: 2-byte void values (the reference's
    bfloat16 arrays, saved through ml_dtypes) are bfloat16 bit patterns;
    float32 values recorded as bfloat16 state are cast back, exactly."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view("<i2").copy()).view(torch.bfloat16)
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if bf16 else t


def hs_solve_checkpointed(i1, i2, cfg: HSConfig, path: str,
                          resume: bool = True, device=None) -> Flow:
    """`hs_solve` with a state save every cfg.checkpoint_every sweeps and
    resume from a checkpoint at `path` (when resume=True and it exists);
    the result equals an uninterrupted cfg.iters-sweep solve bitwise.
    Frames as for `hs_solve` (numpy arrays go to `device`)."""
    k = cfg.checkpoint_every
    if k <= 0:
        raise ValueError("cfg.checkpoint_every must be > 0 for checkpointed solve")
    ih = frames_hash(i1, i2)
    i1 = as_frame(i1, device)
    i2 = as_frame(i2, i1.device)
    done = 0
    flow: Optional[Flow] = None
    if resume and os.path.exists(path):
        flow, done = load_state(path, cfg, input_hash=ih, device=i1.device)
        if done > cfg.iters:
            raise ValueError(
                f"checkpoint {path} records {done} sweeps but cfg.iters is "
                f"{cfg.iters}; refusing to return an over-iterated flow"
            )
    while done < cfg.iters:
        step = min(k, cfg.iters - done)
        flow = hs_solve(i1, i2, dataclasses.replace(cfg, iters=step), init=flow)
        done += step
        save_state(path, flow, done, cfg, input_hash=ih)
    if flow is None:  # iters == 0
        flow = hs_solve(i1, i2, dataclasses.replace(cfg, iters=0))
    return flow
