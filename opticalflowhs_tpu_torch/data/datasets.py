"""Benchmark dataset loaders: Middlebury, MPI-Sintel and KITTI directory
layouts, mirroring opticalflowhs_tpu/data/datasets.py.

Config 2 runs batched HS over "Middlebury + Sintel clips"; these
loaders turn the standard on-disk layouts into frame stacks + GT flows.
No dataset ships with the package, so all
constructors take explicit roots, raise cleanly when absent, and the tests
exercise them against synthetic fixture trees.

Layouts:
  Middlebury (tools/fetch_middlebury.py):
      <root>/other-data/<seq>/frame10.png, frame11.png
      <root>/other-gt-flow/<seq>/flow10.flo
  Sintel (http://sintel.is.tue.mpg.de, training zip):
      <root>/training/<pass>/<seq>/frame_%04d.png     pass in {clean, final}
      <root>/training/flow/<seq>/frame_%04d.flo
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from opticalflowhs_tpu_torch.io.flo import read_flo
from opticalflowhs_tpu_torch.io.images import load_gray


@dataclass(frozen=True)
class FlowSample:
    """One supervised flow example: frame pair + ground truth (H, W, 2)."""

    seq: str
    index: int
    frame1: np.ndarray
    frame2: np.ndarray
    gt_flow: Optional[np.ndarray]


class MiddleburyDataset:
    """The 'other' training split: 8 two-frame sequences with GT flow."""

    def __init__(self, root: str):
        self.root = root
        img_root = os.path.join(root, "other-data")
        gt_root = os.path.join(root, "other-gt-flow")
        if not os.path.isdir(img_root):
            raise FileNotFoundError(
                f"{img_root} missing — run tools/fetch_middlebury.py"
            )
        self.sequences = []
        for seq in sorted(os.listdir(img_root)):
            f10 = os.path.join(img_root, seq, "frame10.png")
            f11 = os.path.join(img_root, seq, "frame11.png")
            if os.path.exists(f10) and os.path.exists(f11):
                self.sequences.append(seq)
        self._img_root = img_root
        self._gt_root = gt_root

    def __len__(self) -> int:
        return len(self.sequences)

    def __iter__(self) -> Iterator[FlowSample]:
        for seq in self.sequences:
            yield self.sample(seq)

    def sample(self, seq: str) -> FlowSample:
        f10 = os.path.join(self._img_root, seq, "frame10.png")
        f11 = os.path.join(self._img_root, seq, "frame11.png")
        gt_path = os.path.join(self._gt_root, seq, "flow10.flo")
        gt = read_flo(gt_path) if os.path.exists(gt_path) else None
        return FlowSample(seq, 10, load_gray(f10), load_gray(f11), gt)


class SintelDataset:
    """MPI-Sintel training split; consecutive-pair samples per sequence."""

    _FRAME_RE = re.compile(r"frame_(\d{4})\.png$")

    def __init__(self, root: str, render_pass: str = "clean"):
        if render_pass not in ("clean", "final"):
            raise ValueError("render_pass must be 'clean' or 'final'")
        self.root = root
        self._img_root = os.path.join(root, "training", render_pass)
        self._flow_root = os.path.join(root, "training", "flow")
        if not os.path.isdir(self._img_root):
            raise FileNotFoundError(f"{self._img_root} missing")
        self.sequences = sorted(
            d for d in os.listdir(self._img_root)
            if os.path.isdir(os.path.join(self._img_root, d))
        )

    def frames(self, seq: str) -> list[str]:
        d = os.path.join(self._img_root, seq)
        out = []
        for name in sorted(os.listdir(d)):
            if self._FRAME_RE.search(name):
                out.append(os.path.join(d, name))
        return out

    def clip(self, seq: str, max_frames: Optional[int] = None) -> np.ndarray:
        """(T, H, W) grayscale frame stack for a sequence."""
        paths = self.frames(seq)
        if max_frames:
            paths = paths[:max_frames]
        return np.stack([load_gray(p) for p in paths])

    def pairs(self, seq: str) -> Iterator[FlowSample]:
        paths = self.frames(seq)
        for k in range(len(paths) - 1):
            idx = int(self._FRAME_RE.search(paths[k]).group(1))
            flow_path = os.path.join(
                self._flow_root, seq, f"frame_{idx:04d}.flo"
            )
            gt = read_flo(flow_path) if os.path.exists(flow_path) else None
            yield FlowSample(
                seq, idx, load_gray(paths[k]), load_gray(paths[k + 1]), gt
            )

    def __iter__(self) -> Iterator[FlowSample]:
        for seq in self.sequences:
            yield from self.pairs(seq)


class KittiDataset:
    """KITTI 2012/2015 flow training split (sparse LIDAR-derived GT).

    Layout (2015; 2012 differs only in the image directory name):
        <root>/training/image_2/%06d_10.png, %06d_11.png
        <root>/training/flow_occ/%06d_10.png   (all valid pixels)
        <root>/training/flow_noc/%06d_10.png   (non-occluded subset)

    GT flow PNGs are 48-bit KITTI-encoded (io/kitti.py); invalid pixels are
    re-marked with the Middlebury unknown sentinel so `metrics.epe` /
    `unknown_mask` treat the sparse GT correctly with no extra plumbing.
    """

    _PAIR_RE = re.compile(r"^(\d{6})_10\.png$")
    _UNKNOWN = 1e10  # io.flo.UNKNOWN_FLOW_THRESH is 1e9

    def __init__(self, root: str, image_dir: str = "image_2",
                 gt_dir: str = "flow_occ"):
        self.root = root
        self._img_root = os.path.join(root, "training", image_dir)
        self._gt_root = os.path.join(root, "training", gt_dir)
        if not os.path.isdir(self._img_root):
            raise FileNotFoundError(f"{self._img_root} missing")
        self.frames = sorted(
            m.group(1)
            for name in os.listdir(self._img_root)
            if (m := self._PAIR_RE.match(name))
            and os.path.exists(
                os.path.join(self._img_root, f"{m.group(1)}_11.png")
            )
        )

    def __len__(self) -> int:
        return len(self.frames)

    def sample(self, frame: str) -> FlowSample:
        from opticalflowhs_tpu_torch.io.kitti import read_flow_png

        f10 = os.path.join(self._img_root, f"{frame}_10.png")
        f11 = os.path.join(self._img_root, f"{frame}_11.png")
        gt_path = os.path.join(self._gt_root, f"{frame}_10.png")
        gt = None
        if os.path.exists(gt_path):
            flow, valid = read_flow_png(gt_path)
            gt = flow.copy()
            gt[~valid] = self._UNKNOWN
        return FlowSample(frame, 10, load_gray(f10), load_gray(f11), gt)

    def __iter__(self) -> Iterator[FlowSample]:
        for frame in self.frames:
            yield self.sample(frame)


def evaluate(dataset, solve_fn, limit: Optional[int] = None
             ) -> dict[str, dict[str, float]]:
    """Run solve_fn(frame1, frame2) -> (H, W, 2) over a dataset.

    Returns {seq: {"epe": ..., "ae": ..., "n": ...}} (mean endpoint and
    Barron angular error over the sequence's GT-bearing samples — unknown
    GT pixels are excluded by metrics' sentinel masking) plus an "ALL" row
    averaging over every evaluated sample. Samples without GT are skipped;
    `limit` caps the number of evaluated samples (dataset order).
    """
    from collections import defaultdict

    from opticalflowhs_tpu_torch.metrics import angular_error, epe

    rows: dict[str, list[tuple[float, float]]] = defaultdict(list)
    n_done = 0
    for s in dataset:
        # Limit check first: once satisfied, stop iterating entirely rather
        # than keep decoding frames of GT-less samples just to skip them.
        if limit is not None and n_done >= limit:
            break
        if s.gt_flow is None:
            continue
        if s.seq == "ALL":
            raise ValueError(
                "sequence name 'ALL' collides with the aggregate row"
            )
        flow = np.asarray(solve_fn(s.frame1, s.frame2))
        rows[s.seq].append((epe(flow, s.gt_flow),
                            angular_error(flow, s.gt_flow)))
        n_done += 1
    out = {
        seq: {
            "epe": float(np.mean([r[0] for r in v])),
            "ae": float(np.mean([r[1] for r in v])),
            "n": len(v),
        }
        for seq, v in rows.items()
    }
    allv = [r for v in rows.values() for r in v]
    if allv:
        out["ALL"] = {
            "epe": float(np.mean([r[0] for r in allv])),
            "ae": float(np.mean([r[1] for r in allv])),
            "n": len(allv),
        }
    return out


def evaluate_epe(dataset, solve_fn) -> dict[str, float]:
    """Back-compat thin wrapper over `evaluate`: per-sequence mean EPE."""
    return {
        seq: row["epe"]
        for seq, row in evaluate(dataset, solve_fn).items()
        if seq != "ALL"
    }
