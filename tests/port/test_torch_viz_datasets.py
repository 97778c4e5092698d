"""The port's renders (viz), metrics log (logging_util) and dataset readers
(data.datasets) against the reference's on the same inputs.

Bars, each with its reason:
  * renders bitwise: the same float64 NumPy arithmetic on the same values
    (a tensor, on any device, is copied to the host first);
  * `log_metrics` records equal but for "ts", the time of writing;
  * dataset samples bitwise (the same readers on the same files), and
    `evaluate` tables equal for the same numpy solve function.
"""

import json
import logging

import numpy as np
import pytest
import torch

import opticalflowhs_tpu.data.datasets as ref_ds
import opticalflowhs_tpu.logging_util as ref_log
import opticalflowhs_tpu.viz as ref_viz
from opticalflowhs_tpu.io.flo import write_flo
from opticalflowhs_tpu.io.images import save_image
from opticalflowhs_tpu.io.kitti import write_flow_png
import opticalflowhs_tpu_torch.data.datasets as ds
import opticalflowhs_tpu_torch.logging_util as log
import opticalflowhs_tpu_torch.viz as viz

torch.set_num_threads(1)


def _flow(seed, h=24, w=32, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, scale, (h, w, 2))).astype(np.float32)


def _equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_color_wheel_matches_reference():
    assert _equal(viz.make_color_wheel(), ref_viz.make_color_wheel())
    assert viz.NCOLS == ref_viz.NCOLS == 55


@pytest.mark.parametrize("max_flow", [None, 2.5, 100.0])
@pytest.mark.parametrize("unknown_black", [True, False])
def test_flow_to_color_matches_reference(max_flow, unknown_black):
    f = _flow(1)
    f[0, 0] = (np.nan, 0.0)
    f[1, 2] = (2e9, 1.0)          # the .flo unknown sentinel
    f[3, 4] = (0.0, -np.inf)
    f[5] = 0.0                     # a row of zero flow
    got = viz.flow_to_color(f, max_flow=max_flow, unknown_black=unknown_black)
    assert _equal(got, ref_viz.flow_to_color(f, max_flow=max_flow,
                                             unknown_black=unknown_black))


def test_flow_to_color_takes_tensors():
    f = _flow(2)
    want = ref_viz.flow_to_color(f)
    assert _equal(viz.flow_to_color(torch.from_numpy(f)), want)
    assert _equal(viz.flow_to_color(torch.from_numpy(f).double()), want)
    zero = np.zeros((6, 7, 2), np.float32)  # the radius floor
    assert _equal(viz.flow_to_color(zero), ref_viz.flow_to_color(zero))


@pytest.mark.parametrize("background", ["none", "float", "uint8", "rgb", "tensor"])
@pytest.mark.parametrize("step,scale", [(16, 1.0), (5, 3.5)])
def test_needle_plot_matches_reference(background, step, scale):
    f = _flow(3, 40, 56, scale=4.0)
    rng = np.random.default_rng(4)
    bg = {"none": None,
          "float": rng.uniform(-0.2, 1.2, (40, 56)).astype(np.float32),
          "uint8": rng.integers(0, 256, (40, 56)).astype(np.uint8),
          "rgb": rng.integers(0, 256, (40, 56, 3)).astype(np.uint8),
          "tensor": rng.uniform(0, 1, (40, 56)).astype(np.float32)}[background]
    want = ref_viz.needle_plot(f, step=step, scale=scale, background=bg)
    port_bg = torch.from_numpy(bg) if background == "tensor" else bg
    got = viz.needle_plot(torch.from_numpy(f), step=step, scale=scale,
                          background=port_bg)
    assert _equal(got, want)


def test_log_metrics_records_match_reference(tmp_path):
    rec = {"cell": "C1", "ms": 0.883, "shape": [1088, 1920], "ok": True}
    log.log_metrics(str(tmp_path / "sub" / "port.jsonl"), rec)
    log.log_metrics(str(tmp_path / "sub" / "port.jsonl"), {"n": 2})
    ref_log.log_metrics(str(tmp_path / "sub" / "ref.jsonl"), rec)
    ref_log.log_metrics(str(tmp_path / "sub" / "ref.jsonl"), {"n": 2})
    got = [json.loads(x) for x in (tmp_path / "sub" / "port.jsonl").read_text().splitlines()]
    want = [json.loads(x) for x in (tmp_path / "sub" / "ref.jsonl").read_text().splitlines()]
    assert all(isinstance(r.pop("ts"), float) for r in got + want)
    assert got == want


def test_get_logger_matches_reference():
    lg = log.get_logger("hsflow-port-test")
    assert isinstance(lg, logging.Logger) and lg.name == "hsflow-port-test"
    assert log.get_logger("hsflow-port-test") is lg and len(lg.handlers) == 1
    assert not lg.propagate
    assert lg.handlers[0].formatter._fmt == ref_log._FORMAT


# -- dataset trees, written with the reference's writers ---------------------------


def _img(seed, h=16, w=24):
    return np.random.default_rng(seed).uniform(0, 1, (h, w)).astype(np.float32)


@pytest.fixture
def middlebury_root(tmp_path):
    root = tmp_path / "mb"
    for k, seq in enumerate(("Grove2", "RubberWhale", "Urban3")):
        d = root / "other-data" / seq
        d.mkdir(parents=True)
        save_image(d / "frame10.png", _img(2 * k))
        save_image(d / "frame11.png", _img(2 * k + 1))
        if seq != "RubberWhale":  # a sequence without GT
            g = root / "other-gt-flow" / seq
            g.mkdir(parents=True)
            write_flo(g / "flow10.flo", _flow(10 + k, 16, 24, 1.0))
    (root / "other-data" / "Incomplete").mkdir()  # no frames: not a sequence
    return str(root)


@pytest.fixture
def sintel_root(tmp_path):
    root = tmp_path / "sintel"
    for k, seq in enumerate(("alley_1", "bandage_2")):
        for render in ("clean", "final"):
            d = root / "training" / render / seq
            d.mkdir(parents=True)
            for t in range(1, 5):
                save_image(d / f"frame_{t:04d}.png", _img(10 * k + t))
            (d / "notes.txt").write_text("not a frame")
        f = root / "training" / "flow" / seq
        f.mkdir(parents=True)
        for t in range(1, 4 - k):  # bandage_2 lacks its last flow
            write_flo(f / f"frame_{t:04d}.flo", _flow(20 + t, 16, 24, 0.5))
    return str(root)


@pytest.fixture
def kitti_root(tmp_path):
    root = tmp_path / "kitti"
    img = root / "training" / "image_2"
    img.mkdir(parents=True)
    rng = np.random.default_rng(30)
    for gt_dir in ("flow_occ", "flow_noc"):
        (root / "training" / gt_dir).mkdir()
    for k in range(3):
        for t in (10, 11):
            save_image(img / f"{k:06d}_{t}.png", _img(40 + 2 * k + t % 2))
        if k < 2:
            flow = np.round(_flow(50 + k, 16, 24, 4.0) * 64) / 64
            valid = rng.uniform(size=(16, 24)) > 0.4
            write_flow_png(root / "training" / "flow_occ" / f"{k:06d}_10.png", flow, valid)
            write_flow_png(root / "training" / "flow_noc" / f"{k:06d}_10.png", flow,
                           valid & (rng.uniform(size=(16, 24)) > 0.5))
    save_image(img / "000009_10.png", _img(60))  # no second frame: not a pair
    return str(root)


def _same_samples(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.seq, g.index) == (w.seq, w.index)
        assert _equal(g.frame1, w.frame1) and _equal(g.frame2, w.frame2)
        assert (g.gt_flow is None) == (w.gt_flow is None)
        if g.gt_flow is not None:
            assert _equal(g.gt_flow, w.gt_flow)


def _datasets(kind, root):
    if kind == "middlebury":
        return ds.MiddleburyDataset(root), ref_ds.MiddleburyDataset(root)
    if kind.startswith("sintel"):
        render = kind.split("_")[1]
        return (ds.SintelDataset(root, render_pass=render),
                ref_ds.SintelDataset(root, render_pass=render))
    gt_dir = kind.split("_", 1)[1]
    return (ds.KittiDataset(root, gt_dir=gt_dir),
            ref_ds.KittiDataset(root, gt_dir=gt_dir))


@pytest.fixture
def roots(middlebury_root, sintel_root, kitti_root):
    return {"middlebury": middlebury_root, "sintel": sintel_root, "kitti": kitti_root}


KINDS = ["middlebury", "sintel_clean", "sintel_final", "kitti_flow_occ", "kitti_flow_noc"]


@pytest.mark.parametrize("kind", KINDS)
def test_dataset_samples_match_reference(roots, kind):
    port, ref = _datasets(kind, roots[kind.split("_")[0]])
    _same_samples(port, ref)
    if kind == "middlebury":
        assert port.sequences == ref.sequences and len(port) == len(ref) == 3
        _same_samples([port.sample("Urban3")], [ref.sample("Urban3")])
    elif kind.startswith("sintel"):
        assert port.sequences == ref.sequences
        for seq in port.sequences:
            assert port.frames(seq) == ref.frames(seq)
            _same_samples(port.pairs(seq), ref.pairs(seq))
            assert _equal(port.clip(seq), ref.clip(seq))
            assert _equal(port.clip(seq, max_frames=2), ref.clip(seq, max_frames=2))
    else:
        assert port.frames == ref.frames and len(port) == len(ref) == 3
        _same_samples([port.sample("000001")], [ref.sample("000001")])


def test_dataset_refusals_match_reference(tmp_path, sintel_root):
    for port_cls, ref_cls in ((ds.MiddleburyDataset, ref_ds.MiddleburyDataset),
                              (ds.SintelDataset, ref_ds.SintelDataset),
                              (ds.KittiDataset, ref_ds.KittiDataset)):
        msgs = []
        for cls in (port_cls, ref_cls):
            with pytest.raises(FileNotFoundError) as e:
                cls(str(tmp_path / "absent"))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for cls in (ds.SintelDataset, ref_ds.SintelDataset):
        with pytest.raises(ValueError, match="render_pass must be 'clean' or 'final'"):
            cls(sintel_root, render_pass="albedo")


def _solve(f1, f2):
    """A fixed numpy solve: a flow that depends on both frames."""
    d = (f2 - f1).astype(np.float32)
    return np.stack([d * 3.0 + 0.25, np.roll(f1, 1, axis=1) - 0.5], axis=-1)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("limit", [None, 1, 2])
def test_evaluate_tables_match_reference(roots, kind, limit):
    port, ref = _datasets(kind, roots[kind.split("_")[0]])
    got = ds.evaluate(port, _solve, limit=limit)
    want = ref_ds.evaluate(ref, _solve, limit=limit)
    assert got == want and "ALL" in got
    if limit is not None:
        assert got["ALL"]["n"] == limit
    assert ds.evaluate_epe(port, _solve) == ref_ds.evaluate_epe(ref, _solve)


def test_evaluate_refuses_a_sequence_named_all():
    gt = np.zeros((4, 5, 2), np.float32)
    samples = [ds.FlowSample("ALL", 10, np.zeros((4, 5), np.float32),
                             np.zeros((4, 5), np.float32), gt)]
    ref_samples = [ref_ds.FlowSample(*s.__dict__.values()) for s in samples]
    msgs = []
    for mod, data in ((ds, samples), (ref_ds, ref_samples)):
        with pytest.raises(ValueError) as e:
            mod.evaluate(data, _solve)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "sequence name 'ALL' collides with the aggregate row"
    assert ds.evaluate([], _solve) == ref_ds.evaluate([], _solve) == {}
