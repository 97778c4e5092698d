"""The port's file I/O (opticalflowhs_tpu_torch.io) against the reference's
on the same files and arrays.

Bars, each with its reason:
  * every decode is bitwise equal: the same NumPy operations on the same
    bytes (PNM, Pillow, png16, KITTI, libhsio);
  * every encode is byte-identical: png16's chunks and zlib level 6, the
    PNM headers, KITTI's rounding and clip, one libhsio for both packages;
  * the png16 branch of `load_gray` (neither Pillow nor OpenCV imports)
    equals the reference's Pillow decode bitwise: the same samples scaled
    by the same float32 operations.
"""

import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import opticalflowhs_tpu.io as ref_io
from opticalflowhs_tpu.io import images as ref_images
from opticalflowhs_tpu.io import kitti as ref_kitti
from opticalflowhs_tpu.io import native as ref_native
from opticalflowhs_tpu.io import png16 as ref_png16
import opticalflowhs_tpu_torch.io as io
from opticalflowhs_tpu_torch.io import images, kitti, native, png16

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parents[1] / "data"


def _equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _pnm_bytes(magic: bytes, img: np.ndarray, maxval: int) -> bytes:
    """A PNM file with comments in its header, as cameras and tools write."""
    h, w = img.shape[:2]
    head = (magic + b"\n# made by a test\n" + f"{w} {h}\n".encode()
            + b"# maxval next\n" + f"{maxval}\n".encode())
    if magic in (b"P2", b"P3"):
        return head + " ".join(str(int(v)) for v in img.ravel()).encode() + b"\n"
    dtype = ">u2" if maxval > 255 else "u1"
    return head + img.astype(dtype).tobytes()


@pytest.mark.parametrize("magic", [b"P2", b"P3", b"P5", b"P6"])
@pytest.mark.parametrize("maxval", [255, 1023, 65535])
def test_pnm_decode_matches_reference(tmp_path, magic, maxval):
    rng = np.random.default_rng(maxval)
    shape = (13, 17, 3) if magic in (b"P3", b"P6") else (13, 17)
    img = rng.integers(0, maxval + 1, shape)
    ext = ".ppm" if magic in (b"P3", b"P6") else ".pgm"
    p = tmp_path / f"f{ext}"
    p.write_bytes(_pnm_bytes(magic, img, maxval))
    got = images.load_gray(p)
    assert _equal(got, ref_images.load_gray(p))
    assert got.shape == (13, 17)


@pytest.mark.parametrize("ext", [".pgm", ".ppm", ".png"])
@pytest.mark.parametrize("kind", ["float_gray", "uint8_rgb", "float_rgb"])
def test_save_image_bytes_match_reference(tmp_path, ext, kind):
    rng = np.random.default_rng(3)
    img = {"float_gray": rng.uniform(-0.1, 1.1, (11, 14)).astype(np.float32),
           "uint8_rgb": rng.integers(0, 256, (11, 14, 3)).astype(np.uint8),
           "float_rgb": rng.uniform(0, 1, (11, 14, 3))}[kind]
    if ext == ".pgm" and img.ndim == 3:
        ext = ".pnm"
    images.save_image(tmp_path / f"port{ext}", img)
    ref_images.save_image(tmp_path / f"ref{ext}", img)
    assert (tmp_path / f"port{ext}").read_bytes() == (tmp_path / f"ref{ext}").read_bytes()
    assert _equal(images.load_gray(tmp_path / f"port{ext}"),
                  ref_images.load_gray(tmp_path / f"ref{ext}"))


def _pillow_pngs(tmp_path):
    """8-bit grey, 8-bit RGB, the 16-bit fixture, and a frame of 0s and 1s
    (which the `max() > 1` rule leaves unscaled), written by Pillow."""
    from PIL import Image

    rng = np.random.default_rng(5)
    out = {"fixture16": FIXTURES / "fixture_frame1.png"}
    arrays = {"gray8": rng.integers(0, 256, (37, 53)).astype(np.uint8),
              "rgb8": rng.integers(0, 256, (37, 53, 3)).astype(np.uint8),
              "binary": rng.integers(0, 2, (37, 53)).astype(np.uint8)}
    for name, arr in arrays.items():
        out[name] = tmp_path / f"{name}.png"
        Image.fromarray(arr).save(out[name])
    return out


def test_png_through_pillow_matches_reference(tmp_path):
    for name, p in _pillow_pngs(tmp_path).items():
        assert _equal(images.load_gray(p), ref_images.load_gray(p)), name


def _without_pillow_and_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    monkeypatch.setitem(sys.modules, "cv2", None)


def test_png16_branch_equals_the_references_pillow_decode(tmp_path, monkeypatch):
    pngs = _pillow_pngs(tmp_path)
    want = {name: ref_images.load_gray(p) for name, p in pngs.items()}
    assert want["binary"].max() == 1.0  # 0s and 1s stay unscaled
    _without_pillow_and_cv2(monkeypatch)
    with pytest.raises(ImportError):
        ref_images.load_gray(pngs["gray8"])  # where the reference stops
    for name, p in pngs.items():
        assert _equal(images.load_gray(p), want[name]), name


def test_png16_branch_16bit_rgb_keeps_pillows_high_bytes(tmp_path, monkeypatch):
    rng = np.random.default_rng(6)
    p = tmp_path / "rgb16.png"
    png16.write_png(p, rng.integers(0, 65536, (9, 12, 3)).astype(np.uint16))
    want = ref_images.load_gray(p)  # Pillow reads 48-bit RGB as 8-bit RGB
    _without_pillow_and_cv2(monkeypatch)
    assert _equal(images.load_gray(p), want)


def test_png16_branch_saves_what_pillow_reads_back(tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    gray = rng.uniform(0, 1, (10, 15)).astype(np.float32)
    rgb = rng.integers(0, 256, (10, 15, 3)).astype(np.uint8)
    _without_pillow_and_cv2(monkeypatch)
    images.save_image(tmp_path / "g.png", gray)
    images.save_image(tmp_path / "c.png", rgb)
    with pytest.raises(ImportError):
        images.save_image(tmp_path / "c.jpg", rgb)
    with pytest.raises(ImportError):
        images.load_gray(tmp_path / "c.jpg")
    monkeypatch.undo()
    from PIL import Image

    want = np.clip(gray * 255.0 + 0.5, 0, 255).astype(np.uint8)
    assert _equal(np.asarray(Image.open(tmp_path / "g.png")), want)
    assert _equal(np.asarray(Image.open(tmp_path / "c.png")), rgb)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 3])
def test_png16_writes_the_references_bytes(tmp_path, dtype, channels):
    rng = np.random.default_rng(8)
    shape = (19, 23) if channels == 1 else (19, 23, 3)
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    png16.write_png(tmp_path / "port.png", img)
    ref_png16.write_png(tmp_path / "ref.png", img)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "ref.png").read_bytes()
    assert _equal(png16.read_png(tmp_path / "port.png"), img)


def _filtered_png(path, recon: np.ndarray, w: int, depth: int, color: int, bpp: int):
    """A PNG whose scanline y uses filter y % 5 (PNG spec §9)."""
    h, stride = recon.shape
    raw = bytearray()
    for y in range(h):
        ft = y % 5
        raw.append(ft)
        prev = recon[y - 1] if y else np.zeros(stride, np.uint8)
        for c in range(stride):
            a = int(recon[y, c - bpp]) if c >= bpp else 0
            b = int(prev[c])
            cc = int(prev[c - bpp]) if c >= bpp else 0
            p = a + b - cc
            pred = (0, a, b, (a + b) // 2,
                    a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(p - cc)
                    else (b if abs(p - b) <= abs(p - cc) else cc))[ft]
            raw.append((int(recon[y, c]) - pred) & 0xFF)

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                           + chunk(b"IDAT", zlib.compress(bytes(raw)))
                           + chunk(b"IEND", b""))


@pytest.mark.parametrize("depth,color,ch", [(8, 0, 1), (8, 2, 3), (16, 0, 1), (16, 2, 3)])
def test_png16_reads_all_five_filters_as_the_reference(tmp_path, depth, color, ch):
    rng = np.random.default_rng(9)
    w, bpp = 11, ch * depth // 8
    recon = rng.integers(0, 256, (10, w * bpp)).astype(np.uint8)
    p = tmp_path / "filters.png"
    _filtered_png(p, recon, w, depth, color, bpp)
    got = png16.read_png(p)
    assert _equal(got, ref_png16.read_png(p))
    if depth == 8:
        assert np.array_equal(got.reshape(10, -1), recon)


def test_png16_reads_pillows_adaptive_filters_as_the_reference(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(10)
    y, x = np.mgrid[0:40, 0:60]
    for name, arr in {"gradient": ((x * 4 + y * 2) % 256).astype(np.uint8),
                      "noise": rng.integers(0, 256, (40, 60, 3)).astype(np.uint8),
                      "gray16": (x * 1000 + y * 7).astype(np.uint16)}.items():
        p = tmp_path / f"{name}.png"
        Image.fromarray(arr).save(p)
        got = png16.read_png(p)
        assert _equal(got, ref_png16.read_png(p)), name
        assert np.array_equal(got, arr), name


def _flows(rng, h=17, w=23):
    flow = rng.uniform(-10, 10, (h, w, 2)).astype(np.float32)
    flow[0, 0] = (600.0, -700.0)  # beyond the format's range: clipped
    valid = rng.uniform(size=(h, w)) > 0.3
    valid[0, 0] = True
    return flow, valid


@pytest.mark.parametrize("with_valid", [False, True])
def test_kitti_write_bytes_and_read_match_reference(tmp_path, with_valid):
    flow, valid = _flows(np.random.default_rng(11))
    v = valid if with_valid else None
    kitti.write_flow_png(tmp_path / "port.png", flow, v)
    ref_kitti.write_flow_png(tmp_path / "ref.png", flow, v)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "ref.png").read_bytes()
    got, got_valid = kitti.read_flow_png(tmp_path / "port.png")
    want, want_valid = ref_kitti.read_flow_png(tmp_path / "port.png")
    assert _equal(got, want) and _equal(got_valid, want_valid)
    expect_valid = valid if with_valid else np.ones_like(valid)
    assert np.array_equal(got_valid, expect_valid)
    assert np.all(got[~expect_valid] == 0.0)
    assert got[0, 0].tolist() == [511.984375, -511.984375]  # clipped to +-(2^15 - 1) / 64
    inside = expect_valid.copy()
    inside[0, 0] = False
    # half a 1/64 px step, plus half a float32 ulp of the 2^15-offset value
    assert np.abs(got[inside] - flow[inside]).max() <= (0.5 + 2**-9) / 64


def test_kitti_refusals_match_reference(tmp_path):
    for bad in (np.zeros((4, 5, 3), np.float32), np.zeros((4, 5), np.float32)):
        for mod in (kitti, ref_kitti):
            with pytest.raises(ValueError, match=r"expected \(H, W, 2\) flow"):
                mod.write_flow_png(tmp_path / "x.png", bad)
    for mod in (kitti, ref_kitti):
        with pytest.raises(ValueError, match="valid mask"):
            mod.write_flow_png(tmp_path / "x.png", np.zeros((4, 5, 2), np.float32),
                               np.ones((5, 4), bool))
    # A grey PNG: png16 refuses its shape, or libhsio with OpenCV its decode.
    png16.write_png(tmp_path / "gray.png", np.zeros((4, 5), np.uint16))
    errors = []
    for mod in (kitti, ref_kitti):
        with pytest.raises((ValueError, OSError)) as e:
            mod.read_flow_png(tmp_path / "gray.png")
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("ext", [".flo", ".png", ".FLO", ".PNG"])
def test_read_write_flow_by_extension_match_reference(tmp_path, ext):
    flow, _ = _flows(np.random.default_rng(12))
    io.write_flow(tmp_path / f"port{ext}", flow)
    ref_io.write_flow(tmp_path / f"ref{ext}", flow)
    assert (tmp_path / f"port{ext}").read_bytes() == (tmp_path / f"ref{ext}").read_bytes()
    assert _equal(io.read_flow(tmp_path / f"port{ext}"), ref_io.read_flow(tmp_path / f"ref{ext}"))


# -- the native library: the same libhsio.so through both bindings ----------------


@pytest.fixture(scope="module")
def hsio():
    if not native.build():
        pytest.skip("no C++ toolchain available to build libhsio")
    if not (native.available() and ref_native.available()):
        pytest.skip("libhsio built but failed to load")
    return native


def test_native_binds_the_references_library(hsio):
    assert hsio._LIB_PATH == ref_native._LIB_PATH
    assert hsio.codecs() == ref_native.codecs()
    assert hsio.video_available() == ref_native.video_available()
    for p in ("a.pgm", "b.PPM", "c.png", "d.jpg", "e.flo"):
        assert hsio.can_decode(p) == ref_native.can_decode(p)


@pytest.mark.parametrize("kind", ["pgm", "ppm", "pgm16", "png"])
def test_native_load_gray_matches_reference(hsio, tmp_path, kind):
    rng = np.random.default_rng(13)
    if kind == "pgm16":
        p = tmp_path / "f.pgm"
        p.write_bytes(_pnm_bytes(b"P5", rng.integers(0, 65536, (21, 30)), 65535))
    else:
        p = tmp_path / f"f.{kind}"
        shape = (21, 30, 3) if kind == "ppm" else (21, 30)
        ref_images.save_image(p, rng.uniform(0, 1, shape).astype(np.float32))
    assert _equal(hsio.load_gray(str(p)), ref_native.load_gray(str(p)))


def test_native_flo_and_png16_match_reference(hsio, tmp_path):
    rng = np.random.default_rng(14)
    f = rng.normal(size=(19, 31, 2)).astype(np.float32)
    hsio.write_flo(str(tmp_path / "port.flo"), f)
    ref_native.write_flo(str(tmp_path / "ref.flo"), f)
    assert (tmp_path / "port.flo").read_bytes() == (tmp_path / "ref.flo").read_bytes()
    assert _equal(hsio.read_flo(str(tmp_path / "ref.flo")),
                  ref_native.read_flo(str(tmp_path / "port.flo")))
    img = rng.integers(0, 65536, (9, 14, 3)).astype(np.uint16)
    wrote = hsio.write_png16(str(tmp_path / "port.png"), img)
    assert wrote == ref_native.write_png16(str(tmp_path / "ref.png"), img)
    if wrote:  # the library holds the OpenCV codecs
        assert (tmp_path / "port.png").read_bytes() == (tmp_path / "ref.png").read_bytes()
    png16.write_png(tmp_path / "py.png", img)
    got, want = hsio.read_png16(str(tmp_path / "py.png")), ref_native.read_png16(
        str(tmp_path / "py.png"))
    assert (got is None and want is None) or _equal(got, want)


def test_native_stream_frames_order_and_values_match_reference(hsio, tmp_path):
    rng = np.random.default_rng(15)
    paths = []
    for k in range(11):
        shape = (20, 32) if k != 7 else (24, 36)  # one larger frame: the buffer grows
        p = str(tmp_path / f"f{k:02d}.pgm")
        ref_images.save_image(p, rng.uniform(0, 1, shape).astype(np.float32))
        paths.append(p)
    got = list(hsio.stream_frames(paths, n_threads=3, prefetch=4))
    want = list(ref_native.stream_frames(paths, n_threads=3, prefetch=4))
    assert len(got) == len(want) == 11
    for g, w, p in zip(got, want, paths):
        assert _equal(g, w) and _equal(g, images.load_gray(p))
    # each yield is a copy of the reused buffer
    assert len({id(g) for g in got}) == 11 and not np.shares_memory(got[0], got[1])
