"""Flow-field and image files, mirroring opticalflowhs_tpu/io/: Middlebury
.flo, KITTI flow PNGs, PNM/PNG frames, the pure-numpy PNG codec and the
native libhsio binding (io.native)."""

from opticalflowhs_tpu_torch.io.flo import read_flo, write_flo
from opticalflowhs_tpu_torch.io.images import load_gray, save_image
from opticalflowhs_tpu_torch.io.kitti import read_flow_png, write_flow_png


def write_flow(path, flow, valid=None) -> None:
    """Write a flow field, format by extension: .flo (Middlebury) or
    .png (KITTI 48-bit encoding; io/kitti.py)."""
    if str(path).lower().endswith(".png"):
        write_flow_png(path, flow, valid)
    else:
        write_flo(path, flow)


def read_flow(path):
    """Read a .flo or KITTI .png flow file -> (H, W, 2) float32 (KITTI
    invalid pixels carry zero flow; use read_flow_png for the mask)."""
    if str(path).lower().endswith(".png"):
        return read_flow_png(path)[0]
    return read_flo(path)


__all__ = [
    "read_flo", "write_flo", "load_gray", "save_image",
    "read_flow_png", "write_flow_png", "read_flow", "write_flow",
]
