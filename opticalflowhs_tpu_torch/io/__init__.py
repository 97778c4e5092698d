"""Flow-field file formats: Middlebury .flo (the reference's image and
KITTI readers are not ported yet, ROADMAP.md queue 1, item 4)."""

from opticalflowhs_tpu_torch.io.flo import read_flo, write_flo

__all__ = ["read_flo", "write_flo"]
