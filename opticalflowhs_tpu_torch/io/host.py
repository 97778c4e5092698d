"""Arrays leaving the device for the host: a tensor's values as numpy.

numpy has no bfloat16, so a bfloat16 tensor (a flow of
`HSConfig(dtype="bfloat16")`) is widened to float32 first, which is exact.
Every host exit of the package (.flo and KITTI writes, renders, metrics,
checkpoints, the command line) goes through `host_array`.
"""

from __future__ import annotations

import numpy as np


def host_array(a) -> np.ndarray:
    """A numpy array of `a`: a torch tensor's values on the host (a 16-bit
    float tensor, such as a bfloat16 flow, widened to float32 first, which
    is exact: numpy has no bfloat16), anything else through np.asarray."""
    if hasattr(a, "detach"):  # torch tensor, on any device
        a = a.detach()
        if a.is_floating_point() and a.element_size() == 2:
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)
