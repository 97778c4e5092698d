"""Synthetic frame pairs with analytic ground truth (NumPy only)."""

from opticalflowhs_tpu_torch.data.synthetic import (
    synthetic_pair,
    synthetic_sequence,
    translation_pair,
)

__all__ = ["synthetic_pair", "synthetic_sequence", "translation_pair"]
