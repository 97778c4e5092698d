"""Synthetic frame pairs with analytic ground truth (NumPy only)."""
