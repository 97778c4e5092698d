"""Flow-field file formats."""
