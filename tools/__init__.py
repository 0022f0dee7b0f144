"""Measurement tools of the port, run on a GPU (see each module)."""
