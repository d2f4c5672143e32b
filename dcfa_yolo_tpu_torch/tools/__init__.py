"""Measurement tools of the port, each run with `python -m`."""
