"""Whole-system runs of the port, run with `python -m`."""
