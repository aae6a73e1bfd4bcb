"""Command-line entry points of the port (mirrors :mod:`repro.launch`)."""
