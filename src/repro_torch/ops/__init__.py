"""Operational scenarios of the PyTorch port (mirrors :mod:`repro.ops`):
capacity schedules, failure/retry injection, cost/SLO accounting."""
