"""Checkpoints, the fault injector and the step-time watchdog of the
PyTorch port (mirrors :mod:`repro.checkpoint`)."""
