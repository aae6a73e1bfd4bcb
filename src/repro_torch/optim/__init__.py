"""Optimizers of the PyTorch port (mirrors :mod:`repro.optim`)."""
