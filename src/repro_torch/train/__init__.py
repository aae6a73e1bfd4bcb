"""Training steps of the PyTorch port (mirrors :mod:`repro.train`)."""
