"""Engine and host-side core of the PyTorch port (mirrors :mod:`repro.core`)."""
