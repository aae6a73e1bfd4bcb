"""Input pipelines of the PyTorch port (mirrors :mod:`repro.data`)."""
