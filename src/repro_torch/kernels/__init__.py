"""Hand-written Hopper kernels of the PyTorch port, each beside its plain
PyTorch version (:mod:`repro_torch.kernels.ref`)."""
