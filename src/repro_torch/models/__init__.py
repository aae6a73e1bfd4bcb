"""The LM substrate of the port (mirrors :mod:`repro.models`): the dense
decoder and its pieces."""
