"""Batched generation with the port's models (mirrors :mod:`repro.serving`)."""
