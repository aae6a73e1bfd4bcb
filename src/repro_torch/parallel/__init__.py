"""Parallelism helpers of the port (mirrors :mod:`repro.parallel`):
gradient compression for the pod-level reduction. The reference's logical
sharding rules and meshes (``sharding.py``) are not ported yet."""
