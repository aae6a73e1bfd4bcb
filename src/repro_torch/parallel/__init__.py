"""Parallelism helpers of the port (mirrors :mod:`repro.parallel`): the
logical-axis sharding rules on a ``torch.distributed`` ``DeviceMesh``
(:mod:`~repro_torch.parallel.sharding`) and gradient compression for the
pod-level reduction (:mod:`~repro_torch.parallel.compression`)."""
