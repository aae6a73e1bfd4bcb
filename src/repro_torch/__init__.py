"""PipeSim on PyTorch, for one NVIDIA H100.

A port of the JAX package :mod:`repro`, which stays the reference. The
layout mirrors it file for file (``repro/core/vdes.py`` ->
``repro_torch/core/vdes.py``, ...), and each module keeps the names of its
reference. This package imports ``torch``, numpy and scipy, never ``jax``
and never a module of ``repro``: what it needs of the reference's
numpy-only modules it keeps as its own copy.

Ported so far: the wave loop (:mod:`repro_torch.core.vdes`: select,
completion/retry, control with capacity schedules, reliability events and
the closed-loop controller, admission, the model lifecycle's fleet stage
and the probe stage), its host side (workload generator, scenarios,
:mod:`repro_torch.reliability`, :mod:`repro_torch.obs.probes`,
:mod:`repro_torch.core.runtime`, padding/stacking, trace flattening and
summaries) and the admission kernel
(:mod:`repro_torch.kernels.queue_scan`); the LM substrate's serving path
for the dense plan (:mod:`repro_torch.models`, :mod:`repro_torch.configs`,
:mod:`repro_torch.serving`, :mod:`repro_torch.launch.serve`) and its
flash-attention kernel (:mod:`repro_torch.kernels.flash_attention`); the
paper's fit -> synthesize -> simulate path (:mod:`repro_torch.core.stats`,
``gmm``, ``fitting``, ``synthesizer``, ``engines``, ``experiment`` and
:mod:`repro_torch.launch.simulate`) and its GMM E-step kernel
(:mod:`repro_torch.kernels.gmm_logpdf`); the hybrid ``zamba2-1.2b`` and its
SSD kernel (:mod:`repro_torch.kernels.mamba2_scan`), and the queue kernel
(``queue_scan``); training (:mod:`repro_torch.optim`,
:mod:`repro_torch.data`, :mod:`repro_torch.train`,
:mod:`repro_torch.launch.train`, :mod:`repro_torch.checkpoint`) through
the plain attention and SSD routes, the kernels having no backward. All
five kernels are CUDA for ``sm_90a``.

Entry points run on the card (``device=None`` means ``"cuda"``) and raise
when there is none; the CPU is used only when the caller passes
``device="cpu"``.
"""
