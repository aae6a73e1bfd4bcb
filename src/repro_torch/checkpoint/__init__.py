"""Checkpoint-side helpers of the PyTorch port (mirrors
:mod:`repro.checkpoint`): only the straggler watchdog the reliability
compiler streams repair times through is ported."""
