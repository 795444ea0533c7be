"""Noise schedules and the reference sampler (counterpart of
``repro.diffusion``)."""
