"""Training: the diffusion and LM trainers (counterpart of
``repro.training``)."""
