"""DiT building blocks (counterpart of ``repro.layers``)."""
