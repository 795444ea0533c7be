"""AdamW with decoupled weight decay (counterpart of ``repro.optim``)."""
