"""Lane sharding of the serving state (counterpart of ``repro.sharding``)."""
