"""Deterministic synthetic datasets (counterpart of ``repro.data``)."""
