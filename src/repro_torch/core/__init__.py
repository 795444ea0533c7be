"""SpeCa core: tables, verification, the lane step and the sampler
(counterpart of ``repro.core``)."""
