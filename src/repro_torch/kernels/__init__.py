"""Hand-written Hopper kernels of the serving path, their plain PyTorch
versions (``ref``) and the wrappers that dispatch between them
(``ops``)."""
