"""SpeCa in PyTorch for NVIDIA Hopper — the port of ``src/repro``.

Module names mirror the JAX package so that each piece has an obvious
counterpart (``repro_torch.core.lane_step`` ↔ ``repro.core.lane_step``).
The port imports ``torch`` and never ``jax`` or ``repro``; it keeps its
own copies of the configuration records and the serving policy.

The TPU kernels on the serving path (Taylor predict, Taylor refresh and
the fused verify) are CUDA C++ kernels for ``sm_90a`` under
``repro_torch/kernels/csrc``, built with ``nvcc`` at first use and bound
with ``ctypes``. Each wrapper runs its plain PyTorch version only for
tensors that lie on the CPU.

Entry points take ``device=`` and default to ``"cuda"``; they raise when
no GPU is present unless the caller passes ``device="cpu"``.
"""
