"""scratchpad_tpu_torch: the PyTorch/CUDA port of scratchpad_tpu.

A second package beside ``scratchpad_tpu`` (the JAX reference, which it never
imports). The same single-controller serving engine — continuous batching,
radix prefix cache, chunked prefill, paged KV cache, fused multi-step decode
windows with on-device sampling — runs eagerly in PyTorch on one CUDA device.
Paged decode and extend attention run in hand-written CUDA kernels for Hopper
(``csrc/``); every kernel keeps a plain PyTorch version beside it, which is
the CPU path and the kernels' oracle.
"""

__version__ = "0.1.0"
