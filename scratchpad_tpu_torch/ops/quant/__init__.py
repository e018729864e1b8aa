"""4-bit weights: the JAX package's storage (``w4a16``), the port's packed
layout and its GEMM kernels (``w4_matmul``), and checkpoint import
(``import_hf``)."""
