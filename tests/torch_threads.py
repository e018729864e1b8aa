"""One torch thread in each test process.

The repository's tier-1 command runs the tests in six pytest-xdist
workers. Torch's intra-op pool takes a thread a core in every worker, so
the workers keep several busy-waiting threads on each core, and the port's
tests (torch on the CPU beside the JAX package) slow every worker: the six
heaviest port test files took 365 s of wall in six workers on eight cores,
and 126 s with one torch thread a process. The tests' tensors are small;
one thread a process loses nothing. Every ``tests/test_torch_*.py`` but the
card's ``test_torch_gpu.py`` imports this module.
"""

import torch

torch.set_num_threads(1)
