"""Imported by the port's test files (tests/test_torch_*.py).

`cap()` limits torch's intra-op threads, so that these CPU-heavy tests, run
by pytest-xdist beside the JAX package's wall-clock-bounded tests, take two
cores each rather than every core of the machine.
"""
import torch

THREADS = 2


def cap() -> None:
    torch.set_num_threads(THREADS)
