"""Caps torch's CPU intra-op threads for the port's tests.

The CPU tier runs the test files in several worker processes side by
side (pytest-xdist). Each process would otherwise start torch with one
intra-op thread per core, and a parallel region then waits on threads
that the other processes have descheduled: a case that takes 0.25 s
alone took 23 s that way. One thread per process keeps every worker
busy without that wait. On a machine with a CUDA device (the ``cuda``
tests, run alone) torch keeps its default.

Every ``tests/test_torch_*.py`` imports this module before its first
torch op. ``set_num_interop_threads`` is left alone: it raises once
parallel work has begun.
"""

import torch

CPU_THREADS = 1

if not torch.cuda.is_available():
    torch.set_num_threads(CPU_THREADS)
